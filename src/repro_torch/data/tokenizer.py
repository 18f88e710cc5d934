"""Deterministic offline tokenizer (a copy of ``repro.data.tokenizer``).

No network, no vocab files: words map to stable ids via blake2s. The
mapping is injective enough for cache-key purposes (the paper's key is a
hash over token ids — identical text must produce identical ids, which
this guarantees) and reserves low ids for special tokens.
"""
from __future__ import annotations

import hashlib
import re
from typing import List

_WORD_RE = re.compile(r"\w+|[^\w\s]")


class WordHashTokenizer:
    PAD, BOS, EOS = 0, 1, 2
    N_SPECIAL = 16

    def __init__(self, vocab: int):
        assert vocab > self.N_SPECIAL * 2
        self.vocab = vocab

    def _word_id(self, w: str) -> int:
        h = hashlib.blake2s(w.lower().encode(), digest_size=4).digest()
        span = self.vocab - self.N_SPECIAL
        return self.N_SPECIAL + int.from_bytes(h, "little") % span

    def encode(self, text: str, bos: bool = True) -> List[int]:
        ids = [self._word_id(w) for w in _WORD_RE.findall(text)]
        return ([self.BOS] if bos else []) + ids


    def decode(self, ids) -> str:           # lossy (hash ids)
        return " ".join(f"<{int(i)}>" for i in ids)
