"""Prompt-cache lookup keys (paper §3.1, Figure 3 top).

A copy of ``repro.core.keys``: a key is a hash of (model metadata ||
token-id prefix). ``model_meta`` must give the reference's bytes for the
same config and dtype string, so both packages derive the same digests
and can share one cache.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Sequence


def model_meta(cfg, dtype_name: str) -> bytes:
    fields = (cfg.name, cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
              cfg.n_kv_heads, cfg.dh, cfg.vocab, cfg.window,
              cfg.n_meta_tokens, dtype_name)
    return ("|".join(str(f) for f in fields)).encode()


@dataclass(frozen=True)
class PromptKey:
    digest: bytes          # 32-byte blake2b
    n_tokens: int          # prefix length this key covers

    @classmethod
    def for_prefix(cls, meta: bytes, token_ids: Sequence[int],
                   n: int) -> "PromptKey":
        # little-endian int32 token ids, as the reference encodes them
        ids = b"".join(int(t).to_bytes(4, "little", signed=True)
                       for t in token_ids[:n])
        h = hashlib.blake2b(digest_size=32)
        h.update(meta)
        h.update(n.to_bytes(4, "little"))
        h.update(ids)
        return cls(h.digest(), n)
