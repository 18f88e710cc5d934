"""LM batches from the synthetic MMLU stream (``repro.training.data``)."""
from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.data.mmlu import MMLUGenerator
from repro_torch.data.tokenizer import WordHashTokenizer


def lm_batches(cfg, batch: int, seq: int, seed: int = 0,
               n_shot: int = 2) -> Iterator[dict]:
    """MMLU-style prompts packed into fixed ``[B, S]`` next-token batches:
    ``{"tokens": int32 [B, S], "targets": int32 [B, S]}`` (numpy), each
    prompt followed by EOS, as the reference packs them."""
    tok = WordHashTokenizer(cfg.vocab)
    gen = MMLUGenerator(tok, n_shot=n_shot, seed=seed)
    stream = gen.stream(10 ** 9)
    buf: list = []
    while True:
        rows = []
        while len(rows) < batch:
            while len(buf) < seq + 1:
                buf.extend(next(stream).segments.token_ids)
                buf.append(tok.EOS)
            rows.append(buf[:seq + 1])
            buf = buf[seq + 1:]
        arr = np.asarray(rows, np.int32)
        yield {"tokens": arr[:, :-1], "targets": arr[:, 1:]}
