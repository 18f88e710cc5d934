"""LM batches from the synthetic MMLU stream (``repro.training.data``),
and a VLM's batches of merged image embeddings (the reference's vision
encoder is a stub: ``launch/specs.py`` declares ``embeds`` and M-RoPE
``positions`` in place of tokens)."""
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


def image_positions(seq: int, text: int, grid: int) -> np.ndarray:
    """One row's M-RoPE positions (int32 ``[3, seq]``) in Qwen2-VL's
    layout (arXiv:2409.12191): ``text`` text tokens at ``0..text-1``, a
    ``grid x grid`` image whose patches share the temporal index ``text``
    (height ``text + r``, width ``text + c``), then text from ``max(t, h,
    w) + 1 = text + grid`` on, the three components equal."""
    n = grid * grid
    if text + n > seq:
        raise ValueError(f"{text} text tokens and a {grid}x{grid} image do "
                         f"not fit {seq} positions")
    pos = np.empty((3, seq), np.int32)
    pos[:, :text] = np.arange(text)
    r, c = np.divmod(np.arange(n), grid)
    pos[0, text:text + n] = text
    pos[1, text:text + n] = text + r
    pos[2, text:text + n] = text + c
    pos[:, text + n:] = text + grid + np.arange(seq - text - n)
    return pos


def vlm_image_batches(cfg, batch: int, seq: int, text: int, grid: int,
                      seed: int = 0) -> Iterator[dict]:
    """A VLM's training batches on merged image embeddings: ``{"embeds":
    fp32 [B, S, D], "positions": int32 [3, B, S], "targets": int32 [B,
    S]}`` (numpy): stub embeddings drawn from ``seed`` (normal x 0.02),
    every row at :func:`image_positions`, the targets
    :func:`lm_batches`'."""
    rng = np.random.default_rng(seed)
    pos = np.broadcast_to(image_positions(seq, text, grid)[:, None],
                          (3, batch, seq)).copy()
    for b in lm_batches(cfg, batch, seq, seed=seed):
        embeds = rng.standard_normal((batch, seq, cfg.d_model)) * 0.02
        yield {"embeds": embeds.astype(np.float32), "positions": pos,
               "targets": b["targets"]}
