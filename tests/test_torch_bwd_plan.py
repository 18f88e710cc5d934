"""The backward kernel's work plan (``flash_prefill.bwd_plan``), on the CPU.

The plan is plain Python: the bf16 kernels' loop lengths as they compute
them (``bwd_tile_counts``) and the choice of dK/dV parts and dQ key
splits that keep an H100's 132 SMs busy. The kernels themselves are
checked on the card (``tests/test_torch_cuda.py``). The expected plans at
the training shapes are the ones the chip runs measured fastest among
those tried (PERF.md).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_prefill import (BWD_ROWS, bwd_plan,
                                               bwd_tile_counts)

# (B, Sq, Sk, H, KV, dh, dv, q_offset, kv_len, window) -> (parts, splits),
# chip_smoke.py's TRAIN_BWD shapes
TRAIN_PLANS = [
    ((4, 1024, 1024, 4, 1, 256, 256, 0, 1024, None), (2, 1)),    # gemma3
    ((4, 256, 256, 32, 8, 64, 64, 0, 256, None), (2, 1)),        # llama
    ((1, 512, 512, 12, 2, 128, 128, 0, 512, None), (6, 2)),      # qwen2-vl
    ((1, 512, 512, 24, 8, 64, 64, 0, 512, None), (3, 1)),        # granite
    ((2, 256, 256, 8, 8, 64, 64, 0, 256, None), (1, 4)),         # whisper self
    ((2, 1500, 1500, 8, 8, 64, 64, 1500, 1500, None), (2, 2)),   # encoder
    ((2, 256, 1500, 8, 8, 64, 64, 1500, 1500, None), (1, 4)),    # cross
    ((1, 512, 512, 128, 128, 192, 128, 0, 512, None), (1, 1)),   # deepseek
]


def _live(kp, qp, kv_len, window):
    ok = (kp <= qp) & (kp < kv_len)
    if window:
        ok &= kp > qp - window
    return ok


SHAPES = [
    # Sq, Sk, q_offset, kv_len, window
    (100, 300, 77, 177, None),
    (37, 128, 91, 128, None),
    (128, 128, 0, 128, 48),
    (200, 300, 100, 300, 96),
    (256, 1500, 1500, 1500, None),
    (40, 64, 40, 64, 8),
    (1, 256, 200, 201, None),
    (513, 700, 0, 700, 130),
]


@pytest.mark.parametrize("shape", SHAPES)
def test_tile_counts_cover_every_live_pair(shape):
    """Every live (key, query) pair lies in the tiles both kernels walk:
    the dK/dV CTA of its key's tile walks query tiles from the multiple of
    64 at or below its first query, and the dQ CTA of its query's tile
    walks key tiles from its window's first tile; and neither walks a tile
    past the live pairs' last one."""
    Sq, Sk, off, kv_len, win = shape
    per_key, per_query = bwd_tile_counts(Sq, Sk, off, kv_len, win)
    assert len(per_key) == -(-Sk // BWD_ROWS)
    assert len(per_query) == -(-Sq // BWD_ROWS)
    kp = np.arange(Sk)[:, None]
    qi = np.arange(Sq)[None, :]
    live = _live(kp, off + qi, min(kv_len, Sk), win)
    for t, n in enumerate(per_key):
        k0 = t * BWD_ROWS
        rows = live[k0:k0 + BWD_ROWS].any(axis=0).nonzero()[0]
        if rows.size == 0:
            continue
        lo = max(0, k0 - off) // BWD_ROWS * BWD_ROWS
        assert lo <= rows.min() and rows.max() < lo + n * BWD_ROWS
        assert lo + (n - 1) * BWD_ROWS <= rows.max()
    for t, n in enumerate(per_query):
        q0 = t * BWD_ROWS
        keys = live[:, q0:q0 + BWD_ROWS].any(axis=1).nonzero()[0]
        if keys.size == 0:             # a window past kv_len: at most one
            assert n <= 1              # tile walked, every pair masked
            continue
        assert n >= 1
        first = keys.min() // BWD_ROWS * BWD_ROWS
        span = -(-(keys.max() + 1 - first) // BWD_ROWS)
        assert n >= span and n <= span + 1


@pytest.mark.parametrize("shape,plan", TRAIN_PLANS)
def test_plans_at_the_training_shapes(shape, plan):
    B, Sq, Sk, H, KV, dh, dv, off, kv_len, win = shape
    assert bwd_plan(torch.bfloat16, B, Sq, Sk, H, KV, dh, dv, off, kv_len,
                    win) == plan


@pytest.mark.parametrize("shape,plan", TRAIN_PLANS)
def test_fp32_keeps_a_part_a_query_head_and_no_split(shape, plan):
    B, Sq, Sk, H, KV, dh, dv, off, kv_len, win = shape
    assert bwd_plan(torch.float32, B, Sq, Sk, H, KV, dh, dv, off, kv_len,
                    win) == (H // KV, 1)


def test_plan_bounds_hold_on_random_shapes():
    """GQA parts divide the group, MHA takes one or two, dQ never splits
    into more parts than its longest walk has tiles, and a card with more
    SMs never gets fewer GQA parts."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        KV = int(rng.choice([1, 2, 4, 8]))
        H = KV * int(rng.choice([1, 2, 3, 4, 5, 8]))
        B = int(rng.integers(1, 5))
        Sq = int(rng.integers(1, 1600))
        Sk = int(rng.integers(1, 1600))
        off = int(rng.integers(0, Sk + 1))
        kv_len = int(rng.integers(0, Sk + 1))
        win = None if rng.random() < 0.7 else int(rng.integers(1, 300))
        dh, dv = [(64, 64), (128, 128), (256, 256), (192, 128)][
            int(rng.integers(4))]
        parts, splits = bwd_plan(torch.bfloat16, B, Sq, Sk, H, KV, dh, dv,
                                 off, kv_len, win)
        rep = H // KV
        if rep > 1:
            assert rep % parts == 0
        else:
            assert parts in (1, 2)
        _, per_query = bwd_tile_counts(Sq, Sk, off, kv_len, win)
        assert 1 <= splits <= max(1, max(per_query))
        more = bwd_plan(torch.bfloat16, B, Sq, Sk, H, KV, dh, dv, off,
                        kv_len, win, sms=4 * 132)
        if rep > 1:
            assert more[0] >= parts
