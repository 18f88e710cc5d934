"""``moe_gemm``'s work plan (``moe_plan``) and its tile walk, on the CPU.

The plan is plain Python: from the host-known shapes alone (M, N, E) it
picks the bf16 kernel's form and tile, and ``moe_tile_walk`` below models
the kernel's assignment of output blocks to CTAs (the warp scan over the
offsets, the row tile slots). The kernel itself is checked on the card
(``tests/test_torch_cuda.py``). Here: the plans at ``chip_smoke.py``'s
shapes, and that under any routing every output element is written
exactly once, by the right expert, and every row outside the groups once
with zeros.
"""
import inspect
from typing import Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import pytest
import torch

from repro_torch.kernels.moe_gemm import MoePlan, moe_gemm_plain, moe_plan

BF16, FP32 = torch.bfloat16, torch.float32


class Write(NamedTuple):
    """An output block a CTA writes: rows [r0, r1) x columns [c0, c1),
    either the products of ``expert``'s rows over the whole of K or, with
    ``expert`` None, zeros."""
    r0: int
    r1: int
    c0: int
    c1: int
    expert: Optional[int]


def _row_tile(offsets: Sequence[int], M: int, rows: int, t: int
              ) -> Optional[Tuple[int, int, int]]:
    """The t-th row tile of the experts that have rows, as the kernel's
    warp scan finds it: (expert, first row, rows), or None."""
    seen = 0
    for e in range(len(offsets) - 1):
        r0 = min(offsets[e], M)
        r1 = max(r0, min(offsets[e + 1], M))
        n = -(-(r1 - r0) // rows)
        if t < seen + n:
            m0 = r0 + (t - seen) * rows
            return e, m0, min(rows, r1 - m0)
        seen += n
    return None


def moe_tile_walk(plan: MoePlan, offsets: Sequence[int], M: int,
                  N: int) -> Iterator[Write]:
    """Every block of the output that the kernel's CTAs write under
    ``plan`` for these group ``offsets``: ``csrc/moe_gemm.cu``'s
    arithmetic (CTA (x, y) takes column tile x, row tile slot y), in
    Python."""
    E = len(offsets) - 1
    lo = max(0, min(offsets[0], M))
    hi = max(lo, min(offsets[E], M))
    live = [e for e in range(E) if offsets[e + 1] > offsets[e]]
    tiles = [_row_tile(offsets, M, plan.rows, y)
             for y in range(plan.row_tiles)]
    for x in range(plan.grid[0]):
        n0 = x * plan.cols
        c1 = min(n0 + plan.cols, N)
        for y in range(plan.row_tiles):
            if y == 0:                 # rows outside every group
                for r0, r1 in ((0, lo), (hi, M)):
                    if r1 > r0:
                        yield Write(r0, r1, n0, c1, None)
            if plan.form == "scalar":
                if y >= len(live):
                    continue
                e = live[y]
                r_end = min(offsets[e + 1], M)
                for m0 in range(offsets[e], r_end, plan.rows):
                    yield Write(m0, min(m0 + plan.rows, r_end), n0, c1, e)
                continue
            if tiles[y] is None:
                continue
            e, m0, rows = tiles[y]
            yield Write(m0, m0 + rows, n0, c1, e)

# chip_smoke.py's MOE_SHAPES x MOE_TOKENS (M = 8 x tokens) and TRAIN_MOE's
# dX products (w read transposed: K and N of the forward swapped; deepseek's
# MTP cut has 32 experts) -> the bf16 plan (form, rows, row tiles, column
# tiles)
BF16_PLANS = {
    # granite-moe-3b-a800m up/gate (K 1536, N 512, E 48)
    (8, 1536, 512, 48): ("decode", 64, 8, 4),
    (32, 1536, 512, 48): ("decode", 64, 32, 4),
    (4096, 1536, 512, 48): ("bucket", 128, 80, 4),
    # granite down (K 512, N 1536); also the up product's dX
    (8, 512, 1536, 48): ("decode", 64, 8, 12),
    (32, 512, 1536, 48): ("decode", 64, 32, 12),
    (4096, 512, 1536, 48): ("bucket", 128, 80, 12),
    # deepseek-v3-671b up/gate (K 7168, N 2048, E 256)
    (8, 7168, 2048, 256): ("decode", 64, 8, 16),
    (32, 7168, 2048, 256): ("decode", 64, 32, 16),
    (4096, 7168, 2048, 256): ("decode", 64, 320, 16),
    # deepseek down (K 2048, N 7168)
    (8, 2048, 7168, 256): ("decode", 64, 8, 56),
    (32, 2048, 7168, 256): ("decode", 64, 32, 56),
    (4096, 2048, 7168, 256): ("decode", 64, 320, 56),
    # training dX at the MTP cut's 32 experts, M = 511 x 8
    (4088, 2048, 7168, 32): ("bucket", 128, 63, 56),
    (4088, 7168, 2048, 32): ("bucket", 128, 63, 16),
}


@pytest.mark.parametrize("shape", sorted(BF16_PLANS))
def test_bf16_plan_at_the_chip_shapes(shape):
    M, K, N, E = shape
    form, rows, row_tiles, col_tiles = BF16_PLANS[shape]
    plan = moe_plan(BF16, M, N, E)
    assert plan == MoePlan(form, rows, 128, row_tiles, col_tiles)
    assert plan.warpgroups == rows // 64
    assert plan.grid == (col_tiles, row_tiles)


@pytest.mark.parametrize("shape", sorted(BF16_PLANS))
def test_fp32_plan_keeps_the_scalar_grid(shape):
    M, K, N, E = shape
    assert moe_plan(FP32, M, N, E) == MoePlan(
        "scalar", 64, 64, min(E, M), -(-N // 64))


def test_the_plan_takes_shapes_and_no_offsets():
    """The plan's inputs are the dtype and three sizes: no offsets, so it
    reads no group size and one plan serves a CUDA graph and every routing
    of a shape."""
    assert list(inspect.signature(moe_plan).parameters) == [
        "dtype", "M", "N", "E"]
    # the form turns at 64 rows a slot: a 512-row bucket over granite's 48
    # experts is the bucket form, over deepseek's 256 the decode form
    assert moe_plan(BF16, 64 * 48, 512, 48).form == "decode"
    assert moe_plan(BF16, 64 * 48 + 1, 512, 48).form == "bucket"
    assert moe_plan(BF16, 4096, 2048, 256).form == "decode"


EDGE_SIZES = (0, 1, 63, 64, 65, 127, 128, 129)


def _routing(rng):
    """(M, N, E, offsets): random group sizes with empty groups, sizes
    at the tiles' edges, rows before the first group or after the last
    (rows outside every group, which the kernel writes as zeros)."""
    E = int(rng.integers(1, 40))
    N = 8 * int(rng.integers(1, 50))
    kind = rng.integers(4)
    if kind == 0:
        sizes = rng.choice(EDGE_SIZES, E)
    elif kind == 1:                    # decode: a few rows, most experts empty
        sizes = np.zeros(E, np.int64)
        picked = rng.choice(E, min(E, int(rng.integers(1, 9))), replace=False)
        sizes[picked] = rng.integers(1, 5, picked.size)
    elif kind == 2:                    # one expert with every row
        sizes = np.zeros(E, np.int64)
        sizes[rng.integers(E)] = int(rng.integers(1, 600))
    else:
        sizes = rng.integers(0, 200, E)
    lead = int(rng.integers(0, 3)) * int(rng.integers(0, 70))
    trail = int(rng.integers(0, 3)) * int(rng.integers(0, 70))
    offsets = lead + np.concatenate([[0], np.cumsum(sizes)])
    M = max(int(offsets[-1]) + trail, 1)
    return M, N, E, [int(v) for v in offsets]


def _plans(M, N, E):
    """Both bf16 forms at this shape (the kernel takes either; the plan
    picks one) and the fp32 plan, by form."""
    slots, col_tiles = min(E, M), -(-N // 128)
    return {"decode": MoePlan("decode", 64, 128, M // 64 + slots, col_tiles),
            "bucket": MoePlan("bucket", 128, 128, M // 128 + slots,
                              col_tiles),
            "scalar": moe_plan(FP32, M, N, E)}


def _check_walk(plan, offsets, M, N):
    E = len(offsets) - 1
    count = np.zeros((M, N), np.int64)
    for wr in moe_tile_walk(plan, offsets, M, N):
        assert 0 <= wr.r0 < wr.r1 <= M and 0 <= wr.c0 < wr.c1 <= N, wr
        count[wr.r0:wr.r1, wr.c0:wr.c1] += 1
        if wr.expert is None:          # zeros, outside every group
            assert wr.r1 <= offsets[0] or wr.r0 >= offsets[E], wr
            continue
        e = wr.expert
        assert offsets[e] <= wr.r0 and wr.r1 <= offsets[e + 1], wr
        assert wr.r1 - wr.r0 <= plan.rows
    assert (count == 1).all(), np.argwhere(count != 1)[:5]


@pytest.mark.parametrize("part", range(8))
def test_tile_walk_writes_every_element_once(part):
    """~200 random routings (8 x 25), each under both bf16 forms (the
    plan's and the other) and the fp32 plan."""
    rng = np.random.default_rng(1000 + part)
    for _ in range(25):
        M, N, E, offsets = _routing(rng)
        assert moe_plan(BF16, M, N, E) in _plans(M, N, E).values()
        for plan in _plans(M, N, E).values():
            _check_walk(plan, offsets, M, N)


@pytest.mark.parametrize("sizes", [
    (63, 64, 65, 127, 128, 129),       # adjacent groups at the tiles' edges
    (1, 0, 129, 0, 0, 64, 1),
    (300,),                            # one expert with all the rows
    (1,) * 40,                         # every expert one row
])
@pytest.mark.parametrize("form", ["decode", "bucket", "scalar"])
def test_walk_computes_the_grouped_product(sizes, form):
    """The walk's blocks, computed as the kernel computes them, give
    ``moe_gemm_plain``'s result: no row lost, none taken from another
    expert."""
    rng = np.random.default_rng(len(sizes))
    E, K, N = len(sizes), 200, 136
    offsets = [0] + list(np.cumsum(sizes))
    M = offsets[-1] + 3                # rows past the last group are 0
    xs = torch.from_numpy(rng.normal(size=(M, K))).double()
    w = torch.from_numpy(rng.normal(size=(E, K, N))).double()
    want = moe_gemm_plain(xs, w, torch.tensor(offsets, dtype=torch.int32))
    plan = _plans(M, N, E)[form]
    got = torch.full((M, N), float("nan"), dtype=torch.float64)
    for wr in moe_tile_walk(plan, offsets, M, N):
        if wr.expert is None:
            got[wr.r0:wr.r1, wr.c0:wr.c1] = 0.0
            continue
        got[wr.r0:wr.r1, wr.c0:wr.c1] = (xs[wr.r0:wr.r1]
                                         @ w[wr.expert, :, wr.c0:wr.c1])
    torch.testing.assert_close(got, want, atol=1e-9, rtol=1e-9)
