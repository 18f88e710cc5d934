"""The port's attention kernels against the reference's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; these
are held against the Pallas kernels (interpret mode) and the ``ref.py``
oracles on the same numpy inputs: fp32 within 1e-5 (the reference's own
kernel tolerance: only summation order differs) and bf16 within 2e-2
(inputs rounded to bf16 identically on both sides; outputs rounded to
bf16 once, an error of up to 2^-8 relative). The CUDA kernels are held
against these plain versions on the card by ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro.kernels.flash_prefill import flash_prefill as jax_flash_prefill
from repro.kernels.ref import flash_decode_ref, flash_prefill_ref
from repro_torch.kernels.flash_decode import flash_decode, split_plan
from repro_torch.kernels.flash_prefill import flash_prefill, grid_plan
from repro_torch.kernels.mla_decode import split_plan as mla_split_plan
from repro_torch.kernels.ssd_scan import rows_vectorizable
from repro_torch.kernels.ssd_scan import scratch_plan as ssd_scratch_plan

PREFILL_CASES = [
    # B, Sq, Sk, H, KV, dh, off, win  (tests/test_kernels.py:19-26)
    (2, 64, 64, 4, 2, 32, 0, None),
    (1, 37, 128, 4, 4, 64, 91, None),      # ragged + prefix resume
    (2, 128, 128, 8, 1, 32, 0, 48),        # MQA + sliding window
    (1, 1, 256, 4, 2, 64, 200, None),      # suffix of one token
    (1, 96, 96, 2, 2, 128, 0, None),       # wide head dim
    (1, 64, 256, 4, 1, 256, 100, None),    # gemma3-270m heads, resume
]

DECODE_CASES = [
    # B, Sk, H, KV, dh, kv_len, win  (tests/test_kernels.py:45-50)
    (2, 128, 4, 2, 32, 100, None),
    (1, 512, 8, 8, 64, 512, None),
    (2, 256, 4, 1, 32, 250, 64),           # windowed decode
    (1, 300, 4, 4, 128, 17, None),         # short valid region, ragged Sk
    (1, 256, 4, 1, 256, 180, None),        # gemma3-270m heads
]

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(rng, shape, dtype_name):
    """The same values as a JAX and a torch array (bf16 rounded alike)."""
    jdt, tdt, _ = DTYPES[dtype_name]
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("case", PREFILL_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_prefill_plain_vs_pallas(case, dtype):
    B, Sq, Sk, H, KV, dh, off, win = case
    rng = np.random.default_rng(7)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, dtype) for s in (
        (B, Sq, H, dh), (B, Sk, KV, dh), (B, Sk, KV, dh)))
    kv_len = off + Sq
    out = flash_prefill(tq, tk, tv, q_offset=off, kv_len=kv_len, window=win)
    assert out.dtype == tq.dtype and out.shape == (B, Sq, H, dh)
    pallas = jax_flash_prefill(jq, jk, jv, q_offset=off, kv_len=kv_len,
                               window=win, block_q=32, block_k=32,
                               interpret=True)
    ref = flash_prefill_ref(jq, jk, jv, q_offset=off, kv_len=kv_len,
                            window=win)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_np(out), _np(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_decode_plain_vs_pallas(case, dtype):
    B, Sk, H, KV, dh, kvlen, win = case
    rng = np.random.default_rng(11)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, dtype) for s in (
        (B, H, dh), (B, Sk, KV, dh), (B, Sk, KV, dh)))
    out = flash_decode(tq, tk, tv, kv_len=kvlen, window=win)
    assert out.dtype == tq.dtype and out.shape == (B, H, dh)
    pallas = jax_flash_decode(jq, jk, jv, kv_len=kvlen, window=win,
                              block_k=64, interpret=True)
    ref = flash_decode_ref(jq, jk, jv, kv_len=kvlen, window=win)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_np(out), _np(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol, rtol=tol)


def test_no_live_key_gives_zero_not_nan():
    """kv_len = 0 (and so every key masked) returns 0, as the Pallas
    kernels' ``l == 0`` guard does."""
    rng = np.random.default_rng(3)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, "float32") for s in (
        (1, 4, 4, 32), (1, 16, 2, 32), (1, 16, 2, 32)))
    out = flash_prefill(tq, tk, tv, q_offset=0, kv_len=0)
    assert torch.count_nonzero(out) == 0
    pallas = jax_flash_prefill(jq, jk, jv, q_offset=0, kv_len=0,
                               block_q=4, block_k=16, interpret=True)
    np.testing.assert_array_equal(_np(out), _np(pallas))
    dec = flash_decode(tq[:, 0], tk, tv, kv_len=0)
    assert torch.count_nonzero(dec) == 0
    pallas_d = jax_flash_decode(jq[:, 0], jk, jv, kv_len=0, block_k=16,
                                interpret=True)
    np.testing.assert_array_equal(_np(dec), _np(pallas_d))


def test_decode_scale_override_and_narrow_v():
    """dv != dh and an explicit scale, as MLA's latent decode uses them:
    the plain version against the Pallas kernel."""
    rng = np.random.default_rng(5)
    (jq, tq), (jk, tk) = (_pair(rng, s, "float32") for s in (
        (1, 4, 64), (1, 96, 1, 64)))
    jv, tv = _pair(rng, (1, 96, 1, 32), "float32")
    out = flash_decode(tq, tk, tv, kv_len=70, scale=0.07)
    pallas = jax_flash_decode(jq, jk, jv, kv_len=70, scale=0.07, block_k=32,
                              interpret=True)
    np.testing.assert_allclose(_np(out), _np(pallas), atol=1e-5, rtol=1e-5)


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises: here,
    tensors on the ``meta`` device have no kernel."""
    q = torch.empty((1, 4, 4, 32), device="meta")
    kv = torch.empty((1, 16, 2, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash_prefill(q, kv, kv, kv_len=4)
    with pytest.raises(ValueError, match="no kernel"):
        flash_decode(q[:, 0], kv, kv, kv_len=4)


@pytest.mark.parametrize("B,H,KV,live,want", [
    (1, 4, 1, 1024, (4, 32, 32)),     # main path: 32 splits of one tile
    (1, 4, 1, 1, (4, 1, 32)),
    (1, 4, 1, 0, (4, 1, 32)),         # no live key: one empty split
    (2, 8, 8, 512, (1, 8, 64)),       # 16 CTAs of heads: 8 splits each
    (1, 16, 1, 300, (4, 10, 32)),     # rep 16 -> groups of 4 heads
])
def test_split_plan(B, H, KV, live, want):
    hg, nsplit, chunk = split_plan(B, H, KV, live)
    assert (hg, nsplit, chunk) == want
    assert nsplit * chunk >= live and (H // KV) % hg == 0


@pytest.mark.parametrize("dtype,B,Sq,H,KV,want", [
    # gemma3-270m: 16 queries x 4 heads a CTA; cold prompt and a resume
    (torch.bfloat16, 1, 512, 4, 1, (64, 4, (32, 1, 1))),
    (torch.bfloat16, 1, 64, 4, 1, (64, 4, (4, 1, 1))),
    # the deepseek-v3 cut, (192, 128): 64 queries of one head a CTA
    (torch.bfloat16, 1, 512, 128, 128, (64, 1, (8, 128, 1))),
    (torch.bfloat16, 1, 64, 128, 128, (64, 1, (1, 128, 1))),
    # the reference test shapes: rep 2, rep 8 (4 heads of 8), rep 1, Sq 37
    (torch.bfloat16, 2, 64, 4, 2, (64, 2, (2, 2, 2))),
    (torch.bfloat16, 2, 128, 8, 1, (64, 4, (8, 2, 2))),
    (torch.bfloat16, 1, 37, 4, 4, (64, 1, (1, 4, 1))),
    (torch.bfloat16, 1, 65, 8, 2, (64, 4, (5, 2, 1))),
    # fp32 keeps the scalar kernel: 16 queries of one head a CTA
    (torch.float32, 1, 512, 4, 1, (16, 1, (32, 4, 1))),
    (torch.float32, 1, 512, 128, 128, (16, 1, (32, 128, 1))),
])
def test_prefill_grid_plan(dtype, B, Sq, H, KV, want):
    rows, hp, grid = grid_plan(dtype, B, Sq, H, KV)
    assert (rows, hp, grid) == want
    assert (H // KV) % hp == 0 and grid[0] * (rows // hp) >= Sq


@pytest.mark.parametrize("dtype,B,H,live,want", [
    # deepseek-v3, 128 heads: one cluster of 8 CTAs of 16 heads a split;
    # bf16 64-key tiles up to 8 splits, fp32 32-key tiles up to 12
    (torch.bfloat16, 1, 128, 1, (8, 8, 1, 64)),
    (torch.bfloat16, 1, 128, 300, (8, 8, 5, 64)),      # a tile a split
    (torch.bfloat16, 1, 128, 1024, (8, 8, 8, 128)),
    (torch.bfloat16, 1, 128, 256, (8, 8, 4, 64)),      # the 256-key window
    (torch.bfloat16, 1, 128, 0, (8, 8, 1, 64)),        # no live key
    (torch.float32, 1, 128, 300, (8, 8, 10, 32)),
    (torch.float32, 1, 128, 1024, (8, 8, 11, 96)),
    # 40 heads: 3 CTAs a cluster, the last one half full
    (torch.bfloat16, 1, 40, 200, (3, 3, 4, 64)),
    (torch.float32, 2, 24, 64, (2, 2, 2, 32)),
    # the reference's test widths: a single CTA a split
    (torch.bfloat16, 2, 4, 100, (1, 1, 2, 64)),
    (torch.float32, 1, 2, 150, (1, 1, 5, 32)),
])
def test_mla_split_plan(dtype, B, H, live, want):
    csize, groups, nsplit, chunk = mla_split_plan(B, H, live, dtype)
    assert (csize, groups, nsplit, chunk) == want
    assert groups % csize == 0 and groups * 16 >= H and csize <= 8
    assert nsplit * chunk >= live and (nsplit - 1) * chunk < max(live, 1)


@pytest.mark.parametrize("args,want", [
    # (B, S, H, G, P, N, chunk) -> C·B, chunk states, chunk decays
    ((1, 271, 48, 1, 64, 128, 256),                  # mamba2-780m, cold
     ((1, 1, 2, 256, 256), (1, 48, 2, 64, 128), (1, 48, 2))),
    ((1, 48, 48, 1, 64, 128, 256),                   # a resumed suffix
     ((1, 1, 1, 64, 64), (1, 48, 1, 64, 128), (1, 48, 1))),
    ((1, 300, 48, 1, 64, 128, 64),                   # five chunks
     ((1, 1, 5, 64, 64), (1, 48, 5, 64, 128), (1, 48, 5))),
    ((2, 200, 8, 2, 64, 128, 100),                   # chunk ends mid-tile
     ((2, 2, 2, 128, 128), (2, 8, 2, 64, 128), (2, 8, 2))),
])
def test_ssd_scratch_plan(args, want):
    assert ssd_scratch_plan(*args) == want


def test_ssd_rows_vectorizable():
    """The kernel reads x, B and C as 16-byte vectors only where every row
    starts on 16 bytes: views of a conv output [1, S, H*P + 2*G*N] are, and
    the same views one element further on are not."""
    H, P, N, G = 4, 32, 16, 1
    width = H * P + 2 * G * N

    def views(xbc):
        x = xbc[..., :H * P].unflatten(-1, (H, P))
        B_ = xbc[..., H * P:H * P + G * N].unflatten(-1, (G, N))
        C_ = xbc[..., H * P + G * N:].unflatten(-1, (G, N))
        return x, B_, C_

    for dtype in (torch.float32, torch.bfloat16):
        assert rows_vectorizable(*views(torch.zeros((1, 10, width),
                                                    dtype=dtype)))
        assert not rows_vectorizable(*views(torch.zeros(
            (1, 10, width + 1), dtype=dtype)[..., 1:]))
