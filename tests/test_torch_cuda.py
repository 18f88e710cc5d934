"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips where there is no card (a
CUDA kernel has no CPU mode). This file imports no JAX, so it also runs
on a machine without the reference package:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: attention (``flash_prefill``, ``flash_decode``, ``mla_decode``)
fp32 1e-5 (the same fp32 arithmetic in another
order; exp differs in the last bits), bf16 2e-2 (both outputs rounded to
bf16 once from fp32 results, up to 2^-8 relative each); ``ssd_scan``
atol 2e-4, rtol 1e-3, the reference's kernel tolerance (fp32 outputs in
both dtypes; the chunked products sum in another order).
"""
import math

import pytest
import torch

from repro_torch.kernels import flash_decode as decode_mod
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
from repro_torch.kernels.flash_prefill import (flash_prefill,
                                               flash_prefill_plain)
from repro_torch.kernels.mla_decode import mla_decode, mla_decode_plain
from repro_torch.kernels.ssd_scan import (rows_vectorizable, ssd_scan,
                                          ssd_scan_plain)

PREFILL_CASES = [
    # B, Sq, Sk, H, KV, dh, off, win  (the reference's kernel cases)
    (2, 64, 64, 4, 2, 32, 0, None),
    (1, 37, 128, 4, 4, 64, 91, None),      # ragged + prefix resume
    (2, 128, 128, 8, 1, 32, 0, 48),        # MQA + sliding window
    (1, 1, 256, 4, 2, 64, 200, None),      # suffix of one token
    (1, 96, 96, 2, 2, 128, 0, None),       # wide head dim
    (1, 512, 1024, 4, 1, 256, 0, None),    # gemma3-270m, cold prefill
    (1, 64, 1024, 4, 1, 256, 448, None),   # gemma3-270m, resume
    (1, 16, 64, 4, 1, 256, 0, None),       # kv_len 16 of a 64 cache
    (1, 65, 256, 8, 2, 64, 0, None),       # Sq 65; 4 heads packed per CTA
    (1, 100, 300, 4, 1, 128, 77, None),    # kv_len 177 ends mid-tile
    (1, 50, 256, 4, 2, 64, 100, 40),       # resume, window across tiles
    (2, 33, 128, 8, 2, 32, 20, 24),        # GQA H=8 KV=2 with a window
    (1, 40, 64, 4, 1, 64, 40, 8),          # rows at qpos >= 72 see no key
    (1, 37, 512, 4, 1, 256, 300, None),    # gemma3-270m widths, ragged Sq
]

DECODE_CASES = [
    # B, Sk, H, KV, dh, dv, kv_len, win
    (2, 128, 4, 2, 32, 32, 100, None),
    (1, 512, 8, 8, 64, 64, 512, None),
    (2, 256, 4, 1, 32, 32, 250, 64),       # windowed decode
    (1, 300, 4, 4, 128, 128, 17, None),    # short valid region, ragged Sk
    (1, 1024, 4, 1, 256, 256, 1, None),    # gemma3-270m
    (1, 1024, 4, 1, 256, 256, 300, None),
    (1, 1024, 4, 1, 256, 256, 1024, None),
    (1, 1024, 4, 1, 256, 256, 0, None),    # no live key -> 0
    (1, 200, 16, 1, 576, 512, 150, None),  # MLA latent widths, dv != dh
    (1, 300, 2, 2, 576, 512, 1, None),     # one split, one head a CTA
    (1, 1024, 4, 1, 256, 256, 700, 100),   # gemma3-270m with a window
    (2, 2048, 4, 1, 128, 128, 2000, None),  # 63 splits per head group
    (1, 4096, 4, 1, 64, 64, 4096, None),   # 128 splits in one merge
]

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


def _rand(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen).to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", PREFILL_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_prefill_cuda_vs_plain(case, dtype, cuda_device):
    B, Sq, Sk, H, KV, dh, off, win = case
    gen = torch.Generator().manual_seed(7)
    q = _rand(gen, (B, Sq, H, dh), dtype, cuda_device)
    k = _rand(gen, (B, Sk, KV, dh), dtype, cuda_device)
    v = _rand(gen, (B, Sk, KV, dh), dtype, cuda_device)
    kv_len = min(off + Sq, Sk)
    n0 = flash_prefill.launches
    out = flash_prefill(q, k, v, q_offset=off, kv_len=kv_len, window=win)
    torch.cuda.synchronize()
    assert flash_prefill.launches == n0 + 1
    plain = flash_prefill_plain(q, k, v, q_offset=off, kv_len=kv_len,
                                window=win)
    torch.testing.assert_close(out.float(), plain.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


MLA_PREFILL_CASES = [
    # B, Sq, Sk, H, off, win  (dh 192, dv 128: MLA's prefill)
    (1, 512, 512, 128, 0, None),           # deepseek-v3 heads, cold prompt
    (1, 33, 300, 128, 267, None),          # resume of a 33-token suffix
    (2, 40, 64, 4, 0, 16),                 # sliding window, two rows
    (1, 33, 200, 128, 100, None),          # 33 queries at q_offset 100
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MLA_PREFILL_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_prefill_narrow_values_cuda_vs_plain(case, dtype, cuda_device):
    B, Sq, Sk, H, off, win = case
    gen = torch.Generator().manual_seed(5)
    q = _rand(gen, (B, Sq, H, 192), dtype, cuda_device)
    k = _rand(gen, (B, Sk, H, 192), dtype, cuda_device)
    v = _rand(gen, (B, Sk, H, 128), dtype, cuda_device)
    kv_len = min(off + Sq, Sk)
    n0 = flash_prefill.launches
    out = flash_prefill(q, k, v, q_offset=off, kv_len=kv_len, window=win)
    torch.cuda.synchronize()
    assert flash_prefill.launches == n0 + 1 and out.shape == (B, Sq, H, 128)
    plain = flash_prefill_plain(q, k, v, q_offset=off, kv_len=kv_len,
                                window=win)
    torch.testing.assert_close(out.float(), plain.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.cuda
def test_flash_prefill_reads_a_strided_cache(cuda_device):
    """The kernel reads one layer of a stacked [L, B, S, KV, dh] cache in
    place, and a q that is a view with padded strides."""
    gen = torch.Generator().manual_seed(3)
    cache = _rand(gen, (3, 1, 128, 1, 256), torch.bfloat16, cuda_device)
    big = _rand(gen, (1, 40, 6, 256), torch.bfloat16, cuda_device)
    q = big[:, :, 1:5]                     # strides (40*6*256, 6*256, 256, 1)
    out = flash_prefill(q, cache[1], cache[2], q_offset=60, kv_len=100)
    plain = flash_prefill_plain(q, cache[1], cache[2], q_offset=60,
                                kv_len=100)
    torch.testing.assert_close(out.float(), plain.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_cuda_vs_plain(case, dtype, cuda_device):
    B, Sk, H, KV, dh, dv, kv_len, win = case
    gen = torch.Generator().manual_seed(11)
    q = _rand(gen, (B, H, dh), dtype, cuda_device)
    k = _rand(gen, (B, Sk, KV, dh), dtype, cuda_device)
    v = _rand(gen, (B, Sk, KV, dv), dtype, cuda_device)
    scale = 1.0 / 192 ** 0.5 if dh != dv else None
    n0 = flash_decode.launches
    out = flash_decode(q, k, v, kv_len=kv_len, window=win, scale=scale)
    torch.cuda.synchronize()
    assert flash_decode.launches == n0 + 1
    plain = flash_decode_plain(q, k, v, kv_len=kv_len, window=win,
                               scale=scale)
    torch.testing.assert_close(out.float(), plain.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    if kv_len == 0:
        assert torch.count_nonzero(out) == 0
    # the last CTA of each head group left its arrival counter at 0
    assert torch.count_nonzero(decode_mod._COUNTERS[out.device]) == 0


@pytest.mark.cuda
def test_unsupported_inputs_raise_on_the_card(cuda_device):
    q = torch.zeros((1, 4, 4, 48), device=cuda_device)
    kv = torch.zeros((1, 16, 1, 48), device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash_prefill(q, kv, kv, kv_len=4)
    with pytest.raises(ValueError, match="dtypes"):
        flash_decode(q[:, 0].half(), kv.half(), kv.half(), kv_len=4)
    flat = torch.zeros(4 * 4 * 32 + 1, device=cuda_device)
    q_off = flat[1:].view(1, 4, 4, 32)          # rows 4 bytes off 16
    kv32 = torch.zeros((1, 16, 1, 32), device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        flash_prefill(q_off, kv32, kv32, kv_len=4)


MLA_DECODE_CASES = [
    # B, S, H, R, Dr, kv_len, win
    (1, 1024, 128, 512, 64, 1, None),      # deepseek-v3 widths
    (1, 1024, 128, 512, 64, 300, None),
    (1, 1024, 128, 512, 64, 1024, None),
    (1, 1024, 128, 512, 64, 700, 256),     # windowed
    (1, 64, 128, 512, 64, 0, None),        # no live key -> 0
    (2, 128, 4, 64, 16, 100, None),        # tests/test_kernels.py widths
    (2, 128, 4, 64, 16, 100, 32),
    (1, 256, 8, 128, 32, 256, None),
    (1, 256, 8, 128, 32, 256, 40),
    (1, 192, 2, 32, 16, 150, 64),
    (1, 192, 2, 32, 16, 150, None),
    (1, 1024, 128, 512, 64, 33, None),     # kv_len ends inside a split
    (1, 1024, 128, 512, 64, 257, None),
    (1, 256, 40, 512, 64, 200, None),      # 40 heads: 3 CTAs, the last half full
    (2, 192, 24, 64, 16, 150, 64),         # two rows of 24 heads, windowed
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MLA_DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_decode_cuda_vs_plain(case, dtype, cuda_device):
    B, S, H, R, Dr, kv_len, win = case
    gen = torch.Generator().manual_seed(17)
    q_lat, q_rope = (_rand(gen, (B, H, w), dtype, cuda_device)
                     for w in (R, Dr))
    ckv, krope = (_rand(gen, (B, S, w), dtype, cuda_device) for w in (R, Dr))
    args = dict(kv_len=kv_len, window=win, scale=1.0 / 192 ** 0.5)
    n0 = mla_decode.launches
    out = mla_decode(q_lat, q_rope, ckv, krope, **args)
    torch.cuda.synchronize()
    assert mla_decode.launches == n0 + 1 and out.shape == (B, H, R)
    plain = mla_decode_plain(q_lat, q_rope, ckv, krope, **args)
    torch.testing.assert_close(out.float(), plain.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    if kv_len == 0:
        assert torch.count_nonzero(out) == 0
    # the last CTA of each head group left its arrival counter at 0
    assert torch.count_nonzero(decode_mod._COUNTERS[out.device]) == 0


@pytest.mark.cuda
def test_mla_decode_reads_the_cache_in_place(cuda_device):
    """One layer of a stacked [L, B, S, .] latent cache, and a q_rope that
    is the tail of each head's [q_nope; q_rope] row."""
    gen = torch.Generator().manual_seed(19)
    dt = torch.bfloat16
    ckv = _rand(gen, (3, 2, 256, 512), dt, cuda_device)
    krope = _rand(gen, (3, 2, 256, 64), dt, cuda_device)
    q_lat = _rand(gen, (2, 128, 512), dt, cuda_device)
    q_rope = _rand(gen, (2, 128, 192), dt, cuda_device)[..., 128:]
    args = dict(kv_len=200, scale=1.0 / 192 ** 0.5)
    out = mla_decode(q_lat, q_rope, ckv[1], krope[1], **args)
    plain = mla_decode_plain(q_lat, q_rope, ckv[1], krope[1], **args)
    torch.testing.assert_close(out.float(), plain.float(), atol=2e-2,
                               rtol=2e-2)
    with pytest.raises(ValueError, match="built for"):
        mla_decode(q_lat[..., :256], q_rope, ckv[1, ..., :256], krope[1],
                   **args)
    with pytest.raises(ValueError, match="dtypes"):
        mla_decode(q_lat.float(), q_rope, ckv[1], krope[1], **args)


SSD_CASES = [
    # S, random h0, chunk, H, P, N, G
    (271, False, 256, 48, 64, 128, 1),     # mamba2-780m cold prompt, ragged
    (48, True, 256, 48, 64, 128, 1),       # mamba2-780m suffix resume
    (1024, True, 256, 48, 64, 128, 1),     # four full chunks
    (100, True, 32, 4, 32, 16, 2),         # reduced widths, two groups
    (300, True, 64, 48, 64, 128, 1),       # state passed over 5 chunks
    (1, True, 256, 48, 64, 128, 1),        # one position
    (100, True, 32, 4, 32, 16, 4),         # G = H, the TPU kernel's contract
    (200, True, 100, 8, 64, 128, 2),       # chunks end mid-tile (100 = 64 + 36)
    (130, True, 64, 2, 128, 64, 1),        # two 64-row p blocks, N = 64
]


def _ssd_inputs(gen, S, random_h0, H, P, N, G, dtype, dev):
    """x, B and C as views of one conv output, as the model passes them;
    dt and A as the model initialises them."""
    xbc = (torch.randn((1, S, H * P + 2 * G * N), generator=gen) * 0.5).to(
        dev, dtype)
    x = xbc[..., :H * P].unflatten(-1, (H, P))
    B_ = xbc[..., H * P:H * P + G * N].unflatten(-1, (G, N))
    C_ = xbc[..., H * P + G * N:].unflatten(-1, (G, N))
    lo, hi = math.log(0.001), math.log(0.1)
    dt = torch.exp(torch.rand((1, S, H), generator=gen) * (hi - lo) + lo)
    A = -torch.arange(1, H + 1, dtype=torch.float32)
    h0 = torch.randn((1, H, P, N), generator=gen) * 0.2 if random_h0 \
        else torch.zeros((1, H, P, N))
    return x, dt.to(dev), A.to(dev), B_, C_, h0.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_cuda_vs_plain(case, dtype, cuda_device):
    S, random_h0, chunk, H, P, N, G = case
    gen = torch.Generator().manual_seed(13)
    args = _ssd_inputs(gen, S, random_h0, H, P, N, G, dtype, cuda_device)
    n0 = ssd_scan.launches
    y, h = ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == n0 + 1
    yr, hr = ssd_scan_plain(*args, chunk=chunk)
    torch.testing.assert_close(y, yr, atol=2e-4, rtol=1e-3)
    torch.testing.assert_close(h, hr, atol=2e-4, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_unaligned_rows(dtype, cuda_device):
    """x, B and C one element off 16 bytes: the kernel reads them element
    by element instead of as 16-byte vectors, with the same result."""
    gen = torch.Generator().manual_seed(23)
    H, P, N, G, S = 8, 32, 16, 2, 150
    xbc = (torch.randn((1, S, 1 + H * P + 2 * G * N), generator=gen)
           * 0.5).to(cuda_device, dtype)[..., 1:]
    x = xbc[..., :H * P].unflatten(-1, (H, P))
    B_ = xbc[..., H * P:H * P + G * N].unflatten(-1, (G, N))
    C_ = xbc[..., H * P + G * N:].unflatten(-1, (G, N))
    _, dt, A, _, _, h0 = _ssd_inputs(gen, S, True, H, P, N, G, dtype,
                                     cuda_device)
    assert not rows_vectorizable(x, B_, C_)
    n0 = ssd_scan.launches
    y, h = ssd_scan(x, dt, A, B_, C_, h0, chunk=64)
    torch.cuda.synchronize()
    assert ssd_scan.launches == n0 + 1
    yr, hr = ssd_scan_plain(x, dt, A, B_, C_, h0, chunk=64)
    torch.testing.assert_close(y, yr, atol=2e-4, rtol=1e-3)
    torch.testing.assert_close(h, hr, atol=2e-4, rtol=1e-3)


@pytest.mark.cuda
def test_ssd_scan_refuses_what_the_kernel_does_not_take(cuda_device):
    gen = torch.Generator().manual_seed(1)
    x, dt, A, B_, C_, h0 = _ssd_inputs(gen, 40, True, 4, 32, 16, 1,
                                       torch.float32, cuda_device)
    n0 = ssd_scan.launches
    big = _ssd_inputs(gen, 300, False, 4, 32, 16, 1, torch.float32,
                      cuda_device)
    with pytest.raises(ValueError, match="chunk up to 256"):
        ssd_scan(*big, chunk=300)
    with pytest.raises(ValueError, match="dtypes"):
        ssd_scan(x.half(), dt, A, B_.half(), C_.half(), h0, chunk=16)
    with pytest.raises(ValueError, match="float32"):
        ssd_scan(x, dt, A, B_, C_, h0.bfloat16(), chunk=16)
    with pytest.raises(ValueError, match="multiple of 16"):
        ssd_scan(x[..., :24], dt, A, B_, C_, h0[..., :24, :], chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x, dt, A, B_, C_, h0.transpose(2, 3).contiguous()
                 .transpose(2, 3), chunk=16)
    assert ssd_scan.launches == n0
