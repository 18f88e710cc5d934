"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips where there is no card (a
CUDA kernel has no CPU mode). This file imports no JAX, so it also runs
on a machine without the reference package:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 1e-5 (the same fp32 arithmetic in another order; exp
differs in the last bits), bf16 2e-2 (both outputs rounded to bf16 once
from fp32 results, up to 2^-8 relative each).
"""
import pytest
import torch

from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
from repro_torch.kernels.flash_prefill import (flash_prefill,
                                               flash_prefill_plain)

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
