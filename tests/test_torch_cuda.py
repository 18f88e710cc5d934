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
both dtypes; the chunked products sum in another order); ``moe_gemm``
fp32 1e-5 and bf16 2e-2 (fp32 sums in another order; one bf16 rounding
of the output) against the largest magnitude of the plain output, whose
sums over K of up to 7168 reach tens.
"""
import math

import pytest
import torch

from repro_torch.kernels import flash_decode as decode_mod
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
from repro_torch.kernels.flash_prefill import (flash_prefill,
                                               flash_prefill_plain)
from repro_torch.kernels.mla_decode import mla_decode, mla_decode_plain
from repro_torch.kernels.mla_decode import split_plan as mla_split_plan
from repro_torch.kernels.moe_gemm import moe_gemm, moe_gemm_plain
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
    (4, 512, 512, 4, 1, 256, 0, None),     # the batched fresh prefill, B=4
    # the dense configs' widths: (H, KV, dh), cold and resumed
    (1, 291, 1024, 32, 8, 64, 0, None),    # llama3.2-1b
    (1, 31, 1024, 32, 8, 64, 253, None),
    (1, 291, 1024, 12, 2, 128, 0, None),   # qwen2-vl-2b
    (1, 31, 1024, 12, 2, 128, 253, None),
    (1, 291, 1024, 32, 8, 128, 0, None),   # qwen3-4b
    (1, 291, 1024, 32, 4, 128, 0, None),   # yi-6b
    (1, 291, 1024, 48, 8, 128, 0, None),   # nemotron-4-15b
    (4, 306, 512, 32, 8, 64, 0, None),     # llama3.2-1b batched, B=4
    # hymba-1.5b's widths (25/5, dh 64) on its linearised ring, window 1024
    (1, 419, 419, 25, 5, 64, 0, 1024),     # cold, 128 meta + 291 tokens
    (1, 31, 412, 25, 5, 64, 381, 1024),    # resume, ring not full
    (1, 1223, 1223, 25, 5, 64, 0, 1024),   # cold past the window
    (1, 31, 1055, 25, 5, 64, 1024, 1024),  # resume over a full ring
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
    # the dense configs' widths: (H, KV, dh)
    (1, 1024, 32, 8, 64, 64, 300, None),    # llama3.2-1b
    (4, 1024, 32, 8, 64, 64, 1024, None),
    (1, 1024, 12, 2, 128, 128, 300, None),  # qwen2-vl-2b
    (1, 1024, 32, 8, 128, 128, 300, None),  # qwen3-4b
    (1, 1024, 32, 4, 128, 128, 300, None),  # yi-6b
    (1, 1024, 48, 8, 128, 128, 300, None),  # nemotron-4-15b
    (1, 1024, 25, 5, 64, 64, 1024, None),   # hymba-1.5b, a full ring
    (4, 1024, 25, 5, 64, 64, 420, None),
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


def _counters(dev):
    """The decode kernels' arrival counters for launches on ``dev``'s
    current stream."""
    return decode_mod._COUNTERS[decode_mod.counters_key(dev)]


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
    (4, 512, 512, 128, 0, None),           # the batched fresh prefill, B=4
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
    assert torch.count_nonzero(_counters(out.device)) == 0


PER_ROW_DECODE_CASES = [
    # Sk, H, KV, dh, dv, kv_len of each row, win, kv_max (None: Sk)
    (1024, 4, 1, 256, 256, (0, 1, 300, 1024), None, 1024),  # gemma3 slots
    (1024, 4, 1, 256, 256, (0, 1, 300, 1024), 100, 1024),
    (1024, 4, 1, 256, 256, (7, 0, 300, 64), None, None),     # grid from Sk
    (128, 4, 2, 32, 32, (100, 0, 5), 16, 100),
    (2048, 4, 1, 128, 128, (2000, 33, 1, 1500), None, 2000),  # empty splits
    (200, 16, 1, 576, 512, (150, 0), None, 150),            # MLA latent widths
    (300, 4, 4, 128, 128, (0, 0, 0), None, 0),              # every row empty
    (1024, 4, 1, 256, 256, (0, 1, 300, 1024), 100, 512),    # a row past kv_max
    (1024, 32, 8, 64, 64, (0, 1, 300, 1024), None, 1024),   # llama3.2-1b slots
    (1024, 12, 2, 128, 128, (0, 1, 300, 1024), None, 1024),  # qwen2-vl-2b
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", PER_ROW_DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kv_len_per_row_cuda_vs_plain(case, dtype, cuda_device):
    """kv_len read from device memory, one a row: each row attends to its
    own keys in one launch, a row of 0 keys gives 0, and the counters are
    left at 0."""
    Sk, H, KV, dh, dv, lens, win, kv_max = case
    B = len(lens)
    gen = torch.Generator().manual_seed(29)
    q = _rand(gen, (B, H, dh), dtype, cuda_device)
    k = _rand(gen, (B, Sk, KV, dh), dtype, cuda_device)
    v = _rand(gen, (B, Sk, KV, dv), dtype, cuda_device)
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    scale = 1.0 / 192 ** 0.5 if dh != dv else None
    n0 = flash_decode.launches
    out = flash_decode(q, k, v, kv_len=kv, window=win, scale=scale,
                       kv_max=kv_max)
    torch.cuda.synchronize()
    assert flash_decode.launches == n0 + 1
    plain = flash_decode_plain(q, k, v, kv_len=kv, window=win, scale=scale,
                               kv_max=kv_max)
    torch.testing.assert_close(out.float(), plain.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    for b, n in enumerate(lens):
        if n == 0:
            assert torch.count_nonzero(out[b]) == 0
    assert torch.count_nonzero(_counters(out.device)) == 0


PER_ROW_MLA_CASES = [
    # S, H, R, Dr, kv_len of each row, win, kv_max
    (1024, 128, 512, 64, (0, 1, 300, 1024), None, 1024),  # deepseek-v3 slots
    (1024, 128, 512, 64, (0, 1, 300, 1024), 256, 1024),
    (1024, 128, 512, 64, (5, 0, 700, 40), None, None),    # grid from S
    (256, 40, 512, 64, (200, 0, 17), None, 200),
    (128, 4, 64, 16, (100, 3), 32, 100),
    (64, 128, 512, 64, (0, 0), None, 0),                  # every row empty
    (1024, 128, 512, 64, (0, 1, 300, 1024), 256, 512),    # a row past kv_max
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", PER_ROW_MLA_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_decode_kv_len_per_row_cuda_vs_plain(case, dtype, cuda_device):
    """The same for mla_decode: a cluster's CTAs share one row, so an
    empty split is left by the whole cluster (a hang here is a failure,
    not a timeout to tune)."""
    S, H, R, Dr, lens, win, kv_max = case
    B = len(lens)
    gen = torch.Generator().manual_seed(31)
    q_lat, q_rope = (_rand(gen, (B, H, w), dtype, cuda_device)
                     for w in (R, Dr))
    ckv, krope = (_rand(gen, (B, S, w), dtype, cuda_device) for w in (R, Dr))
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    args = dict(kv_len=kv, window=win, scale=1.0 / 192 ** 0.5)
    n0 = mla_decode.launches
    out = mla_decode(q_lat, q_rope, ckv, krope, kv_max=kv_max, **args)
    torch.cuda.synchronize()
    assert mla_decode.launches == n0 + 1
    plain = mla_decode_plain(q_lat, q_rope, ckv, krope, kv_max=kv_max,
                             **args)
    torch.testing.assert_close(out.float(), plain.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    for b, n in enumerate(lens):
        if n == 0:
            assert torch.count_nonzero(out[b]) == 0
    assert torch.count_nonzero(_counters(out.device)) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_streams_decode_at_once(dtype, cuda_device):
    """flash_decode and mla_decode launched on two streams at once, many
    times over, each launch with many splits merged by its last CTA: each
    stream keeps its own arrival counters, every output equals the plain
    version and every counter is back at 0."""
    gen = torch.Generator().manual_seed(31)
    dev = cuda_device
    B, Sk, H, KV, dh = 4, 4096, 4, 1, 128
    q = _rand(gen, (B, H, dh), dtype, dev)
    k = _rand(gen, (B, Sk, KV, dh), dtype, dev)
    v = _rand(gen, (B, Sk, KV, dh), dtype, dev)
    lens = torch.tensor([4096, 1, 3000, 777], dtype=torch.int32, device=dev)
    R, Dr, MH = 512, 64, 128
    q_lat, q_rope = (_rand(gen, (B, MH, w), dtype, dev) for w in (R, Dr))
    ckv, krope = (_rand(gen, (B, 2048, w), dtype, dev) for w in (R, Dr))
    mla_args = dict(kv_len=1500, scale=1.0 / 192 ** 0.5)
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    torch.cuda.synchronize()
    outs = {0: [], 1: []}
    keys = set()
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                keys.add(decode_mod.counters_key(dev))
                outs[i].append((
                    flash_decode(q, k, v, kv_len=lens, kv_max=Sk),
                    mla_decode(q_lat, q_rope, ckv, krope, **mla_args)))
    torch.cuda.synchronize()
    assert len(keys) == 2
    assert len({decode_mod._COUNTERS[key].data_ptr() for key in keys}) == 2
    want = flash_decode_plain(q, k, v, kv_len=lens, kv_max=Sk).float()
    want_mla = mla_decode_plain(q_lat, q_rope, ckv, krope,
                                **mla_args).float()
    for i in outs:
        for o, o_mla in outs[i]:
            torch.testing.assert_close(o.float(), want, atol=TOL[dtype],
                                       rtol=TOL[dtype])
            torch.testing.assert_close(o_mla.float(), want_mla,
                                       atol=TOL[dtype], rtol=TOL[dtype])
    for key in keys:
        assert torch.count_nonzero(decode_mod._COUNTERS[key]) == 0


@pytest.mark.cuda
def test_a_larger_batch_reuses_the_reserved_counters(cuda_device):
    """A pool whose decode grid needs more counters than the buffer's
    1024 floor (MLA, 128 heads in 8 head groups, 160 rows) reserves them
    at construction: a decode at B=1, then decode steps at the pool's B,
    use that one buffer and leave every counter at 0. A kv_len tensor the
    kernel cannot read raises."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.deepseek_v3_671b import dense_cut
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import BatchedEngine, InferenceEngine
    B = 160
    assert B * mla_split_plan(B, 128, 1)[1] > 1024
    cfg = dense_cut(get_config("deepseek-v3-671b").reduced(), 2).replace(
        n_heads=128)
    m = Model(cfg, device=cuda_device)
    dev = torch.zeros(1, device=m.device).device      # cuda:<index>
    torch.cuda.synchronize()
    key = decode_mod.counters_key(dev)
    decode_mod._COUNTERS.pop(key, None)
    eng = BatchedEngine(m, 64, batch_size=B)
    buf = decode_mod._COUNTERS[key]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(3, cfg.vocab, (n,)) for n in (21, 9, 30)]
    single = InferenceEngine(m, 64)
    n0 = mla_decode.launches
    single.generate(single.start({"tokens": prompts[0][None]}), 3)
    assert mla_decode.launches > n0                    # decodes at B=1
    eng.prefill_slots([0, 7, B - 1], prompts)
    active = np.zeros(B, bool)
    active[[0, 7, B - 1]] = True
    n0 = mla_decode.launches
    for _ in range(2):
        eng.decode_batch(np.full(B, 5, np.int32), active)
    torch.cuda.synchronize()
    assert mla_decode.launches == n0 + 2 * cfg.n_layers
    assert decode_mod._COUNTERS[key].data_ptr() == buf.data_ptr()
    assert torch.count_nonzero(buf) == 0
    gen = torch.Generator().manual_seed(37)
    q = _rand(gen, (2, 4, 256), torch.bfloat16, dev)
    kv = _rand(gen, (2, 512, 1, 256), torch.bfloat16, dev)
    lens = torch.tensor([3, 512], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        flash_decode(q, kv, kv, kv_len=lens.long())
    with pytest.raises(ValueError, match="int32"):
        flash_decode(q, kv, kv, kv_len=lens.cpu())
    with pytest.raises(ValueError, match="kv_max"):
        flash_decode(q, kv, kv, kv_len=lens, kv_max=513)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gemma3-270m", "deepseek-v3-671b",
                                  "llama3.2-1b", "qwen2-vl-2b",
                                  "hymba-1.5b", "granite-moe-3b-a800m"])
def test_batched_decode_is_one_launch_a_layer(name, cuda_device):
    """A decode step of four slots at their own positions (one inactive)
    launches the decode kernel once a layer (and ``moe_gemm`` three times a
    MoE layer: all rows in one call) and equals each row decoded alone
    (fp32, reduced widths; hymba's rows on rings of 16 slots, two of them
    wrapped; deepseek-v3 cut to its dense layers)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.deepseek_v3_671b import dense_cut
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import BatchedEngine, InferenceEngine
    cfg = get_config(name).reduced()
    if cfg.moe.first_k_dense and cfg.uses_mla:
        cfg = dense_cut(cfg, 2)
    kernel = mla_decode if cfg.uses_mla else flash_decode
    m = Model(cfg, device=cuda_device)
    n_moe = sum(s.n_layers for s in m.segment_specs if s.kind.endswith("moe"))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(3, cfg.vocab, (n,)) for n in (21, 9, 30)]
    eng = BatchedEngine(m, 64, batch_size=4)
    eng.prefill_slots([0, 1, 3], prompts)
    single = InferenceEngine(m, 64)
    sts = [single.start({"tokens": p[None]}) for p in prompts]
    toks = np.array([5, 6, 0, 7], np.int32)
    n0, g0 = kernel.launches, moe_gemm.launches
    step = eng.decode_batch(toks, np.array([True, True, False, True]))
    assert kernel.launches == n0 + cfg.n_layers
    assert moe_gemm.launches == g0 + 3 * n_moe
    for row, st in zip((0, 1, 3), sts):
        want = single.decode_one(st, toks[row:row + 1, None])
        np.testing.assert_allclose(step[row], want[0], atol=2e-5, rtol=1e-4)


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
    assert torch.count_nonzero(_counters(out.device)) == 0


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
    (419, False, 64, 50, 64, 16, 1),       # hymba-1.5b's SSM, cold
    (31, True, 64, 50, 64, 16, 1),         # hymba-1.5b, a resume
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


@pytest.mark.cuda
def test_gateway_on_the_card_matches_a_direct_run(cuda_device):
    """A port ``Gateway`` on ``Fabric.local()`` serves reduced gemma3-270m
    (fp32) on the card from its engine thread: a cold request and its
    full-hit repeat give a direct ``Scheduler`` run's tokens, and every
    decode step launches ``flash_decode`` once a layer."""
    import http.client
    import json
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.fabric import Fabric
    from repro_torch.gateway import Gateway, protocol
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import BatchedEngine
    from repro_torch.serving.scheduler import Request, Scheduler
    cfg = get_config("gemma3-270m").reduced()
    m = Model(cfg, device=cuda_device)
    body = {"messages": [{"role": "system", "content": "terse assistant"},
                         {"role": "user", "content": "name a planet"}],
            "max_tokens": 6}
    gw = Gateway(m, fabric=Fabric.local(), batch_size=2, max_len=128)
    segs = protocol.tokenize_messages(
        gw.tokenizer, [(x["role"], x["content"]) for x in body["messages"]])
    req = Request(tokens=np.asarray(segs.token_ids, np.int32),
                  max_new_tokens=6)
    Scheduler(BatchedEngine(m, 128, 1)).run([req])
    torch.cuda.synchronize()
    gw.start()
    try:
        outs = []
        for _ in range(2):
            steps0, n0 = gw.engine.sched.n_steps, flash_decode.launches
            c = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=120)
            c.request("POST", "/v1/chat/completions", json.dumps(body),
                      {"Content-Type": "application/json"})
            r = c.getresponse()
            assert r.status == 200
            outs.append(json.loads(r.read()))
            c.close()
            steps = gw.engine.sched.n_steps - steps0
            assert steps > 0
            assert flash_decode.launches - n0 == steps * cfg.n_layers
            gw.engine.fetcher.flush_uploads()
    finally:
        gw.stop()
    assert outs[0]["cache"]["matched_tokens"] == 0
    assert outs[1]["cache"]["matched_tokens"] == len(segs.token_ids)
    for out in outs:
        assert out["choices"][0]["token_ids"] == req.stats.output_tokens


@pytest.mark.cuda
def test_weights_are_drawn_on_the_card_from_the_seed(cuda_device):
    """``Model(seed=...)`` on the card draws with a generator there: the
    same seed gives the same weights, another seed others, and the dense
    weights keep the reference's truncated-normal bound (2 / sqrt(fan_in))."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = get_config("llama3.2-1b").reduced()
    a, b = (Model(cfg, device=cuda_device, seed=3) for _ in range(2))
    c = Model(cfg, device=cuda_device, seed=4)
    for name, t in a.state_dict().items():
        assert t.is_cuda and torch.equal(t, b.state_dict()[name]), name
    wq = a.state_dict()["segments.0.attn.wq"]
    assert not torch.equal(wq, c.state_dict()["segments.0.attn.wq"])
    assert wq.abs().max() <= 2.0 / cfg.d_model ** 0.5 + 1e-6


MOE_GEMM_CASES = [
    # M, K, N, experts, group sizes: a tuple, or M rows spread over the
    # first `used` experts (None: all) by a seed, the rest left empty as
    # padded experts are
    (8, 128, 128, 4, None),                # reduced widths, decode (top 2)
    (40, 64, 48, 10, (0, 7, 0, 12, 1, 0, 13, 0, 0, 0)),  # empty groups;
                                           # rows past the last group are 0
    (8, 1536, 512, 48, 40),                # granite up/gate, decode
    (32, 512, 1536, 48, 40),               # granite down, 4 rows decoding
    (4096, 1536, 512, 48, 40),             # granite up, a 512-row bucket
    (8, 7168, 2048, 256, None),            # deepseek up/gate, decode
    (4096, 2048, 7168, 256, None),         # deepseek down, a 512-row bucket
]


def _moe_gemm_inputs(case, dtype, dev, seed=21):
    """xs [M, K] ~ N(0, 1), w [E, K, N] ~ N(0, 1) / sqrt(K) (drawn on the
    card: deepseek's stacks hold 3.8G values), int32 offsets."""
    M, K, N, E, groups = case
    gen = torch.Generator().manual_seed(seed)
    wgen = torch.Generator(device=dev).manual_seed(seed)
    if isinstance(groups, tuple):
        sizes = torch.tensor(groups)
    else:
        ids = torch.randint(0, groups or E, (M,), generator=gen)
        sizes = torch.bincount(ids, minlength=E)
    offsets = torch.cat([torch.zeros(1, dtype=torch.long),
                         sizes.cumsum(0)]).to(dev, torch.int32)
    xs = _rand(gen, (M, K), dtype, dev)
    w = (torch.randn((E, K, N), generator=wgen, device=dev)
         / K ** 0.5).to(dtype)
    return xs, w, offsets


@pytest.mark.cuda
@pytest.mark.parametrize("case", MOE_GEMM_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gemm_cuda_vs_plain(case, dtype, cuda_device):
    xs, w, offsets = _moe_gemm_inputs(case, dtype, cuda_device)
    n0 = moe_gemm.launches
    out = moe_gemm(xs, w, offsets)
    torch.cuda.synchronize()
    assert moe_gemm.launches == n0 + 1 and out.shape == (xs.shape[0],
                                                          w.shape[2])
    plain = moe_gemm_plain(xs, w, offsets)
    err = (out.float() - plain.float()).abs().max().item()
    assert err <= TOL[dtype] * max(1.0, plain.float().abs().max().item())
    last = int(offsets[-1])
    assert torch.count_nonzero(out[last:]) == 0


@pytest.mark.cuda
def test_moe_gemm_reads_a_layer_view_and_refuses_what_it_cannot_take(
        cuda_device):
    """A layer's ``[E, K, N]`` view of an ``[L, E, K, N]`` stack is read in
    place; wrong dtypes, widths off 16 bytes and int64 offsets raise."""
    gen = torch.Generator().manual_seed(5)
    stack = _rand(gen, (2, 4, 64, 32), torch.bfloat16, cuda_device)
    xs = _rand(gen, (6, 64), torch.bfloat16, cuda_device)
    off = torch.tensor([0, 2, 2, 5, 6], dtype=torch.int32, device=cuda_device)
    torch.testing.assert_close(moe_gemm(xs, stack[1], off),
                               moe_gemm_plain(xs, stack[1], off),
                               atol=2e-2, rtol=2e-2)
    with pytest.raises(ValueError, match="int32"):
        moe_gemm(xs, stack[1], off.long())
    with pytest.raises(ValueError, match="dtypes"):
        moe_gemm(xs.float(), stack[1], off)
    with pytest.raises(ValueError, match="16-byte"):
        moe_gemm(xs[:, :60], stack[1][:, :60], off)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_layer_is_captured_by_a_cuda_graph(dtype, cuda_device):
    """``moe_forward`` at granite-reduced widths, decode (4 tokens) and a
    prefill of 37: captured by ``torch.cuda.graph`` (which fails on any
    device-to-host read) and replayed on new inputs, equal to the eager
    result; the shared expert's path on deepseek-reduced too."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for name in ("granite-moe-3b-a800m", "deepseek-v3-671b"):
        cfg = get_config(name).reduced()
        p = moe.init_moe(cfg, dtype, gen, device=cuda_device)
        for T in (4, 37):
            x = torch.randn((1, T, cfg.d_model), device=cuda_device,
                            dtype=dtype)
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                moe.moe_forward(p, cfg, x, aux=False)      # warm up
            torch.cuda.current_stream().wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            n0 = moe_gemm.launches
            with torch.cuda.graph(graph):
                out, _ = moe.moe_forward(p, cfg, x, aux=False)
            assert moe_gemm.launches == n0 + 3
            x.copy_(torch.randn(x.shape, device=cuda_device, dtype=dtype))
            graph.replay()
            torch.cuda.synchronize()
            want, _ = moe.moe_forward(p, cfg, x, aux=False)
            torch.testing.assert_close(out, want, atol=TOL[dtype],
                                       rtol=TOL[dtype])
