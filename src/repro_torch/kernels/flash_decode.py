"""Split-KV flash decode: one query token per head against the cache.

Replaces the TPU kernel ``repro/kernels/flash_decode.py::flash_decode``
(pallas_call at :89). For each (b, h) the query attends to keys
``kpos < kv_len`` (and ``kpos > kv_len - 1 - window`` with a window);
a row with no live key gives 0. ``v`` may be wider or narrower than
``k`` (MLA's latent decode) and ``scale`` overrides ``1/sqrt(dh)``.

On the card the wrapper launches the hand-written CUDA kernel
(``csrc/flash_decode.cu``, one launch: key splits over CTAs, and the last
CTA of each head group merges them). On the CPU it runs
:func:`flash_decode_plain`, the reference's einsum form. A CUDA tensor
never falls back to the plain version: an input the kernel does not take
raises. The kernel's arrival counters are one buffer per device, left at
0 by every launch, so launches on one device are ordered on one stream.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build

# (dh, dv) pairs the CUDA kernel is compiled for
WIDTHS = ((32, 32), (64, 64), (128, 128), (256, 256), (576, 512))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
N_SM = 132                 # H100 SXM streaming multiprocessors
TILE = 32                  # keys of a CTA's tile: 2 parts of 16, 2 lanes a key
_COUNTERS = {}             # device -> int32 arrival counters, all 0 (shared
                           # with mla_decode: launches on one stream)


def flash_decode_plain(q, k, v, *, kv_len: int,
                       window: Optional[int] = None,
                       scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,H,dh]; k: [B,Sk,KV,dh]; v: [B,Sk,KV,dv] -> [B,H,dv]."""
    B, H, dh = q.shape
    _, Sk, KV, _ = k.shape
    dv = v.shape[-1]
    rep = H // KV
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    qf = q.float().reshape(B, KV, rep, dh)
    s = torch.einsum("bgrd,bsgd->bgrs", qf, k.float()) * scale
    kpos = torch.arange(Sk, device=q.device)
    mask = kpos < kv_len
    if window is not None and window > 0:
        mask = mask & (kpos > (kv_len - 1) - window)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    o = torch.einsum("bgrs,bsgd->bgrd", p, v.float())
    return o.reshape(B, H, dv).to(q.dtype)


def split_plan(B: int, H: int, KV: int, live: int):
    """(heads per CTA, number of KV splits, keys per split). Up to one CTA
    per SM, each split a whole number of ``TILE``-key tiles, so a CTA walks
    few tiles and the last CTA's merge reads few partials."""
    rep = H // KV
    hg = next(g for g in (4, 2, 1) if rep % g == 0)
    want = max(1, N_SM // (B * (H // hg)))
    tiles = max(1, -(-live // TILE))
    chunk = TILE * -(-tiles // want)
    nsplit = max(1, -(-live // chunk))
    return hg, nsplit, chunk


def arrival_counters(dev, n: int) -> torch.Tensor:
    """``n`` arrival counters on ``dev``, zero (each launch resets those it
    used)."""
    buf = _COUNTERS.get(dev)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _COUNTERS[dev] = buf
    return buf


def flash_decode(q, k, v, *, kv_len: int, window: Optional[int] = None,
                 scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,H,dh]; k: [B,Sk,KV,dh]; v: [B,Sk,KV,dv] (the cache, read in
    place). ``kv_len`` and ``window`` (None for none) are runtime values.
    Returns [B,H,dv] in q's dtype."""
    B, H, dh = q.shape
    _, Sk, KV, _ = k.shape
    dv = v.shape[-1]
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, kv_len=kv_len, window=window,
                                  scale=scale)
    _check(q, k, v, H, KV, dh, dv, kv_len)
    kv_end = int(kv_len)
    kv_start = max(0, kv_end - window) if window and window > 0 else 0
    hg, nsplit, chunk = split_plan(B, H, KV, kv_end - kv_start)
    dev = q.device
    out = torch.empty((B, H, dv), dtype=q.dtype, device=dev)
    pm = torch.empty((B, H, nsplit), dtype=torch.float32, device=dev)
    pl = torch.empty_like(pm)
    pacc = torch.empty((B, H, nsplit, dv), dtype=torch.float32, device=dev)
    counters = arrival_counters(dev, B * (H // hg))
    scale = 1.0 / math.sqrt(dh) if scale is None else float(scale)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.launch(
            "flash_decode", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), pm.data_ptr(), pl.data_ptr(), pacc.data_ptr(),
            counters.data_ptr(),
            _DTYPES[q.dtype], B, H, KV, dh, dv, hg, nsplit,
            q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            chunk, kv_start, kv_end, scale, stream)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def _check(q, k, v, H, KV, dh, dv, kv_len) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: no kernel for device {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_decode: q, k, v on different devices")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_decode: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; the kernel takes float32 or bfloat16")
    if (dh, dv) not in WIDTHS or k.shape[3] != dh:
        raise ValueError(f"flash_decode: (dh, dv) = ({dh}, {dv}); the "
                         f"kernel is built for {WIDTHS}")
    if H % KV or q.shape[0] != k.shape[0] or v.shape[:3] != k.shape[:3]:
        raise ValueError("flash_decode: H must be a multiple of KV and "
                         "k, v, q shapes must agree")
    if q.stride(2) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_decode: the head dim must be contiguous")
    vec = 16 // k.element_size()           # the kernel loads 16-byte rows
    for t in (k, v):
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
            raise ValueError("flash_decode: k and v rows must start on "
                             "16-byte boundaries (strides a multiple of "
                             f"{vec} elements)")
    if not 0 <= kv_len <= k.shape[1]:
        raise ValueError(f"flash_decode: kv_len={kv_len}, Sk={k.shape[1]}")
