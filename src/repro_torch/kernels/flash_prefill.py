"""Causal GQA flash-attention prefill with prefix resume.

Replaces the TPU kernel ``repro/kernels/flash_prefill.py::flash_prefill``
(pallas_call at :115). ``Sq`` suffix queries at absolute positions
``q_offset..`` attend over a KV cache ``[B, Sk, KV, dh]`` that already
holds the downloaded prefix; the key at ``kpos`` is live when
``kpos <= qpos``, ``kpos < kv_len`` and, with a window,
``kpos > qpos - window``. A row with no live key gives 0. The values
may be narrower than the keys: MLA attends with keys ``[k_nope; k_rope]``
192 wide and values 128 wide, at the scale ``1/sqrt(192)``.

On the card the wrapper launches a hand-written CUDA kernel
(``csrc/flash_prefill.cu``; its header says what bounds each and how the
design answers): bf16 runs on the tensor cores (``mma.sync``, 64 rows a
CTA, query heads that share a kv head packed into one CTA), fp32 on
scalar FMAs (16 queries of one head a CTA). :func:`grid_plan` gives
either's CTA shape and grid. On the CPU it runs
:func:`flash_prefill_plain`, the reference's einsum form. A CUDA tensor
never falls back to the plain version: an input the kernel does not take
raises.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build

# (dh, dv) pairs the CUDA kernel is compiled for
WIDTHS = ((32, 32), (64, 64), (128, 128), (256, 256), (192, 128))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TC_ROWS = 64               # rows of a bf16 CTA: 4 warps x 16
FP32_ROWS = 16             # queries of an fp32 CTA (one head)


def flash_prefill_plain(q, k, v, *, q_offset: int = 0,
                        kv_len: Optional[int] = None,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: [B,Sq,H,dh]; k: [B,Sk,KV,dh]; v: [B,Sk,KV,dv]. fp32 math, output
    [B,Sq,H,dv] in q's dtype."""
    B, Sq, H, dh = q.shape
    _, Sk, KV, _ = k.shape
    dv = v.shape[-1]
    rep = H // KV
    kv_len = Sk if kv_len is None else kv_len
    qf = q.float().reshape(B, Sq, KV, rep, dh)
    s = torch.einsum("bqgrd,bsgd->bgrqs", qf, k.float()) * (1.0 / math.sqrt(dh))
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    mask = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < kv_len)
    if window is not None and window > 0:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)             # fully masked rows -> 0
    o = torch.einsum("bgrqs,bsgd->bqgrd", p, v.float())
    return o.reshape(B, Sq, H, dv).to(q.dtype)


def grid_plan(dtype: torch.dtype, B: int, Sq: int, H: int, KV: int):
    """(rows per CTA, query heads packed per CTA, grid (x, y, z)) of the
    kernel for ``dtype``. A bf16 CTA takes 64 rows: ``hp`` heads that
    share a kv head (4, 2 or 1, dividing ``H / KV``) times ``64 / hp``
    queries, so each K/V tile is loaded once for all of them. An fp32 CTA
    takes 16 queries of one head."""
    if dtype == torch.bfloat16:
        rep = H // KV
        rows, hp = TC_ROWS, next(g for g in (4, 2, 1) if rep % g == 0)
    else:
        rows, hp = FP32_ROWS, 1
    per = rows // hp
    return rows, hp, (-(-Sq // per), H // hp, B)


def flash_prefill(q, k, v, *, q_offset: int = 0,
                  kv_len: Optional[int] = None,
                  window: Optional[int] = None) -> torch.Tensor:
    """q: [B,Sq,H,dh]; k: [B,Sk,KV,dh]; v: [B,Sk,KV,dv] (the cache, read
    in place). ``q_offset``, ``kv_len`` and ``window`` (None for none) are
    runtime values. Returns [B,Sq,H,dv] in q's dtype."""
    B, Sq, H, dh = q.shape
    _, Sk, KV, _ = k.shape
    dv = v.shape[-1]
    kv_len = Sk if kv_len is None else int(kv_len)
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, q_offset=q_offset, kv_len=kv_len,
                                   window=window)
    _check(q, k, v, H, KV, dh, dv, q_offset, kv_len)
    out = torch.empty((B, Sq, H, dv), dtype=q.dtype, device=q.device)
    _, hp, _ = grid_plan(q.dtype, B, Sq, H, KV)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        build.launch(
            "flash_prefill", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), _DTYPES[q.dtype], B, Sq, Sk, H, KV, dh, dv, hp,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(q_offset), kv_len, -1 if not window else int(window),
            1.0 / math.sqrt(dh), stream)
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0


def _check(q, k, v, H, KV, dh, dv, q_offset, kv_len) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: no kernel for device {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_prefill: q, k, v on different devices")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_prefill: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; the kernel takes float32 or bfloat16")
    if (dh, dv) not in WIDTHS or k.shape[3] != dh or \
            v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_prefill: head dim {dh} / k {tuple(k.shape)}"
                         f" / v {tuple(v.shape)}; (dh, dv) must be in "
                         f"{WIDTHS}")
    if H % KV or q.shape[0] != k.shape[0]:
        raise ValueError("flash_prefill: H must be a multiple of KV and "
                         "batches must agree")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_prefill: the head dim must be contiguous")
    vec = 16 // q.element_size()           # the kernel loads 16-byte rows
    for t in (q, k, v):
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
            raise ValueError("flash_prefill: q, k and v rows must start on "
                             "16-byte boundaries (strides a multiple of "
                             f"{vec} elements)")
    if q_offset < 0 or not 0 <= kv_len <= k.shape[1]:
        raise ValueError(f"flash_prefill: q_offset={q_offset}, "
                         f"kv_len={kv_len}, Sk={k.shape[1]}")
