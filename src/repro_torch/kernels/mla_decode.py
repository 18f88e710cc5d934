"""MLA absorbed decode: every head's latent query against one shared
latent cache.

Replaces the TPU kernel ``repro/kernels/mla_decode.py::mla_decode_kernel``
(:25; it runs ``flash_decode``'s pallas_call at :89). For each (b, h)

    o[b, h] = softmax_s((q_lat[b, h] · ckv[b, s] + q_rope[b, h] · krope[b, s])
                        * scale) · ckv[b, s]

over the keys ``s < kv_len`` (and ``s > kv_len - 1 - window`` with a
window), in fp32, with the output in q's dtype and 0 for a row with no
live key. ``kv_len`` is a host int for every row, or a CUDA int32 tensor
``[B]`` that the kernel reads from device memory, one per row. ``ckv`` is
key and value at once; ``krope`` is the shared rotary key; ``scale`` is
``1/sqrt(qk_nope + qk_rope)``.

On the card the wrapper launches the hand-written CUDA kernel
(``csrc/mla_decode.cu``, one launch: each key split is a cluster of CTAs
of 16 heads that share every cache tile, and the last CTA of each head
group merges the splits). It reads ``ckv`` and ``krope`` through their
own pointers and strides, so the layer's slices of the ``[L, B, S, .]``
cache are read in place, once, with no concatenation. On the CPU it runs
:func:`mla_decode_plain`. A CUDA tensor never falls back to the plain
version: an input the kernel does not take raises. The kernel's arrival
counters are ``flash_decode``'s buffer of the (device, stream), left at
0 by every launch, so two streams may decode at once.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode import (KvLen, arrival_counters,
                                              check_kv_lens, decode_span,
                                              live_mask)

# (R, Dr) pairs the CUDA kernel is compiled for: deepseek-v3's (512, 64)
# and the reference kernel tests' widths (tests/test_kernels.py MLA_CASES)
WIDTHS = ((512, 64), (64, 16), (128, 32), (32, 16))
HEAD_GROUP = 16            # query heads per CTA: one m16 tile
MAX_CLUSTER = 8            # CTAs of a cluster: 128 heads share a cache tile
# keys of a shared-memory tile: bf16, 8 per warp of 8; fp32, one per lane
BLOCK_K = {torch.bfloat16: 64, torch.float32: 32}
# splits at most: the last CTA of a head group reads 32 KB a split back to
# merge them, and a split is a cluster of 8 CTAs with ~170-185 KB of shared
# memory each, of which about 14 fit on the card at once; fp32's slower
# tiles pay for more splits than bf16's
MAX_SPLITS = {torch.bfloat16: 8, torch.float32: 12}
N_SM = 132                 # H100 SXM streaming multiprocessors
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def mla_decode_plain(q_lat, q_rope, ckv, krope, *, kv_len: KvLen,
                     scale: float, window: Optional[int] = None,
                     kv_max: Optional[int] = None) -> torch.Tensor:
    """q_lat: [B,H,R]; q_rope: [B,H,Dr]; ckv: [B,S,R]; krope: [B,S,Dr]
    -> [B,H,R] in q_lat's dtype (fp32 math). ``kv_len``: an int, or one
    per row ([B]) capped at ``kv_max``, as in :func:`mla_decode`."""
    s = (torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv.float())
         + torch.einsum("bhk,bsk->bhs", q_rope.float(), krope.float()))
    s = s * scale
    mask = live_mask(kv_len, ckv.shape[1], window, ckv.device,
                     kv_max)[:, None, :]
    p = torch.nan_to_num(torch.softmax(s.masked_fill(~mask, float("-inf")),
                                       dim=-1), nan=0.0)
    return torch.einsum("bhs,bsr->bhr", p, ckv.float()).to(q_lat.dtype)


def split_plan(B: int, H: int, live: int, dtype=torch.bfloat16):
    """(cluster size, head groups, number of key splits, keys per split).
    A head group is one CTA of ``HEAD_GROUP`` heads; a split is one
    cluster of up to ``MAX_CLUSTER`` of them (the head groups are rounded
    up to a whole number of clusters). Splits take whole tiles of
    ``BLOCK_K[dtype]`` keys, and there are at most ``MAX_SPLITS[dtype]`` of
    them and about one CTA per SM: the last CTA of each head group reads
    every split's partial back to merge them."""
    groups = -(-H // HEAD_GROUP)
    csize = min(groups, MAX_CLUSTER)
    groups = -(-groups // csize) * csize
    want = max(1, min(MAX_SPLITS[dtype], N_SM // (B * groups)))
    tiles = max(1, -(-live // BLOCK_K[dtype]))
    chunk = BLOCK_K[dtype] * -(-tiles // want)
    return csize, groups, max(1, -(-live // chunk)), chunk


def mla_decode(q_lat, q_rope, ckv, krope, *, kv_len: KvLen, scale: float,
               window: Optional[int] = None,
               kv_max: Optional[int] = None) -> torch.Tensor:
    """q_lat: [B,H,R]; q_rope: [B,H,Dr]; ckv: [B,S,R]; krope: [B,S,Dr]
    (the layer's cache slices, read in place). ``kv_len`` is a host int,
    or an int32 tensor ``[B]`` on q's device; with a tensor, ``kv_max`` (a
    host int, default ``S``) sizes the grid and must be at least every
    row's ``kv_len``: a row past it reads only the keys below ``kv_max``,
    here and in the plain version alike. ``window`` is None for none.
    Returns [B,H,R] in q's dtype."""
    if q_lat.device.type == "cpu":
        return mla_decode_plain(q_lat, q_rope, ckv, krope, kv_len=kv_len,
                                scale=scale, window=window, kv_max=kv_max)
    build.refuse_grad("mla_decode", q_lat, q_rope, ckv, krope)
    cap, win, live = decode_span(kv_len, kv_max, ckv.shape[1], window)
    _check(q_lat, q_rope, ckv, krope, cap)
    B, H, R = q_lat.shape
    per_row = check_kv_lens("mla_decode", kv_len, B, q_lat.device)
    csize, groups, nsplit, chunk = split_plan(B, H, live, q_lat.dtype)
    dev = q_lat.device
    out = torch.empty((B, H, R), dtype=q_lat.dtype, device=dev)
    pm = torch.empty((B, H, nsplit), dtype=torch.float32, device=dev)
    pl = torch.empty_like(pm)
    pacc = torch.empty((B, H, nsplit, R), dtype=torch.float32, device=dev)
    counters = arrival_counters(dev, B * groups)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.launch(
            "mla_decode", q_lat.data_ptr(), q_rope.data_ptr(),
            ckv.data_ptr(), krope.data_ptr(), out.data_ptr(), pm.data_ptr(),
            pl.data_ptr(), pacc.data_ptr(), counters.data_ptr(),
            kv_len.data_ptr() if per_row else None,
            _DTYPES[q_lat.dtype], B, H, R, q_rope.shape[2], groups, csize,
            nsplit, chunk, cap, win,
            q_lat.stride(0), q_lat.stride(1), q_rope.stride(0),
            q_rope.stride(1), ckv.stride(0), ckv.stride(1),
            krope.stride(0), krope.stride(1), float(scale), stream)
    mla_decode.launches += 1
    return out


mla_decode.launches = 0


def _check(q_lat, q_rope, ckv, krope, kv_cap) -> None:
    ts = (q_lat, q_rope, ckv, krope)
    if q_lat.device.type != "cuda":
        raise ValueError(f"mla_decode: no kernel for device {q_lat.device}")
    if any(t.device != q_lat.device for t in ts):
        raise ValueError("mla_decode: inputs on different devices")
    if q_lat.dtype not in _DTYPES or any(t.dtype != q_lat.dtype for t in ts):
        raise ValueError("mla_decode: dtypes "
                         f"{[str(t.dtype) for t in ts]}; the kernel takes "
                         "float32 or bfloat16, all alike")
    if any(t.dim() != 3 for t in ts):
        raise ValueError("mla_decode: q_lat, q_rope [B,H,.]; ckv, krope "
                         "[B,S,.]")
    B, H, R = q_lat.shape
    Dr = q_rope.shape[2]
    if (R, Dr) not in WIDTHS:
        raise ValueError(f"mla_decode: (R, Dr) = ({R}, {Dr}); the kernel is "
                         f"built for {WIDTHS}")
    if q_rope.shape[:2] != (B, H) or ckv.shape[0] != B or \
            ckv.shape[2] != R or krope.shape[:2] != ckv.shape[:2] or \
            krope.shape[2] != Dr:
        raise ValueError("mla_decode: shapes q_lat "
                         f"{tuple(q_lat.shape)}, q_rope {tuple(q_rope.shape)}"
                         f", ckv {tuple(ckv.shape)}, krope "
                         f"{tuple(krope.shape)} do not agree")
    if any(t.stride(2) != 1 for t in ts):
        raise ValueError("mla_decode: the last axis must be contiguous")
    vec = 16 // q_lat.element_size()      # the kernel loads 16-byte rows
    for t in ts:
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:2]):
            raise ValueError("mla_decode: rows must start on 16-byte "
                             f"boundaries (strides a multiple of {vec} "
                             "elements)")
    if not 0 <= kv_cap <= ckv.shape[1]:
        raise ValueError(f"mla_decode: kv_len (or kv_max) = {kv_cap}, "
                         f"S={ckv.shape[1]}")
