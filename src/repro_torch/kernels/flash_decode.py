"""Split-KV flash decode: one query token per head against the cache.

Replaces the TPU kernel ``repro/kernels/flash_decode.py::flash_decode``
(pallas_call at :89). For each (b, h) the query attends to keys
``kpos < kv_len`` (and ``kpos > kv_len - 1 - window`` with a window);
a row with no live key gives 0. ``kv_len`` is a host int for every row,
or a CUDA int32 tensor ``[B]`` read by the kernel from device memory, so
that the rows of a batch decode at their own positions in one launch.
``v`` may be wider or narrower than ``k`` (MLA's latent decode) and
``scale`` overrides ``1/sqrt(dh)``.

On the card the wrapper launches the hand-written CUDA kernel
(``csrc/flash_decode.cu``, one launch: key splits over CTAs, and the last
CTA of each head group merges them). On the CPU it runs
:func:`flash_decode_plain`, the reference's einsum form. A CUDA tensor
never falls back to the plain version: an input the kernel does not take
raises. The kernel's arrival counters are one buffer per (device,
stream), left at 0 by every launch: launches on one stream are ordered,
and two streams that decode at once use two buffers. A caller that knows
its largest grid reserves its stream's buffer once with
:func:`arrival_counters` (``BatchedEngine`` does, at construction), so
its launches never move it.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch

from repro_torch.kernels import build

# (dh, dv) pairs the CUDA kernel is compiled for
WIDTHS = ((32, 32), (64, 64), (128, 128), (256, 256), (576, 512))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
N_SM = 132                 # H100 SXM streaming multiprocessors
TILE = 32                  # keys of a CTA's tile: 2 parts of 16, 2 lanes a key
_COUNTERS = {}             # (device, stream) -> int32 arrival counters,
                           # all 0 (shared with mla_decode on that stream)
KvLen = Union[int, torch.Tensor]


def live_mask(kv_len: KvLen, S: int, window: Optional[int], device,
              kv_max: Optional[int] = None) -> torch.Tensor:
    """[1 or B, S] bool: key ``s`` of a row is live when ``s < kv_len``
    (and ``s > kv_len - 1 - window`` with a window); ``kv_len`` is an int
    or one per row, and ``kv_max`` caps a tensor's rows as the kernels
    cap them."""
    kl = torch.as_tensor(kv_len, device=device).reshape(-1, 1)
    if kv_max is not None and torch.is_tensor(kv_len):
        kl = kl.clamp(max=int(kv_max))
    kpos = torch.arange(S, device=device)[None, :]
    mask = kpos < kl
    if window is not None and window > 0:
        mask = mask & (kpos > (kl - 1) - window)
    return mask


def flash_decode_plain(q, k, v, *, kv_len: KvLen,
                       window: Optional[int] = None,
                       scale: Optional[float] = None,
                       kv_max: Optional[int] = None) -> torch.Tensor:
    """q: [B,H,dh]; k: [B,Sk,KV,dh]; v: [B,Sk,KV,dv] -> [B,H,dv].
    ``kv_len``: an int, or one per row ([B]) capped at ``kv_max``, as in
    :func:`flash_decode`."""
    B, H, dh = q.shape
    _, Sk, KV, _ = k.shape
    dv = v.shape[-1]
    rep = H // KV
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    qf = q.float().reshape(B, KV, rep, dh)
    s = torch.einsum("bgrd,bsgd->bgrs", qf, k.float()) * scale
    mask = live_mask(kv_len, Sk, window, q.device,
                     kv_max)[:, None, None, :]
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


def counters_key(dev):
    """The key of the counter buffer a launch on ``dev`` uses now:
    ``(device, the device's current stream)``; on the CPU the stream is
    0. ``cuda`` with no index names the current device, as a tensor's
    ``.device`` would."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return dev, 0
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev, torch.cuda.current_stream(dev).cuda_stream


def arrival_counters(dev, n: int) -> torch.Tensor:
    """At least ``n`` arrival counters for launches on ``dev``'s current
    stream, zero (each launch resets those it used). Either decode kernel
    takes one counter per (row, head group), so ``B * H`` cover any
    launch of B rows of H query heads. Each stream has its own buffer,
    made on that stream, so launches on two streams never share a
    counter. A buffer never shrinks. When it grows, the memory it leaves
    is reused only by work queued after it on its stream, so a launch in
    flight keeps its counters."""
    key = counters_key(dev)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=key[0])
        _COUNTERS[key] = buf
    return buf


def decode_span(kv_len: KvLen, kv_max: Optional[int], Sk: int,
                window: Optional[int]):
    """(kv_cap, window or 0, live keys the grid must cover) of a launch:
    a host ``kv_len`` is its own cap; a tensor's is ``kv_max`` (default
    ``Sk``), which bounds every row's ``kv_len``."""
    if torch.is_tensor(kv_len):
        cap = Sk if kv_max is None else int(kv_max)
    else:
        cap = int(kv_len)
    win = int(window) if window and window > 0 else 0
    return cap, win, min(cap, win) if win else cap


def flash_decode(q, k, v, *, kv_len: KvLen, window: Optional[int] = None,
                 scale: Optional[float] = None,
                 kv_max: Optional[int] = None) -> torch.Tensor:
    """q: [B,H,dh]; k: [B,Sk,KV,dh]; v: [B,Sk,KV,dv] (the cache, read in
    place). ``kv_len`` is a host int, or an int32 tensor ``[B]`` on q's
    device; with a tensor, ``kv_max`` (a host int, default ``Sk``) sizes
    the grid and must be at least every row's ``kv_len``: a row past it
    reads only the keys below ``kv_max``, here and in the plain version
    alike. ``window`` is None for none. Returns [B,H,dv] in q's dtype."""
    B, H, dh = q.shape
    _, Sk, KV, _ = k.shape
    dv = v.shape[-1]
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, kv_len=kv_len, window=window,
                                  scale=scale, kv_max=kv_max)
    build.refuse_grad("flash_decode", q, k, v)
    cap, win, live = decode_span(kv_len, kv_max, Sk, window)
    _check(q, k, v, H, KV, dh, dv, cap)
    per_row = check_kv_lens("flash_decode", kv_len, B, q.device)
    hg, nsplit, chunk = split_plan(B, H, KV, live)
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
            counters.data_ptr(), kv_len.data_ptr() if per_row else None,
            _DTYPES[q.dtype], B, H, KV, dh, dv, hg, nsplit,
            q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            chunk, cap, win, scale, stream)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def check_kv_lens(name: str, kv_len: KvLen, B: int, dev) -> bool:
    """True when ``kv_len`` is one value a row; then it must be a
    contiguous int32 ``[B]`` on ``dev``, which the kernel reads."""
    if not torch.is_tensor(kv_len):
        return False
    if kv_len.device != dev or kv_len.dtype != torch.int32 or \
            tuple(kv_len.shape) != (B,) or not kv_len.is_contiguous():
        raise ValueError(f"{name}: a kv_len tensor must be a contiguous "
                         f"int32 [B={B}] on {dev}; got {kv_len.dtype} "
                         f"{tuple(kv_len.shape)} on {kv_len.device}")
    return True


def _check(q, k, v, H, KV, dh, dv, kv_cap) -> None:
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
    if not 0 <= kv_cap <= k.shape[1]:
        raise ValueError(f"flash_decode: kv_len (or kv_max) = {kv_cap}, "
                         f"Sk={k.shape[1]}")
