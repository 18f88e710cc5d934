"""Causal GQA flash-attention prefill with prefix resume.

Replaces the TPU kernel ``repro/kernels/flash_prefill.py::flash_prefill``
(pallas_call at :115). ``Sq`` suffix queries at absolute positions
``q_offset..`` attend over a KV cache ``[B, Sk, KV, dh]`` that already
holds the downloaded prefix; the key at ``kpos`` is live when
``kpos <= qpos``, ``kpos < kv_len`` and, with a window,
``kpos > qpos - window``. A row with no live key gives 0. The values
may be narrower than the keys: MLA attends with keys ``[k_nope; k_rope]``
192 wide and values 128 wide, at the scale ``1/sqrt(192)``.

An optional ``key_limit`` (int32 ``[Sq]`` on q's device, non-decreasing,
at most ``kv_len``; ``q_offset`` 0 and no window) replaces the causal
rule: the key at ``kpos`` is live for query row ``i`` when ``kpos <
key_limit[i]`` and ``kpos < kv_len``. It carries the reference's training
mask for a VLM batch whose temporal M-RoPE positions repeat (patches of
one image share an index and see each other): ``key_limit[i]`` is the
count of positions at most query ``i``'s (``models/attention.py::
training_key_limit``). Both kernels take it as a template flag, so the
null path (every other caller) compiles to the code it had. Its host
copy, read once a tensor (:func:`limit_on_host`), sizes the backward's
plan.

On the card the wrapper launches a hand-written CUDA kernel
(``csrc/flash_prefill.cu``; its header says what bounds each and how the
design answers): bf16 runs on the tensor cores (``mma.sync``, 64 rows a
CTA, query heads that share a kv head packed into one CTA), fp32 on
scalar FMAs (16 queries of one head a CTA). :func:`grid_plan` gives
either's CTA shape and grid. On the CPU it runs
:func:`flash_prefill_plain`, the reference's einsum form. A CUDA tensor
never falls back to the plain version: an input the kernel does not take
raises.

Under autograd (an input that requires grad, grad mode on) the CUDA call
goes through :class:`FlashPrefillFn`: its forward also writes each row's
log-sum-exp, and its backward launches :func:`flash_prefill_bwd`
(``csrc/flash_prefill_bwd.cu``: dQ, dK and dV on ``wgmma`` in bf16, two
to four launches with no atomics; :func:`bwd_plan` splits the work where
the card would otherwise sit idle). On the CPU autograd runs through
:func:`flash_prefill_plain`.
Serving runs under ``torch.no_grad`` and passes no log-sum-exp buffer.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import build

# (dh, dv) pairs the CUDA kernel is compiled for
WIDTHS = ((32, 32), (64, 64), (128, 128), (256, 256), (192, 128))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TC_ROWS = 64               # rows of a bf16 CTA: 4 warps x 16
FP32_ROWS = 16             # queries of an fp32 CTA (one head)
BWD_ROWS = 64              # keys of a bf16 dK/dV CTA, queries of a dQ CTA
H100_SMS = 132


def flash_prefill_plain(q, k, v, *, q_offset: int = 0,
                        kv_len: Optional[int] = None,
                        window: Optional[int] = None,
                        key_limit: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """q: [B,Sq,H,dh]; k: [B,Sk,KV,dh]; v: [B,Sk,KV,dv]; key_limit: [Sq]
    or None. fp32 math, output [B,Sq,H,dv] in q's dtype."""
    B, Sq, H, dh = q.shape
    _, Sk, KV, _ = k.shape
    dv = v.shape[-1]
    rep = H // KV
    kv_len = Sk if kv_len is None else kv_len
    qf = q.float().reshape(B, Sq, KV, rep, dh)
    s = torch.einsum("bqgrd,bsgd->bgrqs", qf, k.float()) * (1.0 / math.sqrt(dh))
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    if key_limit is None:
        mask = kpos[None, :] <= qpos[:, None]
    else:
        mask = kpos[None, :] < key_limit.to(kpos.dtype)[:, None]
    mask = mask & (kpos[None, :] < kv_len)
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
                  window: Optional[int] = None,
                  key_limit: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: [B,Sq,H,dh]; k: [B,Sk,KV,dh]; v: [B,Sk,KV,dv] (the cache, read
    in place). ``q_offset``, ``kv_len`` and ``window`` (None for none) are
    runtime values; ``key_limit`` (None for the causal rule) is described
    in the module docstring. Returns [B,Sq,H,dv] in q's dtype,
    differentiable in q, k and v."""
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    limit_on_host(key_limit, q, kv_len, q_offset, window)
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, q_offset=q_offset, kv_len=kv_len,
                                   window=window, key_limit=key_limit)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashPrefillFn.apply(q, k, v, int(q_offset), kv_len, window,
                                    key_limit)
    return _forward(q, k, v, int(q_offset), kv_len, window, None, key_limit)


flash_prefill.launches = 0


def _forward(q, k, v, q_offset: int, kv_len: int, window,
             lse: Optional[torch.Tensor],
             key_limit: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the forward kernel; ``lse`` (fp32 ``[B, H, Sq]``) takes
    each row's log-sum-exp when given."""
    B, Sq, H, dh = q.shape
    _, Sk, KV, _ = k.shape
    dv = v.shape[-1]
    _check(q, k, v, H, KV, dh, dv, q_offset, kv_len)
    out = torch.empty((B, Sq, H, dv), dtype=q.dtype, device=q.device)
    _, hp, _ = grid_plan(q.dtype, B, Sq, H, KV)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        build.launch(
            "flash_prefill", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(),
            None if key_limit is None else key_limit.data_ptr(),
            _DTYPES[q.dtype], B, Sq, Sk, H, KV, dh, dv, hp,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            q_offset, kv_len, -1 if not window else int(window),
            1.0 / math.sqrt(dh), stream)
    flash_prefill.launches += 1
    return out


class FlashPrefillFn(torch.autograd.Function):
    """``flash_prefill`` on the card with its gradient: the forward keeps
    q, k, v, the output and the rows' log-sum-exp; the backward is
    :func:`flash_prefill_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset: int, kv_len: int, window,
                key_limit):
        B, Sq, H, _ = q.shape
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        out = _forward(q, k, v, q_offset, kv_len, window, lse, key_limit)
        ctx.save_for_backward(q, k, v, out, lse, key_limit)
        ctx.args = (q_offset, kv_len, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, key_limit = ctx.saved_tensors
        q_offset, kv_len, window = ctx.args
        dq, dk, dv = flash_prefill_bwd(q, k, v, out, dout, lse,
                                       q_offset=q_offset, kv_len=kv_len,
                                       window=window, key_limit=key_limit)
        return dq, dk, dv, None, None, None, None


def flash_prefill_bwd_plain(q, k, v, dout, *, q_offset: int = 0,
                            kv_len: Optional[int] = None,
                            window: Optional[int] = None,
                            key_limit: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of :func:`flash_prefill_plain` by autograd, in the
    inputs' dtypes: the backward kernel's plain version."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        o = flash_prefill_plain(qq, kk, vv, q_offset=q_offset, kv_len=kv_len,
                                window=window, key_limit=key_limit)
        return torch.autograd.grad(o, (qq, kk, vv), dout)


def _tiles(n: int) -> range:
    return range(0, n, BWD_ROWS)


def first_tile(key_limit, Sq: int, k0: int) -> int:
    """The first query of the first 64-query tile that sees the key at
    ``k0`` under ``key_limit`` (a tile's last row has the largest limit),
    or the tiles' end where none does: the dK/dV CTAs' search."""
    return next((q0 for q0 in _tiles(Sq)
                 if key_limit[min(q0 + BWD_ROWS, Sq) - 1] > k0),
                -(-Sq // BWD_ROWS) * BWD_ROWS)


def bwd_tile_counts(Sq: int, Sk: int, q_offset: int, kv_len: int,
                    window: Optional[int], key_limit=None):
    """The bf16 kernels' loop lengths, as they compute them: the 64-query
    tiles each 64-key tile's dK/dV CTA walks (from a multiple of 64), and
    the 64-key tiles each 64-query tile's dQ CTA walks, for one head.
    ``key_limit`` is a host sequence (:func:`limit_on_host`) or None."""
    k_lim = min(kv_len, Sk)
    win = window if window and window > 0 else 0
    per_key_tile = []
    for k0 in _tiles(Sk):
        k_last = min(k0 + BWD_ROWS, k_lim) - 1
        lo = max(0, k0 - q_offset) // BWD_ROWS * BWD_ROWS \
            if key_limit is None else first_tile(key_limit, Sq, k0)
        hi = Sq - 1
        if win:
            hi = min(hi, k_last + win - 1 - q_offset)
        per_key_tile.append((hi - lo) // BWD_ROWS + 1
                            if k_last >= k0 and hi >= lo else 0)
    per_query_tile = []
    for q0 in _tiles(Sq):
        pos_lo = q_offset + q0
        pos_hi = pos_lo + min(BWD_ROWS, Sq - q0) - 1
        k_end = min(k_lim, pos_hi + 1 if key_limit is None
                    else key_limit[pos_hi - q_offset])
        k_begin = max(0, pos_lo - win + 1) // BWD_ROWS * BWD_ROWS if win else 0
        per_query_tile.append(-(-(k_end - k_begin) // BWD_ROWS)
                              if k_end > k_begin else 0)
    return per_key_tile, per_query_tile


@functools.lru_cache(maxsize=256)
def bwd_plan(dtype: torch.dtype, B: int, Sq: int, Sk: int, H: int, KV: int,
             dh: int, dv: int, q_offset: int, kv_len: int,
             window: Optional[int], sms: int = H100_SMS,
             key_limit: Optional[Tuple[int, ...]] = None):
    """(kv_parts, dq_splits) of the backward kernel's bf16 launches.

    A dK/dV CTA takes 64 keys of a kv head and walks the (query head,
    64-query tile) pairs that see them, summing the heads' gradients in
    registers; with ``kv_parts > 1`` the pairs are cut into that many runs,
    one a CTA, each writing an fp32 share that a further launch sums in
    part order. A dQ CTA takes 64 queries of a head and ``1 / dq_splits``
    of the key tiles they see, likewise. A split pays for its fp32 shares
    and a launch, so it is taken only where the card would otherwise sit
    idle (``sms`` SMs, each holding two CTAs at dh + dv <= 256, else one):
      - GQA: the smallest divisor of the group whose CTAs fill at least
        half of the card's CTA slots (the group's heads then split evenly);
      - MHA: two parts where the CTAs fill their last wave by half or less
        and each walks 8 or more tiles (shorter ones lose more to the sum);
      - dQ: the split whose CTAs fill their waves best, the fill of n
        parts weighed by 0.9^(n - 1), up to the longest walk's key tiles.
    Under a ``key_limit`` (its host tuple) the tile counts are those
    of the live (query tile, key tile) pairs it leaves.
    fp32 keeps one part a query head and no split. The rules were chosen
    by timing alternative plans at ``chip_smoke.py``'s TRAIN_BWD shapes on
    an H100 (PERF.md)."""
    rep = H // KV
    if dtype != torch.bfloat16:
        return rep, 1
    per_key_tile, per_query_tile = bwd_tile_counts(Sq, Sk, q_offset, kv_len,
                                                   window, key_limit)
    slots = sms * (2 if dh + dv <= 256 else 1)

    def fill(ctas):                    # busy share of the waves' CTA slots
        waves = ctas / slots
        return waves / math.ceil(waves)

    kv_ctas = len(per_key_tile) * KV * B
    if rep > 1:
        kv_parts = next(g for g in range(1, rep + 1) if rep % g == 0 and (
            kv_ctas * g >= slots / 2 or g == rep))
    else:
        kv_parts = 2 if max(per_key_tile) >= 8 and \
            0.9 * fill(2 * kv_ctas) > fill(kv_ctas) else 1
    q_ctas = len(per_query_tile) * H * B
    dq_splits = max(range(1, max(1, max(per_query_tile)) + 1),
                    key=lambda n: (fill(q_ctas * n) * 0.9 ** (n - 1), -n))
    return kv_parts, dq_splits


_SMS = {}


def _sm_count(device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def flash_prefill_bwd(q, k, v, out, dout, lse, *, q_offset: int = 0,
                      kv_len: Optional[int] = None,
                      window: Optional[int] = None,
                      key_limit: Optional[torch.Tensor] = None):
    """Gradients (dq [B,Sq,H,dh], dk [B,Sk,KV,dh], dv [B,Sk,KV,dv], in q's
    dtype) of ``out = flash_prefill(q, k, v, ...)`` for the output's
    gradient ``dout``, from the forward's ``out`` and its rows' ``lse``
    (fp32 ``[B, H, Sq]``). On the card, bf16: the dQ kernel (which also
    computes each row's D) and the dK/dV kernel, each followed by a
    fixed-order sum of fp32 shares where :func:`bwd_plan` splits it; fp32:
    delta, dK/dV, the sum of its per-head parts with GQA, dQ. Counted as
    one call in ``flash_prefill_bwd.launches``; on the CPU the plain
    version's autograd (``out`` and ``lse`` unused)."""
    B, Sq, H, dh = q.shape
    _, Sk, KV, _ = k.shape
    dv = v.shape[-1]
    kv_len = Sk if kv_len is None else int(kv_len)
    lim = limit_on_host(key_limit, q, kv_len, q_offset, window)
    if q.device.type == "cpu":
        return flash_prefill_bwd_plain(q, k, v, dout, q_offset=q_offset,
                                       kv_len=kv_len, window=window,
                                       key_limit=key_limit)
    _check(q, k, v, H, KV, dh, dv, q_offset, kv_len)
    dout = dout.contiguous()
    if dout.dtype != q.dtype or not out.is_contiguous() or \
            lse.dtype != torch.float32 or lse.shape != (B, H, Sq):
        raise ValueError("flash_prefill_bwd: dout in q's dtype, the "
                         "forward's contiguous output and fp32 [B, H, Sq] "
                         "log-sum-exp")
    win = -1 if not window else int(window)
    kv_parts, dq_splits = bwd_plan(q.dtype, B, Sq, Sk, H, KV, dh, dv,
                                   int(q_offset), kv_len, win,
                                   _sm_count(q.device), lim)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((B, Sk, KV, dh), dtype=q.dtype, device=q.device)
    dvv = torch.empty((B, Sk, KV, dv), dtype=q.dtype, device=q.device)
    # D and lse * log2(e) of each row, rows padded to 16 bytes
    delta = torch.empty((2, B, H, -(-Sq // 4) * 4), dtype=torch.float32,
                        device=q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    part = torch.empty(kv_parts * B * Sk * KV * (dh + dv), **f32) \
        if kv_parts > 1 else None
    dq_part = torch.empty(dq_splits * B * Sq * H * dh, **f32) \
        if dq_splits > 1 else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        build.launch(
            "flash_prefill_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            None if key_limit is None else key_limit.data_ptr(),
            delta.data_ptr(),
            None if part is None else part.data_ptr(),
            None if dq_part is None else dq_part.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dvv.data_ptr(), _DTYPES[q.dtype],
            B, Sq, Sk, H, KV, dh, dv, kv_parts, dq_splits,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(q_offset), kv_len, win, 1.0 / math.sqrt(dh), stream)
    flash_prefill_bwd.launches += 1
    return dq, dk, dvv


flash_prefill_bwd.launches = 0


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


# host copies of key limits: tensor -> (its version when copied, the copy)
_LIMITS = WeakIdKeyDictionary()


def limit_on_host(key_limit: Optional[torch.Tensor], q, kv_len: int,
                  q_offset: int, window) -> Optional[Tuple[int, ...]]:
    """``key_limit``'s values as a tuple, after checking it against the
    call (int32 ``[Sq]`` on q's device, non-decreasing, in ``[0,
    kv_len]``; ``q_offset`` 0 and no window); None for None. A tensor is
    read to the host once (one device-to-host copy a batch: the layers
    share it) and again only after an in-place change."""
    if key_limit is None:
        return None
    Sq = q.shape[1]
    if not torch.is_tensor(key_limit) or key_limit.dtype != torch.int32 or \
            key_limit.device != q.device or tuple(key_limit.shape) != (Sq,):
        raise ValueError(f"flash_prefill: key_limit must be an int32 [{Sq}] "
                         f"tensor on {q.device}")
    if q_offset or (window and window > 0):
        raise ValueError("flash_prefill: a key_limit takes q_offset 0 and no "
                         "window (the reference's training mask has "
                         "neither)")
    seen = _LIMITS.get(key_limit)
    if seen is None or seen[0] != key_limit._version:
        host = tuple(key_limit.tolist())
        if any(b < a for a, b in zip(host, host[1:])) or \
                (host and host[0] < 0):
            raise ValueError("flash_prefill: key_limit must be non-negative "
                             "and non-decreasing")
        seen = _LIMITS[key_limit] = (key_limit._version, host)
    if seen[1] and seen[1][-1] > kv_len:
        raise ValueError(f"flash_prefill: key_limit past kv_len={kv_len}")
    return seen[1]
