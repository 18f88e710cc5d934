"""Mamba-2 SSD chunk scan with an initial state.

Replaces the TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan``
(pallas_call at :84). For each (b, h) the scan runs the recurrence

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,    y_t = h_t C_t

from ``h0`` over ``S`` positions, in chunks of ``Q = min(chunk, S)``:
inside a chunk through two Q x Q products, across chunks through the
carried ``[P, N]`` fp32 state. It returns ``y`` and the final state in
fp32. ``h0`` is what the paper's prompt-cache resume feeds an SSM: the
state a downloaded blob carries.

B and C are grouped, ``[B, S, G, N]`` with ``G`` dividing ``H``; head
``h`` reads group ``h // (H / G)`` (``G == H`` is the TPU kernel's
per-head contract). They, and ``x``, may be strided views (the model
passes slices of its conv output): nothing is copied or padded.

On the card the wrapper launches the hand-written CUDA kernels
(``csrc/ssd_scan.cu``: C·B once per group and chunk, each chunk's own
state, then the state passing and the outputs; three launches, one
wrapper call). With grad enabled and an input that requires it, the call
goes through :class:`SsdScanFn`, which keeps the forward's scratch (C·B,
the chunks' states and decays) for :func:`ssd_scan_bwd`, the backward
kernel (``ssd_scan_bwd_launch`` in the same source; its launch shape is
:func:`bwd_plan`'s). On the CPU it runs
:func:`ssd_scan_plain`, the reference model's chunked einsum form
(``repro/models/ssm.py:90``), and its gradient is plain autograd. A CUDA
tensor never falls back to the plain version: an input the kernel does
not take raises.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 256            # chunk positions the kernel's scan holds
MAX_STATE = 128            # N the kernel's shared-memory tiles hold
P_TILE = 16                # state rows of a warp's tile
TILE = 64                  # positions (and state rows p) of a CTA's tile
FOLD_ELEMS = 1024          # state elements a CTA of the backward's fold
H100_SMS = 132             # SMs of the card the backward's plan fills
CLUSTER_MAX = 16           # CTAs of a thread-block cluster (an H100's largest; past 8
                           # non-portable)
HPS_MAX = 16               # heads of a dCB slice (their scan tables in shared memory)
SM_SMEM = 233472           # shared memory of an H100 SM, bytes (1 KB a CTA reserved)
# the share of an SM's CTA slots that clusters fill: a cluster's CTAs share
# one GPC, and the GPCs leave a few slots over
CLUSTER_FILL = 0.9


def ssd_scan_plain(x, dt, A, B_, C_, h0, *, chunk: int):
    """x: [B,S,H,P]; dt: [B,S,H] (post-softplus); A: [H] (negative);
    B_, C_: [B,S,G,N]; h0: [B,H,P,N]. Returns (y [B,S,H,P] fp32,
    h_final [B,H,P,N] fp32)."""
    Bsz, S, H, Pd = x.shape
    G, N = B_.shape[2], B_.shape[3]
    rep = H // G
    Q = min(chunk, S)
    pad = (-S) % Q
    nc = (S + pad) // Q

    def chunks(t, *tail):
        t = t.float()
        if pad:    # zero padding acts as dt = 0: no decay, no input
            t = torch.cat([t, t.new_zeros((Bsz, pad) + t.shape[2:])], 1)
        return t.reshape(Bsz, nc, Q, *tail)

    xf = chunks(x, H, Pd)
    dtf = chunks(dt, H)
    Bh = chunks(B_, G, N).repeat_interleave(rep, dim=3)    # [B,nc,Q,H,N]
    Ch = chunks(C_, G, N).repeat_interleave(rep, dim=3)

    cum = torch.cumsum(dtf * A.float(), dim=2)              # [B,nc,Q,H]
    # intra-chunk: scores[i,j] = exp(cum_i - cum_j) (C_i . B_j) dt_j, i >= j;
    # masked before exp, so the i < j side never overflows
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # [B,nc,i,j,H]
    ii = torch.arange(Q, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    decay = torch.exp(seg.masked_fill(~causal, float("-inf")))
    cb = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh)
    scores = cb * decay * dtf[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xf)
    # chunk summaries: S_c = sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
    dec_last = torch.exp(cum[:, :, -1:, :] - cum)
    st = torch.einsum("bcjh,bcjhn,bcjhp->bchpn", dec_last * dtf, Bh, xf)
    chunk_decay = torch.exp(cum[:, :, -1, :])                # [B,nc,H]

    h = h0.float()
    h_in = []
    for c in range(nc):                                      # state entering c
        h_in.append(h)
        h = h * chunk_decay[:, c, :, None, None] + st[:, c]
    h_in = torch.stack(h_in, dim=1)                          # [B,nc,H,P,N]
    y_inter = torch.einsum("bcihn,bchpn->bcihp", Ch, h_in) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, nc * Q, H, Pd)[:, :S]
    return y, h


def scratch_plan(B: int, S: int, H: int, G: int, P: int, N: int,
                 chunk: int):
    """Shapes of the three parts of the kernel's fp32 scratch, kept in
    one buffer in this order: C·B of each (batch, group, chunk), ``[B, G,
    nc, QP, QP]`` with ``QP`` the chunk rounded up to ``TILE``; each
    chunk's own state, ``[B, H, nc, P, N]``; and each chunk's decay
    ``exp(cum_last)``, ``[B, H, nc]``."""
    Q = min(int(chunk), S)
    nc = -(-S // Q)
    QP = -(-Q // TILE) * TILE
    return (B, G, nc, QP, QP), (B, H, nc, P, N), (B, H, nc)


def bwd_scratch_plan(B: int, S: int, H: int, G: int, P: int, N: int,
                     chunk: int):
    """Shapes of the parts of the backward kernel's fp32 scratch, kept in
    one buffer in this order: U (each chunk's sum of exp(cum_i) dy_i
    C_i^T), ``[B, H, nc, P, N]``; the state entering each chunk and the
    gradient of the state leaving it, ``[B, nc, H, P, N]`` each (a chunk's
    is one ``[H P, N]`` matrix, the B operand of the dC / dB products);
    dCB, the scores' gradient summed over a group's heads, ``[B, G, nc,
    QP, QP]``; each position's row part of dcum, ``[B, H, nt + nnb npb,
    S]`` (a slot per key tile, then one per 64 rows p and 64 columns n of
    the state term), and its direct d(dt), ``[B, H, nt, S]`` (a slot per
    query tile); exp(cum_i) and w_j, ``[B, H, S]`` each; x_j . G B_j per
    64-row block of P, ``[B, H, npb, S]``; and the fold CTAs' shares of
    exp(cum_last) <G, h_in>, ``[B, H, nc, parts]``."""
    Q = min(int(chunk), S)
    nc = -(-S // Q)
    QP = -(-Q // TILE) * TILE
    nt = QP // TILE
    npb, nnb = -(-P // TILE), -(-N // TILE)
    parts = -(-(P * N) // FOLD_ELEMS)
    state, by_chunk = (B, H, nc, P, N), (B, nc, H, P, N)
    return (state, by_chunk, by_chunk, (B, G, nc, QP, QP),
            (B, H, nt + nnb * npb, S), (B, H, nt, S), (B, H, S), (B, H, S),
            (B, H, npb, S), (B, H, nc, parts))


class SsdBwdPlan(NamedTuple):
    """The backward's launch shape: the dCB kernel cuts a group's heads
    into ``slices`` slices of ``heads_per_slice`` (the last may be
    shorter), a CTA each; the dC / dB kernel splits its reduction over
    ``k_split`` CTAs. Both sum their CTAs' shares through a cluster, in
    rank order."""
    slices: int
    heads_per_slice: int
    k_split: int


def _ctas_an_sm(smem: int) -> int:
    """CTAs of 128 threads an SM holds at ``smem`` bytes of shared memory
    each (two at most: their registers)."""
    return max(1, min(2, SM_SMEM // (smem + 1024)))


def bwd_plan(B: int, S: int, H: int, G: int, P: int, N: int, chunk: int,
             dtype: torch.dtype) -> SsdBwdPlan:
    """The plan of :func:`ssd_scan_bwd`'s two cluster launches, from the
    shapes alone.

    The dCB kernel has a CTA per causal 64 x 64 tile pair of a chunk, per
    (batch, group) and per slice of the group's heads, and walks its
    slice's heads in turn. Without slices it has few CTAs (mamba2-780m at
    B=1, S=1024: 10 pairs x 4 chunks = 40 on 132 SMs), so the group's
    ``H / G`` heads are cut into up to 16 slices (a cluster) of
    ``heads_per_slice = ceil(H / G / slices)`` (at most ``HPS_MAX``), the
    last slice shorter where they do not divide. The dC / dB kernel has a
    CTA per (64 rows, 64 columns of N, side, batch, group) and splits its
    reduction (the dCB tiles and the group's ``H / G x ceil(P / 64)``
    blocks of the state term) over ``k_split`` CTAs, up to 16 and at most
    those blocks. Each takes the cut whose waves times its CTAs' serial
    work (heads or blocks, plus two for a CTA's set-up and its cluster's
    sum) is least, the waves counted against the CTA slots its clusters
    fill (``CLUSTER_FILL`` of two an SM, or one where its shared memory
    allows no more); ties go to the fewer waves, then to the most CTAs.
    Timed on an H100 at the training shapes (PERF.md), the model's picks
    were the fastest of the plans tried or within a few percent."""
    es = 2 if dtype == torch.bfloat16 else 4
    Q = min(int(chunk), S)
    nc = -(-S // Q)
    nt = -(-Q // TILE)
    rep = H // G
    if rep > CLUSTER_MAX * HPS_MAX:
        raise ValueError(f"ssd_scan_bwd: {rep} heads a group; the kernel "
                         f"takes at most {CLUSTER_MAX * HPS_MAX}")

    def waves(ctas, smem):
        return math.ceil(ctas / (CLUSTER_FILL * _ctas_an_sm(smem) * H100_SMS))

    def best(cands):                   # (value, waves, serial work, CTAs)
        return min(cands, key=lambda c: (c[1] * (c[2] + 2), c[1], -c[3]))[0]

    raw = TILE * (TILE + 8)            # a raw 64 x 64 tile's elements, rows padded
    pairs = nt * (nt + 1) // 2 * nc * B * G
    xb = 2 * TILE * TILE if es == 2 else 4 * raw
    cands = []
    for n in range(min(CLUSTER_MAX, rep), 0, -1):
        hps = -(-rep // n)
        if -(-rep // hps) != n or hps > HPS_MAX:
            continue
        smem = 1024 + 2 * xb + 4 * (4 * raw + 8 * TILE + 7 * TILE * hps)
        cands.append(((n, hps), waves(pairs * n, smem), hps, pairs * n))
    slices, hps = best(cands)
    tiles = 2 * nt * nc * B * G * -(-N // TILE)
    units = rep * -(-P // TILE)
    smem = 1024 + (2 if es == 2 else 3) * TILE * TILE * 2 + 4 * (
        4 * raw + 2 * TILE)
    cands = [(k, waves(tiles * k, smem), -(-(units + nt) // k), tiles * k)
             for k in range(1, min(CLUSTER_MAX, max(units, 1)) + 1)]
    return SsdBwdPlan(slices, hps, best(cands))


def rows_vectorizable(x, B_, C_) -> bool:
    """Whether the kernel may read the rows of x, B and C as 16-byte
    vectors: each starts on 16 bytes, every stride but the last is a
    whole number of 16-byte vectors, and so is N (P is a multiple of 16)."""
    vec = 16 // x.element_size()
    return B_.shape[3] % vec == 0 and all(
        t.data_ptr() % 16 == 0 and all(s % vec == 0 for s in t.stride()[:3])
        for t in (x, B_, C_))


def ssd_scan(x, dt, A, B_, C_, h0, *, chunk: int):
    """See :func:`ssd_scan_plain`. ``S`` and ``chunk`` are runtime
    values; the kernel takes ``min(chunk, S) <= 256``, ``N <= 128`` and
    ``P`` a multiple of 16. On the card, with grad enabled and an input
    that requires it, the result carries its gradient (:class:`SsdScanFn`)."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B_, C_, h0, chunk=chunk)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B_, C_, h0)):
        return SsdScanFn.apply(x, dt, A, B_, C_, h0, int(chunk))
    return _forward(x, dt, A, B_, C_, h0, chunk)[:2]


ssd_scan.launches = 0


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and on 16 bytes (the kernels read it as float4)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _strides(x, dt, B_, C_):
    return (x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2),
            B_.stride(0), B_.stride(1), B_.stride(2),
            C_.stride(0), C_.stride(1), C_.stride(2))


def _forward(x, dt, A, B_, C_, h0, chunk: int):
    """One launch of the forward kernels: ``(y, h_final, scratch)``, the
    scratch as :func:`scratch_plan` lays it out (what the backward reads)."""
    Bsz, S, H, Pd = x.shape
    G, N = B_.shape[2], B_.shape[3]
    Q = min(int(chunk), S)
    _check(x, dt, A, B_, C_, h0, Q)
    dev = x.device
    y = torch.empty((Bsz, S, H, Pd), dtype=torch.float32, device=dev)
    h = torch.empty((Bsz, H, Pd, N), dtype=torch.float32, device=dev)
    scratch = torch.empty(sum(math.prod(p) for p in scratch_plan(
        Bsz, S, H, G, Pd, N, Q)), dtype=torch.float32, device=dev)
    h0 = _aligned(h0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.launch(
            "ssd_scan", x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            B_.data_ptr(), C_.data_ptr(), h0.data_ptr(), y.data_ptr(),
            h.data_ptr(), scratch.data_ptr(), _DTYPES[x.dtype],
            Bsz, S, H, G, Pd, N, Q, int(rows_vectorizable(x, B_, C_)),
            *_strides(x, dt, B_, C_), stream)
    ssd_scan.launches += 1
    return y, h, scratch


class SsdScanFn(torch.autograd.Function):
    """``ssd_scan`` on the card with its gradient: the forward keeps its
    inputs and its scratch; the backward is :func:`ssd_scan_bwd`. A
    result that takes no gradient (``h_final`` in training) is passed on
    as ``None``, and the kernel reads it as zero."""

    @staticmethod
    def forward(ctx, x, dt, A, B_, C_, h0, chunk: int):
        ctx.set_materialize_grads(False)
        y, h, scratch = _forward(x, dt, A, B_, C_, h0, chunk)
        ctx.save_for_backward(x, dt, A, B_, C_, h0, scratch)
        ctx.chunk = chunk
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, B_, C_, h0, scratch = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        grads = ssd_scan_bwd(x, dt, A, B_, C_, h0, dy, dh, chunk=ctx.chunk,
                             scratch=scratch)
        return (*grads, None)


def ssd_scan_bwd(x, dt, A, B_, C_, h0, dy, dh_final=None, *, chunk: int,
                 scratch=None):
    """The gradients ``(dx, ddt, dA, dB, dC, dh0)`` of ssd_scan's ``(y,
    h_final)`` given ``dy`` [B,S,H,P] and ``dh_final`` [B,H,P,N] (fp32;
    ``None`` is zero): dx, dB and dC in their inputs' dtypes (dB and dC
    summed over a group's heads), ddt, dA and dh0 in fp32. ``scratch`` is
    what the forward kernel left (:class:`SsdScanFn` keeps it); ``None``
    runs the forward first. One wrapper call, six launches: U, the fold,
    dCB (the scores' gradient summed over a group's heads, in
    :func:`bwd_plan`'s slices), dC and dB once per group (on ``wgmma`` in
    bf16), dx, and the last launch for d(dt) and dA; dCB, then dC and dB,
    run on a second stream beside U and the fold, then dx, and the last
    launch waits for them on the caller's stream. No atomics: two calls
    give the same bits. On the CPU: :func:`ssd_scan_bwd_plain`."""
    if x.device.type == "cpu":
        return ssd_scan_bwd_plain(x, dt, A, B_, C_, h0, dy, dh_final,
                                  chunk=chunk)
    Bsz, S, H, Pd = x.shape
    G, N = B_.shape[2], B_.shape[3]
    Q = min(int(chunk), S)
    _check(x, dt, A, B_, C_, h0, Q)
    _check_bwd(x, dy, dh_final, (Bsz, S, H, Pd), (Bsz, H, Pd, N))
    if scratch is None:
        scratch = _forward(x, dt, A, B_, C_, h0, Q)[2]
    if scratch.numel() != sum(math.prod(p) for p in scratch_plan(
            Bsz, S, H, G, Pd, N, Q)) or scratch.dtype != torch.float32:
        raise ValueError("ssd_scan_bwd: scratch is not the forward's at "
                         "these shapes")
    dev = x.device
    dy, h0 = _aligned(dy), _aligned(h0)
    dhf = None if dh_final is None else _aligned(dh_final)
    dx = torch.empty((Bsz, S, H, Pd), dtype=x.dtype, device=dev)
    ddt = torch.empty((Bsz, S, H), dtype=torch.float32, device=dev)
    dA = torch.empty((H,), dtype=torch.float32, device=dev)
    dB = torch.empty((Bsz, S, G, N), dtype=B_.dtype, device=dev)
    dC = torch.empty((Bsz, S, G, N), dtype=C_.dtype, device=dev)
    dh0 = torch.empty((Bsz, H, Pd, N), dtype=torch.float32, device=dev)
    work = torch.empty(sum(math.prod(p) for p in bwd_scratch_plan(
        Bsz, S, H, G, Pd, N, Q)), dtype=torch.float32, device=dev)
    plan = bwd_plan(Bsz, S, H, G, Pd, N, Q, x.dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.launch(
            "ssd_scan_bwd", x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            B_.data_ptr(), C_.data_ptr(), h0.data_ptr(), dy.data_ptr(),
            None if dhf is None else dhf.data_ptr(), scratch.data_ptr(),
            work.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), dh0.data_ptr(), _DTYPES[x.dtype],
            Bsz, S, H, G, Pd, N, Q, int(rows_vectorizable(x, B_, C_)),
            plan.heads_per_slice, plan.k_split, *_strides(x, dt, B_, C_),
            stream)
    ssd_scan_bwd.launches += 1
    return dx, ddt, dA, dB, dC, dh0


ssd_scan_bwd.launches = 0


def ssd_scan_bwd_plain(x, dt, A, B_, C_, h0, dy, dh_final=None, *,
                       chunk: int):
    """``(dx, ddt, dA, dB, dC, dh0)`` of :func:`ssd_scan_plain` by
    autograd, dx, dB and dC in their inputs' dtypes: the backward kernel's
    plain version."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True)
               for t in (x, dt, A, B_, C_, h0)]
        y, h = ssd_scan_plain(*ins, chunk=chunk)
        outs, grads = [y], [dy]
        if dh_final is not None:
            outs.append(h)
            grads.append(dh_final)
        return torch.autograd.grad(outs, ins, grads)


def _check_bwd(x, dy, dh_final, y_shape, h_shape) -> None:
    for name, t, shape in (("dy", dy, y_shape),
                           ("dh_final", dh_final, h_shape)):
        if t is None:
            continue
        if t.device != x.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape:
            raise ValueError(f"ssd_scan_bwd: {name} must be float32 of shape "
                             f"{shape} on {x.device}, not {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _check(x, dt, A, B_, C_, h0, Q) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    if any(t.device != x.device for t in (dt, A, B_, C_, h0)):
        raise ValueError("ssd_scan: inputs on different devices")
    if x.dtype not in _DTYPES or B_.dtype != x.dtype or C_.dtype != x.dtype:
        raise ValueError(f"ssd_scan: dtypes x {x.dtype}, B {B_.dtype}, "
                         f"C {C_.dtype}; the kernel takes float32 or "
                         "bfloat16, the same for all three")
    if any(t.dtype != torch.float32 for t in (dt, A, h0)):
        raise ValueError("ssd_scan: dt, A and h0 must be float32")
    Bsz, S, H, Pd = x.shape
    G, N = B_.shape[2], B_.shape[3]
    if (tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,)
            or tuple(B_.shape) != (Bsz, S, G, N) or C_.shape != B_.shape
            or tuple(h0.shape) != (Bsz, H, Pd, N) or G <= 0 or H % G):
        raise ValueError("ssd_scan: shapes x [B,S,H,P], dt [B,S,H], A [H], "
                         "B/C [B,S,G,N] with G dividing H, h0 [B,H,P,N]")
    if Pd % P_TILE or N > MAX_STATE or N % 4 or not 0 < Q <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: P={Pd}, N={N}, chunk={Q}; the kernel "
                         f"takes P a multiple of {P_TILE}, N a multiple of "
                         f"4 up to {MAX_STATE}, chunk up to {MAX_CHUNK}")
    if (x.stride(3) != 1 or B_.stride(3) != 1 or C_.stride(3) != 1
            or not A.is_contiguous() or not h0.is_contiguous()):
        raise ValueError("ssd_scan: the last axis of x, B and C must be "
                         "contiguous, and A and h0 contiguous")
