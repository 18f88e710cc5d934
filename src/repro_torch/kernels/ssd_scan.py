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
wrapper call). On the CPU it runs :func:`ssd_scan_plain`, the
reference model's chunked einsum form (``repro/models/ssm.py:90``). A
CUDA tensor never falls back to the plain version: an input the kernel
does not take raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 256            # chunk positions the kernel's scan holds
MAX_STATE = 128            # N the kernel's shared-memory tiles hold
P_TILE = 16                # state rows of a warp's tile
TILE = 64                  # positions (and state rows p) of a CTA's tile


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
    ``P`` a multiple of 16."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B_, C_, h0, chunk=chunk)
    Bsz, S, H, Pd = x.shape
    G, N = B_.shape[2], B_.shape[3]
    Q = min(int(chunk), S)
    _check(x, dt, A, B_, C_, h0, Q)
    dev = x.device
    y = torch.empty((Bsz, S, H, Pd), dtype=torch.float32, device=dev)
    h = torch.empty((Bsz, H, Pd, N), dtype=torch.float32, device=dev)
    scratch = torch.empty(sum(math.prod(p) for p in scratch_plan(
        Bsz, S, H, G, Pd, N, Q)), dtype=torch.float32, device=dev)
    if h0.data_ptr() % 16:             # the kernel reads h0 as float4
        h0 = h0.clone()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.launch(
            "ssd_scan", x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            B_.data_ptr(), C_.data_ptr(), h0.data_ptr(), y.data_ptr(),
            h.data_ptr(), scratch.data_ptr(), _DTYPES[x.dtype],
            Bsz, S, H, G, Pd, N, Q, int(rows_vectorizable(x, B_, C_)),
            x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2),
            B_.stride(0), B_.stride(1), B_.stride(2),
            C_.stride(0), C_.stride(1), C_.stride(2), stream)
    ssd_scan.launches += 1
    return y, h


ssd_scan.launches = 0


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
