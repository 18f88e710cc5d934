"""The SSD scan's backward on the CPU: the algebra the CUDA kernel
implements, its plain version, the reference's gradient, and the plan and
scratch of its launches.

* ``chunked_bwd`` below is the kernel's algebra written in plain torch, part
  by part as ``csrc/ssd_scan.cu``'s backward launches compute it (the reverse
  state pass; dCB, the scores' gradient summed over a group's heads in
  slices, the slices in order, with each head's row and column sums per
  64-position tile; dC and dB once per group from dCB and the K = H P state
  products, rsum's state term per head from those products; dx; dcum from
  the per-tile slots and its suffix sum over the chunk; padding, groups).
  It must equal ``ssd_scan_bwd_plain`` (autograd of ``ssd_scan_plain``)
  within 1e-5 of each gradient's largest magnitude: the same fp32
  function, summed in another order.
* ``ssd_scan_bwd_plain`` against ``jax.vjp`` of the reference's
  ``repro.models.ssm._ssd_scan`` on the same numpy inputs, where the
  reference's gradients are finite (small decay, chunk 16-32): 1e-5 of each
  gradient's largest magnitude.
* The reference's gradient is NaN at a realistic decay: its decay is
  ``where(causal, exp(seg), 0)``, and on the masked side ``seg`` overflows
  exp, so the gradient there is 0 * inf. The port masks before exp.
* ``bwd_plan`` and ``bwd_scratch_plan``: the launches' slices and K split,
  and the scratch layout the kernel reads.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jax_ssm
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.kernels.ssd_scan import (ssd_scan, ssd_scan_bwd,
                                          ssd_scan_bwd_plain, ssd_scan_plain)

TOL = 1e-5
GRADS = ("dx", "ddt", "dA", "dB", "dC", "dh0")


def chunked_bwd(x, dt, A, B_, C_, h0, dy, dhf, chunk, slices=1):
    """(dx, ddt, dA, dB, dC, dh0) of ssd_scan as the backward kernel forms
    them, in fp32; ``dhf`` None is zero. A group's heads are cut into
    ``slices`` slices of ceil(H / G / slices) heads, the last shorter, as
    the dCB launch cuts them."""
    Bsz, S, H, P = x.shape
    G, N = B_.shape[2:]
    rep = H // G
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    T = ssd_mod.TILE
    nt = -(-Q // T)

    def chunks(t):                      # padded positions: zero, dt = 0
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_zeros((Bsz, pad) + t.shape[2:])], 1)
        return t.reshape(Bsz, nc, Q, *t.shape[2:])

    xf, dtf, dyf = chunks(x), chunks(dt), chunks(dy)
    Bg, Cg = chunks(B_), chunks(C_)                         # [b, c, q, g, n]
    Bh = Bg.repeat_interleave(rep, 3)
    Ch = Cg.repeat_interleave(rep, 3)
    cum = torch.cumsum(dtf * A.float(), 2)                 # [b, c, q, h]
    last = cum[:, :, -1]
    dec = torch.exp(last)
    ii = torch.arange(Q)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    L = torch.exp((cum[:, :, :, None] - cum[:, :, None, :])
                  .masked_fill(~causal, -math.inf))        # [b, c, i, j, h]
    CB = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh)
    w = torch.exp(last[:, :, None] - cum) * dtf            # [b, c, j, h]
    ecum = torch.exp(cum)
    st = torch.einsum("bcjh,bcjhp,bcjhn->bchpn", w, xf, Bh)
    # the fold: h_in of each chunk forward, then G back from dh_final,
    # G_c = exp(cum_last) G_{c+1} + U_c, U_c = sum_i exp(cum_i) dy_i C_i^T
    h = h0.float()
    hin = []
    for c in range(nc):
        hin.append(h)
        h = dec[:, c, :, None, None] * h + st[:, c]
    hin = torch.stack(hin, 1)                  # [b, c, h, p, n], as the kernel lays it
    U = torch.einsum("bcih,bcihp,bcihn->bchpn", ecum, dyf, Ch)
    g = torch.zeros_like(h) if dhf is None else dhf.float()
    gn, dot = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        gn[c] = g                                           # G_{c+1}
        dot[c] = dec[:, c] * (g * hin[:, c]).sum((-1, -2))
        g = dec[:, c, :, None, None] * g + U[:, c]
    gn, dot, dh0 = torch.stack(gn, 1), torch.stack(dot, 1), g
    # the dCB launch, per head and 64 x 64 tile pair: dM = dy_i . x_j,
    # V = dM o L o dt_j; rsum's slot jt the row sums of V o CB over key tile
    # jt, ddtd's slot it the column sums of dM o L o CB over query tile it
    dM = torch.einsum("bcihp,bcjhp->bcijh", dyf, xf)
    ML = dM * L
    V = ML * dtf[:, :, None]
    tiles = torch.nn.functional.one_hot(ii // T, nt).float()   # [q, tile]
    rs_slot = torch.einsum("bcijh,jt->bciht", V * CB, tiles)
    dd_slot = torch.einsum("bcijh,it->bcjht", ML * CB, tiles)
    # ... and V summed over a slice's heads in order, then the slices in
    # order (the cluster's ranks)
    hps = -(-rep // slices)
    dCB = []
    for gi in range(G):
        total = None
        for h_lo in range(gi * rep, (gi + 1) * rep, hps):
            part = V[..., h_lo]
            for hh in range(h_lo + 1, min(h_lo + hps, (gi + 1) * rep)):
                part = part + V[..., hh]
            total = part if total is None else total + part
        dCB.append(total)
    dCB = torch.stack(dCB, -1)                              # [b, c, i, j, g]
    # the dC / dB launch, once per group: dCB times B (C), plus the state
    # term as one product over K = H P, its rows scaled per head
    dy_s = (ecum[..., None] * dyf).reshape(Bsz, nc, Q, G, rep * P)
    x_s = (w[..., None] * xf).reshape(Bsz, nc, Q, G, rep * P)
    hin_k = hin.reshape(Bsz, nc, G, rep * P, N)
    gn_k = gn.reshape(Bsz, nc, G, rep * P, N)
    dCg = torch.einsum("bcijg,bcjgn->bcign", dCB, Bg) \
        + torch.einsum("bcigk,bcgkn->bcign", dy_s, hin_k)
    dBg = torch.einsum("bcijg,bcign->bcjgn", dCB, Cg) \
        + torch.einsum("bcjgk,bcgkn->bcjgn", x_s, gn_k)
    # ... and each head's share of rsum's state term, C_i . (exp(cum_i)
    # dy_i h_in), a slot per 64 rows p and 64 columns n of its product
    dy_h = ecum[..., None] * dyf                           # [b, c, i, h, p]
    q_slots = []
    for p0 in range(0, P, T):
        for n0 in range(0, N, T):
            prod = torch.einsum("bcihp,bchpn->bcihn", dy_h[..., p0:p0 + T],
                                hin[:, :, :, p0:p0 + T, n0:n0 + T])
            q_slots.append((prod * Ch[..., n0:n0 + T]).sum(-1))
    # the last launch's sums of the slots: rsum over key tiles jt <= the
    # row's, then the state term's; ddtd over query tiles it >= the column's
    own = ii // T
    rsum = (rs_slot * (torch.arange(nt)[None, :] <= own[:, None])
            [None, None, :, None, :]).sum(-1)
    for q in q_slots:
        rsum = rsum + q
    ddtd = (dd_slot * (torch.arange(nt)[None, :] >= own[:, None])
            [None, None, :, None, :]).sum(-1)
    # dx (rows j): S^T dy plus w_j T_j, T_j = G_{c+1} B_j; x . T
    Tj = torch.einsum("bcjhn,bchpn->bcjhp", Bh, gn)
    dx = torch.einsum("bcijh,bcihp->bcjhp", CB * L * dtf[:, :, None], dyf) \
        + w[..., None] * Tj
    xT = (xf * Tj).sum(-1)
    # the last launch: dcum, its suffix sum over the chunk, d(dt), dA
    ds = torch.exp(last[:, :, None] - cum) * xT
    W = dtf * ds
    dcum = rsum - dtf * ddtd - W
    lastpos = torch.full((nc,), Q - 1)
    lastpos[-1] = (S - 1) % Q
    for c in range(nc):
        dcum[:, c, lastpos[c]] += W[:, c].sum(1) + dot[:, c]
    da = dcum.flip(2).cumsum(2).flip(2)
    ddt = ddtd + ds + A.float() * da
    dA = (dtf * da).sum((0, 1, 2))

    def rows(t):
        return t.reshape(Bsz, nc * Q, *t.shape[3:])[:, :S]

    return rows(dx), rows(ddt), dA, rows(dBg), rows(dCg), dh0


def _inputs(B, S, H, P, N, G, random_h0=True, dh_final=True, seed=0,
            dt_scale=0.1, a_max=None):
    """numpy inputs: the reference test's distributions, A = -1..-H (the
    model's) or -|N(0, 1)| - 0.1 scaled to at most ``a_max``."""
    rng = np.random.default_rng(seed)

    def n(shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    x = n((B, S, H, P), 0.5)
    dt = np.abs(n((B, S, H), dt_scale)) + 0.01
    A = (-np.arange(1, H + 1, dtype=np.float32) if a_max is None
         else -np.minimum(np.abs(n((H,))) + 0.1, a_max))
    Bg, Cg = n((B, S, G, N), 0.5), n((B, S, G, N), 0.5)
    h0 = n((B, H, P, N), 0.2) if random_h0 else np.zeros((B, H, P, N),
                                                          np.float32)
    dy = n((B, S, H, P))
    dh = n((B, H, P, N)) if dh_final else None
    return x, dt, A, Bg, Cg, h0, dy, dh


def _err(got, ref):
    """Largest |got - ref| over each gradient's largest magnitude."""
    return {k: float((np.asarray(g, np.float64) - np.asarray(r, np.float64))
                     .__abs__().max()
                     / max(np.abs(np.asarray(r, np.float64)).max(), 1e-12))
            for k, g, r in zip(GRADS, got, ref)}


ALGEBRA_CASES = [
    # B, S, H, P, N, G, chunk, random h0, dh_final
    (2, 37, 4, 16, 8, 2, 16, True, True),       # ragged S, G < H
    (1, 64, 4, 16, 8, 1, 16, False, False),      # training: zero h0, no dh
    (1, 100, 6, 16, 16, 3, 32, True, True),      # 4 chunks, ragged
    (1, 1, 3, 16, 4, 3, 16, True, True),         # S = 1, G = H
    (2, 50, 4, 16, 8, 2, 64, True, False),       # one chunk past S
    (1, 200, 6, 16, 8, 2, 128, True, True),      # 2 tiles a chunk, 3 heads a group
]


@pytest.mark.parametrize("slices", [1, 2])
@pytest.mark.parametrize("case", ALGEBRA_CASES)
def test_the_kernels_chunked_algebra_equals_plain_autograd(case, slices):
    """One slice a group, and two: even where a group has 2 heads, one
    head and two where it has 3 (the last slice shorter)."""
    B, S, H, P, N, G, chunk, rh0, dhf = case
    x, dt, A, Bg, Cg, h0, dy, dh = (None if a is None else torch.tensor(a)
                                    for a in _inputs(B, S, H, P, N, G, rh0,
                                                     dhf, seed=S))
    got = chunked_bwd(x, dt, A, Bg, Cg, h0, dy, dh, chunk, slices)
    ref = ssd_scan_bwd_plain(x, dt, A, Bg, Cg, h0, dy, dh, chunk=chunk)
    for k, g, r in zip(GRADS, got, ref):
        assert g.shape == r.shape, k
    errs = _err([g.numpy() for g in got], [r.numpy() for r in ref])
    assert max(errs.values()) <= TOL, errs


def test_padded_positions_get_no_gradient():
    """Positions past S exist only inside the last chunk: the gradients
    have S rows, and the ragged run's equal a run padded with zero inputs
    and zero dy (dt = 0 there: no decay, no input) on its first S rows."""
    B, S, H, P, N, G, chunk = 1, 40, 2, 16, 8, 1, 16
    x, dt, A, Bg, Cg, h0, dy, dh = (torch.tensor(a) for a in _inputs(
        B, S, H, P, N, G))
    got = ssd_scan_bwd_plain(x, dt, A, Bg, Cg, h0, dy, dh, chunk=chunk)
    pad = (-S) % chunk

    def zpad(t):
        return torch.cat([t, t.new_zeros((B, pad) + t.shape[2:])], 1)
    ref = ssd_scan_bwd_plain(*(zpad(t) for t in (x, dt)), A,
                             *(zpad(t) for t in (Bg, Cg)), h0, zpad(dy), dh,
                             chunk=chunk)
    for k, g, r in zip(GRADS, got, ref):
        r = r[:, :S] if k in ("dx", "ddt", "dB", "dC") else r
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)


def test_the_cpu_wrapper_is_plain_autograd():
    """On the CPU, ``ssd_scan`` keeps plain autograd and ``ssd_scan_bwd``
    is its plain version: no kernel is counted."""
    x, dt, A, Bg, Cg, h0, dy, dh = (torch.tensor(a) for a in _inputs(
        1, 30, 4, 16, 8, 2))
    n0, b0 = ssd_scan.launches, ssd_scan_bwd.launches
    ins = [t.clone().requires_grad_() for t in (x, dt, A, Bg, Cg, h0)]
    y, h = ssd_scan(*ins, chunk=16)
    got = torch.autograd.grad((y, h), ins, (dy, dh))
    ref = ssd_scan_bwd(x, dt, A, Bg, Cg, h0, dy, dh, chunk=16)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=0, rtol=0)
    assert (ssd_scan.launches, ssd_scan_bwd.launches) == (n0, b0)


def test_bwd_scratch_plan_matches_the_kernels_layout():
    """The backward's scratch: U [B,H,nc,P,N]; h_in and G [B,nc,H,P,N];
    dCB [B,G,nc,QP,QP]; rsum a slot per key tile and per 64 x 64 block of
    the state term; ddtd a slot per query tile; exp(cum) and w [B,H,S];
    x . T per 64-row block of P; the fold's shares, one a 1024 state
    elements. No per-head dB or dC: at mamba2-780m's training shape the
    buffer is at least 35 MB under the per-head form's."""
    plan = ssd_mod.bwd_scratch_plan(2, 300, 48, 1, 128, 128, 256)
    assert plan == ((2, 48, 2, 128, 128), (2, 2, 48, 128, 128),
                    (2, 2, 48, 128, 128), (2, 1, 2, 256, 256),
                    (2, 48, 8, 300), (2, 48, 4, 300), (2, 48, 300),
                    (2, 48, 300), (2, 48, 2, 300), (2, 48, 2, 16))
    plan = ssd_mod.bwd_scratch_plan(1, 31, 50, 1, 64, 16, 64)
    assert plan[0] == (1, 50, 1, 64, 16) and plan[4] == (1, 50, 2, 31) \
        and plan[5] == (1, 50, 1, 31) and plan[-1] == (1, 50, 1, 1)
    B, S, H, G, P, N = 1, 1024, 48, 1, 64, 128
    plan = ssd_mod.bwd_scratch_plan(B, S, H, G, P, N, 256)
    assert (B, H, S, N) not in plan
    nc, npb, nnb, parts = 4, 1, 2, 8
    per_head = (3 * B * H * nc * P * N + 2 * B * H * S * N
                + B * H * nnb * S + B * H * S + B * H * npb * S
                + B * H * nc * parts)
    assert 4 * (per_head - sum(math.prod(p) for p in plan)) >= 35e6


def _plan_holds(plan, B, S, H, G, P, N, chunk):
    """The plan's invariants: slices a cluster of up to 16, every slice
    non-empty, only the last shorter, at most HPS_MAX heads; the K split a
    cluster of up to 16 and at most the state term's blocks."""
    rep = H // G
    assert 1 <= plan.slices <= 16 and 1 <= plan.k_split <= 16
    assert plan.heads_per_slice == -(-rep // plan.slices) <= ssd_mod.HPS_MAX
    assert plan.heads_per_slice * (plan.slices - 1) < rep \
        <= plan.heads_per_slice * plan.slices
    assert plan.k_split == 1 or plan.k_split <= rep * -(-P // 64)


def _dcb_ctas(plan, B, S, H, G, chunk):
    Q = min(chunk, S)
    nt = -(-Q // 64)
    return nt * (nt + 1) // 2 * -(-S // Q) * B * G * plan.slices


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape, want", [
    # B, S, H, G, P, N, chunk; what the plan must show
    ((1, 1024, 48, 1, 64, 128, 256), "fills"),   # mamba2-780m's training shape
    ((1, 271, 48, 1, 64, 128, 256), None),       # its cold prompt
    ((1, 640, 50, 1, 64, 16, 64), None),         # hymba-1.5b training: 50 heads
    ((1, 31, 50, 1, 64, 16, 64), "uneven"),      # hymba-1.5b, a resume
    ((1, 100, 4, 4, 32, 16, 32), "one head"),    # G = H: a slice is one head
    ((1, 200, 6, 2, 16, 8, 128), None),          # 3 heads a group
    ((2, 300, 8, 2, 64, 128, 256), None),        # G = 2, B = 2
])
def test_bwd_plan(shape, want, dtype):
    """At mamba2-780m's training shape the dCB launch fills the card (at
    least 132 CTAs); at hymba-1.5b's 50 heads in one tile the last slice
    is shorter;
    at G = H a slice is one head; every plan holds its invariants."""
    B, S, H, G, P, N, chunk = shape
    plan = ssd_mod.bwd_plan(B, S, H, G, P, N, chunk, dtype)
    _plan_holds(plan, B, S, H, G, P, N, chunk)
    rep = H // G
    if want == "fills":
        assert _dcb_ctas(plan, B, S, H, G, chunk) >= 132
    if want == "uneven":
        assert rep % plan.heads_per_slice and plan.slices > 1
    if want == "one head":
        assert (plan.slices, plan.heads_per_slice) == (1, 1)


def _jax_vjp(x, dt, A, Bg, Cg, h0, dy, dh, chunk):
    """The reference's gradients by ``jax.vjp`` (jitted: one compile, not
    one dispatch an op); ``dh`` None is zero."""
    def f(ins, dy, dh):
        _, vjp = jax.vjp(lambda *a: jax_ssm._ssd_scan(*a, chunk=chunk), *ins)
        return vjp((dy, dh))
    dh = np.zeros_like(h0) if dh is None else dh
    return jax.jit(f)(tuple(jnp.asarray(a) for a in (x, dt, A, Bg, Cg, h0)),
                      jnp.asarray(dy), jnp.asarray(dh))


REF_CASES = [
    # B, S, H, P, N, G, chunk, random h0, dh_final
    (2, 40, 4, 16, 8, 2, 16, True, True),
    (1, 70, 3, 16, 16, 3, 32, False, False),
    (1, 64, 4, 32, 8, 1, 32, True, False),
    (2, 33, 2, 16, 8, 1, 16, False, True),
]


@pytest.mark.parametrize("case", REF_CASES)
def test_plain_backward_matches_the_references_vjp(case):
    """Small decay (|A| <= 1, dt ~ 0.01-0.2, chunk 16-32): the reference's
    exp of the masked side stays finite, and its gradients are the port's."""
    B, S, H, P, N, G, chunk, rh0, dhf = case
    arrs = _inputs(B, S, H, P, N, G, rh0, dhf, seed=7 + S, a_max=1.0)
    ref = [np.asarray(r) for r in _jax_vjp(*arrs, chunk)]
    assert all(np.isfinite(r).all() for r in ref)
    got = ssd_scan_bwd_plain(*(None if a is None else torch.tensor(a)
                               for a in arrs), chunk=chunk)
    errs = _err([g.numpy() for g in got], ref)
    assert max(errs.values()) <= TOL, errs


def test_the_references_gradient_is_nan_at_a_realistic_decay():
    """One head at A = -48 (mamba2-780m's last head: A_log = log(1..48))
    with dt = softplus(N(0, 1) + softplus^-1(0.1)) over one chunk of 64:
    the chunk's decay passes ~88, so the reference's exp(seg) on the masked
    side (i < j, seg > 0) is inf and ``where`` makes the gradient 0 * inf =
    NaN in d(dt) and dA, while its forward is right. The port's plain
    autograd masks before exp: finite, and the two forwards agree."""
    rng = np.random.default_rng(0)
    S, P, N = 64, 16, 8
    z = rng.normal(size=(1, S, 1)) + np.log(np.expm1(0.1))
    dt = np.log1p(np.exp(z)).astype(np.float32)
    assert 48 * dt.sum() > 89
    x = (rng.normal(size=(1, S, 1, P)) * 0.5).astype(np.float32)
    Bg = (rng.normal(size=(1, S, 1, N)) * 0.5).astype(np.float32)
    Cg = (rng.normal(size=(1, S, 1, N)) * 0.5).astype(np.float32)
    A = np.array([-48.0], np.float32)
    h0 = np.zeros((1, 1, P, N), np.float32)
    dy = rng.normal(size=(1, S, 1, P)).astype(np.float32)
    ref = [np.asarray(r) for r in _jax_vjp(x, dt, A, Bg, Cg, h0, dy, None,
                                           64)]
    assert np.isnan(ref[1]).any() and np.isnan(ref[2]).any()
    args = [torch.tensor(a) for a in (x, dt, A, Bg, Cg, h0)]
    got = ssd_scan_bwd_plain(*args, torch.tensor(dy), chunk=64)
    assert all(torch.isfinite(g).all() for g in got)
    y_ref, h_ref = jax_ssm._ssd_scan(*(jnp.asarray(a) for a in (
        x, dt, A, Bg, Cg, h0)), chunk=64)
    y, h = ssd_scan_plain(*args, chunk=64)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=1e-5,
                               rtol=1e-5)
