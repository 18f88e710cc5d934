"""Mixture-of-Experts layer: top-k routing, the routed rows sorted by
expert, and the expert FFN on the grouped expert GEMM.

Counterpart of ``repro/models/moe.py:41-132`` for one device
(``stored_experts``, ``init_moe``, ``route``, ``_shared_ffn``,
``moe_local``, and ``moe_forward`` with no mesh). The expert-parallel
paths (``moe_ep``, ``moe_ep_resident``) wait for ROADMAP Queue 1, item 11.

Every op of the layer runs on the tensors' device and reads nothing on
the host: the group offsets come from ``searchsorted`` on the sorted
expert ids (``torch.bincount`` would read its input's max on the host),
and :func:`repro_torch.kernels.moe_gemm.moe_gemm` reads them from device
memory. So a decode step of a MoE model can be captured as a CUDA graph.

The combine is deterministic and in the reference's order. The reference
adds each sorted row into its token with a scatter-add, rows sorted by
expert id (a stable ``argsort``), in the activation dtype. Here each
token's k rows come back through the inverse permutation, in the order
of their expert ids, and are added one after the other in the activation
dtype, with the routing weight cast to it as the reference casts it. No
atomic add (``index_add_`` on CUDA) is used: its float sums would change
order, and bf16 tokens with it, from run to run.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_gemm import moe_gemm
from repro_torch.models.common import activation, dense_init


def stored_experts(cfg) -> int:
    """The expert axis as stored: padded to a multiple of 16 from 16
    experts up, as the reference stores it (the padded experts receive no
    rows and cost nothing)."""
    e = cfg.moe.n_experts
    return -(-e // 16) * 16 if e >= 16 else e


def init_moe(cfg, dtype, gen: Optional[torch.Generator], device=None):
    """The reference's leaves, in its order and at its scales: ``dense_init``
    takes ``fan_in`` from the first axis, which is the stored-expert count
    for the ``[E, d, f]`` stacks. The router stays fp32. With no generator
    the leaves are allocated and left unset."""
    mo = cfg.moe
    d, f = cfg.d_model, mo.expert_ff
    es = stored_experts(cfg)
    p = {"router": dense_init((d, mo.n_experts), torch.float32, gen,
                              device=device),
         "w_up": dense_init((es, d, f), dtype, gen, device=device),
         "w_down": dense_init((es, f, d), dtype, gen, device=device)}
    if cfg.gated_mlp:
        p["w_gate"] = dense_init((es, d, f), dtype, gen, device=device)
    if mo.n_shared:
        fs = (mo.shared_ff or mo.expert_ff) * mo.n_shared
        p["ws_up"] = dense_init((d, fs), dtype, gen, device=device)
        p["ws_down"] = dense_init((fs, d), dtype, gen, device=device)
        if cfg.gated_mlp:
            p["ws_gate"] = dense_init((d, fs), dtype, gen, device=device)
    return p


def route(p, cfg, xf: torch.Tensor, aux: bool = True):
    """xf [T, D] -> (weights [T, k] fp32, ids [T, k], aux loss or None).
    The router runs in fp32; the top-k weights are renormalised; ``aux``
    is the switch load-balance loss (serving asks for none)."""
    mo = cfg.moe
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)
    w, ids = torch.topk(probs, mo.top_k, dim=-1)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-9)
    if not aux:
        return w, ids, None
    frac = F.one_hot(ids, mo.n_experts).float().mean(dim=(0, 1))
    load = probs.mean(dim=0)
    return w, ids, mo.n_experts * torch.sum(frac * load) * mo.aux_coef


class Dispatch(NamedTuple):
    """The routed rows of T tokens sorted by expert (k rows a token)."""
    xs: torch.Tensor        # [T*k, D] rows, sorted by expert id, then token
    offsets: torch.Tensor   # [E + 1] int32: expert e's rows are [off[e], off[e+1])
    weights: torch.Tensor   # [T*k] each sorted row's routing weight (fp32)
    back: torch.Tensor      # [T, k] token t's rows' sorted positions, by expert id


def dispatch(xf: torch.Tensor, w: torch.Tensor, ids: torch.Tensor,
             n_stored: int) -> Dispatch:
    """Sort the T*k routed rows by expert, as the reference's stable
    ``argsort`` does (ties by token), and keep the way back."""
    T, k = ids.shape
    ids, perm = torch.sort(ids, dim=-1)        # a token's experts by id
    w = torch.gather(w, -1, perm)
    eid, order = torch.sort(ids.reshape(-1), stable=True)
    offsets = torch.searchsorted(
        eid, torch.arange(n_stored + 1, device=eid.device), out_int32=True)
    back = torch.empty_like(order).scatter_(
        0, order, torch.arange(T * k, device=order.device))
    return Dispatch(xf.index_select(0, order // k), offsets,
                    w.reshape(-1)[order], back.view(T, k))


def _expert_ffn(xs: torch.Tensor, p, cfg, offsets: torch.Tensor):
    """The routed experts' FFN over sorted rows: three grouped products."""
    h = moe_gemm(xs, p["w_up"], offsets)
    if cfg.gated_mlp:
        h = activation(moe_gemm(xs, p["w_gate"], offsets), cfg.act) * h
    else:
        h = activation(h, cfg.act)
    return moe_gemm(h, p["w_down"], offsets)


def combine(y: torch.Tensor, d: Dispatch) -> torch.Tensor:
    """y [T*k, D] (sorted rows) -> [T, D]: each token's k rows times their
    weights, added in order of expert id in y's dtype."""
    rows = (y * d.weights.to(y.dtype)[:, None]).index_select(
        0, d.back.reshape(-1)).view(*d.back.shape, y.shape[1])
    out = rows[:, 0]
    for j in range(1, rows.shape[1]):
        out = out + rows[:, j]
    return out


def _shared_ffn(x: torch.Tensor, p, cfg) -> torch.Tensor:
    h = x @ p["ws_up"]
    if cfg.gated_mlp:
        h = activation(x @ p["ws_gate"], cfg.act) * h
    else:
        h = activation(h, cfg.act)
    return h @ p["ws_down"]


def moe_local(p, cfg, x: torch.Tensor, aux: bool = True):
    """x [B, S, D] -> (out [B, S, D], aux loss or None)."""
    B, S, D = x.shape
    xf = x.reshape(-1, D)
    w, ids, loss = route(p, cfg, xf, aux)
    d = dispatch(xf, w, ids, p["w_up"].shape[0])
    out = combine(_expert_ffn(d.xs, p, cfg, d.offsets), d)
    if cfg.moe.n_shared:
        out = out + _shared_ffn(xf, p, cfg)
    return out.reshape(B, S, D), loss


def moe_forward(p, cfg, x: torch.Tensor, mesh=None, aux: bool = True):
    """The reference's ``moe_forward`` with no mesh: :func:`moe_local`."""
    if mesh is not None:
        raise NotImplementedError(
            "expert-parallel MoE (moe_ep, moe_ep_resident) is not in this "
            "port yet (ROADMAP Queue 1, item 11)")
    return moe_local(p, cfg, x, aux)
