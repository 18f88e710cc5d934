"""Mixture-of-Experts layer: top-k routing, the routed rows sorted by
expert, and the expert FFN on the grouped expert GEMM.

Counterpart of ``repro/models/moe.py``: ``stored_experts``,
``init_moe``, ``route``, ``_shared_ffn``, ``moe_local`` (one device),
the expert-parallel ``moe_ep`` and ``moe_ep_resident`` over a
``torch.distributed`` mesh (``launch/mesh.py``), and ``moe_forward``,
which picks among them by the reference's rule.

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

Expert parallelism. Each rank of the mesh holds only its ``model``-axis
slice of the expert stacks, ``e_pad / n_model`` experts with the stack
padded by zero experts to ``e_pad``, a multiple of ``n_model``
(``init_moe``'s ``ep``, decided once when a ``Model`` is built under its
mesh); the router and the shared expert are
replicated. A rank's share of the layer is computed by a function of its
coordinates and its slice alone (:func:`moe_ep_partial`,
:func:`moe_ep_resident_partial`), and :func:`moe_ep` /
:func:`moe_ep_resident` sum the shares over the group, as the
reference's ``shard_map`` bodies ``psum`` them. The semantics are the
reference's: rows routed to another rank's experts take the sentinel
group ``e_loc`` and sort last (a stable sort), only the first ``cap``
sorted rows are kept, so routed rows past the capacity are dropped, and
``moe_ep`` routes and bounds ``_TOKEN_CHUNK`` tokens at a time, its aux
loss the chunks' mean. The grouped GEMM leaves the rows past the
groups' end unwritten (``torch.empty``), so the combine selects the
kept rows with ``torch.where`` and never multiplies such a row by 0.
The shared expert runs replicated and is added after the sum (the
reference runs it tensor-parallel inside the sum: the same function,
its fp32 sums in another order, within 1e-6 at the tests' widths).
Every op stays on the device: ``cap`` is a host int from the shapes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_gemm import moe_gemm
from repro_torch.launch.mesh import (all_axes_group, axis_index, axis_names,
                                     axis_size)
from repro_torch.models.common import activation, dense_init
from repro_torch.params import expert_slice

# tokens a rank routes at once in moe_ep (the reference's _TOKEN_CHUNK):
# the capacity and the aux loss are per chunk
_TOKEN_CHUNK = 8192
RESIDENT_MAX_TOKENS = 4096     # moe_forward's bound for the resident path


def stored_experts(cfg) -> int:
    """The expert axis as stored: padded to a multiple of 16 from 16
    experts up, as the reference stores it (the padded experts receive no
    rows and cost nothing)."""
    e = cfg.moe.n_experts
    return -(-e // 16) * 16 if e >= 16 else e


def init_moe(cfg, dtype, gen: Optional[torch.Generator], device=None,
             ep: Tuple[int, int] = (0, 1)):
    """The reference's leaves, in its order and at its scales: ``dense_init``
    takes ``fan_in`` from the first axis, which is the stored-expert count
    for the ``[E, d, f]`` stacks. The router stays fp32. With no generator
    the leaves are allocated and left unset. ``ep = (m, n_model)``: the
    expert stacks hold only model index ``m``'s slice, ``e_pad / n_model``
    experts (:func:`repro_torch.params.expert_slice`); from a generator
    each stack is drawn whole and cut, so the weights are those of the
    layer with no mesh."""
    mo = cfg.moe
    d, f = cfg.d_model, mo.expert_ff
    es = stored_experts(cfg)
    m, n_model = ep
    e_loc = ep_layout(es, n_model)[1]

    def experts(shape):
        if gen is None:
            return dense_init((e_loc,) + shape, dtype, None, device=device)
        return expert_slice(dense_init((es,) + shape, dtype, gen,
                                       device=device), m, n_model, es)

    p = {"router": dense_init((d, mo.n_experts), torch.float32, gen,
                              device=device),
         "w_up": experts((d, f)),
         "w_down": experts((f, d))}
    if cfg.gated_mlp:
        p["w_gate"] = experts((d, f))
    if mo.n_shared:
        fs = (mo.shared_ff or mo.expert_ff) * mo.n_shared
        p["ws_up"] = dense_init((d, fs), dtype, gen, device=device)
        p["ws_down"] = dense_init((fs, d), dtype, gen, device=device)
        if cfg.gated_mlp:
            p["ws_gate"] = dense_init((d, fs), dtype, gen, device=device)
    return p


def route(p, cfg, xf: torch.Tensor, aux: bool = True,
          n_real: Optional[int] = None):
    """xf [T, D] -> (weights [T, k] fp32, ids [T, k], aux loss or None).
    The router runs in fp32; the top-k weights are renormalised; ``aux``
    is the switch load-balance loss (serving asks for none). Rows from
    ``n_real`` on are zero padding (a chunk's tail in ``moe_ep``): their
    probabilities tie over every expert, and they take experts ``0..k-1``,
    as the reference's ``top_k`` breaks a tie (``torch.topk`` does not
    say how it breaks one)."""
    mo = cfg.moe
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)
    w, ids = torch.topk(probs, mo.top_k, dim=-1)
    if n_real is not None and n_real < ids.shape[0]:
        ids[n_real:] = torch.arange(mo.top_k, device=ids.device)
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


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------

def ep_layout(e_stored: int, n_ep: int) -> Tuple[int, int]:
    """``(e_pad, e_loc)``: the stored experts padded to a multiple of the
    ``n_ep`` ranks, and the experts a rank holds."""
    e_pad = -(-e_stored // n_ep) * n_ep
    return e_pad, e_pad // n_ep


class EpPart(NamedTuple):
    """One rank's share of a MoE layer under expert parallelism."""
    out: torch.Tensor              # [b, S, D]: its experts' rows, combined
    aux: Optional[torch.Tensor]    # the aux loss of the tokens it routed
    # a chunk's kept rows a local expert: [e_loc + 1] int32 group offsets,
    # one tensor a chunk; offsets[-1] is the rows kept within the capacity
    offsets: Tuple[torch.Tensor, ...]


def _ep_rows(p, cfg, xc, lo: int, e_loc: int, cap: int, aux: bool,
             n_real: Optional[int] = None):
    """The rows of tokens ``xc`` [t, D] routed to experts ``[lo, lo +
    e_loc)`` (``p``'s stacks), the first ``cap`` of the sorted rows kept:
    ``(out [t, D], aux, offsets)``. The body of the reference's
    ``chunk_fn`` and of its resident ``f``."""
    k = cfg.moe.top_k
    t, D = xc.shape
    w, ids, loss = route(p, cfg, xc, aux, n_real)
    ids, perm = torch.sort(ids, dim=-1)        # a token's experts by id
    w = torch.gather(w, -1, perm)
    local = (ids >= lo) & (ids < lo + e_loc)
    eid = torch.where(local, ids - lo, e_loc).reshape(-1)
    eid_sorted, order = torch.sort(eid, stable=True)
    sel = order[:cap]
    offsets = torch.searchsorted(
        eid_sorted[:cap], torch.arange(e_loc + 1, device=eid.device),
        out_int32=True)                        # the sentinel rows: past E
    y = _expert_ffn(xc.index_select(0, sel // k), p, cfg, offsets)
    back = torch.empty_like(order).scatter_(
        0, order, torch.arange(t * k, device=order.device))
    # a row is kept where its sorted position is one of the local rows
    # among the first cap (they sort first); the others' y rows are
    # past offsets[-1], never written, and selected away, not scaled by 0
    keep = back < offsets[-1]
    rows = y.index_select(0, back.clamp(max=cap - 1)) * \
        w.reshape(-1, 1).to(y.dtype)
    rows = torch.where(keep[:, None], rows, 0).view(t, k, D)
    out = rows[:, 0]
    for j in range(1, k):
        out = out + rows[:, j]
    return out, loss, offsets


def ep_capacity(cfg, t: int, n_ep: int) -> int:
    """``moe_ep``'s rows kept a rank of a chunk of ``t`` tokens."""
    mo = cfg.moe
    cap = int(t * mo.top_k / n_ep * mo.capacity_factor)
    return min(max(cap, 1), t * mo.top_k)


def resident_capacity(cfg, t: int, n_ep: int) -> int:
    """``moe_ep_resident``'s rows kept a rank of ``t`` tokens."""
    mo = cfg.moe
    cap = int(max(t * mo.top_k / n_ep * mo.capacity_factor, 8))
    return min(cap, t * mo.top_k)


def moe_ep_partial(p, cfg, x: torch.Tensor, m: int, n_model: int,
                   aux: bool = True) -> EpPart:
    """Rank ``m`` of ``n_model`` on the ``model`` axis: its share of the
    routed experts for its rows ``x`` [b, S, D], ``p`` holding the router
    and its slice of ``e_pad / n_model`` experts. Tokens are routed
    ``_TOKEN_CHUNK`` at a time, the last chunk padded with zero rows as
    the reference pads it; ``aux`` is the chunks' mean."""
    b, S, D = x.shape
    xf = x.reshape(-1, D)
    t = xf.shape[0]
    e_loc = p["w_up"].shape[0]
    tc = _TOKEN_CHUNK
    if t <= tc:
        out, loss, offsets = _ep_rows(
            p, cfg, xf, m * e_loc, e_loc, ep_capacity(cfg, t, n_model), aux)
        return EpPart(out.view(b, S, D), loss, (offsets,))
    xp = F.pad(xf, (0, 0, 0, (-t) % tc))
    cap = ep_capacity(cfg, tc, n_model)
    parts = [_ep_rows(p, cfg, xc, m * e_loc, e_loc, cap, aux,
                      n_real=min(tc, t - i * tc))
             for i, xc in enumerate(xp.split(tc))]
    out = torch.cat([q[0] for q in parts])[:t].view(b, S, D)
    loss = torch.stack([q[1] for q in parts]).mean() if aux else None
    return EpPart(out, loss, tuple(q[2] for q in parts))


def moe_ep_resident_partial(p, cfg, x: torch.Tensor, idx: int, n_ep: int,
                            aux: bool = True) -> EpPart:
    """Rank ``idx`` of ``n_ep`` (``m * n_data + d`` on a mesh): its share
    of the routed experts for every token ``x`` [B, S, D], ``p`` holding
    the router and its ``e_stored / n_ep`` resident experts
    (:func:`resident_slice`)."""
    B, S, D = x.shape
    xf = x.reshape(-1, D)
    e_loc = p["w_up"].shape[0]
    cap = resident_capacity(cfg, xf.shape[0], n_ep)
    out, loss, offsets = _ep_rows(p, cfg, xf, idx * e_loc, e_loc, cap, aux)
    return EpPart(out.view(B, S, D), loss, (offsets,))


EXPERT_LEAVES = ("w_up", "w_gate", "w_down")


def resident_slice(p, d: int, n_data: int):
    """The resident experts of data index ``d`` within a rank's ``moe_ep``
    slice (views): ``e_loc / n_data`` experts from ``d * e_loc /
    n_data``. With ``e_stored % (n_model * n_data) == 0`` the resident
    index ``m * n_data + d`` holds experts ``[m E/n_m + d E/(n_m n_d),
    ...)``, inside model index m's slice ``[m E/n_m, (m+1) E/n_m)``: one
    slice serves both paths."""
    e_res = p["w_up"].shape[0] // n_data
    return {k: (v[d * e_res:(d + 1) * e_res] if k in EXPERT_LEAVES else v)
            for k, v in p.items()}


def _check_slice(p, cfg, n_model: int) -> None:
    e_loc = ep_layout(stored_experts(cfg), n_model)[1]
    if p["w_up"].shape[0] != e_loc:
        raise ValueError(
            f"expert leaves of {p['w_up'].shape[0]} experts under a mesh of "
            f"{n_model} model ranks: a rank holds its slice of {e_loc} "
            "(a Model built with the mesh holds it)")


def _with_shared(out, p, cfg, x):
    if cfg.moe.n_shared:
        B, S, D = x.shape
        out = out + _shared_ffn(x.reshape(-1, D), p, cfg).view(B, S, D)
    return out


def moe_ep(p, cfg, x: torch.Tensor, mesh, aux: bool = True):
    """Expert-parallel MoE over ``mesh``'s ``model`` axis, ``p`` holding
    this rank's expert slice. The batch is split over ``data`` where the
    axis divides it (the reference keeps a data axis only then; a small
    decode batch is replicated), each rank's share is summed over
    ``model``, and the data shards are gathered back, so every rank
    returns the whole ``(out [B, S, D], aux)``, aux averaged over the
    data shards."""
    import torch.distributed as dist
    n_model, m = axis_size(mesh, "model"), axis_index(mesh, "model")
    _check_slice(p, cfg, n_model)
    B = x.shape[0]
    n_data = axis_size(mesh, "data")
    split = "data" in axis_names(mesh) and B % n_data == 0
    xl = x
    if split:
        b = B // n_data
        d = axis_index(mesh, "data")
        xl = x[d * b:(d + 1) * b]
    part = moe_ep_partial(p, cfg, xl, m, n_model, aux)
    out, loss = part.out, part.aux
    dist.all_reduce(out, group=mesh.get_group("model"))
    if split:
        group = mesh.get_group("data")
        shards = [torch.empty_like(out) for _ in range(n_data)]
        dist.all_gather(shards, out.contiguous(), group=group)
        out = torch.cat(shards)
        if aux:
            dist.all_reduce(loss, group=group)
            loss = loss / n_data
    return _with_shared(out, p, cfg, x), loss


def moe_ep_resident(p, cfg, x: torch.Tensor, mesh, aux: bool = True):
    """The reference's resident-expert path (a decode batch): every rank
    routes every token, against its ``e_stored / (n_model n_data)``
    experts (within its ``moe_ep`` slice, no weights move), and the
    shares are summed over both axes. Returns ``(out, aux)``."""
    import torch.distributed as dist
    n_model, n_data = axis_size(mesh, "model"), axis_size(mesh, "data")
    e_stored = stored_experts(cfg)
    if e_stored % (n_model * n_data):
        raise ValueError(f"{e_stored} experts do not split over "
                         f"{n_model} x {n_data} ranks")
    _check_slice(p, cfg, n_model)
    m, d = axis_index(mesh, "model"), axis_index(mesh, "data")
    part = moe_ep_resident_partial(resident_slice(p, d, n_data), cfg, x,
                                   m * n_data + d, n_model * n_data, aux)
    dist.all_reduce(part.out, group=all_axes_group(mesh))
    return _with_shared(part.out, p, cfg, x), part.aux


def moe_forward(p, cfg, x: torch.Tensor, mesh=None, aux: bool = True):
    """The reference's choice (``repro/models/moe.py:313-321``):
    :func:`moe_local` with no mesh or no ``model`` axis; the resident
    path for at most 4096 tokens whose stored experts split evenly over
    ``model`` x ``data``; else :func:`moe_ep`."""
    if mesh is None or "model" not in axis_names(mesh):
        return moe_local(p, cfg, x, aux)
    tokens = x.shape[0] * x.shape[1]
    n_md = axis_size(mesh, "model") * axis_size(mesh, "data")
    if tokens <= RESIDENT_MAX_TOKENS and stored_experts(cfg) % n_md == 0:
        return moe_ep_resident(p, cfg, x, mesh, aux)
    return moe_ep(p, cfg, x, mesh, aux)
