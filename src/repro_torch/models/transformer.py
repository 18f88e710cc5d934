"""Layer stacks: segments of one layer kind, run as a Python loop over
layers.

Counterpart of ``repro.models.transformer`` for ``dense``, ``moe``,
``ssm``, ``hybrid``, ``mla_dense`` and ``mla_moe`` segments. Parameters
and caches keep the reference's stacked layout, a leading ``[L, ...]``
layer axis on every leaf of their nested dicts, so parameter trees and
state blobs line up leaf for leaf; the loop over layers replaces
``lax.scan``. A MoE layer's FFN is :func:`repro_torch.models.moe.moe_forward`;
an empty segment (deepseek-v3 cut to its leading dense layers) keeps the
reference's leaves with a zero layer axis.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models import hybrid as hyb
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import apply_norm, tree_map
from repro_torch.models.mlp import init_mlp, mlp_forward


class Segment(NamedTuple):
    kind: str          # dense | moe | ssm | hybrid | mla_dense | mla_moe
    n_layers: int
    d_ff: int          # for the dense kinds' MLP


def segments_for(cfg) -> List[Segment]:
    if cfg.family == "ssm":
        return [Segment("ssm", cfg.n_layers, 0)]
    if cfg.family == "hybrid":
        return [Segment("hybrid", cfg.n_layers, cfg.d_ff)]
    if cfg.family in ("dense", "vlm"):     # a VLM's text stack is dense
        return [Segment("dense", cfg.n_layers, cfg.d_ff)]
    if cfg.family == "moe":
        fk = cfg.moe.first_k_dense
        att = "mla_" if cfg.uses_mla else ""
        segs = []
        if fk:
            segs.append(Segment(att + "dense", fk,
                                cfg.moe.dense_ff or cfg.d_ff))
        segs.append(Segment(att + "moe", cfg.n_layers - fk, 0))
        return segs
    raise NotImplementedError(
        f"family {cfg.family!r} is not in this port yet (ROADMAP Queue 1, "
        "item 9)")


def init_norm(cfg, dtype, device):
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def init_layer(cfg, seg: Segment, dtype, gen: Optional[torch.Generator],
               device=None) -> Dict:
    """One layer's parameters; with no generator, allocated and unset."""
    if seg.kind == "ssm":
        return {"ln1": init_norm(cfg, dtype, device),
                "ssm": ssm_mod.init_ssm(cfg, dtype, gen, device=device)}
    if seg.kind == "hybrid":
        return {"ln1": init_norm(cfg, dtype, device),
                "hyb": hyb.init_hybrid_attn(cfg, dtype, gen, device=device),
                "ln2": init_norm(cfg, dtype, device),
                "mlp": init_mlp(cfg, dtype, gen, seg.d_ff, device=device)}
    p = {"ln1": init_norm(cfg, dtype, device),
         "ln2": init_norm(cfg, dtype, device)}
    if seg.kind.startswith("mla_"):
        p["mla"] = mla_mod.init_mla(cfg, dtype, gen, device=device)
    else:
        p["attn"] = attn.init_attention(cfg, dtype, gen, device=device)
    if seg.kind.endswith("moe"):
        p["moe"] = moe_mod.init_moe(cfg, dtype, gen, device=device)
    else:
        p["mlp"] = init_mlp(cfg, dtype, gen, seg.d_ff, device=device)
    return p


def init_segment(cfg, seg: Segment, dtype, gen: Optional[torch.Generator],
                 device=None) -> Dict:
    """Stacked ``[L, ...]`` parameters of one segment. A segment of zero
    layers has the leaves of one layer, each with a zero layer axis."""
    if seg.n_layers == 0:
        one = init_layer(cfg, seg, dtype, None, device="meta")
        return tree_map(lambda t: torch.empty(
            (0,) + tuple(t.shape), dtype=t.dtype, device=device), one)
    layers = [init_layer(cfg, seg, dtype, gen, device)
              for _ in range(seg.n_layers)]
    if len(layers) == 1:               # a view: no second copy of a layer
        return tree_map(lambda t: t.unsqueeze(0), layers[0])
    return tree_map(lambda *ts: torch.stack(ts), *layers)


def init_segment_cache(cfg, seg: Segment, batch: int, max_len: int, dtype,
                       device=None):
    """Stacked ``[L, ...]`` cache of one segment; each leaf keeps its own
    dtype (an SSM's ``ssd`` state is fp32 in a bf16 cache)."""
    if seg.kind == "ssm":
        single = ssm_mod.init_ssm_cache(cfg, batch, dtype, device)
    elif seg.kind == "hybrid":
        single = hyb.init_hybrid_cache(cfg, batch, max_len, dtype, device)
    elif seg.kind.startswith("mla_"):
        single = mla_mod.init_mla_cache(cfg, batch, max_len, dtype, device)
    else:
        single = attn.init_kv_cache(cfg, batch, max_len, dtype, device)
    return tree_map(lambda t: torch.zeros(
        (seg.n_layers,) + tuple(t.shape), dtype=t.dtype, device=device),
        single)


def layer_params(sp: Dict, i: int) -> Dict:
    """Layer ``i``'s views of the stacked segment parameters (or cache)."""
    return tree_map(lambda t: t[i], sp)


def _ffn(lp, cfg, seg: Segment, x):
    """The layer's FFN: the routed experts of a MoE layer (its aux loss
    unused in serving), else the dense MLP."""
    if seg.kind.endswith("moe"):
        return moe_mod.moe_forward(lp["moe"], cfg, x, aux=False)[0]
    return mlp_forward(lp["mlp"], cfg, x)


def layer_prefill(lp, cfg, seg: Segment, x, positions, lc, start_pos: int):
    h = apply_norm(lp["ln1"], x)
    if seg.kind == "ssm":
        y, _ = ssm_mod.ssm_prefill(lp["ssm"], cfg, h, lc)
        return x + y
    if seg.kind == "hybrid":
        y, _ = hyb.hybrid_prefill(lp["hyb"], cfg, h, positions, lc,
                                  start_pos)
    elif seg.kind.startswith("mla_"):
        y, _ = mla_mod.mla_prefill(lp["mla"], cfg, h, positions, lc,
                                   start_pos)
    else:
        y, _ = attn.attn_prefill(lp["attn"], cfg, h, positions, lc,
                                 start_pos)
    x = x + y
    return x + _ffn(lp, cfg, seg, apply_norm(lp["ln2"], x))


def layer_decode(lp, cfg, seg: Segment, x1, pos: attn.Pos, lc,
                 kv_max: Optional[int] = None):
    """One token a row at ``pos`` (an int, or one a row with ``kv_max`` a
    host bound of ``pos + 1``); an SSM layer takes no position."""
    h = apply_norm(lp["ln1"], x1)
    if seg.kind == "ssm":
        y, _ = ssm_mod.ssm_decode(lp["ssm"], cfg, h, lc)
        return x1 + y
    if seg.kind == "hybrid":
        y, _ = hyb.hybrid_decode(lp["hyb"], cfg, h, pos, lc, kv_max=kv_max)
    elif seg.kind.startswith("mla_"):
        y, _ = mla_mod.mla_decode(lp["mla"], cfg, h, pos, lc, kv_max=kv_max)
    else:
        y, _ = attn.attn_decode(lp["attn"], cfg, h, pos, lc, kv_max=kv_max)
    x1 = x1 + y
    return x1 + _ffn(lp, cfg, seg, apply_norm(lp["ln2"], x1))


def stack_prefill(sp, cfg, seg: Segment, x, positions, cache,
                  start_pos: int):
    """Run every layer; ``cache`` (the segment's stacked leaves) is
    updated in place, one layer slice at a time."""
    for i in range(seg.n_layers):
        x = layer_prefill(layer_params(sp, i), cfg, seg, x, positions,
                          layer_params(cache, i), start_pos)
    return x


def stack_decode(sp, cfg, seg: Segment, x1, pos: attn.Pos, cache,
                 kv_max: Optional[int] = None):
    for i in range(seg.n_layers):
        x1 = layer_decode(layer_params(sp, i), cfg, seg, x1, pos,
                          layer_params(cache, i), kv_max)
    return x1
