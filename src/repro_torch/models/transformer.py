"""Layer stacks: segments of one layer kind, run as a Python loop over
layers.

Counterpart of ``repro.models.transformer`` for ``dense``, ``ssm`` and
``mla_dense`` segments. Parameters and caches keep the reference's
stacked layout, a leading ``[L, ...]`` layer axis, so parameter trees and
state blobs line up leaf for leaf; the loop over layers replaces
``lax.scan``. A segment of MoE layers runs no experts here: it must be
empty, as in deepseek-v3 cut to its leading dense layers, and then keeps
the reference's leaves with a zero layer axis.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import apply_norm
from repro_torch.models.mlp import init_mlp, mlp_forward


class Segment(NamedTuple):
    kind: str          # dense | ssm | mla_dense | (empty) moe, mla_moe
    n_layers: int
    d_ff: int          # for the dense kinds' MLP


def segments_for(cfg) -> List[Segment]:
    if cfg.family == "ssm":
        return [Segment("ssm", cfg.n_layers, 0)]
    if cfg.family == "dense":
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
        "item 7)")


def init_norm(cfg, dtype, device):
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def moe_leaves(cfg, dtype, device=None) -> Dict:
    """The reference's MoE leaves (``repro/models/moe.py::init_moe``),
    unset: an empty MoE segment carries them with a zero layer axis. The
    router stays fp32; the expert axis is padded to a multiple of 16 from
    16 experts up, as the reference stores it."""
    mo, d = cfg.moe, cfg.d_model
    e, f = mo.n_experts, mo.expert_ff
    es = -(-e // 16) * 16 if e >= 16 else e
    shapes = {"router": ((d, e), torch.float32), "w_up": ((es, d, f), dtype),
              "w_down": ((es, f, d), dtype)}
    if cfg.gated_mlp:
        shapes["w_gate"] = ((es, d, f), dtype)
    if mo.n_shared:
        fs = (mo.shared_ff or mo.expert_ff) * mo.n_shared
        shapes.update(ws_up=((d, fs), dtype), ws_down=((fs, d), dtype))
        if cfg.gated_mlp:
            shapes["ws_gate"] = ((d, fs), dtype)
    return {name: torch.empty(shape, dtype=dt, device=device)
            for name, (shape, dt) in shapes.items()}


def init_layer(cfg, seg: Segment, dtype, gen: Optional[torch.Generator],
               device=None) -> Dict:
    """One layer's parameters; with no generator, allocated and unset."""
    if seg.kind == "ssm":
        return {"ln1": init_norm(cfg, dtype, device),
                "ssm": ssm_mod.init_ssm(cfg, dtype, gen, device=device)}
    p = {"ln1": init_norm(cfg, dtype, device),
         "ln2": init_norm(cfg, dtype, device)}
    if seg.kind.startswith("mla_"):
        p["mla"] = mla_mod.init_mla(cfg, dtype, gen, device=device)
    else:
        p["attn"] = attn.init_attention(cfg, dtype, gen, device=device)
    if seg.kind.endswith("moe"):
        p["moe"] = moe_leaves(cfg, dtype, device)
    else:
        p["mlp"] = init_mlp(cfg, dtype, gen, seg.d_ff, device=device)
    return p


def init_segment(cfg, seg: Segment, dtype, gen: Optional[torch.Generator],
                 device=None) -> Dict:
    """Stacked ``[L, ...]`` parameters of one segment. A segment of zero
    layers has the leaves of one layer, each with a zero layer axis."""
    if seg.n_layers == 0:
        one = init_layer(cfg, seg, dtype, None, device="meta")
        return {group: {name: torch.empty((0,) + tuple(t.shape),
                                          dtype=t.dtype, device=device)
                        for name, t in ps.items()}
                for group, ps in one.items()}
    if seg.kind.endswith("moe"):
        raise NotImplementedError(
            "MoE layers (routed experts) are not in this port yet (ROADMAP "
            "Queue 1, item 7)")
    layers = [init_layer(cfg, seg, dtype, gen, device)
              for _ in range(seg.n_layers)]
    return {group: {name: torch.stack([lp[group][name] for lp in layers])
                    for name in layers[0][group]}
            for group in layers[0]}


def init_segment_cache(cfg, seg: Segment, batch: int, max_len: int, dtype,
                       device=None):
    """Stacked ``[L, ...]`` cache of one segment; each leaf keeps its own
    dtype (an SSM's ``ssd`` state is fp32 in a bf16 cache)."""
    if seg.kind == "ssm":
        single = ssm_mod.init_ssm_cache(cfg, batch, dtype, device)
    elif seg.kind.startswith("mla_"):
        single = mla_mod.init_mla_cache(cfg, batch, max_len, dtype, device)
    else:
        single = attn.init_kv_cache(cfg, batch, max_len, dtype, device)
    return {name: torch.zeros((seg.n_layers,) + tuple(t.shape),
                              dtype=t.dtype, device=device)
            for name, t in single.items()}


def layer_params(sp: Dict, i: int) -> Dict:
    """Layer ``i``'s views of the stacked segment parameters."""
    return {group: {name: t[i] for name, t in ps.items()}
            for group, ps in sp.items()}


def layer_prefill(lp, cfg, seg: Segment, x, positions, lc, start_pos: int):
    h = apply_norm(lp["ln1"], x)
    if seg.kind == "ssm":
        y, _ = ssm_mod.ssm_prefill(lp["ssm"], cfg, h, lc)
        return x + y
    if seg.kind.startswith("mla_"):
        y, _ = mla_mod.mla_prefill(lp["mla"], cfg, h, positions, lc,
                                   start_pos)
    else:
        y, _ = attn.attn_prefill(lp["attn"], cfg, h, positions, lc,
                                 start_pos)
    x = x + y
    return x + mlp_forward(lp["mlp"], cfg, apply_norm(lp["ln2"], x))


def layer_decode(lp, cfg, seg: Segment, x1, pos: int, lc):
    h = apply_norm(lp["ln1"], x1)
    if seg.kind == "ssm":
        y, _ = ssm_mod.ssm_decode(lp["ssm"], cfg, h, lc)
        return x1 + y
    if seg.kind.startswith("mla_"):
        y, _ = mla_mod.mla_decode(lp["mla"], cfg, h, pos, lc)
    else:
        y, _ = attn.attn_decode(lp["attn"], cfg, h, pos, lc)
    x1 = x1 + y
    return x1 + mlp_forward(lp["mlp"], cfg, apply_norm(lp["ln2"], x1))


def _layer_cache(cache, i: int):
    return {name: t[i] for name, t in cache.items()}


def stack_prefill(sp, cfg, seg: Segment, x, positions, cache,
                  start_pos: int):
    """Run every layer; ``cache`` (the segment's stacked leaves) is
    updated in place, one layer slice at a time."""
    for i in range(seg.n_layers):
        x = layer_prefill(layer_params(sp, i), cfg, seg, x, positions,
                          _layer_cache(cache, i), start_pos)
    return x


def stack_decode(sp, cfg, seg: Segment, x1, pos: int, cache):
    for i in range(seg.n_layers):
        x1 = layer_decode(layer_params(sp, i), cfg, seg, x1, pos,
                          _layer_cache(cache, i))
    return x1
