"""Layer stacks: segments of one layer kind, run as a Python loop over
layers.

Counterpart of ``repro.models.transformer`` for ``dense`` and ``ssm``
segments. Parameters and caches keep the reference's stacked layout, a
leading ``[L, ...]`` layer axis, so parameter trees and state blobs line
up leaf for leaf; the loop over layers replaces ``lax.scan``.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import apply_norm
from repro_torch.models.mlp import init_mlp, mlp_forward


class Segment(NamedTuple):
    kind: str          # dense | ssm
    n_layers: int
    d_ff: int          # for the dense kind's MLP


def segments_for(cfg) -> List[Segment]:
    if cfg.family == "ssm":
        return [Segment("ssm", cfg.n_layers, 0)]
    if cfg.family == "dense":
        return [Segment("dense", cfg.n_layers, cfg.d_ff)]
    raise NotImplementedError(
        f"family {cfg.family!r} is not in this port yet (ROADMAP Queue 1, "
        "item 7)")


def init_norm(cfg, dtype, device):
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def init_layer(cfg, seg: Segment, dtype, gen: torch.Generator,
               device=None) -> Dict:
    if seg.kind == "ssm":
        return {"ln1": init_norm(cfg, dtype, device),
                "ssm": ssm_mod.init_ssm(cfg, dtype, gen, device=device)}
    return {"ln1": init_norm(cfg, dtype, device),
            "attn": attn.init_attention(cfg, dtype, gen, device=device),
            "ln2": init_norm(cfg, dtype, device),
            "mlp": init_mlp(cfg, dtype, gen, device=device)}


def init_segment(cfg, seg: Segment, dtype, gen: torch.Generator,
                 device=None) -> Dict:
    """Stacked ``[L, ...]`` parameters of one segment."""
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
    y, _ = attn.attn_prefill(lp["attn"], cfg, h, positions, lc, start_pos)
    x = x + y
    return x + mlp_forward(lp["mlp"], cfg, apply_norm(lp["ln2"], x))


def layer_decode(lp, cfg, seg: Segment, x1, pos: int, lc):
    h = apply_norm(lp["ln1"], x1)
    if seg.kind == "ssm":
        y, _ = ssm_mod.ssm_decode(lp["ssm"], cfg, h, lc)
        return x1 + y
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
