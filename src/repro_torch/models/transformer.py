"""Layer stack: the dense segment, run as a Python loop over layers.

Counterpart of ``repro.models.transformer`` for ``dense`` segments.
Parameters and caches keep the reference's stacked layout, a leading
``[L, ...]`` layer axis, so parameter trees and state blobs line up
leaf for leaf; the loop over layers replaces ``lax.scan``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import attention as attn
from repro_torch.models.common import apply_norm
from repro_torch.models.mlp import init_mlp, mlp_forward


def init_norm(cfg, dtype, device):
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def init_layer(cfg, dtype, gen: torch.Generator, device=None) -> Dict:
    return {"ln1": init_norm(cfg, dtype, device),
            "attn": attn.init_attention(cfg, dtype, gen, device=device),
            "ln2": init_norm(cfg, dtype, device),
            "mlp": init_mlp(cfg, dtype, gen, device=device)}


def init_segment(cfg, dtype, gen: torch.Generator, device=None) -> Dict:
    """Stacked ``[L, ...]`` parameters of the dense segment."""
    layers = [init_layer(cfg, dtype, gen, device) for _ in range(cfg.n_layers)]
    return {group: {name: torch.stack([lp[group][name] for lp in layers])
                    for name in layers[0][group]}
            for group in layers[0]}


def init_segment_cache(cfg, batch: int, max_len: int, dtype, device=None):
    single = attn.init_kv_cache(cfg, batch, max_len, dtype, device)
    return {name: torch.zeros((cfg.n_layers,) + tuple(t.shape), dtype=dtype,
                              device=device) for name, t in single.items()}


def layer_params(sp: Dict, i: int) -> Dict:
    """Layer ``i``'s views of the stacked segment parameters."""
    return {group: {name: t[i] for name, t in ps.items()}
            for group, ps in sp.items()}


def layer_prefill(lp, cfg, x, positions, lc, start_pos: int):
    h = apply_norm(lp["ln1"], x)
    y, _ = attn.attn_prefill(lp["attn"], cfg, h, positions, lc, start_pos)
    x = x + y
    return x + mlp_forward(lp["mlp"], cfg, apply_norm(lp["ln2"], x))


def layer_decode(lp, cfg, x1, pos: int, lc):
    h = apply_norm(lp["ln1"], x1)
    y, _ = attn.attn_decode(lp["attn"], cfg, h, pos, lc)
    x1 = x1 + y
    return x1 + mlp_forward(lp["mlp"], cfg, apply_norm(lp["ln2"], x1))


def stack_prefill(sp, cfg, x, positions, cache, start_pos: int):
    """Run every layer; ``cache`` ({k, v} of [L, B, S, KV, dh]) is
    updated in place, one layer slice at a time."""
    for i in range(cfg.n_layers):
        lc = {"k": cache["k"][i], "v": cache["v"][i]}
        x = layer_prefill(layer_params(sp, i), cfg, x, positions, lc,
                          start_pos)
    return x


def stack_decode(sp, cfg, x1, pos: int, cache):
    for i in range(cfg.n_layers):
        lc = {"k": cache["k"][i], "v": cache["v"][i]}
        x1 = layer_decode(layer_params(sp, i), cfg, x1, pos, lc)
    return x1
