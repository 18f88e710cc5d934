"""Dense MLP blocks (gated and plain), counterpart of
``repro.models.mlp``. Weights keep the reference layout: ``w_up`` and
``w_gate`` are ``[d, f]``, ``w_down`` is ``[f, d]``."""
from __future__ import annotations

import torch

from repro_torch.models.common import activation, dense_init


def init_mlp(cfg, dtype, gen: torch.Generator, d_ff=None, device=None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"w_up": dense_init((d, f), dtype, gen, device=device),
         "w_down": dense_init((f, d), dtype, gen, device=device)}
    if cfg.gated_mlp:
        p["w_gate"] = dense_init((d, f), dtype, gen, device=device)
    return p


def mlp_forward(p, cfg, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["w_up"]
    if cfg.gated_mlp:
        h = activation(x @ p["w_gate"], cfg.act) * h
    else:
        h = activation(h, cfg.act)
    return h @ p["w_down"]
