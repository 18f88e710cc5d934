"""Hymba-style hybrid block: attention and an SSM run in parallel on the
same (pre-norm) input; each branch's output is normalised on its own and
the two are mean-fused.

Counterpart of ``repro.models.hybrid`` (arXiv:2411.13676). The
attention branch keeps a sliding-window ring KV cache
(:mod:`repro_torch.models.attention`), the SSM branch a conv window and
an SSD state (:mod:`repro_torch.models.ssm`); a layer's cache is
``{"attn": {k, v}, "ssm": {conv, ssd}}`` and both branches update their
half IN PLACE. Meta tokens (the learned prefix) are the model's
(:class:`repro_torch.models.model.Model`). :func:`hybrid_forward` is the
training path (no cache).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models.attention import (Pos, attn_decode, attn_forward,
                                          attn_prefill, init_attention,
                                          init_kv_cache)
from repro_torch.models.common import rmsnorm
from repro_torch.models.ssm import (init_ssm, init_ssm_cache, ssm_decode,
                                    ssm_forward, ssm_prefill)


def init_hybrid_attn(cfg, dtype, gen: Optional[torch.Generator],
                     device=None) -> Dict:
    return {
        "attn": init_attention(cfg, dtype, gen, device=device),
        "ssm": init_ssm(cfg, dtype, gen, device=device),
        "norm_attn": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        "norm_ssm": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
    }


def _fuse(p, a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return 0.5 * (rmsnorm(a, p["norm_attn"]) + rmsnorm(s, p["norm_ssm"]))


def hybrid_forward(p, cfg, x, positions) -> torch.Tensor:
    """Training / no-cache forward: both branches over x [B, S, D]."""
    return _fuse(p, attn_forward(p["attn"], cfg, x, positions),
                 ssm_forward(p["ssm"], cfg, x))


def hybrid_prefill(p, cfg, x, positions, cache, start_pos: int):
    a, _ = attn_prefill(p["attn"], cfg, x, positions, cache["attn"],
                        start_pos)
    s, _ = ssm_prefill(p["ssm"], cfg, x, cache["ssm"])
    return _fuse(p, a, s), cache


def hybrid_decode(p, cfg, x1, pos: Pos, cache,
                  kv_max: Optional[int] = None):
    a, _ = attn_decode(p["attn"], cfg, x1, pos, cache["attn"], kv_max=kv_max)
    s, _ = ssm_decode(p["ssm"], cfg, x1, cache["ssm"])
    return _fuse(p, a, s), cache


def init_hybrid_cache(cfg, batch: int, max_len: int, dtype, device=None):
    return {"attn": init_kv_cache(cfg, batch, max_len, dtype, device),
            "ssm": init_ssm_cache(cfg, batch, dtype, device)}
