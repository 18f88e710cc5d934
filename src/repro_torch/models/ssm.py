"""Mamba-2 (SSD) layer: chunked prefill from an initial state, and the
one-token recurrent decode.

Counterpart of ``repro.models.ssm``. An SSM's prompt cache is the
(conv window, SSD state) pair at a boundary; :func:`ssm_prefill`
continues from it, through the ``ssd_scan`` kernel with ``h0`` = the
cache's ``ssd``. Per layer:

  conv: [B, d_conv-1, conv_dim]   rolling conv window, in the cache dtype
  ssd:  [B, H, P, N]              SSD recurrent state, fp32

Unlike the reference, both functions write the new state into the cache
tensors IN PLACE. :func:`ssm_decode` stays plain PyTorch ops, as the
reference's decode has no kernel.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.common import dense_init, rmsnorm

Params = Dict[str, torch.Tensor]


def init_ssm(cfg, dtype, gen: torch.Generator, device=None) -> Params:
    s = cfg.ssm
    d, di, H = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_n_heads
    conv_dim = di + 2 * s.n_groups * s.d_state
    d_in_proj = 2 * di + 2 * s.n_groups * s.d_state + H
    lo, hi = math.log(0.001), math.log(0.1)
    dt = torch.exp(torch.rand((H,), generator=gen) * (hi - lo) + lo)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init((d, d_in_proj), dtype, gen, device=device),
        "conv_w": dense_init((s.d_conv, conv_dim), dtype, gen, scale=0.4,
                             device=device),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.arange(1, H + 1, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.log(torch.expm1(dt)).to(**f32),
        "norm": torch.zeros((di,), dtype=dtype, device=device),
        "out_proj": dense_init((di, d), dtype, gen, device=device),
    }


def init_ssm_cache(cfg, batch: int, dtype, device=None) -> Params:
    s = cfg.ssm
    conv_dim = cfg.ssm_d_inner + 2 * s.n_groups * s.d_state
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssd": torch.zeros((batch, cfg.ssm_n_heads, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
    }


def _split_proj(cfg, zxbcdt: torch.Tensor):
    """in_proj output -> (z [.., di], xBC [.., conv_dim], dt [.., H])."""
    di = cfg.ssm_d_inner
    gn = 2 * cfg.ssm.n_groups * cfg.ssm.d_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + gn],
            zxbcdt[..., 2 * di + gn:])


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: torch.Tensor):
    """xBC: [B,S,C]; w: [K,C] depthwise; prev: [B,K-1,C]. Returns
    (silu(conv + b) [B,S,C], the new window [B,K-1,C])."""
    K, S = w.shape[0], xBC.shape[1]
    full = torch.cat([prev.to(xBC.dtype), xBC], dim=1)      # [B, S+K-1, C]
    y = full[:, 0:S] * w[0]
    for i in range(1, K):                  # K shifted adds (K is 4)
        y = y + full[:, i:i + S] * w[i]
    return F.silu(y + b), full[:, S:]


def _split_xbc(cfg, xBC: torch.Tensor):
    """Views of the conv output: x [B,S,H,P], B and C [B,S,G,N]."""
    s = cfg.ssm
    di, G, N = cfg.ssm_d_inner, s.n_groups, s.d_state
    lead = xBC.shape[:2]
    return (xBC[..., :di].unflatten(-1, (cfg.ssm_n_heads, s.head_dim)),
            xBC[..., di:di + G * N].reshape(*lead, G, N),
            xBC[..., di + G * N:].reshape(*lead, G, N))


def _gate_out(p: Params, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """rmsnorm(y * silu(z)) @ out_proj, y already in the model dtype."""
    return rmsnorm(y * F.silu(z), p["norm"]) @ p["out_proj"]


def ssm_prefill(p: Params, cfg, x: torch.Tensor, cache: Params):
    """x: [B,S,D]; ``cache`` holds the state entering the sequence (zeros
    for a cold prefill, a downloaded state for a resume) and is updated
    IN PLACE. Returns ``(y [B,S,D], cache)``."""
    Bsz, S, _ = x.shape
    z, xBC, dt = _split_proj(cfg, x @ p["in_proj"])
    xBC, conv_state = _causal_conv(xBC, p["conv_w"], p["conv_b"],
                                   cache["conv"])
    xh, B_, C_ = _split_xbc(cfg, xBC)
    dtf = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, h = ssd_scan(xh, dtf, A, B_, C_, cache["ssd"], chunk=cfg.ssm.chunk)
    y = y + p["D"][:, None] * xh.float()
    y = y.reshape(Bsz, S, cfg.ssm_d_inner).to(x.dtype)
    cache["conv"].copy_(conv_state)
    cache["ssd"].copy_(h)
    return _gate_out(p, y, z), cache


def ssm_decode(p: Params, cfg, x1: torch.Tensor, cache: Params):
    """One-token recurrent step. x1: [B,1,D]; ``cache`` is updated IN
    PLACE. Returns ``(y [B,1,D], cache)``."""
    H, Pd = cfg.ssm_n_heads, cfg.ssm.head_dim
    rep = H // cfg.ssm.n_groups
    z, xBC, dt = _split_proj(cfg, x1 @ p["in_proj"])
    full = torch.cat([cache["conv"].to(xBC.dtype), xBC], dim=1)  # [B,K,C]
    xBC = F.silu((full * p["conv_w"]).sum(dim=1, keepdim=True)
                 + p["conv_b"])
    cache["conv"].copy_(full[:, 1:])
    xs, B_, C_ = _split_xbc(cfg, xBC)
    xh = xs[:, 0].float()                                      # [B,H,P]
    Bh = B_[:, 0].float().repeat_interleave(rep, dim=1)        # [B,H,N]
    Ch = C_[:, 0].float().repeat_interleave(rep, dim=1)
    dtf = F.softplus(dt[:, 0].float() + p["dt_bias"])          # [B,H]
    A = -torch.exp(p["A_log"])
    h = cache["ssd"]
    h.mul_(torch.exp(dtf * A)[..., None, None]).add_(
        (dtf[..., None] * xh)[..., None] * Bh[:, :, None, :])
    y = (h @ Ch[..., None])[..., 0] + p["D"][:, None] * xh     # [B,H,P]
    y = y.reshape(-1, 1, cfg.ssm_d_inner).to(x1.dtype)
    return _gate_out(p, y, z), cache
