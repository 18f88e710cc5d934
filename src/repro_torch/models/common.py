"""Shared building blocks: norms, activations, RoPE, inits.

Counterpart of ``repro.models.common``. Traps the port keeps:

* rmsnorm scales by ``1 + scale`` (the stored scale starts at zero);
* ``jax.nn.gelu`` is the tanh approximation;
* RoPE rotates the two halves of the head, not interleaved pairs;
* :func:`safe_softmax` sends a fully masked row to zeros, not NaN.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def dense_init(shape, dtype, gen: Optional[torch.Generator],
               scale: Optional[float] = None, device=None) -> torch.Tensor:
    """Truncated normal in [-2, 2] times 1/sqrt(fan_in) (fan_in is the
    first axis), as the reference initialises its dense weights. With no
    generator the tensor is allocated and left unset, for a caller that
    loads a state dict into it next."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(device=device, dtype=dtype)


def embed_init(shape, dtype, gen: Optional[torch.Generator], device=None):
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, dtype=torch.float32) * 0.02
    return w.to(device=device, dtype=dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale.float() + bias.float()).to(dt)


def apply_norm(p, x: torch.Tensor):
    """``p`` holds ``scale`` (rmsnorm) or ``scale`` and ``bias``
    (layernorm)."""
    if "bias" in p:
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    if kind == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {kind}")


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [B, S, H, dh]; positions: [B, S] (int)."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    ang = positions[..., None].float() * freqs          # [B, S, half]
    cos = torch.cos(ang)[..., None, :]                  # [B, S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def safe_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis in fp32; a fully masked row gives 0."""
    scores = torch.where(mask, scores.float(),
                         torch.tensor(float("-inf"), device=scores.device))
    m = torch.amax(scores, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(scores - m)
    return e / (torch.sum(e, dim=-1, keepdim=True) + 1e-30)
