"""Shared building blocks: norms, activations, RoPE and M-RoPE,
sinusoidal positions, inits, and :func:`tree_map` over the nested dicts
of parameters and caches.

Counterpart of ``repro.models.common``. Traps the port keeps:

* rmsnorm scales by ``1 + scale`` (the stored scale starts at zero);
* ``jax.nn.gelu`` is the tanh approximation;
* RoPE rotates the two halves of the head, not interleaved pairs;
* :func:`safe_softmax` sends a fully masked row to zeros, not NaN.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts and lists (``rest``: trees
    of the same structure, their leaves passed beside)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def dense_init(shape, dtype, gen: Optional[torch.Generator],
               scale: Optional[float] = None, device=None) -> torch.Tensor:
    """Truncated normal in [-2, 2] times 1/sqrt(fan_in) (fan_in is the
    first axis), as the reference initialises its dense weights, drawn on
    the generator's device. With no generator the tensor is allocated and
    left unset, for a caller that loads a state dict into it next."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(device=device, dtype=dtype)


def embed_init(shape, dtype, gen: Optional[torch.Generator], device=None):
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device) * 0.02
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


@lru_cache(maxsize=None)
def mrope_band(sections: Tuple[int, ...], device) -> torch.Tensor:
    """The position component each frequency band reads, ``[half]`` int
    on ``device``: section i's bands read component i. Built once per
    (sections, device) and reused by every call."""
    return torch.repeat_interleave(
        torch.arange(len(sections)), torch.tensor(sections)).to(device)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, ...]):
    """Multimodal RoPE (qwen2-vl). x: [B, S, H, dh]; positions3: [3, B, S]
    (int), the (temporal, height, width) components; ``sections`` sum to
    dh // 2 and give each component its run of frequency bands. With the
    three components equal (text) this is :func:`apply_rope`."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} do not sum to {half}")
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    band = mrope_band(tuple(sections), x.device)
    pos = positions3.index_select(0, band).movedim(0, -1)   # [B, S, half]
    ang = pos.float() * freqs
    cos = torch.cos(ang)[..., None, :]                  # [B, S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int, offset: int = 0,
                         device=None) -> torch.Tensor:
    """``[n, d]`` fp32 table of positions ``offset .. offset + n - 1``:
    sin at the even columns, cos at the odd ones, as the reference builds
    it."""
    pos = (torch.arange(n, dtype=torch.float32, device=device)
           + offset)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((n, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def add_sinusoidal(x: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """``x [B, S, d]`` plus the table of positions ``offset ..``, cast to
    ``x``'s dtype and added in it: ``offset`` is a prefill's start
    position, or a decode step's token position."""
    return x + sinusoidal_positions(x.shape[1], x.shape[-1], offset,
                                    x.device).to(x.dtype)


def safe_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis in fp32; a fully masked row gives 0."""
    scores = torch.where(mask, scores.float(),
                         torch.tensor(float("-inf"), device=scores.device))
    m = torch.amax(scores, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(scores - m)
    return e / (torch.sum(e, dim=-1, keepdim=True) + 1e-30)
