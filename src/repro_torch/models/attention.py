"""GQA attention with prefix-resume prefill over a linear KV cache.

Counterpart of ``repro.models.attention``. The ``cache`` of
:func:`attn_prefill` may already hold a prefix downloaded from the cache
server (``start_pos`` > 0); only the suffix queries run, through the
``flash_prefill`` kernel with ``q_offset=start_pos``. Decode runs
through ``flash_decode`` with ``kv_len=pos+1``, the mask the reference's
``ring_positions(size, pos+1)`` gives a linear cache.

Unlike the reference, these functions write the new K/V entries into
the cache tensors IN PLACE and the kernels read that layer's cache slice
where it lies. Ring (sliding-window) caches are not in this port yet and
raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.models.common import apply_rope, dense_init, rmsnorm

Params = Dict[str, torch.Tensor]


def init_attention(cfg, dtype, gen: torch.Generator, device=None) -> Params:
    d, h, k, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    p = {
        "wq": dense_init((d, h, dh), dtype, gen, device=device),
        "wk": dense_init((d, k, dh), dtype, gen, device=device),
        "wv": dense_init((d, k, dh), dtype, gen, device=device),
        "wo": dense_init((h, dh, d), dtype, gen, scale=1.0 / (h * dh) ** 0.5,
                         device=device),
    }
    if cfg.attn_bias:
        for name, shape in (("bq", (h, dh)), ("bk", (k, dh)),
                            ("bv", (k, dh)), ("bo", (d,))):
            p[name] = torch.zeros(shape, dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((dh,), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((dh,), dtype=dtype, device=device)
    return p


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def project_qkv(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor):
    """x: [B, S, D]; positions: [B, S] int."""
    q, k, v = _heads(x, p["wq"]), _heads(x, p["wk"]), _heads(x, p["wv"])
    if cfg.attn_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q, k = rmsnorm(q, p["q_norm"]), rmsnorm(k, p["k_norm"])
    if cfg.rope == "standard":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope != "none":
        raise NotImplementedError(f"rope {cfg.rope!r} is not in this port")
    return q, k, v


def out_proj(p: Params, cfg, o: torch.Tensor) -> torch.Tensor:
    h, k, d = p["wo"].shape
    y = o.reshape(*o.shape[:-2], h * k) @ p["wo"].reshape(h * k, d)
    if cfg.attn_bias:
        y = y + p["bo"]
    return y


def init_kv_cache(cfg, batch: int, max_len: int, dtype, device=None):
    """One layer's cache; a windowed model keeps ``min(max_len, window)``
    slots, as the reference does."""
    size = min(max_len, cfg.window) if cfg.window else max_len
    shape = (batch, size, cfg.n_kv_heads, cfg.dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _linear_cache(cache, window) -> int:
    size = cache["k"].shape[1]
    if window and size == window:
        raise NotImplementedError(
            "ring (sliding-window) KV caches are not in this port yet "
            "(ROADMAP Queue 1: ring caches and windowed configs)")
    return size


def cache_write_prefill(cache, k_new, v_new, start_pos: int, window) -> None:
    """Write S new entries at ``start_pos`` IN PLACE (linear cache)."""
    size = _linear_cache(cache, window)
    S = k_new.shape[1]
    if start_pos < 0 or start_pos + S > size:
        raise ValueError(f"prefill of {S} tokens at {start_pos} overflows "
                         f"a cache of {size} positions")
    cache["k"][:, start_pos:start_pos + S] = k_new
    cache["v"][:, start_pos:start_pos + S] = v_new


def cache_write_decode(cache, k1, v1, pos: int, window) -> None:
    """Write one entry at ``pos`` IN PLACE (linear cache)."""
    size = _linear_cache(cache, window)
    if not 0 <= pos < size:
        raise ValueError(f"decode at position {pos} overflows a cache of "
                         f"{size} positions")
    cache["k"][:, pos] = k1[:, 0]
    cache["v"][:, pos] = v1[:, 0]


def attn_prefill(p: Params, cfg, x, positions, cache, start_pos: int, *,
                 window: Optional[int] = None):
    """Prefill ``S`` tokens at ``start_pos`` into ``cache`` (which may hold
    a downloaded prefix of ``start_pos`` tokens) and attend over both.
    Returns ``(y, cache)``; ``cache`` is updated in place."""
    q, k_new, v_new = project_qkv(p, cfg, x, positions)
    S = x.shape[1]
    w = window or cfg.window
    cache_write_prefill(cache, k_new, v_new, start_pos, w)
    o = flash_prefill(q, cache["k"], cache["v"], q_offset=start_pos,
                      kv_len=start_pos + S, window=w)
    return out_proj(p, cfg, o), cache


def attn_decode(p: Params, cfg, x1, pos: int, cache, *,
                window: Optional[int] = None):
    """One-token decode: x1 [B, 1, D] at position ``pos``. Returns
    ``(y, cache)``; ``cache`` is updated in place."""
    positions = torch.full((x1.shape[0], 1), pos, dtype=torch.long,
                           device=x1.device)
    q, k1, v1 = project_qkv(p, cfg, x1, positions)
    w = window or cfg.window
    cache_write_decode(cache, k1, v1, pos, w)
    o = flash_decode(q[:, 0], cache["k"], cache["v"], kv_len=pos + 1,
                     window=w)
    return out_proj(p, cfg, o[:, None]), cache
