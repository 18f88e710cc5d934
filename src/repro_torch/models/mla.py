"""Multi-head Latent Attention (DeepSeek-V2/V3) over a linear latent cache.

Counterpart of ``repro.models.mla`` for serving. The cache holds only the
compressed latent ``ckv`` ([B, S, kv_lora]) and the shared rotary key
``krope`` ([B, S, qk_rope]): 576 values per token for deepseek-v3, the
state the prompt cache ships.

* :func:`mla_prefill` writes the new latents at ``start_pos`` and
  materialises per-head keys ``[k_nope; krope]`` (qk_nope + qk_rope wide)
  and values (v_dim wide) from the latents of positions
  ``< start_pos + S``, then runs ``flash_prefill`` with
  ``q_offset=start_pos``. The reference materialises the whole cache and
  masks the positions past ``start_pos + S``; they are never read here.
* :func:`mla_decode` is the absorbed form: ``q_lat = q_nope · wk_b``
  attends in latent space to the layer's ``ckv``/``krope`` slices, read
  in place by the ``mla_decode`` kernel with ``kv_len = pos + 1``, and the
  latent output goes through ``wv_b`` and ``wo``. The scale is
  ``1/sqrt(qk_nope + qk_rope)``, the width before absorption.

Both write the new latents into the cache tensors IN PLACE. A windowed
MLA cache (a ring) is not in this port and raises.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.mla_decode import mla_decode as mla_decode_kernel
from repro_torch.models.attention import out_proj
from repro_torch.models.common import apply_rope, dense_init, rmsnorm

Params = Dict[str, torch.Tensor]


def init_mla(cfg, dtype, gen: Optional[torch.Generator],
             device=None) -> Params:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    return {
        "wq_a": dense_init((d, m.q_lora_rank), dtype, gen, device=device),
        "q_norm": torch.zeros((m.q_lora_rank,), dtype=dtype, device=device),
        "wq_b": dense_init((m.q_lora_rank, H, m.qk_nope_dim + m.qk_rope_dim),
                           dtype, gen, device=device),
        "wkv_a": dense_init((d, m.kv_lora_rank + m.qk_rope_dim), dtype, gen,
                            device=device),
        "kv_norm": torch.zeros((m.kv_lora_rank,), dtype=dtype, device=device),
        "wk_b": dense_init((m.kv_lora_rank, H, m.qk_nope_dim), dtype, gen,
                           device=device),
        "wv_b": dense_init((m.kv_lora_rank, H, m.v_dim), dtype, gen,
                           device=device),
        "wo": dense_init((H, m.v_dim, d), dtype, gen, device=device),
    }


def init_mla_cache(cfg, batch: int, max_len: int, dtype, device=None):
    """One layer's latent cache. A windowed config would keep a ring of
    ``window`` slots, which this port does not run."""
    if cfg.window:
        raise NotImplementedError(
            "windowed (ring) MLA caches are not in this port yet (ROADMAP "
            "Queue 1: ring caches and windowed configs)")
    m = cfg.mla
    return {"ckv": torch.zeros((batch, max_len, m.kv_lora_rank),
                               dtype=dtype, device=device),
            "krope": torch.zeros((batch, max_len, m.qk_rope_dim),
                                 dtype=dtype, device=device)}


def _queries(p: Params, cfg, x, positions):
    """x: [B, S, D] -> (q_nope [B,S,H,qk_nope], q_rope [B,S,H,qk_rope])."""
    m = cfg.mla
    qa = rmsnorm(x @ p["wq_a"], p["q_norm"])
    r, H, k = p["wq_b"].shape
    q = (qa @ p["wq_b"].reshape(r, H * k)).reshape(*x.shape[:-1], H, k)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _latents(p: Params, cfg, x, positions):
    """x: [B, S, D] -> (ckv [B,S,kv_lora], krope [B,S,qk_rope])."""
    m = cfg.mla
    kv = x @ p["wkv_a"]
    ckv = rmsnorm(kv[..., :m.kv_lora_rank], p["kv_norm"])
    krope = apply_rope(kv[..., None, m.kv_lora_rank:], positions,
                       cfg.rope_theta)[..., 0, :]
    return ckv, krope


def _per_head(lat: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsr,rhk->bshk') as one matmul."""
    r, H, k = w.shape
    return (lat @ w.reshape(r, H * k)).reshape(*lat.shape[:-1], H, k)


def _write(cache, ckv, krope, start: int) -> None:
    size, S = cache["ckv"].shape[1], ckv.shape[1]
    if start < 0 or start + S > size:
        raise ValueError(f"{S} latents at position {start} overflow a cache "
                         f"of {size} positions")
    cache["ckv"][:, start:start + S] = ckv
    cache["krope"][:, start:start + S] = krope


def mla_prefill(p: Params, cfg, x, positions, cache, start_pos: int, *,
                window: Optional[int] = None):
    """Prefill ``S`` tokens at ``start_pos`` into ``cache`` (which may hold
    a downloaded prefix) and attend over both. Returns ``(y, cache)``;
    ``cache`` is updated in place."""
    m = cfg.mla
    S = x.shape[1]
    q_nope, q_rope = _queries(p, cfg, x, positions)
    ckv_new, krope_new = _latents(p, cfg, x, positions)
    _write(cache, ckv_new, krope_new, start_pos)
    kv_end = start_pos + S
    ckv = cache["ckv"][:, :kv_end]
    k_nope = _per_head(ckv, p["wk_b"])
    krope = cache["krope"][:, :kv_end, None, :]
    k = torch.cat([k_nope, krope.expand(*k_nope.shape[:3], m.qk_rope_dim)],
                  dim=-1)
    v = _per_head(ckv, p["wv_b"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = flash_prefill(q, k, v, q_offset=start_pos, kv_len=kv_end,
                      window=window or cfg.window)
    return out_proj(p, cfg, o), cache


def mla_decode(p: Params, cfg, x1, pos: int, cache, *,
               window: Optional[int] = None):
    """Absorbed one-token decode: x1 [B, 1, D] at position ``pos``.
    Returns ``(y, cache)``; ``cache`` is updated in place."""
    m = cfg.mla
    positions = torch.full((x1.shape[0], 1), pos, dtype=torch.long,
                           device=x1.device)
    q_nope, q_rope = _queries(p, cfg, x1, positions)
    ckv1, krope1 = _latents(p, cfg, x1, positions)
    _write(cache, ckv1, krope1, pos)
    # q_lat[b, h] = q_nope[b, h] @ wk_b[:, h]^T, as one batched matmul
    q_lat = torch.matmul(q_nope[:, 0].transpose(0, 1),
                         p["wk_b"].permute(1, 2, 0)).transpose(0, 1)
    o_lat = mla_decode_kernel(
        q_lat.contiguous(), q_rope[:, 0], cache["ckv"], cache["krope"],
        kv_len=pos + 1, window=window or cfg.window,
        scale=1.0 / (m.qk_nope_dim + m.qk_rope_dim) ** 0.5)
    o = torch.matmul(o_lat.transpose(0, 1), p["wv_b"].transpose(0, 1))
    return out_proj(p, cfg, o.transpose(0, 1)[:, None]), cache
