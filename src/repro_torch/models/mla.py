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
  ``1/sqrt(qk_nope + qk_rope)``, the width before absorption. ``pos`` is
  one int for the batch or a ``[B]`` int32 tensor, one position a row.

Both write the new latents into the cache tensors IN PLACE.

A windowed config keeps the reference's cache: ``min(max_len, window)``
latent rows (``models/transformer.py``), with the window applied by
mask. A prefill writes linearly at ``start_pos`` and must fit the cache
(``start_pos + S <= size``; the reference's ``dynamic_update_slice``
would clamp the write onto earlier positions, or fail). A decode writes
slot ``pos % size``; where ``size == window`` the cache is a ring, read
unordered with ``kv_len = min(pos + 1, size)`` and no mask (every slot
holds one of the last ``window`` positions), else it is linear and read
with ``kv_len = pos + 1`` under the window. A decode past a linear
cache is refused: there the reference overwrites slot ``pos % size``
but still reads slot ``s`` as position ``s``, so from ``pos >= window``
on its window drops keys the cache holds within it (ROADMAP Queue 3;
``tests/test_torch_mla_window.py``).

* :func:`mla_forward` is the training path: per-head K/V materialised
  from the S tokens' latents into ``flash_prefill`` at (qk_nope + qk_rope,
  v_dim) = (192, 128), ``q_offset = 0``, as :func:`mla_prefill` runs it
  with no cache.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.mla_decode import mla_decode as mla_decode_kernel
from repro_torch.models.attention import (Pos, decode_positions, out_proj,
                                          write_rows)
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
    """One layer's latent cache of ``max_len`` rows (a windowed model's
    caller passes ``min(max_len, window)``, as the reference's does)."""
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


def _keys_values(p: Params, cfg, ckv, krope):
    """Per-head keys ``[k_nope; krope]`` and values of latents ``ckv`` [B,
    S, kv_lora] and rotary keys ``krope`` [B, S, qk_rope]."""
    k_nope = _per_head(ckv, p["wk_b"])
    k = torch.cat([k_nope, krope[:, :, None, :].expand(
        *k_nope.shape[:3], cfg.mla.qk_rope_dim)], dim=-1)
    return k, _per_head(ckv, p["wv_b"])


def mla_forward(p: Params, cfg, x, positions, *,
                window: Optional[int] = None) -> torch.Tensor:
    """Training / no-cache forward of ``x`` [B, S, D] at positions
    ``0..S-1`` (the reference's ``mla_forward``). Returns y [B, S, D]."""
    q_nope, q_rope = _queries(p, cfg, x, positions)
    k, v = _keys_values(p, cfg, *_latents(p, cfg, x, positions))
    o = flash_prefill(torch.cat([q_nope, q_rope], dim=-1), k, v, q_offset=0,
                      kv_len=x.shape[1], window=window or cfg.window)
    return out_proj(p, cfg, o)


def mla_prefill(p: Params, cfg, x, positions, cache, start_pos: int, *,
                window: Optional[int] = None):
    """Prefill ``S`` tokens at ``start_pos`` into ``cache`` (which may hold
    a downloaded prefix) and attend over both. Returns ``(y, cache)``;
    ``cache`` is updated in place."""
    S = x.shape[1]
    q_nope, q_rope = _queries(p, cfg, x, positions)
    ckv_new, krope_new = _latents(p, cfg, x, positions)
    _write(cache, ckv_new, krope_new, start_pos)
    kv_end = start_pos + S
    k, v = _keys_values(p, cfg, cache["ckv"][:, :kv_end],
                        cache["krope"][:, :kv_end])
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = flash_prefill(q, k, v, q_offset=start_pos, kv_len=kv_end,
                      window=window or cfg.window)
    return out_proj(p, cfg, o), cache


def mla_decode(p: Params, cfg, x1, pos: Pos, cache, *,
               window: Optional[int] = None, kv_max: Optional[int] = None):
    """Absorbed one-token decode: x1 [B, 1, D] at position ``pos`` (an
    int, or an int32 ``[B]`` tensor with ``kv_max`` a host bound of
    ``pos + 1``). Returns ``(y, cache)``; ``cache`` is updated in place."""
    m = cfg.mla
    positions = decode_positions(cfg, pos, x1.shape[0], x1.device)
    q_nope, q_rope = _queries(p, cfg, x1, positions)
    ckv1, krope1 = _latents(p, cfg, x1, positions)
    w = window or cfg.window
    size = cache["ckv"].shape[1]
    kv_len = pos + 1
    if w and size == w:                # a ring: every slot in the window
        pos = pos % size
        kv_len = kv_len.clamp(max=size) if torch.is_tensor(kv_len) \
            else min(kv_len, size)
        kv_max = size if kv_max is None else min(kv_max, size)
        w = None
    elif not torch.is_tensor(pos) and pos >= size:
        raise ValueError(
            f"decode at position {pos} past a linear MLA cache of {size} "
            "positions (the reference overwrites slot pos % size and reads "
            "it as position slot)")
    write_rows(cache["ckv"], ckv1[:, 0], pos)
    write_rows(cache["krope"], krope1[:, 0], pos)
    # q_lat[b, h] = q_nope[b, h] @ wk_b[:, h]^T, as one batched matmul
    q_lat = torch.matmul(q_nope[:, 0].transpose(0, 1),
                         p["wk_b"].permute(1, 2, 0)).transpose(0, 1)
    o_lat = mla_decode_kernel(
        q_lat.contiguous(), q_rope[:, 0], cache["ckv"], cache["krope"],
        kv_len=kv_len, window=w, kv_max=kv_max,
        scale=1.0 / (m.qk_nope_dim + m.qk_rope_dim) ** 0.5)
    o = torch.matmul(o_lat.transpose(0, 1), p["wv_b"].transpose(0, 1))
    return out_proj(p, cfg, o.transpose(0, 1)[:, None]), cache
