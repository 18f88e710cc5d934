"""GQA attention with prefix-resume prefill over a linear or ring KV cache.

Counterpart of ``repro.models.attention``. The ``cache`` of
:func:`attn_prefill` may already hold a prefix downloaded from the cache
server (``start_pos`` > 0); only the suffix queries run, through the
``flash_prefill`` kernel with ``q_offset=start_pos``. Decode runs
through ``flash_decode`` with ``kv_len=pos+1``, the mask the reference's
``ring_positions(size, pos+1)`` gives a linear cache. ``pos`` is one int
for the batch, or a ``[B]`` int tensor on the device, one position a row
(the batched engine's slots): rope, the cache write and ``kv_len`` then
follow each row's position, in one launch each. Under M-RoPE (qwen2-vl)
positions are ``[3, B, S]``; a decode step's three components are equal,
as in the reference.

A windowed model whose cache has exactly ``window`` slots keeps a ring,
as in the reference: position ``p`` lives in slot ``p % window``. Neither
kernel reads ring positions; the ring is fed to them so that it needs
none:

* prefill linearises it. The ring holds positions ``[kbase, start)``,
  ``kbase = max(0, start - window)``; those slots, gathered in position
  order, and the S new keys after them make one contiguous buffer that
  ``flash_prefill`` reads with ``q_offset = start - kbase`` and the
  window (relative positions are what the mask compares). The last
  ``min(S, window)`` new entries are then written into their slots.
* decode reads it unordered. Once the entry at ``pos`` is written, the
  ring holds exactly positions ``[max(0, pos - window + 1), pos]``, all
  inside the window, and softmax does not depend on the keys' order: so
  ``flash_decode`` runs with ``kv_len = min(pos + 1, window)`` and no
  window.

Unlike the reference, these functions write the new K/V entries into
the cache tensors IN PLACE and the kernels read that layer's cache slice
where it lies (a ring prefill reads the gathered buffer).

:func:`attn_forward` is the training path: no cache, the S tokens at
positions ``0..S-1`` attending causally (and within the window) on
``flash_prefill`` at ``q_offset = 0``, whose gradient runs on its
backward kernel on the card. As in the reference, the training mask
follows batch row 0's temporal positions, not the index: where they
repeat (a VLM batch's image patches), the model passes the kernel the
key limit :func:`training_key_limit` gives. Serving prefills mask by
index, in both packages.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.models.common import (apply_mrope, apply_rope, dense_init,
                                       rmsnorm)

Params = Dict[str, torch.Tensor]
Pos = Union[int, torch.Tensor]     # one position, or one a row ([B])


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
    """x: [B, S, D]; positions: [B, S] int (standard rope) or [3, B, S]
    (M-RoPE)."""
    q, k, v = _heads(x, p["wq"]), _heads(x, p["wk"]), _heads(x, p["wv"])
    if cfg.attn_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q, k = rmsnorm(q, p["q_norm"]), rmsnorm(k, p["k_norm"])
    if cfg.rope == "standard":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope == "mrope":
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
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


def ring_size(cache, window) -> Optional[int]:
    """The slot count of a ring cache, or None for a linear one: a cache
    is a ring exactly when it has ``window`` slots, as in the
    reference."""
    size = cache["k"].shape[1]
    return size if window and size == window else None


def cache_write_prefill(cache, k_new, v_new, start_pos: int, window) -> None:
    """Write S new entries at ``start_pos`` IN PLACE: at their positions
    in a linear cache, the last ``min(S, size)`` of them at their slots
    ``p % size`` in a ring."""
    size = cache["k"].shape[1]
    S = k_new.shape[1]
    if ring_size(cache, window):
        m = min(S, size)
        s0 = (start_pos + S - m) % size
        first = min(m, size - s0)          # slots up to the ring's end
        for name, new in (("k", k_new), ("v", v_new)):
            tail = new[:, S - m:]
            cache[name][:, s0:s0 + first] = tail[:, :first]
            cache[name][:, :m - first] = tail[:, first:]
        return
    if start_pos < 0 or start_pos + S > size:
        raise ValueError(f"prefill of {S} tokens at {start_pos} overflows "
                         f"a cache of {size} positions")
    cache["k"][:, start_pos:start_pos + S] = k_new
    cache["v"][:, start_pos:start_pos + S] = v_new


def ring_gather(leaf: torch.Tensor, new: torch.Tensor,
                start_pos: int) -> torch.Tensor:
    """The ring ``leaf`` ``[B, size, ...]`` about to take position
    ``start_pos``, linearised: its slots in position order (positions
    ``[max(0, start_pos - size), start_pos)``) with ``new`` after them,
    one contiguous ``[B, n_old + S, ...]`` copy."""
    size = leaf.shape[1]
    if start_pos <= size:                  # not wrapped: slot p holds p
        parts = [leaf[:, :start_pos]] if start_pos else []
    else:
        a = start_pos % size               # the oldest position's slot
        parts = [leaf[:, a:], leaf[:, :a]]
    return torch.cat(parts + [new], dim=1) if parts else new


def decode_positions(cfg, pos: Pos, B: int, device) -> torch.Tensor:
    """[B, 1] positions of a one-token step (``[3, B, 1]`` under M-RoPE,
    the three components equal): ``pos`` for every row, or row b's
    ``pos[b]``. A position tensor stays on the device (a view, no copy)."""
    shape = (3, B, 1) if cfg.rope == "mrope" else (B, 1)
    if torch.is_tensor(pos):
        return pos[:, None].expand(shape)
    return torch.full(shape, pos, dtype=torch.long, device=device)


def write_rows(leaf: torch.Tensor, new: torch.Tensor, pos: Pos) -> None:
    """``leaf[b, pos] = new[b]`` IN PLACE for a ``[B, S, ...]`` leaf: at
    one position, or at row b's ``pos[b]`` in one indexed store. A
    position tensor is not checked against ``S`` on the host (that would
    wait for the device); its caller keeps it in range."""
    if torch.is_tensor(pos):
        rows = torch.arange(leaf.shape[0], device=leaf.device)
        leaf.index_put_((rows, pos), new)
        return
    if not 0 <= pos < leaf.shape[1]:
        raise ValueError(f"decode at position {pos} overflows a cache of "
                         f"{leaf.shape[1]} positions")
    leaf[:, pos] = new


def cache_write_decode(cache, k1, v1, pos: Pos, window) -> None:
    """Write one entry a row at ``pos`` IN PLACE: at ``pos`` in a linear
    cache, at slot ``pos % size`` in a ring (a tensor's on the device)."""
    size = ring_size(cache, window)
    slot = pos % size if size else pos
    write_rows(cache["k"], k1[:, 0], slot)
    write_rows(cache["v"], v1[:, 0], slot)


def training_key_limit(pos) -> Optional[np.ndarray]:
    """The reference's training mask as a key limit. Its ``attn_forward``
    takes batch row 0's positions (the temporal row under M-RoPE) as both
    ``qpos`` and ``kpos``, and ``attend`` keeps the key at ``j`` for the
    query at ``i`` when ``0 <= pos[j] <= pos[i]``: image patches at one
    temporal index see each other, and every row of the batch is masked
    by row 0's positions. For non-decreasing, non-negative ``pos`` (host
    ints ``[S]``: Qwen2-VL's layout, text, an image at one index, text
    after it) that is ``j < lim[i]``, ``lim[i]`` the count of positions at
    most ``pos[i]``. Returns ``lim`` (int32 ``[S]``), or None where it is
    ``arange(S) + 1`` (strictly increasing positions: the causal rule).
    Raises ValueError for positions that decrease or are negative: the
    reference's mask is then no key limit."""
    pos = np.asarray(pos, dtype=np.int64)
    if pos.size and (pos.min() < 0 or np.any(np.diff(pos) < 0)):
        raise ValueError(
            "training attention masks by batch row 0's temporal positions "
            "(the reference's rule: the key at j is live for the query at i "
            "when 0 <= pos[j] <= pos[i]); the port takes them non-negative "
            "and non-decreasing, as Qwen2-VL lays out text and images")
    lim = np.searchsorted(pos, pos, side="right").astype(np.int32)
    return None if np.array_equal(lim, np.arange(1, pos.size + 1)) else lim


def attn_forward(p: Params, cfg, x, positions, *,
                 window: Optional[int] = None,
                 key_limit: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training / no-cache forward of ``x`` [B, S, D] (the reference's
    ``attn_forward``, which masks every row by batch row 0's positions:
    a text batch's, or one with meta tokens before it, are ``0..S-1``, the
    causal rule). ``key_limit`` (int32 ``[S]`` on the device, from
    :func:`training_key_limit`) carries that mask where the positions
    repeat; None for the causal rule. Returns y [B, S, D]."""
    q, k, v = project_qkv(p, cfg, x, positions)
    o = flash_prefill(q, k, v, q_offset=0, kv_len=x.shape[1],
                      window=window or cfg.window, key_limit=key_limit)
    return out_proj(p, cfg, o)


def attn_prefill(p: Params, cfg, x, positions, cache, start_pos: int, *,
                 window: Optional[int] = None):
    """Prefill ``S`` tokens at ``start_pos`` into ``cache`` (which may hold
    a downloaded prefix of ``start_pos`` tokens) and attend over both.
    Returns ``(y, cache)``; ``cache`` is updated in place."""
    q, k_new, v_new = project_qkv(p, cfg, x, positions)
    S = x.shape[1]
    w = window or cfg.window
    size = ring_size(cache, w)
    if size:                # linearise: old ring + new keys, then write
        n_old = start_pos - max(0, start_pos - size)
        k_att = ring_gather(cache["k"], k_new, start_pos)
        v_att = ring_gather(cache["v"], v_new, start_pos)
        o = flash_prefill(q, k_att, v_att, q_offset=n_old, kv_len=n_old + S,
                          window=w)
        cache_write_prefill(cache, k_new, v_new, start_pos, w)
    else:
        cache_write_prefill(cache, k_new, v_new, start_pos, w)
        o = flash_prefill(q, cache["k"], cache["v"], q_offset=start_pos,
                          kv_len=start_pos + S, window=w)
    return out_proj(p, cfg, o), cache


def attn_decode(p: Params, cfg, x1, pos: Pos, cache, *,
                window: Optional[int] = None,
                kv_max: Optional[int] = None):
    """One-token decode: x1 [B, 1, D] at position ``pos`` (an int, or an
    int32 ``[B]`` tensor with ``kv_max`` a host bound of ``pos + 1``).
    A ring is read unordered: ``kv_len = min(pos + 1, size)``, no window
    (see the module docstring). Returns ``(y, cache)``; ``cache`` is
    updated in place."""
    positions = decode_positions(cfg, pos, x1.shape[0], x1.device)
    q, k1, v1 = project_qkv(p, cfg, x1, positions)
    w = window or cfg.window
    cache_write_decode(cache, k1, v1, pos, w)
    kv_len = pos + 1
    size = ring_size(cache, w)
    if size:
        kv_len = kv_len.clamp(max=size) if torch.is_tensor(pos) \
            else min(kv_len, size)
        kv_max = size if kv_max is None else min(kv_max, size)
        w = None
    o = flash_decode(q[:, 0], cache["k"], cache["v"], kv_len=kv_len,
                     window=w, kv_max=kv_max)
    return out_proj(p, cfg, o[:, None]), cache
