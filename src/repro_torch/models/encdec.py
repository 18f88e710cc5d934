"""Whisper-style encoder-decoder blocks.

Counterpart of ``repro.models.encdec``. The audio frontend (mel and
conv) is the reference's stub: callers give frame embeddings ``[B,
n_frames, d]``. Encoder and decoder take sinusoidal positions
(:func:`repro_torch.models.common.add_sinusoidal`), no rope.

All three attentions run on the port's kernels:

* the encoder's bidirectional self-attention and a prefill's
  cross-attention on ``flash_prefill``, through :func:`attend_all`;
* the decoder's causal self-attention through ``attn_prefill`` /
  ``attn_decode``, as a dense layer runs it;
* a decode step's cross-attention on ``flash_decode`` with ``kv_len =
  n_frames``.

A decoder layer's cache is ``{"self": {"k", "v"}, "cross_k", "cross_v"}``
(``[B, T, KV, dh]`` and ``[B, n_frames, KV, dh]``). The cross K/V are
computed once, in the prefill that runs the encoder, and stored there:
they are part of the prompt-cache blob of this architecture, and a
resume reads them from the cache. Unlike the reference, the layers write
the cache IN PLACE and the kernels read it where it lies.

Training runs :func:`enc_layer` as it is and :func:`dec_layer_forward`
(no cache): the decoder's causal self-attention through
``attn_forward``, the cross-attention over the encoder's output through
:func:`attend_all`; both on ``flash_prefill`` and its backward kernel.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.models import attention as attn
from repro_torch.models.common import apply_norm
from repro_torch.models.mlp import init_mlp, mlp_forward
from repro_torch.models.transformer import init_norm


def attend_all(q, k, v) -> torch.Tensor:
    """Every query over every key of ``k`` / ``v`` (``[B, Sk, KV, dh]``),
    no causal mask, on the causal ``flash_prefill`` kernel. This is exact:
    the kernel takes the key at ``kpos`` as live for query ``i`` when
    ``kpos <= q_offset + i`` and ``kpos < kv_len``. With ``q_offset =
    kv_len = Sk`` the first holds for every ``kpos < Sk``, so every key is
    live for every query: the reference's ``attend(..., causal=False)``."""
    Sk = k.shape[1]
    return flash_prefill(q, k, v, q_offset=Sk, kv_len=Sk)


def init_enc_layer(cfg, dtype, gen, device=None) -> Dict:
    return {"ln1": init_norm(cfg, dtype, device),
            "attn": attn.init_attention(cfg, dtype, gen, device=device),
            "ln2": init_norm(cfg, dtype, device),
            "mlp": init_mlp(cfg, dtype, gen, device=device)}


def init_dec_layer(cfg, dtype, gen, device=None) -> Dict:
    return {"ln1": init_norm(cfg, dtype, device),
            "self_attn": attn.init_attention(cfg, dtype, gen, device=device),
            "ln2": init_norm(cfg, dtype, device),
            "cross_attn": attn.init_attention(cfg, dtype, gen, device=device),
            "ln3": init_norm(cfg, dtype, device),
            "mlp": init_mlp(cfg, dtype, gen, device=device)}


def init_dec_cache(cfg, batch: int, max_len: int, dtype, device=None):
    shape = (batch, cfg.encdec.n_frames, cfg.n_kv_heads, cfg.dh)
    return {"self": attn.init_kv_cache(cfg, batch, max_len, dtype, device),
            "cross_k": torch.zeros(shape, dtype=dtype, device=device),
            "cross_v": torch.zeros(shape, dtype=dtype, device=device)}


def enc_layer(p, cfg, x):
    """One encoder layer: bidirectional self-attention over the frames
    (positions 0 for rope, as the reference passes them; whisper has
    none), then the MLP."""
    h = apply_norm(p["ln1"], x)
    pos = torch.zeros(x.shape[:2], dtype=torch.long, device=x.device)
    q, k, v = attn.project_qkv(p["attn"], cfg, h, pos)
    x = x + attn.out_proj(p["attn"], cfg, attend_all(q, k, v))
    return x + mlp_forward(p["mlp"], cfg, apply_norm(p["ln2"], x))


def _cross_kv(p, cfg, enc_out):
    """The cross-attention's K and V of the encoder's output, biases
    included."""
    k, v = attn._heads(enc_out, p["wk"]), attn._heads(enc_out, p["wv"])
    if cfg.attn_bias:
        k, v = k + p["bk"], v + p["bv"]
    return k, v


def _cross_q(p, cfg, x):
    q = attn._heads(x, p["wq"])
    return q + p["bq"] if cfg.attn_bias else q


def _cross(p, cfg, x, k, v):
    """x plus the cross-attention of its ``ln2`` over K/V ``k``, ``v``."""
    pc = p["cross_attn"]
    o = attend_all(_cross_q(pc, cfg, apply_norm(p["ln2"], x)), k, v)
    return x + attn.out_proj(pc, cfg, o)


def dec_layer_forward(p, cfg, x, positions, enc_out):
    """Training / no-cache forward of a decoder layer over ``x`` [B, S, d]
    at positions ``0..S-1`` against the encoder's output ``enc_out``."""
    h = apply_norm(p["ln1"], x)
    x = x + attn.attn_forward(p["self_attn"], cfg, h, positions)
    x = _cross(p, cfg, x, *_cross_kv(p["cross_attn"], cfg, enc_out))
    return x + mlp_forward(p["mlp"], cfg, apply_norm(p["ln3"], x))


def dec_layer_prefill(p, cfg, x, positions, cache, start_pos: int,
                      enc_out=None):
    """A decoder layer over ``S`` tokens at ``start_pos``. With
    ``enc_out`` the cross K/V are computed and stored in ``cache``; without
    it they are read from ``cache`` (a resume). Returns ``(x, cache)``;
    ``cache`` is updated in place."""
    h = apply_norm(p["ln1"], x)
    a, _ = attn.attn_prefill(p["self_attn"], cfg, h, positions,
                             cache["self"], start_pos)
    x = x + a
    if enc_out is not None:
        ck, cv = _cross_kv(p["cross_attn"], cfg, enc_out)
        cache["cross_k"].copy_(ck)
        cache["cross_v"].copy_(cv)
    x = _cross(p, cfg, x, cache["cross_k"], cache["cross_v"])
    h = apply_norm(p["ln3"], x)
    return x + mlp_forward(p["mlp"], cfg, h), cache


def dec_layer_decode(p, cfg, x1, pos: int, cache):
    """One token a row at ``pos``; the cross-attention reads every frame
    (``kv_len = n_frames``). Returns ``(x1, cache)``; ``cache`` is updated
    in place."""
    h = apply_norm(p["ln1"], x1)
    a, _ = attn.attn_decode(p["self_attn"], cfg, h, pos, cache["self"])
    x1 = x1 + a
    pc, ck = p["cross_attn"], cache["cross_k"]
    q = _cross_q(pc, cfg, apply_norm(p["ln2"], x1))
    o = flash_decode(q[:, 0], ck, cache["cross_v"], kv_len=ck.shape[1])
    x1 = x1 + attn.out_proj(pc, cfg, o[:, None])
    h = apply_norm(p["ln3"], x1)
    return x1 + mlp_forward(p["mlp"], cfg, h), cache
