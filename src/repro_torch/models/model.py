"""Model facade for decoder-only models (the dense and SSM families, and
deepseek-v3 cut to its dense MLA layers): prefill with prefix resume, and
one-token decode.

Counterpart of ``repro.models.model.Model`` (serving modes only). The
parameters live in this ``nn.Module`` under the reference's tree paths,
with ``.`` for ``/`` (``segments.0.attn.wq`` is the reference's
``segments/0/attn/wq``, same ``[L, d, H, dh]`` layout), so
:func:`repro_torch.params.from_jax_params` is a copy. The cache returned
by :meth:`init_cache` has the reference's structure, layout and per-leaf
dtypes, ``{"segments": [{"k": [L,B,S,KV,dh], "v": ...}]}`` for a dense
model, ``{"segments": [{"conv": [L,B,K-1,C], "ssd": [L,B,H,P,N] fp32}]}``
for an SSM and ``{"segments": [{"ckv": [L,B,S,R], "krope": [L,B,S,Dr]},
...]}`` for MLA (an empty MoE segment has ``L = 0``): it is the state the
paper ships between devices (``core/state_io.py``). :meth:`prefill` and :meth:`decode_step` update it
IN PLACE and return it.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.common import apply_norm, embed_init


def padded_vocab(vocab: int) -> int:
    """Vocab storage padded to a multiple of 256, as the reference pads
    it; the padded tail is masked in the head."""
    return -(-vocab // 256) * 256


def _pdict(tensors: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(t, requires_grad=False)
                             for k, t in tensors.items()})


class Model(nn.Module):
    """``seed`` draws the random weights; ``seed=None`` allocates them
    unset, for a caller that loads a state dict next."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None, seed: Optional[int] = 0):
        super().__init__()
        if cfg.family not in ("dense", "ssm", "moe") or cfg.n_meta_tokens:
            raise NotImplementedError(
                f"family {cfg.family!r} (meta tokens: {cfg.n_meta_tokens}) "
                "is not in this port yet (ROADMAP Queue 1, item 7)")
        if cfg.mtp:
            raise NotImplementedError(
                "the MTP head is a training head; serve the model with "
                "mtp=False (training: ROADMAP Queue 1, item 8)")
        self.cfg = cfg
        self.segment_specs = tf.segments_for(cfg)
        self.dtype = dtype
        self.device = resolve_device(device)
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        vp = padded_vocab(cfg.vocab)
        self.embed = nn.Parameter(
            embed_init((vp, cfg.d_model), dtype, gen, device=self.device),
            requires_grad=False)
        self.final_norm = _pdict(tf.init_norm(cfg, dtype, self.device))
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(
                embed_init((cfg.d_model, vp), dtype, gen, device=self.device),
                requires_grad=False)
        self.segments = nn.ModuleList([nn.ModuleDict(
            {group: _pdict(ps) for group, ps in tf.init_segment(
                cfg, spec, dtype, gen, device=self.device).items()})
            for spec in self.segment_specs])

    @property
    def has_recurrent_state(self) -> bool:
        """True when the cache is a state that every token advances (an
        SSM's conv window and SSD state) rather than per-position K/V: it
        cannot take padding or a re-run token, and it is not cut to a
        prefix when serialized."""
        return any(s.kind == "ssm" for s in self.segment_specs)

    # ------------------------------------------------------------------
    def cache_len(self, n_tokens: int) -> int:
        return n_tokens + self.cfg.n_meta_tokens

    def init_cache(self, batch: int, max_len: int, dtype=None):
        return {"segments": [tf.init_segment_cache(
            self.cfg, spec, batch, max_len, dtype or self.dtype, self.device)
            for spec in self.segment_specs]}

    def _segment_params(self, si: int):
        return {group: dict(ps.items())
                for group, ps in self.segments[si].items()}

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                               device=self.device)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = apply_norm(self.final_norm, x)
        if self.cfg.tie_embeddings:
            logits = x @ self.embed.t()
        else:
            logits = x @ self.head
        logits = logits.float()
        if logits.shape[-1] != self.cfg.vocab:    # mask padded vocab tail
            logits[..., self.cfg.vocab:] = -1e30
        return logits

    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, inputs, cache, start_pos: int = 0,
                last_index: Optional[int] = None, *, resume: bool = False):
        """Prefill ``inputs["tokens"]`` ([B, S]) at ``start_pos``; with
        ``start_pos`` > 0 the cache already holds that prefix (the paper's
        partial-match resume; ``resume`` only matters for meta-token
        models, which this port does not run). ``last_index`` picks the
        position whose logits return (bucket-padded prompts). Returns
        ``(logits [B, V] fp32, cache)``."""
        tokens = self._tokens(inputs["tokens"])
        B, S = tokens.shape
        x = F.embedding(tokens, self.embed)
        pos1 = start_pos + torch.arange(S, device=self.device)
        positions = pos1.expand(B, S)
        for si, sc in enumerate(cache["segments"]):
            x = tf.stack_prefill(self._segment_params(si), self.cfg,
                                 self.segment_specs[si], x, positions, sc,
                                 start_pos)
        last = x[:, -1:] if last_index is None else \
            x[:, last_index:last_index + 1]
        return self._head(last)[:, 0], cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos: int):
        """tokens: [B, 1]; pos: the token's position. Returns
        ``(logits [B, V] fp32, cache)``."""
        x1 = F.embedding(self._tokens(tokens), self.embed)
        for si, sc in enumerate(cache["segments"]):
            x1 = tf.stack_decode(self._segment_params(si), self.cfg,
                                 self.segment_specs[si], x1, pos, sc)
        return self._head(x1)[:, 0], cache
