"""Model facade for decoder-only models (the dense, VLM, SSM, hybrid and
MoE families; deepseek-v3 cut to its dense MLA layers or to those and
its first MoE layers): prefill with prefix resume, and one-token decode.

Counterpart of ``repro.models.model.Model`` (serving modes only). The
parameters live in this ``nn.Module`` under the reference's tree paths,
with ``.`` for ``/`` (``segments.0.attn.wq`` is the reference's
``segments/0/attn/wq``, same ``[L, d, H, dh]`` layout; a hybrid's
``segments.0.hyb.attn.wq`` one level deeper), so
:func:`repro_torch.params.from_jax_params` is a copy. The cache returned
by :meth:`init_cache` has the reference's structure, layout and per-leaf
dtypes, ``{"segments": [{"k": [L,B,S,KV,dh], "v": ...}]}`` for a dense
model, ``{"segments": [{"conv": [L,B,K-1,C], "ssd": [L,B,H,P,N] fp32}]}``
for an SSM, ``{"segments": [{"attn": {"k", "v"}, "ssm": {"conv",
"ssd"}}]}`` for a hybrid and ``{"segments": [{"ckv": [L,B,S,R], "krope":
[L,B,S,Dr]}, ...]}`` for MLA (a MoE segment's cache is its attention's:
k/v for granite, latents for deepseek; an empty MoE segment has ``L =
0``): it is the state the paper ships between devices
(``core/state_io.py``).
:meth:`prefill` and :meth:`decode_step` update it IN PLACE and return it.

Meta tokens (hymba's learned prefix of ``R`` rows, ``meta [R, d]``) take
cache positions ``0..R-1`` and text token ``i`` position ``R + i``: a
cold prefill prepends them and writes the cache from 0, a resume adds
none and continues at ``start_pos + R``, and a decode step at text
position ``pos`` runs at ``pos + R``. Positions the caller passes
(``start_pos``, ``pos``, ``last_index``) are text positions.
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
from repro_torch.models.common import apply_norm, embed_init, tree_map


def padded_vocab(vocab: int) -> int:
    """Vocab storage padded to a multiple of 256, as the reference pads
    it; the padded tail is masked in the head."""
    return -(-vocab // 256) * 256


def _pdict(tensors: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(t, requires_grad=False)
                             for k, t in tensors.items()})


class ParamTree(nn.Module):
    """Nested dicts of tensors as a module under the same names: a tensor
    is a parameter, a dict a child module, so the state dict's keys are
    the tree's paths with ``.`` (a ``ParameterDict`` key cannot hold
    one). ``tree[name]`` reads a child or a parameter."""

    def __init__(self, tree: Dict):
        super().__init__()
        for k, v in tree.items():
            if torch.is_tensor(v):
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))
            else:
                self.add_module(k, ParamTree(v))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def tree(self) -> Dict:
        """The parameters as nested dicts of tensors."""
        out = dict(self._parameters)
        out.update((k, m.tree()) for k, m in self._modules.items())
        return out


class Model(nn.Module):
    """``seed`` draws the random weights with a generator on the model's
    device: on the card they are drawn there, not on the host, and differ
    from the CPU's for the same seed. ``seed=None`` allocates them unset,
    for a caller that loads a state dict next."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None, seed: Optional[int] = 0):
        super().__init__()
        if cfg.family not in ("dense", "vlm", "ssm", "hybrid", "moe"):
            raise NotImplementedError(
                f"family {cfg.family!r} is not in this port yet (ROADMAP "
                "Queue 1, item 9)")
        if cfg.mtp:
            raise NotImplementedError(
                "the MTP head is a training head; serve the model with "
                "mtp=False (training: ROADMAP Queue 1, item 10)")
        self.cfg = cfg
        self.segment_specs = tf.segments_for(cfg)
        self.dtype = dtype
        self.device = resolve_device(device)
        gen = None if seed is None else \
            torch.Generator(device=self.device).manual_seed(seed)
        vp = padded_vocab(cfg.vocab)
        self.embed = nn.Parameter(
            embed_init((vp, cfg.d_model), dtype, gen, device=self.device),
            requires_grad=False)
        self.final_norm = _pdict(tf.init_norm(cfg, dtype, self.device))
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(
                embed_init((cfg.d_model, vp), dtype, gen, device=self.device),
                requires_grad=False)
        if cfg.n_meta_tokens:          # drawn after the head, as the
            self.meta = nn.Parameter(   # reference draws it
                embed_init((cfg.n_meta_tokens, cfg.d_model), dtype, gen,
                           device=self.device), requires_grad=False)
        self.segments = nn.ModuleList([ParamTree(tf.init_segment(
            cfg, spec, dtype, gen, device=self.device))
            for spec in self.segment_specs])

    @property
    def has_recurrent_state(self) -> bool:
        """True when the cache holds a state that every token advances (an
        SSM's or a hybrid's conv window and SSD state) beside or instead
        of per-position K/V: it cannot take padding or a re-run token, and
        it is not cut to a prefix when serialized."""
        return any(s.kind in ("ssm", "hybrid") for s in self.segment_specs)

    # ------------------------------------------------------------------
    def cache_len(self, n_tokens: int) -> int:
        return n_tokens + self.cfg.n_meta_tokens

    def init_cache(self, batch: int, max_len: int, dtype=None):
        return {"segments": [tf.init_segment_cache(
            self.cfg, spec, batch, max_len, dtype or self.dtype, self.device)
            for spec in self.segment_specs]}

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
    def prefill(self, inputs, cache, start_pos: int = 0, last_index=None,
                *, resume: bool = False):
        """Prefill ``inputs["tokens"]`` ([B, S]) at ``start_pos``, or a
        VLM's ``inputs["embeds"]`` ([B, S, D]) at ``inputs["positions"]``
        ([3, B, S]), the stub vision encoder's merged embeddings; with
        ``start_pos`` > 0 the cache already holds that prefix (the paper's
        partial-match resume). ``resume`` matters for meta-token models
        only: without it the meta tokens are prepended (see the module
        docstring). ``last_index`` picks the text index whose logits
        return (bucket-padded prompts): one for every row, or one a row.
        Returns ``(logits [B, V] fp32, cache)``."""
        x, positions, eff_start = self.prefill_stream_embed(
            inputs, start_pos, resume=resume)
        for si, spec in enumerate(self.segment_specs):
            x, _ = self.prefill_stream_group(
                x, positions, cache["segments"][si], eff_start, si=si, lo=0,
                hi=spec.n_layers)
        R = self.cfg.n_meta_tokens
        if R and not resume and last_index is not None:
            # a text index: the row past the meta rows
            last_index = int(last_index) + R if np.ndim(last_index) == 0 \
                else [int(i) + R for i in last_index]
        return self.prefill_stream_head(x, last_index), cache

    # -- layer-streamed prefill ------------------------------------------
    # The prefill in three pieces, so a streamed resume runs layers
    # [lo:hi) of the suffix as soon as that layer group's cache chunks
    # have landed. Running [0:k) then [k:L) is the same layer loop as
    # running [0:L): the same kernels, launched layer by layer.

    @property
    def supports_layer_stream(self) -> bool:
        return True                    # every family this port runs

    @torch.no_grad()
    def prefill_stream_embed(self, inputs, start_pos: int, *,
                             resume: bool = True):
        """The suffix's hidden states and positions: ``(x, positions,
        eff_start)``, as :meth:`prefill` computes them (a streamed prefill
        is a resume). A VLM's embeddings come with their own positions;
        text tokens under M-RoPE take ``[3, B, S]`` positions, the three
        components equal. Text takes positions ``start_pos + R + i``; a
        cold prefill (``resume=False``) of a meta-token model prepends
        the ``R`` meta rows at positions ``0..R-1`` and writes the cache
        from ``start_pos``."""
        R = self.cfg.n_meta_tokens
        eff_start = start_pos + (R if resume else 0)
        if self.cfg.family == "vlm" and "embeds" in inputs:
            x = torch.as_tensor(inputs["embeds"], device=self.device)
            positions = torch.as_tensor(inputs["positions"], dtype=torch.long,
                                        device=self.device)
            return x.to(self.dtype), positions, eff_start
        tokens = self._tokens(inputs["tokens"])
        B, S = tokens.shape
        x = F.embedding(tokens, self.embed)
        pos1 = start_pos + R + torch.arange(S, device=self.device)
        if R and not resume:
            x = torch.cat([self.meta.expand(B, R, -1).to(x.dtype), x], 1)
            pos1 = torch.cat([torch.arange(R, device=self.device), pos1])
            S += R
        shape = (3, B, S) if self.cfg.rope == "mrope" else (B, S)
        return x, pos1.expand(shape), eff_start

    @torch.no_grad()
    def prefill_stream_group(self, x, positions, cache_group, eff_start: int,
                             *, si: int, lo: int, hi: int):
        """Layers ``[lo:hi)`` of segment ``si`` on ``x``, over that
        segment's parameters cut to those layers and ``cache_group``, its
        cache leaves cut to them (updated in place). Returns ``(x,
        cache_group)``."""
        sp = tree_map(lambda t: t[lo:hi], self.segments[si].tree())
        spec = self.segment_specs[si]._replace(n_layers=hi - lo)
        x = tf.stack_prefill(sp, self.cfg, spec, x, positions, cache_group,
                             eff_start)
        return x, cache_group

    @torch.no_grad()
    def prefill_stream_head(self, x, last_index=None):
        """Last-token logits ``[B, V]`` fp32, or those at ``last_index``:
        an int for every row, or a sequence of one index a row."""
        if last_index is None:
            last = x[:, -1:]
        elif np.ndim(last_index):
            idx = torch.as_tensor(np.asarray(last_index), dtype=torch.long,
                                  device=x.device)
            last = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
        else:
            last = x[:, last_index:last_index + 1]
        return self._head(last)[:, 0]

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos, kv_max: Optional[int] = None):
        """tokens: [B, 1]; pos: the tokens' text position, an int for
        every row or an int32 ``[B]`` tensor on the model's device, one a
        row (under M-RoPE all three components take it, as in the
        reference); then ``kv_max`` (a host int, default the cache's
        length) bounds every ``pos + 1`` and sizes the decode kernels'
        grids. A meta-token model runs at ``pos + R`` (on the device for
        a tensor). Returns ``(logits [B, V] fp32, cache)``."""
        R = self.cfg.n_meta_tokens
        if R:
            pos = pos + R
            kv_max = None if kv_max is None else kv_max + R
        x1 = F.embedding(self._tokens(tokens), self.embed)
        for si, sc in enumerate(cache["segments"]):
            x1 = tf.stack_decode(self.segments[si].tree(), self.cfg,
                                 self.segment_specs[si], x1, pos, sc, kv_max)
        return self._head(x1)[:, 0], cache
