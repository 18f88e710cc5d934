"""Model facade for the six families (dense, VLM, SSM, hybrid, MoE and
the encoder-decoder; deepseek-v3 cut to its dense MLA layers or to those
and its first MoE layers): the training forward and loss, prefill with
prefix resume, and one-token decode.

Counterpart of ``repro.models.model.Model``. The
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
(``core/state_io.py``). An encoder-decoder (whisper) holds ``enc``
(stacked ``[L_enc, ...]``), ``enc_ln`` and ``dec`` instead of segments,
and its cache is ``{"dec": {"self": {"k", "v"}, "cross_k", "cross_v"}}``
with a leading ``[L]`` on every leaf, the cross K/V ``[L, B, n_frames,
KV, dh]``: a cold prefill runs the encoder over ``inputs["frames"]`` and
stores them, a resume reads them (``models/encdec.py``).
:meth:`prefill` and :meth:`decode_step` update it IN PLACE and return it.

Training (:meth:`forward`, :meth:`loss`) runs the full sequence with no
cache: each layer's training forward, under a checkpoint a layer with
``remat``; the cross-entropy sequence-chunked, each chunk under a
checkpoint, under the reference's condition; deepseek's MTP head (its
params under ``mtp``, built when ``cfg.mtp``) adds its loss at weight 0.3.
A VLM also trains on a batch of the stub vision encoder's merged
embeddings (``embeds`` [B, S, D], ``positions`` [3, B, S], ``targets``),
its attention masked, as the reference's is, by batch row 0's temporal
positions: where they repeat, by a key limit computed once a batch on
the host (``attention.training_key_limit``).

Under a mesh (``Model(..., mesh=...)``, a ``torch.distributed`` mesh of
``data`` x ``model`` ranks, ``launch/mesh.py``) every rank serves the
same request: the mesh goes to the MoE layers alone, which run
expert-parallel (``moe_forward``: ``moe_ep`` or ``moe_ep_resident``),
each rank holding its slice of the experts, decided once when the
model is built (``moe.init_moe``'s ``ep``): drawn from a seed, each
layer's stacks are drawn whole and cut; loaded, each whole stack of the
state dict is cut as it is loaded (:meth:`Model.load_state_dict`).
The reference's other uses of a mesh (``constrain_bh``, ``act_pspec``,
the logits' sharding, ``repro/models/model.py:113-141``) are layout
hints to GSPMD that change no number, so every other layer runs
replicated on every rank. Training under a mesh raises (ROADMAP item
11a-2).

Parameters are registered frozen: ``model.requires_grad_(True)`` makes
them trainable (``training.train_step`` does). Serving runs under
``torch.no_grad`` and ignores the MTP head, as the reference's does.

Meta tokens (hymba's learned prefix of ``R`` rows, ``meta [R, d]``) take
cache positions ``0..R-1`` and text token ``i`` position ``R + i``: a
cold prefill prepends them and writes the cache from 0, a resume adds
none and continues at ``start_pos + R``, and a decode step at text
position ``pos`` runs at ``pos + R``. Positions the caller passes
(``start_pos``, ``pos``, ``last_index``) are text positions.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import axis_index, axis_size
from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tf
from repro_torch.models.attention import training_key_limit
from repro_torch.models.common import (add_sinusoidal, apply_norm,
                                       embed_init, tree_map)
from repro_torch.models.moe import EXPERT_LEAVES, stored_experts
from repro_torch.params import expert_slice

CE_CHUNK = 512                 # positions a chunk of the chunked CE
CE_CHUNKED_ABOVE = 1 << 25     # S * V past which the CE is chunked
MTP_WEIGHT = 0.3


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
    for a caller that loads a state dict next. ``remat`` recomputes each
    layer's activations in the backward (training only). With
    ``cfg.mtp`` the MTP head's params are built too (``mtp.layer`` of the
    last segment's kind, ``mtp.proj``, ``mtp.ln_h``, ``mtp.ln_e``): the
    loss trains them, serving leaves them unused. Under ``mesh`` every
    MoE expert stack holds only the rank's ``model``-axis slice
    (``[L, e_pad / n_model, ...]``)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None, seed: Optional[int] = 0,
                 remat: bool = False, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        # (model index, model ranks): the expert slice this rank holds;
        # axis_size refuses a mesh with a pod axis
        self.ep = (0, 1) if mesh is None else \
            (axis_index(mesh, "model"), axis_size(mesh, "model"))
        self.remat = remat
        self.is_encdec = cfg.family == "encdec"
        self.segment_specs = [] if self.is_encdec else tf.segments_for(cfg)
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
            cfg, spec, dtype, gen, device=self.device, ep=self.ep))
            for spec in self.segment_specs])
        if self.is_encdec:
            def stacked(init, n):
                return ParamTree(tf.stack_layers([
                    init(cfg, dtype, gen, device=self.device)
                    for _ in range(n)]))
            self.enc = stacked(ed.init_enc_layer, cfg.encdec.n_enc_layers)
            self.enc_ln = _pdict(tf.init_norm(cfg, dtype, self.device))
            self.dec = stacked(ed.init_dec_layer, cfg.n_layers)
        if cfg.mtp and not self.is_encdec:
            d = cfg.d_model
            self.mtp = ParamTree({
                "layer": tf.init_layer(cfg, self.segment_specs[-1], dtype,
                                       gen, device=self.device, ep=self.ep),
                "proj": embed_init((2 * d, d), dtype, gen,
                                   device=self.device),
                "ln_h": tf.init_norm(cfg, dtype, self.device),
                "ln_e": tf.init_norm(cfg, dtype, self.device)})

    def load_state_dict(self, state_dict, *args, **kwargs):
        """``nn.Module.load_state_dict``; under a mesh each MoE expert stack
        that comes whole (the reference's ``[L, E, d, f]``) is cut to the
        rank's slice as it is loaded (``params.expert_slice``)."""
        m, n_model = self.ep
        if n_model > 1:
            es = stored_experts(self.cfg)
            meta = getattr(state_dict, "_metadata", None)
            state_dict = OrderedDict(state_dict)
            if meta is not None:
                state_dict._metadata = meta
            for k, t in state_dict.items():
                path = k.split(".")
                axis = t.dim() - 3              # [L,] E, d, f
                if path[-2:-1] == ["moe"] and path[-1] in EXPERT_LEAVES \
                        and axis >= 0 and t.shape[axis] == es:
                    state_dict[k] = expert_slice(t, m, n_model, es, axis)
        return super().load_state_dict(state_dict, *args, **kwargs)

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
        dtype = dtype or self.dtype
        if self.is_encdec:
            one = ed.init_dec_cache(self.cfg, batch, max_len, dtype, "meta")
            return {"dec": tree_map(lambda t: torch.zeros(
                (self.cfg.n_layers,) + tuple(t.shape), dtype=t.dtype,
                device=self.device), one)}
        return {"segments": [tf.init_segment_cache(
            self.cfg, spec, batch, max_len, dtype, self.device)
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
    # training / full forward
    # ------------------------------------------------------------------
    def _backbone(self, batch):
        """Hidden states of the whole sequence ``[B, S, D]`` (text rows
        only: a meta-token model's prefix is dropped) and the MoE layers'
        summed aux loss. ``batch["tokens"]`` [B, S]; an encoder-decoder
        also takes ``batch["frames"]`` [B, n_frames, d]; a VLM takes
        ``batch["embeds"]`` [B, S, D] and ``batch["positions"]`` [3, B, S]
        instead of tokens (:meth:`_key_limit`)."""
        cfg = self.cfg
        if self.mesh is not None:
            raise NotImplementedError(
                "training under a mesh (the collectives' gradients) is not "
                "in this port yet (ROADMAP item 11a-2)")
        if self.is_encdec:
            return self._backbone_encdec(batch), 0.0
        x, positions, _ = self._embed(batch, 0, resume=False)
        key_limit = self._key_limit(batch)
        aux = 0.0
        for sp, spec in zip(self.segments, self.segment_specs):
            x, a = tf.stack_forward(sp.tree(), cfg, spec, x, positions,
                                    remat=self.remat, key_limit=key_limit)
            aux = aux + a
        return x[:, cfg.n_meta_tokens:], aux

    def _key_limit(self, batch) -> Optional[torch.Tensor]:
        """The training mask of a VLM batch of embeddings: the key limit
        of batch row 0's temporal positions (``training_key_limit``, which
        raises for positions that decrease or are negative), computed on
        the host and copied to the device once (int32 ``[S]``); None where
        they strictly increase, as a text batch's do (the causal rule)."""
        if not (self.cfg.family == "vlm" and "embeds" in batch):
            return None
        pos = batch["positions"]
        pos_t = pos[0, 0].cpu().numpy() if torch.is_tensor(pos) \
            else np.asarray(pos)[0, 0]
        lim = training_key_limit(pos_t)
        return None if lim is None else torch.as_tensor(lim,
                                                        device=self.device)

    def _backbone_encdec(self, batch) -> torch.Tensor:
        cfg = self.cfg
        frames = batch["frames"]
        if not torch.is_tensor(frames):
            frames = torch.from_numpy(np.array(frames))
        enc = add_sinusoidal(frames.to(self.device, self.dtype))
        for lp in tf.unbind_layers(self.enc.tree(), cfg.encdec.n_enc_layers):
            enc = self._layer(ed.enc_layer, lp, cfg, enc)
        enc = apply_norm(self.enc_ln, enc)
        tokens = self._tokens(batch["tokens"])
        B, S = tokens.shape
        x = add_sinusoidal(F.embedding(tokens, self.embed))
        positions = torch.arange(S, device=self.device).expand(B, S)
        for lp in tf.unbind_layers(self.dec.tree(), cfg.n_layers):
            x = self._layer(ed.dec_layer_forward, lp, cfg, x, positions, enc)
        return x

    def _layer(self, fn, *args):
        """``fn(*args)``, under a checkpoint with ``remat``."""
        if self.remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def forward(self, batch) -> torch.Tensor:
        """Logits ``[B, S, V]`` fp32 of the whole sequence."""
        return self._head(self._backbone(batch)[0])

    def _ce(self, h, targets, mask) -> torch.Tensor:
        """Masked mean cross-entropy of the head over ``h`` [B, S, D].
        Sequence-chunked under the reference's condition (``S * V`` past
        2^25, ``S`` a multiple of the 512-position chunk and above it),
        each chunk's logits recomputed in the backward: at a 262k vocab a
        whole sequence's fp32 logits would be kept several times over."""
        S, V, chunk = h.shape[1], self.embed.shape[0], CE_CHUNK
        if S * V <= CE_CHUNKED_ABOVE or S % chunk or S <= chunk:
            ll, m = self._ce_chunk(h, targets, mask)
            return -ll / (m + 1e-9)
        ll = m = 0.0
        for c in range(0, S, chunk):
            lc, mc = checkpoint(self._ce_chunk, h[:, c:c + chunk],
                                targets[:, c:c + chunk],
                                mask[:, c:c + chunk], use_reentrant=False)
            ll, m = ll + lc, m + mc
        return -ll / (m + 1e-9)

    def _ce_chunk(self, h, targets, mask):
        """(sum of the masked log-likelihoods, sum of the mask)."""
        logp = torch.log_softmax(self._head(h), dim=-1)
        ll = torch.gather(logp, -1, targets[..., None])[..., 0]
        mask = mask.float()
        return torch.sum(ll * mask), torch.sum(mask)

    def loss(self, batch):
        """``(loss, metrics)``: the cross-entropy of ``batch["targets"]``
        [B, S] (under ``batch["mask"]`` when given) plus the MoE aux loss
        and, with an MTP head, 0.3 times its loss on the token after the
        next. ``metrics`` holds ``ce``, ``aux``, ``mtp`` (MTP models) and
        ``loss``, each a 0-d fp32 tensor."""
        cfg = self.cfg
        h, aux = self._backbone(batch)
        targets = self._tokens(batch["targets"])
        mask = batch.get("mask")
        mask = torch.ones(targets.shape, device=self.device) if mask is None \
            else torch.as_tensor(np.asarray(mask), device=self.device).float()
        ce = self._ce(h, targets, mask)
        aux = torch.as_tensor(aux, dtype=torch.float32, device=self.device)
        metrics = {"ce": ce, "aux": aux}
        total = ce + aux
        if cfg.mtp and "tokens" in batch:
            mtp = self._mtp_loss(h, self._tokens(batch["tokens"]), targets,
                                 mask)
            metrics["mtp"] = mtp
            total = total + MTP_WEIGHT * mtp
        metrics["loss"] = total
        return total, metrics

    def _mtp_loss(self, h, tokens, targets, mask) -> torch.Tensor:
        """The MTP head's loss: predict token t + 2 from (h_t, the embedding
        of token t + 1) through one more layer of the last segment's kind,
        its CE padded to the chunk's multiple where it is chunked, as the
        reference pads it."""
        cfg, mp = self.cfg, self.mtp.tree()
        hh = apply_norm(mp["ln_h"], h[:, :-1])
        ee = apply_norm(mp["ln_e"], F.embedding(tokens[:, 1:], self.embed))
        hm = torch.cat([hh, ee], dim=-1) @ mp["proj"]
        B, S1 = hm.shape[:2]
        positions = torch.arange(S1, device=self.device).expand(B, S1)
        if cfg.rope == "mrope":
            positions = positions.expand(3, B, S1)
        hm, _ = tf.layer_forward(mp["layer"], cfg, self.segment_specs[-1], hm,
                                 positions)
        tgt, msk = targets[:, 1:], mask[:, 1:]
        pad = (-S1) % CE_CHUNK
        if pad and S1 * self.embed.shape[0] > CE_CHUNKED_ABOVE:
            hm = F.pad(hm, (0, 0, 0, pad))
            tgt, msk = F.pad(tgt, (0, pad)), F.pad(msk, (0, pad))
        return self._ce(hm, tgt, msk)

    # ------------------------------------------------------------------
    # serving
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
        An encoder-decoder also takes ``inputs["frames"]`` ([B, n_frames,
        d], numpy or a tensor), encoded when ``resume`` is false.
        Returns ``(logits [B, V] fp32, cache)``."""
        if self.is_encdec:
            return self._prefill_encdec(inputs, cache, start_pos,
                                        last_index, resume)
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

    @torch.no_grad()
    def encode(self, frames) -> torch.Tensor:
        """The encoder over frame embeddings ``[B, n_frames, d]`` (numpy or
        a tensor, moved to the model's device and dtype): ``[B, n_frames,
        d]`` after ``enc_ln``."""
        if not torch.is_tensor(frames):
            frames = torch.from_numpy(np.array(frames))
        x = add_sinusoidal(frames.to(self.device, self.dtype))
        ep = self.enc.tree()
        for i in range(self.cfg.encdec.n_enc_layers):
            x = ed.enc_layer(tf.layer_params(ep, i), self.cfg, x)
        return apply_norm(self.enc_ln, x)

    def _prefill_encdec(self, inputs, cache, start_pos, last_index, resume):
        """The encoder (unless ``resume``), then the decoder over the tokens
        at ``start_pos``, as the reference's ``_prefill_encdec``."""
        enc = None if resume else self.encode(inputs["frames"])
        tokens = self._tokens(inputs["tokens"])
        B, S = tokens.shape
        x = add_sinusoidal(F.embedding(tokens, self.embed), start_pos)
        positions = (start_pos + torch.arange(S, device=self.device)
                     ).expand(B, S)
        dp = self.dec.tree()
        for i in range(self.cfg.n_layers):
            x, _ = ed.dec_layer_prefill(
                tf.layer_params(dp, i), self.cfg, x, positions,
                tf.layer_params(cache["dec"], i), start_pos, enc_out=enc)
        return self.prefill_stream_head(x, last_index), cache

    # -- layer-streamed prefill ------------------------------------------
    # The prefill in three pieces, so a streamed resume runs layers
    # [lo:hi) of the suffix as soon as that layer group's cache chunks
    # have landed. Running [0:k) then [k:L) is the same layer loop as
    # running [0:L): the same kernels, launched layer by layer.

    @property
    def supports_layer_stream(self) -> bool:
        """Every family but the encoder-decoder, as in the reference."""
        return not self.is_encdec

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
        return self._embed(inputs, start_pos, resume)

    def _embed(self, inputs, start_pos: int, resume: bool):
        """:meth:`prefill_stream_embed`'s work, differentiable (the
        training forward's embedding, ``start_pos = 0`` and the meta rows
        prepended)."""
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
                             eff_start, self.mesh)
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
        a tensor); an encoder-decoder takes an int ``pos`` and adds its
        sinusoid. Returns ``(logits [B, V] fp32, cache)``."""
        if self.is_encdec:
            x1 = add_sinusoidal(F.embedding(self._tokens(tokens), self.embed),
                                pos)
            dp = self.dec.tree()
            for i in range(self.cfg.n_layers):
                x1, _ = ed.dec_layer_decode(
                    tf.layer_params(dp, i), self.cfg, x1, pos,
                    tf.layer_params(cache["dec"], i))
            return self._head(x1)[:, 0], cache
        R = self.cfg.n_meta_tokens
        if R:
            pos = pos + R
            kv_max = None if kv_max is None else kv_max + R
        x1 = F.embedding(self._tokens(tokens), self.embed)
        for si, sc in enumerate(cache["segments"]):
            x1 = tf.stack_decode(self.segments[si].tree(), self.cfg,
                                 self.segment_specs[si], x1, pos, sc, kv_max,
                                 self.mesh)
        return self._head(x1)[:, 0], cache
