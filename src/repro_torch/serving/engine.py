"""Inference engines: one request at a time (the edge client's), and a
pool of slots for continuous batching (the scheduler's).

Counterpart of ``repro.serving.engine.InferenceEngine``:

  * ``start(inputs)``                    — fresh prefill (Case 1, miss)
  * ``resume(inputs, cache, n_prefix)``  — continue from a downloaded
                                           prefix (Cases 2-4)
  * ``adopt(cache, n_tokens, logits)``   — full hit (Case 5): no compute
  * ``resume_streamed(inputs, n_prefix, groups, template)``
                                         — a resume run one layer group at
                                           a time, as the groups' cache
                                           chunks land
  * ``generate(state, n, sampler)``      — greedy decode loop

Prefill inputs of a dense, MoE or MLA model are padded to power-of-two
buckets, as in the reference. The padding writes junk K/V (or latents)
past the true length; the
next prefill or decode starts at the true length and the kernels mask by
``kv_len``, so it is never read. In a MoE layer the pad rows are routed
through the experts like any row; ``moe_local`` has no capacity, so the
real rows do not depend on them. Unlike the reference, the bucket is also
capped at the room left in the cache after ``start_pos``, so a resume
near the end of the cache never writes past it. A windowed model is never
padded (pad entries would rotate into its ring), nor is a model whose
cache holds recurrent state (an SSM, a hybrid): every pad token would
advance its state (the reference pads an SSM; ROADMAP Queue 3). An
encoder-decoder's ``frames`` pass through the padding untouched, and a
resume takes none (the cache holds the audio's K/V).

A model built on a mesh (``Model(..., mesh=...)``, expert-parallel MoE
layers) is served unchanged: every rank of the mesh runs the same
request through its own engine, and the MoE layers' collectives pair
the ranks' calls layer by layer, as the reference's engine serves a
meshed ``Model``.

:class:`BatchedEngine` is the counterpart of
``repro.serving.engine.BatchedEngine``: a fixed pool of cache slots, each
at its own position.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import clock
from repro_torch.kernels.flash_decode import arrival_counters
from repro_torch.models.common import tree_map
from repro_torch.serving.sampler import greedy


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclass
class EngineState:
    cache: Any
    pos: int                       # next token position
    last_logits: np.ndarray        # [B, V] on the host
    timings: Dict[str, float] = field(default_factory=dict)


class InferenceEngine:
    def __init__(self, model, max_len: int, cache_dtype=None):
        self.model = model
        self.max_len = max_len            # in prompt-token space
        self.cache_dtype = cache_dtype or model.dtype

    def new_cache(self):
        return self.model.init_cache(
            1, self.model.cache_len(self.max_len), self.cache_dtype)

    @property
    def supports_layer_stream(self) -> bool:
        """Whether :meth:`resume_streamed` can run this model."""
        return self.model.supports_layer_stream

    def _pad_inputs(self, inputs: Dict[str, np.ndarray], start_pos: int = 0):
        """Pad the sequence axis to a bucket; returns (padded, true_len).
        Tokens are edge-padded; a VLM's embeddings are padded with zeros
        and their ``[3, B, S]`` positions edge-padded, as the reference
        pads them."""
        key = "embeds" if "embeds" in inputs else "tokens"
        n = np.shape(inputs[key])[1]
        room = self.max_len - start_pos
        if n > room:
            raise ValueError(f"{n} tokens at position {start_pos} do not fit "
                             f"a cache of {self.max_len}")
        if self.model.cfg.window or self.model.has_recurrent_state:
            return inputs, n           # ring caches and states take no padding
        b = min(_bucket(n), room)
        if b == n:
            return inputs, n
        pad = b - n
        out = dict(inputs)
        if key == "tokens":
            out["tokens"] = np.pad(np.asarray(inputs["tokens"]),
                                   ((0, 0), (0, pad)), mode="edge")
        else:
            out["embeds"] = np.pad(np.asarray(inputs["embeds"]),
                                   ((0, 0), (0, pad), (0, 0)))
            out["positions"] = np.pad(np.asarray(inputs["positions"]),
                                      ((0, 0), (0, 0), (0, pad)), mode="edge")
        return out, n

    # ------------------------------------------------------------------
    def start(self, inputs) -> EngineState:
        """Fresh prefill of the full prompt (cache miss). Here and in the
        resumes ``inputs`` holds ``tokens`` [B, S], or a VLM's ``embeds``
        [B, S, D] and ``positions`` [3, B, S] (numpy arrays)."""
        return self._run_prefill(inputs, self.new_cache(), 0, resume=False)

    def resume(self, inputs, cache, n_prefix: int) -> EngineState:
        """Continue prefill from a restored prefix of ``n_prefix`` tokens."""
        return self._run_prefill(inputs, cache, n_prefix, resume=True)

    def adopt(self, cache, n_tokens: int, logits: np.ndarray) -> EngineState:
        """Full hit: adopt a downloaded state with no model execution."""
        return EngineState(cache=cache, pos=n_tokens, last_logits=logits)

    def resume_streamed(self, inputs, n_prefix: int,
                        groups: Iterable[Tuple[int, int, int, Any]],
                        template) -> EngineState:
        """A resume from a prefix of ``n_prefix`` tokens that runs the
        suffix one layer group at a time, as the groups' cache chunks land.

        ``groups`` yields ``(si, lo, hi, cache_group)`` in compute order
        (segment by segment, ascending layers, together covering every
        layer), typically from a generator that blocks on a
        :class:`~repro_torch.core.state_io.ChunkedRestorer`: layers
        ``[lo:hi)`` of segment ``si`` run while the chunks of later layers
        are still arriving. ``cache_group`` holds that segment's leaves cut
        to those layers, views of ``template`` with the stored prefix
        already in them; the layers write the suffix into them in place,
        so the state's cache is ``template`` itself. A group out of order,
        or a stream that ends before every layer ran, raises ``ValueError``.
        The input is padded as :meth:`resume` pads it. ``prefill_wall`` is
        the compute alone (the device synchronised after each group);
        ``stream_wall`` the whole call, waits for chunks included. An
        encoder-decoder raises, as in the reference."""
        model = self.model
        if not self.supports_layer_stream:
            raise NotImplementedError(
                f"layer-streamed resume unsupported for family "
                f"{model.cfg.family!r}")
        t0 = clock.monotonic()
        padded, true_n = self._pad_inputs(inputs, n_prefix)
        specs = model.segment_specs
        compute = 0.0
        tc = clock.monotonic()
        x, positions, eff_start = model.prefill_stream_embed(padded, n_prefix)
        _sync(x)
        compute += clock.monotonic() - tc
        next_layer = [0] * len(specs)
        for si, lo, hi, cache_group in groups:
            if not 0 <= si < len(specs) or lo != next_layer[si] or \
                    not lo <= hi <= specs[si].n_layers:
                raise ValueError(f"stream group (segment {si}, layers "
                                 f"{lo}:{hi}) out of order")
            tc = clock.monotonic()
            x, _ = model.prefill_stream_group(x, positions, cache_group,
                                              eff_start, si=si, lo=lo, hi=hi)
            _sync(x)
            compute += clock.monotonic() - tc
            next_layer[si] = hi
        for si, spec in enumerate(specs):
            if next_layer[si] != spec.n_layers:
                raise ValueError(f"stream ended with segment {si} at layer "
                                 f"{next_layer[si]}/{spec.n_layers}")
        tc = clock.monotonic()
        logits = model.prefill_stream_head(x, true_n - 1).cpu().numpy()
        compute += clock.monotonic() - tc
        st = EngineState(cache=template, pos=n_prefix + true_n,
                         last_logits=logits)
        st.timings["prefill_wall"] = compute
        st.timings["stream_wall"] = clock.monotonic() - t0
        return st

    def _run_prefill(self, inputs, cache, start_pos, *, resume):
        t0 = clock.monotonic()
        padded, true_n = self._pad_inputs(inputs, start_pos)
        logits, cache = self.model.prefill(padded, cache, start_pos,
                                           true_n - 1, resume=resume)
        logits = logits.cpu().numpy()          # waits for the device
        st = EngineState(cache=cache, pos=start_pos + true_n,
                         last_logits=logits)
        st.timings["prefill_wall"] = clock.monotonic() - t0
        return st

    # ------------------------------------------------------------------
    def decode_one(self, st: EngineState, token: np.ndarray) -> np.ndarray:
        """Feed ``token`` [B, 1], return logits [B, V]; advances state."""
        logits, st.cache = self.model.decode_step(st.cache, token, st.pos)
        st.pos += 1
        st.last_logits = logits.cpu().numpy()
        return st.last_logits

    def generate(self, st: EngineState, max_tokens: int,
                 sampler: Callable = greedy, rng=None) -> np.ndarray:
        """``max_tokens`` sampled tokens [B, max_tokens]; like the
        reference, every sampled token is also fed to the model."""
        t0 = clock.monotonic()
        out = []
        logits = st.last_logits
        for _ in range(max_tokens):
            tok = sampler(logits, rng)           # [B]
            out.append(tok)
            logits = self.decode_one(st, tok[:, None])
        st.timings["decode_wall"] = clock.monotonic() - t0
        st.timings["decode_tokens"] = len(out)
        return np.stack(out, axis=1)


def _sync(t: torch.Tensor) -> None:
    """Wait for the device work behind ``t`` (nothing to wait for on the
    CPU)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


# ---------------------------------------------------------------------------
# batched engine (continuous batching substrate)
# ---------------------------------------------------------------------------

class BatchedEngine:
    """Fixed pool of ``batch_size`` cache slots with per-slot positions.

    The reference vmaps its single-row decode over the cache's batch axis
    to give every slot its own position. Here the model's decode step
    takes the positions as one int32 ``[B]`` tensor on the device, and
    the decode kernels read each row's ``kv_len`` from it: every slot
    decodes at its own position in one launch per layer, whatever the
    batch size. Under M-RoPE (qwen2-vl) every component of a row's
    position is that row's entry of the same tensor, a view on the device.

    Slot lifecycle (driven by the Scheduler):
      ``prefill_slots``  — batched prefill of fresh prompts
      ``prefill_slot``   — exact single-row prefill, fresh or from a
                           downloaded prefix (``cache1``, ``start_pos``)
      ``adopt_slot``     — install a restored state (full hit)
      ``decode_batch``   — advance every active slot one token
      ``free_slot``      — recycle on EOS or length (stale K/V needs no
                           scrub: the next request's positions mask it)

    The pool cache is one allocation, made here. Slot writes are indexed
    copies into its batch axis (axis 1 of every ``[L, B, ...]`` leaf), and
    :meth:`slot_cache` is a view of one slot. ``prefill_slots`` pads the
    prompts to one power-of-two bucket and runs them as one batch of
    ``len(slots)`` rows into a cache of ``bucket`` positions (eager
    PyTorch has no compile count to bound, so the batch is not padded to
    ``batch_size`` as the reference pads it), then copies the rows into
    the pool (a MoE model's rows of all slots go through one MoE call a
    layer). A model with recurrent state (an SSM, a hybrid), or whose
    cache is a ring (a window no longer than the cache), takes exact
    per-row prefill instead: padding would run through the state (the
    reference pads an SSM; ROADMAP Queue 3), and a ring cache cannot take
    it (the reference falls back only for windows shorter than
    ``max_len``). ``prefill_slot`` runs in place on the slot's view; a
    ring row is written at its slots ``p % window`` and decodes with
    ``kv_len`` capped at the window, on the device.

    The cache takes the model's dtype, which the decode kernels need of
    it. Their arrival counters are reserved here, on the current stream,
    for the pool's largest grid (``batch_size * n_heads``), so no later
    launch on that stream moves the buffer; another stream reserves its
    own buffer at its first launch.
    """

    def __init__(self, model, max_len: int, batch_size: int):
        cfg = model.cfg
        if cfg.family == "encdec":
            raise NotImplementedError(
                "BatchedEngine does not serve an encoder-decoder: its slot "
                "prefill takes tokens alone, with no audio frames, and the "
                "reference's BatchedEngine cannot prefill one either "
                "(KeyError: 'frames')")
        self.model = model
        self.max_len = max_len
        self.batch_size = batch_size
        ring = cfg.window and cfg.window <= model.cache_len(max_len)
        self._pad_prefill = not (model.has_recurrent_state or ring)
        self.cache = model.init_cache(batch_size, model.cache_len(max_len))
        self.pos = np.zeros(batch_size, np.int32)     # next token position
        arrival_counters(model.device, batch_size * cfg.n_heads)

    # -- slot plumbing ---------------------------------------------------
    def slot_cache(self, slot: int):
        """A B=1 view of one slot's cache (for state_io extraction)."""
        return tree_map(lambda t: t[:, slot:slot + 1], self.cache)

    def free_slot(self, slot: int) -> None:
        self.pos[slot] = 0

    def _put(self, rows, slots) -> None:
        """Copy ``rows`` (a cache of ``len(slots)`` rows, its leaves
        ``[L, k, s, ...]``) into the pool's rows ``slots``, over the
        first ``s`` entries of each leaf's third axis."""
        idx = torch.as_tensor(np.asarray(slots), dtype=torch.long,
                              device=self.model.device)

        def put(big, new):
            big[:, idx, :new.shape[2]] = new.to(big.device, big.dtype)
        tree_map(put, self.cache, rows)

    def adopt_slot(self, slot: int, cache1, n_tokens: int) -> None:
        """Install a restored B=1 cache (full prompt-cache hit)."""
        self._put(cache1, [slot])
        self.pos[slot] = n_tokens

    # -- prefill ---------------------------------------------------------
    def prefill_slots(self, slots: Sequence[int],
                      token_rows: Sequence[np.ndarray]) -> np.ndarray:
        """Prefill fresh prompts into ``slots``: rows edge-padded to one
        power-of-two bucket in one batch, or one exact prefill a row (see
        the class docstring). Returns the true last-token logits
        ``[len(slots), V]``."""
        k = len(slots)
        if not 0 < k <= self.batch_size or len(token_rows) != k:
            raise ValueError(f"{k} slots for {len(token_rows)} prompts in a "
                             f"pool of {self.batch_size}")
        rows = [np.asarray(t).reshape(-1) for t in token_rows]
        lens = [len(r) for r in rows]
        if max(lens) > self.max_len:
            raise ValueError(f"a {max(lens)}-token prompt does not fit a "
                             f"cache of {self.max_len}")
        if not self._pad_prefill:
            return np.concatenate([self.prefill_slot(s, r)
                                   for s, r in zip(slots, rows)])
        bucket = min(_bucket(max(lens)), self.max_len)
        toks = np.stack([np.pad(r, (0, bucket - len(r)), mode="edge")
                         for r in rows])
        fresh = self.model.init_cache(k, self.model.cache_len(bucket))
        logits, fresh = self.model.prefill({"tokens": toks}, fresh, 0,
                                           [n - 1 for n in lens])
        self._put(fresh, slots)
        self.pos[list(slots)] = lens
        return logits.cpu().numpy()

    def prefill_slot(self, slot: int, tokens: np.ndarray,
                     cache1=None, start_pos: int = 0) -> np.ndarray:
        """Exact-length single-row prefill into ``slot``, in place on its
        view of the pool. ``cache1``/``start_pos``: resume from a
        downloaded prefix state (a B=1 cache holding ``start_pos``
        tokens), copied into the slot first; without one, a recurrent
        state starts from zero. Returns logits [1, V]."""
        toks = np.asarray(tokens).reshape(1, -1)
        n = toks.shape[1]
        if start_pos + n > self.max_len:
            raise ValueError(f"{n} tokens at position {start_pos} do not fit "
                             f"a cache of {self.max_len}")
        if cache1 is not None:
            self._put(cache1, [slot])
        elif self.model.has_recurrent_state:
            tree_map(lambda t: t[:, slot].zero_(), self.cache)
        logits, _ = self.model.prefill({"tokens": toks}, self.slot_cache(slot),
                                       start_pos, n - 1,
                                       resume=start_pos > 0)
        self.pos[slot] = start_pos + n
        return logits.cpu().numpy()

    # -- decode ------------------------------------------------------------
    def decode_batch(self, tokens: np.ndarray,
                     active: Optional[np.ndarray] = None) -> np.ndarray:
        """One decode step for the whole pool. ``tokens``: [B] (pad rows
        arbitrary); ``active``: [B] bool mask. The positions go to the
        device as one int32 ``[B]`` tensor; an inactive row steps at
        position 0 and its (junk) write is overwritten or masked on the
        slot's next use. Returns logits [B, V]; advances active positions.
        """
        if active is None:
            active = np.ones(self.batch_size, bool)
        pos = np.where(active, self.pos, 0).astype(np.int32)
        if pos.max() >= self.max_len:
            raise ValueError(f"a slot at position {int(pos.max())} overflows "
                             f"a cache of {self.max_len}")
        pos_dev = torch.from_numpy(pos).to(self.model.device)
        logits, _ = self.model.decode_step(
            self.cache, np.asarray(tokens).reshape(-1, 1), pos_dev,
            kv_max=int(pos.max()) + 1)
        self.pos = np.where(active, self.pos + 1, self.pos).astype(np.int32)
        return logits.cpu().numpy()
