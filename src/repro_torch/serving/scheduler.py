"""Continuous batching over a ``BatchedEngine`` slot pool.

Counterpart of ``repro.serving.scheduler``: iteration-level scheduling,
reduced to its core loop.

  * a FIFO request queue feeds a fixed pool of B cache slots;
  * admission is *prefill-before-decode*: whenever a slot is free and a
    request is queued, the next iteration prefills every admissible
    request before any decode step, so new requests reach their first
    token as early as possible;
  * one ``decode_batch`` step then advances every active slot at its own
    position (one launch per layer of each decode kernel);
  * slots are recycled the moment a request finishes (EOS or
    max-new-tokens), so the next queued request is admitted on the very
    next iteration.

The scheduler is single-threaded and deterministic: it samples greedily
(the paper decodes greedily), so its outputs are token-identical to sequential ``InferenceEngine``
runs. It counts finished requests by reason and observes each request's
queue wait in :data:`repro_torch.obs.metrics.REGISTRY`. With a
``tracer``, a finished request whose ``Request.trace`` names a parent
span gets its slot-lifecycle spans (``slot.queue_wait``, ``slot.prefill``
as Table-3 ``p_decode``, ``slot.decode`` as ``r_decode``), projected from
the request's timestamps: no span is timed around a device call, so a
traced step synchronises and launches exactly what an untraced one does.
The gateway's engine thread (:mod:`repro_torch.gateway.engine`) drives it
with ``step()``.
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch import clock
from repro_torch.core.metrics import RequestStats, ServingReport
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.serving.engine import BatchedEngine
from repro_torch.serving.sampler import greedy


@dataclass
class Request:
    """One generation request."""
    tokens: np.ndarray                 # prompt token ids [n]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    req_id: int = -1                   # assigned by submit()
    # resume-from-prompt-cache entry points:
    cache1: object = None              # restored B=1 cache prefix
    n_prefix: int = 0                  # tokens held by cache1
    prefix_logits: Optional[np.ndarray] = None   # full hit: [1, V]
    tenant: str = ""                   # gateway multi-tenancy tag
    stats: RequestStats = field(default=None)    # filled by the scheduler
    # the span context (from the submitting thread) this request's slot
    # spans parent onto
    trace: object = None


@dataclass
class _Slot:
    req: Optional[Request] = None

    @property
    def free(self) -> bool:
        return self.req is None


class Scheduler:
    def __init__(self, engine: BatchedEngine,
                 on_prefill: Optional[Callable] = None,
                 tracer: Optional[Tracer] = None):
        self.engine = engine
        self.tracer = tracer or NULL_TRACER
        self._m_reqs = REGISTRY.counter(
            "sched_requests_total", "requests finished by reason",
            ("reason",))
        self._m_queue = REGISTRY.histogram(
            "sched_queue_wait_seconds",
            "submit-to-admission wait per request")
        # called as on_prefill(slot_i, req, logits_row) right after a
        # FRESH prefill (cache-resumed admissions came from the cache), so
        # a caller can extract and upload the prompt-cache ranges while
        # the slot still holds the state
        self.on_prefill = on_prefill
        self.queue: deque[Request] = deque()
        self.slots = [_Slot() for _ in range(engine.batch_size)]
        self._ids = itertools.count()
        self.done: List[Request] = []
        self._last_logits = np.zeros(
            (engine.batch_size, 1), np.float32)     # per-slot, resized lazily
        self.n_steps = 0                             # decode iterations run

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> int:
        need = int(np.size(req.tokens)) + req.max_new_tokens
        if need > self.engine.max_len:
            raise ValueError(
                f"request needs {need} cache positions (prompt "
                f"{int(np.size(req.tokens))} + {req.max_new_tokens} new) "
                f"but the engine was built with max_len="
                f"{self.engine.max_len}")
        if req.req_id < 0:
            req.req_id = next(self._ids)
        req.stats = RequestStats(req_id=req.req_id,
                                 prompt_tokens=int(np.size(req.tokens)),
                                 submit_t=clock.monotonic(),
                                 tenant=req.tenant)
        self.queue.append(req)
        return req.req_id

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(not s.free for s in self.slots)

    # ------------------------------------------------------------------
    def _emit(self, slot_i: int, token: int) -> None:
        """Record one generated token; recycle the slot when finished."""
        slot = self.slots[slot_i]
        req = slot.req
        if not req.stats.first_token_t:
            req.stats.first_token_t = clock.monotonic()
        req.stats.output_tokens.append(int(token))
        finished = None
        if req.eos_id is not None and token == req.eos_id:
            finished = "eos"
        elif len(req.stats.output_tokens) >= req.max_new_tokens:
            finished = "length"
        if finished:
            req.stats.finish_t = clock.monotonic()
            req.stats.finish_reason = finished
            self._m_reqs.labels(reason=finished).inc()
            self._m_queue.observe(max(req.stats.queue_wait, 0.0))
            self._slot_spans(slot_i, req, finished)
            self.done.append(req)
            slot.req = None
            self.engine.free_slot(slot_i)

    def _slot_spans(self, slot_i: int, req: Request, reason: str) -> None:
        """The finished request's timestamps as slot spans: the stats stay
        authoritative, the spans are derived, never measured again."""
        st, tr = req.stats, self.tracer
        if not tr.enabled or req.trace is None:
            return
        tr.add("slot.queue_wait", max(st.admit_t - st.submit_t, 0.0),
               parent=req.trace, t0=st.submit_t, slot=slot_i)
        tr.add("slot.prefill", max(st.first_token_t - st.admit_t, 0.0),
               parent=req.trace, t0=st.admit_t, slot=slot_i,
               component="p_decode", prompt_tokens=st.prompt_tokens,
               resumed=req.cache1 is not None)
        tr.add("slot.decode", max(st.finish_t - st.first_token_t, 0.0),
               parent=req.trace, t0=st.first_token_t, slot=slot_i,
               component="r_decode", tokens=len(st.output_tokens),
               reason=reason)

    def _admit(self) -> None:
        """Fill free slots from the queue (FIFO), prefill, emit first
        tokens. Fresh prompts go through one batched prefill; resume and
        adopt requests take the per-slot paths."""
        fresh: List[int] = []
        eng = self.engine
        while self.queue and any(s.free for s in self.slots):
            slot_i = next(i for i, s in enumerate(self.slots) if s.free)
            req = self.queue.popleft()
            self.slots[slot_i].req = req
            req.stats.admit_t = clock.monotonic()
            n = int(np.size(req.tokens))
            if req.prefix_logits is not None and req.cache1 is not None:
                # full prompt-cache hit: zero prefill compute
                eng.adopt_slot(slot_i, req.cache1, n)
                self._set_logits(slot_i, req.prefix_logits[0])
            elif req.cache1 is not None:
                # no stored logits: a K/V cache recomputes the last prompt
                # token at least (the edge client's matched - 1 resume); a
                # recurrent state already holds every prefix token, so it
                # resumes at n_prefix and never runs one twice
                if eng.model.has_recurrent_state:
                    start = req.n_prefix
                    if start >= n:
                        raise ValueError(
                            "a recurrent state of the whole prompt needs "
                            "its logits (prefix_logits) to be adopted")
                else:
                    start = min(req.n_prefix, n - 1)
                suffix = np.asarray(req.tokens)[start:]
                lg = eng.prefill_slot(slot_i, suffix, req.cache1, start)
                self._set_logits(slot_i, lg[0])
            else:
                fresh.append(slot_i)
        if fresh:
            rows = [np.asarray(self.slots[i].req.tokens) for i in fresh]
            logits = eng.prefill_slots(fresh, rows)
            for j, slot_i in enumerate(fresh):
                self._set_logits(slot_i, logits[j])
                if self.on_prefill is not None:
                    self.on_prefill(slot_i, self.slots[slot_i].req,
                                    logits[j])
        # the first token of every newly admitted request comes from its
        # prefill (or adopted) logits
        for slot_i in self._admitted_waiting_first_token():
            tok = greedy(self._last_logits[slot_i][None])[0]
            self._emit(slot_i, int(tok))

    def _set_logits(self, slot_i: int, row: np.ndarray) -> None:
        if self._last_logits.shape[1] != row.shape[-1]:
            self._last_logits = np.zeros(
                (self.engine.batch_size, row.shape[-1]), np.float32)
        self._last_logits[slot_i] = row

    def _admitted_waiting_first_token(self) -> List[int]:
        return [i for i, s in enumerate(self.slots)
                if not s.free and not s.req.stats.output_tokens]

    def _decode_step(self) -> None:
        active = np.array([not s.free for s in self.slots])
        if not active.any():
            return
        tokens = np.zeros(self.engine.batch_size, np.int32)
        for i, s in enumerate(self.slots):
            if not s.free:
                tokens[i] = s.req.stats.output_tokens[-1]
        logits = self.engine.decode_batch(tokens, active)
        self.n_steps += 1
        sampled = greedy(logits)
        for i, s in enumerate(self.slots):
            if not s.free:
                self._set_logits(i, logits[i])
                self._emit(i, int(sampled[i]))

    # ------------------------------------------------------------------
    def step(self) -> None:
        """One scheduling iteration: admit (prefill) then decode."""
        self._admit()
        self._decode_step()

    def run(self, requests: Optional[Sequence[Request]] = None
            ) -> Dict[int, RequestStats]:
        """Drain ``requests`` plus anything already queued; returns
        {req_id: RequestStats} for every completed request."""
        for r in (requests or []):
            self.submit(r)
        t0 = clock.monotonic()
        while self.has_work:
            self.step()
        self.wall_s = clock.monotonic() - t0
        return {r.req_id: r.stats for r in self.done}

    def report(self) -> ServingReport:
        return ServingReport.from_requests(
            [r.stats for r in self.done], getattr(self, "wall_s", 0.0))
