"""The gateway's engine thread: the only thread that touches a tensor.

The port's counterpart of ``repro.gateway.engine``. The asyncio HTTP
server parses, validates and admits requests, then hands
:class:`GatewayJob` objects to one :class:`GatewayEngine` thread, which
builds and owns the :class:`~repro_torch.serving.engine.BatchedEngine`
and the continuous-batching
:class:`~repro_torch.serving.scheduler.Scheduler`. Tokens flow back
through per-request asyncio queues (``loop.call_soon_threadsafe``): the
event loop never waits on the device, and the device sees one thread.
The pool's decode kernels reserve their arrival counters on this thread's
stream when the engine is built, and every launch runs on it.

The prompt cache is resolved *blocking*, as the reference does: the
scheduler's per-slot resume takes a restored cache, not a chunk stream,
so ``FetchPolicy(transfer='streamed')`` (or any ``overlap``) is refused
at construction.

* before submit, :class:`PrefixFetcher` resolves the longest cached
  prefix through the fabric (a directory plan with the broker's dedup
  and the request's deadline, or the single box's catalog); the blob is
  parsed and restored on this thread, so every live slot waits for it,
  and the request resumes from it (a full hit adopts the slot);
* on a complete miss the scheduler's ``on_prefill`` hook fires while
  the slot still holds the state: the ranges are extracted to host
  bytes here (``extract_state_ranges``, ``pack_container``), before the
  slot can be freed and reused, and a background uploader thread ships
  the bytes. It never sees a tensor.

A model with a recurrent state (an SSM) uploads only its whole prompt's
range: a shorter range's state cannot be cut from the final one.

Tracing: the HTTP thread opens each request's ``gw.request`` root span
and hands its context over in the job (``GatewayJob.span``); on this
thread the resolve runs under a ``gw.resolve`` child (the fetcher hands
the span on, explicitly, to the broker's GET thread, so the directory's
``net.get`` span and the daemon's folded spans join the tree), and the
scheduler adds the slot spans at finish from the request's timestamps. A
span holds numbers and strings only: none touches a tensor.

Decision ledger: the resolve's plan opens a record, the fetcher notes
its attempts, and the record is committed when the request finishes,
when the realized prefill is known. The gateway's planner has no perf
model, so a complete miss's prefill (admission to first token) teaches
the ledger its local baseline. The request id is an alias of the trace
and of the record.
"""
from __future__ import annotations

import itertools
import queue
import threading
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import clock
from repro_torch.config import CacheConfig
from repro_torch.core import state_io
from repro_torch.core.catalog import Catalog
from repro_torch.core.cluster.directory import PeerDirectory
from repro_torch.core.cluster.planner import FetchAttempt, FetchPlanner
from repro_torch.core.deadline import attach as deadline_attach
from repro_torch.core.deadline import current_deadline, deadline_scope
from repro_torch.core.fetch_policy import FetchPolicy
from repro_torch.core.keys import model_meta
from repro_torch.core.metrics import ServingReport, merge_peer_stats
from repro_torch.core.session_pool import FetchBroker
from repro_torch.core.transport import TransportError
from repro_torch.device import dtype_name
from repro_torch.gateway.protocol import ParsedRequest
from repro_torch.obs.flight import CHUNK_ERROR, FLIGHT
from repro_torch.obs.ledger import LEDGER, LEDGER_KEY
from repro_torch.obs.metrics import DEFAULT_BUCKETS, REGISTRY
from repro_torch.obs.trace import NULL_SPAN, NULL_TRACER, Tracer, current_span
from repro_torch.serving.engine import BatchedEngine
from repro_torch.serving.scheduler import Request, Scheduler

TIMING_SAMPLES = 4096              # per-iteration timings kept (newest)


class GatewayClosed(Exception):
    """Submit after stop() or the engine's death."""


class GatewayJob:
    """One admitted request between the event loop and the engine thread.
    Events pushed to ``q`` (thread-safe, ``call_soon_threadsafe``):
    ``("token", id)``, ``("done", reason, meta)``, ``("error", message)``."""

    _ids = itertools.count()

    def __init__(self, parsed: ParsedRequest, segments, loop, q):
        self.parsed = parsed
        self.segments = segments
        self.loop = loop
        self.q = q
        self.rid = f"cmpl-{next(self._ids)}"
        self.created = int(clock.wall())
        self.matched = 0
        self.served_by = ""
        # the ledger handoff: the record the resolve's plan opened, the
        # broker leader's record when the GET was shared, and the winning
        # GET's seconds (committed at finish)
        self.decision = None
        self.dedup_of = None
        self.fetch_s = 0.0
        # the root span, opened and ended by the HTTP thread; the engine
        # thread parents on ``span.ctx``
        self.span = None

    def push(self, event: tuple) -> None:
        try:
            self.loop.call_soon_threadsafe(self.q.put_nowait, event)
        except RuntimeError:
            pass                       # the loop is closed (shutdown)


class PrefixFetcher:
    """Blocking prompt-cache resolve and upload against one fabric view.

    ``view`` is what ``fabric.directory()`` returned: a
    :class:`PeerDirectory` (multi-peer) or an ``InProcTransport`` (the
    single box, its catalog kept here). :meth:`resolve` runs on the
    engine thread; the GET itself runs on the broker's helper thread
    while the restore template is allocated here. :meth:`upload` packs
    the blobs here and queues their bytes for the uploader thread.
    """

    def __init__(self, model, max_len: int, view, cache_cfg: CacheConfig,
                 tracer: Optional[Tracer] = None):
        self.tracer = tracer or NULL_TRACER
        self.model = model
        self.max_len = max_len
        self.cache_cfg = cache_cfg
        self.meta = model_meta(model.cfg, dtype_name(model.dtype))
        self.directory = view if isinstance(view, PeerDirectory) else None
        self.transport = None if self.directory is not None else view
        self.catalog = Catalog(cache_cfg)
        self.clock = getattr(view, "clock", None)
        self.planner = FetchPlanner(
            self.directory, model.cfg, None,
            dtype_bytes=model.dtype.itemsize,
            chunk_layers=cache_cfg.chunk_layers) \
            if self.directory is not None else None
        if self.planner is not None:
            self.planner.owner = "gateway"
        # (record, dedup_of, GET seconds) of the last resolve, for the
        # engine thread to hand to the job
        self.last_decision = (None, None, 0.0)
        self.broker = FetchBroker()
        self._uploaded: "OrderedDict[bytes, None]" = OrderedDict()
        self.last_upload_error = ""
        self.stats = {"resolves": 0, "hits": 0, "full_hits": 0,
                      "false_positives": 0, "unreadable": 0,
                      "bytes_down": 0, "bytes_up": 0, "uploads": 0,
                      "upload_errors": 0}
        # (end on clock.monotonic, wall seconds) of each GET and of each
        # hit's restore on the engine thread (parse and place), newest
        # TIMING_SAMPLES
        self.fetch_s: "deque[Tuple[float, float]]" = \
            deque(maxlen=TIMING_SAMPLES)
        self.restore_s: "deque[Tuple[float, float]]" = \
            deque(maxlen=TIMING_SAMPLES)
        self._upq: "queue.Queue" = queue.Queue()
        self._uploader = threading.Thread(target=self._upload_loop,
                                          daemon=True, name="gw-uploader")
        self._uploader.start()

    # ------------------------------------------------------------------
    def _template(self):
        return self.model.init_cache(1, self.model.cache_len(self.max_len))

    def sync(self) -> None:
        now = self.clock.now() if self.clock is not None \
            else clock.monotonic()
        if self.directory is not None:
            self.directory.maybe_sync(now)
            return
        try:
            self.catalog.maybe_sync(self.transport, now)
        except TransportError as e:    # a stale catalog degrades to misses
            FLIGHT.record("catalog.sync_failed", client="gateway",
                          error=repr(e))

    # ------------------------------------------------------------------
    def resolve(self, segments) -> Tuple[object, int, object, str]:
        """The longest usable cached prefix of this prompt: ``(cache1,
        matched_tokens, logits, served_by)``, or ``(None, 0, None, "")``
        on a miss. A dead peer, a spent deadline, a missing blob (a
        false positive) or an unreadable one falls to the next attempt."""
        self.stats["resolves"] += 1
        cc = self.cache_cfg
        keys = segments.keys(self.meta, cc.max_ranges, cc.range_stride)
        n = len(segments.token_ids)
        ddl = current_deadline()
        if self.directory is not None:
            plan = self.planner.plan(keys, n, min_match=cc.min_match_tokens,
                                     deadline_s=ddl.remaining()
                                     if ddl is not None else None)
        else:
            plan = [FetchAttempt(None, k) for k in keys
                    if k.n_tokens >= cc.min_match_tokens
                    and self.catalog.lookup(k.digest)]
        recurrent = self.model.has_recurrent_state
        rec = self.planner.last_decision if self.planner is not None \
            else None
        self.last_decision = (rec, None, 0.0)
        for att in plan:
            peer = att.peer_id or "server"
            if ddl is not None and att.est_fetch_s >= ddl.remaining():
                # the budget cannot cover the GET
                LEDGER.note_attempt(rec, peer=peer,
                                    range_tokens=att.key.n_tokens,
                                    result="deadline",
                                    est_fetch_s=att.est_fetch_s)
                FLIGHT.record("fetch.deadline_skip", client="gateway",
                              peer=peer, est_fetch_s=att.est_fetch_s,
                              remaining_s=ddl.remaining())
                continue
            t0 = clock.monotonic()
            resp, dt, _, shared, template = self._get(att)
            t1 = clock.monotonic()
            self.fetch_s.append((t1, t1 - t0))
            hit = bool(resp.get("ok") and resp.get("blob"))
            result = ("dead" if resp.get("dead") else "hit" if hit
                      else "deadline" if resp.get("deadline_exceeded")
                      else "miss")
            LEDGER.note_attempt(rec, peer=peer,
                                range_tokens=att.key.n_tokens, result=result,
                                est_fetch_s=att.est_fetch_s, actual_s=dt,
                                shared=shared)
            FLIGHT.record("fetch.attempt", client="gateway", peer=peer,
                          range_tokens=att.key.n_tokens, kind=result)
            if result in ("dead", "deadline"):
                continue               # next attempt; never a hang
            if self.directory is not None and not shared:
                # every planned attempt was predicted present: a miss is
                # a stale-catalog false positive
                self.directory.record_get(
                    att.peer_id, hit, att.est_fetch_s, dt,
                    len(resp["blob"]) if hit else 0,
                    predicted_present=True)
            if not hit:
                self.stats["false_positives"] += 1
                continue
            blob = resp["blob"]
            tr = clock.monotonic()
            try:
                payload = state_io.parse_state(blob, self.meta)
                if recurrent and not payload.get("logits"):
                    continue           # a state cannot re-run its last token
                cache, _, logits = state_io.restore_state(
                    payload, template if template is not None
                    else self._template())
            except ValueError as e:    # ChunkError too: a miss
                self.stats["unreadable"] += 1
                FLIGHT.trigger(CHUNK_ERROR, client="gateway", peer=peer,
                               key=att.key.digest.hex(), error=repr(e))
                continue
            t1 = clock.monotonic()
            self.restore_s.append((t1, t1 - tr))
            if not shared:
                self.stats["bytes_down"] += len(blob)
                if att.peer_id is not None:
                    self.directory.note_fetch(att.key.digest, len(blob),
                                              att.peer_id, lambda: blob)
            if rec is not None:
                # a shared GET belongs to the leader's record: link to it
                if shared:
                    self.last_decision = (rec, resp.get(LEDGER_KEY), dt)
                else:
                    resp[LEDGER_KEY] = rec["id"]
                    self.last_decision = (rec, None, dt)
            self.stats["hits"] += 1
            if att.key.n_tokens == n:
                self.stats["full_hits"] += 1
            return cache, att.key.n_tokens, logits, peer
        return None, 0, None, ""

    def _get(self, att: FetchAttempt):
        """The GET through the broker: issued on its helper thread (which
        carries the deadline and the caller's span over), the template
        allocated here."""
        ddl = current_deadline()
        caller = current_span()
        if att.peer_id is not None:
            def issue():
                with self.tracer.attach(caller), deadline_attach(ddl):
                    return self.directory.request(att.peer_id, "get",
                                                  {"key": att.key.digest})
            key = (att.peer_id, att.key.digest)
        else:
            def issue():
                with self.tracer.attach(caller), deadline_attach(ddl):
                    return self.transport.request("get",
                                                  {"key": att.key.digest})
            key = att.key.digest
        return self.broker.fetch(key, issue, prep=self._template)

    # ------------------------------------------------------------------
    def upload(self, segments, cache1, logits) -> int:
        """Extract this prompt's range states to host bytes (one
        serialization pass, on the engine thread: the slot is read here,
        before it can be reused) and queue them for the uploader. Ranges
        this gateway already shipped are skipped: N identical cold
        prompts cost one upload. Returns the bytes queued."""
        cc = self.cache_cfg
        n = len(segments.token_ids)
        keys = [k for k in segments.keys(self.meta, cc.max_ranges,
                                         cc.range_stride)
                if k.digest not in self._uploaded
                and (k.n_tokens == n or not self.model.has_recurrent_state)]
        if not keys:
            return 0
        per_key = {k.digest: self.model.cache_len(k.n_tokens) for k in keys}
        chunk_lists = state_io.extract_state_ranges(
            cache1, sorted(set(per_key.values())), self.meta,
            logits=(logits if any(k.n_tokens == n for k in keys) else None),
            compress=cc.compress, level=cc.compress_level,
            quantize=cc.quantize, codec=cc.compress_codec,
            chunk_layers=cc.chunk_layers)
        blobs = []
        for k in keys:
            blobs.append((k.digest, state_io.pack_container(
                chunk_lists[per_key[k.digest]])))
            self._uploaded[k.digest] = None
            while len(self._uploaded) > 4096:
                self._uploaded.popitem(last=False)
        self._upq.put(blobs)
        return sum(len(b) for _, b in blobs)

    def _upload_loop(self) -> None:
        while True:
            blobs = self._upq.get()
            try:
                if blobs is None:
                    return
                for digest, blob in blobs:
                    self._put(digest, blob)
            finally:
                self._upq.task_done()

    def _put(self, digest: bytes, blob: bytes) -> None:
        """One upload, best effort (on the uploader thread)."""
        try:
            if self.directory is not None:
                self.stats["bytes_up"] += self.directory.upload(digest, blob)
            else:
                resp, _, _ = self.transport.request(
                    "put", {"key": digest, "blob": blob},
                    advance_clock=False)
                if resp.get("stored", True):
                    self.catalog.register(digest)
                    self.stats["bytes_up"] += len(blob)
            self.stats["uploads"] += 1
        except TransportError as e:    # best effort: counted, not raised
            self.stats["upload_errors"] += 1
            self.last_upload_error = repr(e)
            FLIGHT.record("gw.upload_failed", error=repr(e))

    def flush_uploads(self, timeout_s: float = 10.0) -> bool:
        """Wait until every queued upload has drained; False at the
        timeout."""
        deadline = clock.monotonic() + timeout_s
        with self._upq.all_tasks_done:
            while self._upq.unfinished_tasks:
                remaining = deadline - clock.monotonic()
                if remaining <= 0:
                    return False
                self._upq.all_tasks_done.wait(remaining)
        return True

    def close(self) -> None:
        self._upq.put(None)

    def peer_stats(self):
        if self.directory is None:
            return {}
        return merge_peer_stats([self.directory.peer_stats()],
                                estimator=self.directory.estimator)


class GatewayEngine:
    """The single-threaded serving core behind the HTTP front door.

    ``start()`` spawns the engine thread, which builds the
    :class:`BatchedEngine`, the scheduler and the fabric view, then
    drains the job inbox: resolve prefix, submit, step, publish new
    tokens. A failure while building raises out of ``start()``.
    ``stop()`` joins the thread and drains the uploads. One ``tracer``
    (``Tracer(proc="gateway")``) serves the whole gateway: the HTTP
    thread, this thread, the scheduler and the fetcher mint their spans
    in it, so ``GET /v1/traces/<id>`` finds one tree.
    """

    def __init__(self, model, batch_size: int = 4, max_len: int = 512,
                 fabric=None, cache_cfg: CacheConfig = CacheConfig(),
                 policy: Optional[FetchPolicy] = None, admission=None):
        if policy is None:
            policy = FetchPolicy(transfer="blocking")
        if policy.transfer != "blocking" or policy.overlap:
            raise ValueError(
                "GatewayEngine requires FetchPolicy(transfer='blocking',"
                " overlap=False): the batched scheduler restores cached"
                " prefixes whole before slot adoption")
        self.model = model
        self.batch_size = batch_size
        self.max_len = max_len
        self.fabric = fabric
        self.cache_cfg = cache_cfg
        self.policy = policy
        self.admission = admission
        self.tracer = Tracer(proc="gateway", max_traces=128)
        self._m_ttft = REGISTRY.histogram(
            "gateway_ttft_seconds", "submit-to-first-token per request",
            buckets=DEFAULT_BUCKETS)
        self._m_latency = REGISTRY.histogram(
            "gateway_request_seconds", "submit-to-finish per request")
        self._m_done = REGISTRY.counter(
            "gateway_requests_finished_total",
            "requests finished by the engine", ("reason",))
        self.inbox: "queue.Queue[GatewayJob]" = queue.Queue()
        self._live: Dict[int, List] = {}      # req_id -> [job, req, sent]
        self._stop = threading.Event()
        self.ready = threading.Event()
        self.startup_error: Optional[BaseException] = None
        self.engine: Optional[BatchedEngine] = None
        self.fetcher: Optional[PrefixFetcher] = None
        self.sched: Optional[Scheduler] = None
        self._thread: Optional[threading.Thread] = None
        self._t0 = 0.0
        # (end on clock.monotonic, wall seconds) of each loop iteration
        # that stepped the scheduler (the inbox drained, prefixes
        # resolved, then one step), with a hit's restore in it
        # (step_after_restore_s) or without (step_s): the gap a hit puts
        # between the live slots' decode steps
        self.step_s: "deque[Tuple[float, float]]" = \
            deque(maxlen=TIMING_SAMPLES)
        self.step_after_restore_s: "deque[Tuple[float, float]]" = \
            deque(maxlen=TIMING_SAMPLES)

    # ------------------------------------------------------------------
    def start(self, timeout_s: float = 120.0) -> "GatewayEngine":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="gateway-engine")
        self._thread.start()
        self.ready.wait(timeout_s)
        if self.startup_error is not None:
            raise self.startup_error
        if not self.ready.is_set():
            raise TimeoutError("gateway engine failed to start")
        return self

    def stop(self, timeout_s: float = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout_s)
        if self.fetcher is not None:
            self.fetcher.flush_uploads(timeout_s)
            self.fetcher.close()

    @property
    def alive(self) -> bool:
        return (self._thread is not None and self._thread.is_alive()
                and not self._stop.is_set())

    def submit(self, job: GatewayJob) -> None:
        if not self.alive:
            raise GatewayClosed("gateway engine is not running")
        self.inbox.put(job)

    # ------------------------------------------------------------------
    def _run(self) -> None:
        try:
            self.engine = BatchedEngine(self.model, self.max_len,
                                        self.batch_size)
            self.sched = Scheduler(self.engine, on_prefill=self._on_prefill,
                                   tracer=self.tracer)
            if self.fabric is not None:
                self.fetcher = PrefixFetcher(self.model, self.max_len,
                                             self.fabric.directory(),
                                             self.cache_cfg,
                                             tracer=self.tracer)
        except BaseException as e:     # noqa: BLE001 - raised by start()
            self.startup_error = e
            self.ready.set()
            return
        self.ready.set()
        self._t0 = clock.monotonic()
        while not self._stop.is_set():
            t0 = clock.monotonic()
            n_hits = self.fetcher.stats["hits"] if self.fetcher else 0
            drained = self._drain_inbox()
            if self.sched.has_work:
                restored = self.fetcher is not None and \
                    self.fetcher.stats["hits"] != n_hits
                try:
                    self.sched.step()
                except Exception as e:        # a broken step fails every
                    self._fail_all(repr(e))   # live request, not the
                    continue                  # whole gateway
                t1 = clock.monotonic()
                (self.step_after_restore_s if restored else
                 self.step_s).append((t1, t1 - t0))
                self._publish()
            elif not drained:
                try:
                    self._start_job(self.inbox.get(timeout=0.05))
                except queue.Empty:
                    continue
        self._fail_all("gateway shutting down")

    def _drain_inbox(self) -> bool:
        drained = False
        while True:
            try:
                job = self.inbox.get_nowait()
            except queue.Empty:
                return drained
            self._start_job(job)
            drained = True

    def _start_job(self, job: GatewayJob) -> None:
        try:
            segs = job.segments
            n = len(segs.token_ids)
            pctx = getattr(job.span, "ctx", None)
            cache1, matched, logits, served = None, 0, None, ""
            if self.fetcher is not None:
                rs = self.tracer.start("gw.resolve", parent=pctx, attrs={
                    "prompt_tokens": n}) if pctx is not None else NULL_SPAN
                # ambient: the GET's spans nest here; the request's budget
                # (wire extension ``deadline_s``) scopes the resolve: the
                # plan prunes against it and the peers see what is left
                with rs, deadline_scope(job.parsed.deadline_s):
                    self.fetcher.sync()
                    cache1, matched, logits, served = \
                        self.fetcher.resolve(segs)
                    rs.set(matched=matched, served_by=served)
            req = Request(
                tokens=np.asarray(segs.token_ids, np.int32),
                max_new_tokens=job.parsed.max_tokens,
                tenant=job.parsed.tenant,
                cache1=cache1, n_prefix=matched,
                # a partial hit resumes from ``matched`` and recomputes
                # the suffix; only a full hit skips the prefill
                prefix_logits=(logits if matched == n
                               and logits is not None else None),
                trace=pctx)
            rid = self.sched.submit(req)
            if pctx is not None:       # the request id finds the trace
                self.tracer.alias(job.rid, pctx.trace_id)
            job.matched, job.served_by = matched, served
            if self.fetcher is not None:
                job.decision, job.dedup_of, job.fetch_s = \
                    self.fetcher.last_decision
                if job.decision is not None:     # and the record
                    LEDGER.alias(job.rid, job.decision["id"])
            self._live[rid] = [job, req, 0]
        except Exception as e:         # answered as the request's error
            if self.admission is not None:
                self.admission.release(job.parsed.tenant)
            job.push(("error", repr(e)))

    def _on_prefill(self, slot_i: int, req: Request, logits_row) -> None:
        """A fresh prefill is a complete miss: publish its ranges."""
        if self.fetcher is None or not self.policy.upload_on_miss:
            return
        entry = self._live.get(req.req_id)
        if entry is None or entry[0].matched:
            return
        try:
            self.fetcher.upload(entry[0].segments,
                                self.engine.slot_cache(slot_i),
                                np.asarray(logits_row)[None])
        except ValueError:             # an unserializable state: the
            self.fetcher.stats["upload_errors"] += 1   # request serves on

    def _publish(self) -> None:
        finished = []
        for rid, entry in self._live.items():
            job, req, _sent = entry
            toks = req.stats.output_tokens
            while entry[2] < len(toks):
                job.push(("token", int(toks[entry[2]])))
                entry[2] += 1
            if req.stats.finish_t:
                lat = req.stats.finish_t - req.stats.submit_t
                if self.admission is not None:
                    self.admission.release(job.parsed.tenant, lat)
                self._m_ttft.observe(req.stats.ttft)
                self._m_latency.observe(lat)
                self._commit_decision(job, req, lat)
                self._m_done.labels(reason=req.stats.finish_reason).inc()
                job.push(("done", req.stats.finish_reason,
                          {"matched_tokens": job.matched,
                           "served_by": job.served_by,
                           "ttft_s": req.stats.ttft,
                           "latency_s": lat,
                           "trace_id": getattr(job.span, "trace_id", "")}))
                finished.append(rid)
        for rid in finished:
            del self._live[rid]

    def _commit_decision(self, job: GatewayJob, req: Request,
                         lat: float) -> None:
        """Close the job's record with the realized outcome: the wall
        prefill from admission to the first token; a complete miss's
        teaches the ledger its per-token local baseline."""
        rec = job.decision
        if rec is None:
            return
        st = req.stats
        first = st.first_token_t or st.finish_t
        prefill_s = max(first - st.admit_t, 0.0) if st.admit_t else 0.0
        n = st.prompt_tokens
        if job.matched > 0:
            LEDGER.commit(rec, chosen=job.served_by or None,
                          result="hit" if job.matched >= n else "partial",
                          fetch_s=job.fetch_s,
                          suffix_s=prefill_s if job.matched < n else 0.0,
                          dedup_of=job.dedup_of, ttft_s=st.ttft,
                          latency_s=lat)
        else:
            LEDGER.note_prefill(n, prefill_s)
            LEDGER.commit(rec, chosen=None, result="local",
                          local_prefill_s=prefill_s, ttft_s=st.ttft,
                          latency_s=lat)

    def _fail_all(self, message: str) -> None:
        for job, _req, _sent in list(self._live.values()):
            if self.admission is not None:
                self.admission.release(job.parsed.tenant)
            job.push(("error", message))
        self._live.clear()

    # ------------------------------------------------------------------
    def report(self) -> ServingReport:
        """Completed-request percentiles by tenant, shed counts from
        admission and the fabric's per-peer stats."""
        reqs = [r.stats for r in self.sched.done] \
            if self.sched is not None else []
        wall = (clock.monotonic() - self._t0) if self._t0 else 0.0
        shed = self.admission.shed_counts() \
            if self.admission is not None else {}
        per_peer = self.fetcher.peer_stats() \
            if self.fetcher is not None else {}
        return ServingReport.from_requests(reqs, wall, per_peer=per_peer,
                                           shed=shed)
