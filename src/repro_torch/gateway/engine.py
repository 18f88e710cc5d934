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

Not ported (ROADMAP Queue 1, item 7.5): the tracer (request, resolve and
slot spans, ``trace_id``) and the decision ledger.
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
from repro_torch.obs.metrics import DEFAULT_BUCKETS, REGISTRY
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

    def __init__(self, model, max_len: int, view, cache_cfg: CacheConfig):
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
        except TransportError:
            return                     # a stale catalog degrades to misses

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
        for att in plan:
            if ddl is not None and att.est_fetch_s >= ddl.remaining():
                continue               # the budget cannot cover the GET
            t0 = clock.monotonic()
            resp, dt, _, shared, template = self._get(att)
            t1 = clock.monotonic()
            self.fetch_s.append((t1, t1 - t0))
            hit = bool(resp.get("ok") and resp.get("blob"))
            if resp.get("dead") or resp.get("deadline_exceeded"):
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
            except ValueError:         # ChunkError too: a miss
                self.stats["unreadable"] += 1
                continue
            t1 = clock.monotonic()
            self.restore_s.append((t1, t1 - tr))
            if not shared:
                self.stats["bytes_down"] += len(blob)
                if att.peer_id is not None:
                    self.directory.note_fetch(att.key.digest, len(blob),
                                              att.peer_id, lambda: blob)
            self.stats["hits"] += 1
            if att.key.n_tokens == n:
                self.stats["full_hits"] += 1
            return cache, att.key.n_tokens, logits, att.peer_id or "server"
        return None, 0, None, ""

    def _get(self, att: FetchAttempt):
        """The GET through the broker: issued on its helper thread (which
        carries the deadline over), the template allocated here."""
        ddl = current_deadline()
        if att.peer_id is not None:
            def issue():
                with deadline_attach(ddl):
                    return self.directory.request(att.peer_id, "get",
                                                  {"key": att.key.digest})
            key = (att.peer_id, att.key.digest)
        else:
            def issue():
                with deadline_attach(ddl):
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
    ``stop()`` joins the thread and drains the uploads.
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
            self.sched = Scheduler(self.engine, on_prefill=self._on_prefill)
            if self.fabric is not None:
                self.fetcher = PrefixFetcher(self.model, self.max_len,
                                             self.fabric.directory(),
                                             self.cache_cfg)
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
            cache1, matched, logits, served = None, 0, None, ""
            if self.fetcher is not None:
                # the request's budget (wire extension ``deadline_s``)
                # scopes the resolve: the plan prunes against it and the
                # peers see what is left
                with deadline_scope(job.parsed.deadline_s):
                    self.fetcher.sync()
                    cache1, matched, logits, served = \
                        self.fetcher.resolve(segs)
            req = Request(
                tokens=np.asarray(segs.token_ids, np.int32),
                max_new_tokens=job.parsed.max_tokens,
                tenant=job.parsed.tenant,
                cache1=cache1, n_prefix=matched,
                # a partial hit resumes from ``matched`` and recomputes
                # the suffix; only a full hit skips the prefill
                prefix_logits=(logits if matched == n
                               and logits is not None else None))
            rid = self.sched.submit(req)
            job.matched, job.served_by = matched, served
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
                self._m_done.labels(reason=req.stats.finish_reason).inc()
                job.push(("done", req.stats.finish_reason,
                          {"matched_tokens": job.matched,
                           "served_by": job.served_by,
                           "ttft_s": req.stats.ttft,
                           "latency_s": lat}))
                finished.append(rid)
        for rid in finished:
            del self._live[rid]

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
