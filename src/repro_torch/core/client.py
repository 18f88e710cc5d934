"""Edge client — the paper's inference procedure (§3.1 Steps 1-4, §3.2).

The port's counterpart of ``repro.core.client.EdgeClient``. Given a
structured prompt, the client

  1. derives the prefix-range keys, longest range first;
  2. probes its catalog for them (ranges shorter than
     ``min_match_tokens`` are never fetched) and turns the result into a
     plan of fetch attempts;
  3. walks the plan: a Bloom false positive (no blob), an unreadable
     blob or a dead peer falls through to the next attempt, then to
     local prefill (§3.3: latency, never correctness);
  4. on a hit restores the state: a full hit with logits is adopted with
     no model call, a partial hit resumes prefill for the suffix; on a
     miss it prefills the whole prompt and uploads a v3 ``PC3`` container
     per range, all ranges of a K/V or latent cache from one
     serialization pass;
  5. decodes the response greedily.

``transport`` is one of

* a :class:`~repro_torch.core.server.CacheServer`, wrapped in an
  :class:`~repro_torch.core.transport.InProcTransport` that reports wall
  seconds;
* a transport: an ``InProcTransport`` (with a ``SimNetwork``: modeled
  Wi-Fi seconds on a ``SimClock``) or a
  :class:`~repro_torch.core.transport.TCPTransport` to one real server;
* a :class:`~repro_torch.core.cluster.PeerDirectory` (the multi-peer
  fabric): the probe consults one catalog a peer, a
  :class:`~repro_torch.core.cluster.FetchPlanner` orders the (peer,
  range) attempts by estimated fetch and recompute time, uploads go by
  consistent-hash placement, and each attempt feeds the directory's
  per-peer stats, link estimator, read repair and hot-key replication.

``use_catalog=False`` is the paper's §5.2.3 ablation: no catalog, every
range at least ``min_match_tokens`` long is asked for. A dead peer
(``TransportError``) costs one bounded fast fail, then the next
attempt, then local prefill.

A fetched blob that cannot be read (a corrupt or truncated container, a
``ZST`` blob where ``zstandard`` does not import, another model's blob)
is a miss: the request tries the next attempt, then prefills locally.
The reference lets that error out of ``infer``.

With ``overlap=True`` a partial hit streams: the blob's chunks arrive
one at a time (``get_chunks``, over TCP one frame a chunk) on a pump
thread that checks and decodes them, and the main thread runs the
suffix prefill one layer group at a time as each group's chunks are in
(``InferenceEngine.resume_streamed``). A v2 blob on the stream is
restored whole and resumed as usual.

A model whose cache is recurrent state (an SSM) differs in three ways:
its state is not cut to a prefix, so each shorter range's state is
rebuilt at upload time by prefilling boundary by boundary; every blob it
uploads carries its logits; and a blob without logits is not resumed at
``matched - 1`` (that would run the prefix's last token through the
state twice) but skipped like a miss. A K/V or latent blob without
logits resumes at ``matched - 1``.

Each result carries three accountings. ``timings`` holds wall seconds on
this process's clock, with the device synchronised at each step's end;
TTFT runs to the first output token's logits on the host, TTLT to the
last token. ``wall`` is the Table-3 ``Breakdown`` projected from the
request's span tree (``trace_id``; the client's tracer is on by
default): its ``bloom``, ``redis``, ``p_decode`` and ``r_decode`` spans
carry the same measured seconds as ``timings``' ``bloom_s``,
``fetch_s``, ``prefill_s`` and ``decode_s``, closed where the host
already waited for the device, so tracing adds no synchronisation and
no launch. ``sim`` is the paper's Table-3 ``Breakdown`` of an emulated
edge device (``perf``, a :class:`~repro_torch.core.perfmodel.DevicePerfModel`)
and the simulated Wi-Fi: modeled seconds, never a reading of this
machine, all 0 without a perf model and a simulated link. Uploads run
after the response, off its latency, as the paper's asynchronous uploads
are.

The fetch path's knobs are one validated
:class:`~repro_torch.core.fetch_policy.FetchPolicy` (``policy=``), or the
older ``overlap=`` / ``use_catalog=`` flags, never both. A
:class:`~repro_torch.core.session_pool.FetchBroker` (``broker=``) shares
one GET among concurrent sessions that want the same (peer, key). A
deadline (``infer(deadline_s=...)`` or an ambient
:func:`~repro_torch.core.deadline.deadline_scope`) prunes the plan,
skips attempts whose estimated fetch exceeds what is left, and rides
every payload to the peers. On a wall link without a broker, a single
GET that outlasts :meth:`PeerDirectory.hedge_delay_s` fires the plan's
next holder of the same range on another peer, and the first usable
response wins; a streamed fetch projected to overrun the deadline (or,
with a perf model, the local prefill it was priced against, without
one the decision ledger's learned local baseline) is cut by the cancel
frame.

On the fabric each plan opens a decision-ledger record
(:data:`~repro_torch.obs.ledger.LEDGER`); the walk notes every attempt
and commits the realized outcome (a complete miss without a perf model
also teaches the ledger its local prefill rate). Attempts, skips,
cancels and hedges are recorded in the flight recorder
(:data:`~repro_torch.obs.flight.FLIGHT`), and a plan whose every attempt
failed, or a blob that fails its digests, triggers a dump.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch import clock
from repro_torch.config import CacheConfig
from repro_torch.core import chunkfmt, sizing, state_io
from repro_torch.core.catalog import Catalog
from repro_torch.core.cluster.directory import PeerDirectory
from repro_torch.core.cluster.planner import FetchAttempt, FetchPlanner
from repro_torch.core.deadline import attach as deadline_attach
from repro_torch.core.deadline import current_deadline, deadline_scope
from repro_torch.core.fetch_policy import FetchPolicy
from repro_torch.core.keys import PromptKey, model_meta
from repro_torch.core.metrics import Breakdown
from repro_torch.core.perfmodel import DevicePerfModel
from repro_torch.core.segments import PromptSegments
from repro_torch.core.server import CacheServer
from repro_torch.core.transport import (InProcTransport, StreamCancelled,
                                        TransportError)
from repro_torch.device import dtype_name
from repro_torch.models.common import tree_map
from repro_torch.obs.flight import CHUNK_ERROR, FLIGHT, PLAN_EXHAUSTED
from repro_torch.obs.ledger import LEDGER, LEDGER_KEY
from repro_torch.obs.trace import Tracer, current_span
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.sampler import greedy

# the port's attempt kinds as the ledger names their results
_LEDGER_RESULT = {"unreadable": "corrupt", "skip": "miss"}


@dataclass
class InferResult:
    case: int                      # paper Cases 1-5
    matched_tokens: int
    prompt_tokens: int
    output_tokens: list
    ttft_s: float                  # wall: request start -> first token
    ttlt_s: float                  # wall: request start -> last token
    blob_bytes_down: int = 0
    blob_bytes_up: int = 0
    false_positive: bool = False   # catalog said yes, server said no
    unreadable_blobs: int = 0      # fetched blobs counted as misses
    streamed: bool = False         # the hit resumed layer group by group
    chunks_down: int = 0           # chunks of a streamed fetch
    timings: Dict[str, float] = field(default_factory=dict)
    sim: Breakdown = field(default_factory=Breakdown)   # modeled seconds
    served_by: str = ""            # fabric: the peer that served the hit
    shared_fetch: bool = False     # the hit rode another session's GET
    fetch_attempts: int = 0        # GETs tried (false positives, dead
    #                                peers, unreadable blobs and the hit)
    est_fetch_s: float = 0.0       # the planner's estimate of the hit
    actual_fetch_s: float = 0.0    # what the hit's fetch cost (sim/wall)
    extra: Dict[str, float] = field(default_factory=dict)
    wall: Breakdown = field(default_factory=Breakdown)  # from the spans
    trace_id: str = ""             # the span tree behind this result


class _StreamEnded(Exception):
    """The chunk stream stopped before every layer group arrived."""


class EdgeClient:
    def __init__(self, name: str, engine: InferenceEngine, transport,
                 cache_cfg: CacheConfig = CacheConfig(),
                 perf: Optional[DevicePerfModel] = None,
                 use_catalog: bool = True, perf_cfg=None,
                 overlap: bool = False,
                 policy: Optional[FetchPolicy] = None, broker=None,
                 tracer: Optional[Tracer] = None):
        if engine.model.cfg.family == "encdec":
            raise NotImplementedError(
                "EdgeClient does not serve an encoder-decoder: its prompt "
                "keys hash text tokens alone, so two audios with one "
                "prompt would share a key (the reference's client passes "
                "no frames and fails with KeyError: 'frames'); drive its "
                "InferenceEngine and state_io blobs directly")
        self.name = name
        # every request gets a span tree, and ``wall`` is its projection:
        # pass a shared tracer to stitch the client's spans into a larger
        # tree, or let each client keep its own bounded store
        self.tracer = tracer or Tracer(proc=f"client:{name}", max_traces=64)
        self.engine = engine
        if isinstance(transport, CacheServer):
            transport = InProcTransport(transport)
        self.transport = transport
        self.cache_cfg = cache_cfg
        self.perf = perf
        # a full-size config's sizes and compute for the sim accounting
        # while a reduced model runs
        self.perf_cfg = perf_cfg or engine.model.cfg
        if policy is None:
            policy = FetchPolicy(overlap=overlap, use_catalog=use_catalog)
        elif overlap or not use_catalog:
            raise ValueError(
                "pass either policy=FetchPolicy(...) or the legacy "
                "overlap=/use_catalog= flags, not both")
        self.policy = policy
        self.use_catalog = policy.use_catalog
        self.overlap = policy.overlap
        self.broker = broker
        self.hedges = self.hedge_wins = 0    # backups fired, and won
        self.stream_cancels = 0        # streams the watchdog cut
        self.catalog = Catalog(cache_cfg)
        self.directory = transport if isinstance(transport, PeerDirectory) \
            else None
        self.planner = None
        if self.directory is not None:
            emulated = self.perf_cfg is not engine.model.cfg
            self.planner = FetchPlanner(
                self.directory, self.perf_cfg, perf,
                dtype_bytes=2 if emulated else engine.cache_dtype.itemsize,
                overlap=self.overlap, chunk_layers=cache_cfg.chunk_layers)
            self.planner.owner = name
        # strict mode: a policy that requires streaming fails here, not on
        # the first partial hit
        policy.validate_for(engine, [ln.transport for ln in
                                     self.directory.links.values()]
                            if self.directory is not None else [transport])
        self.meta = model_meta(engine.model.cfg,
                               dtype_name(engine.cache_dtype))
        self.clock = getattr(transport, "clock", None)

    def sync_catalog(self) -> None:
        """Pull the catalog deltas (rate-limited). An unreachable server
        leaves the catalog stale: its lookups degrade into misses."""
        now = self.clock.now() if self.clock else clock.monotonic()
        if self.directory is not None:
            self.directory.maybe_sync(now)
            return
        try:
            self.catalog.maybe_sync(self.transport, now)
        except TransportError as e:    # stale until the next sync
            FLIGHT.record("catalog.sync_failed", client=self.name,
                          error=repr(e))

    # ------------------------------------------------------------------
    def infer(self, prompt: PromptSegments, max_new_tokens: int = 16,
              sampler: Callable = greedy, rng=None,
              upload_on_miss: Optional[bool] = None,
              deadline_s: Optional[float] = None) -> InferResult:
        """The paper's request. ``timings`` holds wall seconds: ``bloom_s``
        (probe and plan), ``fetch_s`` (transfer on the TTFT path, every
        attempt; for a streamed hit what of the stream's wall time was
        not compute), ``restore_s`` (checking, decoding and placing the
        blob; for a streamed hit, partly hidden), ``prefill_s``
        (compute), ``decode_s``, ``upload_s``; a streamed hit adds
        ``stream_s`` (the whole fetch and resume) and ``hidden_s``
        (transfer and restore seconds that ran while the suffix
        computed). ``sim`` holds the modeled Table-3 seconds.

        ``upload_on_miss`` defaults to the policy's. ``deadline_s`` is
        the request's latency budget (on the link's sim clock where there
        is one); an ambient ``deadline_scope`` applies the same way."""
        root = self.tracer.start("infer", attrs={
            "client": self.name, "prompt_tokens": len(prompt.token_ids)})
        with root, deadline_scope(deadline_s, clock=self.clock):
            res = self._infer(prompt, max_new_tokens, sampler, rng,
                              self.policy.upload_on_miss
                              if upload_on_miss is None else upload_on_miss)
        res.wall = Breakdown.from_spans(self.tracer.trace(root.trace_id)
                                        or [])
        res.trace_id = root.trace_id
        return res

    def _infer(self, prompt: PromptSegments, max_new_tokens: int,
               sampler: Callable, rng, upload_on_miss: bool) -> InferResult:
        t0 = clock.monotonic()
        cfg = self.perf_cfg
        n = len(prompt.token_ids)
        keys = prompt.keys(self.meta, self.cache_cfg.max_ranges,
                           self.cache_cfg.range_stride)
        tm = {"bloom_s": 0.0, "fetch_s": 0.0, "restore_s": 0.0,
              "prefill_s": 0.0, "decode_s": 0.0, "upload_s": 0.0}
        sim = Breakdown()
        model = self.engine.model
        recurrent = model.has_recurrent_state
        emulated = cfg is not model.cfg
        if self.perf:
            sim.token = self.perf.time_tokenize(n)

        # Step 2: catalog probe, longest range first; on the fabric the
        # planner orders the (peer, range) attempts
        min_match = self.cache_cfg.min_match_tokens \
            if self.policy.min_match_tokens is None \
            else self.policy.min_match_tokens
        ddl = current_deadline()
        if self.directory is not None:
            plan = self.planner.plan(keys, n, min_match=min_match,
                                     use_catalog=self.use_catalog,
                                     deadline_s=ddl.remaining()
                                     if ddl is not None else None)
            if self.perf and self.use_catalog:
                sim.bloom = self.perf.time_bloom(
                    len(keys) * max(len(self.directory.links), 1))
        elif self.use_catalog:
            plan = [FetchAttempt(None, k) for k in keys
                    if k.n_tokens >= min_match
                    and self.catalog.lookup(k.digest)]
            if self.perf:
                sim.bloom = self.perf.time_bloom(len(keys))
        else:                          # §5.2.3 ablation: ask the server
            plan = [FetchAttempt(None, k) for k in keys
                    if k.n_tokens >= min_match]
        tm["bloom_s"] = clock.monotonic() - t0
        tr = self.tracer
        tr.add("bloom", tm["bloom_s"], t0=t0, component="bloom",
               candidates=len(plan))
        # the record the planner just opened (the fabric only), closed
        # below with the realized outcome
        rec = self.planner.last_decision if self.planner is not None \
            else None
        dedup_of = None

        matched, false_pos, down_bytes, unreadable = 0, False, 0, 0
        state, st, got = None, None, None
        n_attempts, dead, dead_s, chunks_down = 0, 0, 0.0, 0
        served_by, est_fetch, actual_fetch, hit_dl_sim = "", 0.0, 0.0, 0.0
        shared = False
        for att in plan:               # best estimate first
            cand = att.key
            if ddl is not None and att.est_fetch_s >= ddl.remaining():
                # the rest of the budget cannot cover the transfer
                LEDGER.note_attempt(rec, peer=att.peer_id or "server",
                                    range_tokens=cand.n_tokens,
                                    result="deadline",
                                    est_fetch_s=att.est_fetch_s)
                FLIGHT.record("fetch.deadline_skip", client=self.name,
                              peer=att.peer_id or "server",
                              est_fetch_s=att.est_fetch_s,
                              remaining_s=ddl.remaining())
                continue
            n_attempts += 1
            net = self._link_net(att.peer_id)
            sim_link = self.clock is not None and net is not None
            got = None
            fetch0, restore0 = tm["fetch_s"], tm["restore_s"]
            # one span an attempt; the directory's net.<op> span and the
            # peer's folded spans nest under it
            with tr.start("redis.attempt", attrs={
                    "peer": att.peer_id or "server",
                    "range_tokens": cand.n_tokens,
                    "est_fetch_s": att.est_fetch_s}) as asp:
                if self.overlap and cand.n_tokens < n and \
                        self.policy.transfer != "blocking" and \
                        model.supports_layer_stream:
                    got = self._fetch_streamed(att, prompt, tm, net)
                if got is None:        # not streamed, or a broker follower
                    got = self._fetch(att, tm, net,
                                      self._hedge_candidate(plan, att))
                else:
                    chunks_down += got["chunks"]
                # the transfer on the TTFT path is this attempt's Table-3
                # redis share; the span also covers its restore
                asp.set(component="redis",
                        component_s=tm["fetch_s"] - fetch0,
                        restore_s=tm["restore_s"] - restore0,
                        result=got["kind"])
            att = got.get("att", att)  # a hedge's winner served it
            kind, arrived = got["kind"], got["arrived"]
            if sim_link:
                dl = 0.0 if got["shared"] else got["dt"]
                if emulated and kind != "dead" and not got["shared"]:
                    # only the full prompt's blob carries logits
                    nb_full = sizing.state_bytes(
                        cfg, cand.n_tokens,
                        with_logits=arrived and cand.n_tokens == n)
                    dl = net.transfer_time(nb_full if arrived else 256)
                    got["basis"] = nb_full if arrived else None
                sim.redis += dl
                actual = dl
            else:
                actual = got["transfer"]
            FLIGHT.record("fetch.attempt", client=self.name,
                          peer=att.peer_id or "server",
                          range_tokens=cand.n_tokens, kind=kind)
            LEDGER.note_attempt(rec, peer=att.peer_id or "server",
                                range_tokens=cand.n_tokens,
                                result=_LEDGER_RESULT.get(kind, kind),
                                est_fetch_s=att.est_fetch_s, actual_s=actual,
                                shared=got["shared"])
            if kind == "dead":         # already marked suspect: next one
                dead += 1
                dead_s += got["transfer"]
                continue
            if kind in ("cancelled", "deadline"):
                continue               # a healthy peer: no miss to count
            if att.peer_id is not None and not got["shared"]:
                self.directory.record_get(
                    att.peer_id, arrived, att.est_fetch_s, actual,
                    got["nbytes"] if arrived else 0,
                    basis_bytes=got.get("basis"),
                    predicted_present=self.use_catalog, digest=cand.digest)
            if kind == "miss":
                false_pos = True       # §3.3: try the next attempt
                continue
            if kind == "unreadable":
                unreadable += 1
                continue
            if kind != "hit":          # a recurrent state with no logits
                continue
            st, state, shared = got["st"], got["state"], got["shared"]
            if rec is not None and got.get("resp") is not None:
                # the broker shares the reply: a sibling that adopted it
                # links its record to this one
                if shared:
                    dedup_of = got["resp"].get(LEDGER_KEY)
                else:
                    got["resp"][LEDGER_KEY] = rec["id"]
            matched = cand.n_tokens
            down_bytes = 0 if shared else got["nbytes"]
            hit_dl_sim = actual if sim_link else 0.0
            if att.peer_id is not None:
                served_by, est_fetch = att.peer_id, att.est_fetch_s
                actual_fetch = actual
                if not shared:         # N shared adoptions are one fetch
                    # the blob's bytes are made only if the client must
                    # ship a replica itself (a streamed hit's container
                    # is a copy)
                    self.directory.note_fetch(cand.digest, got["nbytes"],
                                              att.peer_id, got["blob"])
            break
        if plan and not matched:
            # every attempt failed: the last events say why
            FLIGHT.trigger(PLAN_EXHAUSTED, client=self.name,
                           attempts=n_attempts, dead_peers=dead,
                           decision=rec["id"] if rec else "")

        # Step 3: adopt / resume / full local prefill
        streamed = st is not None
        overlap_hidden = 0.0
        if matched == n and state[2] is not None:
            cache, _, logits = state
            st = self.engine.adopt(cache, n, logits)
        elif matched > 0:
            if streamed:
                resume_from = got["resume_from"]
            else:
                cache, _, logits = state
                # a blob without logits cannot give the first suffix
                # token's input: re-run the prefix's last token
                resume_from = matched if logits is not None else matched - 1
                suffix = np.asarray(prompt.token_ids[resume_from:],
                                    np.int32)[None]
                st = self.engine.resume({"tokens": suffix}, cache,
                                        resume_from)
            tm["prefill_s"] = st.timings["prefill_wall"]
            tr.add("p_decode", tm["prefill_s"], component="p_decode",
                   kind="streamed" if streamed else "resumed",
                   resumed_from=resume_from)
            if self.perf:
                t_suffix = self.perf.time_prefill(cfg, n - resume_from)
                sim.p_decode += t_suffix
                if self.overlap and hit_dl_sim > 0:
                    # the chunks arrive a layer group at a time, so only
                    # the first chunk stays serial with the suffix
                    k = max(got["chunks"] - 1, 0) if streamed else 0
                    if emulated or not k:
                        k = sizing.stream_chunk_count(
                            cfg, self.cache_cfg.chunk_layers)
                    overlap_hidden = min(hit_dl_sim * (1.0 - 1.0 / k)
                                         if k > 1 else 0.0, t_suffix)
                    sim.redis -= overlap_hidden
            if streamed and not overlap_hidden:
                overlap_hidden = got["hidden_wall"]
            if overlap_hidden and served_by:
                self.directory.record_overlap(served_by, overlap_hidden)
        else:
            tokens = np.asarray(prompt.token_ids, np.int32)[None]
            st = self.engine.start({"tokens": tokens})
            tm["prefill_s"] = st.timings["prefill_wall"]
            tr.add("p_decode", tm["prefill_s"], component="p_decode",
                   kind="full")
            if self.perf:
                sim.p_decode += self.perf.time_prefill(cfg, n)
        prompt_logits = st.last_logits
        ttft = clock.monotonic() - t0
        upload = matched == 0 and upload_on_miss
        prompt_cache = st.cache
        if upload and (recurrent or model.cfg.window):
            # decode advances a state, and overwrites a ring's slots, in
            # place
            prompt_cache = _clone(st.cache)

        # Step 4: decode the response
        out = self.engine.generate(st, max_new_tokens, sampler, rng=rng)
        tm["decode_s"] = st.timings["decode_wall"]
        ttlt = clock.monotonic() - t0
        n_out = st.timings["decode_tokens"]
        tr.add("r_decode", tm["decode_s"], component="r_decode",
               tokens=int(n_out))
        if self.perf:
            sim.r_decode = self.perf.time_decode(cfg, n_out)
            sim.sample = self.perf.time_sample(n_out)
        self._commit(rec, n, matched, served_by, actual_fetch, dedup_of,
                     sim, tm)

        up = 0
        if upload:
            tu = clock.monotonic()
            up = self._upload_ranges(prompt, keys, prompt_cache,
                                     prompt_logits)
            tm["upload_s"] = clock.monotonic() - tu
            tr.add("upload", tm["upload_s"], t0=tu, bytes=up)
        res = InferResult(
            case=self._case_of(prompt, matched), matched_tokens=matched,
            prompt_tokens=n, output_tokens=[int(t) for t in out[0]],
            ttft_s=ttft, ttlt_s=ttlt, blob_bytes_down=down_bytes,
            blob_bytes_up=up, false_positive=false_pos and matched == 0,
            unreadable_blobs=unreadable, streamed=streamed,
            chunks_down=chunks_down, timings=tm, sim=sim,
            served_by=served_by, shared_fetch=shared,
            fetch_attempts=n_attempts,
            est_fetch_s=est_fetch, actual_fetch_s=actual_fetch)
        if overlap_hidden:
            res.extra["overlap_hidden_s"] = overlap_hidden
        if dead:                       # count, and wall seconds, of the
            res.extra["dead_peer_failures"] = float(dead)    # fast fails
            res.extra["dead_peer_s"] = dead_s
        return res

    def _commit(self, rec, n: int, matched: int, served_by: str,
                fetch_s: float, dedup_of, sim: Breakdown,
                tm: Dict[str, float]) -> None:
        """Close the plan's ledger record with the realized outcome, on
        the seconds the plan was priced in: the perf model's where there
        is one, else wall seconds (and a complete miss then teaches the
        ledger its local prefill rate)."""
        if rec is None:
            return
        prefill_s = sim.p_decode if self.perf else tm["prefill_s"]
        if matched:
            LEDGER.commit(rec, chosen=served_by or None,
                          result="hit" if matched == n else "partial",
                          fetch_s=fetch_s,
                          suffix_s=prefill_s if matched < n else 0.0,
                          dedup_of=dedup_of)
            return
        if not self.perf:
            LEDGER.note_prefill(n, tm["prefill_s"])
        LEDGER.commit(rec, chosen=None, result="local",
                      local_prefill_s=prefill_s)

    # ------------------------------------------------------------------
    def _link_net(self, peer_id: Optional[str]):
        if peer_id is not None:
            return self.directory.link(peer_id).net
        return getattr(self.transport, "net", None)

    def _issue(self, att: FetchAttempt):
        """One GET of ``att``'s blob: ``(resp, seconds, bytes)``. A dead
        peer's ``TransportError`` is the reply ``{"ok": False, "dead":
        True}`` with the wall seconds the fast fail cost."""
        payload = {"key": att.key.digest}
        t0 = clock.monotonic()
        try:
            if att.peer_id is not None:
                return self.directory.request(att.peer_id, "get", payload)
            return self.transport.request("get", payload)
        except TransportError as e:
            return ({"ok": False, "dead": True, "error": repr(e)},
                    clock.monotonic() - t0, 0)

    def _broker_key(self, att: FetchAttempt):
        """The broker shares a transfer per (peer, key): the same blob on
        two peers is two links."""
        return (att.peer_id, att.key.digest) if att.peer_id is not None \
            else att.key.digest

    def _fetch(self, att: FetchAttempt, tm: Dict[str, float], net,
               hedge: Optional[FetchAttempt] = None) -> dict:
        """One GET, its blob checked and restored. Returns ``{"kind":
        "hit" | "miss" | "dead" | "deadline" | "unreadable" | "skip",
        "arrived": a blob came, "dt": the transport's seconds (a sim
        link's modeled seconds; for a dead peer there one RTT),
        "transfer": wall seconds of the GET, "nbytes", "blob", "state",
        "shared": another session's GET brought it (the broker), "att":
        the attempt that served it (a hedge's winner), "resp": the reply
        (the broker shares it)}``. Adds wall seconds to ``tm``."""
        t0 = clock.monotonic()
        shared, template = False, None
        if self.broker is not None:    # with a broker there is no hedge
            caller = current_span()    # the GET runs on the broker's thread

            def issue():
                with self.tracer.attach(caller):
                    return self._issue(att)
            resp, dt, _, shared, template = self.broker.fetch(
                self._broker_key(att), issue, prep=self.engine.new_cache)
        elif hedge is not None:
            resp, dt, att = self._fetch_hedged(att, hedge)
        else:
            resp, dt, _ = self._issue(att)
        wall = clock.monotonic() - t0
        tm["fetch_s"] += wall          # a dead peer: what the fast fail cost
        out = {"kind": "miss", "arrived": False, "dt": dt, "transfer": wall,
               "nbytes": 0, "st": None, "state": None, "shared": shared,
               "att": att, "resp": resp}
        if resp.get("dead"):
            out.update(kind="dead", dt=net.rtt_s if net is not None else wall)
            return out
        if resp.get("deadline_exceeded"):
            out["kind"] = "deadline"
            return out
        blob = resp.get("blob") if resp.get("ok") else None
        if not blob:
            return out
        out.update(arrived=True, nbytes=len(blob), blob=lambda: blob)
        tr = clock.monotonic()
        try:
            payload = state_io.parse_state(blob, self.meta)
            if self.engine.model.has_recurrent_state and \
                    not payload.get("logits"):
                out["kind"] = "skip"   # a state cannot re-run its last token
                return out
            out["state"] = state_io.restore_state(
                payload, template if template is not None
                else self.engine.new_cache())
            out["kind"] = "hit"
        except ValueError as e:        # ChunkError too: a miss
            out["kind"] = "unreadable"
            FLIGHT.trigger(CHUNK_ERROR, client=self.name,
                           peer=att.peer_id or "server",
                           key=att.key.digest.hex(), error=repr(e))
        finally:
            tm["restore_s"] += clock.monotonic() - tr
        return out

    # -- hedged fetches --------------------------------------------------
    def _hedge_candidate(self, plan, att: FetchAttempt
                         ) -> Optional[FetchAttempt]:
        """The plan's next attempt at the same range on another wall-link
        peer: the backup a hedged GET fires once the primary outlasts its
        patience. None where hedging does not apply: sim links (their
        modeled time is exact), a broker (a hedging leader would fork the
        shared transfer), the single-server client, or no other holder."""
        if (self.directory is None or self.broker is not None
                or att.peer_id is None
                or self._link_net(att.peer_id) is not None):
            return None
        later = plan[plan.index(att) + 1:]
        return next((o for o in later
                     if o.key.digest == att.key.digest
                     and o.peer_id not in (None, att.peer_id)
                     and self._link_net(o.peer_id) is None), None)

    def _fetch_hedged(self, att: FetchAttempt, hedge: FetchAttempt):
        """A single GET with a tail-latency hedge: fire the primary; if it
        is still out after ``hedge_delay_s``, fire the backup too. The
        first usable reply wins; a failed first reply waits for the other
        leg. The loser's reply is dropped when it lands (a single GET has
        no stream to cancel). Returns ``(resp, seconds, winner)``. Both
        legs carry the caller's deadline."""
        results: "queue.Queue" = queue.Queue()
        ddl = current_deadline()
        caller = current_span()

        def issue(a: FetchAttempt):
            with self.tracer.attach(caller), deadline_attach(ddl):
                resp, dt, _ = self._issue(a)
            results.put((a, resp, dt))

        threading.Thread(target=issue, args=(att,), daemon=True).start()
        delay = self.directory.hedge_delay_s(att.peer_id, att.est_fetch_s)
        try:
            got = results.get(timeout=delay)
        except queue.Empty:
            self.hedges += 1
            FLIGHT.record("fetch.hedge", client=self.name,
                          primary=att.peer_id, secondary=hedge.peer_id,
                          est_fetch_s=att.est_fetch_s, waited_s=delay)
            threading.Thread(target=issue, args=(hedge,),
                             daemon=True).start()
            got = results.get()
            if not (got[1].get("ok") and got[1].get("blob")):
                got = results.get()    # the other leg's chance
        winner, resp, dt = got
        if winner is hedge:
            self.hedge_wins += 1
            FLIGHT.record("fetch.hedge_win", client=self.name,
                          primary=att.peer_id, winner=winner.peer_id,
                          actual_s=dt)
        return resp, dt, winner

    def _fetch_streamed(self, att: FetchAttempt, prompt: PromptSegments,
                        tm: Dict[str, float], net) -> dict:
        """A partial hit fetched as a chunk stream, its suffix prefill run
        one layer group at a time as the chunks land.

        A pump thread takes the chunks from the transport (through the
        directory on the fabric) and feeds them to a
        :class:`~repro_torch.core.state_io.ChunkedRestorer` (digest,
        inflate, decode), queueing each completed layer group; this
        thread writes each group into the template and runs its layers.
        The pump always ends the queue, so a bad stream never blocks the
        consumer. Returns :meth:`_fetch`'s fields, with ``kind``: ``hit``
        with ``st`` (the resumed state) or, for a v2 blob, ``state``
        (restored whole, for the ordinary resume); ``miss`` (no blob);
        ``dead``; ``unreadable`` (a corrupt, truncated or undecodable
        stream); ``cancelled`` (a recurrent state without logits, or the
        watchdog below: the stream is cut). A hit adds ``resume_from``,
        ``chunks`` and ``hidden_wall``. Adds its wall seconds to ``tm``.

        With a broker this session leads the transfer, and publishes the
        blob (or the failure) for the sessions that join it; returns None
        when another session leads it or its blob is cached, and the
        caller shares it through :meth:`_fetch`.

        On a wall link a watchdog projects the stream's end from its pace
        so far (from the second chunk on) and cuts it with the cancel
        frame when the projection overruns the deadline's remainder or
        the local prefill the attempt was priced against: the perf
        model's, or without one the decision ledger's learned baseline
        (none before the ledger has seen a local prefill)."""
        cand, peer_id = att.key, att.peer_id
        if self.broker is not None and \
                self.broker.lead(self._broker_key(att)) is None:
            return None
        sim_link = self.clock is not None and net is not None
        recurrent = self.engine.model.has_recurrent_state
        restorer = state_io.ChunkedRestorer(self.meta)
        events: "queue.Queue" = queue.Queue()
        cancel = threading.Event()
        info = {"chunks": 0, "feed_s": 0.0, "seconds": 0.0, "hdr": None,
                "err": None, "watchdog": None}
        ddl = current_deadline()
        k_expected = max(sizing.stream_chunk_count(
            self.engine.model.cfg, self.cache_cfg.chunk_layers), 1)
        n_prompt = len(prompt.token_ids)
        local_s = self.perf.time_prefill(self.perf_cfg, n_prompt) \
            if self.perf else LEDGER.baseline_s(n_prompt)
        t_w0 = clock.monotonic()

        def watchdog():
            """The reason to cut the stream now, or None."""
            elapsed = clock.monotonic() - t_w0
            left_s = elapsed / info["chunks"] * max(
                k_expected - info["chunks"], 0)
            if ddl is not None and left_s > ddl.remaining():
                return "deadline"
            if local_s is not None and att.est_total_s < local_s \
                    and elapsed + left_s > local_s:
                return "estimator"
            return None

        def on_chunk(chunk, dt, nb):
            info["chunks"] += 1
            if peer_id is not None:
                self.directory.record_chunk(peer_id, nb, dt,
                                            observe=not sim_link)
            if not sim_link and not cancel.is_set() and info["chunks"] >= 2:
                info["watchdog"] = watchdog()
                if info["watchdog"] is not None:
                    cancel.set()
                    self.stream_cancels += 1
                    FLIGHT.record("fetch.cancel", client=self.name,
                                  peer=peer_id or "server",
                                  reason=info["watchdog"],
                                  chunks=info["chunks"],
                                  expected_chunks=k_expected)
            tf = clock.monotonic()
            done = restorer.feed(chunk)
            info["feed_s"] += clock.monotonic() - tf
            if info["chunks"] == 1:
                events.put("header")
            for gid in done:
                events.put(gid)

        caller = current_span()        # the pump's net span joins the tree

        def pump():
            req = ("get_chunks", {"key": cand.digest}, on_chunk)
            try:
                with self.tracer.attach(caller), deadline_attach(ddl):
                    pump_request(req)
            except BaseException as e:  # re-raised below unless the
                info["err"] = e        # stream was bad, cut or dead
            finally:
                events.put(None)       # always unblock the consumer

        def pump_request(req):
            if peer_id is not None:
                info["hdr"], info["seconds"], _ = \
                    self.directory.request_stream(peer_id, *req,
                                                  cancel=cancel)
            else:
                info["hdr"], info["seconds"], _ = \
                    self.transport.request_stream(*req, cancel=cancel)

        t0 = clock.monotonic()
        worker = threading.Thread(target=pump, daemon=True)
        worker.start()
        template = self.engine.new_cache()      # overlaps the first chunks
        matched = cand.n_tokens
        st, state, kind, resume_from = None, None, "unreadable", matched

        def drain(cut: bool):          # wait for the pump's end
            if cut:
                cancel.set()
            while events.get() is not None:
                pass

        ended = []                     # the consumer has seen the end
        first = events.get()
        if first is None:
            pass                       # no blob, a dead peer, a bad stream
        elif restorer.v2_payload is not None:
            drain(cut=False)           # one chunk: the stream is ending
            if info["err"] is None:
                try:
                    state = restorer.result(template)
                    kind = "hit"
                except ValueError:
                    pass
        elif recurrent and not restorer.header.get("logits"):
            drain(cut=True)
            kind = "cancelled"
        else:
            resume_from = matched if restorer.header.get("logits") \
                else matched - 1
            suffix = np.asarray(prompt.token_ids[resume_from:],
                                np.int32)[None]

            def groups():
                while True:
                    gid = events.get()
                    if gid is None:
                        ended.append(True)
                        if restorer.complete:
                            return
                        raise _StreamEnded()
                    yield (state_io.segment_index(gid[0]), gid[1], gid[2],
                           restorer.group_tree(gid, template))

            try:
                st = self.engine.resume_streamed(
                    {"tokens": suffix}, resume_from, groups(), template)
                kind = "hit"
            except (_StreamEnded, ValueError):
                if not ended:
                    drain(cut=True)
        worker.join()
        err = info["err"]
        if err is not None and not isinstance(
                err, (StreamCancelled, ValueError, TransportError)):
            if self.broker is not None:     # never leave joiners waiting
                self.broker.publish(self._broker_key(att),
                                    {"ok": False, "error": repr(err)})
            raise err
        if kind == "hit" and err is not None:
            st, state, kind = None, None, "unreadable"
        if isinstance(err, TransportError):
            kind = "dead"
        elif isinstance(err, StreamCancelled) and info["watchdog"]:
            kind = "cancelled"         # cut on purpose: not a bad stream
        elif first is None and isinstance(info["hdr"], dict) and \
                not info["hdr"].get("error"):
            kind = "miss"
        if kind == "unreadable":       # a digest or decode failed
            FLIGHT.trigger(CHUNK_ERROR, client=self.name,
                           peer=peer_id or "server", key=cand.digest.hex(),
                           chunks=info["chunks"], error=repr(err))
        wall = clock.monotonic() - t0
        restore = info["feed_s"] + restorer.phase_s["place"]
        compute = st.timings["prefill_wall"] if st is not None else 0.0
        visible = max(wall - compute - (restore if st is None else 0.0), 0.0)
        tm["fetch_s"] += visible
        tm["restore_s"] += restore
        hidden = 0.0
        if st is not None:
            tm["stream_s"] = wall
            hidden = max(info["seconds"] + restore + compute - wall, 0.0)
            tm["hidden_s"] = hidden
        if sim_link:
            dt = info["seconds"] if info["hdr"] is not None else net.rtt_s
        else:
            dt = visible
        resp = None
        if self.broker is not None:    # resolve the sessions that joined
            resp = {"ok": True, "blob": state_io.pack_container(
                restorer.raw_chunks())} if kind == "hit" else \
                {"ok": False, "blob": None, "dead": kind == "dead"}
            self.broker.publish(self._broker_key(att), resp,
                                info["seconds"])
        return {"kind": kind, "arrived": kind == "hit", "st": st,
                "shared": False, "watchdog": info["watchdog"], "resp": resp,
                "state": state, "chunks": info["chunks"],
                "nbytes": chunkfmt.container_size(restorer.raw_chunks()),
                "resume_from": resume_from,
                "dt": dt, "transfer": info["seconds"] if kind == "hit"
                else visible, "hidden_wall": hidden,
                "blob": lambda: state_io.pack_container(
                    restorer.raw_chunks())}

    # ------------------------------------------------------------------
    def _range_states(self, prompt: PromptSegments, keys: List[PromptKey],
                      cache, logits: np.ndarray):
        """(key, cache, logits) of every prefix range of a recurrent state.
        Such a state is not cut to a prefix, so each shorter range's state
        is rebuilt by prefilling the prompt boundary by boundary on a
        fresh cache, each piece resuming from the last, and carries its
        own logits. Each cache is reused by the next range: serialize it
        before asking for the next."""
        n = len(prompt.token_ids)
        tokens = np.asarray(prompt.token_ids, np.int32)[None]
        st = None
        for k in sorted(keys, key=lambda k: k.n_tokens):
            if k.n_tokens == n:
                yield k, cache, logits
                continue
            if st is None:
                st = self.engine.start({"tokens": tokens[:, :k.n_tokens]})
            else:
                st = self.engine.resume(
                    {"tokens": tokens[:, st.pos:k.n_tokens]}, st.cache, st.pos)
            yield k, st.cache, st.last_logits

    def _upload_ranges(self, prompt: PromptSegments, keys: List[PromptKey],
                       cache, logits: np.ndarray) -> int:
        """Register every prefix range of the prompt (paper Fig. 3), one
        ``PC3`` container per range; on the fabric each goes to its
        consistent-hash owner by one PUT. A K/V or latent cache takes one
        serialization pass for all ranges (shorter ranges are header
        rewrites), logits on the full prompt's range only. A recurrent
        state takes one pass per range, each range's own state and
        logits: cutting every range from the final state, as the
        reference does, would give each the whole prompt's state."""
        model = self.engine.model
        cc = self.cache_cfg
        kw = dict(compress=cc.compress, level=cc.compress_level,
                  quantize=cc.quantize, codec=cc.compress_codec,
                  chunk_layers=cc.chunk_layers)
        blobs = []
        if model.has_recurrent_state:
            for k, range_cache, range_logits in self._range_states(
                    prompt, keys, cache, logits):
                blobs.append((k, state_io.pack_container(
                    state_io.extract_state_chunks(
                        range_cache, model.cache_len(k.n_tokens), self.meta,
                        logits=range_logits, **kw))))
        else:
            n = len(prompt.token_ids)
            per_key = {k.digest: model.cache_len(k.n_tokens) for k in keys}
            lists = state_io.extract_state_ranges(
                cache, sorted(set(per_key.values())), self.meta,
                logits=logits if any(k.n_tokens == n for k in keys)
                else None, **kw)
            blobs = [(k, state_io.pack_container(lists[per_key[k.digest]]))
                     for k in keys]
        total = 0
        for k, blob in blobs:
            if self.directory is not None:   # one PUT, by placement
                total += self.directory.upload(k.digest, blob)
                continue
            try:
                resp, _, _ = self.transport.request(
                    "put", {"key": k.digest, "blob": blob},
                    advance_clock=False)
            except TransportError:
                continue               # best effort: the server is gone
            if not resp.get("stored", True):
                continue               # never advertise a rejected blob
            self.catalog.register(k.digest)
            total += len(blob)
        return total

    def _case_of(self, prompt: PromptSegments, matched: int) -> int:
        """Map the matched length onto the paper's Cases 1-5."""
        if matched == 0:
            return 1
        bounds = list(prompt.boundaries)
        if matched == len(prompt.token_ids):
            return 5
        try:
            i = bounds.index(matched)
        except ValueError:
            return 1
        return min(2 + i, 4)


def _clone(cache):
    return tree_map(lambda t: t.clone(), cache)
