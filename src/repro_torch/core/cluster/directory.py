"""The client's view of the cache fabric: one Bloom catalog per peer.

The port's copy of ``repro.core.cluster.directory``. A
:class:`PeerDirectory` takes the place of the single transport in
``EdgeClient``. Per peer it holds
the link (an in-process simulated one, or a real
:class:`~repro_torch.core.net.link.TCPPeerLink`), a local catalog of the
peer's contents kept fresh by delta ``csync``, a liveness belief (a
failed request marks the peer suspect for a cooldown, never a hang), a
:class:`~repro_torch.core.cluster.breaker.CircuitBreaker` and
:class:`~repro_torch.core.metrics.PeerStats`.

Fetch costs come from a
:class:`~repro_torch.core.net.estimator.LinkEstimator` seeded from each
link's nominal ``SimNetwork`` where there is one, then updated from the
transfers the directory sees (``adaptive=False`` pins the nominal
costs).

Writes are one PUT to the first accepting peer in ring order; that peer
fans out to the key's other owners itself. A ``stored: false`` ack
(budget refused) keeps walking the ring and registers nothing. An
ambient :func:`~repro_torch.core.deadline.deadline_scope` rides every
request's payload as its remaining seconds; with none in scope the
payload is sent as it was given. Keys hot
at fetch time get one more replica on the fastest other peer, by a
``hot`` hint to the peer that served them; with a decaying tracker the
replica is collected (``del``) once the key cools. A GET the catalog
predicted present that misses triggers a read repair: another holder
pushes its copy to the peer that lied.

Observability: a request made while the calling thread has a span open
runs under a ``net.<op>`` span whose context rides the payload
(``_trace``), and the peer's ``_spans`` are folded under it. A failed
request triggers a ``peer_death`` flight dump, a breaker that opens a
``breaker_open`` one. Every realized transfer (a hit's GET, a stream
chunk on a wall link) feeds ``calibration``, a
:class:`~repro_torch.obs.calibrate.CalibrationTracker`, whose p95
actual/estimate ratio a peer is a hedged GET's patience.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.config import CacheConfig
from repro_torch.core.catalog import Catalog
from repro_torch.core.cluster.breaker import CircuitBreaker
from repro_torch.core.cluster.peer import CachePeer, PeerTransport
from repro_torch.core.cluster.placement import HotKeyTracker, PlacementPolicy
from repro_torch.core.cluster.replication import REPL_FACTOR
from repro_torch.core.deadline import inject_deadline
from repro_torch.core.metrics import PeerStats
from repro_torch.core.net.estimator import LinkEstimator
from repro_torch.core.netsim import SimClock
from repro_torch.core.transport import TransportError
from repro_torch.obs.calibrate import CalibrationTracker
from repro_torch.obs.flight import BREAKER_OPEN, FLIGHT, PEER_DEATH
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import SPANS_KEY, inject_trace, phase

# a miss slower than this is a server stall, not wire time: kept out of
# the RTT estimate (record_get)
MISS_SAMPLE_CAP_S = 0.05
# a replica GC that finds nothing to delete retries for this long: on
# TCP the hinted push may still wait for the serving peer's pump
REPLICA_GC_GRACE_S = 1.0
READ_REPAIR_INTERVAL_S = 5.0       # at most one read repair a digest a
                                   # window
HOT_MAX_ENTRIES = 4096             # digests the hot-key tracker counts
# a hedge's patience: the estimate times the peer's calibrated p95
# actual/estimate ratio (HEDGE_RATIO until it has samples), at least
# HEDGE_FLOOR_S
HEDGE_RATIO = 1.5
HEDGE_FLOOR_S = 0.05


class PeerLink:
    """Everything the client tracks about one peer."""

    def __init__(self, peer_id: str, transport, cache_cfg: CacheConfig,
                 peer: Optional[CachePeer] = None,
                 breaker: Optional[CircuitBreaker] = None):
        self.peer_id = peer_id
        self.peer = peer               # the in-process fabric only
        self.transport = transport
        self.catalog = Catalog(cache_cfg)
        self.stats = PeerStats(peer_id)
        self.suspect_until = -1e18     # clock time; past = usable
        self.local_version = 0         # csync cursor: the peer's key log
        self.remote_version = 0        # csync cursor: its remote log
        self.breaker = breaker or CircuitBreaker(peer_id)

    @property
    def net(self):
        return getattr(self.transport, "net", None)


class PeerDirectory:
    def __init__(self, peers: Sequence,
                 cache_cfg: CacheConfig = CacheConfig(),
                 clock: Optional[SimClock] = None,
                 hot_threshold: int = 3,
                 hot_decay_every: int = 0,
                 suspect_cooldown_s: float = 30.0,
                 sync_peers: Optional[Sequence[str]] = None,
                 adaptive: bool = True,
                 estimator: Optional[LinkEstimator] = None):
        """``peers`` mixes :class:`CachePeer` objects (the directory builds
        their simulated :class:`PeerTransport`) and transport-like objects
        with a ``peer_id`` and ``request(op, payload, advance_clock)``,
        such as :class:`~repro_torch.core.net.link.TCPPeerLink`. A shared
        ``estimator`` (a session pool's) keeps the beliefs its other
        directories learned; each new link is only seeded in it."""
        self.cache_cfg = cache_cfg
        self.clock = clock or SimClock()
        self.links: Dict[str, PeerLink] = {}
        for p in peers:
            breaker = CircuitBreaker(p.peer_id)
            if isinstance(p, CachePeer):
                link = PeerLink(p.peer_id, PeerTransport(p, self.clock),
                                cache_cfg, peer=p, breaker=breaker)
            else:
                link = PeerLink(p.peer_id, p, cache_cfg, breaker=breaker)
            self.links[link.peer_id] = link
        self.placement = PlacementPolicy(list(self.links))
        # replicas this directory minted: digest -> peer (the GC set);
        # made before the tracker so live replicas pin their counts
        self._replicas: Dict[bytes, str] = {}
        self.hot = HotKeyTracker(hot_threshold, max_entries=HOT_MAX_ENTRIES,
                                 decay_every=hot_decay_every,
                                 pinned=self._replicas.__contains__)
        self.suspect_cooldown_s = suspect_cooldown_s
        self.sync_peers = list(sync_peers) if sync_peers else None
        self.last_sync_t = -1e18
        self.sync_bytes = 0
        self.replications = 0
        self.replica_gcs = 0
        self._gc_misses: Dict[bytes, float] = {}
        self._repair_t: Dict[bytes, float] = {}
        self.read_repairs = 0
        self.adaptive = adaptive
        self.estimator = estimator or LinkEstimator()
        self.calibration = CalibrationTracker()
        self._m_catalog_fp = REGISTRY.counter(
            "repro_catalog_fp_total",
            "catalog-predicted-present GETs that missed (stale Bloom)",
            ("peer",))
        self._nominal: Dict[str, Tuple[float, float]] = {}
        for pid, ln in self.links.items():
            net = ln.net
            if net is not None:
                self._nominal[pid] = (net.bandwidth_bps, net.rtt_s)
                self.estimator.seed(pid, net.bandwidth_bps, net.rtt_s)
            else:
                self._nominal[pid] = (self.estimator.default_bw_bps,
                                      self.estimator.default_rtt_s)
                self.estimator.seed(pid)

    # -- liveness --------------------------------------------------------
    def link(self, peer_id: str) -> PeerLink:
        return self.links[peer_id]

    def usable_ids(self) -> List[str]:
        now = self.clock.now()
        return [pid for pid, ln in self.links.items()
                if ln.suspect_until <= now and ln.breaker.allow(now)]

    def mark_suspect(self, peer_id: str) -> None:
        ln = self.links[peer_id]
        ln.suspect_until = self.clock.now() + self.suspect_cooldown_s
        ln.stats.transport_errors += 1

    # -- catalog ---------------------------------------------------------
    def lookup(self, digest: bytes) -> List[str]:
        """Usable peers whose catalog (probably) holds ``digest``."""
        return [pid for pid in self.usable_ids()
                if self.links[pid].catalog.lookup(digest)]

    def register(self, peer_id: str, digest: bytes) -> None:
        self.links[peer_id].catalog.register(digest)

    def maybe_sync(self, now: float) -> bool:
        """Delta-sync the per-peer catalogs, at most once per
        ``sync_interval_s``, off the request path (no clock advance)."""
        if now - self.last_sync_t < self.cache_cfg.sync_interval_s:
            return False
        self.last_sync_t = now
        for pid in self.sync_peers or self.usable_ids():
            ln = self.links.get(pid)
            if ln is None or ln.suspect_until > now:
                continue
            try:
                resp, _, nb = ln.transport.request(
                    "csync", {"since": ln.local_version,
                              "since_remote": ln.remote_version},
                    advance_clock=False)
            except TransportError:
                self.mark_suspect(pid)
                continue
            self.sync_bytes += nb
            for k in resp.get("keys", []):
                ln.catalog.register(k)
            ln.local_version = resp.get("version", ln.local_version)
            ln.stats.tombstones = resp.get("tombstones", ln.stats.tombstones)
            for k, owner in resp.get("remote", []):
                other = self.links.get(owner)
                if other is not None:
                    other.catalog.register(k)
            ln.remote_version = resp.get("remote_version",
                                         ln.remote_version)
        return True

    # -- request routing -------------------------------------------------
    def _failed(self, ln: PeerLink, op: str, err: TransportError) -> None:
        self.mark_suspect(ln.peer_id)
        ev = ln.breaker.record_failure(self.clock.now())
        if ev is not None:             # it just opened: freeze the ring
            FLIGHT.trigger(BREAKER_OPEN, op=op, error=repr(err), **ev)
        FLIGHT.trigger(PEER_DEATH, peer=ln.peer_id, op=op, error=repr(err))

    @staticmethod
    def _fold(sp, reply, peer_id: str, nb: int, dt: float) -> None:
        """Close a ``net.<op>`` span and fold the peer's spans under it."""
        sp.set(bytes=nb, transfer_s=dt).end()
        remote = reply.get(SPANS_KEY) if isinstance(reply, dict) else None
        if remote:
            sp._tracer.fold_remote(sp, remote, proc=f"peer:{peer_id}")

    def request(self, peer_id: str, op: str, payload: dict,
                advance_clock: bool = True):
        """One request to a peer; a transport failure marks the peer
        suspect, feeds its breaker and re-raises ``TransportError``.
        Traced as ``net.<op>`` when the thread has a span open."""
        ln = self.links[peer_id]
        ln.breaker.on_attempt(self.clock.now())
        try:
            with phase(f"net.{op}", peer=peer_id) as sp:
                if sp:
                    payload = inject_trace(payload, sp)
                resp, dt, nb = ln.transport.request(
                    op, inject_deadline(payload), advance_clock)
                if sp:
                    self._fold(sp, resp, peer_id, nb, dt)
        except TransportError as e:
            self._failed(ln, op, e)
            raise
        ln.breaker.record_success()
        return resp, dt, nb

    def request_stream(self, peer_id: str, op: str, payload: dict,
                       on_chunk, advance_clock: bool = True, cancel=None):
        """A streamed request (one frame a chunk) with :meth:`request`'s
        failure contract. A cancelled stream
        (:class:`~repro_torch.core.transport.StreamCancelled`) neither
        marks the peer suspect nor feeds its breaker."""
        ln = self.links[peer_id]
        tr = ln.transport
        if not hasattr(tr, "request_stream"):
            raise TransportError(f"peer {peer_id!r} transport does not "
                                 f"stream")
        ln.breaker.on_attempt(self.clock.now())
        try:
            with phase(f"net.{op}", peer=peer_id, stream=True) as sp:
                if sp:
                    payload = inject_trace(payload, sp)
                header, dt, nb = tr.request_stream(
                    op, inject_deadline(payload), on_chunk,
                    advance_clock=advance_clock, cancel=cancel)
                if sp:
                    self._fold(sp, header, peer_id, nb, dt)
        except TransportError as e:
            self._failed(ln, op, e)
            raise
        ln.breaker.record_success()
        return header, dt, nb

    def est_fetch_s(self, peer_id: str, nbytes: int) -> float:
        """Estimated seconds to move ``nbytes`` from ``peer_id``: the
        estimator's belief, or the nominal link with ``adaptive=False``."""
        if self.adaptive:
            return self.estimator.est_fetch_s(peer_id, nbytes)
        bw, rtt = self._nominal[peer_id]
        return rtt + nbytes * 8.0 / bw

    def hedge_delay_s(self, peer_id: str, est_s: float) -> float:
        """How long to wait on ``peer_id`` before firing the plan's next
        candidate: the estimate times the peer's calibrated p95
        actual/estimate ratio (a peer that runs 2x over its estimates
        gets 2x the patience: a hedge fires on an anomaly, not on a known
        slow link), floored at ``HEDGE_FLOOR_S`` so that sub-millisecond
        estimates do not hedge on scheduler noise."""
        ratio = self.calibration.p95_ratio(peer_id, default=HEDGE_RATIO)
        return max(est_s * ratio, HEDGE_FLOOR_S)

    # -- placement -------------------------------------------------------
    def upload(self, digest: bytes, blob: bytes) -> int:
        """One PUT to the first accepting peer in ring order (off the
        request path: no clock advance). Returns the bytes the client
        shipped (0: nowhere accepted)."""
        now = self.clock.now()
        for pid in self.placement.ring_order(digest):
            ln = self.links[pid]
            if ln.suspect_until > now:
                continue
            try:
                resp, _, _ = self.request(pid, "put",
                                          {"key": digest, "blob": blob},
                                          advance_clock=False)
            except TransportError:
                continue
            if not resp.get("stored", True):
                ln.stats.store_rejects += 1
                continue               # budget refused: the next peer
            ln.catalog.register(digest)
            ln.stats.bytes_up += len(blob)
            return len(blob)
        return 0

    def note_fetch(self, digest: bytes, nbytes: int, src_peer: str,
                   make_blob: Callable[[], bytes]) -> Optional[str]:
        """Count a fetch of ``nbytes``; once the key is hot, ask the serving
        peer to push it to the fastest usable peer that neither advertises
        it nor owns it. A peer that cannot push (unwired, or the blob is
        gone) makes the client ship the copy itself as a ``repl``: only
        then is ``make_blob()`` called for the bytes. Returns the replica's
        peer when one was made."""
        self.hot.note(digest)
        if self.hot.decay_every > 0:
            self.gc_replicas()
        if not self.hot.is_hot(digest):
            return None
        if digest in self._replicas:
            return None
        holders = set(self.lookup(digest)) | {src_peer}
        # hot replicas go to non-owners only, so the GC never deletes an
        # owner's copy
        owners = set(self.placement.ring_order(digest)[:REPL_FACTOR])
        cands = [pid for pid in self.usable_ids()
                 if pid not in holders and pid not in owners]
        if not cands:
            return None
        target = min(cands, key=lambda pid: self.est_fetch_s(pid, nbytes))
        try:
            resp, _, _ = self.request(src_peer, "hot",
                                      {"key": digest, "target": target},
                                      advance_clock=False)
        except TransportError:
            return None
        if resp.get("ok"):
            self.links[src_peer].stats.hints += 1
        else:
            blob = make_blob()
            try:
                resp, _, _ = self.request(
                    target, "repl",
                    {"key": digest, "blob": blob, "origin": "client"},
                    advance_clock=False)
            except TransportError:
                return None
            if not (resp.get("ok") and resp.get("stored", True)):
                self.links[target].stats.store_rejects += 1
                return None
            self.links[target].stats.bytes_up += len(blob)
        # the push is in flight; if the target drops it, the catalog's
        # claim is a §3.3 false positive
        self.links[target].catalog.register(digest)
        self.replications += 1
        self._replicas[digest] = target
        return target

    def gc_replicas(self) -> int:
        """Delete the replicas this directory minted for keys no longer
        hot. A transport failure keeps the entry for the next pass; a
        peer with nothing to delete is retried for
        ``REPLICA_GC_GRACE_S``. Returns the replicas collected."""
        gone = 0
        for digest in [d for d in self._replicas if not self.hot.is_hot(d)]:
            target = self._replicas[digest]
            try:
                resp, _, _ = self.request(target, "del", {"key": digest},
                                          advance_clock=False)
            except TransportError:
                continue
            if not resp.get("ok"):
                now = self.clock.now()
                first = self._gc_misses.setdefault(digest, now)
                if now - first < REPLICA_GC_GRACE_S:
                    continue
            self._gc_misses.pop(digest, None)
            del self._replicas[digest]
            gone += 1
            self.replica_gcs += 1
        return gone

    # -- accounting ------------------------------------------------------
    def record_get(self, peer_id: str, hit: bool, est_s: float,
                   actual_s: float, nbytes: int,
                   basis_bytes: Optional[int] = None,
                   predicted_present: bool = False,
                   digest: Optional[bytes] = None) -> None:
        """Account one GET and feed the estimator. ``basis_bytes`` is the
        byte count the estimate was priced on (default: the wire bytes).
        A miss the catalog predicted present fires a read repair when
        ``digest`` is given."""
        st = self.links[peer_id].stats
        st.gets += 1
        if hit:
            st.hits += 1
            st.bytes_down += nbytes
            st.est_fetch_s += est_s
            st.actual_fetch_s += actual_s
            self.estimator.observe(peer_id, basis_bytes or nbytes, actual_s)
            self.calibration.observe(peer_id, est_s, actual_s, nbytes)
            return
        if predicted_present:
            self._m_catalog_fp.labels(peer=peer_id).inc()
            if digest is not None:
                self._read_repair(peer_id, digest)
        st.misses += 1
        # a failed GET is usually an RTT sample, unless server-side
        # handling dominated it
        _, rtt_now, _ = self.estimator.snapshot(peer_id)
        if actual_s <= max(MISS_SAMPLE_CAP_S, 8.0 * rtt_now):
            self.estimator.observe(peer_id, 256, actual_s)
        else:
            st.miss_outliers += 1

    def _read_repair(self, miss_peer: str, digest: bytes) -> bool:
        """Ask another holder of ``digest`` to push it to ``miss_peer``
        (a ``hot`` hint), at most once per ``READ_REPAIR_INTERVAL_S`` a
        digest."""
        now = self.clock.now()
        last = self._repair_t.get(digest)
        if last is not None and now - last < READ_REPAIR_INTERVAL_S:
            return False
        self._repair_t[digest] = now
        holders = [pid for pid in self.lookup(digest) if pid != miss_peer]
        if not holders:
            return False
        src = min(holders, key=lambda pid: self.est_fetch_s(pid, 1))
        try:
            resp, _, _ = self.request(src, "hot",
                                      {"key": digest, "target": miss_peer},
                                      advance_clock=False)
        except TransportError:
            return False
        if not resp.get("ok"):
            return False
        self.read_repairs += 1
        return True

    def record_chunk(self, peer_id: str, nbytes: int, seconds: float,
                     observe: bool = True) -> None:
        """Account one received stream chunk; ``observe`` feeds it to the
        estimator (real links: a congested link shows within one fetch;
        sim links pass False, their whole-transfer sample is exact)."""
        self.links[peer_id].stats.chunks_down += 1
        if observe and seconds > 0:
            # calibration sees the belief before this sample: the price
            # the chunk was planned under
            est = self.est_fetch_s(peer_id, nbytes)
            self.estimator.observe(peer_id, nbytes, seconds)
            self.calibration.observe(peer_id, est, seconds, nbytes)

    def record_overlap(self, peer_id: str, hidden_s: float) -> None:
        """Transfer seconds hidden behind a streamed suffix prefill on a
        fetch served by ``peer_id``."""
        self.links[peer_id].stats.overlap_hidden_s += hidden_s

    def peer_stats(self) -> Dict[str, PeerStats]:
        for pid, ln in self.links.items():
            bw, rtt, n_obs = self.estimator.snapshot(pid)
            ln.stats.est_bw_bps = bw
            ln.stats.est_rtt_s = rtt
            ln.stats.link_observations = n_obs
        return {pid: ln.stats for pid, ln in self.links.items()}
