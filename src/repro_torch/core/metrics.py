"""Latency accounting in the paper's Table-3 vocabulary, the fabric's
per-peer statistics, and the serving layer's per-request and aggregate
(percentile) statistics.

The port's copy of ``repro/core/metrics.py``: :class:`Breakdown` (the
client's ``sim`` seconds: emulated edge device and simulated Wi-Fi),
:class:`PeerStats` and :func:`merge_peer_stats` (the session pool's and
the gateway's fleet view), :func:`percentile`, :class:`RequestStats`,
:class:`TenantStats` and :class:`ServingReport`. A request's wall
``Breakdown`` is a projection of its span tree (:meth:`Breakdown.from_spans`),
not a second bookkeeping path.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

COMPONENTS = ("token", "bloom", "p_decode", "redis", "r_decode", "sample")


@dataclass
class Breakdown:
    """Seconds of one request by Table-3 column."""
    token: float = 0.0
    bloom: float = 0.0
    p_decode: float = 0.0
    redis: float = 0.0
    r_decode: float = 0.0
    sample: float = 0.0

    @property
    def ttft(self) -> float:
        return self.token + self.bloom + self.p_decode + self.redis

    @property
    def ttlt(self) -> float:
        return self.ttft + self.r_decode + self.sample

    def as_dict(self) -> Dict[str, float]:
        d = {c: getattr(self, c) for c in COMPONENTS}
        d["ttft"] = self.ttft
        d["ttlt"] = self.ttlt
        return d

    @classmethod
    def from_spans(cls, spans: Sequence[dict]) -> "Breakdown":
        """Project a span tree onto the Table-3 columns: a span with a
        ``component`` attribute adds its duration to that column, or its
        ``component_s`` where the accountable time differs from the
        span's (an attempt span covers transfer and restore; only the
        transfer is ``redis``). Spans without one (structural parents,
        folded remote spans) are not summed, so nesting never counts a
        second time."""
        bd = cls()
        for d in spans:
            attrs = d.get("attrs") or {}
            comp = attrs.get("component")
            if comp in COMPONENTS:
                dur = float(attrs.get("component_s", d["dur"]))
                setattr(bd, comp, getattr(bd, comp) + dur)
        return bd


@dataclass
class PeerStats:
    """Per-peer accounting on the client side of the cache fabric."""
    peer_id: str
    gets: int = 0
    hits: int = 0
    misses: int = 0                # failed GETs (Bloom FP / eviction)
    miss_outliers: int = 0         # slow misses kept out of the RTT EWMA
    transport_errors: int = 0      # dead-peer fast fails
    bytes_down: int = 0
    bytes_up: int = 0              # client-shipped upload bytes (one copy
    #                                a key: the fan-out is peer to peer)
    store_rejects: int = 0         # puts the peer's budget refused
    hints: int = 0                 # ``hot`` hints sent in place of blobs
    chunks_down: int = 0           # stream chunks received
    overlap_hidden_s: float = 0.0  # transfer seconds hidden behind the
    #                                streamed suffix prefill
    est_fetch_s: float = 0.0       # sum of planner estimates on hits
    actual_fetch_s: float = 0.0    # sum of realized fetch times on hits
    tombstones: int = 0            # stale keys the peer reported at sync
    est_bw_bps: float = 0.0        # the link estimator's current belief
    est_rtt_s: float = 0.0
    link_observations: int = 0     # transfers behind it (0: the prior)

    @property
    def est_error_s(self) -> float:
        """Signed planner error (negative: the planner was optimistic)."""
        return self.est_fetch_s - self.actual_fetch_s

    def as_dict(self) -> Dict[str, float]:
        d = dict(self.__dict__)
        d["est_error_s"] = self.est_error_s
        return d


# counter fields summed when merging PeerStats across clients (tombstones
# is a gauge: the freshest belief wins)
PEER_COUNTER_FIELDS = (
    "gets", "hits", "misses", "miss_outliers", "transport_errors",
    "bytes_down", "bytes_up", "store_rejects", "hints", "chunks_down",
    "overlap_hidden_s", "est_fetch_s", "actual_fetch_s")


def merge_peer_stats(stat_maps: Sequence[Dict[str, PeerStats]],
                     estimator=None) -> Dict[str, PeerStats]:
    """One fleet view over several clients' per-peer stats: counters
    summed, ``tombstones`` the largest; with the shared ``estimator``,
    each entry carries its current bandwidth / RTT belief."""
    merged: Dict[str, PeerStats] = {}
    for stats in stat_maps:
        for pid, st in (stats or {}).items():
            agg = merged.setdefault(pid, PeerStats(pid))
            for f in PEER_COUNTER_FIELDS:
                setattr(agg, f, getattr(agg, f) + getattr(st, f))
            agg.tombstones = max(agg.tombstones, st.tombstones)
    if estimator is not None:
        for pid, agg in merged.items():
            agg.est_bw_bps, agg.est_rtt_s, agg.link_observations = \
                estimator.snapshot(pid)
    return merged


def percentile(xs: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile; 0.0 on empty input."""
    if not len(xs):
        return 0.0
    import numpy as np
    return float(np.percentile(np.asarray(xs, float), q))


@dataclass
class RequestStats:
    """Wall-clock accounting of one request through the Scheduler."""
    req_id: int
    prompt_tokens: int
    output_tokens: List[int] = field(default_factory=list)
    submit_t: float = 0.0
    admit_t: float = 0.0           # when a slot was allocated (prefill start)
    first_token_t: float = 0.0
    finish_t: float = 0.0
    finish_reason: str = ""        # "eos" | "length"
    tenant: str = ""               # gateway multi-tenancy ("" = untagged)

    @property
    def ttft(self) -> float:
        return self.first_token_t - self.submit_t

    @property
    def queue_wait(self) -> float:
        return self.admit_t - self.submit_t

    @property
    def latency(self) -> float:
        return self.finish_t - self.submit_t

    @property
    def n_out(self) -> int:
        return len(self.output_tokens)


@dataclass
class TenantStats:
    """Per-tenant slice of a serving run (gateway multi-tenancy)."""
    tenant: str
    n_requests: int = 0            # completed requests
    total_output_tokens: int = 0
    ttft_p50: float = 0.0
    ttft_p95: float = 0.0
    latency_p50: float = 0.0
    latency_p95: float = 0.0
    shed: int = 0                  # admissions refused (429/503)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.__dict__)

    @classmethod
    def from_requests(cls, tenant: str, reqs: Sequence[RequestStats],
                      shed: int = 0) -> "TenantStats":
        ttfts = [r.ttft for r in reqs]
        lats = [r.latency for r in reqs]
        return cls(tenant=tenant, n_requests=len(reqs),
                   total_output_tokens=sum(r.n_out for r in reqs),
                   ttft_p50=percentile(ttfts, 50),
                   ttft_p95=percentile(ttfts, 95),
                   latency_p50=percentile(lats, 50),
                   latency_p95=percentile(lats, 95), shed=shed)


@dataclass
class ServingReport:
    """Aggregate over a batch of completed requests."""
    n_requests: int
    total_output_tokens: int
    wall_s: float
    throughput_tok_s: float        # aggregate generated tokens / wall
    ttft_p50: float
    ttft_p90: float
    ttft_p99: float
    latency_p50: float
    latency_p99: float
    queue_wait_p50: float
    per_peer: Dict[str, object] = field(default_factory=dict)
    overlap_hidden_s: float = 0.0
    chunks_down: int = 0
    per_tenant: Dict[str, TenantStats] = field(default_factory=dict)
    shed_requests: int = 0

    @classmethod
    def from_requests(cls, reqs: Sequence[RequestStats], wall_s: float,
                      per_peer: Dict[str, PeerStats] = None,
                      shed: Dict[str, int] = None) -> "ServingReport":
        """``shed`` maps tenant -> admissions refused; shed requests
        never completed, so they appear only in the shed counters, not
        the latency percentiles (which cover admitted work)."""
        shed = dict(shed or {})
        by_tenant: Dict[str, List[RequestStats]] = {}
        for r in reqs:
            by_tenant.setdefault(r.tenant, []).append(r)
        per_tenant = {}
        if shed or any(t for t in by_tenant):
            for t in sorted(set(by_tenant) | set(shed)):
                per_tenant[t] = TenantStats.from_requests(
                    t, by_tenant.get(t, ()), shed=shed.get(t, 0))
        ttfts = [r.ttft for r in reqs]
        lats = [r.latency for r in reqs]
        total = sum(r.n_out for r in reqs)
        return cls(
            n_requests=len(reqs), total_output_tokens=total, wall_s=wall_s,
            throughput_tok_s=total / wall_s if wall_s > 0 else 0.0,
            ttft_p50=percentile(ttfts, 50), ttft_p90=percentile(ttfts, 90),
            ttft_p99=percentile(ttfts, 99),
            latency_p50=percentile(lats, 50),
            latency_p99=percentile(lats, 99),
            queue_wait_p50=percentile([r.queue_wait for r in reqs], 50),
            per_peer=dict(per_peer or {}),
            per_tenant=per_tenant, shed_requests=sum(shed.values()))

    def as_dict(self) -> Dict[str, object]:
        d = dict(self.__dict__)
        d["per_peer"] = {k: v.as_dict() for k, v in self.per_peer.items()}
        d["per_tenant"] = {k: v.as_dict() for k, v in self.per_tenant.items()}
        return d
