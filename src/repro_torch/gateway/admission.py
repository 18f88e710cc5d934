"""Per-tenant quotas, admission control, and load shedding.

A copy of ``repro.gateway.admission`` on the port's clock. Pure
bookkeeping — no torch, no sockets — shared by the asyncio handlers
(admit on arrival) and the engine thread (release on completion), so
everything mutates under one lock.

Two rejection tiers, matching HTTP semantics:

* **429 Too Many Requests** — the *tenant* is over its quota (request
  rate or concurrent in-flight). The cluster has room; this caller
  does not. ``Retry-After`` is the time until the tenant's token
  bucket refills (rate) or an EWMA of request latency (concurrency).
* **503 Service Unavailable** — the *gateway* is out of capacity:
  every engine slot busy and the bounded admission queue full. Load
  is shed instead of queued unboundedly — bounded queue depth is what
  keeps admitted requests' p95 bounded under overload.
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from repro_torch import clock as _clock


@dataclass(frozen=True)
class TenantQuota:
    """Per-tenant limits. ``rate_per_s=0`` disables rate limiting;
    ``burst=0`` defaults the bucket to ``max(1, ceil(rate))``."""
    max_concurrent: int = 8
    rate_per_s: float = 0.0
    burst: int = 0

    def __post_init__(self):
        if self.max_concurrent < 1:
            raise ValueError("max_concurrent must be >= 1")
        if self.rate_per_s < 0:
            raise ValueError("rate_per_s must be >= 0")
        if self.burst < 0:
            raise ValueError("burst must be >= 0")

    @property
    def bucket_size(self) -> float:
        if self.rate_per_s <= 0:
            return math.inf
        return float(self.burst or max(1, math.ceil(self.rate_per_s)))


class ShedError(Exception):
    """An admission refusal: carries the HTTP status, a Retry-After
    estimate (seconds), and the reason bucket for the shed counters."""

    def __init__(self, status: int, retry_after_s: float, reason: str,
                 tenant: str):
        super().__init__(f"{status} shed ({reason}) for tenant "
                         f"{tenant!r}; retry after {retry_after_s:.1f}s")
        self.status = status
        self.retry_after_s = retry_after_s
        self.reason = reason
        self.tenant = tenant


class _TenantState:
    def __init__(self, quota: TenantQuota, now: float):
        self.quota = quota
        self.inflight = 0
        self.tokens = quota.bucket_size     # token bucket (requests)
        self.refill_t = now
        self.shed = 0


class AdmissionController:
    """Admit-or-shed for the gateway front door.

    ``max_inflight`` should equal the engine's slot count; ``queue_depth``
    is the extra admitted-but-not-yet-prefilled headroom. Together they
    bound the admitted population — everything beyond is shed with 503.
    """

    def __init__(self, max_inflight: int, queue_depth: int = 0,
                 default_quota: TenantQuota = TenantQuota(),
                 quotas: Optional[Dict[str, TenantQuota]] = None,
                 clock: Callable[[], float] = _clock.monotonic):
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        if queue_depth < 0:
            raise ValueError("queue_depth must be >= 0")
        self.max_inflight = max_inflight
        self.queue_depth = queue_depth
        self.default_quota = default_quota
        self.quotas = dict(quotas or {})
        self.clock = clock
        self.lock = threading.Lock()
        self.tenants: Dict[str, _TenantState] = {}
        self.inflight = 0
        self.latency_ewma_s = 0.5          # seeds the Retry-After estimate
        self.shed_by_reason = {"capacity": 0, "tenant_rate": 0,
                               "tenant_concurrency": 0}

    # ------------------------------------------------------------------
    def _tenant(self, tenant: str, now: float) -> _TenantState:
        st = self.tenants.get(tenant)
        if st is None:
            st = self.tenants[tenant] = _TenantState(
                self.quotas.get(tenant, self.default_quota), now)
        return st

    def _refill(self, st: _TenantState, now: float) -> None:
        q = st.quota
        if q.rate_per_s <= 0:
            return
        st.tokens = min(q.bucket_size,
                        st.tokens + (now - st.refill_t) * q.rate_per_s)
        st.refill_t = now

    # ------------------------------------------------------------------
    def admit(self, tenant: str) -> None:
        """Admit one request or raise :class:`ShedError`. A successful
        admit MUST be paired with :meth:`release` when the request
        finishes (or fails downstream)."""
        now = self.clock()
        with self.lock:
            st = self._tenant(tenant, now)
            q = st.quota
            self._refill(st, now)
            if q.rate_per_s > 0 and st.tokens < 1.0:
                st.shed += 1
                self.shed_by_reason["tenant_rate"] += 1
                wait = (1.0 - st.tokens) / q.rate_per_s
                raise ShedError(429, max(wait, 0.1), "tenant_rate",
                                tenant)
            if st.inflight >= q.max_concurrent:
                st.shed += 1
                self.shed_by_reason["tenant_concurrency"] += 1
                raise ShedError(429, max(self.latency_ewma_s, 0.1),
                                "tenant_concurrency", tenant)
            if self.inflight >= self.max_inflight + self.queue_depth:
                st.shed += 1
                self.shed_by_reason["capacity"] += 1
                # the backlog drains roughly one slot-batch per EWMA
                # latency — estimate how long until a slot frees up
                depth = self.inflight - self.max_inflight + 1
                wait = self.latency_ewma_s * max(
                    depth / self.max_inflight, 1.0)
                raise ShedError(503, min(max(wait, 0.5), 30.0),
                                "capacity", tenant)
            if q.rate_per_s > 0:
                st.tokens -= 1.0
            st.inflight += 1
            self.inflight += 1

    def release(self, tenant: str,
                latency_s: Optional[float] = None) -> None:
        with self.lock:
            st = self.tenants.get(tenant)
            if st is not None and st.inflight > 0:
                st.inflight -= 1
            if self.inflight > 0:
                self.inflight -= 1
            if latency_s is not None and latency_s >= 0:
                self.latency_ewma_s += 0.3 * (latency_s
                                              - self.latency_ewma_s)

    # ------------------------------------------------------------------
    def shed_counts(self) -> Dict[str, int]:
        """tenant -> total admissions refused (for ServingReport)."""
        with self.lock:
            return {t: st.shed for t, st in self.tenants.items()
                    if st.shed}

    def snapshot(self) -> dict:
        with self.lock:
            return {
                "inflight": self.inflight,
                "max_inflight": self.max_inflight,
                "queue_depth": self.queue_depth,
                "latency_ewma_s": self.latency_ewma_s,
                "shed_by_reason": dict(self.shed_by_reason),
                "tenants": {t: {"inflight": st.inflight,
                                "shed": st.shed}
                            for t, st in self.tenants.items()},
            }
