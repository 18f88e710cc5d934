"""Per-peer circuit breakers for the fetch fabric.

A copy of ``repro.core.cluster.breaker``. A breaker cuts traffic to a
peer that keeps failing instead of paying a bounded but real
``TransportError`` on every plan that touches it:

* **closed**: every request allowed; ``fail_threshold`` consecutive
  failures trip it open (one success resets the count);
* **open**: requests refused for a backoff window that doubles with
  each consecutive open, jittered, up to ``max_backoff_s``;
* **half-open**: after the window exactly one probe goes through;
  success closes the breaker, failure re-opens it. A probe that never
  reports back times out after ``probe_timeout_s``.

Time is passed in (``now``), and the jitter comes from a
``random.Random`` seeded with the CRC32 of the peer id, not ``hash()``,
so it is the same in every process.
"""
from __future__ import annotations

import random
import threading
import zlib
from typing import Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    fail_threshold = 3             # consecutive failures that open it
    base_backoff_s = 0.5           # the first open window
    max_backoff_s = 30.0
    jitter = 0.2                   # windows stretch by up to 20%
    probe_timeout_s = 10.0         # a half-open probe that never reports

    def __init__(self, peer_id: str):
        self.peer_id = peer_id
        self._lock = threading.Lock()
        self.state = CLOSED
        self.failures = 0              # consecutive, while closed
        self.opens = 0                 # consecutive open episodes
        self.open_until = 0.0
        self._probe_inflight = False
        self._probe_t0 = 0.0
        self._rng = random.Random(zlib.crc32(peer_id.encode()))

    def allow(self, now: float) -> bool:
        """May a request go to this peer now? Moves open to half-open
        once the window has passed (the caller becomes the probe)."""
        with self._lock:
            if self.state == CLOSED:
                return True
            if self.state == OPEN:
                if now < self.open_until:
                    return False
                self.state = HALF_OPEN
                self._probe_inflight = False
                return True
            if not self._probe_inflight:
                return True
            return (now - self._probe_t0) > self.probe_timeout_s

    def on_attempt(self, now: float) -> None:
        """A request allowed by :meth:`allow` is in flight; half-open,
        it takes the single probe slot."""
        with self._lock:
            if self.state == HALF_OPEN:
                self._probe_inflight = True
                self._probe_t0 = now

    def record_success(self) -> bool:
        """Returns True when the state changed (half-open to closed)."""
        with self._lock:
            changed = self.state != CLOSED
            self.state = CLOSED
            self.failures = 0
            self.opens = 0
            self.open_until = 0.0
            self._probe_inflight = False
            return changed

    def record_failure(self, now: float) -> Optional[dict]:
        """A transport failure. Returns the open event when this failure
        tripped the breaker (at the threshold, or a failed probe)."""
        with self._lock:
            if self.state == HALF_OPEN:
                return self._open(now, probe_failed=True)
            if self.state == OPEN:
                return None
            self.failures += 1
            if self.failures >= self.fail_threshold:
                return self._open(now, probe_failed=False)
            return None

    def _open(self, now: float, probe_failed: bool) -> dict:
        self.opens += 1                # the caller holds the lock
        backoff = min(self.max_backoff_s,
                      self.base_backoff_s * (2.0 ** (self.opens - 1)))
        backoff *= 1.0 + self.jitter * self._rng.random()
        self.state = OPEN
        self.open_until = now + backoff
        self.failures = 0
        self._probe_inflight = False
        return {"peer": self.peer_id, "backoff_s": backoff,
                "opens": self.opens, "probe_failed": probe_failed,
                "open_until": self.open_until}
