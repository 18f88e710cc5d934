"""Failure flight recorder: a bounded ring of serving events.

The port's copy of ``repro.obs.flight``. Every layer records cheap
structured events into the process-wide :data:`FLIGHT` ring
(``FLIGHT.record("fetch.attempt", peer=..., hit=...)``). Nothing is
written until something goes wrong: a *trigger* — a plan with every
attempt failed (:data:`PLAN_EXHAUSTED`), a corrupt chunk
(:data:`CHUNK_ERROR`), an admission shed (:data:`SHED`), a dead peer
(:data:`PEER_DEATH`), an estimator out of band
(:data:`ESTIMATOR_DRIFT`), a breaker that opens — freezes the last
events into a **dump**::

    {"reason": "chunk_error", "at": <epoch s>, "mono": <monotonic s>,
     "context": {...},                 # the trigger site's details
     "events": [{"ev": ..., "mono": ..., "seq": ..., ...}, ...]}

Dumps are kept in a small bounded list (``FLIGHT.dumps()``) and served
by the gateway at ``GET /v1/flight``. Recording costs a dict and a deque
append under a lock: no I/O, no formatting. Standard library only.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

from repro_torch import clock

# canonical trigger reasons (free-form strings are allowed too)
PLAN_EXHAUSTED = "plan_exhausted"
CHUNK_ERROR = "chunk_error"
SHED = "shed"
PEER_DEATH = "peer_death"
ESTIMATOR_DRIFT = "estimator_drift"
BREAKER_OPEN = "breaker_open"
RESTART_CIRCUIT_OPEN = "restart_circuit_open"

# events the ring keeps, and dumps kept (the oldest go first)
CAPACITY, MAX_DUMPS = 512, 32


class FlightRecorder:
    """Bounded ring buffer of events with trigger-time dumps."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ring: "deque[dict]" = deque(maxlen=CAPACITY)
        self._dumps: "deque[dict]" = deque(maxlen=MAX_DUMPS)
        self._seq = 0

    def record(self, ev: str, **fields) -> None:
        """Append one event to the ring. ``ev`` is a dotted kind
        (``fetch.attempt``, ``gw.shed``, ``peer.suspect`` …)."""
        entry = {"ev": ev, "mono": clock.monotonic()}
        if fields:
            entry.update(fields)
        with self._lock:
            self._seq += 1
            entry["seq"] = self._seq
            self._ring.append(entry)

    def trigger(self, reason: str, **context) -> dict:
        """Freeze the ring into a dump. Returns the dump dict (also
        retained in :meth:`dumps`)."""
        with self._lock:
            events = list(self._ring)
        dump = {"reason": reason, "at": clock.wall(),
                "mono": clock.monotonic(),
                "context": {k: _plain(v) for k, v in context.items()},
                "events": events}
        with self._lock:
            self._dumps.append(dump)
        return dump

    def dumps(self) -> List[dict]:
        with self._lock:
            return list(self._dumps)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {"events": len(self._ring), "seq": self._seq,
                    "dumps": len(self._dumps),
                    "capacity": CAPACITY}

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._dumps.clear()
            self._seq = 0


def _plain(v):
    if isinstance(v, (str, int, float, bool, type(None))):
        return v
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _plain(x) for k, x in v.items()}
    return repr(v)


# process-wide recorder: daemons, client, gateway all feed this one
FLIGHT = FlightRecorder()
