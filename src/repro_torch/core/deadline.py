"""End-to-end deadline propagation for the fetch fabric.

A copy of ``repro.core.deadline`` on the port's clock. A request that
enters with a latency budget (the gateway's ``deadline_s`` field, or
``EdgeClient.infer(deadline_s=...)``) carries it down through planning,
every fetch attempt and across the wire:

* client side: :func:`deadline_scope` installs a :class:`Deadline` in a
  thread-local; the planner drops candidates whose priced total cannot
  finish within the remaining budget, and the client's walk skips
  attempts whose estimated fetch alone exceeds what is left;
* wire side: :meth:`PeerDirectory.request` / ``request_stream`` stamp
  the remaining seconds into the op payload under :data:`DEADLINE_KEY`
  (the reference's key, so JAX and port peers understand each other).
  The peer server pops it before dispatch and answers an already expired
  request with ``{"ok": False, "deadline_exceeded": True}`` without
  running the handler. With no deadline in scope nothing is added.

The scope is thread-local; code that hops threads (the stream pump, a
hedged GET) hands the deadline over explicitly with :func:`attach`.
Time comes from :func:`repro_torch.clock.monotonic`, or from any object
with a ``now()`` (a ``SimClock``), so sim runs price deadlines on sim
time.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional

from repro_torch import clock as _clock

DEADLINE_KEY = "_deadline"         # the payload key of the remaining budget

_tls = threading.local()


class Deadline:
    """An absolute expiry on an injected clock."""

    def __init__(self, budget_s: float, clock=None):
        self._clock = clock
        self.budget_s = float(budget_s)
        self.t0 = self._now()
        self.expires_at = self.t0 + self.budget_s

    def _now(self) -> float:
        if self._clock is not None:
            return self._clock.now()
        return _clock.monotonic()

    def remaining(self) -> float:
        return self.expires_at - self._now()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def __repr__(self) -> str:
        return (f"Deadline(budget={self.budget_s:.3f}s, "
                f"remaining={self.remaining():.3f}s)")


def current_deadline() -> Optional[Deadline]:
    """The ambient deadline for this thread, or None."""
    return getattr(_tls, "deadline", None)


@contextmanager
def deadline_scope(budget_s: Optional[float], clock=None):
    """Install a deadline for the block. A ``None`` budget is a no-op
    scope (yields None)."""
    if budget_s is None:
        yield None
        return
    dl = Deadline(budget_s, clock=clock)
    prev = getattr(_tls, "deadline", None)
    _tls.deadline = dl
    try:
        yield dl
    finally:
        _tls.deadline = prev


@contextmanager
def attach(dl: Optional[Deadline]):
    """Re-install an existing deadline on this thread (the explicit hand
    over to a pump or hedge thread)."""
    prev = getattr(_tls, "deadline", None)
    _tls.deadline = dl
    try:
        yield dl
    finally:
        _tls.deadline = prev


def inject_deadline(payload: dict) -> dict:
    """A copy of ``payload`` stamped with the ambient deadline's remaining
    seconds, or ``payload`` itself when no deadline is in scope. Only the
    remaining budget crosses the wire: the two processes share no
    clock."""
    dl = current_deadline()
    if dl is None:
        return payload
    out = dict(payload)
    out[DEADLINE_KEY] = dl.remaining()
    return out


def expired_reply(payload: dict) -> Optional[dict]:
    """Pop :data:`DEADLINE_KEY` from a request ``payload``; the reply a
    server sends without running the handler when the budget is already
    spent, else None."""
    rem = payload.pop(DEADLINE_KEY, None)
    if rem is not None and float(rem) <= 0.0:
        return {"ok": False, "error": "deadline exceeded",
                "deadline_exceeded": True}
    return None
