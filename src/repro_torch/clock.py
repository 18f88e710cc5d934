"""The port's one clock source.

Every duration the port reports comes from :func:`monotonic`, so the
static checker's raw-clock rule (R3) has its sanctioned call sites in
this package here only. :func:`wall` is for absolute stamps (a response's
``created``, a flight dump's ``at``), never for durations. Device work is
asynchronous: callers synchronise before they read the clock.

Tests freeze both sources with :func:`mocked` and a :class:`MockClock`
instead of sleeping. Imports nothing but the standard library: the peer
daemons read it too.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

_mono = time.perf_counter  # repro: allow[R3] the port's clock source
_wall = time.time  # repro: allow[R3] the port's wall-clock source


def monotonic() -> float:
    """Seconds on a monotonic clock (arbitrary origin)."""
    return _mono()


def wall() -> float:
    """Epoch seconds, for absolute timestamps only."""
    return _wall()


class MockClock:
    """A clock advanced by hand; install it with :func:`mocked`."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> "MockClock":
        self.t += dt
        return self

    def now(self) -> float:
        """The ``SimClock`` spelling, so a ``MockClock`` can stand in
        for one."""
        return self.t


def set_sources(mono=None, wall=None) -> None:
    """Swap the time sources (``None`` restores the default)."""
    global _mono, _wall
    _mono = mono or time.perf_counter  # repro: allow[R3] the clock source
    _wall = wall or time.time  # repro: allow[R3] the wall-clock source


@contextmanager
def mocked(clock: MockClock = None):
    """Both sources read ``clock`` (a fresh :class:`MockClock` by
    default) inside the ``with`` block; yields the clock."""
    clock = clock or MockClock()
    set_sources(clock, clock)
    try:
        yield clock
    finally:
        set_sources()
