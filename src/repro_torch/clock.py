"""The port's one clock source.

Every duration the port reports comes from :func:`monotonic`, so the
static checker's raw-clock rule (R3) has its sanctioned call sites in
this package here only. :func:`wall` is for absolute stamps (a response's
``created``), never for durations. Device work is asynchronous: callers
synchronise before they read the clock.
"""
from __future__ import annotations

import time


def monotonic() -> float:
    """Seconds on a monotonic clock (arbitrary origin)."""
    return time.perf_counter()  # repro: allow[R3] the port's clock source


def wall() -> float:
    """Epoch seconds, for absolute timestamps only."""
    return time.time()  # repro: allow[R3] the port's wall-clock source
