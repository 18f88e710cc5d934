"""Estimator calibration: estimate-vs-actual error and drift alarms.

The port's copy of ``repro.obs.calibrate``. The planner prices each
candidate from the link estimator's beliefs; this module tracks how
wrong those prices turn out. Every realized transfer
(``PeerDirectory.record_get`` hits, ``record_chunk`` samples) feeds
:meth:`CalibrationTracker.observe` with the estimated and the actual
seconds, and the tracker keeps, a peer, the signed relative error
``(est - actual) / actual``: its EWMA (``ewma``: bias; a throttled link
drives it toward -1), its running mean absolute value, and a window of
the last actual/estimate ratios, whose p95 (:meth:`p95_ratio`) is the
hedged fetch's patience.

Drift: once a peer has ``MIN_OBS`` samples and ``|ewma|`` reaches
``BAND``, the tracker fires one :data:`~repro_torch.obs.flight.ESTIMATOR_DRIFT`
flight trigger and sets the ``repro_estimator_drift{peer}`` gauge; the
flag clears only below ``BAND / 2`` (hysteresis), so a link at the
boundary does not flap. :func:`catalog_fp_probe` sets a Bloom filter's
predicted false-positive rate beside the served miss rate (a daemon's
``health``).
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

from repro_torch.obs.flight import ESTIMATOR_DRIFT, FLIGHT
from repro_torch.obs.metrics import REGISTRY

_EPS = 1e-9
# the error EWMA's weight of a new sample; the drift band on |ewma|
# (cleared below half of it); the samples a peer needs before it can drift
ALPHA, BAND, MIN_OBS = 0.3, 0.5, 4


class _PeerCal:
    __slots__ = ("n", "ewma", "abs_sum", "last_est_s", "last_actual_s",
                 "last_bytes", "drift", "drift_events", "ratios")

    # recent actual/est ratios kept for the hedging p95: small and
    # recency-biased on purpose — hedges must adapt to the link NOW
    RATIO_WINDOW = 32

    def __init__(self):
        self.n = 0
        self.ewma = 0.0
        self.abs_sum = 0.0
        self.last_est_s = 0.0
        self.last_actual_s = 0.0
        self.last_bytes = 0
        self.drift = False
        self.drift_events = 0
        from collections import deque
        self.ratios = deque(maxlen=self.RATIO_WINDOW)


class CalibrationTracker:
    """Per-peer est-vs-actual error EWMAs with banded drift alarms."""

    def __init__(self):
        self._lock = threading.Lock()
        self._peers: Dict[str, _PeerCal] = {}
        self._g_drift = REGISTRY.gauge(
            "repro_estimator_drift",
            "1 while a peer's link estimator is drifted out of band",
            ("peer",))
        self._g_err = REGISTRY.gauge(
            "repro_estimator_rel_err",
            "EWMA signed relative error (est-actual)/actual per peer",
            ("peer",))

    def observe(self, peer: str, est_s: float, actual_s: float,
                nbytes: int = 0) -> None:
        """Fold one realized transfer into the peer's error EWMA.
        Samples without a meaningful estimate or measurement are
        dropped (cold estimator, zero-duration sim hops)."""
        if est_s <= 0.0 or actual_s <= _EPS:
            return
        err = (est_s - actual_s) / max(actual_s, _EPS)
        fire = None
        with self._lock:
            pc = self._peers.get(peer)
            if pc is None:
                pc = self._peers[peer] = _PeerCal()
            pc.n += 1
            pc.abs_sum += abs(err)
            pc.ewma = (err if pc.n == 1
                       else ALPHA * err + (1 - ALPHA) * pc.ewma)
            pc.last_est_s, pc.last_actual_s = est_s, actual_s
            pc.last_bytes = int(nbytes)
            pc.ratios.append(actual_s / est_s)
            if pc.n >= MIN_OBS:
                if not pc.drift and abs(pc.ewma) >= BAND:
                    pc.drift = True
                    pc.drift_events += 1
                    fire = dict(peer=peer, ewma=pc.ewma, n=pc.n,
                                est_s=est_s, actual_s=actual_s,
                                nbytes=int(nbytes))
                elif pc.drift and abs(pc.ewma) < BAND / 2.0:
                    pc.drift = False
            ewma, drift = pc.ewma, pc.drift
        self._g_err.labels(peer=peer).set(ewma)
        self._g_drift.labels(peer=peer).set(1.0 if drift else 0.0)
        if fire is not None:
            FLIGHT.trigger(ESTIMATOR_DRIFT, **fire)

    def p95_ratio(self, peer: str, default: float = 1.5) -> float:
        """The p95 of the peer's recent actual/est ratios — the
        calibrated patience bound for hedged fetches: an attempt still
        outstanding past ``est * p95_ratio`` is an anomaly worth firing
        the plan's #2 candidate over. Falls back to ``default`` until
        the window has a few samples."""
        with self._lock:
            pc = self._peers.get(peer)
            if pc is None or len(pc.ratios) < 4:
                return default
            xs = sorted(pc.ratios)
        return xs[min(len(xs) - 1, int(0.95 * len(xs)))]

    def snapshot(self) -> Dict[str, dict]:
        """Per-peer calibration state (daemon ``health`` / console)."""
        with self._lock:
            return {p: {"n": pc.n,
                        "ewma_rel_err": pc.ewma,
                        "mean_abs_err": (pc.abs_sum / pc.n if pc.n
                                         else 0.0),
                        "drift": pc.drift,
                        "drift_events": pc.drift_events,
                        "last_est_s": pc.last_est_s,
                        "last_actual_s": pc.last_actual_s,
                        "last_bytes": pc.last_bytes}
                    for p, pc in self._peers.items()}


def catalog_fp_probe(bloom, gets: int, misses: int,
                     tombstones: int = 0) -> Dict[str, object]:
    """Predicted-vs-realized Bloom false-positive probe for one
    catalog. ``predicted`` is the filter's analytic FP rate at its
    current fill ``(1 - e^{-kn/m})^k``; ``realized`` is the served
    miss rate (a GET only reaches a peer when some catalog predicted
    the key present, so every miss *is* a stale-catalog FP — evictions
    leave tombstoned keys in remote Blooms). Reported per peer in
    daemon ``health``, merged fleet-wide by the supervisor."""
    import math

    predicted = 0.0
    if bloom is not None:
        fp = getattr(bloom, "expected_fp_rate", None)
        if callable(fp):
            predicted = float(fp())
        else:
            m = getattr(bloom, "m", 0) or 0
            k = getattr(bloom, "k", 0) or 0
            n = getattr(bloom, "n_added", 0)
            if m and k:
                predicted = (1.0 - math.exp(
                    -float(k) * float(n) / float(m))) ** k
    return {"predicted": predicted,
            "realized": (misses / gets) if gets else 0.0,
            "gets": int(gets), "misses": int(misses),
            "tombstones": int(tombstones)}
