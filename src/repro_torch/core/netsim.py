"""Deterministic network and clock simulation (the paper's Wi-Fi 4).

A copy of ``repro.core.netsim``. Latency model: rtt + bytes * 8 /
bandwidth, calibrated to the paper's measurement (a 2.25 MB prompt cache
in ~0.86 s, ~21 Mb/s effective over 2.4 GHz Wi-Fi 4). These are modeled
seconds of an emulated edge link, never a reading of this machine.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch import clock


class SimClock:
    """A virtual clock; latency accounting advances it explicitly."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"a clock cannot go back ({dt} s)")
        self.t += dt

    def now(self) -> float:
        return self.t


class WallClock:
    """The sim clock's interface over the monotonic clock, for the real
    (TCP) fabric: the directory's sync rate limit and suspect cooldowns
    read ``now()``, and nothing is advanced."""

    def advance(self, dt: float) -> None:
        pass                           # real time advances itself

    def now(self) -> float:
        return clock.monotonic()


@dataclass
class SimNetwork:
    bandwidth_bps: float = 21e6
    rtt_s: float = 0.003

    def transfer_time(self, nbytes: int) -> float:
        return self.rtt_s + nbytes * 8.0 / self.bandwidth_bps
