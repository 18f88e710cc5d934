"""In-process chaos injectors: faults for fabrics without sockets.

The port's copy of ``repro.chaos.injectors``. On the TCP fabric faults
are injected server-side (the daemon's ``inject`` op); an in-process
fabric has no daemon, so these wrappers apply the same faults at the
transport boundary:

* :class:`ChaosLink` wraps a peer link or transport and can drop
  requests (``TransportError``), delay them, or flip a byte of the next
  streamed chunks before the client's digests see them;
* :class:`ChaosSimNetwork` wraps a
  :class:`~repro_torch.core.netsim.SimNetwork` and scales its modeled
  bandwidth and RTT: a silent collapse that only the estimator's
  calibration sees.

Both are transparent until a fault is armed (set an attribute).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.transport import TransportError
from repro_torch.obs.flight import FLIGHT


class ChaosLink:
    """Transparent proxy over a peer link with armable faults.

    ``drop_requests`` — raise :class:`TransportError` on every request
    (an unreachable peer); ``fail_next`` — raise on the next N
    requests then auto-disarm (a flapping peer); ``corrupt_chunks`` —
    flip the first byte of the next N streamed chunks;
    ``delay_s`` — advance the wrapped clock / sleep before each
    request (only meaningful on wall links).
    """

    def __init__(self, link):
        self._link = link
        self.drop_requests = False
        self.fail_next = 0
        self.corrupt_chunks = 0
        self.delay_s = 0.0

    # attribute passthrough keeps the wrapper drop-in for the
    # directory (peer_id, net, catalog wiring, close, ...)
    def __getattr__(self, name):
        return getattr(self._link, name)

    def _gate(self, op: str) -> None:
        if self.delay_s:
            import time
            time.sleep(self.delay_s)
        if self.drop_requests or self.fail_next > 0:
            if self.fail_next > 0:
                self.fail_next -= 1
            FLIGHT.record("chaos.fault", kind="drop_request", op=op,
                          peer=getattr(self._link, "peer_id", "?"))
            raise TransportError(
                f"chaos: injected drop for op {op!r}")

    def request(self, op, payload, **kw):
        self._gate(op)
        return self._link.request(op, payload, **kw)

    def request_stream(self, op, payload, on_chunk, **kw):
        self._gate(op)

        def tap(chunk, dt, nb):
            # a transport hands on_chunk the chunk's bytes (the
            # reference's tap reads a dict here, and raises)
            if self.corrupt_chunks > 0 and chunk:
                self.corrupt_chunks -= 1
                chunk = bytes([chunk[0] ^ 0xFF]) + bytes(chunk[1:])
                FLIGHT.record("chaos.fault", kind="corrupt_chunk",
                              op=op,
                              peer=getattr(self._link, "peer_id", "?"))
            on_chunk(chunk, dt, nb)

        return self._link.request_stream(op, payload, tap, **kw)


class ChaosSimNetwork:
    """A :class:`SimNetwork` view with degradable bandwidth/RTT.

    ``degrade(bw_factor, rtt_factor)`` scales the modeled link;
    ``heal()`` restores nominal. The planner keeps pricing from the
    estimator's (stale) beliefs while modeled transfers slow down —
    exactly the silent-bandwidth-collapse miscalibration the drift
    alarm exists to catch."""

    def __init__(self, net):
        self._net = net
        self.bw_factor = 1.0
        self.rtt_factor = 1.0

    @property
    def bandwidth_bps(self) -> float:
        return self._net.bandwidth_bps * self.bw_factor

    @property
    def rtt_s(self) -> float:
        return self._net.rtt_s * self.rtt_factor

    def transfer_time(self, nbytes: int) -> float:
        return self.rtt_s + nbytes * 8.0 / max(self.bandwidth_bps, 1.0)

    def degrade(self, bw_factor: float = 0.1,
                rtt_factor: Optional[float] = None) -> None:
        self.bw_factor = bw_factor
        if rtt_factor is not None:
            self.rtt_factor = rtt_factor
        FLIGHT.record("chaos.fault", kind="sim_degrade",
                      bw_factor=self.bw_factor,
                      rtt_factor=self.rtt_factor)

    def heal(self) -> None:
        self.bw_factor = 1.0
        self.rtt_factor = 1.0
