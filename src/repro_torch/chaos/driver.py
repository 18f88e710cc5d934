"""Replay a :class:`FaultSchedule` against a live TCP fleet.

The port's copy of ``repro.chaos.driver``: each fault kind maps onto one
:class:`~repro_torch.core.net.supervisor.PeerSupervisor` surface —

========== =====================================================
kind       applied as
========== =====================================================
kill       ``sup.kill(peer, hard=True)`` (SIGKILL, no drain)
revive     ``sup.restart(peer)`` (same id, same port, cold store)
bandwidth  ``sup.set_throttle(peer, bps)`` (``bps=None`` lifts it)
corrupt    ``inject {corrupt_chunks: n}`` (flip a byte in the next
           n stream chunks: the per-chunk digests catch it)
stall      ``inject {stall_chunk_s: s}`` (sleep before every chunk)
delay_ack  ``inject {delay_ack_s: s}`` (slow single-frame replies)
partition  ``inject {partition_inbound: true}`` (the peer reads and
           never answers; its own gossip and pushes still flow)
heal       ``inject {reset: true}`` (clears every injected flag)
========== =====================================================

``advance(step)`` fires what is scheduled up to ``step`` in canonical
order; an event aimed at a peer that is dead at the time is recorded
and skipped, not an error (a schedule may corrupt a peer another event
killed: that interleaving is the point).
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.chaos.schedule import FaultEvent, FaultSchedule
from repro_torch.core.transport import TransportError
from repro_torch.obs.flight import FLIGHT

# FaultEvent kind -> PeerServer.chaos flag for the inject-op kinds
_INJECT_FLAGS = {"corrupt": "corrupt_chunks",
                 "stall": "stall_chunk_s",
                 "delay_ack": "delay_ack_s",
                 "partition": "partition_inbound"}


class FaultDriver:
    def __init__(self, sup, schedule: FaultSchedule):
        self.sup = sup
        self.schedule = schedule
        self.cursor = 0            # first step not yet fired
        self.applied: List[FaultEvent] = []
        self.skipped: List[FaultEvent] = []

    def advance(self, step: int) -> List[FaultEvent]:
        """Fire every event scheduled in ``(cursor-1, step]``."""
        fired: List[FaultEvent] = []
        for s in range(self.cursor, step + 1):
            for ev in self.schedule.at(s):
                self._apply(ev)
                fired.append(ev)
        self.cursor = step + 1
        return fired

    def finish(self) -> List[FaultEvent]:
        """Fire everything left on the schedule (the trailing heals)."""
        return self.advance(max((e.step for e in self.schedule.events),
                                default=self.cursor))

    # ------------------------------------------------------------------
    def _apply(self, ev: FaultEvent) -> None:
        FLIGHT.record("chaos.apply", step=ev.step, kind=ev.kind,
                      peer=ev.peer, **{str(k): v
                                       for k, v in ev.args.items()})
        try:
            if ev.kind == "kill":
                self.sup.kill(ev.peer, hard=True)
            elif ev.kind == "revive":
                self.sup.restart(ev.peer)
            elif ev.kind == "bandwidth":
                self.sup.set_throttle(ev.peer, ev.args.get("bps"))
            elif ev.kind == "heal":
                self.sup.inject_faults(ev.peer, reset=True)
            elif ev.kind in _INJECT_FLAGS:
                flag = _INJECT_FLAGS[ev.kind]
                val: object = True if ev.kind == "partition" else \
                    (ev.args.get("chunks") if ev.kind == "corrupt"
                     else ev.args.get("seconds"))
                self.sup.inject_faults(ev.peer, chaos={flag: val})
            else:
                raise ValueError(f"unknown fault kind {ev.kind!r}")
        except TransportError as e:
            # target currently dead (killed earlier in the schedule):
            # record the interleaving and move on — the drill asserts
            # on what was APPLIED, not what was scheduled
            self.skipped.append(ev)
            FLIGHT.record("chaos.skip", step=ev.step, kind=ev.kind,
                          peer=ev.peer, error=repr(e))
            return
        self.applied.append(ev)

    # ------------------------------------------------------------------
    def applied_order(self) -> List[str]:
        """Fingerprints of the events actually applied, in fire
        order — the replay-determinism probe for live runs."""
        return [e.fingerprint() for e in self.applied]

    def heal_all(self, peers: Optional[List[str]] = None) -> None:
        """Best-effort terminal heal: clear chaos flags and throttles
        on every (live) peer so teardown never races leftover faults."""
        for pid in (peers if peers is not None else
                    list(self.sup.procs)):
            try:
                self.sup.inject_faults(pid, reset=True)
                self.sup.set_throttle(pid, None)
            except TransportError as e:
                FLIGHT.record("chaos.heal_failed", peer=pid,
                              error=repr(e))
