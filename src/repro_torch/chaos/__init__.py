"""Deterministic fault injection (the chaos layer).

The port's copy of ``repro.chaos``. Faults are data: a
:class:`FaultSchedule` is a seed-drawn, JSON-serializable list of
:class:`FaultEvent` entries (kills and revives, partitions, bandwidth
collapse, corrupt chunks, stalled streams, delayed acks, each with its
heal) that a :class:`FaultDriver` replays against a live
:class:`~repro_torch.core.net.supervisor.PeerSupervisor` fleet; the same
seed gives the same events in the same order, the reference's too. For
in-process fabrics :class:`ChaosLink` and :class:`ChaosSimNetwork` apply
the same faults at the transport. Like the daemons it drives, it imports
no ``torch``.
"""
from repro_torch.chaos.driver import FaultDriver
from repro_torch.chaos.injectors import ChaosLink, ChaosSimNetwork
from repro_torch.chaos.schedule import FaultEvent, FaultSchedule

__all__ = ["FaultDriver", "FaultEvent", "FaultSchedule",
           "ChaosLink", "ChaosSimNetwork"]
