"""Seeded, replayable fault schedules.

The port's copy of ``repro.chaos.schedule``: the same seed, peers and
sizes give the reference's events letter for letter. A schedule is drawn
once from a private ``random.Random(seed)`` (never the wall clock, never
``hash()``), so it is the same across processes and ``PYTHONHASHSEED``
values; ``event_order()`` is the fingerprint two replays are compared
by. Events are indexed by step (a driver advances one request a step),
not stamped with wall time.
"""
from __future__ import annotations

import json
import random
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Sequence

# every kind the driver knows how to apply; generate() draws from the
# injectable subset and pairs each fault with its heal
KINDS = ("kill", "revive", "bandwidth", "corrupt", "stall",
         "delay_ack", "partition", "heal")
# the faults generate() cycles through, in this order
INJECTABLE = ("kill", "partition", "corrupt", "stall", "bandwidth",
              "delay_ack")


@dataclass
class FaultEvent:
    step: int                  # schedule step the driver fires this at
    kind: str                  # one of KINDS
    peer: str                  # target peer id
    # kind-specific knobs (bps for bandwidth, chunks for corrupt /
    # close, seconds for stall/delay) — JSON-safe scalars only
    args: Dict[str, object] = field(default_factory=dict)

    def fingerprint(self) -> str:
        args = ",".join(f"{k}={self.args[k]}"
                        for k in sorted(self.args))
        return f"{self.step}:{self.kind}:{self.peer}:{args}"


class FaultSchedule:
    """An ordered list of :class:`FaultEvent` plus its provenance."""

    def __init__(self, events: Sequence[FaultEvent], seed: int = 0,
                 n_steps: int = 0):
        self.events: List[FaultEvent] = sorted(
            events, key=lambda e: (e.step, e.kind, e.peer))
        self.seed = seed
        self.n_steps = n_steps

    # -- generation ----------------------------------------------------
    @classmethod
    def generate(cls, seed: int, peers: Sequence[str],
                 n_steps: int = 30, n_faults: int = 6,
                 heal_after: int = 3) -> "FaultSchedule":
        """Deterministically draw ``n_faults`` faults over ``n_steps``
        schedule steps. Every fault gets its matching heal
        ``heal_after`` steps later (revive for kill, heal/reset for
        the injected flags), so the fleet always converges back to
        healthy — a drill must end in a repairable state to assert
        repair. Cycling through :data:`INJECTABLE` before redrawing
        covers every kind when ``n_faults >= len(INJECTABLE)``."""
        if not peers:
            raise ValueError("need at least one peer")
        rng = random.Random(seed)
        events: List[FaultEvent] = []
        # spread fault start steps over the schedule, leaving room for
        # the final heal to land inside it
        last_start = max(n_steps - heal_after - 1, 1)
        for i in range(n_faults):
            kind = INJECTABLE[i % len(INJECTABLE)]
            peer = rng.choice(list(peers))
            step = rng.randint(1, last_start)
            if kind == "kill":
                events.append(FaultEvent(step, "kill", peer))
                events.append(FaultEvent(step + heal_after, "revive",
                                         peer))
            elif kind == "bandwidth":
                bps = rng.choice([2_000_000.0, 4_000_000.0])
                events.append(FaultEvent(step, "bandwidth", peer,
                                         {"bps": bps}))
                events.append(FaultEvent(step + heal_after,
                                         "bandwidth", peer,
                                         {"bps": None}))
            elif kind == "corrupt":
                events.append(FaultEvent(step, "corrupt", peer,
                                         {"chunks": rng.randint(1, 3)}))
                events.append(FaultEvent(step + heal_after, "heal",
                                         peer))
            elif kind == "stall":
                events.append(FaultEvent(
                    step, "stall", peer,
                    {"seconds": round(rng.uniform(0.05, 0.2), 3)}))
                events.append(FaultEvent(step + heal_after, "heal",
                                         peer))
            elif kind == "delay_ack":
                events.append(FaultEvent(
                    step, "delay_ack", peer,
                    {"seconds": round(rng.uniform(0.05, 0.15), 3)}))
                events.append(FaultEvent(step + heal_after, "heal",
                                         peer))
            elif kind == "partition":
                events.append(FaultEvent(step, "partition", peer))
                events.append(FaultEvent(step + heal_after, "heal",
                                         peer))
            else:
                raise ValueError(f"unknown fault kind {kind!r}")
        return cls(events, seed=seed, n_steps=n_steps)

    # -- replay fingerprint --------------------------------------------
    def event_order(self) -> List[str]:
        """Canonical ordered fingerprint — two schedules replay the
        same chaos iff their event_order()s are equal."""
        return [e.fingerprint() for e in self.events]

    def at(self, step: int) -> List[FaultEvent]:
        return [e for e in self.events if e.step == step]

    def faults(self) -> List[FaultEvent]:
        """Only the degrading events (heals/revives excluded)."""
        return [e for e in self.events
                if e.kind not in ("revive", "heal")
                and not (e.kind == "bandwidth"
                         and e.args.get("bps") is None)]

    # -- (de)serialization --------------------------------------------
    def to_json(self) -> str:
        return json.dumps({"seed": self.seed, "n_steps": self.n_steps,
                           "events": [asdict(e) for e in self.events]},
                          indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "FaultSchedule":
        doc = json.loads(text)
        return cls([FaultEvent(int(e["step"]), e["kind"], e["peer"],
                               dict(e.get("args", {})))
                    for e in doc["events"]],
                   seed=int(doc.get("seed", 0)),
                   n_steps=int(doc.get("n_steps", 0)))
