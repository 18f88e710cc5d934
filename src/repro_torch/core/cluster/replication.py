"""Peer-side push replication, hinted handoff and ring repair.

A copy of ``repro.core.cluster.replication``. The client ships one copy
of a blob; the peer that accepts it does the fan-out:

* **push replication**: a peer that accepts a client ``put`` pushes the
  blob to the key's other ring owners (the first ``repl_factor`` peers
  of ``ring_order(digest)``) with the ``repl`` op;
* **hinted handoff**: a peer that accepted a blob whose primary it is
  not pushes it to the primary (``handoff``) until the primary acks,
  which is when it has come back;
* **leak repair**: a non-owner drops its stray copy once the handoff
  landed and no push of it is pending;
* **hot hints**: the client sends a small ``hot`` op to the peer that
  served a hot key, and that peer pushes its copy to the target.

``send(peer_id, op, payload)`` is whatever the runtime wires in: a
direct ``handle`` call on the in-process fabric, a pooled
:class:`~repro_torch.core.net.link.TCPPeerLink` on a daemon. A dead
target costs one ``TransportError`` and its task waits for the next
:meth:`Replicator.pump`: the handoff queue is the retry queue.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cluster.placement import PlacementPolicy
from repro_torch.core.transport import TransportError

REPL_FACTOR = 2                    # ring owners a key (the reference's default)


class Replicator:
    """One peer's replication state. Unwired (no ring), every entry point
    is a no-op, so a bare peer behind ``serve_peer_tcp`` works as is."""

    def __init__(self, peer_id: str):
        self.peer_id = peer_id
        self.placement: Optional[PlacementPolicy] = None
        self.repl_factor = 1
        self.immediate = False
        self._send: Optional[Callable[[str, str, dict], dict]] = None
        self._peek: Optional[Callable[[bytes], Optional[bytes]]] = None
        self._drop: Optional[Callable[[bytes], bool]] = None
        self._lock = threading.Lock()
        # one pump at a time: concurrent pumps must not send one batch
        # twice
        self._pump_lock = threading.Lock()
        # (digest, target) -> "repl" | "handoff", in insertion order
        self._tasks: "OrderedDict[Tuple[bytes, str], str]" = OrderedDict()
        self._per_digest: Dict[bytes, int] = {}   # pending pushes a digest
        self._misplaced: set = set()    # accepted here, not owned here
        self._handoff_ok: set = set()   # primary acked the handoff
        self.stats: Dict[str, int] = {
            "repl_pushed": 0, "repl_push_bytes": 0,
            "handoffs": 0, "handoff_bytes": 0,
            "hot_hints": 0, "retries": 0, "rejected": 0, "dropped": 0,
            "rounds": 0, "leaks_repaired": 0,
            "repl_in": 0, "repl_in_bytes": 0,
            "handoff_in": 0, "handoff_in_bytes": 0,
        }

    @property
    def wired(self) -> bool:
        return self.placement is not None and self._send is not None

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._tasks)

    def wire(self, ring: Sequence[str],
             send: Callable[[str, str, dict], dict],
             peek: Callable[[bytes], Optional[bytes]],
             drop: Callable[[bytes], bool],
             repl_factor: int = REPL_FACTOR,
             immediate: bool = False) -> None:
        """Teach this peer the ring and how to reach the others.
        ``immediate`` pumps on every enqueue (the deterministic in-process
        fabric); daemons pump from their gossip thread. Re-wiring keeps
        pending tasks."""
        with self._lock:
            self.placement = PlacementPolicy(sorted(ring))
            self._send = send
            self._peek = peek
            self._drop = drop
            self.repl_factor = max(1, min(repl_factor, len(ring)))
            self.immediate = immediate

    def _add_task(self, digest: bytes, target: str, kind: str) -> bool:
        if (digest, target) in self._tasks:      # caller holds _lock
            return False
        self._tasks[(digest, target)] = kind
        self._per_digest[digest] = self._per_digest.get(digest, 0) + 1
        return True

    def _pop_task(self, digest: bytes, target: str) -> None:
        if self._tasks.pop((digest, target), None) is None:
            return                                # caller holds _lock
        left = self._per_digest.get(digest, 0) - 1
        if left > 0:
            self._per_digest[digest] = left
        else:
            self._per_digest.pop(digest, None)

    def owners(self, digest: bytes) -> List[str]:
        """The ``repl_factor`` ring owners of ``digest``, primary first
        (empty when unwired)."""
        if self.placement is None:
            return []
        return self.placement.ring_order(digest)[:self.repl_factor]

    def on_client_put(self, digest: bytes) -> int:
        """Schedule the fan-out of a client ``put``: ``repl`` to every
        other owner, ``handoff`` to the primary when this peer is not it.
        Returns the pushes scheduled."""
        if not self.wired:
            return 0
        owners = self.owners(digest)
        if not owners:
            return 0
        primary = owners[0]
        scheduled = 0
        with self._lock:
            for target in owners:
                if target == self.peer_id:
                    continue
                kind = "handoff" if (target == primary
                                     and self.peer_id != primary) else "repl"
                scheduled += self._add_task(digest, target, kind)
            if self.peer_id not in owners:
                self._misplaced.add(digest)
        if scheduled and self.immediate:
            self.pump()
        return scheduled

    def on_hot_hint(self, digest: bytes, target: str) -> bool:
        """Push our copy of ``digest`` to ``target`` (a client's hint)."""
        if not self.wired or self._peek(digest) is None:
            return False
        if target not in self.placement.peer_ids:
            return False
        with self._lock:
            self._add_task(digest, target, "repl")
            self.stats["hot_hints"] += 1
        if self.immediate:
            self.pump()
        return True

    def on_accept(self, kind: str, nbytes: int, stored: bool) -> None:
        """Account an incoming ``repl`` or ``handoff`` (pushes never
        cascade)."""
        with self._lock:
            if stored:
                self.stats[f"{kind}_in"] += 1
                self.stats[f"{kind}_in_bytes"] += nbytes

    def pump(self) -> int:
        """Try every pending push once; a dead target keeps its task.
        Returns the pushes delivered."""
        with self._pump_lock:
            return self._pump_once()

    def _pump_once(self) -> int:
        with self._lock:
            batch = list(self._tasks.items())
            if batch:
                self.stats["rounds"] += 1
        delivered = 0
        for (digest, target), kind in batch:
            blob = self._peek(digest)
            if blob is None:           # our copy is gone: nothing to push
                with self._lock:
                    self._pop_task(digest, target)
                    self.stats["dropped"] += 1
                self._maybe_repair_leak(digest)
                continue
            try:
                resp = self._send(target, kind, {"key": digest, "blob": blob,
                                                 "origin": self.peer_id})
            except TransportError:
                with self._lock:
                    self.stats["retries"] += 1
                continue
            with self._lock:
                self._pop_task(digest, target)
                if resp.get("ok") and resp.get("stored", True):
                    delivered += 1
                    if kind == "handoff":
                        self.stats["handoffs"] += 1
                        self.stats["handoff_bytes"] += len(blob)
                        if digest in self._misplaced:
                            self._handoff_ok.add(digest)
                    else:
                        self.stats["repl_pushed"] += 1
                        self.stats["repl_push_bytes"] += len(blob)
                else:                  # the target's budget refused it
                    self.stats["rejected"] += 1
            self._maybe_repair_leak(digest)
        return delivered

    def _maybe_repair_leak(self, digest: bytes) -> None:
        """Drop our stray copy once the primary acked its handoff and no
        push of it is pending; clear the digest's bookkeeping whenever no
        push is left."""
        with self._lock:
            if self._per_digest.get(digest, 0):
                return
            do_drop = digest in self._misplaced and \
                digest in self._handoff_ok
            self._misplaced.discard(digest)
            self._handoff_ok.discard(digest)
            drop = self._drop if do_drop else None
        if drop is not None and drop(digest):
            with self._lock:
                self.stats["leaks_repaired"] += 1

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self.stats)
            out["pending"] = len(self._tasks)
            out["misplaced"] = len(self._misplaced)
        return out
