"""A cache peer: one member of the multi-peer prompt-cache fabric.

A copy of ``repro.core.cluster.peer``. Each peer is a full
:class:`~repro_torch.core.server.CacheServer` (its own store, master
catalog and key log) reachable over its own link: a
:class:`~repro_torch.core.netsim.SimNetwork` in the simulation, a TCP
socket served by :func:`~repro_torch.core.net.server.serve_peer_tcp` in
a deployment. Off the request path peers gossip key-log deltas, so each
can advertise which keys its neighbours hold: a client that syncs only
with peer B still finds a blob uploaded through peer A (``csync``
returns ``remote`` entries tagged with their owner). A gossip pull is
one ``csync`` against the source, folded in by
:meth:`CachePeer.fold_gossip`; :func:`gossip_round` runs a full mesh, or
epidemic rounds of ``fanout`` random neighbours.
"""
from __future__ import annotations

import random
import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.config import CacheConfig
from repro_torch.core.cluster.replication import REPL_FACTOR, Replicator
from repro_torch.core.netsim import SimClock, SimNetwork
from repro_torch.core.server import CacheServer
from repro_torch.core.transport import InProcTransport, TransportError

# gossip wire cost per advertised key: 32-byte digest + owner id + framing
_GOSSIP_BYTES_PER_KEY = 48


class CachePeer:
    def __init__(self, peer_id: str, cache_cfg: CacheConfig = CacheConfig(),
                 net: Optional[SimNetwork] = None):
        self.peer_id = peer_id
        self.server = CacheServer(cache_cfg)
        self.net = net or SimNetwork()              # client <-> peer link
        self.alive = True
        # how far each neighbour's logs are consumed, and the (digest,
        # owner) entries this peer advertises onward; a daemon's gossip
        # thread folds while connections read csync
        self._glock = threading.Lock()
        self._cursors: Dict[str, int] = {}
        self.remote_log: List[Tuple[bytes, str]] = []
        self._remote_seen: Set[Tuple[bytes, str]] = set()
        self.gossip_stats = {"rounds": 0, "keys_in": 0, "bytes": 0}
        self.replication = Replicator(peer_id)

    def wire_replication(self, ring: Sequence[str], send,
                         repl_factor: int = REPL_FACTOR,
                         immediate: bool = False) -> None:
        """Teach this peer the ring and ``send(peer_id, op, payload)``."""
        self.replication.wire(ring, send, self.server.peek,
                              self.server.delete, repl_factor=repl_factor,
                              immediate=immediate)

    def gossip_cursors(self, src_id: str) -> Tuple[int, int]:
        """``(since, since_remote)`` of a ``csync`` pull from ``src_id``."""
        with self._glock:
            return (self._cursors.get(src_id, 0),
                    self._cursors.get(src_id + "#remote", 0))

    def fold_gossip(self, resp: dict) -> int:
        """Fold a neighbour's ``csync`` reply into our remote log and
        advance its cursors. Returns the fresh entries."""
        src = resp.get("peer", "")
        fresh = 0
        with self._glock:
            for k in resp.get("keys", []):      # the source's own keys
                entry = (bytes(k), src)
                if entry in self._remote_seen or k in self.server.store:
                    continue
                self._remote_seen.add(entry)
                self.remote_log.append(entry)
                fresh += 1
            for k, owner in resp.get("remote", []):   # second-hand
                entry = (bytes(k), owner)
                if owner == self.peer_id or entry in self._remote_seen:
                    continue
                self._remote_seen.add(entry)
                self.remote_log.append(entry)
                fresh += 1
            self._cursors[src] = resp.get("version",
                                          self._cursors.get(src, 0))
            self._cursors[src + "#remote"] = resp.get(
                "remote_version", self._cursors.get(src + "#remote", 0))
            self.gossip_stats["keys_in"] += fresh
            self.gossip_stats["bytes"] += fresh * _GOSSIP_BYTES_PER_KEY
            self.gossip_stats["rounds"] += 1
        return fresh

    def pull_from(self, other: "CachePeer") -> int:
        """One in-process gossip pull from ``other``."""
        if not (self.alive and other.alive):
            return 0
        since, since_r = self.gossip_cursors(other.peer_id)
        return self.fold_gossip(other.handle(
            "csync", {"since": since, "since_remote": since_r}))

    def knows(self, digest: bytes) -> bool:
        """Whether this peer holds ``digest`` or knows an owner of it."""
        if digest in self.server.store:
            return True
        with self._glock:
            return any(k == digest for k, _ in self._remote_seen)

    def handle(self, op: str, payload: dict) -> dict:
        """The server's ops, plus: ``put`` schedules the fan-out to the
        key's other owners; ``repl`` / ``handoff`` are those pushes
        (stored with no further fan-out); ``hot`` asks this peer to push
        its copy to a target; ``rstats`` reports replication; ``csync``
        is the catalog sync with the gossiped ``remote`` entries."""
        if op == "put":
            resp = self.server.handle("put", payload)
            if resp.get("stored"):
                self.replication.on_client_put(bytes(payload["key"]))
            return resp
        if op in ("repl", "handoff"):
            key, blob = bytes(payload["key"]), payload["blob"]
            _, stored = self.server.put(key, blob)
            self.replication.on_accept(op, len(blob), stored)
            return {"ok": True, "stored": stored, "peer": self.peer_id}
        if op == "hot":
            ok = self.replication.on_hot_hint(bytes(payload["key"]),
                                              payload["target"])
            return {"ok": ok, "peer": self.peer_id}
        if op == "rstats":
            return {"ok": True, "peer": self.peer_id,
                    "repl": self.replication.snapshot()}
        if op == "csync":
            keys, v = self.server.sync(payload.get("since", 0))
            with self._glock:
                since_r = payload.get("since_remote", 0)
                remote = [[k, owner] for k, owner in self.remote_log[since_r:]]
                remote_v = len(self.remote_log)
            return {"ok": True, "keys": keys, "version": v,
                    "remote": remote, "remote_version": remote_v,
                    "tombstones": self.server.stats["tombstones"],
                    "peer": self.peer_id}
        return self.server.handle(op, payload)


class PeerTransport(InProcTransport):
    """In-process transport to one peer over its simulated link. A
    killed peer (``alive = False``) fails fast with ``TransportError``,
    the analogue of a refused connect."""

    def __init__(self, peer: CachePeer, clock: Optional[SimClock] = None):
        super().__init__(peer, peer.net, clock)
        self.peer = peer
        self.peer_id = peer.peer_id

    def _serve(self, op: str, payload: dict) -> dict:
        if not self.peer.alive:
            raise TransportError(f"peer {self.peer.peer_id!r} is down")
        return super()._serve(op, payload)


def gossip_round(peers: Sequence[CachePeer], fanout: Optional[int] = None,
                 rng: Optional[random.Random] = None) -> int:
    """One anti-entropy round; returns the entries exchanged. ``fanout``
    None is the full mesh (every live peer pulls from every other);
    ``fanout=k`` has every peer pull from k random live neighbours."""
    total = 0
    if fanout is None:
        for dst in peers:
            for src in peers:
                if dst is not src:
                    total += dst.pull_from(src)
        return total
    rng = rng or random.Random()
    for dst in peers:
        others = [p for p in peers if p is not dst and p.alive]
        for src in rng.sample(others, min(fanout, len(others))):
            total += dst.pull_from(src)
    return total
