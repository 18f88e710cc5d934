"""Multi-peer prompt-cache fabric (beyond the paper's single cache box).

A copy of ``repro.core.cluster``: N peers, each with its own blob store,
master Bloom catalog and link.

* :class:`CachePeer`        — one fabric member (store, catalog, link)
* :class:`PeerDirectory`    — the client's per-peer catalogs, liveness,
                              delta sync and placement
* :class:`FetchPlanner`     — link-aware (peer, range) choice with
                              fetch-against-recompute pruning
* :class:`PlacementPolicy`  — consistent-hash primary and ring fallbacks
* :class:`Replicator`       — peer-side push replication and handoff
* :class:`CacheCluster`     — build peers, drive gossip, kill and revive
                              peers, mint directories (in process)
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Union

from repro_torch.config import CacheConfig
from repro_torch.core.cluster.breaker import CircuitBreaker
from repro_torch.core.cluster.directory import PeerDirectory, PeerLink
from repro_torch.core.cluster.peer import (CachePeer, PeerTransport,
                                           gossip_round)
from repro_torch.core.cluster.placement import HotKeyTracker, PlacementPolicy
from repro_torch.core.cluster.planner import FetchAttempt, FetchPlanner
from repro_torch.core.cluster.replication import Replicator
from repro_torch.core.netsim import SimClock, SimNetwork
from repro_torch.core.transport import TransportError

__all__ = ["CacheCluster", "CachePeer", "CircuitBreaker", "FetchAttempt",
           "FetchPlanner", "HotKeyTracker", "PeerDirectory", "PeerLink",
           "PeerTransport", "PlacementPolicy", "Replicator", "gossip_round"]

LinkSpec = Union[SimNetwork, tuple]


class CacheCluster:
    """N in-process peers and their links, one handle.

    ``links`` holds one spec a peer, a ``SimNetwork`` or a
    ``(bandwidth_bps, rtt_s)`` tuple. ``directory()`` mints a client's
    view; ``gossip()`` runs one anti-entropy round and pumps pending
    replication; ``kill`` / ``revive`` flip a peer's liveness."""

    def __init__(self, links: Sequence[LinkSpec],
                 cache_cfg: CacheConfig = CacheConfig()):
        self.cache_cfg = cache_cfg
        self.peers: List[CachePeer] = []
        for i, spec in enumerate(links):
            net = spec if isinstance(spec, SimNetwork) else \
                SimNetwork(bandwidth_bps=spec[0], rtt_s=spec[1])
            self.peers.append(CachePeer(f"peer{i}", cache_cfg, net))
        self.by_id: Dict[str, CachePeer] = {p.peer_id: p for p in self.peers}
        self._gossip_rng = random.Random(0xC1)   # epidemic partner picks
        # peer-side push replication, pumped on enqueue (deterministic);
        # a push to a dead peer waits for gossip() / repair_round()
        ring = [p.peer_id for p in self.peers]
        for p in self.peers:
            p.wire_replication(ring, self._peer_send(p), immediate=True)

    def _peer_send(self, src: CachePeer):
        def send(peer_id: str, op: str, payload: dict) -> dict:
            dst = self.by_id[peer_id]
            if not (src.alive and dst.alive):
                raise TransportError(f"peer {peer_id!r} is down (push from "
                                     f"{src.peer_id!r})")
            return dst.handle(op, payload)
        return send

    def directory(self, clock: Optional[SimClock] = None,
                  **kw) -> PeerDirectory:
        return PeerDirectory(self.peers, self.cache_cfg,
                             clock=clock or SimClock(), **kw)

    def gossip(self, fanout: Optional[int] = None) -> int:
        """One anti-entropy round (a full mesh, or ``fanout`` random
        pulls a peer), then one replication pump."""
        n = gossip_round(self.peers, fanout=fanout, rng=self._gossip_rng)
        self.repair_round()
        return n

    def repair_round(self) -> int:
        """Pump every live peer's pending pushes once; returns the pushes
        still pending fleet-wide (0: converged)."""
        for p in self.peers:
            if p.alive:
                p.replication.pump()
        return sum(p.replication.pending for p in self.peers)

    def kill(self, peer_id: str) -> None:
        self.by_id[peer_id].alive = False

    def revive(self, peer_id: str) -> None:
        self.by_id[peer_id].alive = True

    def stored_bytes(self) -> int:
        return sum(p.server.stored_bytes for p in self.peers)

    def replication_stats(self) -> Dict[str, Dict[str, int]]:
        return {p.peer_id: p.replication.snapshot() for p in self.peers}

    def p2p_bytes(self) -> int:
        """Blob bytes moved peer to peer (pushes and handoffs)."""
        return sum(s["repl_push_bytes"] + s["handoff_bytes"]
                   for s in self.replication_stats().values())
