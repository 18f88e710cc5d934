"""Peer daemon: one cache peer as its own OS process.

    python -m repro_torch.core.net.daemon --peer-id peer0 --port 0 \\
        [--max-store-bytes N] [--gossip-interval S]

Hosts a :class:`~repro_torch.core.cluster.CachePeer` behind
:func:`~repro_torch.core.net.server.serve_peer_tcp` and prints one line
on stdout once its socket is bound::

    PEER-READY <peer_id> <host> <port>

It imports no ``torch``: its closure is config, server, codec and
sockets, so a fleet starts in well under a second. Besides the peer's
ops it answers three control ops:

* ``health``: liveness, pid, store occupancy, gossip and replication
  counts and the socket server's counts;
* ``set_neighbors``: ``{peers: {peer_id: [host, port], ...}, ring:
  [peer_id, ...], repl_factor: R}``. It arms the gossip thread, which
  every ``--gossip-interval`` seconds pulls ``csync`` deltas from
  ``GOSSIP_FANOUT`` random neighbours and pumps the peer's pending
  replication pushes and hinted handoffs, and it wires peer-side push
  replication over :class:`~repro_torch.core.net.link.TCPPeerLink`\\ s.
  A ``ring`` given is the ring (the supervisor names every peer it
  runs, the dead ones too); without one the ring is every peer this
  daemon was ever told of, so a primary that is down keeps its keys
  while it is restarted;
* ``shutdown``: replies ``{"ok": True}``, then exits through the
  server's graceful drain. SIGTERM takes the same path.
"""
from __future__ import annotations

import argparse
import os
import random
import signal
import sys
import threading
import zlib
from typing import Dict, Tuple

from repro_torch.config import CacheConfig
from repro_torch.core.cluster.peer import CachePeer
from repro_torch.core.cluster.replication import REPL_FACTOR
from repro_torch.core.net.link import TCPPeerLink
from repro_torch.core.net.server import serve_peer_tcp
from repro_torch.core.transport import TransportError

GOSSIP_FANOUT = 2                  # neighbours pulled a gossip round


class DaemonHandler:
    """A peer's ``handle`` with the daemon's control ops."""

    def __init__(self, peer: CachePeer, stop_event: threading.Event):
        self.peer = peer
        self.stop_event = stop_event
        self.server = None             # the PeerServer, once bound
        self.neighbors: Dict[str, Tuple[str, int]] = {}
        self._known_ring = {peer.peer_id}     # every peer ever named
        self._nlock = threading.Lock()
        self._repl_links: Dict[str, TCPPeerLink] = {}

    def _repl_send(self, peer_id: str, op: str, payload: dict) -> dict:
        """One bounded push to a neighbour over a pooled link; a failure
        is a ``TransportError`` and the replicator retries later."""
        with self._nlock:
            addr = self.neighbors.get(peer_id)
            link = self._repl_links.get(peer_id)
            if addr is None:
                raise TransportError(f"no address for peer {peer_id!r}")
            if link is None or link.addr != addr:
                link = self._repl_links[peer_id] = TCPPeerLink(
                    peer_id, *addr, timeout=2.0)
        return link.request(op, payload)[0]

    def handle(self, op: str, payload: dict) -> dict:
        if op == "health":
            srv = self.peer.server
            return {"ok": True, "peer": self.peer.peer_id,
                    "pid": os.getpid(), "stored_bytes": srv.stored_bytes,
                    "n_entries": len(srv.store),
                    "gossip": dict(self.peer.gossip_stats),
                    "repl": self.peer.replication.snapshot(),
                    "transport": dict(getattr(self.server, "stats", None)
                                      or {})}
        if op == "set_neighbors":
            with self._nlock:
                self.neighbors = {
                    pid: (host, int(port))
                    for pid, (host, port) in payload["peers"].items()
                    if pid != self.peer.peer_id}
            if payload.get("ring"):
                ring = list(payload["ring"])
                self._known_ring = set(ring)
            else:
                self._known_ring |= set(payload["peers"])
                ring = sorted(self._known_ring)
            self.peer.wire_replication(
                ring, self._repl_send,
                repl_factor=int(payload.get("repl_factor", REPL_FACTOR)),
                immediate=False)
            return {"ok": True, "n_neighbors": len(self.neighbors),
                    "ring": ring}
        if op == "shutdown":
            self.stop_event.set()
            return {"ok": True, "bye": self.peer.peer_id}
        return self.peer.handle(op, payload)

    def snapshot_neighbors(self) -> Dict[str, Tuple[str, int]]:
        with self._nlock:
            return dict(self.neighbors)


def gossip_rng(peer_id: str) -> random.Random:
    """The daemon's neighbour picks, seeded from the peer id's CRC32 (not
    ``hash()``, which changes from process to process)."""
    return random.Random(zlib.crc32(peer_id.encode()))


def gossip_loop(handler: DaemonHandler, interval_s: float, fanout: int,
                stop_event: threading.Event) -> None:
    """Every ``interval_s``: pump the peer's pending pushes, then pull
    ``csync`` deltas from ``fanout`` random neighbours over TCP. A dead
    neighbour costs one bounded ``TransportError``."""
    peer = handler.peer
    rng = gossip_rng(peer.peer_id)
    links: Dict[str, TCPPeerLink] = {}
    try:
        while not stop_event.wait(interval_s):
            if peer.replication.wired:
                peer.replication.pump()
            neighbors = handler.snapshot_neighbors()
            ids = sorted(neighbors)
            for pid in rng.sample(ids, min(fanout, len(ids))):
                link = links.get(pid)
                if link is None or link.addr != neighbors[pid]:
                    link = links[pid] = TCPPeerLink(pid, *neighbors[pid],
                                                    timeout=2.0)
                since, since_r = peer.gossip_cursors(pid)
                try:
                    resp, _, _ = link.request(
                        "csync", {"since": since, "since_remote": since_r})
                except TransportError:
                    continue
                peer.fold_gossip(resp)
    finally:
        for link in links.values():
            link.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--peer-id", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--max-store-bytes", type=int, default=0,
                    help="the peer's store budget in bytes (0: unbounded)")
    ap.add_argument("--gossip-interval", type=float, default=0.25)
    args = ap.parse_args(argv)

    stop_event = threading.Event()
    peer = CachePeer(args.peer_id,
                     CacheConfig(max_store_bytes=args.max_store_bytes))
    handler = DaemonHandler(peer, stop_event)
    server = serve_peer_tcp(handler, args.host, args.port)
    handler.server = server
    signal.signal(signal.SIGTERM, lambda *_: stop_event.set())
    signal.signal(signal.SIGINT, lambda *_: stop_event.set())
    gossip = threading.Thread(target=gossip_loop,
                              args=(handler, args.gossip_interval,
                                    GOSSIP_FANOUT, stop_event),
                              daemon=True)
    gossip.start()
    print(f"PEER-READY {args.peer_id} {args.host} {server.port}", flush=True)
    stop_event.wait()
    gossip.join(args.gossip_interval + 5.0)
    server.close(graceful=True)        # drain in-flight, then exit
    return 0


if __name__ == "__main__":
    sys.exit(main())
