"""Peer daemon: one cache peer as its own OS process.

    python -m repro_torch.core.net.daemon --peer-id peer0 --port 0 \\
        [--max-store-bytes N] [--gossip-interval S] [--state-dir DIR]

Hosts a :class:`~repro_torch.core.cluster.CachePeer` behind
:func:`~repro_torch.core.net.server.serve_peer_tcp` and prints one line
on stdout once its socket is bound::

    PEER-READY <peer_id> <host> <port>

It imports no ``torch``: its closure is config, server, codec and
sockets, so a fleet starts in well under a second. Besides the peer's
ops it answers five control ops:

* ``health``: liveness, pid, store occupancy, gossip and replication
  counts, the socket server's counts, its throttle and injected faults,
  the learned links to its neighbours (``links``: bandwidth, RTT,
  samples), the ``catalog_fp`` probe (the master Bloom filter's
  predicted false-positive rate beside the served miss rate), the
  process's metrics snapshot and the flight recorder's occupancy;
* ``set_throttle``: ``{bps: float | null}`` paces the server's outgoing
  frames from now on (``null`` lifts it): a silent bandwidth collapse;
* ``inject``: ``{chaos: {flag: value, ...}, reset: bool}`` merges fault
  flags into the live server (``corrupt_chunks``, ``stall_chunk_s``,
  ``close_mid_stream``, ``delay_ack_s``, ``partition_inbound``; a
  ``None`` value removes one, ``reset`` clears all first). A partitioned
  peer still answers ``inject``, so it can always be healed;
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

The daemon learns its links to its neighbours from every gossip pull and
replication push (a :class:`~repro_torch.core.net.estimator.LinkEstimator`);
with ``--state-dir`` it saves them there after each gossip round and at
exit, and a restarted daemon starts from them.
"""
from __future__ import annotations

import argparse
import os
import random
import signal
import sys
import threading
import zlib
from typing import Dict, Optional, Tuple

from repro_torch.config import CacheConfig
from repro_torch.core.cluster.peer import CachePeer
from repro_torch.core.cluster.replication import REPL_FACTOR
from repro_torch.core.net.estimator import LinkEstimator
from repro_torch.core.net.link import TCPPeerLink
from repro_torch.core.net.server import serve_peer_tcp
from repro_torch.core.transport import TransportError
from repro_torch.obs.calibrate import catalog_fp_probe
from repro_torch.obs.flight import FLIGHT
from repro_torch.obs.metrics import REGISTRY

GOSSIP_FANOUT = 2                  # neighbours pulled a gossip round


class DaemonHandler:
    """A peer's ``handle`` with the daemon's control ops."""

    def __init__(self, peer: CachePeer, stop_event: threading.Event,
                 state_dir: Optional[str] = None):
        self.peer = peer
        self.stop_event = stop_event
        self.state_dir = state_dir
        self.estimator = LinkEstimator()     # links to the neighbours
        if state_dir:
            self.estimator.warm_start(self._links_path)
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
        resp, dt, nb = link.request(op, payload)
        self.estimator.observe(peer_id, nb, dt)
        return resp

    @property
    def _links_path(self) -> str:
        return os.path.join(self.state_dir, f"{self.peer.peer_id}-links.json")

    def save_estimator(self) -> None:
        """Persist the learned links under ``--state-dir`` (best effort)."""
        if not self.state_dir:
            return
        try:
            self.estimator.save(self._links_path)
        except OSError as e:
            FLIGHT.record("daemon.save_failed", error=repr(e))

    def handle(self, op: str, payload: dict) -> dict:
        if op == "health":
            srv = self.peer.server
            return {"ok": True, "peer": self.peer.peer_id,
                    "pid": os.getpid(), "stored_bytes": srv.stored_bytes,
                    "n_entries": len(srv.store),
                    "gossip": dict(self.peer.gossip_stats),
                    "repl": self.peer.replication.snapshot(),
                    "links": {pid: list(snap) for pid, snap in
                              self.estimator.snapshot_all().items()},
                    "catalog_fp": catalog_fp_probe(
                        srv.master, srv.stats.get("gets", 0),
                        srv.stats.get("misses", 0), len(srv.tombstones)),
                    "throttle_bps": getattr(self.server, "throttle_bps",
                                            None),
                    "chaos": dict(getattr(self.server, "chaos", None) or {}),
                    "transport": dict(getattr(self.server, "stats", None)
                                      or {}),
                    "metrics": REGISTRY.snapshot(),
                    "flight": FLIGHT.snapshot()}
        if op == "inject":
            if self.server is None:
                return {"ok": False, "error": "no server attached"}
            if payload.get("reset"):
                self.server.chaos.clear()
            for k, v in (payload.get("chaos") or {}).items():
                if v is None:
                    self.server.chaos.pop(k, None)
                else:
                    self.server.chaos[k] = v
            FLIGHT.record("chaos.inject", peer=self.peer.peer_id,
                          chaos=dict(self.server.chaos))
            return {"ok": True, "peer": self.peer.peer_id,
                    "chaos": dict(self.server.chaos)}
        if op == "set_throttle":
            if self.server is None:
                return {"ok": False, "error": "no server attached"}
            bps = payload.get("bps")
            self.server.throttle_bps = float(bps) if bps else None
            return {"ok": True, "peer": self.peer.peer_id,
                    "throttle_bps": self.server.throttle_bps}
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
                    resp, dt, nb = link.request(
                        "csync", {"since": since, "since_remote": since_r})
                except TransportError as e:
                    FLIGHT.record("gossip.pull_failed", peer=pid,
                                  error=repr(e))
                    continue
                handler.estimator.observe(pid, nb, dt)   # a link sample
                peer.fold_gossip(resp)
            handler.save_estimator()
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
    ap.add_argument("--state-dir", default=None,
                    help="where the learned links persist across restarts")
    args = ap.parse_args(argv)

    stop_event = threading.Event()
    peer = CachePeer(args.peer_id,
                     CacheConfig(max_store_bytes=args.max_store_bytes))
    handler = DaemonHandler(peer, stop_event, state_dir=args.state_dir)
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
    handler.save_estimator()           # the learned links survive
    server.close(graceful=True)        # drain in-flight, then exit
    return 0


if __name__ == "__main__":
    sys.exit(main())
