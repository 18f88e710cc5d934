"""One front door for standing up the cache fabric.

The port's copy of ``repro.core.fabric``: three constructors, one
contract.

* ``Fabric.sim(links)``   — in-process peers over simulated links;
* ``Fabric.tcp(n_peers)`` — peer daemons over TCP (``start()`` /
  ``stop()`` own the processes, or use the fabric as a context manager);
* ``Fabric.local()``      — the paper's single cache box.

``fabric.directory(...)`` mints a fresh client-side view a session: a
:class:`~repro_torch.core.cluster.PeerDirectory` on the multi-peer
fabrics, an :class:`~repro_torch.core.transport.InProcTransport` on the
single box; the ``EdgeClient``, the session pool and the gateway take
either. The mode's own handle stays at ``.cluster``, ``.supervisor`` or
``.server``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.config import CacheConfig
from repro_torch.core.netsim import SimClock, SimNetwork
from repro_torch.core.transport import TransportError


class Fabric:
    """A started (or startable) fabric behind one ``directory()``."""

    def __init__(self, kind: str, *, cluster=None, supervisor=None,
                 server=None, net=None,
                 cache_cfg: CacheConfig = CacheConfig()):
        if kind not in ("sim", "tcp", "local"):
            raise ValueError(f"unknown fabric kind {kind!r}")
        self.kind = kind
        self.cluster = cluster         # CacheCluster   (kind "sim")
        self.supervisor = supervisor   # PeerSupervisor (kind "tcp")
        self.server = server           # CacheServer    (kind "local")
        self.net = net                 # the single box's simulated link
        self.cache_cfg = cache_cfg
        self._started = kind != "tcp"

    # -- constructors ------------------------------------------------------
    @classmethod
    def sim(cls, links: Optional[Sequence] = None, n_peers: int = 2,
            cache_cfg: CacheConfig = CacheConfig()) -> "Fabric":
        """In-process peers; ``links`` holds a ``SimNetwork`` or a
        ``(bandwidth_bps, rtt_s)`` a peer (its length is the peer count),
        by default ``n_peers`` default links."""
        from repro_torch.core.cluster import CacheCluster
        if links is None:
            links = [SimNetwork() for _ in range(n_peers)]
        return cls("sim", cluster=CacheCluster(links, cache_cfg),
                   cache_cfg=cache_cfg)

    @classmethod
    def tcp(cls, n_peers: int = 2, specs: Optional[Sequence] = None,
            cache_cfg: CacheConfig = CacheConfig(),
            max_store_bytes: int = 0, host: str = "127.0.0.1",
            **supervisor_kw) -> "Fabric":
        """Peer daemons over TCP. Returns an unstarted fabric: ``start()``
        (or ``with``) spawns the fleet, and raises if a daemon does not
        come up; ``stop()`` tears it down."""
        from repro_torch.core.net.supervisor import PeerSupervisor
        if specs is not None:
            sup = PeerSupervisor(specs, **supervisor_kw)
        else:
            sup = PeerSupervisor.fleet(n_peers, host=host,
                                       max_store_bytes=max_store_bytes,
                                       **supervisor_kw)
        return cls("tcp", supervisor=sup, cache_cfg=cache_cfg)

    @classmethod
    def local(cls, cache_cfg: CacheConfig = CacheConfig(), net=None,
              server=None) -> "Fabric":
        """The single cache box behind a simulated link; each
        ``directory()`` is a fresh ``InProcTransport`` (its own sim
        clock) over the one server and link."""
        from repro_torch.core.server import CacheServer
        return cls("local", server=server or CacheServer(cache_cfg),
                   net=net or SimNetwork(), cache_cfg=cache_cfg)

    # -- lifecycle (tcp; a no-op elsewhere) ---------------------------------
    def start(self) -> "Fabric":
        if self.kind == "tcp" and not self._started:
            self.supervisor.start()
            self._started = True
        return self

    def stop(self) -> None:
        if self.kind == "tcp" and self._started:
            self.supervisor.stop()
            self._started = False

    def __enter__(self) -> "Fabric":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the contract --------------------------------------------------------
    def directory(self, clock=None, **kw):
        """A fresh client-side view, one a session. The multi-peer
        fabrics take ``estimator=`` (a shared ``LinkEstimator``) and the
        directory's other options; the single box has no links, so it
        ignores ``estimator`` and ``adaptive``."""
        if self.kind == "sim":
            return self.cluster.directory(clock=clock, **kw)
        if self.kind == "tcp":
            if not self._started:
                raise RuntimeError(
                    "Fabric.tcp(...) is not started: call start() or use "
                    "it as a context manager before directory()")
            return self.supervisor.directory(clock=clock, **kw)
        from repro_torch.core.transport import InProcTransport
        kw.pop("estimator", None)
        kw.pop("adaptive", None)
        if kw:
            raise TypeError(f"Fabric.local().directory() got unexpected "
                            f"kwargs {sorted(kw)}")
        return InProcTransport(self.server, self.net, clock or SimClock())

    # -- passthroughs for drills ----------------------------------------------
    def peer_ids(self) -> List[str]:
        if self.kind == "sim":
            return [p.peer_id for p in self.cluster.peers]
        if self.kind == "tcp":
            return list(self.supervisor.procs)
        return []

    def kill(self, peer_id: str, **kw) -> None:
        if self.kind == "sim":
            self.cluster.kill(peer_id)
        elif self.kind == "tcp":
            self.supervisor.kill(peer_id, **kw)
        else:
            raise ValueError("Fabric.local() has no peers to kill")

    def revive(self, peer_id: str) -> None:
        if self.kind == "sim":
            self.cluster.revive(peer_id)
        elif self.kind == "tcp":
            self.supervisor.restart(peer_id)
        else:
            raise ValueError("Fabric.local() has no peers to revive")

    def gossip(self, fanout: Optional[int] = None) -> int:
        """One anti-entropy round on the sim fabric; the daemons and the
        single box sync on their own (0)."""
        if self.kind == "sim":
            return self.cluster.gossip(fanout=fanout)
        return 0

    def server_stats(self) -> Dict[str, dict]:
        if self.kind == "sim":
            return {p.peer_id: dict(p.server.stats)
                    for p in self.cluster.peers}
        if self.kind == "local":
            return {"server": dict(self.server.stats)}
        out = {}
        for pid in self.peer_ids():
            try:
                out[pid] = self.supervisor.request(pid, "stats",
                                                   {}).get("stats", {})
            except TransportError as e:     # down: no stats to report
                out[pid] = {"error": repr(e)}
        return out

    def __repr__(self) -> str:
        n = len(self.peer_ids()) if self.kind != "local" else 1
        return f"Fabric(kind={self.kind!r}, peers={n})"
