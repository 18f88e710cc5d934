"""Process supervisor for a fleet of TCP cache-peer daemons.

The port's copy of ``repro.core.net.supervisor``. ``PeerSupervisor``
turns "N peers" into N OS processes: it spawns ``python -m
repro_torch.core.net.daemon`` a peer (the port's ``src`` on
``PYTHONPATH``), reads each ``PEER-READY`` line for its OS-assigned
port, wires the peers into a gossip and replication mesh
(``set_neighbors``), health-checks them over the wire, restarts the ones
that die (same peer id, same port: the clients' lazy
:class:`~repro_torch.core.net.link.TCPPeerLink` sockets reconnect), and
stops the fleet through the daemons' graceful drain. Every wait is
bounded: readiness, convergence, repair and stop.

:meth:`PeerSupervisor.directory` mints a client-side
:class:`~repro_torch.core.cluster.PeerDirectory` over TCP links, the
object the in-process fabric gives, so the planner, client, session pool
and gateway run unchanged against real processes.

With a ``state_dir`` the daemons persist their learned links there
(``--state-dir``), every client directory minted here starts its link
estimator from ``<state_dir>/client-links.json``, and ``stop()`` writes
the newest one back. The fault surfaces (the chaos layer's,
:mod:`repro_torch.chaos`): ``set_throttle`` (a live peer's outgoing
pacing), ``inject_faults`` (its chaos flags), and the fleet views that
ride the daemons' ``health``: ``fleet_metrics`` (every daemon's metrics,
each sample labelled with its peer) and ``fleet_calibration`` (the Bloom
false-positive probe, learned links, throttle, faults and restart state a
peer). Like the daemon, this module imports no ``torch``.
"""
from __future__ import annotations

import os
import random
import signal
import subprocess
import sys
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch import clock
from repro_torch.core.cluster.replication import REPL_FACTOR
from repro_torch.core.net.link import TCPPeerLink
from repro_torch.core.transport import TransportError
from repro_torch.obs.flight import FLIGHT, RESTART_CIRCUIT_OPEN

POLL_S = 0.05                      # remote-state poll period of the waits
STOP_TIMEOUT_S = 10.0              # a daemon's exit after kill or shutdown
START_TIMEOUT_S = 30.0             # a daemon's PEER-READY line after spawn
# the restart-storm guard: the second death in a storm waits
# RESTART_BACKOFF_S, doubling to RESTART_BACKOFF_MAX_S, each wait
# stretched by up to RESTART_JITTER of itself; after MAX_RESTARTS the
# peer is parked; healthy for RESTART_STABLE_S forgives the storm
RESTART_BACKOFF_S = 0.5
RESTART_BACKOFF_MAX_S = 30.0
RESTART_JITTER = 0.2
MAX_RESTARTS = 8
RESTART_STABLE_S = 60.0


@dataclass
class PeerSpec:
    peer_id: str
    host: str = "127.0.0.1"
    port: int = 0                      # 0: OS-assigned, read at PEER-READY
    max_store_bytes: int = 0
    gossip_interval_s: float = 0.25
    extra_args: Tuple[str, ...] = field(default_factory=tuple)


class PeerProc:
    """One supervised daemon: its spec, process and bound port, and the
    restart-storm guard's state."""

    def __init__(self, spec: PeerSpec):
        self.spec = spec
        self.proc: Optional[subprocess.Popen] = None
        self.port: int = spec.port
        self.restarts = 0
        # supervised restarts (check_and_restart) since the peer last
        # looked stable, when the next may run, and whether the peer is
        # parked until an explicit restart(); the jitter is seeded from
        # the peer id's CRC32 (not hash(): stable across processes)
        self.storm = 0
        self.backoff_until = 0.0
        self.last_restart_t = 0.0
        self.circuit_open = False
        self._rng = random.Random(zlib.crc32(spec.peer_id.encode()))
        # the child's last lines (stdout is drained for its whole life:
        # a full pipe would block a write in the daemon's event loop)
        self.tail: "deque[str]" = deque(maxlen=20)

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


def _src_pythonpath() -> str:
    """A ``PYTHONPATH`` on which the child imports ``repro_torch``."""
    import repro_torch
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    existing = os.environ.get("PYTHONPATH", "")
    return src + (os.pathsep + existing if existing else "")


class PeerSupervisor:
    def __init__(self, specs: Sequence[PeerSpec],
                 request_timeout_s: float = 5.0,
                 state_dir: Optional[str] = None):
        if not specs:
            raise ValueError("need at least one PeerSpec")
        self.request_timeout_s = request_timeout_s
        self.state_dir = state_dir
        self.procs: Dict[str, PeerProc] = {
            s.peer_id: PeerProc(s) for s in specs}
        self._env = dict(os.environ, PYTHONPATH=_src_pythonpath())
        self._estimators: List = []    # the client directories' estimators

    @classmethod
    def fleet(cls, n_peers: int, max_store_bytes: int = 0,
              host: str = "127.0.0.1", gossip_interval_s: float = 0.25,
              **kw) -> "PeerSupervisor":
        """``n_peers`` uniform peers, peer0..peerN-1, each with the given
        store budget."""
        return cls([PeerSpec(f"peer{i}", host=host,
                             max_store_bytes=max_store_bytes,
                             gossip_interval_s=gossip_interval_s)
                    for i in range(n_peers)], **kw)

    @property
    def _client_links_path(self) -> Optional[str]:
        if self.state_dir is None:
            return None
        return os.path.join(self.state_dir, "client-links.json")

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "PeerSupervisor":
        try:
            for pp in self.procs.values():
                self._spawn(pp)
        except BaseException:
            self.stop()                # no orphan from a half-made fleet
            raise
        self.wire_gossip()
        return self

    def _spawn(self, pp: PeerProc) -> None:
        s = pp.spec
        cmd = [sys.executable, "-m", "repro_torch.core.net.daemon",
               "--peer-id", s.peer_id, "--host", s.host,
               "--port", str(pp.port),
               "--max-store-bytes", str(s.max_store_bytes),
               "--gossip-interval", str(s.gossip_interval_s),
               *(("--state-dir", self.state_dir) if self.state_dir else ()),
               *s.extra_args]
        pp.proc = subprocess.Popen(
            cmd, env=self._env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, bufsize=1)
        pp.port = self._wait_ready(pp)

    def _wait_ready(self, pp: PeerProc) -> int:
        """Wait (at most ``START_TIMEOUT_S``) for PEER-READY; returns the
        bound port. Raises with the child's last lines if it dies or
        stalls. The reader thread drains stdout for the child's life."""
        found: Dict[str, int] = {}
        ready = threading.Event()

        def reader():
            try:
                for line in pp.proc.stdout:
                    pp.tail.append(line.rstrip())
                    if "port" not in found and \
                            line.startswith("PEER-READY "):
                        found["port"] = int(line.split()[3])
                        ready.set()
            except ValueError:
                pass                   # stop() closed the pipe under us
            ready.set()                # EOF: the child exited

        threading.Thread(target=reader, daemon=True).start()
        ready.wait(START_TIMEOUT_S)
        if "port" not in found:
            pp.proc.kill()
            pp.proc.wait(timeout=STOP_TIMEOUT_S)
            raise RuntimeError(
                f"peer {pp.spec.peer_id!r} failed to start within "
                f"{START_TIMEOUT_S}s: {list(pp.tail)[-5:]}")
        return found["port"]

    def wire_gossip(self) -> None:
        """Send every live daemon the address map, the ring and the
        replication factor. The ring names every spec'd peer, the dead
        ones too: a pending handoff keeps its primary, which is
        restarted on the same address."""
        ring = sorted(self.procs)
        addrs = {pid: [pp.spec.host, pp.port]
                 for pid, pp in self.procs.items() if pp.alive}
        for pid in addrs:
            try:
                self.request(pid, "set_neighbors",
                             {"peers": addrs, "ring": ring,
                              "repl_factor": REPL_FACTOR})
            except TransportError as e:     # re-wired at its restart
                FLIGHT.record("supervisor.rewire_failed", peer=pid,
                              error=repr(e))

    # -- addressing and client views -------------------------------------
    def addresses(self) -> Dict[str, Tuple[str, int]]:
        return {pid: (pp.spec.host, pp.port)
                for pid, pp in self.procs.items()}

    def links(self, timeout: Optional[float] = None) -> List[TCPPeerLink]:
        """Fresh lazily connecting links, one a peer in spec order: one
        set of sockets a client."""
        return [TCPPeerLink(pid, pp.spec.host, pp.port,
                            timeout=timeout or self.request_timeout_s)
                for pid, pp in self.procs.items()]

    def directory(self, clock=None, **kw):
        """A client-side ``PeerDirectory`` over TCP links, on the wall
        clock (real time drives sync intervals and suspect cooldowns).
        With a ``state_dir`` its link estimator (or the caller's shared
        one) starts from the fleet's saved client beliefs."""
        from repro_torch.core.cluster.directory import PeerDirectory
        from repro_torch.core.net.estimator import LinkEstimator
        from repro_torch.core.netsim import WallClock
        path = self._client_links_path
        if path is not None:
            if kw.get("estimator") is not None:
                kw["estimator"].warm_start(path)
            else:
                kw["estimator"] = LinkEstimator.load(path)
        d = PeerDirectory(self.links(), clock=clock or WallClock(), **kw)
        if path is not None:
            self._estimators.append(d.estimator)
        return d

    def save_estimators(self) -> None:
        """Persist the newest client directory's link beliefs (nothing
        without a ``state_dir``)."""
        path = self._client_links_path
        if path is not None and self._estimators:
            self._estimators[-1].save(path)

    def request(self, peer_id: str, op: str, payload: dict,
                timeout: Optional[float] = None) -> dict:
        """One request over a fresh link, closed after it."""
        pp = self.procs[peer_id]
        link = TCPPeerLink(peer_id, pp.spec.host, pp.port,
                           timeout=timeout or self.request_timeout_s)
        try:
            return link.request(op, payload)[0]
        finally:
            link.close()

    # -- health and faults -----------------------------------------------
    def health(self) -> Dict[str, bool]:
        """One bounded ping a peer; False: dead or unreachable."""
        out = {}
        for pid, pp in self.procs.items():
            if not pp.alive:
                out[pid] = False
                continue
            try:
                out[pid] = bool(self.request(pid, "health", {},
                                             timeout=2.0).get("ok"))
            except TransportError as e:
                out[pid] = False
                pp.tail.append(f"health: {e!r}")
                FLIGHT.record("supervisor.peer_unreachable", peer=pid,
                              error=repr(e))
        return out

    def _healths(self) -> Dict[str, Optional[dict]]:
        """Each peer's ``health`` reply; None: dead or unreachable."""
        out: Dict[str, Optional[dict]] = {}
        for pid, pp in self.procs.items():
            resp = None
            if pp.alive:
                try:
                    resp = self.request(pid, "health", {}, timeout=2.0)
                except TransportError as e:
                    pp.tail.append(f"health: {e!r}")
            out[pid] = resp if resp is not None and resp.get("ok") else None
        return out

    def fleet_metrics(self) -> Dict[str, object]:
        """Every live daemon's metrics snapshot merged into one, each
        sample labelled ``peer="<id>"``, with a ``_fleet`` summary (peers,
        and peers that reported)."""
        from repro_torch.obs.metrics import merge_snapshots
        snaps = {pid: h["metrics"] for pid, h in self._healths().items()
                 if h is not None and isinstance(h.get("metrics"), dict)}
        merged = merge_snapshots(snaps)
        merged["_fleet"] = {"peers": len(self.procs),
                            "reporting": len(snaps)}
        return merged

    def fleet_calibration(self) -> Dict[str, object]:
        """A peer's calibration view from its ``health``: the Bloom
        false-positive probe, learned links, throttle, injected faults,
        restart state and store occupancy (``alive: False`` for a dead
        or unreachable one)."""
        restarts = self.restart_states()
        out: Dict[str, object] = {}
        for pid, h in self._healths().items():
            if h is None:
                out[pid] = {"alive": False, "restart": restarts[pid]}
                continue
            out[pid] = {"alive": True,
                        "catalog_fp": h.get("catalog_fp", {}),
                        "links": h.get("links", {}),
                        "throttle_bps": h.get("throttle_bps"),
                        "chaos": h.get("chaos", {}),
                        "restart": restarts[pid],
                        "stored_bytes": h.get("stored_bytes", 0),
                        "n_entries": h.get("n_entries", 0)}
        return out

    def set_throttle(self, peer_id: str, bps: Optional[float]) -> dict:
        """Pace a live peer's outgoing frames at ``bps`` (None lifts it):
        a silent bandwidth collapse, with no restart."""
        return self.request(peer_id, "set_throttle", {"bps": bps})

    def inject_faults(self, peer_id: str, chaos: Optional[dict] = None,
                      reset: bool = False) -> dict:
        """Merge ``chaos`` flags into a live peer's server (a None value
        removes one; ``reset`` clears every fault first). Returns the
        daemon's faults after the merge. The flags:
        :mod:`repro_torch.core.net.server`."""
        payload: dict = {}
        if reset:
            payload["reset"] = True
        if chaos is not None:
            payload["chaos"] = chaos
        return self.request(peer_id, "inject", payload)

    def check_and_restart(self) -> List[str]:
        """Health-check the fleet and restart dead peers under the
        restart-storm guard: the first death restarts at once, repeated
        deaths back off exponentially (with per-peer jitter, capped at
        ``RESTART_BACKOFF_MAX_S``), and after ``MAX_RESTARTS`` without a
        stable period the peer stays down until :meth:`restart` is called.
        A peer healthy for ``RESTART_STABLE_S`` after its last restart is
        forgiven. Returns the peers restarted in this sweep."""
        restarted = []
        for pid, ok in self.health().items():
            pp = self.procs[pid]
            now = clock.monotonic()
            if ok:
                if pp.storm and (now - pp.last_restart_t
                                 >= RESTART_STABLE_S):
                    pp.storm = 0
                    pp.circuit_open = False
                continue
            if pp.circuit_open or now < pp.backoff_until:
                continue
            if pp.storm >= MAX_RESTARTS:
                pp.circuit_open = True
                FLIGHT.trigger(RESTART_CIRCUIT_OPEN, peer=pid,
                               restarts=pp.restarts, storm=pp.storm)
                continue
            self.restart(pid)
            pp.storm += 1
            pp.last_restart_t = clock.monotonic()
            delay = min(RESTART_BACKOFF_MAX_S,
                        RESTART_BACKOFF_S * (2 ** (pp.storm - 1)))
            delay *= 1.0 + RESTART_JITTER * pp._rng.random()
            pp.backoff_until = pp.last_restart_t + delay
            FLIGHT.record("supervisor.restart", peer=pid, storm=pp.storm,
                          next_backoff_s=delay)
            restarted.append(pid)
        return restarted

    def restart_states(self) -> Dict[str, dict]:
        """Each peer's restart-storm guard state."""
        now = clock.monotonic()
        return {pid: {"restarts": pp.restarts, "storm": pp.storm,
                      "circuit_open": pp.circuit_open,
                      "backoff_remaining_s":
                          max(pp.backoff_until - now, 0.0)}
                for pid, pp in self.procs.items()}

    def restart(self, peer_id: str) -> None:
        """Respawn a peer on its previous port. Its store starts empty: a
        restarted peer is a cold cache, never wrong data."""
        pp = self.procs[peer_id]
        if pp.alive:
            pp.proc.kill()
            pp.proc.wait(timeout=STOP_TIMEOUT_S)
        self._close_pipe(pp)
        pp.restarts += 1
        self._spawn(pp)
        self.wire_gossip()

    def kill(self, peer_id: str, hard: bool = True) -> None:
        """Take a peer down: ``hard`` is ``kill -9`` (no drain); otherwise
        the daemon is asked to drain and exit, and terminated, then
        killed, if it does not within ``STOP_TIMEOUT_S``."""
        pp = self.procs[peer_id]
        if not pp.alive:
            return
        if hard:
            pp.proc.send_signal(signal.SIGKILL)
            pp.proc.wait(timeout=STOP_TIMEOUT_S)
            return
        try:
            self.request(peer_id, "shutdown", {}, timeout=2.0)
        except TransportError as e:    # no answer: SIGTERM drains too
            pp.tail.append(f"shutdown: {e!r}")
            pp.proc.terminate()
        try:
            pp.proc.wait(timeout=STOP_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            pp.proc.kill()
            pp.proc.wait(timeout=STOP_TIMEOUT_S)

    @staticmethod
    def _close_pipe(pp: PeerProc) -> None:
        if pp.proc is not None and pp.proc.stdout:
            pp.proc.stdout.close()

    def stop(self) -> None:
        """Graceful teardown: the shutdown op (the daemon drains its
        in-flight requests), then SIGTERM, then SIGKILL. Each daemon's
        exit code stays in ``procs[pid].proc.returncode``. With a
        ``state_dir`` the client link beliefs are saved first."""
        self.save_estimators()
        for pid, pp in self.procs.items():
            if pp.alive:
                self.kill(pid, hard=False)
        for pp in self.procs.values():
            self._close_pipe(pp)

    def exit_codes(self) -> Dict[str, Optional[int]]:
        """Each daemon's exit code (None: running or never started)."""
        return {pid: (pp.proc.poll() if pp.proc is not None else None)
                for pid, pp in self.procs.items()}

    def __enter__(self) -> "PeerSupervisor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- bounded waits on remote state -------------------------------------
    def wait_converged(self, digests: Sequence[bytes],
                       timeout_s: float = 10.0) -> bool:
        """Poll until every live peer advertises every digest (its csync
        holds it, or a gossiped owner of it). False at the timeout."""
        deadline = clock.monotonic() + timeout_s
        want = {bytes(d) for d in digests}
        while clock.monotonic() < deadline:
            if all(want <= self._known(pid)
                   for pid, pp in self.procs.items() if pp.alive):
                return True
            time.sleep(POLL_S)         # another process's state: poll it
        return False

    def _known(self, peer_id: str) -> set:
        try:
            resp = self.request(peer_id, "csync",
                                {"since": 0, "since_remote": 0})
        except TransportError:
            return set()               # unreachable: knows nothing yet
        return {bytes(k) for k in resp.get("keys", [])} | \
            {bytes(k) for k, _ in resp.get("remote", [])}

    def wait_repaired(self, digests: Sequence[bytes],
                      timeout_s: float = 15.0) -> bool:
        """Poll until every digest can be read from its consistent-hash
        primary: after a primary is killed mid-upload and revived cold,
        the fallbacks' hinted handoffs must put the blobs back on it.
        False at the timeout."""
        from repro_torch.core.cluster.placement import PlacementPolicy
        placement = PlacementPolicy(sorted(self.procs))
        deadline = clock.monotonic() + timeout_s
        todo = {bytes(d) for d in digests}
        while clock.monotonic() < deadline:
            for d in list(todo):
                try:
                    resp = self.request(placement.primary(d), "get",
                                        {"key": d}, timeout=2.0)
                except TransportError:
                    continue           # down or restarting: poll again
                if resp.get("ok") and resp.get("blob") is not None:
                    todo.discard(d)
            if not todo:
                return True
            time.sleep(POLL_S)
        return False
