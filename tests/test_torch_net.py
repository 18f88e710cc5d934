"""The port's wire and runtime held against the reference's, on the CPU.

Frames: the port's ``encode_frame`` gives the reference's bytes (msgpack
``use_bin_type=True``) for every value the wire carries. Transports:
mirrors of ``tests/test_transport.py`` and the frame, peer-server,
estimator and TCP-directory tests of ``tests/test_net_runtime.py`` on
the port. Interop: a reference ``TCPTransport`` gets and puts against
the port's ``serve_tcp`` and a port ``TCPTransport`` against the
reference's, chunk streams and cancels included. Daemons: importing the
daemon loads no ``torch``, and a daemon process starts, answers and
shuts down cleanly.
"""
import os
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from repro.core import CacheServer as JaxCacheServer
from repro.core.net import frames as jax_frames
from repro.core.transport import StreamCancelled as JaxStreamCancelled
from repro.core.transport import TCPTransport as JaxTCPTransport
from repro.core.transport import serve_tcp as jax_serve_tcp
from repro_torch.config import CacheConfig
from repro_torch.core import state_io
from repro_torch.core.cluster.directory import PeerDirectory
from repro_torch.core.cluster.peer import CachePeer
from repro_torch.core.net import frames
from repro_torch.core.net.estimator import LinkEstimator
from repro_torch.core.net.link import TCPPeerLink
from repro_torch.core.net.server import serve_peer_tcp
from repro_torch.core.netsim import SimClock, SimNetwork, WallClock
from repro_torch.core.server import CacheServer
from repro_torch.core.transport import (InProcTransport, StreamCancelled,
                                        TCPTransport, TransportError,
                                        serve_tcp)

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from hypo_compat import given, settings, st

REPO = Path(__file__).resolve().parents[1]

# every integer width and sign msgpack distinguishes, at its edges
INT_EDGES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
             2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
             -2**31, -2**31 - 1, -2**63]


def _payload(seed: int, depth: int = 0):
    """A nested wire value drawn from ``seed``: maps with str and bytes
    keys, arrays, bytes, str, ints of every width and sign, float64,
    bool and nil."""
    r = np.random.default_rng(seed)
    kind = int(r.integers(0, 9 if depth < 3 else 7))
    if kind == 0:
        return r.bytes(int(r.choice([0, 5, 31, 255, 256, 70000])))
    if kind == 1:
        n = int(r.choice([0, 7, 31, 32, 255, 256, 70000]))
        return "".join(chr(int(c)) for c in r.integers(32, 0x2FF, n))
    if kind == 2:
        return INT_EDGES[int(r.integers(len(INT_EDGES)))]
    if kind == 3:
        return int(r.integers(-2**62, 2**62))
    if kind == 4:
        return float(r.choice([0.0, -0.0, 1.5, 1e-300, -3.25e12,
                               float(r.normal())]))
    if kind == 5:
        return bool(r.integers(2))
    if kind == 6:
        return None
    n = int(r.choice([0, 3, 15, 16, 17]))
    if kind == 7:
        return [_payload(seed * 31 + i + 1, depth + 1) for i in range(n)]
    out = {}
    for i in range(n):
        key = r.bytes(4) if r.integers(3) == 0 else f"k{i}"
        out[key] = _payload(seed * 37 + i + 1, depth + 1)
    return out


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_encode_frame_is_the_reference_bytes(seed):
    obj = {"op": "put", "key": b"k" * 32, "payload": _payload(seed)}
    data = frames.encode_frame(obj)
    assert data == jax_frames.encode_frame(obj)
    body = data[frames.HEADER_SIZE:]
    assert frames.unpack_payload(body) == jax_frames.unpack_payload(body)


@pytest.mark.parametrize("value", INT_EDGES + [0.1, -2.5e-308, True, False,
                                               None, "", "x" * 32, b"",
                                               b"y" * 65536, [], {}])
def test_scalar_frames_are_the_reference_bytes(value):
    obj = {"v": value, "l": [value, [value]], b"b": {"s": value}}
    assert frames.encode_frame(obj) == jax_frames.encode_frame(obj)


def test_frames_of_a_client_exchange_are_the_reference_bytes():
    """The messages the fabric sends, a PC3 blob inside, with the fields
    the planner and directory carry (float64 seconds, negative ints)."""
    blob = state_io.pack_container([b"h" * 100, b"c" * 3000, b""])
    for obj in ({"op": "get", "key": b"\x00" * 32},
                {"ok": True, "blob": blob},
                {"op": "csync", "since": 3, "since_remote": 0},
                {"ok": True, "keys": [b"a" * 32], "version": 1,
                 "remote": [[b"b" * 32, "peer1"]], "remote_version": 1,
                 "tombstones": 0, "peer": "peer0"},
                {"ok": True, "stored": False, "version": -1,
                 "est_fetch_s": 0.0031415, "bps": 21e6}):
        assert frames.encode_frame(obj) == jax_frames.encode_frame(obj)


# -- frame format (mirrors tests/test_net_runtime.py) ------------------------

def test_frame_roundtrip_and_size():
    obj = {"op": "put", "key": b"k" * 32, "blob": b"x" * 10_000}
    data = frames.encode_frame(obj)
    n = frames.parse_header(data[:frames.HEADER_SIZE])
    assert n == len(data) - frames.HEADER_SIZE
    assert frames.unpack_payload(data[frames.HEADER_SIZE:]) == obj


@pytest.mark.parametrize("header", [
    b"XX" + struct.pack("<BxI", frames.VERSION, 1),          # bad magic
    struct.pack("<2sBxI", frames.MAGIC, 99, 1),              # bad version
    struct.pack("<2sBxI", frames.MAGIC, frames.VERSION,      # oversize
                frames.MAX_FRAME_BYTES + 1)])
def test_bad_frame_header_is_rejected(header):
    with pytest.raises(frames.FrameError):
        frames.parse_header(header)


def test_undecodable_payload_is_a_frame_error():
    with pytest.raises(frames.FrameError):
        frames.unpack_payload(frames.pack_payload({"a": 1}) + b"\x00")


# -- transports (mirrors tests/test_transport.py) ----------------------------

def test_inproc_latency_model():
    server = CacheServer(CacheConfig())
    clock = SimClock()
    net = SimNetwork(bandwidth_bps=8e6, rtt_s=0.01)   # 1 MB/s
    tr = InProcTransport(server, net, clock)
    blob = b"x" * 1_000_000
    _, dt, nbytes = tr.request("put", {"key": b"k", "blob": blob})
    assert nbytes > 1_000_000
    assert abs(dt - (0.01 + nbytes * 8 / 8e6)) < 1e-9
    assert clock.now() == dt
    _, _, _ = tr.request("sync", {"since": 0}, advance_clock=False)
    assert clock.now() == dt           # an asynchronous op: no advance


def test_inproc_without_a_network_reports_wall_seconds():
    tr = InProcTransport(CacheServer(CacheConfig()))
    assert tr.net is None and tr.clock is None
    resp, dt, nbytes = tr.request("put", {"key": b"k", "blob": b"b" * 10})
    assert resp["stored"] and 0 < dt < 5.0 and nbytes > 10


def test_tcp_roundtrip():
    server = CacheServer(CacheConfig())
    port, shutdown = serve_tcp(server)
    try:
        tr = TCPTransport("127.0.0.1", port)
        resp, dt, _ = tr.request("put", {"key": b"abc", "blob": b"payload"})
        assert resp["ok"] and dt > 0
        assert tr.request("get", {"key": b"abc"})[0]["blob"] == b"payload"
        resp, _, _ = tr.request("sync", {"since": 0})
        assert resp["keys"] == [b"abc"] and resp["version"] == 1
        assert not tr.request("get", {"key": b"missing"})[0]["ok"]
        assert tr.request("stats", {})[0]["n_entries"] == 1
        tr.close()
    finally:
        shutdown()


def _closed_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_tcp_connect_refused_raises_transport_error():
    with pytest.raises(TransportError):
        TCPTransport("127.0.0.1", _closed_port(), timeout=0.5)


def test_tcp_dead_server_raises_transport_error_not_hang():
    port, shutdown = serve_tcp(CacheServer(CacheConfig()))
    tr = TCPTransport("127.0.0.1", port, timeout=1.0)
    assert tr.request("ping", {})[0]["ok"]
    shutdown()                         # the server goes away mid-session
    with pytest.raises(TransportError):
        for _ in range(3):
            tr.request("ping", {})
    tr.close()


def test_tcp_request_timeout_is_bounded():
    srv = socket.socket()              # accepts, never answers
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    tr = TCPTransport("127.0.0.1", srv.getsockname()[1], timeout=0.3)
    t0 = time.perf_counter()
    with pytest.raises(TransportError):
        tr.request("ping", {})
    assert time.perf_counter() - t0 < 5.0
    tr.close()
    srv.close()


def test_server_sync_incremental():
    server = CacheServer(CacheConfig())
    server.put(b"k1", b"b1")
    keys, v1 = server.sync(0)
    assert keys == [b"k1"]
    server.put(b"k2", b"b2")
    keys, v2 = server.sync(v1)
    assert keys == [b"k2"] and v2 == 2
    server.put(b"k2", b"b2-new")       # a re-put does not grow the log
    assert server.sync(v2)[0] == []


# -- the peer server (mirrors tests/test_net_runtime.py) ---------------------

def test_peer_server_roundtrip_with_csync():
    peer = CachePeer("p0", CacheConfig())
    with serve_peer_tcp(peer) as srv:
        link = TCPPeerLink("p0", "127.0.0.1", srv.port, timeout=5.0)
        assert link.request("put", {"key": b"k" * 32, "blob": b"blob"})[0][
            "ok"]
        assert link.request("get", {"key": b"k" * 32})[0]["blob"] == b"blob"
        resp, _, _ = link.request("csync", {"since": 0, "since_remote": 0})
        assert resp["peer"] == "p0" and resp["keys"] == [b"k" * 32]
        link.close()


def test_peer_server_handler_exception_is_error_reply_not_close():
    class Boom:
        def handle(self, op, payload):
            if op == "boom":
                raise RuntimeError("kaboom")
            return {"ok": True}

    with serve_peer_tcp(Boom()) as srv:
        link = TCPPeerLink("b", "127.0.0.1", srv.port, timeout=5.0)
        resp, _, _ = link.request("boom", {})
        assert not resp["ok"] and "kaboom" in resp["error"]
        assert link.request("ping", {})[0]["ok"]   # the connection lives
        link.close()


def test_graceful_shutdown_drains_inflight_request():
    started = threading.Event()

    class Slow:
        def handle(self, op, payload):
            started.set()
            time.sleep(0.4)
            return {"ok": True, "slept": True}

    srv = serve_peer_tcp(Slow())
    link = TCPPeerLink("slow", "127.0.0.1", srv.port, timeout=5.0)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "resp", link.request("work", {})[0]))
    t.start()
    assert started.wait(2.0)
    srv.close(graceful=True)           # drains the request first
    t.join(5.0)
    assert not t.is_alive()
    assert out.get("resp", {}).get("slept") is True
    with pytest.raises(TransportError):
        link.request("work", {})
    link.close()


def _one_shot_server(reply: bytes):
    """A listener that reads one request, sends ``reply`` and closes."""
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)

    def serve():
        conn, _ = lsock.accept()
        conn.recv(1 << 16)
        conn.sendall(reply)
        conn.close()

    threading.Thread(target=serve, daemon=True).start()
    return lsock


@pytest.mark.parametrize("reply", [
    frames.encode_frame({"ok": True})[:5],        # half a frame
    b"HTTP/1.1 400 Bad Request\r\n\r\n"],         # another protocol
    ids=["truncated", "garbage"])
def test_bad_reply_is_transport_error_not_hang(reply):
    lsock = _one_shot_server(reply)
    link = TCPPeerLink("x", "127.0.0.1", lsock.getsockname()[1], timeout=2.0)
    t0 = time.perf_counter()
    with pytest.raises(TransportError):
        link.request("get", {"key": b"k"})
    assert time.perf_counter() - t0 < 5.0
    link.close()
    lsock.close()


def _container(n_data: int, size: int = 2000) -> bytes:
    return state_io.pack_container([b"H" * 64] + [bytes([i]) * size
                                                  for i in range(n_data)])


def test_chunk_stream_and_cancel_over_tcp():
    """A streamed GET delivers every chunk; a cancel mid-stream raises
    StreamCancelled and leaves the connection usable."""
    server = CacheServer(CacheConfig())
    blob = _container(12)
    server.put(b"k" * 32, blob)
    port, shutdown = serve_tcp(server)
    try:
        tr = TCPTransport("127.0.0.1", port)
        got = []
        hdr, _, nb = tr.request_stream(
            "get_chunks", {"key": b"k" * 32},
            lambda c, dt, n: got.append(c))
        assert hdr["ok"] and hdr["n_chunks"] == 13
        assert got == state_io.split_container(blob) and nb > len(blob)
        cancel = threading.Event()

        def on_chunk(c, dt, n):
            got.append(c)
            if len(got) == 15:
                cancel.set()

        with pytest.raises(StreamCancelled):
            tr.request_stream("get_chunks", {"key": b"k" * 32}, on_chunk,
                              cancel=cancel)
        assert len(got) < 13 + 13
        assert tr.request("ping", {})[0]["ok"]     # not poisoned
        tr.close()
    finally:
        shutdown()


def test_inproc_sim_stream_charges_the_single_frame_time():
    server = CacheServer(CacheConfig())
    server.put(b"k", _container(4))
    net = SimNetwork(8e6, 0.01)
    tr = InProcTransport(server, net, SimClock())
    seen = []
    hdr, dt, nb = tr.request_stream("get_chunks", {"key": b"k"},
                                    lambda c, d, n: seen.append((d, n)))
    assert hdr["n_chunks"] == 5 and len(seen) == 5
    assert dt == pytest.approx(net.transfer_time(nb), rel=1e-12)
    assert tr.clock.now() == pytest.approx(dt, rel=1e-12)


# -- port and reference over one socket, both ways ---------------------------

@pytest.mark.parametrize("direction", ["reference-client/port-server",
                                       "port-client/reference-server"])
def test_tcp_interop_with_the_reference(direction):
    if direction.startswith("reference"):
        server = CacheServer(CacheConfig())
        port, shutdown = serve_tcp(server)
        tr = JaxTCPTransport("127.0.0.1", port)
        cancelled = JaxStreamCancelled
    else:
        from repro.config import CacheConfig as JaxCacheConfig
        server = JaxCacheServer(JaxCacheConfig())
        port, shutdown = jax_serve_tcp(server)
        tr = TCPTransport("127.0.0.1", port)
        cancelled = StreamCancelled
    blob = _container(10)
    try:
        resp, _, up = tr.request("put", {"key": b"q" * 32, "blob": blob})
        assert resp["ok"] and resp["stored"] and up > len(blob)
        assert tr.request("get", {"key": b"q" * 32})[0]["blob"] == blob
        assert not tr.request("get", {"key": b"z" * 32})[0]["ok"]
        resp, _, _ = tr.request("sync", {"since": 0})
        assert resp["keys"] == [b"q" * 32] and resp["version"] == 1
        got = []
        hdr, _, _ = tr.request_stream("get_chunks", {"key": b"q" * 32},
                                      lambda c, dt, n: got.append(c))
        assert hdr["n_chunks"] == 11
        assert got == state_io.split_container(blob)
        cancel = threading.Event()
        cancel.set()
        with pytest.raises(cancelled):
            tr.request_stream("get_chunks", {"key": b"q" * 32},
                              lambda c, dt, n: None, cancel=cancel)
        assert tr.request("ping", {})[0]["ok"]
        assert tr.request("get", {"key": b"q" * 32})[0]["blob"] == blob
        tr.close()
    finally:
        shutdown()


# -- link estimation (mirrors tests/test_net_runtime.py) ---------------------

def test_estimator_seeded_matches_static_costs():
    est = LinkEstimator()
    est.seed("a", 21e6, 0.003)
    nb = 1_000_000
    assert est.est_fetch_s("a", nb) == pytest.approx(0.003 + nb * 8 / 21e6)


def test_estimator_adapts_to_congestion_and_recovers_rtt():
    est = LinkEstimator(alpha=0.5)
    est.seed("a", 40e6, 0.002)
    nb = 500_000
    for _ in range(8):
        est.observe("a", nb, 0.002 + nb * 8 / 4e6)
    bw, rtt, n_obs = est.snapshot("a")
    assert n_obs == 8 and bw == pytest.approx(4e6, rel=0.05)
    for _ in range(8):
        est.observe("a", 256, 0.002 + 256 * 8 / bw)
    assert est.snapshot("a")[1] == pytest.approx(0.002, rel=0.05)


def test_estimator_in_sim_stays_at_truth():
    est = LinkEstimator()
    bw, rtt = 21e6, 0.003
    est.seed("a", bw, rtt)
    for nb in (2_000_000, 500_000, 100_000):
        est.observe("a", nb, rtt + nb * 8 / bw)
    for _ in range(3):
        est.observe("a", 256, rtt + 256 * 8 / bw)
    got_bw, got_rtt, _ = est.snapshot("a")
    assert got_bw == pytest.approx(bw, rel=1e-6)
    assert got_rtt == pytest.approx(rtt, rel=1e-6)


def test_estimator_degenerate_samples_match_the_reference():
    """An unseeded peer takes the default prior, a sample of no time is
    dropped, an exchange faster than the believed RTT lowers it (loopback
    against a Wi-Fi prior), and bandwidth samples clamp at the ceiling
    and floor: each as the reference does."""
    from repro.core.net.estimator import LinkEstimator as JaxEstimator
    ours, ref = LinkEstimator(), JaxEstimator()
    assert ours.snapshot("x") == ref.snapshot("x") == (21e6, 0.003, 0)
    assert ours.est_fetch_s("x", 10**6) == ref.est_fetch_s("x", 10**6)
    samples = [("x", 10**6, 0.0), ("x", 10**6, -1.0),
               ("x", 8_000_000, 0.001), ("x", 10**9, 1e-9),
               ("y", 100_000, 3600.0), ("y", 4096, 0.002),
               ("y", 4097, 0.002)]
    for pid, nb, sec in samples:
        ours.observe(pid, nb, sec)
        ref.observe(pid, nb, sec)
        assert ours.snapshot(pid) == ref.snapshot(pid), (pid, nb, sec)
    assert ours.snapshot("x")[2] == 2          # the two empty samples dropped
    assert ours.snapshot("x")[1] < 0.003       # RTT fell under the prior


def test_estimator_matches_the_reference_on_one_sample_sequence():
    from repro.core.net.estimator import LinkEstimator as JaxEstimator
    ours, ref = LinkEstimator(), JaxEstimator()
    for e in (ours, ref):
        e.seed("a", 30e6, 0.002)
    samples = [(2_000_000, 0.9), (256, 0.004), (700_000, 0.05),
               (128, 1e-4), (5_000_000, 0.0015)]
    for nb, s in samples:
        ours.observe("a", nb, s)
        ref.observe("a", nb, s)
    assert ours.snapshot("a") == ref.snapshot("a")


def test_directory_over_tcp_links_marks_suspect_with_wall_clock():
    peer = CachePeer("p0", CacheConfig())
    srv = serve_peer_tcp(peer)
    links = [TCPPeerLink("p0", "127.0.0.1", srv.port, timeout=1.0),
             TCPPeerLink("ghost", "127.0.0.1", _closed_port(), timeout=0.3)]
    d = PeerDirectory(links, clock=WallClock(), suspect_cooldown_s=30.0)
    assert d.links["p0"].net is None
    assert d.request("p0", "ping", {})[0]["ok"]
    with pytest.raises(TransportError):
        d.request("ghost", "ping", {})
    assert d.usable_ids() == ["p0"]
    assert d.est_fetch_s("p0", 1_000_000) > 0
    for link in links:
        link.close()
    srv.close()


# -- the daemon ---------------------------------------------------------------

def _env():
    return dict(os.environ, PYTHONPATH=str(REPO / "src"))


def test_daemon_import_loads_no_torch():
    code = ("import sys, repro_torch.core.net.daemon\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'msgpack', 'repro')))\n")
    proc = subprocess.run([sys.executable, "-c", code], env=_env(),
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_daemon_gossip_picks_are_seeded_from_the_peer_id():
    """Two processes under different hash seeds pick the same gossip
    neighbours (the reference seeds them with ``hash(peer_id)``)."""
    code = ("from repro_torch.core.net.daemon import gossip_rng\n"
            "r = gossip_rng('peer0')\n"
            "print([r.sample(['a', 'b', 'c', 'd'], 2) for _ in range(4)])\n")
    outs = {subprocess.run([sys.executable, "-c", code],
                           env=dict(_env(), PYTHONHASHSEED=seed),
                           capture_output=True, text=True,
                           timeout=60).stdout for seed in ("1", "2", "3")}
    assert len(outs) == 1 and outs.pop().startswith("[[")


def _spawn(peer_id: str):
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.core.net.daemon", "--peer-id",
         peer_id, "--port", "0", "--gossip-interval", "0.05"],
        env=_env(), stdout=subprocess.PIPE, text=True)
    tag, pid, host, port = proc.stdout.readline().split()
    assert (tag, pid) == ("PEER-READY", peer_id)
    return proc, (host, int(port))


def test_daemons_replicate_gossip_and_shut_down():
    """Three daemon processes: set_neighbors wires the ring, a PUT lands
    on its owners (the gossip thread pumps the push), gossip spreads the
    key, health answers, and each exits 0 on shutdown."""
    procs, addrs = {}, {}
    try:
        for pid in ("peer0", "peer1", "peer2"):
            procs[pid], addrs[pid] = _spawn(pid)
        links = {pid: TCPPeerLink(pid, *addrs[pid]) for pid in procs}
        peers = {pid: list(a) for pid, a in addrs.items()}
        for link in links.values():
            resp = link.request("set_neighbors", {
                "peers": peers, "ring": sorted(peers), "repl_factor": 2})[0]
            assert resp["ok"] and resp["n_neighbors"] == 2
        from repro_torch.core.cluster.placement import PlacementPolicy
        digest = b"\x42" * 32
        owners = PlacementPolicy(sorted(peers)).ring_order(digest)[:2]
        other = next(p for p in peers if p not in owners)
        assert links[owners[0]].request(
            "put", {"key": digest, "blob": b"v" * 500})[0]["stored"]
        deadline = time.perf_counter() + 20.0
        while time.perf_counter() < deadline:
            held = [p for p in peers if links[p].request(
                "get", {"key": digest})[0]["ok"]]
            known = links[other].request(
                "csync", {"since": 0, "since_remote": 0})[0]["remote"]
            if sorted(held) == sorted(owners) and known:
                break
            time.sleep(0.05)
        assert sorted(held) == sorted(owners)
        assert {bytes(k) for k, _ in known} == {digest}
        health = links[owners[0]].request("health", {})[0]
        assert health["ok"] and health["repl"]["repl_pushed"] == 1
        for pid, link in links.items():
            assert link.request("shutdown", {})[0]["bye"] == pid
            link.close()
        for proc in procs.values():
            assert proc.wait(timeout=15) == 0
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
            proc.stdout.close()


def test_daemon_sigterm_is_a_graceful_exit():
    proc, addr = _spawn("solo")
    try:
        link = TCPPeerLink("solo", *addr, timeout=5.0)
        assert link.request("ping", {})[0]["ok"]
        proc.terminate()
        assert proc.wait(timeout=15) == 0
        t0 = time.perf_counter()
        with pytest.raises(TransportError):
            link.request("ping", {})
        assert time.perf_counter() - t0 < 6.0
        link.close()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
