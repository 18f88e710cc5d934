"""The port's observability, held against the reference's.

Mirrors ``tests/test_obs.py`` on ``repro_torch.obs``: span nesting, the
explicit cross-thread handoff, the null tracer, aliases and the bounded
store, remote folding, the ``Breakdown`` projection, the mocked clock,
the Perfetto export, the tolerant ``_trace`` envelope, a server with and
without it, the flight recorder (ring, dumps, the JSONL cap, the dump on
a corrupt chunk) and a client request's trace id. Where the reference
computes the same thing (folded span times, the projection, Perfetto
documents, envelopes, flight dumps) the same inputs go through both and
must agree exactly. In place of the reference's two JAX-free import
tests: ``repro_torch.obs``, ``repro_torch.chaos``, the daemon and the
supervisor import without ``torch``. Across packages: a traced port
directory against a reference daemon folds its spans, and the other way
round. The metrics registry's tests are in
``tests/test_torch_fabric_runtime.py``.
"""
import json
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest

from repro.core.cluster.directory import PeerDirectory as JaxDirectory
from repro.core.cluster.peer import CachePeer as JaxPeer
from repro.core.metrics import Breakdown as JaxBreakdown
from repro.core.net.link import TCPPeerLink as JaxLink
from repro.core.net.server import serve_peer_tcp as jax_serve_peer_tcp
from repro.core.netsim import WallClock as JaxWallClock
from repro.obs import export as jax_export
from repro.obs.flight import FlightRecorder as JaxFlightRecorder
from repro.obs.trace import Tracer as JaxTracer
from repro.obs.trace import extract_trace as jax_extract_trace
from repro_torch import clock
from repro_torch.config import CacheConfig
from repro_torch.configs import get_config
from repro_torch.core import state_io
from repro_torch.core.client import EdgeClient
from repro_torch.core.cluster.directory import PeerDirectory
from repro_torch.core.cluster.peer import CachePeer
from repro_torch.core.metrics import Breakdown
from repro_torch.core.net.link import TCPPeerLink
from repro_torch.core.net.server import serve_peer_tcp
from repro_torch.core.netsim import SimClock, SimNetwork, WallClock
from repro_torch.core.server import CacheServer
from repro_torch.core.transport import InProcTransport
from repro_torch.data.mmlu import MMLUGenerator
from repro_torch.data.tokenizer import WordHashTokenizer
from repro_torch.models.model import Model
from repro_torch.obs import flight as flight_mod
from repro_torch.obs.export import (perfetto_trace, span_tree, write_jsonl,
                                    write_perfetto)
from repro_torch.obs.flight import (CHUNK_ERROR, FLIGHT, PLAN_EXHAUSTED,
                                    FlightRecorder)
from repro_torch.obs.ledger import LEDGER
from repro_torch.obs.trace import (NULL_SPAN, NULL_TRACER, SPANS_KEY,
                                   TRACE_KEY, SpanContext, Tracer,
                                   current_span, extract_trace, inject_trace,
                                   phase)
from repro_torch.params import from_jax_params
from repro_torch.serving.engine import InferenceEngine

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MAX_LEN = 512


@pytest.fixture(scope="module")
def world(tiny_setup):
    cfg, _, jp = tiny_setup
    model = Model(get_config("gemma3-270m").reduced(), device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)))
    engine = InferenceEngine(model, max_len=MAX_LEN)
    gen = MMLUGenerator(WordHashTokenizer(cfg.vocab), n_shot=2)
    return cfg, engine, gen


# ---------------------------------------------------------------------------
# spans: nesting, ambient parents, cross-thread handoff
# ---------------------------------------------------------------------------

def test_span_nesting_via_ambient_parent():
    tr = Tracer(proc="t")
    with tr.start("root") as root:
        with tr.start("child") as child:
            with phase("grandchild", k=1) as gc:
                assert gc.parent_id == child.span_id
        assert child.parent_id == root.span_id
    spans = tr.trace(root.trace_id)
    assert {d["name"] for d in spans} == {"root", "child", "grandchild"}
    assert all(d["trace"] == root.trace_id for d in spans)
    # the reference's id formats: 16 and 16 hex digits
    assert len(root.trace_id) == 16 and len(root.span_id) == 16
    int(root.trace_id, 16)
    tree = span_tree(spans)
    assert tree["name"] == "root"
    assert tree["children"][0]["name"] == "child"
    assert tree["children"][0]["children"][0]["name"] == "grandchild"
    assert jax_export.span_tree(spans) == tree


def test_cross_thread_handoff_is_explicit():
    tr = Tracer(proc="t")
    got = {}

    def worker(ctx):
        assert current_span() is None      # nothing leaks through threads
        with tr.attach(ctx):
            with phase("worker.step") as sp:
                got["parent"] = sp.parent_id
                got["trace"] = sp.trace_id

    with tr.start("root") as root:
        t = threading.Thread(target=worker, args=(root.ctx,))
        t.start()
        t.join(10.0)
    assert got == {"parent": root.span_id, "trace": root.trace_id}


def test_null_tracer_and_disabled_paths_are_inert():
    sp = NULL_TRACER.start("x")
    assert sp is NULL_SPAN and not sp
    with sp:
        with phase("y") as p:
            assert p is NULL_SPAN
    assert NULL_TRACER.trace("x") is None
    assert Tracer(enabled=False).add("z", 1.0) is NULL_SPAN


def test_tracer_alias_and_bounded_store():
    tr = Tracer(proc="t", max_traces=2)
    ids = []
    for i in range(3):
        with tr.start(f"r{i}") as sp:
            pass
        ids.append(sp.trace_id)
        tr.alias(f"cmpl-{i}", sp.trace_id)
    assert tr.trace(ids[0]) is None          # FIFO-evicted
    assert tr.trace("cmpl-0") is None        # its alias with it
    assert tr.trace("cmpl-2")[0]["name"] == "r2"
    assert tr.trace(ids[1])[0]["name"] == "r1"


DESCS = [{"name": "peer.get", "rel_s": 0.0, "dur_s": 0.2,
          "attrs": {"pid": 42}},
         {"name": "chunk.verify", "rel_s": 0.05, "dur_s": 0.1, "attrs": {}}]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_fold_remote_centers_server_window(pkg):
    tr = (Tracer if pkg == "port" else JaxTracer)(proc="client")
    net = tr.start("net.get", t0=100.0)
    net.end(t1=100.4)                        # 400 ms round trip
    assert tr.fold_remote(net, DESCS, proc="peer:p0") == 2
    spans = {d["name"]: d for d in tr.trace(net.trace_id)}
    folded = spans["peer.get"]
    assert folded["parent"] == net.span_id
    assert folded["proc"] == "peer:p0"
    assert folded["attrs"] == {"pid": 42, "remote": True}
    # the 0.2 s server window centred in the 0.4 s client span
    assert folded["t0"] == pytest.approx(100.1, abs=1e-12)
    assert spans["chunk.verify"]["t0"] == pytest.approx(100.15, abs=1e-12)
    assert folded["t0"] + folded["dur"] <= net.t0 + net.dur + 1e-9


def _phases(tr):
    root = tr.start("infer")
    with root:
        tr.add("bloom", 0.01, component="bloom")
        tr.add("redis.attempt", 0.30, component="redis", component_s=0.25)
        tr.add("p_decode", 0.50, component="p_decode")
        tr.add("r_decode", 0.40, component="r_decode")
        tr.add("untagged.phase", 9.9)        # no component: not summed
    return tr.trace(root.trace_id)


def test_breakdown_is_projection_of_span_tree():
    spans = _phases(Tracer(proc="client"))
    wall = Breakdown.from_spans(spans)
    assert wall.bloom == pytest.approx(0.01)
    assert wall.redis == pytest.approx(0.25)  # component_s wins
    assert wall.p_decode == pytest.approx(0.50)
    assert wall.r_decode == pytest.approx(0.40)
    # the reference projects the same spans (either package's) alike
    assert wall.as_dict() == JaxBreakdown.from_spans(spans).as_dict()
    assert Breakdown.from_spans(_phases(JaxTracer())).as_dict() == \
        wall.as_dict()


def test_mock_clock_swaps_time_sources():
    mc = clock.MockClock(10.0)
    with clock.mocked(mc) as got:
        assert got is mc
        t0 = clock.monotonic()
        mc.advance(2.5)
        assert clock.monotonic() - t0 == pytest.approx(2.5)
        assert clock.wall() == 12.5
        tr = Tracer()
        with tr.start("frozen") as sp:
            mc.advance(0.75)
        assert sp.dur == pytest.approx(0.75)   # spans read the mocked clock
    assert clock.monotonic() != 13.25          # the real source is back


# ---------------------------------------------------------------------------
# Perfetto export
# ---------------------------------------------------------------------------

def test_perfetto_schema(tmp_path):
    tr = Tracer(proc="client")
    with tr.start("infer") as root:
        tr.add("redis.attempt", 0.1, component="redis", peer="p0")
    tr.fold_remote(root, [{"name": "peer.get", "rel_s": 0.0,
                           "dur_s": 0.05, "attrs": {}}], proc="peer:p0")
    spans = tr.trace(root.trace_id)
    doc = perfetto_trace(spans)
    assert doc == jax_export.perfetto_trace(spans)
    procs = [e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M"]
    assert set(procs) == {"client", "peer:p0"}     # a track a process
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == 3
    for e in xs:
        assert e["ts"] >= 0 and e["dur"] >= 0      # microseconds
        assert e["args"]["trace_id"] == root.trace_id
    att = next(e for e in xs if e["name"] == "redis.attempt")
    assert att["cat"] == "redis"
    assert att["args"]["parent_span"] == root.span_id
    path = write_perfetto(str(tmp_path / "trace.json"), spans)
    loaded = json.load(open(path))
    assert loaded["displayTimeUnit"] == "ms"
    assert len(loaded["traceEvents"]) == len(doc["traceEvents"])


# ---------------------------------------------------------------------------
# the _trace envelope
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("raw", [None, "garbled", [1, 2], ["t", "s"],
                                 [b"t", b"s"], ["t", "s", "u"]])
def test_extract_trace_is_tolerant_and_matches_the_reference(raw):
    p = {"key": b"k"} if raw is None else {TRACE_KEY: raw, "key": b"k"}
    q = dict(p)
    got = extract_trace(p)
    assert got == jax_extract_trace(q)
    assert p == q == {"key": b"k"}           # popped by both
    if raw in (["t", "s"], [b"t", b"s"]):
        assert got == SpanContext("t", "s")
    else:
        assert got is None


def test_inject_trace_matches_the_reference():
    tr, jtr = Tracer(), JaxTracer()
    with tr.start("a") as sp:
        out = inject_trace({"key": b"k"}, sp)
    assert out == {"key": b"k", TRACE_KEY: [sp.trace_id, sp.span_id]}
    assert inject_trace({"key": b"k"}, NULL_SPAN) == {"key": b"k"}
    with jtr.start("b") as jsp:
        from repro.obs.trace import inject_trace as jax_inject
        assert jax_inject({"key": b"k"}, jsp)[TRACE_KEY] == \
            [jsp.trace_id, jsp.span_id]
    assert inject_trace({}, sp.ctx)[TRACE_KEY] == [sp.trace_id, sp.span_id]


def test_server_interop_with_and_without_trace_ctx():
    """Without ``_trace`` an op is served as before and answered without
    ``_spans``; with it, the same op returns the server's descriptors.
    The bytes charged are the op's own either way."""
    t = InProcTransport(CacheServer(CacheConfig()), SimNetwork(), SimClock())
    blob = b"x" * 64
    resp, _, _ = t.request("put", {"key": b"k" * 32, "blob": blob})
    assert resp["ok"] and SPANS_KEY not in resp
    resp, dt_plain, nb_plain = t.request("get", {"key": b"k" * 32})
    assert resp["ok"] and SPANS_KEY not in resp

    tr = Tracer(proc="client")
    with tr.start("infer") as root:
        payload = inject_trace({"key": b"k" * 32}, root)
        resp, dt, nb = t.request("get", payload)
    assert resp["ok"] and resp["blob"] == blob
    assert (dt, nb) == (dt_plain, nb_plain)   # tracing moves no sim seconds
    descs = resp[SPANS_KEY]
    assert descs and descs[0]["name"] == "peer.get"
    assert descs[0]["dur_s"] >= 0
    assert tr.fold_remote(root, descs, proc="peer:sim") == len(descs)
    assert {"client", "peer:sim"} <= {d["proc"]
                                      for d in tr.trace(root.trace_id)}


def _directory_tree(tracer, directory, peer_id, key):
    with tracer.start("infer") as root:
        resp, _, _ = directory.request(peer_id, "get", {"key": key})
    return resp, tracer.trace(root.trace_id), root


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_traced_request_folds_the_other_package_daemon_spans(client_pkg):
    """A traced port directory against a reference peer server, and a
    traced reference directory against a port peer server: the envelope
    is the same bytes, so each side gets ``_spans`` and folds them into
    one tree under its ``net.get`` span."""
    key, blob = b"\x07" * 32, b"blob" * 16
    if client_pkg == "port":
        peer = JaxPeer("p0")
        peer.server.put(key, blob)
        srv = jax_serve_peer_tcp(peer)
        tracer = Tracer(proc="client")
        d = PeerDirectory([TCPPeerLink("p0", "127.0.0.1", srv.port,
                                       timeout=10.0)], clock=WallClock())
    else:
        peer = CachePeer("p0")
        peer.server.put(key, blob)
        srv = serve_peer_tcp(peer)
        tracer = JaxTracer(proc="client")
        d = JaxDirectory([JaxLink("p0", "127.0.0.1", srv.port,
                                  timeout=10.0)], clock=JaxWallClock())
    try:
        resp, spans, root = _directory_tree(tracer, d, "p0", key)
    finally:
        srv.close()
    assert resp["ok"] and resp["blob"] == blob
    by = {d_["name"]: d_ for d_ in spans}
    assert {"infer", "net.get", "peer.get"} <= set(by)
    assert by["net.get"]["parent"] == root.span_id
    remote = by["peer.get"]
    assert remote["parent"] == by["net.get"]["span"]
    assert remote["proc"] == "peer:p0"
    assert remote["attrs"]["remote"] is True
    assert remote["attrs"]["pid"] == os.getpid()   # the server's process
    assert all(s["trace"] == root.trace_id for s in spans)


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def _fill(fr):
    for i in range(10):
        fr.record("fetch.attempt", peer=f"p{i}")
    return fr.trigger("plan_exhausted", client="c0", err=ValueError("x"))


def test_flight_recorder_ring_and_dump(monkeypatch):
    monkeypatch.setattr(flight_mod, "CAPACITY", 4)
    monkeypatch.setattr(flight_mod, "MAX_DUMPS", 2)
    fr = FlightRecorder()
    dump = _fill(fr)
    ref = _fill(JaxFlightRecorder(capacity=4, max_dumps=2))

    def plain(d):                  # the clock readings differ, nothing else
        return {"reason": d["reason"], "context": d["context"],
                "events": [{k: v for k, v in e.items() if k != "mono"}
                           for e in d["events"]]}
    assert plain(dump) == plain(ref)
    assert dump["reason"] == "plan_exhausted"
    assert dump["context"] == {"client": "c0", "err": repr(ValueError("x"))}
    assert len(dump["events"]) == 4                  # ring-bounded
    assert dump["events"][-1]["peer"] == "p9"
    for _ in range(5):
        fr.trigger("shed")
    assert len(fr.dumps()) == 2                      # dumps bounded too
    snap = fr.snapshot()
    assert snap == {"events": 4, "seq": 10, "dumps": 2, "capacity": 4}


def test_write_jsonl_appends_dumps(tmp_path):
    """The JSONL log: one object a line, appended, the reference's
    lines for the same dumps."""
    fr = FlightRecorder()
    for i in range(3):
        fr.trigger("shed", i=i)
    path = str(tmp_path / "flight.jsonl")
    assert write_jsonl(path, fr.dumps()) == 3
    assert write_jsonl(path, fr.dumps()) == 3
    lines = open(path).readlines()
    assert [json.loads(x) for x in lines] == 2 * fr.dumps()
    ref = str(tmp_path / "ref.jsonl")
    jax_export.write_jsonl(ref, fr.dumps())
    assert lines[:3] == open(ref).readlines()


def test_flight_dump_on_injected_chunk_error(world):
    """A corrupt chunk stream fails the streamed fetch with one bounded
    error and freezes a ``chunk_error`` dump; the plan's exhaustion
    freezes the last."""
    cfg, engine, gen = world
    server = CacheServer(CacheConfig())
    sim_clock, net = SimClock(), SimNetwork()

    def client(name, overlap=False):
        return EdgeClient(name, engine, InProcTransport(server, net,
                                                        sim_clock),
                          CacheConfig(), overlap=overlap)

    client("seed").infer(gen.prompt("virology", 0).segments,
                         max_new_tokens=2)
    for key, blob in list(server.store.items()):
        chunks = state_io.split_container(blob)
        bad = bytearray(chunks[-1])
        bad[len(bad) // 2] ^= 0xFF
        chunks[-1] = bytes(bad)
        server.store[key] = state_io.pack_container(chunks)
    FLIGHT.clear()
    c = client("stream", overlap=True)
    c.sync_catalog()
    res = c.infer(gen.prompt("virology", 1).segments, max_new_tokens=2,
                  upload_on_miss=False)
    assert res.matched_tokens == 0                   # degraded, not hung
    dumps = FLIGHT.dumps()
    chunk_dumps = [d for d in dumps if d["reason"] == CHUNK_ERROR]
    assert chunk_dumps
    assert chunk_dumps[0]["context"]["client"] == "stream"
    assert "error" in chunk_dumps[0]["context"]
    if len(chunk_dumps) > 1:
        assert any(e["ev"] == "fetch.attempt"
                   for e in chunk_dumps[-1]["events"])
    assert dumps[-1]["reason"] == PLAN_EXHAUSTED
    FLIGHT.clear()


# ---------------------------------------------------------------------------
# a client request's trace
# ---------------------------------------------------------------------------

def _close(a, b):
    return abs(a - b) <= max(5e-4, 0.02 * max(abs(a), abs(b)))


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["monolithic", "streamed"])
def test_infer_result_carries_trace_id(world, overlap):
    """``infer`` returns the trace id; the client's tracer resolves it to
    the tree whose projection is ``wall``, and its phases agree with
    ``timings`` within max(0.5 ms, 2%)."""
    cfg, engine, gen = world
    LEDGER.clear()                     # no learned baseline cuts the stream
    server = CacheServer(CacheConfig())
    EdgeClient("a", engine, server, CacheConfig()).infer(
        gen.prompt("virology", 0).segments, max_new_tokens=2)
    c = EdgeClient("t", engine, server, CacheConfig(), overlap=overlap)
    c.sync_catalog()
    for p, case in ((gen.prompt("virology", 1), 4),
                    (gen.prompt("anatomy", 5), 1)):
        res = c.infer(p.segments, max_new_tokens=3)
        assert res.case == case and res.streamed == (overlap and case == 4)
        assert res.trace_id
        spans = c.tracer.trace(res.trace_id)
        names = {d["name"] for d in spans}
        assert {"infer", "bloom", "p_decode", "r_decode"} <= names
        wall = Breakdown.from_spans(spans)
        assert wall == res.wall
        tm = res.timings
        for col, key in (("bloom", "bloom_s"), ("redis", "fetch_s"),
                         ("p_decode", "prefill_s"), ("r_decode", "decode_s")):
            assert _close(getattr(wall, col), tm[key]), (col, tm)
        roots = [d for d in spans if not d["parent"]]
        assert len(roots) == 1 and roots[0]["name"] == "infer"
        assert ("redis.attempt" in names) == (case == 4)


def test_traced_request_tree_reaches_the_daemon(world):
    """A port client on a port peer over TCP: one tree from ``infer``
    through the attempt and ``net.get`` to the daemon's folded
    ``peer.get``."""
    cfg, engine, gen = world
    peer = CachePeer("p0")
    srv = serve_peer_tcp(peer)
    try:
        d = PeerDirectory([TCPPeerLink("p0", "127.0.0.1", srv.port,
                                       timeout=10.0)], clock=WallClock())
        a = EdgeClient("a", engine, d, CacheConfig())
        p = gen.prompt("astronomy", 0).segments
        a.infer(p, max_new_tokens=2)
        d.last_sync_t = -1e18
        a.sync_catalog()
        r = a.infer(p, max_new_tokens=2)
    finally:
        srv.close()
    assert r.case == 5
    spans = a.tracer.trace(r.trace_id)
    by = {s["name"]: s for s in spans}
    assert by["net.get"]["parent"] == by["redis.attempt"]["span"]
    assert by["peer.get"]["parent"] == by["net.get"]["span"]
    assert by["peer.get"]["proc"] == "peer:p0"
    assert span_tree(spans)["name"] == "infer"


# ---------------------------------------------------------------------------
# the import graph: no torch where the daemons import
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", [
    "repro_torch.obs", "repro_torch.obs.console", "repro_torch.chaos",
    "repro_torch.clock",
    "repro_torch.core.net.daemon", "repro_torch.core.net.supervisor"])
def test_daemon_side_modules_import_without_torch(module):
    code = ("import importlib, sys;"
            f"importlib.import_module({module!r});"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'numpy', 'jax', 'repro'));"
            "sys.exit(f'leaked: {bad}' if bad else 0)")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr + proc.stdout
