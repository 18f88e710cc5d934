"""The port's HTTP front door, held against the reference's.

Mirrors ``tests/test_gateway.py`` test by test on the port's ``Gateway``
over reduced gemma3-270m (the reference's ``tiny_setup`` weights carried
across by ``params.from_jax_params``, fp32, on the CPU): OpenAI shapes,
SSE framing, 400s, routing and introspection, keep-alive, ``Connection:
close``, the 429s and the 503, tenant headers, admission units,
``FetchPolicy`` validation, the streamed-policy refusal, ``Fabric.sim``
≡ ``.local`` ≡ ``.tcp``, and the per-tenant ``ServingReport``.

Token identity is held against the reference's ``Gateway``: the same
HTTP bodies go to both packages' gateways, and the port's tokens must
equal the reference's and a direct run of the port's scheduler. Two
gateways, one of each package, also share one cache store both ways.

The trace-tree test (``test_gateway_trace_spans_client_and_remote_daemon``:
one tree from the HTTP front door through the engine thread to a peer
daemon, ``cache.trace_id``, the ``/v1/traces``, ``/v1/decisions`` and
``/v1/flight`` routes) and the keep-alive test's ``follows`` link between
root spans are mirrored too. Left out, with the code it tests:
``test_deprecated_constructors_still_work_and_warn`` (the deprecated
``SessionPool(server, engine)`` spelling is not ported).
"""
import http.client
import json
import time

import jax
import numpy as np
import pytest

from repro.core import Fabric as JaxFabric
from repro.core.transport import InProcTransport as JaxTransport
from repro.core.netsim import SimClock as JaxSimClock
from repro.core.netsim import SimNetwork as JaxSimNetwork
from repro.gateway import Gateway as JaxGateway
from repro_torch.config import CacheConfig
from repro_torch.configs import get_config
from repro_torch.core.client import EdgeClient
from repro_torch.core.fabric import Fabric
from repro_torch.core.fetch_policy import FetchPolicy
from repro_torch.core.metrics import RequestStats, ServingReport
from repro_torch.core.netsim import SimClock, SimNetwork
from repro_torch.core.server import CacheServer
from repro_torch.core.session_pool import SessionPool
from repro_torch.core.transport import InProcTransport
from repro_torch.data.mmlu import MMLUGenerator
from repro_torch.data.tokenizer import WordHashTokenizer
from repro_torch.gateway import Gateway, GatewayEngine, TenantQuota
from repro_torch.gateway import protocol
from repro_torch.gateway.admission import AdmissionController, ShedError
from repro_torch.models.model import Model
from repro_torch.params import from_jax_params
from repro_torch.serving.engine import BatchedEngine, InferenceEngine
from repro_torch.serving.scheduler import Request, Scheduler

MAX_LEN = 128


# ---------------------------------------------------------------------------
# HTTP helpers (stdlib only)
# ---------------------------------------------------------------------------

def _conn(gw):
    return http.client.HTTPConnection("127.0.0.1", gw.port, timeout=60)


def _post(gw, path, body, headers=None):
    c = _conn(gw)
    raw = json.dumps(body) if isinstance(body, dict) else body
    c.request("POST", path, raw,
              {"Content-Type": "application/json", **(headers or {})})
    r = c.getresponse()
    data = r.read()
    c.close()
    return r, data


def _get(gw, path):
    c = _conn(gw)
    c.request("GET", path)
    r = c.getresponse()
    data = r.read()
    c.close()
    return r, data


def _sse_tokens(data):
    events = [e for e in data.split(b"\n\n") if e]
    return [c["choices"][0]["token_id"]
            for c in (json.loads(e[6:]) for e in events[:-1])
            if "token_id" in c["choices"][0]]


class _StreamReq:
    """A streaming request held open: admitted once its first SSE token
    arrives, released when drained."""

    def __init__(self, gw, body, path="/v1/completions"):
        self.conn = _conn(gw)
        self.conn.request("POST", path, json.dumps(body),
                          {"Content-Type": "application/json"})
        self.resp = self.conn.getresponse()

    def wait_first_token(self, timeout_s=30.0):
        assert self.resp.status == 200
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            line = self.resp.readline()
            if line.startswith(b"data: ") and b"token_id" in line:
                return
        raise AssertionError("no SSE token before timeout")

    def drain(self):
        self.resp.read()
        self.conn.close()


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_model(tiny_setup):
    cfg, _, jp = tiny_setup
    m = Model(get_config("gemma3-270m").reduced(), device="cpu")
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)))
    return m


QUOTAS = {"limited": TenantQuota(max_concurrent=8, rate_per_s=0.001,
                                 burst=1),
          "narrow": TenantQuota(max_concurrent=1)}


@pytest.fixture(scope="module")
def gw(port_model):
    g = Gateway(port_model, fabric=Fabric.local(), batch_size=2,
                max_len=MAX_LEN, quotas=QUOTAS,
                model_name="test-model").start()
    yield g
    g.stop()


@pytest.fixture(scope="module")
def ref_gw(tiny_setup):
    """The reference's gateway on the same weights: the token oracle."""
    cfg, model, params = tiny_setup
    g = JaxGateway(model, params, fabric=JaxFabric.local(), batch_size=2,
                   max_len=MAX_LEN, model_name="test-model").start()
    yield g
    g.stop()


@pytest.fixture(scope="module")
def tok(tiny_setup):
    return WordHashTokenizer(tiny_setup[0].vocab)


def _direct_tokens(model, tok, prompt_or_messages, max_new):
    """The port's scheduler on the same tokenization, no cache."""
    if isinstance(prompt_or_messages, str):
        segs = protocol.tokenize_prompt(tok, prompt_or_messages)
    else:
        segs = protocol.tokenize_messages(tok, prompt_or_messages)
    sched = Scheduler(BatchedEngine(model, MAX_LEN, 1))
    req = Request(tokens=np.asarray(segs.token_ids, np.int32),
                  max_new_tokens=max_new)
    sched.run([req])
    return req.stats.output_tokens


# ---------------------------------------------------------------------------
# OpenAI wire behaviour and token identity
# ---------------------------------------------------------------------------

def test_completion_token_identity(gw, ref_gw, port_model, tok):
    prompt = "compare the two routing strategies in detail"
    body = {"prompt": prompt, "max_tokens": 6, "model": "m"}
    r, data = _post(gw, "/v1/completions", body)
    assert r.status == 200
    got = json.loads(data)
    assert got["object"] == "text_completion"
    assert got["usage"]["completion_tokens"] == 6
    assert got["choices"][0]["finish_reason"] == "length"
    assert got["choices"][0]["token_ids"] == \
        list(_direct_tokens(port_model, tok, prompt, 6))
    r, data = _post(ref_gw, "/v1/completions", body)
    want = json.loads(data)
    assert got["choices"][0]["token_ids"] == want["choices"][0]["token_ids"]
    assert got["choices"][0]["text"] == want["choices"][0]["text"]
    assert got["usage"] == want["usage"]


def test_chat_token_identity_and_cache_hit(gw, ref_gw, port_model, tok):
    msgs = [{"role": "system", "content": "terse assistant"},
            {"role": "user", "content": "name a planet"}]
    body = {"messages": msgs, "max_tokens": 5}
    r1, d1 = _post(gw, "/v1/chat/completions", body)
    assert r1.status == 200
    first = json.loads(d1)
    assert first["object"] == "chat.completion"
    assert first["cache"]["matched_tokens"] == 0
    gw.engine.fetcher.flush_uploads()
    r2, d2 = _post(gw, "/v1/chat/completions", body)
    second = json.loads(d2)
    # the second run resumes from the uploaded prefix, tokens identical
    assert second["cache"]["matched_tokens"] > 0
    assert second["choices"][0]["token_ids"] == \
        first["choices"][0]["token_ids"]
    expect = _direct_tokens(port_model, tok,
                            [(m["role"], m["content"]) for m in msgs], 5)
    assert first["choices"][0]["token_ids"] == list(expect)
    _, dr = _post(ref_gw, "/v1/chat/completions", body)
    assert json.loads(dr)["choices"][0]["token_ids"] == list(expect)


def test_sse_chunk_framing(gw, ref_gw, port_model, tok):
    body = {"messages": [{"role": "user", "content": "stream me a song"}],
            "max_tokens": 4, "stream": True}
    r, data = _post(gw, "/v1/chat/completions", body)
    assert r.status == 200
    assert r.getheader("Content-Type") == "text/event-stream"
    events = [e for e in data.split(b"\n\n") if e]
    assert all(e.startswith(b"data: ") for e in events)
    assert events[-1] == b"data: [DONE]"
    chunks = [json.loads(e[6:]) for e in events[:-1]]
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    finishes = [c["choices"][0]["finish_reason"] for c in chunks
                if c["choices"][0]["finish_reason"]]
    assert finishes == ["length"]          # exactly one terminal chunk
    assert chunks[-1]["choices"][0]["delta"] == {}
    expect = _direct_tokens(port_model, tok,
                            [("user", "stream me a song")], 4)
    assert _sse_tokens(data) == list(expect)
    _, dr = _post(ref_gw, "/v1/chat/completions", body)
    assert _sse_tokens(dr) == list(expect)


def test_malformed_requests_get_400(gw):
    cases = [
        b"{not json",
        {"max_tokens": 4},                              # no prompt
        {"prompt": ""},                                 # empty prompt
        {"prompt": 42},                                 # wrong type
        {"prompt": "x", "max_tokens": 0},
        {"prompt": "x", "max_tokens": True},
        {"prompt": "x", "max_tokens": 10_000},          # over the cap
        {"prompt": "x", "temperature": 0.7},            # not greedy
        {"prompt": "x", "stream": "yes"},
        {"prompt": "x", "user": 3},
        {"prompt": "word " * 500},                      # over max_len
    ]
    for body in cases:
        r, data = _post(gw, "/v1/completions", body)
        assert r.status == 400, body
        assert "message" in json.loads(data)["error"]
    chat_cases = [
        {"messages": []},
        {"messages": "hi"},
        {"messages": [{"role": "robot", "content": "x"}]},
        {"messages": [{"role": "user", "content": ""}]},
        {"messages": [{"role": "user"}]},
    ]
    for body in chat_cases:
        r, _ = _post(gw, "/v1/chat/completions", body)
        assert r.status == 400, body


def test_routing_and_introspection(gw):
    r, _ = _get(gw, "/no/such/route")
    assert r.status == 404
    r, _ = _get(gw, "/v1/completions")                  # wrong method
    assert r.status == 405 and r.getheader("Allow") == "POST"
    r, data = _get(gw, "/healthz")
    health = json.loads(data)
    assert r.status == 200 and health["ok"] and health["slots"] == 2
    r, data = _get(gw, "/v1/models")
    assert json.loads(data)["data"][0]["id"] == "test-model"
    r, data = _get(gw, "/metrics.json")
    metrics = json.loads(data)
    assert "report" in metrics and "admission" in metrics
    assert metrics["admission"]["max_inflight"] == 2
    r, data = _get(gw, "/metrics")
    assert r.status == 200
    assert r.getheader("Content-Type").startswith("text/plain")
    text = data.decode()
    assert "# TYPE gateway_http_requests_total counter" in text
    assert "gateway_ttft_seconds_bucket" in text


def test_keepalive_pipelines_sequential_requests(gw):
    """Two unary requests down one socket: the server answers both
    (``Connection: keep-alive``), counts the reuse, and links the second
    request's root span to the first by its ``follows`` attribute."""
    before = gw.server.stats["keepalive_reuses"]
    c = _conn(gw)
    try:
        tids = []
        for i in range(2):
            c.request("POST", "/v1/completions",
                      json.dumps({"prompt": f"keepalive req {i}",
                                  "max_tokens": 2}),
                      {"Content-Type": "application/json"})
            r = c.getresponse()
            assert r.status == 200
            assert r.getheader("Connection") == "keep-alive"
            body = json.loads(r.read())
            assert len(body["choices"][0]["token_ids"]) == 2
            tids.append(body["cache"]["trace_id"])
    finally:
        c.close()
    assert gw.server.stats["keepalive_reuses"] >= before + 1

    def _root(tid):
        # the root span ends just after the response is flushed
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            for s in (gw.tracer.trace(tid) or []):
                if s["name"] == "gw.request":
                    return s
            time.sleep(0.01)
        raise AssertionError(f"gw.request root never recorded for {tid}")

    roots = [_root(t) for t in tids]
    assert roots[0]["attrs"]["conn"] == roots[1]["attrs"]["conn"]
    assert roots[0]["attrs"]["seq"] == 0 and roots[1]["attrs"]["seq"] == 1
    assert roots[1]["attrs"]["follows"] == roots[0]["span"]
    assert "follows" not in roots[0]["attrs"]


def test_connection_close_honoured(gw):
    c = _conn(gw)
    try:
        c.request("GET", "/healthz", headers={"Connection": "close"})
        r = c.getresponse()
        assert r.status == 200
        assert r.getheader("Connection") == "close"
        r.read()
    finally:
        c.close()


# ---------------------------------------------------------------------------
# quotas and load shedding
# ---------------------------------------------------------------------------

def test_rate_quota_sheds_429(gw):
    body = {"prompt": "rate limited tenant", "max_tokens": 2,
            "user": "limited"}                # burst 1, ~no refill
    r1, _ = _post(gw, "/v1/completions", body)
    assert r1.status == 200
    r2, data = _post(gw, "/v1/completions", body)
    assert r2.status == 429
    assert int(r2.getheader("Retry-After")) >= 1
    assert json.loads(data)["error"]["type"] == "rate_limit_exceeded"


def test_tenant_concurrency_sheds_429(gw):
    hold = _StreamReq(gw, {"prompt": "hold this slot open for a while",
                           "max_tokens": 100, "stream": True,
                           "user": "narrow"})
    try:
        hold.wait_first_token()
        r, _ = _post(gw, "/v1/completions",
                     {"prompt": "second concurrent", "max_tokens": 2,
                      "user": "narrow"})
        assert r.status == 429
        assert r.getheader("Retry-After") is not None
    finally:
        hold.drain()


def test_capacity_sheds_503_under_slot_exhaustion(port_model):
    """One slot, no queue: a held stream exhausts the gateway and the next
    request is refused with 503 and Retry-After, not queued."""
    g = Gateway(port_model, fabric=None, batch_size=1, max_len=MAX_LEN,
                max_inflight=1, queue_depth=0).start()
    try:
        hold = _StreamReq(g, {"prompt": "exhaust the only slot",
                              "max_tokens": 100, "stream": True})
        hold.wait_first_token()
        r, data = _post(g, "/v1/completions",
                        {"prompt": "overflow", "max_tokens": 2})
        assert r.status == 503
        assert r.getheader("Retry-After") is not None
        assert json.loads(data)["error"]["type"] == "overloaded"
        hold.drain()
        # capacity freed: the same request is admitted now
        r, _ = _post(g, "/v1/completions",
                     {"prompt": "overflow", "max_tokens": 2})
        assert r.status == 200
    finally:
        g.stop()


def test_x_tenant_header_overrides_body_user(gw):
    r, _ = _post(gw, "/v1/completions",
                 {"prompt": "who am i", "max_tokens": 2, "user": "body"},
                 headers={"X-Tenant": "header"})
    assert r.status == 200
    assert "header" in gw.admission.snapshot()["tenants"]


def test_admission_controller_units():
    adm = AdmissionController(max_inflight=2, queue_depth=0,
                              default_quota=TenantQuota(
                                  max_concurrent=1, rate_per_s=1.0,
                                  burst=2))
    adm.admit("a")
    with pytest.raises(ShedError) as ei:
        adm.admit("a")                       # concurrency before rate
    assert ei.value.status == 429
    adm.admit("b")
    with pytest.raises(ShedError) as ei:
        adm.admit("c")                       # global capacity
    assert ei.value.status == 503
    adm.release("a", latency_s=0.2)
    adm.admit("c")
    assert adm.shed_counts() == {"a": 1, "c": 1}
    with pytest.raises(ValueError):
        TenantQuota(max_concurrent=0)


# ---------------------------------------------------------------------------
# FetchPolicy
# ---------------------------------------------------------------------------

def test_fetch_policy_validation():
    with pytest.raises(ValueError):
        FetchPolicy(transfer="warp")
    with pytest.raises(ValueError):
        FetchPolicy(transfer="blocking", overlap=True)
    with pytest.raises(ValueError):
        FetchPolicy(transfer="streamed", overlap=False)
    with pytest.raises(ValueError):
        FetchPolicy(min_match_tokens=-1)
    p = FetchPolicy()                        # the defaults are coherent
    assert p.transfer == "auto" and p.use_catalog


def test_edge_client_rejects_policy_plus_legacy_flags(port_model):
    engine = InferenceEngine(port_model, max_len=MAX_LEN)
    tr = InProcTransport(CacheServer(CacheConfig()), SimNetwork(),
                         SimClock())
    with pytest.raises(ValueError, match="not both"):
        EdgeClient("dup", engine, tr, CacheConfig(),
                   policy=FetchPolicy(), overlap=True)


def test_gateway_engine_rejects_streamed_policy(port_model):
    with pytest.raises(ValueError, match="blocking"):
        GatewayEngine(port_model,
                      policy=FetchPolicy(transfer="streamed", overlap=True))


# ---------------------------------------------------------------------------
# the Fabric facade: the backends give the same tokens
# ---------------------------------------------------------------------------

def _pool_tokens(fabric, engine, gen, n=3):
    pool = SessionPool(engine=engine, fabric=fabric, n_sessions=2,
                       cache_cfg=CacheConfig())
    jobs = [gen.prompt("astronomy", q).segments for q in range(n)]
    return [r.output_tokens for r in pool.run(jobs, max_new_tokens=4)]


def test_fabric_equivalence_sim_vs_local(port_model, tok):
    engine = InferenceEngine(port_model, max_len=512)
    gen = MMLUGenerator(tok, n_shot=2)
    assert _pool_tokens(Fabric.local(), engine, gen) == \
        _pool_tokens(Fabric.sim(n_peers=2), engine, gen)


def test_gateway_trace_spans_client_and_remote_daemon(port_model):
    """A request id resolves through ``GET /v1/traces/<id>`` to one tree
    that crosses processes: the gateway's request, resolve and slot
    spans and the spans a peer daemon folded back (its pid with them).
    ``/v1/decisions`` and ``/v1/flight`` serve the ledger and the
    recorder."""
    with Fabric.tcp(n_peers=2) as fabric:
        g = Gateway(port_model, fabric=fabric, batch_size=2,
                    max_len=MAX_LEN).start()
        try:
            body = {"prompt": "trace me across the fleet", "max_tokens": 3}
            r1, d1 = _post(g, "/v1/completions", body)
            assert r1.status == 200
            assert json.loads(d1)["cache"]["trace_id"]
            g.engine.fetcher.flush_uploads()
            # until the uploaded prefix is in the synced catalog and a
            # daemon serves the hit
            deadline = time.monotonic() + 60
            second = None
            while time.monotonic() < deadline:
                _, d2 = _post(g, "/v1/completions", body)
                second = json.loads(d2)
                if second["cache"]["matched_tokens"] > 0:
                    break
                time.sleep(0.3)
            assert second["cache"]["matched_tokens"] > 0
            rid = second["id"]
            assert second["cache"]["trace_id"]
            deadline = time.monotonic() + 5.0       # the root ends last
            while time.monotonic() < deadline:
                r, data = _get(g, f"/v1/traces/{rid}")
                doc = json.loads(data)
                if any(s["name"] == "gw.request" for s in doc["spans"]):
                    break
                time.sleep(0.01)
            assert r.status == 200
            assert doc["trace_id"] == second["cache"]["trace_id"]
            spans = doc["spans"]
            names = {d["name"] for d in spans}
            assert {"gw.request", "gw.parse", "gw.admission", "gw.resolve",
                    "net.get", "slot.queue_wait", "slot.prefill",
                    "slot.decode"} <= names
            remote = [d for d in spans if str(d["proc"]).startswith("peer:")]
            assert remote and all(d["attrs"].get("remote") for d in remote)
            assert any(d["attrs"].get("pid") for d in remote)
            roots = [d for d in spans if not d["parent"]]
            assert len(roots) == 1 and roots[0]["name"] == "gw.request"
            assert doc["tree"]["name"] == "gw.request"
            r, _ = _get(g, "/v1/traces/nope")
            assert r.status == 404
            r, data = _get(g, f"/v1/decisions/{rid}")
            rec = json.loads(data)
            assert r.status == 200 and rec["client"] == "gateway"
            assert rec["outcome"]["result"] in ("hit", "partial")
            assert rec["attempts"][-1]["result"] == "hit"
            assert rec["outcome"]["baseline_s"] is not None   # learned
            r, data = _get(g, "/v1/decisions")
            assert json.loads(data)["totals"]["commits"] >= 2
            r, _ = _get(g, "/v1/decisions/nope")
            assert r.status == 404
            r, data = _get(g, "/v1/flight")
            assert r.status == 200 and "snapshot" in json.loads(data)
            r, data = _get(g, "/metrics.json")
            assert "peer0" in json.loads(data)["calibration"] or \
                "peer1" in json.loads(data)["calibration"]
        finally:
            g.stop()


def test_fabric_equivalence_tcp(port_model, tok):
    engine = InferenceEngine(port_model, max_len=512)
    gen = MMLUGenerator(tok, n_shot=2)
    toks_local = _pool_tokens(Fabric.local(), engine, gen)
    with Fabric.tcp(n_peers=2) as fabric:
        toks_tcp = _pool_tokens(fabric, engine, gen)
        assert all(v is None for v in fabric.supervisor.exit_codes().values())
    assert toks_tcp == toks_local
    assert all(v == 0 for v in fabric.supervisor.exit_codes().values())


# ---------------------------------------------------------------------------
# one store, a gateway of each package
# ---------------------------------------------------------------------------

class _OneBox:
    """A reference fabric view over a store the port owns: each
    ``directory()`` is a reference ``InProcTransport`` on that store."""

    def __init__(self, server):
        self.server = server

    def directory(self):
        return JaxTransport(self.server, JaxSimNetwork(), JaxSimClock())


def test_gateways_share_one_store_both_ways(tiny_setup, port_model):
    """A port gateway's uploads give a reference gateway a hit with the
    cold tokens, and the other way round, over one cache store."""
    cfg, model, params = tiny_setup
    store = CacheServer(CacheConfig())
    port = Gateway(port_model, fabric=Fabric.local(server=store),
                   batch_size=2, max_len=MAX_LEN).start()
    ref = JaxGateway(model, params, fabric=_OneBox(store), batch_size=2,
                     max_len=MAX_LEN).start()
    try:
        for writer, reader, word in ((port, ref, "port"),
                                     (ref, port, "reference")):
            body = {"messages": [
                {"role": "system", "content": f"{word} wrote this prefix"},
                {"role": "user", "content": "which package reads it"}],
                "max_tokens": 5}
            _, d_cold = _post(writer, "/v1/chat/completions", body)
            cold = json.loads(d_cold)
            assert cold["cache"]["matched_tokens"] == 0
            writer.engine.fetcher.flush_uploads()
            # the reader's catalog syncs at its next request (syncs are
            # rate-limited on its link's sim clock, which GETs advance)
            reader.engine.fetcher.catalog.last_sync_t = -1e18
            _, d_warm = _post(reader, "/v1/chat/completions", body)
            warm = json.loads(d_warm)
            assert warm["cache"]["matched_tokens"] == \
                cold["usage"]["prompt_tokens"]          # a full hit
            assert warm["choices"][0]["token_ids"] == \
                cold["choices"][0]["token_ids"]
    finally:
        ref.stop()
        port.stop()


# ---------------------------------------------------------------------------
# ServingReport: per-tenant slices and shed counts
# ---------------------------------------------------------------------------

def _stats(rid, tenant, ttft=0.1, lat=0.5, n_out=4):
    return RequestStats(req_id=rid, prompt_tokens=8,
                        output_tokens=list(range(n_out)), submit_t=1.0,
                        admit_t=1.0, first_token_t=1.0 + ttft,
                        finish_t=1.0 + lat, finish_reason="length",
                        tenant=tenant)


def test_serving_report_per_tenant_and_shed():
    reqs = [_stats(0, "a", ttft=0.1), _stats(1, "a", ttft=0.3),
            _stats(2, "b", ttft=0.2)]
    rep = ServingReport.from_requests(reqs, wall_s=2.0,
                                      shed={"a": 1, "c": 2})
    assert rep.shed_requests == 3
    assert set(rep.per_tenant) == {"a", "b", "c"}
    assert rep.per_tenant["a"].n_requests == 2
    assert rep.per_tenant["a"].shed == 1
    assert rep.per_tenant["c"].n_requests == 0   # a shed-only tenant
    d = rep.as_dict()
    assert d["per_tenant"]["b"]["ttft_p50"] == pytest.approx(0.2)


def test_serving_report_untagged_round_trips_unchanged():
    """Runs with no tenants and no shedding keep the old shape."""
    reqs = [_stats(0, ""), _stats(1, "")]
    rep = ServingReport.from_requests(reqs, wall_s=1.0)
    assert rep.per_tenant == {} and rep.shed_requests == 0
    d = rep.as_dict()
    assert d["n_requests"] == 2 and d["per_tenant"] == {}
