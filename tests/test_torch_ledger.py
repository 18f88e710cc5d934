"""The port's decision ledger and estimator calibration, held against the
reference's.

Mirrors ``tests/test_ledger.py``: the regret arithmetic, the learned
wall-clock baseline, the bounded store, the drift alarm with hysteresis,
the Bloom false-positive probe, and over the port's simulated fabric the
planner opening records that the client commits, the broker's dedup
linking two records, and the stale-catalog counter. The same sequences
of observations go through the reference's ``DecisionLedger`` and
``CalibrationTracker``: regret, savings and the learned baseline agree
within 1e-9. Two repairs are held here against the reference too: the
hedge delay learns the peer's p95 actual/estimate ratio (equal within
1e-12 after the same ``record_get`` / ``record_chunk`` observations),
and without a perf model the stream watchdog cuts a stream projected
past the ledger's learned local baseline, as the reference's does.
"""
import time

import jax
import numpy as np
import pytest

from repro.config import CacheConfig as JaxCacheConfig
from repro.configs import get_config as jax_get_config
from repro.core.bloom import BloomFilter as JaxBloom
from repro.core.client import EdgeClient as JaxEdgeClient
from repro.core.cluster.directory import PeerDirectory as JaxDirectory
from repro.core.cluster.peer import CachePeer as JaxPeer
from repro.core.netsim import SimClock as JaxSimClock
from repro.core.netsim import SimNetwork as JaxSimNetwork
from repro.core.netsim import WallClock as JaxWallClock
from repro.core.segments import PromptSegments as JaxSegments
from repro.core.server import CacheServer as JaxServer
from repro.core.transport import InProcTransport as JaxTransport
from repro.core.transport import StreamCancelled as JaxStreamCancelled
from repro.models import Model as JaxModel
from repro.obs.calibrate import CalibrationTracker as JaxCalibration
from repro.obs.calibrate import catalog_fp_probe as jax_fp_probe
from repro.obs.flight import FLIGHT as JAX_FLIGHT
from repro.obs.flight import FlightRecorder as JaxFlightRecorder
from repro.obs.ledger import LEDGER as JAX_LEDGER
from repro.obs.ledger import DecisionLedger as JaxLedger
from repro.obs.metrics import MetricsRegistry as JaxRegistry
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.config import CacheConfig
from repro_torch.configs import get_config
from repro_torch.core.bloom import BloomFilter
from repro_torch.core.client import EdgeClient
from repro_torch.core.cluster import CacheCluster
from repro_torch.core.cluster.directory import PeerDirectory
from repro_torch.core.cluster.peer import CachePeer
from repro_torch.core.netsim import SimClock, WallClock
from repro_torch.core.perfmodel import PI_ZERO_2W
from repro_torch.core.segments import PromptSegments
from repro_torch.core.server import CacheServer
from repro_torch.core.session_pool import FetchBroker
from repro_torch.core.sizing import stream_chunk_count
from repro_torch.core.transport import StreamCancelled
from repro_torch.data.mmlu import MMLUGenerator
from repro_torch.data.tokenizer import WordHashTokenizer
from repro_torch.models.model import Model
from repro_torch.obs import calibrate as calibrate_mod
from repro_torch.obs import ledger as ledger_mod
from repro_torch.obs.calibrate import CalibrationTracker, catalog_fp_probe
from repro_torch.obs.flight import ESTIMATOR_DRIFT, FLIGHT, FlightRecorder
from repro_torch.obs.ledger import LEDGER, DecisionLedger
from repro_torch.obs.metrics import REGISTRY, MetricsRegistry
from repro_torch.params import from_jax_params
from repro_torch.serving.engine import InferenceEngine

HET_LINKS = [(30e6, 0.002), (21e6, 0.003), (8e6, 0.008)]
TOL = 1e-9


# ---------------------------------------------------------------------------
# regret arithmetic, against the reference on the same observations
# ---------------------------------------------------------------------------

def _clean_win(led):
    rec = led.open(client="c", prompt_tokens=100, trace_id="tr-1",
                   candidates=[{"peer": "p0", "range_tokens": 100,
                                "est_fetch_s": 0.05, "est_total_s": 0.05,
                                "ring_rank": 0, "pruned": False}],
                   local_est_s=0.5)
    led.note_attempt(rec, peer="p0", range_tokens=100, result="hit",
                     est_fetch_s=0.05, actual_s=0.07)
    led.commit(rec, chosen="p0", result="hit", fetch_s=0.07)
    return rec


def _fallthroughs(led):
    rec = led.open(client="c", prompt_tokens=10, candidates=[],
                   local_est_s=0.2)
    led.note_attempt(rec, peer="p0", range_tokens=10, result="miss",
                     est_fetch_s=0.01, actual_s=0.05)
    led.note_attempt(rec, peer="p1", range_tokens=10, result="dead",
                     est_fetch_s=0.01, actual_s=0.03)
    led.note_attempt(rec, peer="p2", range_tokens=10, result="corrupt",
                     est_fetch_s=0.01, actual_s=0.004)
    led.commit(rec, chosen=None, result="local", local_prefill_s=0.2)
    return rec


def _learned(led):
    led.note_prefill(100, 0.5)                 # 5 ms a token
    led.note_prefill(100, 1.0)                 # the EWMA folds toward 10
    led.note_prefill(0, 3.0)                   # ignored
    led.note_prefill(37, 0.21)
    rec = led.open(client="c", prompt_tokens=100, candidates=[])
    led.commit(rec, chosen="p0", result="partial", fetch_s=0.1,
               suffix_s=0.03)
    return rec


@pytest.mark.parametrize("seq", [_clean_win, _fallthroughs, _learned],
                         ids=["clean_win", "fallthroughs", "learned"])
def test_regret_and_savings_equal_the_reference(seq):
    led, jled = DecisionLedger(), JaxLedger()
    mine, ref = seq(led), seq(jled)
    assert _close_dicts(mine["outcome"], ref["outcome"], skip=("t_close",))
    assert mine["attempts"] == ref["attempts"]
    assert mine["candidates"] == ref["candidates"]
    assert _close_dicts(led.totals(), jled.totals())


def _close_dicts(a, b, skip=()):
    """Equal keys; floats within TOL, anything else equal."""
    assert set(a) == set(b)
    for k, v in a.items():
        if k in skip:
            continue
        if isinstance(v, float) and isinstance(b[k], float):
            assert v == pytest.approx(b[k], rel=0, abs=TOL), k
        else:
            assert v == b[k], k
    return True


def test_regret_zero_when_plan_wins_cleanly():
    led = DecisionLedger()
    rec = _clean_win(led)
    oc = rec["outcome"]
    assert oc["realized_total_s"] == pytest.approx(0.07)
    assert oc["best_hindsight_s"] == pytest.approx(0.07)
    assert oc["regret_s"] == pytest.approx(0.0)
    assert oc["savings_vs_local_s"] == pytest.approx(0.43)
    assert led.get("tr-1") is rec and led.get(rec["id"]) is rec
    assert led.totals()["commits"] == 1 and led.totals()["wins"] == 1
    # a second close cannot rewrite the outcome
    led.commit(rec, chosen=None, result="local", local_prefill_s=9.0)
    assert rec["outcome"]["result"] == "hit"
    assert led.totals()["commits"] == 1


def test_regret_equals_wasted_fallthrough_time():
    led = DecisionLedger()
    oc = _fallthroughs(led)["outcome"]
    # wasted attempts + the local prefill; going local at once was best
    assert oc["realized_total_s"] == pytest.approx(0.284)
    assert oc["best_hindsight_s"] == pytest.approx(0.2)
    assert oc["regret_s"] == pytest.approx(0.084)
    assert oc["savings_vs_local_s"] == pytest.approx(-0.084)
    assert oc["fallthroughs"] == {"miss": 1, "dead": 1, "corrupt": 1}
    t = led.totals()
    assert (t["fallthrough_miss"], t["fallthrough_dead"],
            t["fallthrough_corrupt"]) == (1, 1, 1)
    assert t["locals"] == 1 and t["wins"] == 0


def test_learned_wall_clock_baseline():
    led, ref = DecisionLedger(), JaxLedger()
    assert led.baseline_s(100) is None
    for n, s in ((100, 0.5), (100, 1.0), (250, 0.9), (3, 0.0001)):
        led.note_prefill(n, s)
        ref.note_prefill(n, s)
        for m in (1, 100, 291):
            assert led.baseline_s(m) == pytest.approx(ref.baseline_s(m),
                                                      rel=0, abs=TOL)
    assert led.totals()["prefill_s_per_tok"] == pytest.approx(
        ref.totals()["prefill_s_per_tok"], rel=0, abs=TOL)
    led2 = DecisionLedger()
    led2.note_prefill(100, 0.5)
    assert led2.baseline_s(200) == pytest.approx(1.0)
    led2.note_prefill(100, 1.0)
    assert led2.baseline_s(100) == pytest.approx(0.65)
    oc = _learned(DecisionLedger())["outcome"]
    assert oc["baseline_s"] == pytest.approx(
        _learned(JaxLedger())["outcome"]["baseline_s"], rel=0, abs=TOL)


def test_ledger_bounded_fifo_with_aliases(monkeypatch):
    monkeypatch.setattr(ledger_mod, "MAX_RECORDS", 2)
    led = DecisionLedger()
    r0 = led.open(client="c", trace_id="t0")
    led.alias("cmpl-0", r0["id"])
    led.open(client="c", trace_id="t1")
    r2 = led.open(client="c", trace_id="t2")
    assert led.get(r0["id"]) is None           # FIFO evicted
    assert led.get("t0") is None and led.get("cmpl-0") is None
    assert led.get("t2") is r2
    assert len(led.records(10)) == 2
    # a commit's extra fields land in the outcome (the gateway's TTFT)
    led.commit(r2, chosen=None, result="local", local_prefill_s=0.1,
               ttft_s=0.123)
    assert r2["outcome"]["ttft_s"] == 0.123


# ---------------------------------------------------------------------------
# calibration: the drift alarm, hysteresis, the Bloom probe
# ---------------------------------------------------------------------------

DRIFT_SEQ = ([("p0", 0.0, 0.1)] + [("p0", 0.01, 0.5)] * 5
             + [("p1", 0.2, 0.21)] * 3 + [("p0", 0.5, 0.5)] * 20)


def _own_flight_and_registry(monkeypatch):
    """A tracker that triggers into a recorder and sets gauges in a
    registry of its own (not the process-wide ones)."""
    fr, reg = FlightRecorder(), MetricsRegistry()
    monkeypatch.setattr(calibrate_mod, "FLIGHT", fr)
    monkeypatch.setattr(calibrate_mod, "REGISTRY", reg)
    return fr, reg


def test_calibration_drift_alarm_and_hysteresis(monkeypatch):
    fr, reg = _own_flight_and_registry(monkeypatch)
    assert (calibrate_mod.BAND, calibrate_mod.MIN_OBS) == (0.5, 4)
    cal = CalibrationTracker()
    cal.observe("p0", est_s=0.0, actual_s=0.1)   # dropped: no estimate
    assert cal.snapshot() == {}

    def drifted():
        return sorted(p for p, v in cal.snapshot().items() if v["drift"])
    for _ in range(3):
        cal.observe("p0", est_s=0.01, actual_s=0.5)
    assert not drifted() and not fr.dumps()      # below min_obs
    cal.observe("p0", est_s=0.01, actual_s=0.5)
    assert drifted() == ["p0"]
    assert reg.snapshot()["repro_estimator_drift"]['{peer="p0"}'] == 1.0
    dumps = [d for d in fr.dumps() if d["reason"] == ESTIMATOR_DRIFT]
    assert len(dumps) == 1 and dumps[0]["context"]["peer"] == "p0"
    cal.observe("p0", est_s=0.01, actual_s=0.5)
    assert len(fr.dumps()) == 1                  # no flapping
    for _ in range(20):
        cal.observe("p0", est_s=0.5, actual_s=0.5)
    assert drifted() == []
    assert reg.snapshot()["repro_estimator_drift"]['{peer="p0"}'] == 0.0
    snap = cal.snapshot()["p0"]
    assert snap["drift_events"] == 1 and snap["n"] >= 25


def test_calibration_equals_the_reference(monkeypatch):
    _own_flight_and_registry(monkeypatch)
    cal = CalibrationTracker()
    ref = JaxCalibration(flight=JaxFlightRecorder(), registry=JaxRegistry())
    for pid, est, act in DRIFT_SEQ:
        cal.observe(pid, est, act, nbytes=1000)
        ref.observe(pid, est, act, nbytes=1000)
        assert cal.p95_ratio(pid) == ref.p95_ratio(pid)
    assert [p for p, v in cal.snapshot().items() if v["drift"]] == \
        ref.drifted()
    mine, theirs = cal.snapshot(), ref.snapshot()
    assert set(mine) == set(theirs)
    for pid in mine:
        for k, v in mine[pid].items():
            assert v == pytest.approx(theirs[pid][k], rel=0, abs=1e-12), k


def test_catalog_fp_probe_matches_bloom_analytics():
    bf, jbf = BloomFilter(capacity=128, fp_rate=0.05), \
        JaxBloom(capacity=128, fp_rate=0.05)
    for i in range(64):
        bf.add(bytes([i]) * 32)
        jbf.add(bytes([i]) * 32)
    probe = catalog_fp_probe(bf, gets=10, misses=1, tombstones=2)
    assert probe == jax_fp_probe(jbf, gets=10, misses=1, tombstones=2)
    assert probe["predicted"] == pytest.approx(bf.expected_fp_rate())
    assert 0.0 < probe["predicted"] < 1.0
    assert probe["realized"] == pytest.approx(0.1)
    assert probe["tombstones"] == 2
    empty = catalog_fp_probe(None, 0, 0)
    assert empty["predicted"] == 0.0 and empty["realized"] == 0.0


# ---------------------------------------------------------------------------
# the hedge delay learns the peer's ratio (a repair), as the reference's
# ---------------------------------------------------------------------------

class _Link:
    """A transport-like stand-in: the directories only read its id."""

    net = None

    def __init__(self, peer_id):
        self.peer_id = peer_id


def test_hedge_delay_equals_the_reference_after_the_same_observations():
    mine = PeerDirectory([_Link("pa"), _Link("pb")], clock=WallClock())
    ref = JaxDirectory([_Link("pa"), _Link("pb")], clock=JaxWallClock())
    obs = [("get", "pa", 0.004, 0.011, 200_000), ("chunk", "pa", 40_000,
                                                   0.006),
           ("get", "pa", 0.004, 0.009, 200_000), ("get", "pb", 0.01, 0.012,
                                                  500_000),
           ("chunk", "pa", 40_000, 0.03), ("chunk", "pa", 40_000, 0.002),
           ("get", "pa", 0.004, 0.05, 200_000), ("chunk", "pb", 9_000,
                                                 0.001)]

    def delays(d):
        return [d.hedge_delay_s(pid, est) for pid in ("pa", "pb")
                for est in (0.001, 0.02, 0.3)]

    for i, ob in enumerate(obs):
        for d in (mine, ref):
            if ob[0] == "get":
                d.record_get(ob[1], True, ob[2], ob[3], ob[4])
            else:
                d.record_chunk(ob[1], ob[2], ob[3])
        assert delays(mine) == pytest.approx(delays(ref), rel=0,
                                             abs=1e-12), i
    # the learned ratio differs from the fixed 1.5 once there are samples
    assert mine.hedge_delay_s("pa", 0.3) != pytest.approx(0.45)
    assert mine.calibration.p95_ratio("pa") == \
        ref.calibration.p95_ratio("pa")


# ---------------------------------------------------------------------------
# end to end over the port's simulated fabric
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_model(tiny_setup):
    cfg, _, jp = tiny_setup
    m = Model(get_config("gemma3-270m").reduced(), device="cpu")
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)))
    return m


@pytest.fixture()
def ledger_world(port_model):
    engine = InferenceEngine(port_model, max_len=512)
    ccfg = CacheConfig()
    cluster = CacheCluster(HET_LINKS, ccfg)

    def client(name, **kw):
        return EdgeClient(name, engine, cluster.directory(clock=SimClock()),
                          ccfg, perf=PI_ZERO_2W, **kw)
    return cluster, client


def _one_range_prompt(start: int, n: int) -> PromptSegments:
    tokens = list(range(start, start + n))
    return PromptSegments.make(tokens, [len(tokens)])


def test_planner_opens_and_client_commits(ledger_world):
    cluster, client = ledger_world
    seg = _one_range_prompt(3, 57)
    LEDGER.clear()
    r1 = client("seeder").infer(seg, max_new_tokens=2)
    assert r1.matched_tokens == 0
    rec = LEDGER.get(r1.trace_id)
    assert rec is not None and rec["client"] == "seeder"
    assert rec["outcome"]["result"] == "local"
    assert rec["outcome"]["regret_s"] == pytest.approx(0.0)
    # a perf model's baseline: nothing learned from the sim prefill
    assert LEDGER.baseline_s(57) is None

    cluster.gossip()
    c2 = client("fetcher")
    c2.sync_catalog()
    r2 = c2.infer(seg, max_new_tokens=2)
    assert r2.matched_tokens == 57
    rec = LEDGER.get(r2.trace_id)
    assert rec["client"] == "fetcher"
    assert rec["candidates"]
    assert {"peer", "range_tokens", "est_fetch_s", "est_total_s",
            "ring_rank", "pruned"} <= set(rec["candidates"][0])
    assert rec["attempts"] and rec["attempts"][0]["result"] == "hit"
    oc = rec["outcome"]
    assert oc["result"] == "hit" and oc["chosen"] == r2.served_by
    assert oc["fetch_s"] == pytest.approx(r2.actual_fetch_s)
    assert oc["fetch_s"] > 0.0 and oc["regret_s"] >= 0.0
    # sim seconds: the baseline is the perf model's local prefill
    assert rec["local_est_s"] == pytest.approx(
        PI_ZERO_2W.time_prefill(c2.engine.model.cfg, 57))
    assert oc["savings_vs_local_s"] == pytest.approx(
        rec["local_est_s"] - oc["realized_total_s"])
    t = LEDGER.totals()
    assert t["decisions"] == 2 and t["commits"] == 2
    assert t["wins"] == 1 and t["locals"] == 1


def test_records_equal_the_reference_on_the_same_requests(tiny_setup,
                                                          ledger_world):
    """The same two requests (a miss, then a hit from another client)
    through both packages' simulated fabrics: candidates, attempts,
    regret and savings agree within 1e-9. The reference runs untraced:
    its trace envelope would change its sim seconds."""
    from repro.core.cluster import CacheCluster as JaxCluster
    from repro.core.perfmodel import PI_ZERO_2W as JAX_PI
    from repro.obs.trace import Tracer as JaxTracer
    cfg, jm, jp = tiny_setup
    cluster, client = ledger_world
    seg = _one_range_prompt(5, 61)
    jcluster = JaxCluster(HET_LINKS, JaxCacheConfig())
    jengine = JaxEngine(jm, jp, max_len=512)

    def jclient(name):
        return JaxEdgeClient(name, jengine,
                             jcluster.directory(clock=JaxSimClock()),
                             JaxCacheConfig(), perf=JAX_PI,
                             tracer=JaxTracer(enabled=False))
    jseg = JaxSegments.make(list(seg.token_ids), list(seg.boundaries))
    recs = []
    for mk, cl, s in ((client, cluster, seg), (jclient, jcluster, jseg)):
        a = mk("A")
        a.infer(s, max_new_tokens=2)
        cl.gossip()
        b = mk("B")
        b.sync_catalog()
        b.infer(s, max_new_tokens=2)
        recs.append((a.planner.last_decision, b.planner.last_decision))
    for mine, ref in zip(*recs):
        assert len(mine["candidates"]) == len(ref["candidates"])
        for c, rc in zip(mine["candidates"], ref["candidates"]):
            assert _close_dicts(c, rc)
        assert [x["result"] for x in mine["attempts"]] == \
            [x["result"] for x in ref["attempts"]]
        for k in ("realized_total_s", "best_hindsight_s", "regret_s",
                  "savings_vs_local_s", "baseline_s", "fetch_s"):
            assert mine["outcome"][k] == pytest.approx(
                ref["outcome"][k], rel=TOL, abs=TOL), k


def test_broker_dedup_links_records(ledger_world):
    cluster, client = ledger_world
    seg = _one_range_prompt(7, 70)
    client("seeder").infer(seg, max_new_tokens=2)
    cluster.gossip()
    broker = FetchBroker()
    a = client("leader", broker=broker)
    b = client("follower", broker=broker)
    a.sync_catalog()
    b.sync_catalog()
    LEDGER.clear()
    ra = a.infer(seg, max_new_tokens=2)
    rb = b.infer(seg, max_new_tokens=2)
    assert ra.matched_tokens == rb.matched_tokens == 70
    assert rb.shared_fetch
    rec_a, rec_b = LEDGER.get(ra.trace_id), LEDGER.get(rb.trace_id)
    # the leader's record owns the fetch; the sibling links to it
    # through the broker-shared reply
    assert rec_a["outcome"]["dedup_of"] is None
    assert rec_b["outcome"]["dedup_of"] == rec_a["id"]
    assert rec_b["attempts"][0]["shared"] is True
    assert LEDGER.totals()["dedup_shared"] == 1


def test_stale_catalog_fp_bumps_directory_counter(ledger_world):
    cluster, client = ledger_world
    seg = _one_range_prompt(11, 44)
    client("seeder").infer(seg, max_new_tokens=2)
    cluster.gossip()
    c = client("victim")
    c.sync_catalog()
    for peer in cluster.peers:          # every catalog now lies
        peer.server.store.clear()
        peer.server.stored_bytes = 0

    def fp_total():
        fam = REGISTRY.snapshot().get("repro_catalog_fp_total", {})
        return sum(fam.values()) if isinstance(fam, dict) else fam

    LEDGER.clear()
    before = fp_total()
    res = c.infer(seg, max_new_tokens=2)
    assert res.matched_tokens == 0
    assert fp_total() > before
    rec = LEDGER.get(res.trace_id)
    assert rec["outcome"]["result"] == "local"
    assert rec["outcome"]["fallthroughs"]["miss"] >= 1
    assert LEDGER.totals()["fallthrough_miss"] >= 1


# ---------------------------------------------------------------------------
# the stream watchdog's learned baseline (a repair), as the reference's
# ---------------------------------------------------------------------------

class _PacedStream:
    """An in-process link (either package's peer) whose chunk streams
    arrive one every ``pace_s`` and honour the cancel between chunks."""

    net = None

    def __init__(self, peer, pace_s, cancelled_exc):
        self.peer, self.peer_id, self.pace_s = peer, peer.peer_id, pace_s
        self.exc = cancelled_exc
        self.cancelled = 0

    def request(self, op, payload, advance_clock=True):
        return self.peer.handle(op, dict(payload)), 0.001, 64

    def request_stream(self, op, payload, on_chunk, advance_clock=True,
                       cancel=None):
        resp = self.peer.handle(op, dict(payload))
        chunks = resp.pop("chunks", [])
        for c in chunks:
            if cancel is not None and cancel.is_set():
                self.cancelled += 1
                raise self.exc("cut")
            time.sleep(self.pace_s)
            on_chunk(bytes(c), self.pace_s, len(c))
        return resp, self.pace_s * len(chunks), 64


PACE_S = 0.15                      # a chunk's wait on the paced link
BASELINE_S = 0.2                   # the learned local prefill of the prompt


def _watchdog_run(pkg, jm, jp, learned):
    """One streamed partial hit with no perf model and no deadline; with
    ``learned`` the ledger has learned a BASELINE_S local prefill of the
    prompt first. Returns (matched tokens, output tokens, chunks the
    link cut, the watchdog's reasons in the flight ring)."""
    n_shot = 2
    if pkg == "port":
        cfg = get_config("gemma3-270m").reduced().replace(n_layers=6)
        model = Model(cfg, device="cpu")
        model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)))
        engine = InferenceEngine(model, max_len=512)
        box, peer = CacheServer(CacheConfig()), CachePeer("p0")
        seed_c = EdgeClient("seed", engine, box, CacheConfig())
        ledger, flight, exc = LEDGER, FLIGHT, StreamCancelled
        gen = MMLUGenerator(WordHashTokenizer(cfg.vocab), n_shot=n_shot)

        def client(d):
            return EdgeClient("w", engine, d, CacheConfig(), overlap=True)
        directory, wall = PeerDirectory, WallClock
    else:
        from repro.data import MMLUGenerator as JaxGen
        from repro.data import WordHashTokenizer as JaxTok
        cfg = jm.cfg
        engine = JaxEngine(jm, jp, max_len=512)
        box, peer = JaxServer(JaxCacheConfig()), JaxPeer("p0")
        seed_c = JaxEdgeClient("seed", engine,
                               JaxTransport(box, JaxSimNetwork(),
                                            JaxSimClock()),
                               JaxCacheConfig())
        ledger, flight, exc = JAX_LEDGER, JAX_FLIGHT, JaxStreamCancelled
        gen = JaxGen(JaxTok(cfg.vocab), n_shot=n_shot)

        def client(d):
            return JaxEdgeClient("w", engine, d, JaxCacheConfig(),
                                 overlap=True)
        directory, wall = JaxDirectory, JaxWallClock
    seed_c.infer(gen.prompt("nutrition", 0).segments, max_new_tokens=2)
    for key, v in box.store.items():
        peer.server.put(key, v)
    link = _PacedStream(peer, PACE_S, exc)
    d = directory([link], clock=wall())
    c = client(d)
    c.sync_catalog()
    p = gen.prompt("nutrition", 1).segments
    ledger.clear()
    flight.clear()
    if learned:
        ledger.note_prefill(len(p.token_ids), BASELINE_S)
    r = c.infer(p, max_new_tokens=4, upload_on_miss=False)
    reasons = [e.get("reason") for dmp in flight.dumps()
               for e in dmp["events"] if e["ev"] == "fetch.cancel"]
    ledger.clear()
    flight.clear()
    return (r.matched_tokens, [int(t) for t in r.output_tokens],
            link.cancelled, reasons)


def test_watchdog_cuts_past_the_learned_baseline_as_the_reference(
        tiny_setup):
    """Without a perf model and without a deadline, the watchdog of
    both packages cuts a stream paced at PACE_S a chunk once the ledger
    has learned a BASELINE_S local prefill; both fall back to a local
    prefill with the same tokens. With nothing learned it lets the
    stream finish."""
    jcfg = jax_get_config("gemma3-270m").reduced().replace(n_layers=6)
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    assert stream_chunk_count(jcfg, CacheConfig().chunk_layers) >= 3
    mine = _watchdog_run("port", jm, jp, learned=True)
    ref = _watchdog_run("jax", jm, jp, learned=True)
    assert mine[0] == ref[0] == 0              # cut: a local prefill
    assert mine[2] == ref[2] >= 1              # each attempt's link was cut
    assert set(mine[3]) == set(ref[3]) == {"estimator"}
    assert mine[1] == ref[1]
    plain = _watchdog_run("port", jm, jp, learned=False)
    assert plain[0] > 0 and plain[2] == 0 and plain[3] == []
    assert plain[1] == mine[1]                 # the same tokens either way
