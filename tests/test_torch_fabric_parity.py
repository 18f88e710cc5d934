"""The port's fabric against the reference's, on the CPU.

* Placement, replication owners and fetch plans: the same peers, links,
  perf model and keys give the same owners, the same plan order and the
  same pruned set in both packages; the port's parameter counts, blob
  sizing and Pi perf model give the reference's numbers.
* One request sequence on a 3-peer ``CacheCluster`` with ``SimNetwork``
  links and ``PI_ZERO_2W``, in each package with its own fleet and
  weights carried across by ``params.from_jax_params``: a miss, a gossip
  round, a partial hit (monolithic, and streamed in the ``overlap``
  case), a full hit, a full hit after the serving peer died, and the
  no-catalog ablation. Cases, ``served_by``, attempts, blob bytes,
  per-peer stats and greedy tokens must be equal; every ``sim``
  Breakdown field within 1e-9 relative; fp32 prompt logits within 1e-5.
  Blob sizes must be equal for the modeled seconds to be, so this
  sequence stores blobs uncompressed (``compress=False``): a compressed
  size follows the last bits of the fp32 cache, which the two frameworks
  compute in another order. The reference client runs with its tracer
  disabled: a traced request carries a ``_trace`` envelope and
  ``_spans`` descriptors the port does not send, which would change the
  bytes its SimNetwork charges.
* A mixed fleet over TCP: a JAX client uploads through port peers and a
  port client hits, and the other way round.
"""
import jax
import numpy as np
import pytest

from repro.config import CacheConfig as JaxCacheConfig
from repro.configs import get_config as jax_get_config
from repro.core import EdgeClient as JaxEdgeClient
from repro.core import sizing as jax_sizing
from repro.core.cluster import CacheCluster as JaxCluster
from repro.core.cluster import PlacementPolicy as JaxPlacement
from repro.core.cluster.directory import PeerDirectory as JaxDirectory
from repro.core.cluster.peer import CachePeer as JaxPeer
from repro.core.cluster.planner import FetchPlanner as JaxPlanner
from repro.core.net.link import TCPPeerLink as JaxLink
from repro.core.net.server import serve_peer_tcp as jax_serve_peer_tcp
from repro.core.netsim import SimClock as JaxSimClock
from repro.core.netsim import WallClock as JaxWallClock
from repro.core.perfmodel import PI_5 as JAX_PI_5
from repro.core.perfmodel import PI_ZERO_2W as JAX_PI_ZERO_2W
from repro.core.segments import PromptSegments as JaxSegments
from repro.obs.trace import Tracer
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.config import CacheConfig
from repro_torch.configs import get_config
from repro_torch.configs.deepseek_v3_671b import dense_cut
from repro_torch.core import sizing
from repro_torch.core.client import EdgeClient
from repro_torch.core.cluster import CacheCluster, PlacementPolicy
from repro_torch.core.cluster.directory import PeerDirectory
from repro_torch.core.cluster.peer import CachePeer
from repro_torch.core.cluster.planner import FetchPlanner
from repro_torch.core.net.link import TCPPeerLink
from repro_torch.core.net.server import serve_peer_tcp
from repro_torch.core.netsim import SimClock, WallClock
from repro_torch.core.perfmodel import PI_5, PI_ZERO_2W
from repro_torch.core.segments import PromptSegments
from repro_torch.models.model import Model
from repro_torch.params import from_jax_params
from repro_torch.serving.engine import InferenceEngine

MAX_LEN = 512
N_NEW = 4
LINKS = [(30e6, 0.002), (21e6, 0.003), (8e6, 0.008)]
CONFIGS = ["gemma3-270m", "gemma3-1b", "mamba2-780m", "deepseek-v3-671b",
           "hymba-1.5b"]


def _cfg_pair(name):
    ours, ref = get_config(name), jax_get_config(name)
    if name.startswith("deepseek"):
        ours = dense_cut(ours, 3)
        ref = ref.replace(n_layers=3, mtp=False,
                          moe=ref.moe.__class__(**{**ref.moe.__dict__,
                                                   "first_k_dense": 3}))
    return ours, ref


# -- counts, sizes and the perf model ------------------------------------------

@pytest.mark.parametrize("name", CONFIGS)
def test_param_counts_sizes_and_perf_model_match(name):
    ours, ref = _cfg_pair(name)
    assert ours.param_count() == ref.param_count()
    assert ours.active_param_count() == ref.active_param_count()
    for n in (1, 57, 300):
        for logits in (True, False):
            assert sizing.state_bytes(ours, n, 2, logits) == \
                jax_sizing.state_bytes(ref, n, 2, logits)
    for cl in (1, 2, 5):
        assert sizing.stream_chunk_count(ours, cl) == \
            jax_sizing.stream_chunk_count(ref, cl)
    for mine, theirs in ((PI_ZERO_2W, JAX_PI_ZERO_2W), (PI_5, JAX_PI_5)):
        for n in (1, 65, 334):
            assert mine.time_prefill(ours, n) == theirs.time_prefill(ref, n)
            assert mine.time_decode(ours, n) == theirs.time_decode(ref, n)
            assert mine.time_tokenize(n) == theirs.time_tokenize(n)
            assert mine.time_bloom(n) == theirs.time_bloom(n)
            assert mine.time_sample(n) == theirs.time_sample(n)


# -- placement, owners, plans ---------------------------------------------------

@pytest.mark.parametrize("n_peers", [2, 3, 5, 8])
def test_placement_and_replication_owners_match(n_peers):
    ids = [f"peer{i}" for i in range(n_peers)]
    ours, ref = PlacementPolicy(ids), JaxPlacement(ids)
    rng = np.random.default_rng(n_peers)
    mine, theirs = CacheCluster([(21e6, 0.003)] * n_peers), \
        JaxCluster([(21e6, 0.003)] * n_peers)
    for _ in range(300):
        d = rng.bytes(32)
        assert ours.ring_order(d) == ref.ring_order(d)
        assert mine.peers[0].replication.owners(d) == \
            theirs.peers[0].replication.owners(d)


@pytest.fixture(scope="module")
def prompts(tiny_setup):
    """A; B, which shares A's first 80 tokens; C, which shares nothing.
    Drawn from a seed (MMLU-style prompts take their lengths from
    ``hash()``, which changes from process to process)."""
    rng = np.random.default_rng(7)
    vocab = tiny_setup[0].vocab
    a = rng.integers(3, vocab, 96).tolist()
    b = a[:80] + rng.integers(3, vocab, 40).tolist()
    c = rng.integers(3, vocab, 64).tolist()
    return [PromptSegments.make(a, [16, 48, 80, 96]),
            PromptSegments.make(b, [16, 48, 80, 120]),
            PromptSegments.make(c, [16, 32, 64])]


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("links", [LINKS, [(100e6, 0.001), (1e4, 0.5),
                                           (2e6, 0.03)]],
                         ids=["het", "straggler"])
def test_fetch_plans_match(tiny_setup, prompts, links, overlap):
    """Every peer's catalog claims every range: the plans (order, est
    fetch and total seconds, ring ranks) and the pruned sets agree."""
    cfg_ref = tiny_setup[0]
    cfg = get_config("gemma3-270m").reduced()
    mine, theirs = CacheCluster(links), JaxCluster(links)
    d, jd = mine.directory(clock=SimClock()), \
        theirs.directory(clock=JaxSimClock())
    for perf, jperf in ((PI_ZERO_2W, JAX_PI_ZERO_2W), (None, None)):
        planner = FetchPlanner(d, cfg, perf, dtype_bytes=4, overlap=overlap)
        jplanner = JaxPlanner(jd, cfg_ref, jperf, dtype_bytes=4,
                              overlap=overlap)
        for seg in prompts:
            keys = seg.keys(b"meta")
            jkeys = JaxSegments(seg.token_ids, seg.boundaries).keys(b"meta")
            assert [k.digest for k in keys] == [k.digest for k in jkeys]
            for k in keys:
                for pid in d.links:
                    d.register(pid, k.digest)
                    jd.register(pid, k.digest)
            n = len(seg.token_ids)
            got = [(a.peer_id, a.key.digest, a.est_fetch_s, a.est_total_s,
                    a.ring_rank) for a in planner.plan(keys, n, min_match=4)]
            want = [(a.peer_id, a.key.digest, a.est_fetch_s, a.est_total_s,
                     a.ring_rank) for a in jplanner.plan(jkeys, n,
                                                         min_match=4)]
            assert got == want
            if perf is not None and links[1][0] < 1e5:
                assert all(a[0] != "peer1" for a in got)   # pruned


# -- one request sequence, both packages ----------------------------------------

def _record_logits(engine, sink):
    """Keep each request's prompt logits (start / resume / adopt)."""
    for name in ("start", "resume", "adopt", "resume_streamed"):
        f = getattr(engine, name)

        def wrapped(*a, _f=f, _name=name, **kw):
            st = _f(*a, **kw)
            sink.append((_name, np.asarray(st.last_logits, np.float32)))
            return st
        setattr(engine, name, wrapped)
    return engine


def _sequence(pkg, tiny_setup, prompts, overlap):
    """Run the fabric sequence in one package; returns its observations."""
    cfg, jm, jp = tiny_setup
    p_a, p_b, p_c = prompts
    logits = []
    if pkg == "jax":
        ccfg = JaxCacheConfig(compress=False)
        cluster = JaxCluster(LINKS, ccfg)

        def client(name, **kw):
            eng = _record_logits(JaxEngine(jm, jp, max_len=MAX_LEN), logits)
            return JaxEdgeClient(name, eng,
                                 cluster.directory(clock=JaxSimClock()),
                                 ccfg, perf=JAX_PI_ZERO_2W,
                                 tracer=Tracer(enabled=False), **kw)

        def seg(p):
            return JaxSegments(p.token_ids, p.boundaries)
    else:
        model = Model(get_config("gemma3-270m").reduced(), device="cpu")
        model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)))
        ccfg = CacheConfig(compress=False)
        cluster = CacheCluster(LINKS, ccfg)

        def client(name, **kw):
            eng = _record_logits(InferenceEngine(model, max_len=MAX_LEN),
                                 logits)
            return EdgeClient(name, eng, cluster.directory(clock=SimClock()),
                              ccfg, perf=PI_ZERO_2W, **kw)

        def seg(p):
            return PromptSegments(p.token_ids, p.boundaries)

    def sync(c):
        c.directory.last_sync_t = -1e18
        c.sync_catalog()

    a, b = client("A"), client("B", overlap=overlap)
    steps = [("A miss", a.infer(seg(p_a), N_NEW))]
    cluster.gossip()
    sync(b)
    steps.append(("B partial", b.infer(seg(p_b), N_NEW)))
    steps.append(("B full", b.infer(seg(p_a), N_NEW)))
    served = steps[-1][1].served_by
    cluster.kill(served)
    steps.append(("B after a death", b.infer(seg(p_a), N_NEW)))
    cat = client("C")
    sync(cat)
    steps.append(("catalog, cold prompt", cat.infer(seg(p_c), N_NEW,
                                                    upload_on_miss=False)))
    nocat = client("N", use_catalog=False)
    sync(nocat)
    steps.append(("no catalog, cold prompt",
                  nocat.infer(seg(p_c), N_NEW, upload_on_miss=False)))
    out = []
    for tag, r in steps:
        out.append({"tag": tag, "case": r.case, "matched": r.matched_tokens,
                    "served_by": r.served_by,
                    "attempts": r.fetch_attempts,
                    "down": r.blob_bytes_down, "up": r.blob_bytes_up,
                    "fp": r.false_positive,
                    "tokens": [int(t) for t in r.output_tokens],
                    "dead": r.extra.get("dead_peer_failures", 0.0),
                    "chunks": int(r.chunks_down if pkg == "port"
                                  else r.extra.get("chunks_down", 0)),
                    "sim": r.sim.as_dict()})
    stats = {name: {pid: s.as_dict() for pid, s in
                    c.directory.peer_stats().items()}
             for name, c in (("B", b), ("N", nocat))}
    gets = {p.peer_id: p.server.stats["gets"] for p in cluster.peers}
    return out, stats, gets, served, logits


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["monolithic", "streamed"])
def test_fabric_sequence_matches_the_reference(tiny_setup, prompts, overlap):
    mine = _sequence("port", tiny_setup, prompts, overlap)
    ref = _sequence("jax", tiny_setup, prompts, overlap)
    steps, stats, gets, served, logits = mine
    rsteps, rstats, rgets, rserved, rlogits = ref
    assert [s["case"] for s in steps][:2] == [1, 4]
    # streamed, the planner prices a partial hit as pipelined: it may
    # take one over the full range
    assert steps[2]["case"] == 5 or overlap
    assert (steps[1]["chunks"] > 0) == overlap
    # the planner may take a shorter range over a faster link (Case 4)
    assert steps[3]["case"] in (1, 4, 5) and steps[3]["served_by"] != served
    assert steps[3]["dead"] >= 1
    assert steps[4]["attempts"] == 0 and steps[5]["attempts"] >= 1
    assert served == rserved
    for s, r in zip(steps, rsteps):
        for k in ("case", "matched", "served_by", "attempts", "down", "up",
                  "fp", "tokens", "dead", "chunks"):
            assert s[k] == r[k], (s["tag"], k, s[k], r[k])
        for k, v in s["sim"].items():
            assert v == pytest.approx(r["sim"][k], rel=1e-9, abs=1e-15), \
                (s["tag"], k)
    assert gets == rgets
    for who in stats:
        for pid, st in stats[who].items():
            for k, v in st.items():
                assert v == pytest.approx(rstats[who][pid][k], rel=1e-9,
                                          abs=1e-15), (who, pid, k)
    assert len(logits) == len(rlogits) == len(steps)
    vocab = tiny_setup[0].vocab
    for (how, mine_l), (rhow, ref_l) in zip(logits, rlogits):
        assert how == rhow
        mine_l, ref_l = mine_l[:, :vocab], ref_l[:, :vocab]
        if how == "adopt":
            # a full hit adopts the blob's fp16 logits: each package
            # rounds its own fp32 logits, which may straddle a rounding
            # point, so they agree within one fp16 step
            ulp = np.spacing(np.abs(ref_l).astype(np.float16)).astype(
                np.float32)
            assert np.all(np.abs(mine_l - ref_l) <= ulp), how
        else:
            np.testing.assert_allclose(mine_l, ref_l, rtol=0, atol=1e-5)


def test_reference_sim_seconds_move_with_its_tracer(tiny_setup, prompts):
    """The reference charges its tracing envelope (``_trace`` out,
    ``_spans`` back) as Wi-Fi bytes, so its modeled fetch seconds depend
    on whether tracing is on; the port charges the op's frames only and
    gives the untraced reference's seconds."""
    cfg, jm, jp = tiny_setup
    p_a = prompts[0]
    redis = {}
    for traced in (False, True):
        cluster = JaxCluster(LINKS, JaxCacheConfig(compress=False))

        def client(name):
            kw = {} if traced else {"tracer": Tracer(enabled=False)}
            return JaxEdgeClient(name, JaxEngine(jm, jp, max_len=MAX_LEN),
                                 cluster.directory(clock=JaxSimClock()),
                                 cluster.cache_cfg, perf=JAX_PI_ZERO_2W,
                                 **kw)
        seg = JaxSegments(p_a.token_ids, p_a.boundaries)
        client("A").infer(seg, N_NEW)
        b = client("B")
        b.sync_catalog()
        redis[traced] = b.infer(seg, N_NEW).sim.redis
    model = Model(get_config("gemma3-270m").reduced(), device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)))
    cluster = CacheCluster(LINKS, CacheConfig(compress=False))

    def port_client(name):
        return EdgeClient(name, InferenceEngine(model, max_len=MAX_LEN),
                          cluster.directory(clock=SimClock()),
                          cluster.cache_cfg, perf=PI_ZERO_2W)
    port_client("A").infer(p_a, N_NEW)
    b = port_client("B")
    b.sync_catalog()
    mine = b.infer(p_a, N_NEW).sim.redis
    assert redis[True] > redis[False]
    assert mine == pytest.approx(redis[False], rel=1e-12)


# -- a mixed fleet over TCP -------------------------------------------------------

@pytest.mark.parametrize("peers_of", ["port", "jax"])
def test_mixed_fleet_over_tcp(tiny_setup, prompts, peers_of):
    """Three TCP peers of one package; the other package's client
    uploads on a miss, this package's client gets Cases 4 and 5 with the
    cold run's tokens (wall clocks, real sockets)."""
    cfg, jm, jp = tiny_setup
    p_a, p_b = prompts[0], prompts[1]
    model = Model(get_config("gemma3-270m").reduced(), device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)))
    if peers_of == "port":
        peers = [CachePeer(f"peer{i}") for i in range(3)]
        servers = [serve_peer_tcp(p) for p in peers]
    else:
        peers = [JaxPeer(f"peer{i}") for i in range(3)]
        servers = [jax_serve_peer_tcp(p) for p in peers]
    addrs = [("127.0.0.1", s.port) for s in servers]

    def jax_client(name):
        links = [JaxLink(f"peer{i}", *a) for i, a in enumerate(addrs)]
        d = JaxDirectory(links, JaxCacheConfig(), clock=JaxWallClock())
        return JaxEdgeClient(name, JaxEngine(jm, jp, max_len=MAX_LEN), d,
                             JaxCacheConfig())

    def port_client(name):
        links = [TCPPeerLink(f"peer{i}", *a) for i, a in enumerate(addrs)]
        d = PeerDirectory(links, CacheConfig(), clock=WallClock())
        return EdgeClient(name, InferenceEngine(model, max_len=MAX_LEN), d,
                          CacheConfig())

    def jseg(p):
        return JaxSegments(p.token_ids, p.boundaries)

    try:
        cold = port_client("cold")
        cold_a = cold.infer(p_a, N_NEW, upload_on_miss=False).output_tokens
        cold_b = cold.infer(p_b, N_NEW, upload_on_miss=False).output_tokens
        if peers_of == "port":
            up = jax_client("ja").infer(jseg(p_a), N_NEW)
            reader, seg = port_client("tb"), (lambda p: p)
        else:
            up = port_client("ta").infer(p_a, N_NEW)
            reader, seg = jax_client("jb"), jseg
        assert up.case == 1 and up.blob_bytes_up > 0
        reader.directory.last_sync_t = -1e18
        reader.sync_catalog()
        r4 = reader.infer(seg(p_b), N_NEW, upload_on_miss=False)
        r5 = reader.infer(seg(p_a), N_NEW, upload_on_miss=False)
        assert (r4.case, r5.case) == (4, 5)
        assert r4.served_by and r5.served_by
        assert [int(t) for t in r4.output_tokens] == cold_b
        assert [int(t) for t in r5.output_tokens] == cold_a
    finally:
        for s in servers:
            s.close()
