"""The port's multi-peer fabric and its edge client, on the CPU.

Mirrors ``tests/test_cluster.py`` (placement, gossip, planning, fault
paths, replication and repair; not the broker or session-pool tests),
``tests/test_distributed_cache.py`` (the paper's cases over one
simulated server with the Pi Zero 2W perf model) and the adaptive
planner test of ``tests/test_net_runtime.py``, on the port's classes
and its ``EdgeClient`` over reduced gemma3-270m, with the reference's
weights carried across by ``params.from_jax_params``.

The contract is the paper's §3.3 extended to N peers: a catalog lie
(Bloom false positive, eviction, stale gossip) or a dead peer costs
latency only; outputs equal the single-server and cache-off runs.
"""
import hashlib
import random

import jax
import numpy as np
import pytest

from repro_torch.config import CacheConfig
from repro_torch.configs import get_config
from repro_torch.core.client import EdgeClient
from repro_torch.core.cluster import (CacheCluster, HotKeyTracker,
                                      PeerDirectory, PlacementPolicy,
                                      gossip_round)
from repro_torch.core.cluster.directory import HOT_MAX_ENTRIES
from repro_torch.core.cluster.peer import CachePeer
from repro_torch.core.netsim import SimClock, SimNetwork
from repro_torch.core.perfmodel import PI_ZERO_2W
from repro_torch.core.segments import PromptSegments
from repro_torch.core.server import CacheServer
from repro_torch.core.transport import InProcTransport, TransportError
from repro_torch.data.mmlu import MMLUGenerator
from repro_torch.data.tokenizer import WordHashTokenizer
from repro_torch.models.model import Model
from repro_torch.params import from_jax_params
from repro_torch.serving.engine import InferenceEngine

HET_LINKS = [(30e6, 0.002), (21e6, 0.003), (8e6, 0.008)]
MAX_LEN = 512


@pytest.fixture(scope="module")
def fabric_world(tiny_setup):
    cfg, _, jp = tiny_setup
    model = Model(get_config("gemma3-270m").reduced(), device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)))
    engine = InferenceEngine(model, max_len=MAX_LEN)
    gen = MMLUGenerator(WordHashTokenizer(cfg.vocab), n_shot=2)

    def make_cluster(links=None, ccfg=None, **dir_kw):
        ccfg = ccfg or CacheConfig()
        cluster = CacheCluster(links or HET_LINKS, ccfg)

        def client(name, **kw):
            dkw = dict(dir_kw)
            dkw.update(kw.pop("dir_kw", {}))
            d = cluster.directory(clock=SimClock(), **dkw)
            return EdgeClient(name, engine, d, ccfg, perf=PI_ZERO_2W, **kw)
        return cluster, client
    return gen, engine, make_cluster


# -- placement ---------------------------------------------------------------

def test_consistent_hash_stability():
    ids3 = ["a", "b", "c"]
    p3, p2 = PlacementPolicy(ids3), PlacementPolicy(["a", "b"])
    moved = 0
    for k in [bytes([i]) * 32 for i in range(200)]:
        order = p3.ring_order(k)
        assert p3.primary(k) in ids3 and sorted(order) == sorted(ids3)
        assert p3.ring_order(k) == order
        if p3.primary(k) != p2.primary(k):
            moved += 1
            assert p3.primary(k) == "c"        # only c's keys remap
    assert 0 < moved < 200


# -- gossip --------------------------------------------------------------------

def test_gossip_spreads_key_knowledge(fabric_world):
    _, _, make_cluster = fabric_world
    cluster, _ = make_cluster()
    a, b, _ = cluster.peers
    a.server.put(b"k" * 32, b"blob-on-a")
    assert gossip_round(cluster.peers) > 0
    resp = b.handle("csync", {"since": 0, "since_remote": 0})
    assert [b"k" * 32, a.peer_id] in resp["remote"]
    assert gossip_round(cluster.peers) == 0    # converged


def test_blob_via_peer_a_discoverable_syncing_only_peer_b(fabric_world):
    _, _, make_cluster = fabric_world
    cluster, client = make_cluster()
    c1 = client("uploader")
    tokens = list(range(3, 60))                # one range: the whole prompt
    seg = PromptSegments.make(tokens, [len(tokens)])
    r1 = c1.infer(seg, max_new_tokens=4)
    assert r1.case == 1 and r1.blob_bytes_up > 0
    key = seg.keys(c1.meta)[0].digest
    holders = {pid for pid, p in cluster.by_id.items()
               if key in p.server.store}
    assert len(holders) >= 2                   # the peer pushed the rest
    assert c1.directory.placement.primary(key) in holders
    other = next(pid for pid in cluster.by_id if pid not in holders)
    cluster.gossip()
    c2 = client("syncer", dir_kw={"sync_peers": [other]})
    c2.sync_catalog()
    r2 = c2.infer(seg, max_new_tokens=4)
    assert r2.matched_tokens == len(tokens) and r2.served_by in holders
    assert r2.output_tokens == r1.output_tokens


# -- false positives and dead peers ------------------------------------------

def test_multi_peer_false_positive_falls_back_to_local(fabric_world):
    gen, _, make_cluster = fabric_world
    cluster, client = make_cluster()
    poisoned, honest = client("poisoned"), client("honest")
    p = gen.prompt("prehistory", 3)
    for pid in cluster.by_id:                  # every catalog lies
        for k in p.segments.keys(poisoned.meta):
            poisoned.directory.register(pid, k.digest)
    r = poisoned.infer(p.segments, max_new_tokens=3, upload_on_miss=False)
    rh = honest.infer(p.segments, max_new_tokens=3, upload_on_miss=False)
    assert r.case == 1 and r.false_positive
    assert r.fetch_attempts >= len(cluster.peers)
    assert r.output_tokens == rh.output_tokens
    assert r.sim.redis > 0                     # paid the wasted GETs
    misses = sum(s.misses for s in poisoned.directory.peer_stats().values())
    assert misses == r.fetch_attempts


def test_dead_peer_degrades_to_local_prefill(fabric_world):
    gen, _, make_cluster = fabric_world
    cluster, client = make_cluster()
    c1, c2 = client("seed"), client("reader")
    p = gen.prompt("virology", 0)
    r1 = c1.infer(p.segments, max_new_tokens=4)
    c2.sync_catalog()
    r2 = c2.infer(p.segments, max_new_tokens=4)
    assert r2.matched_tokens > 0 and r2.served_by
    for pid in cluster.by_id:                  # the whole fabric dies
        cluster.kill(pid)
    r3 = c2.infer(p.segments, max_new_tokens=4, upload_on_miss=False)
    assert r3.case == 1 and r3.matched_tokens == 0
    assert r3.extra.get("dead_peer_failures", 0) >= 1
    assert r3.output_tokens == r1.output_tokens
    assert [ln for ln in c2.directory.links.values()
            if ln.suspect_until > c2.clock.now()]
    for pid in cluster.by_id:
        cluster.revive(pid)
    c2.clock.advance(c2.directory.suspect_cooldown_s + 1)
    r4 = c2.infer(p.segments, max_new_tokens=4)
    assert r4.matched_tokens > 0 and r4.served_by
    assert r4.output_tokens == r1.output_tokens


def test_dead_transport_error_is_bounded(fabric_world):
    _, _, make_cluster = fabric_world
    cluster, client = make_cluster()
    c = client("c")
    cluster.kill("peer0")
    with pytest.raises(TransportError):
        c.directory.request("peer0", "ping", {})
    assert "peer0" not in c.directory.usable_ids()


def test_npeer_outputs_token_identical_to_single_and_cache_off(fabric_world):
    gen, engine, make_cluster = fabric_world
    ccfg = CacheConfig()
    prompts = [gen.prompt(d, q).segments
               for d in ("anatomy", "nutrition") for q in range(3)]

    def run_cluster():
        cluster, client = make_cluster(ccfg=ccfg)
        c = client("c")
        outs = []
        for p in prompts:
            c.directory.last_sync_t = -1e18
            c.sync_catalog()
            cluster.gossip()
            outs.append(c.infer(p, max_new_tokens=4).output_tokens)
        return outs

    def single(upload):
        tr = InProcTransport(CacheServer(ccfg), SimNetwork(), SimClock())
        c = EdgeClient("s", engine, tr, ccfg, perf=PI_ZERO_2W)
        outs = []
        for p in prompts:
            c.catalog.last_sync_t = -1e18
            c.sync_catalog()
            outs.append(c.infer(p, max_new_tokens=4,
                                upload_on_miss=upload).output_tokens)
        return outs

    off = single(False)
    assert run_cluster() == off
    assert single(True) == off


# -- hot keys, the planner ------------------------------------------------------

def test_hot_key_replicates_to_fastest_peer(fabric_world):
    gen, _, make_cluster = fabric_world
    cluster, client = make_cluster()
    c = client("c", dir_kw={"hot_threshold": 2})
    p = gen.prompt("marketing", 0)
    c.infer(p.segments, max_new_tokens=2)
    c.sync_catalog()
    for _ in range(3):
        assert c.infer(p.segments, max_new_tokens=2).matched_tokens > 0
    assert c.directory.replications >= 1
    assert [k for k in p.segments.keys(c.meta)
            if sum(k.digest in peer.server.store
                   for peer in cluster.peers) >= 2]


def test_planner_prefers_fast_link_and_prunes_slow(fabric_world):
    gen, _, make_cluster = fabric_world
    cluster, client = make_cluster(links=[(100e6, 0.001), (1e4, 0.5)])
    c = client("c")
    p = gen.prompt("sociology", 0)
    keys = p.segments.keys(c.meta)
    for pid in cluster.by_id:
        for k in keys:
            c.directory.register(pid, k.digest)
    n = len(p.segments.token_ids)
    plan = c.planner.plan(keys, n, min_match=c.cache_cfg.min_match_tokens)
    assert plan and all(a.peer_id == "peer0" for a in plan)
    local_s = c.perf.time_prefill(c.perf_cfg, n)
    assert all(a.est_total_s < local_s for a in plan)


def test_adaptive_planner_reroutes_off_congested_link(fabric_world):
    """Both peers hold the key; peer0's link collapses. The adaptive
    directory reprices it from observed fetches and the plan leads with
    peer1; a static one keeps leading with peer0."""
    gen, engine, _ = fabric_world
    p = gen.prompt("anatomy", 0)
    for adaptive in (True, False):
        cluster = CacheCluster([(40e6, 0.002), (20e6, 0.003)])
        d = cluster.directory(clock=SimClock(), adaptive=adaptive)
        c = EdgeClient("c", engine, d, cluster.cache_cfg, perf=PI_ZERO_2W)
        c.infer(p.segments, max_new_tokens=2)
        cluster.gossip()
        for key in p.segments.keys(c.meta):
            blob = cluster.peers[0].server.get(key.digest)
            if blob is not None:
                for peer in cluster.peers:
                    peer.server.put(key.digest, blob)
        d.last_sync_t = -1e18
        c.sync_catalog()
        cluster.by_id["peer0"].net.bandwidth_bps = 1e6
        for _ in range(6):
            assert c.infer(p.segments, max_new_tokens=2).matched_tokens > 0
        plan = c.planner.plan(p.segments.keys(c.meta),
                              len(p.segments.token_ids),
                              min_match=c.cache_cfg.min_match_tokens)
        assert plan[0].peer_id == ("peer1" if adaptive else "peer0")


def test_hot_key_decay_gc_returns_replica_bytes_to_budget(fabric_world):
    gen, _, make_cluster = fabric_world
    budget = 600_000
    cluster, client = make_cluster(ccfg=CacheConfig(max_store_bytes=budget))
    c = client("c", dir_kw={"hot_threshold": 2, "hot_decay_every": 6})
    hot, cold = gen.prompt("marketing", 0), gen.prompt("prehistory", 1)
    c.infer(hot.segments, max_new_tokens=2)
    c.sync_catalog()
    for _ in range(3):
        assert c.infer(hot.segments, max_new_tokens=2).matched_tokens > 0
    assert c.directory.replications >= 1 and c.directory._replicas
    replicated = dict(c.directory._replicas)
    assert all(p.server.stored_bytes <= budget for p in cluster.peers)
    before = cluster.stored_bytes()
    c.infer(cold.segments, max_new_tokens=2)
    c.sync_catalog()
    for _ in range(12):
        c.infer(cold.segments, max_new_tokens=2)
    assert c.directory.hot.decays >= 1 and c.directory.replica_gcs >= 1
    for digest, pid in replicated.items():
        if digest not in c.directory._replicas:
            assert digest not in cluster.by_id[pid].server.store
            assert cluster.by_id[pid].server.stats["deletes"] >= 1
    assert cluster.stored_bytes() < before + budget
    assert all(p.server.stored_bytes <= budget for p in cluster.peers)


def test_hot_key_tracker_decay_cools_keys():
    t = HotKeyTracker(threshold=2, decay_every=4)
    for _ in range(3):
        t.note(b"a")
    assert t.is_hot(b"a")
    t.note(b"b")                       # the 4th note decays
    assert t.decays == 1 and not t.is_hot(b"a")
    assert t.counts.get(b"b", 0) == 0


def test_hot_tracker_never_evicts_live_replica_digest():
    pinned = {b"\xaa" * 32}
    t = HotKeyTracker(threshold=3, max_entries=16, pinned=pinned.__contains__)
    replica = b"\xaa" * 32
    t.note(replica)
    for i in range(500):
        t.note(b"cold-%027d" % i)
    assert t.counts[replica] == 1 and len(t.counts) <= 16
    t.note(replica)
    t.note(replica)
    assert t.is_hot(replica)


def test_directory_hammered_tracker_keeps_replica(fabric_world):
    gen, _, make_cluster = fabric_world
    _, client = make_cluster()
    c = client("c", dir_kw={"hot_threshold": 2})
    d = c.directory
    p = gen.prompt("marketing", 0)
    c.infer(p.segments, max_new_tokens=2)
    c.sync_catalog()
    for _ in range(3):
        assert c.infer(p.segments, max_new_tokens=2).matched_tokens > 0
    digest = next(iter(d._replicas))
    for i in range(HOT_MAX_ENTRIES + 64):    # evicts the cold counts
        d.hot.note(b"noise-%026d" % i)
    assert len(d.hot.counts) <= HOT_MAX_ENTRIES and d.hot.is_hot(digest)
    assert d.gc_replicas() == 0 and digest in d._replicas


# -- push replication, handoff, repair ----------------------------------------

def _digest_with_primary(placement, pid: str, tag: bytes = b"k") -> bytes:
    for i in range(10_000):
        d = hashlib.blake2b(tag + b"%d" % i, digest_size=32).digest()
        if placement.primary(d) == pid:
            return d
    raise AssertionError(f"no digest maps to {pid!r}")


def test_put_fans_out_peer_to_peer_one_client_copy():
    cluster = CacheCluster([(21e6, 0.003)] * 3)
    d = cluster.directory(clock=SimClock())
    digest, blob = b"\x5a" * 32, b"x" * 1000
    assert d.upload(digest, blob) == len(blob)
    owners = cluster.peers[0].replication.owners(digest)
    assert len(owners) == 2
    assert all(digest in cluster.by_id[pid].server.store for pid in owners)
    assert sum(ln.stats.bytes_up for ln in d.links.values()) == len(blob)
    assert cluster.p2p_bytes() == len(blob) * (len(owners) - 1)


def test_hinted_handoff_repairs_misplacement_and_drops_leak():
    cluster = CacheCluster([(21e6, 0.003)] * 3)
    d = cluster.directory(clock=SimClock())
    digest, blob = b"\x11" * 32, b"y" * 500
    primary, second, third = d.placement.ring_order(digest)
    cluster.kill(primary)
    cluster.kill(second)
    assert d.upload(digest, blob) == len(blob)
    assert digest in cluster.by_id[third].server.store
    repl = cluster.by_id[third].replication
    assert repl.pending == 2
    assert cluster.repair_round() == 2          # owners dead: retried
    cluster.revive(primary)
    cluster.revive(second)
    assert cluster.repair_round() == 0
    assert digest in cluster.by_id[primary].server.store
    assert digest in cluster.by_id[second].server.store
    assert digest not in cluster.by_id[third].server.store   # leak dropped
    snap = repl.snapshot()
    assert (snap["handoffs"], snap["repl_pushed"], snap["leaks_repaired"],
            snap["pending"]) == (1, 1, 1, 0)
    d2 = cluster.directory(clock=SimClock())
    d2.maybe_sync(d2.clock.now())
    assert primary in d2.lookup(digest)


def test_hot_hint_ships_blob_peer_to_peer_not_from_client():
    cluster = CacheCluster(HET_LINKS)
    d = cluster.directory(clock=SimClock(), hot_threshold=2)
    digest, blob = b"\x07" * 32, b"z" * 2000
    d.upload(digest, blob)
    owners = cluster.peers[0].replication.owners(digest)
    d.maybe_sync(d.clock.now())
    made = []

    def make_blob():
        made.append(1)
        return blob
    assert d.note_fetch(digest, len(blob), owners[0], make_blob) is None
    target = d.note_fetch(digest, len(blob), owners[0], make_blob)
    assert target is not None and target not in owners
    assert not made                    # the peer pushed: no client copy
    assert digest in cluster.by_id[target].server.store
    assert d.links[target].stats.bytes_up == 0
    assert d.links[owners[0]].stats.hints == 1
    assert d._replicas[digest] == target and d.hot.pinned(digest)


def test_hot_replication_falls_back_to_client_push_when_unwired():
    peers = [CachePeer(f"p{i}") for i in range(3)]
    d = PeerDirectory(peers, clock=SimClock(), hot_threshold=2)
    digest, blob = b"\x44" * 32, b"q" * 900
    d.upload(digest, blob)
    assert sum(digest in p.server.store for p in peers) == 1
    src = d.placement.ring_order(digest)[0]
    d.maybe_sync(d.clock.now())
    made = []

    def make_blob():
        made.append(1)
        return blob
    d.note_fetch(digest, len(blob), src, make_blob)
    target = d.note_fetch(digest, len(blob), src, make_blob)
    assert target is not None and len(made) == 1
    assert digest in next(p for p in peers if p.peer_id == target).server.store
    assert d.links[target].stats.bytes_up == len(blob)
    assert d.links[src].stats.hints == 0 and d._replicas[digest] == target


def test_budget_rejected_put_acks_stored_false_and_walks_ring():
    cluster = CacheCluster([(21e6, 0.003)] * 3)
    d = cluster.directory(clock=SimClock())
    digest = _digest_with_primary(d.placement, "peer0", b"rej")
    cluster.by_id["peer0"].server.cfg = CacheConfig(max_store_bytes=100)
    blob = b"b" * 500
    assert d.upload(digest, blob) == len(blob)
    assert digest not in cluster.by_id["peer0"].server.store
    assert d.links["peer0"].stats.store_rejects == 1
    assert "peer0" not in d.lookup(digest)
    assert cluster.by_id["peer0"].server.stats["rejects"] >= 1
    fallback = d.placement.ring_order(digest)[1]
    assert digest in cluster.by_id[fallback].server.store
    assert fallback in d.lookup(digest)


def test_gc_replicas_transient_failure_keeps_entry_and_retries():
    cluster = CacheCluster(HET_LINKS)
    d = cluster.directory(clock=SimClock(), hot_threshold=2)
    digest, blob = b"\x2f" * 32, b"w" * 800
    d.upload(digest, blob)
    owners = cluster.peers[0].replication.owners(digest)
    d.maybe_sync(d.clock.now())
    d.note_fetch(digest, len(blob), owners[0], lambda: blob)
    target = d.note_fetch(digest, len(blob), owners[0], lambda: blob)
    assert target is not None and digest in d._replicas
    d.hot.counts.clear()                       # the key has cooled
    cluster.kill(target)
    assert d.gc_replicas() == 0 and d._replicas.get(digest) == target
    cluster.revive(target)
    assert d.gc_replicas() == 1 and digest not in d._replicas
    assert digest not in cluster.by_id[target].server.store
    assert d.replica_gcs == 1


def test_slow_miss_does_not_pollute_rtt_estimator_or_flip_plan():
    cluster = CacheCluster([(30e6, 0.002), (21e6, 0.003)])
    d = cluster.directory(clock=SimClock())
    digest = b"\x3c" * 32
    for pid in cluster.by_id:
        d.register(pid, digest)
    nb = 500_000
    fast = d.est_fetch_s("peer0", nb)
    assert fast < d.est_fetch_s("peer1", nb)
    d.record_get("peer0", hit=False, est_s=0.0, actual_s=5.0, nbytes=0)
    assert d.links["peer0"].stats.miss_outliers == 1
    assert d.est_fetch_s("peer0", nb) == pytest.approx(fast)
    d.record_get("peer0", hit=False, est_s=0.0, actual_s=0.002, nbytes=0)
    assert d.links["peer0"].stats.misses == 2
    assert d.estimator.snapshot("peer0")[2] == 1


def test_read_repair_pushes_a_holders_copy_to_the_peer_that_lied():
    cluster = CacheCluster([(21e6, 0.003)] * 3)
    d = cluster.directory(clock=SimClock())
    digest, blob = b"\x66" * 32, b"r" * 700
    d.upload(digest, blob)
    d.maybe_sync(d.clock.now())
    liar = next(pid for pid in cluster.by_id
                if digest not in cluster.by_id[pid].server.store)
    d.register(liar, digest)
    d.record_get(liar, hit=False, est_s=0.0, actual_s=0.003, nbytes=0,
                 predicted_present=True, digest=digest)
    assert d.read_repairs == 1
    assert digest in cluster.by_id[liar].server.store
    d.record_get(liar, hit=False, est_s=0.0, actual_s=0.003, nbytes=0,
                 predicted_present=True, digest=digest)
    assert d.read_repairs == 1                 # rate-limited a digest


def test_epidemic_gossip_converges_at_lower_fanout():
    cluster = CacheCluster([(21e6, 0.003)] * 8)
    peers = cluster.peers
    digests = []
    for i, p in enumerate(peers):
        p.server.put(bytes([i]) * 32, b"blob")
        digests.append(bytes([i]) * 32)
    rng = random.Random(3)
    rounds = 0
    while rounds < 40 and not all(p.knows(d) for p in peers
                                  for d in digests):
        gossip_round(peers, fanout=2, rng=rng)
        rounds += 1
    assert 2 <= rounds < 40
    resp = peers[0].handle("csync", {"since": 0, "since_remote": 0})
    known = {bytes(k) for k in resp["keys"]} | \
        {bytes(k) for k, _ in resp["remote"]}
    assert set(digests) <= known


# -- the store budget ------------------------------------------------------------

def test_put_larger_than_budget_is_rejected_not_silently_dropped():
    server = CacheServer(CacheConfig(max_store_bytes=250))
    _, stored = server.put(b"g" * 32, b"x" * 1000)
    assert not stored and not server.store
    assert server.stats["rejects"] == 1 and server.sync(0)[0] == []
    resp = server.handle("put", {"key": b"k" * 32, "blob": b"y" * 100})
    assert resp["ok"] and resp["stored"]


def test_eviction_tombstones_exposed_via_sync():
    server = CacheServer(CacheConfig(max_store_bytes=250))
    for i in range(5):
        server.put(bytes([i]) * 32, b"x" * 100)
    assert server.stats["evictions"] >= 2
    assert server.stats["tombstones"] == server.stats["evictions"]
    resp = server.handle("sync", {"since": 0})
    assert resp["tombstones"] == server.stats["tombstones"]
    assert resp["version"] == 5
    victim = next(iter(server.tombstones))
    before = server.stats["tombstones"]
    server.put(victim, b"y" * 10)
    assert server.stats["tombstones"] == before - 1


def test_delete_op_returns_bytes_and_tombstones():
    server = CacheServer(CacheConfig())
    server.put(b"d" * 32, b"x" * 40)
    assert server.peek(b"d" * 32) == b"x" * 40
    assert server.stats["gets"] == 0           # peek is not a GET
    assert server.handle("del", {"key": b"d" * 32}) == {"ok": True}
    assert server.stored_bytes == 0 and server.stats["tombstones"] == 1
    assert server.handle("del", {"key": b"d" * 32}) == {"ok": False}


# -- one simulated server (mirrors tests/test_distributed_cache.py) ------------

@pytest.fixture(scope="module")
def world(fabric_world):
    gen, engine, _ = fabric_world
    server, clock, net = CacheServer(CacheConfig()), SimClock(), SimNetwork()

    def client(name, **kw):
        tr = InProcTransport(server, net, clock)
        return EdgeClient(name, engine, tr, CacheConfig(), perf=PI_ZERO_2W,
                          **kw)
    return server, gen, client


def test_cases_1_through_5(world):
    server, gen, mk = world
    c1, c2 = mk("c1"), mk("c2")
    p = gen.prompt("astronomy", 0)
    r1 = c1.infer(p.segments, max_new_tokens=4)
    assert r1.case == 1 and r1.blob_bytes_up > 0
    c2.sync_catalog()
    r2 = c2.infer(gen.prompt("astronomy", 1).segments, max_new_tokens=4)
    assert r2.case == 4 and 0 < r2.matched_tokens < r2.prompt_tokens
    r3 = c2.infer(p.segments, max_new_tokens=4)
    assert r3.case == 5 and r3.matched_tokens == r3.prompt_tokens
    assert r3.output_tokens == r1.output_tokens
    assert r3.sim.p_decode == 0.0
    assert r3.sim.ttft < r1.sim.ttft          # the paper's headline effect


def test_partial_hit_output_equals_miss_output(world):
    server, gen, mk = world
    seeder, fresh, resumed = mk("s"), mk("f"), mk("r")
    p0, p1 = gen.prompt("virology", 0), gen.prompt("virology", 1)
    seeder.infer(p0.segments, max_new_tokens=2)
    resumed.sync_catalog()
    r_resumed = resumed.infer(p1.segments, max_new_tokens=4)
    r_fresh = fresh.infer(p1.segments, max_new_tokens=4,
                          upload_on_miss=False)
    assert r_resumed.case in (3, 4)
    assert r_resumed.output_tokens == r_fresh.output_tokens


def test_catalog_suppresses_misses(world):
    server, gen, mk = world
    before = server.handle("stats", {})["stats"]["gets"]
    mk("cold").infer(gen.prompt("management", 40).segments, max_new_tokens=2)
    assert server.handle("stats", {})["stats"]["gets"] == before


def test_no_catalog_ablation_pays_roundtrips(world):
    server, gen, mk = world
    c = mk("nocat", use_catalog=False)
    before = server.handle("stats", {})["stats"]["gets"]
    r = c.infer(gen.prompt("marketing", 77).segments, max_new_tokens=2)
    assert server.handle("stats", {})["stats"]["gets"] - before >= 1
    assert r.sim.redis > 0 and r.sim.bloom == 0.0


def test_false_positive_falls_back_to_local(world):
    server, gen, mk = world
    honest, poisoned = mk("h"), mk("p")
    p = gen.prompt("prehistory", 3)
    for k in p.segments.keys(poisoned.meta):
        poisoned.catalog.register(k.digest)
    r = poisoned.infer(p.segments, max_new_tokens=3, upload_on_miss=False)
    rh = honest.infer(p.segments, max_new_tokens=3, upload_on_miss=False)
    assert r.case == 1 and r.false_positive
    assert r.output_tokens == rh.output_tokens
    assert r.sim.redis > 0


def test_catalog_async_sync_versioning(world):
    server, gen, mk = world
    c = mk("sync")
    v0 = c.catalog.version
    c.infer(gen.prompt("nutrition", 9).segments, max_new_tokens=2)
    c.catalog.last_sync_t = -1e18
    c.sync_catalog()
    assert c.catalog.version >= v0
    assert not c.catalog.maybe_sync(c.transport, c.clock.now())


def test_circuit_breaker_opens_probes_and_closes_as_the_reference():
    """Three failures open the breaker for a jittered window, a probe
    after it is allowed once, a failed probe doubles the window and a
    success closes it; every window equals the reference breaker's."""
    from repro.core.cluster.breaker import CircuitBreaker as JaxBreaker
    from repro_torch.core.cluster.breaker import CircuitBreaker
    ours, ref = CircuitBreaker("peer7"), JaxBreaker("peer7")
    for b in (ours, ref):
        assert b.allow(0.0)
        assert b.record_failure(0.0) is None
        assert b.record_failure(0.1) is None
    ev, rev = ours.record_failure(0.2), ref.record_failure(0.2)
    assert ev == rev and ev["backoff_s"] >= 0.5
    assert not ours.allow(0.3)
    t = ev["open_until"]
    assert ours.allow(t) and ours.state == "half_open"
    ours.on_attempt(t)
    assert not ours.allow(t + 1.0)            # one probe at a time
    assert ref.allow(t)
    ref.on_attempt(t)
    ev2, rev2 = ours.record_failure(t + 1.0), ref.record_failure(t + 1.0)
    assert ev2 == rev2 and ev2["probe_failed"] and ev2["opens"] == 2
    assert ev2["backoff_s"] >= 1.0
    assert ours.allow(ev2["open_until"])
    assert ours.record_success() and ours.state == "closed"
