"""The port's concurrent cache-sharing sessions: fetch dedup, shared
adoption, download/compute overlap accounting.

Mirrors the seven tests of ``tests/test_session_pool.py`` on the port's
``FetchBroker`` and ``SessionPool`` over reduced gemma3-270m (the
reference's ``tiny_setup`` weights carried across by
``params.from_jax_params``, fp32, on the CPU). The pools are built the
one way the port offers, ``SessionPool(engine=..., fabric=...)``: the
reference's deprecated ``SessionPool(server, engine)`` spelling, which
those tests use, is not ported. Where a pool serves whole prompts, its
tokens are also held against the reference's ``EdgeClient`` on the same
prompt.
"""
import threading
import time

import jax
import numpy as np
import pytest

from repro.config import CacheConfig as JaxCacheConfig
from repro.core import CacheServer as JaxCacheServer
from repro.core import EdgeClient as JaxEdgeClient
from repro.core import SimClock as JaxSimClock
from repro.core import SimNetwork as JaxSimNetwork
from repro.core.transport import InProcTransport as JaxTransport
from repro.data import MMLUGenerator as JaxMMLU
from repro.data import WordHashTokenizer as JaxTokenizer
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.config import CacheConfig
from repro_torch.configs import get_config
from repro_torch.core.client import EdgeClient
from repro_torch.core.fabric import Fabric
from repro_torch.core.netsim import SimClock, SimNetwork
from repro_torch.core.perfmodel import PI_ZERO_2W
from repro_torch.core.server import CacheServer
from repro_torch.core.session_pool import FetchBroker, SessionPool
from repro_torch.core.transport import InProcTransport
from repro_torch.data.mmlu import MMLUGenerator
from repro_torch.data.tokenizer import WordHashTokenizer
from repro_torch.models.model import Model
from repro_torch.params import from_jax_params
from repro_torch.serving.engine import InferenceEngine

TIMEOUT_S = 30.0                   # every join and wait here is bounded


@pytest.fixture(scope="module")
def world(tiny_setup):
    cfg, _, jp = tiny_setup
    model = Model(get_config("gemma3-270m").reduced(), device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)))
    engine = InferenceEngine(model, max_len=512)
    gen = MMLUGenerator(WordHashTokenizer(cfg.vocab), n_shot=2)
    return cfg, engine, gen


def _seeder(server, engine):
    return EdgeClient("seeder", engine,
                      InProcTransport(server, SimNetwork(), SimClock()),
                      CacheConfig(), perf=PI_ZERO_2W)


def _pool(server, engine, **kw):
    return SessionPool(engine=engine, fabric=Fabric.local(server=server),
                       perf=PI_ZERO_2W, **kw)


def _join(*threads):
    for t in threads:
        t.join(TIMEOUT_S)
        assert not t.is_alive()


# ---------------------------------------------------------------------------
# FetchBroker
# ---------------------------------------------------------------------------

def test_broker_dedups_concurrent_fetches():
    broker = FetchBroker()
    calls, gate = [], threading.Event()

    def issue():
        calls.append(1)
        gate.wait(5.0)
        return {"ok": True, "blob": b"blob-bytes"}, 0.25, 100

    results = []

    def go():
        results.append(broker.fetch(b"key", issue))

    t1 = threading.Thread(target=go)
    t1.start()
    deadline = time.monotonic() + TIMEOUT_S
    while not calls and time.monotonic() < deadline:
        time.sleep(0.001)                 # the leader's GET is in flight
    t2 = threading.Thread(target=go)
    t2.start()
    deadline = time.monotonic() + TIMEOUT_S
    while broker.stats["joined"] < 1 and time.monotonic() < deadline:
        time.sleep(0.001)                 # the follower has joined it
    gate.set()
    _join(t1, t2)
    assert len(calls) == 1                # one download
    assert all(r[0]["blob"] == b"blob-bytes" for r in results)
    assert sorted(r[3] for r in results) == [False, True]
    shared = next(r for r in results if r[3])
    assert shared[1] == 0.0 and shared[2] == 0   # no wire cost to share


def test_broker_runs_prep_during_transfer():
    broker = FetchBroker()
    order = []

    def issue():
        order.append("issue-start")
        time.sleep(0.05)
        order.append("issue-end")
        return {"ok": True, "blob": b"x"}, 0.0, 1

    def prep():
        order.append("prep")
        return "template"

    resp, dt, nb, shared, prepped = broker.fetch(b"k2", issue, prep=prep)
    assert prepped == "template"
    assert order.index("prep") < order.index("issue-end")


def test_broker_does_not_cache_failures():
    broker = FetchBroker()
    n = []

    def issue():
        n.append(1)
        return {"ok": False, "blob": None}, 0.0, 10

    broker.fetch(b"miss", issue)
    broker.fetch(b"miss", issue)
    assert len(n) == 2                    # a failed GET is asked again


def test_broker_blob_cache_serves_later_sessions():
    broker = FetchBroker()
    n = []

    def issue():
        n.append(1)
        return {"ok": True, "blob": b"y"}, 0.1, 50

    first = broker.fetch(b"hit", issue)
    second = broker.fetch(b"hit", issue)
    assert len(n) == 1
    assert not first[3] and second[3]     # the second adoption is shared
    assert broker.stats["cache_hits"] == 1


# ---------------------------------------------------------------------------
# SessionPool
# ---------------------------------------------------------------------------

def _gets(server):
    return server.handle("stats", {})["stats"]["gets"]


def test_pool_single_get_per_shared_prefix(world, tiny_setup):
    """Three concurrent sessions wanting the same prefix cost one GET (one
    download, shared adoption), with the unshared path's tokens, which
    are the reference client's."""
    cfg, engine, gen = world
    server = CacheServer(CacheConfig())
    p0 = gen.prompt("astronomy", 0)
    r0 = _seeder(server, engine).infer(p0.segments, max_new_tokens=4)

    pool = _pool(server, engine, n_sessions=3)
    pool.sync_catalogs()
    gets0 = _gets(server)
    res = pool.run([p0.segments] * 3, max_new_tokens=4)

    assert _gets(server) - gets0 == 1     # one download for three sessions
    assert sum(r.shared_fetch for r in res) == 2
    assert all(r.case == 5 for r in res)  # all three adopted the full hit
    assert all(r.output_tokens == r0.output_tokens for r in res)
    assert sum(r.blob_bytes_down > 0 for r in res) == 1

    _, jmodel, jparams = tiny_setup
    jgen = JaxMMLU(JaxTokenizer(cfg.vocab), n_shot=2)
    jclient = JaxEdgeClient(
        "ref", JaxEngine(jmodel, jparams, max_len=512),
        JaxTransport(JaxCacheServer(JaxCacheConfig()), JaxSimNetwork(),
                     JaxSimClock()), JaxCacheConfig())
    want = jclient.infer(jgen.prompt("astronomy", 0).segments,
                         max_new_tokens=4).output_tokens
    assert [int(t) for t in want] == r0.output_tokens


def test_pool_partial_hits_share_one_get(world):
    """Different questions over the same instructions and examples: the
    shared prefix is downloaded once (one session streams it, the others
    join that transfer), each session prefills its own suffix."""
    cfg, engine, gen = world
    server = CacheServer(CacheConfig())
    _seeder(server, engine).infer(gen.prompt("virology", 0).segments,
                                  max_new_tokens=2)
    pool = _pool(server, engine, n_sessions=3)
    pool.sync_catalogs()
    gets0 = _gets(server)
    res = pool.run([gen.prompt("virology", q).segments for q in (1, 2, 3)],
                   max_new_tokens=4, upload_on_miss=False)
    assert _gets(server) - gets0 == 1
    assert all(0 < r.matched_tokens < r.prompt_tokens for r in res)
    fresh = EdgeClient(
        "fresh", engine, InProcTransport(server, SimNetwork(), SimClock()),
        CacheConfig(), perf=PI_ZERO_2W, use_catalog=True)
    for q, r in zip((1, 2, 3), res):
        ref = fresh.infer(gen.prompt("virology", q).segments,
                          max_new_tokens=4, upload_on_miss=False)
        assert r.output_tokens == ref.output_tokens


def test_overlap_hides_download_behind_suffix_prefill(world):
    """A partial hit with overlap: the sim TTFT charges only the
    un-hidden remainder of the transfer (layer-streamed model)."""
    cfg, engine, gen = world
    server = CacheServer(CacheConfig())
    _seeder(server, engine).infer(gen.prompt("nutrition", 0).segments,
                                  max_new_tokens=2)

    def run_one(overlap):
        pool = _pool(server, engine, n_sessions=1, overlap=overlap)
        pool.sync_catalogs()
        return pool.run([gen.prompt("nutrition", 1).segments],
                        max_new_tokens=2, upload_on_miss=False)[0]

    r_plain = run_one(overlap=False)
    r_overlap = run_one(overlap=True)
    assert r_overlap.matched_tokens == r_plain.matched_tokens > 0
    hidden = r_overlap.extra.get("overlap_hidden_s", 0.0)
    assert hidden > 0
    assert r_overlap.sim.redis >= 0
    assert r_overlap.sim.ttft < r_plain.sim.ttft
    assert r_overlap.output_tokens == r_plain.output_tokens
    np.testing.assert_allclose(r_overlap.sim.ttft,
                               r_plain.sim.ttft - hidden, rtol=0.2)
