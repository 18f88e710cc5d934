"""The port's edge client end to end: the paper's cases on the CPU.

Mirrors ``tests/test_distributed_cache.py`` for the port's ``EdgeClient``
(single cache server, in-process transport), and runs one prompt
sequence through both packages' clients: the cases, matched lengths and
output tokens must be the same.
"""
import jax
import numpy as np
import pytest

from repro.config import CacheConfig as JaxCacheConfig
from repro.core import CacheServer as JaxCacheServer
from repro.core import EdgeClient as JaxEdgeClient
from repro.core import SimClock, SimNetwork
from repro.core.perfmodel import PI_ZERO_2W
from repro.core.transport import InProcTransport as JaxTransport
from repro.data import MMLUGenerator as JaxMMLU
from repro.data import WordHashTokenizer as JaxTokenizer
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.config import CacheConfig
from repro_torch.configs import get_config
from repro_torch.core.client import EdgeClient
from repro_torch.core.segments import PromptSegments
from repro_torch.core.server import CacheServer
from repro_torch.data import mmlu
from repro_torch.data.tokenizer import WordHashTokenizer
from repro_torch.models.model import Model
from repro_torch.params import from_jax_params
from repro_torch.serving.engine import InferenceEngine

MAX_LEN = 512


@pytest.fixture(scope="module")
def world(tiny_setup):
    cfg, jm, jp = tiny_setup
    model = Model(get_config("gemma3-270m").reduced(), device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)))
    server = CacheServer(CacheConfig())
    gen = mmlu.MMLUGenerator(WordHashTokenizer(cfg.vocab), n_shot=2)

    def client(name, **kw):
        return EdgeClient(name, InferenceEngine(model, max_len=MAX_LEN),
                          server, CacheConfig(), **kw)
    return cfg, server, gen, client


def test_cases_1_4_5(world):
    cfg, server, gen, mk = world
    c1, c2 = mk("c1"), mk("c2")
    p = gen.prompt("astronomy", 0)
    r1 = c1.infer(p.segments, max_new_tokens=4)
    assert r1.case == 1 and r1.blob_bytes_up > 0 and r1.matched_tokens == 0
    # same domain, new question -> partial hit (instruction + examples)
    c2.sync_catalog()
    r2 = c2.infer(gen.prompt("astronomy", 1).segments, max_new_tokens=4)
    assert r2.case == 4 and 0 < r2.matched_tokens < r2.prompt_tokens
    assert r2.blob_bytes_down > 0
    # identical prompt -> full hit with no model call, identical output
    r3 = c2.infer(p.segments, max_new_tokens=4)
    assert r3.case == 5 and r3.matched_tokens == r3.prompt_tokens
    assert r3.output_tokens == r1.output_tokens
    assert r3.timings["prefill_s"] == 0.0
    for r in (r1, r2, r3):
        assert 0 < r.ttft_s <= r.ttlt_s


def test_partial_hit_output_equals_miss_output(world):
    cfg, server, gen, mk = world
    seeder, fresh, resumed = mk("s"), mk("f"), mk("r")
    p0, p1 = gen.prompt("virology", 0), gen.prompt("virology", 1)
    seeder.infer(p0.segments, max_new_tokens=2)
    resumed.sync_catalog()
    r_resumed = resumed.infer(p1.segments, max_new_tokens=4)
    r_fresh = fresh.infer(p1.segments, max_new_tokens=4,
                          upload_on_miss=False)
    assert r_resumed.case in (3, 4) and r_fresh.case == 1
    assert r_resumed.output_tokens == r_fresh.output_tokens


def test_catalog_suppresses_gets_on_a_cold_prompt(world):
    cfg, server, gen, mk = world
    c = mk("cold")
    before = server.handle("stats", {})["stats"]["gets"]
    c.infer(gen.prompt("management", 40).segments, max_new_tokens=2)
    assert server.handle("stats", {})["stats"]["gets"] == before


def test_poisoned_catalog_falls_back_to_local(world):
    """§3.3: a catalog entry the server does not hold costs a GET, never
    correctness."""
    cfg, server, gen, mk = world
    honest, poisoned = mk("h"), mk("p")
    p = gen.prompt("prehistory", 3)
    for k in p.segments.keys(poisoned.meta):
        poisoned.catalog.register(k.digest)
    before = server.handle("stats", {})["stats"]["gets"]
    r = poisoned.infer(p.segments, max_new_tokens=3, upload_on_miss=False)
    rh = honest.infer(p.segments, max_new_tokens=3, upload_on_miss=False)
    assert r.case == 1 and r.false_positive and r.blob_bytes_down == 0
    assert server.handle("stats", {})["stats"]["gets"] - before >= 1
    assert r.output_tokens == rh.output_tokens


def test_generator_copy_matches_reference(world):
    cfg = world[0]
    mine = mmlu.MMLUGenerator(WordHashTokenizer(cfg.vocab), n_shot=5)
    ref = JaxMMLU(JaxTokenizer(cfg.vocab), n_shot=5)
    for domain, i in (("astronomy", 0), ("virology", 3)):
        a, b = mine.prompt(domain, i), ref.prompt(domain, i)
        assert a.segments.token_ids == b.segments.token_ids
        assert a.segments.boundaries == b.segments.boundaries


def test_same_cases_tokens_as_the_jax_client(tiny_setup):
    """One prompt sequence through both packages' clients, each with its
    own server: miss, partial hit, full hit, cold miss, and a poisoned
    catalog."""
    cfg, jm, jp = tiny_setup
    model = Model(get_config("gemma3-270m").reduced(), device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)))
    gen = JaxMMLU(JaxTokenizer(cfg.vocab), n_shot=2)
    jserver, tserver = JaxCacheServer(JaxCacheConfig()), \
        CacheServer(CacheConfig())
    clock, net = SimClock(), SimNetwork()

    def jax_client(name):
        return JaxEdgeClient(name, JaxEngine(jm, jp, max_len=MAX_LEN),
                             JaxTransport(jserver, net, clock),
                             JaxCacheConfig(), perf=PI_ZERO_2W)

    def port_client(name):
        return EdgeClient(name, InferenceEngine(model, max_len=MAX_LEN),
                          tserver, CacheConfig())

    steps = [("a", ("nutrition", 0), False), ("b", ("nutrition", 1), False),
             ("b", ("nutrition", 0), False), ("a", ("sociology", 2), False),
             ("p", ("anatomy", 5), True)]
    results = {}
    for pkg, mk in (("jax", jax_client), ("port", port_client)):
        clients = {name: mk(name) for name in ("a", "b", "p")}
        out = []
        for name, (domain, i), poison in steps:
            c = clients[name]
            c.sync_catalog()
            seg = gen.prompt(domain, i).segments
            if pkg == "port":
                seg = PromptSegments(seg.token_ids, seg.boundaries)
            if poison:
                for k in seg.keys(c.meta):
                    c.catalog.register(k.digest)
            r = c.infer(seg, max_new_tokens=5)
            out.append((r.case, r.matched_tokens,
                        [int(t) for t in r.output_tokens], r.false_positive))
        results[pkg] = out
    assert [o[0] for o in results["port"]] == [1, 4, 5, 1, 1]
    assert results["port"] == results["jax"]
