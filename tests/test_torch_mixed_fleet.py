"""A JAX peer and a torch peer share one cache (fp32, on the CPU).

The blobs one package's client uploads on a miss are put byte for byte
into the other package's server; the other client's Cases 4 and 5 must
then give a cold run's tokens. fp32 only: the reference cannot write a
bf16 cache (ROADMAP Queue 3).

On mamba2 the prompts are built so that the reference's own faults
(ROADMAP Queue 3) stay out of the way: prompt B extends prompt A, so B's
partial hit is A's full-prompt blob, the one blob the reference uploads
with logits and its own state; A is 64 tokens and B's suffix 32, bucket
sizes, so the reference's engine pads neither.

On deepseek-v3 cut to its dense layers the reference writes no chunk
for the empty MoE segment and then cannot restore its own blob; the port
restores it. The other direction is
``tests/test_torch_mla_client.py::test_port_blob_of_the_cut_resumes_in_the_reference``.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.config import CacheConfig as JaxCacheConfig
from repro.configs import get_config as jax_get_config
from repro.core import CacheServer as JaxCacheServer
from repro.core import EdgeClient as JaxEdgeClient
from repro.core import SimClock, SimNetwork
from repro.core import state_io as jax_state_io
from repro.core.segments import PromptSegments as JaxSegments
from repro.core.transport import InProcTransport as JaxTransport
from repro.models import Model as JaxModel
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.config import CacheConfig
from repro_torch.configs import get_config
from repro_torch.configs.deepseek_v3_671b import dense_cut
from repro_torch.core import state_io
from repro_torch.core.client import EdgeClient
from repro_torch.core.segments import PromptSegments
from repro_torch.core.server import CacheServer
from repro_torch.data import mmlu
from repro_torch.data.tokenizer import WordHashTokenizer
from repro_torch.models.model import Model
from repro_torch.params import from_jax_params
from repro_torch.serving.engine import InferenceEngine

MAX_LEN = 512
N_NEW = 5


def _pair(jcfg, port_cfg):
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    model = Model(port_cfg, device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)))
    return jm, jp, model


def _mmlu_prompts(vocab):
    gen = mmlu.MMLUGenerator(WordHashTokenizer(vocab), n_shot=2)
    return [gen.prompt("astronomy", i).segments for i in (0, 1)]


def _extending_prompts(vocab):
    """A: 64 tokens; B: A and 32 more. B's 64-token range is A's prompt."""
    toks = np.random.default_rng(11).integers(3, vocab, 96).tolist()
    return [PromptSegments.make(toks[:64], [8, 16, 40, 64]),
            PromptSegments.make(toks, [8, 16, 40, 64, 96])]


class Fleet:
    """Both packages' clients over one model's params."""

    def __init__(self, jm, jp, model):
        self.jm, self.jp, self.model = jm, jp, model
        self.clock, self.net = SimClock(), SimNetwork()

    def jax_client(self, name, server):
        return JaxEdgeClient(name, JaxEngine(self.jm, self.jp,
                                             max_len=MAX_LEN),
                             JaxTransport(server, self.net, self.clock),
                             JaxCacheConfig())

    def port_client(self, name, server, overlap=False):
        return EdgeClient(name, InferenceEngine(self.model, max_len=MAX_LEN),
                          server, CacheConfig(), overlap=overlap)

    def cold(self, prompt):
        return self.port_client("cold", CacheServer(CacheConfig())).infer(
            prompt, N_NEW, upload_on_miss=False).output_tokens


def _jax_seg(p):
    return JaxSegments(p.token_ids, p.boundaries)


def _cases_4_and_5(client, p_a, p_b, **kw):
    client.sync_catalog()
    r4 = client.infer(p_b, N_NEW, upload_on_miss=False, **kw)
    r5 = client.infer(p_a, N_NEW, upload_on_miss=False, **kw)
    return r4, r5


def _crossing(fleet, p_a, p_b, overlap):
    """JAX uploads -> port server -> port client, then port uploads ->
    JAX server -> JAX client. Returns the four results."""
    cold_a, cold_b = fleet.cold(p_a), fleet.cold(p_b)
    jserver = JaxCacheServer(JaxCacheConfig())
    fleet.jax_client("ja", jserver).infer(_jax_seg(p_a), N_NEW)
    assert jserver.store and all(state_io.is_chunked(b)
                                 for b in jserver.store.values())
    tserver = CacheServer(CacheConfig())
    for key, blob in jserver.store.items():
        tserver.put(key, blob)
    r4, r5 = _cases_4_and_5(fleet.port_client("tb", tserver, overlap),
                            p_a, p_b)
    assert (r4.case, r5.case) == (4, 5) and r4.streamed == overlap
    assert r4.output_tokens == cold_b and r5.output_tokens == cold_a

    tserver2, jserver2 = CacheServer(CacheConfig()), \
        JaxCacheServer(JaxCacheConfig())
    fleet.port_client("ta", tserver2).infer(p_a, N_NEW)
    for key, blob in tserver2.store.items():
        assert state_io.is_chunked(blob)
        jserver2.put(key, blob)
    j4, j5 = _cases_4_and_5(fleet.jax_client("jb", jserver2), _jax_seg(p_a),
                            _jax_seg(p_b))
    assert (j4.case, j5.case) == (4, 5)
    assert list(j4.output_tokens) == cold_b
    assert list(j5.output_tokens) == cold_a


@pytest.mark.parametrize("overlap", [False, True], ids=["whole", "streamed"])
def test_gemma_blobs_cross_both_ways(tiny_setup, overlap):
    cfg, jm, jp = tiny_setup
    model = Model(get_config("gemma3-270m").reduced(), device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)))
    _crossing(Fleet(jm, jp, model), *_mmlu_prompts(cfg.vocab), overlap)


@pytest.fixture(scope="module")
def mamba():
    return _pair(jax_get_config("mamba2-780m").reduced(),
                 get_config("mamba2-780m").reduced())


@pytest.mark.parametrize("overlap", [False, True], ids=["whole", "streamed"])
def test_mamba2_blobs_cross_both_ways(mamba, overlap):
    fleet = Fleet(*mamba)
    _crossing(fleet, *_extending_prompts(fleet.model.cfg.vocab), overlap)


@pytest.fixture(scope="module")
def cut():
    jcfg = jax_get_config("deepseek-v3-671b").reduced()
    jcfg = jcfg.replace(n_layers=2, mtp=False,
                        moe=dataclasses.replace(jcfg.moe, first_k_dense=2))
    return _pair(jcfg, dense_cut(get_config("deepseek-v3-671b").reduced(),
                                 2))


@pytest.mark.parametrize("overlap", [False, True], ids=["whole", "streamed"])
def test_port_restores_the_reference_blob_of_the_dense_cut(cut, overlap):
    """The reference's client uploads PC3 blobs of the cut with no chunk
    for the empty MoE segment; its own full hit then raises ChunkError
    out of ``infer`` (ROADMAP Queue 3). The port counts the empty leaves
    as covered: its Cases 4 and 5 on those blobs give a cold run's
    tokens."""
    fleet = Fleet(*cut)
    p_a, p_b = _mmlu_prompts(fleet.model.cfg.vocab)
    jserver = JaxCacheServer(JaxCacheConfig())
    ja = fleet.jax_client("ja", jserver)
    ja.infer(_jax_seg(p_a), N_NEW)
    tserver = CacheServer(CacheConfig())
    for key, blob in jserver.store.items():
        segs = {m["seg"] for m in state_io.parse_state(
            blob, ja.meta)["_restorer"].header["chunks"]}
        assert segs == {"segments/0"}          # nothing for segments/1
        tserver.put(key, blob)
    r4, r5 = _cases_4_and_5(fleet.port_client("tb", tserver, overlap),
                            p_a, p_b)
    assert (r4.case, r5.case) == (4, 5) and r4.unreadable_blobs == 0
    assert r4.output_tokens == fleet.cold(p_b)
    assert r5.output_tokens == fleet.cold(p_a)
    with pytest.raises(jax_state_io.ChunkError, match="missing leaves"):
        ja.infer(_jax_seg(p_a), N_NEW, upload_on_miss=False)
