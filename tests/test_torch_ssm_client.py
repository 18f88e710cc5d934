"""The edge client and state blobs on an SSM (mamba2-780m reduced, fp32,
on the CPU).

An SSM's prompt cache is a recurrent state, not per-position K/V. The
reference gets three things wrong with it (ROADMAP Queue 3): its engine
bucket-pads prompts, and the pad tokens advance the state; its range
blobs all carry the state of the whole prompt; and it resumes a blob
without logits at ``matched - 1``, running that token through the state
twice. Here every hit must equal a cold, unpadded prefill of the same
prompt: logits within 1e-5 (fp32; only summation orders differ), tokens
identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import state_io as jax_state_io
from repro.models import Model as JaxModel
from repro_torch.config import CacheConfig
from repro_torch.configs import get_config
from repro_torch.core import state_io
from repro_torch.core.client import EdgeClient
from repro_torch.core.keys import model_meta
from repro_torch.core.server import CacheServer
from repro_torch.data import mmlu
from repro_torch.data.tokenizer import WordHashTokenizer
from repro_torch.models.model import Model
from repro_torch.params import from_jax_params
from repro_torch.serving.engine import InferenceEngine

MAX_LEN = 512
TOL = 1e-5


@pytest.fixture(scope="module")
def world():
    jcfg = jax_get_config("mamba2-780m").reduced()
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    model = Model(get_config("mamba2-780m").reduced(), device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)))
    gen = mmlu.MMLUGenerator(WordHashTokenizer(model.cfg.vocab), n_shot=2)
    return jm, jp, model, gen


def _client(model, name, server):
    return EdgeClient(name, InferenceEngine(model, max_len=MAX_LEN), server,
                      CacheConfig())


def _tokens(prompt):
    return np.asarray(prompt.token_ids, np.int32)[None]


def _cold(model, tokens):
    """A cold, unpadded prefill: (last logits [1, V], cache)."""
    logits, cache = model.prefill({"tokens": tokens},
                                  model.init_cache(1, MAX_LEN))
    return logits.numpy(), cache


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL,
                               rtol=TOL)


def test_cases_1_4_5_equal_cold_runs(world):
    _, _, model, gen = world
    server = CacheServer(CacheConfig())
    a, b = _client(model, "a", server), _client(model, "b", server)
    cold = _client(model, "cold", CacheServer(CacheConfig()))
    p_a, p_b = (gen.prompt("astronomy", i).segments for i in (0, 1))
    r1 = a.infer(p_a, max_new_tokens=6)
    assert r1.case == 1 and r1.blob_bytes_up > 0
    b.sync_catalog()
    r4 = b.infer(p_b, max_new_tokens=6)
    assert r4.case == 4 and 0 < r4.matched_tokens < r4.prompt_tokens
    r5 = b.infer(p_a, max_new_tokens=6)
    assert r5.case == 5 and r5.timings["prefill_s"] == 0.0
    assert r1.output_tokens == r5.output_tokens
    assert r4.output_tokens == cold.infer(p_b, 6, upload_on_miss=False
                                          ).output_tokens
    assert r1.output_tokens == cold.infer(p_a, 6, upload_on_miss=False
                                          ).output_tokens


def test_range_blobs_hold_their_own_state_and_logits(world):
    """Every range blob A uploads restores to the state and logits of a
    cold prefill of that prefix; resuming B from the shared range gives
    B's cold logits. Under the reference's faults every range would carry
    the full (padded) prompt's state and these would differ."""
    _, _, model, gen = world
    server = CacheServer(CacheConfig())
    a = _client(model, "a", server)
    p_a, p_b = (gen.prompt("nutrition", i).segments for i in (0, 1))
    a.infer(p_a, max_new_tokens=4)
    toks_a, toks_b = _tokens(p_a), _tokens(p_b)
    eng = InferenceEngine(model, max_len=MAX_LEN)
    for key in p_a.keys(a.meta):
        blob = server.get(key.digest)
        cache, n_eff, logits = state_io.restore_state(
            state_io.parse_state(blob, a.meta), eng.new_cache())
        cold_logits, cold_cache = _cold(model, toks_a[:, :key.n_tokens])
        assert n_eff == key.n_tokens and logits is not None
        # blobs carry logits as float16: half an fp16 ulp, 2^-11 relative
        np.testing.assert_allclose(logits, cold_logits, rtol=2 ** -11,
                                   atol=TOL)
        for leaf in ("conv", "ssd"):
            _close(cache["segments"][0][leaf],
                   cold_cache["segments"][0][leaf])
        if np.array_equal(toks_a[:, :key.n_tokens],
                          toks_b[:, :key.n_tokens]) and \
                key.n_tokens < toks_b.shape[1]:
            res = eng.resume({"tokens": toks_b[:, key.n_tokens:]}, cache,
                             key.n_tokens)
            _close(res.last_logits, _cold(model, toks_b)[0])


def test_engine_does_not_pad_an_ssm_prompt(world):
    """The port's engine runs a 20-token prompt unpadded: its logits and
    greedy tokens are those of the reference's unpadded ``Model.prefill``
    and decode steps."""
    jm, jp, model, _ = world
    toks = np.random.default_rng(0).integers(3, 512, (1, 20)).astype(
        np.int32)
    eng = InferenceEngine(model, max_len=MAX_LEN)
    padded, n = eng._pad_inputs({"tokens": toks})
    assert n == 20 and padded["tokens"].shape == (1, 20)
    st = eng.start({"tokens": toks})
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        jm.init_cache(1, 32))
    _close(st.last_logits, np.asarray(jl))
    out = eng.generate(st, 6)[0].tolist()
    ref = []
    for i in range(6):
        t = int(np.argmax(np.asarray(jl)[0]))
        ref.append(t)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray([[t]], jnp.int32),
                                20 + i)
    assert out == ref


def test_blob_without_logits_is_skipped_not_resumed(world, monkeypatch):
    """A blob with no logits (as a JAX peer writes for a partial range)
    cannot be resumed at ``matched - 1`` on a recurrent state: the client
    treats it as a miss and prefills locally."""
    _, _, model, gen = world
    server = CacheServer(CacheConfig())
    c = _client(model, "c", server)
    p = gen.prompt("virology", 2).segments
    key = p.keys(c.meta)[1]                      # a partial range
    _, prefix_cache = _cold(model, _tokens(p)[:, :key.n_tokens])
    server.put(key.digest, state_io.extract_state(
        prefix_cache, key.n_tokens, c.meta, logits=None))
    c.catalog.register(key.digest)
    resumed = []
    monkeypatch.setattr(c.engine, "resume",
                        lambda *a, **k: resumed.append(a))
    r = c.infer(p, max_new_tokens=5, upload_on_miss=False)
    assert not resumed
    assert r.case == 1 and r.matched_tokens == 0
    cold = _client(model, "cold", CacheServer(CacheConfig()))
    assert r.output_tokens == cold.infer(p, 5, upload_on_miss=False
                                         ).output_tokens


def test_poisoned_catalog_falls_back_to_local(world):
    _, _, model, gen = world
    server = CacheServer(CacheConfig())
    poisoned, honest = _client(model, "p", server), _client(model, "h",
                                                            server)
    p = gen.prompt("prehistory", 3).segments
    for k in p.keys(poisoned.meta):
        poisoned.catalog.register(k.digest)
    r = poisoned.infer(p, max_new_tokens=4, upload_on_miss=False)
    rh = honest.infer(p, max_new_tokens=4, upload_on_miss=False)
    assert r.case == 1 and r.false_positive and r.blob_bytes_down == 0
    assert r.output_tokens == rh.output_tokens


def _ssm_cache_pair(dtype, seed=0):
    """The same SSM cache contents as a JAX pytree and a port cache: conv
    in ``dtype``, ssd in fp32."""
    cfg = get_config("mamba2-780m").reduced()
    template = Model(cfg, device="cpu").init_cache(1, 8)["segments"][0]
    rng = np.random.default_rng(seed)
    vals = {k: rng.normal(size=t.shape).astype(np.float32)
            for k, t in template.items()}
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jc = {"segments": [{"conv": jnp.asarray(vals["conv"], jdt),
                        "ssd": jnp.asarray(vals["ssd"], jnp.float32)}]}
    seg = {"conv": torch.from_numpy(vals["conv"]).to(dtype),
           "ssd": torch.from_numpy(vals["ssd"])}
    return cfg, jc, {"segments": [seg]}


def test_fp32_ssm_blob_is_byte_identical_and_resumes_in_jax(world):
    jm, jp, model, _ = world
    cfg, jc, tc = _ssm_cache_pair(torch.float32)
    meta = model_meta(cfg, "float32")
    logits = np.random.default_rng(1).normal(size=(1, cfg.vocab)).astype(
        np.float32)
    for lg in (logits, None):
        assert state_io.extract_state(tc, 30, meta, logits=lg,
                                      compress=False) == \
            jax_state_io.extract_state(jc, 30, meta, logits=lg,
                                       compress=False)
        assert state_io.extract_state(tc, 30, meta, logits=lg) == \
            jax_state_io.extract_state(jc, 30, meta, logits=lg,
                                       codec="zlib")
    # port prefill -> blob -> JAX restore -> JAX unpadded resume, and back
    toks = np.random.default_rng(2).integers(3, 512, (1, 40)).astype(
        np.int32)
    lg, pre = model.prefill({"tokens": toks[:, :25]},
                            model.init_cache(1, 64))
    blob = state_io.extract_state(pre, 25, meta, logits=lg.numpy())
    jcache, n_eff, _ = jax_state_io.restore_state(
        jax_state_io.parse_state(blob, meta), jm.init_cache(1, 64))
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, 25:])}, jcache,
                       25, resume=True)
    _close(_cold(model, toks)[0], np.asarray(jl))
    jl_pre, jpre = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :25])},
                              jm.init_cache(1, 64))
    jblob = jax_state_io.extract_state(jpre, 25, meta,
                                       logits=np.asarray(jl_pre),
                                       codec="zlib")
    tcache, _, _ = state_io.restore_state(state_io.parse_state(jblob, meta),
                                          model.init_cache(1, 64))
    tl, _ = model.prefill({"tokens": toks[:, 25:]}, tcache, 25, resume=True)
    _close(tl, np.asarray(jl))


def test_bf16_cache_blob_keeps_its_fp32_state():
    cfg, jc, tc = _ssm_cache_pair(torch.bfloat16, seed=3)
    meta = model_meta(cfg, "bfloat16")
    blob = state_io.extract_state(tc, 12, meta)
    payload = state_io.parse_state(blob, meta)
    dtypes = {d["path"]: d["dtype"] for d in payload["leaves"]}
    assert dtypes == {"segments/0/conv": "bfloat16",
                      "segments/0/ssd": "float32"}
    tmpl = {"segments": [{k: torch.zeros_like(t) for k, t in
                          tc["segments"][0].items()}]}
    back, _, _ = state_io.restore_state(payload, tmpl)
    for leaf in ("conv", "ssd"):
        got = back["segments"][0][leaf]
        assert got.dtype == tc["segments"][0][leaf].dtype
        assert torch.equal(got, tc["segments"][0][leaf])
    # the reference reads the same bits back
    jback, _, _ = jax_state_io.restore_state(
        jax_state_io.parse_state(blob, meta), jax.tree.map(jnp.zeros_like,
                                                           jc))
    ssd = np.asarray(jback["segments"][0]["ssd"])
    assert ssd.dtype == np.float32
    np.testing.assert_array_equal(ssd, tc["segments"][0]["ssd"].numpy())
    conv = np.asarray(jback["segments"][0]["conv"])
    assert np.array_equal(conv.view(np.int16),
                          tc["segments"][0]["conv"].view(torch.int16).numpy())
