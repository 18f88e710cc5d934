"""The port's Hymba hybrid (hymba-1.5b) against the JAX reference.

Every layer runs sliding-window attention over a ring KV cache and an SSM
branch in parallel; the model prepends learned meta tokens. The reduced
config (2 layers, d 128, window 16, 8 meta tokens, SSM d_state 16, chunk
16) takes the reference's params through ``from_jax_params`` and gives
the reference's logits within 1e-5 in fp32 on the CPU: a cold prefill
(meta tokens prepended, the ring wrapped), a resume past the wrap, and 8
decode steps, against ``repro.models.model.Model.forward`` and the
reference's own ``prefill(resume=True)`` and ``decode_step``. Then the
engines (sequential, streamed, batched), the edge client's cases, blobs
crossing the two packages both ways, and bf16 against the reference at 2
layers.

The reference's engines pick the wrong row on a cold prefill of a
meta-token model: they pass the text index ``S - 1`` as ``last_index``
to a sequence of ``R + S`` rows (ROADMAP Queue 3). The port picks the
last text token;
``test_cold_prefill_reads_the_last_token_where_the_reference_does_not``
asserts both. Where a reference engine's tokens stand for a correct run
here, its prompt starts with a one-token prefill and resumes the rest.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import CacheConfig as JaxCacheConfig
from repro.configs import get_config as jax_get_config
from repro.core import CacheServer as JaxCacheServer
from repro.core import EdgeClient as JaxEdgeClient
from repro.core import SimClock, SimNetwork
from repro.core.keys import model_meta as jax_model_meta
from repro.core.segments import PromptSegments as JaxSegments
from repro.core.transport import InProcTransport as JaxTransport
from repro.models import Model as JaxModel
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.config import CacheConfig
from repro_torch.configs import get_config
from repro_torch.core import state_io
from repro_torch.core.client import EdgeClient
from repro_torch.core.keys import model_meta
from repro_torch.core.segments import PromptSegments
from repro_torch.core.server import CacheServer
from repro_torch.models.model import Model
from repro_torch.models.transformer import segments_for
from repro_torch.params import from_jax_params
from repro_torch.serving.engine import BatchedEngine, InferenceEngine
from repro_torch.serving.sampler import greedy

ARCH = "hymba-1.5b"
TOL, TOL_BF16 = 1e-5, 2e-2
MAX_LEN = 96
N_NEW = 5


def _port(jp, cfg=None, dtype=torch.float32):
    m = Model(cfg or get_config(ARCH).reduced(), dtype=dtype, device="cpu",
              seed=None)
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)))
    return m


@pytest.fixture(scope="module")
def world():
    jm = JaxModel(jax_get_config(ARCH).reduced())
    jp = jm.init(jax.random.PRNGKey(1))
    return jm, jp, _port(jp)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


def _tokens(n, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(3, vocab, (1, n)).astype(
        np.int32)


def test_config_fields_param_count_and_meta_equal_the_reference():
    for jcfg, tcfg in ((jax_get_config(ARCH), get_config(ARCH)),
                       (jax_get_config(ARCH).reduced(),
                        get_config(ARCH).reduced())):
        for f in dataclasses.fields(tcfg):
            want = getattr(jcfg, f.name)
            got = getattr(tcfg, f.name)
            if dataclasses.is_dataclass(got):
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
            else:
                assert got == want, f.name
        assert tcfg.param_count() == jcfg.param_count()
        for dt in ("float32", "bfloat16"):
            assert model_meta(tcfg, dt) == jax_model_meta(jcfg, dt)
    full = get_config(ARCH)
    assert round(full.param_count() / 1e6, 1) == 1640.1
    assert (full.n_meta_tokens, full.window, full.ssm_n_heads) == \
        (128, 1024, 50)
    assert [tuple(s) for s in segments_for(full)] == [("hybrid", 32, 5504)]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_params_round_trip(dtype):
    """Every leaf of the reference's tree, one level deeper for the
    hybrid (``segments/0/hyb/attn/wq``) and ``meta`` at the top, loads
    strictly and comes back as the same bits."""
    jp = JaxModel(jax_get_config(ARCH).reduced(), dtype=dtype).init(
        jax.random.PRNGKey(2))
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    sd = from_jax_params(jax.tree.map(np.asarray, jp))
    m = Model(get_config(ARCH).reduced(), dtype=tdt, device="cpu")
    assert set(m.state_dict()) == set(sd)
    for name in ("meta", "segments.0.hyb.attn.wq", "segments.0.hyb.ssm.D",
                 "segments.0.hyb.norm_ssm", "segments.0.mlp.w_gate"):
        assert name in sd
    m.load_state_dict(sd)
    back = m.state_dict()
    for name, t in sd.items():
        assert back[name].dtype == t.dtype and torch.equal(back[name], t)
    assert m.segments[0]["hyb"]["ssm"]["A_log"].dtype == torch.float32
    again = Model(m.cfg, dtype=tdt, device="cpu", seed=None)
    again.load_state_dict(back)
    assert all(torch.equal(again.state_dict()[k], t) for k, t in sd.items())


def test_reduced_decode_step(world):
    """The hybrid row of
    ``tests/test_arch_smoke.py::test_reduced_decode_step``: an 8-token
    prefill, then a decode at 8; finite, and the reference's logits and
    cache."""
    jm, jp, m = world
    toks = _tokens(8, seed=1)
    jc = jm.init_cache(1, jm.cache_len(12))
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    c = m.init_cache(1, m.cache_len(12))
    lg, c = m.prefill({"tokens": toks}, c)
    assert lg.shape[0] == 1
    jl2, jc = jm.decode_step(jp, jc, jnp.asarray([[5]], jnp.int32), 8)
    lg2, c = m.decode_step(c, [[5]], 8)
    assert np.isfinite(lg2[..., :m.cfg.vocab].numpy()).all()
    _close(lg2, jl2)
    for name, t in (("k", c["segments"][0]["attn"]["k"]),
                    ("ssd", c["segments"][0]["ssm"]["ssd"])):
        ref = jc["segments"][0]["attn" if name == "k" else "ssm"][name]
        _close(t, ref)


def test_cold_prefill_resume_past_the_wrap_and_decode_match_the_reference(
        world):
    """20 text tokens cold (28 cache positions over a 16-slot ring), a
    6-token resume at 20 and 8 decode steps: ``forward``'s logits at each
    text position, and the reference's resume and decode."""
    jm, jp, m = world
    S = 34
    toks = _tokens(S, seed=0)
    ref = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(toks)}))
    c = m.init_cache(1, m.cache_len(MAX_LEN))
    lg, c = m.prefill({"tokens": toks[:, :20]}, c)
    _close(lg, ref[:, 19])
    jc = jm.init_cache(1, jm.cache_len(MAX_LEN))
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :20])}, jc)
    _close(c["segments"][0]["attn"]["k"], jc["segments"][0]["attn"]["k"])
    lg, c = m.prefill({"tokens": toks[:, 20:26]}, c, 20, resume=True)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, 20:26])}, jc, 20,
                        resume=True)
    _close(lg, ref[:, 25])
    _close(lg, jl)
    for i in range(26, S):
        lg, c = m.decode_step(c, toks[:, i:i + 1], i)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, i:i + 1]), i)
        _close(lg, ref[:, i])
        _close(lg, jl)
    for half, name in (("attn", "k"), ("attn", "v"), ("ssm", "conv"),
                       ("ssm", "ssd")):
        _close(c["segments"][0][half][name], jc["segments"][0][half][name])


def test_cold_prefill_reads_the_last_token_where_the_reference_does_not(
        world):
    """On a 12-token prompt with R = 8 meta tokens the reference's
    ``InferenceEngine.start`` returns ``forward``'s logits at text index
    12 - 1 - 8 = 3; the port's engine returns those of the last token."""
    jm, jp, m = world
    S, R = 12, m.cfg.n_meta_tokens
    toks = _tokens(S, seed=4)
    ref = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(toks)}))
    jst = JaxEngine(jm, jp, max_len=MAX_LEN).start(
        {"tokens": jnp.asarray(toks)})
    _close(jst.last_logits, ref[:, S - 1 - R])
    assert np.abs(np.asarray(jst.last_logits) - ref[:, S - 1]).max() > 0.1
    st = InferenceEngine(m, max_len=MAX_LEN).start({"tokens": toks})
    _close(st.last_logits, ref[:, S - 1])
    lg, _ = m.prefill({"tokens": toks}, m.init_cache(1, m.cache_len(S)),
                      last_index=S - 1)
    _close(lg, ref[:, S - 1])


def _reference_tokens(jm, jp, toks, n_new):
    """The reference's sequential engine on a correct path: one token
    cold, the rest resumed, then greedy decode."""
    eng = JaxEngine(jm, jp, max_len=MAX_LEN)
    st = eng.start({"tokens": jnp.asarray(toks[:, :1])})
    st = eng.resume({"tokens": jnp.asarray(toks[:, 1:])}, st.cache, 1)
    return [int(t) for t in eng.generate(st, n_new)[0]]


def test_engine_resume_and_streamed_resume_equal_cold(world):
    """A 30-token prompt: cold, and resumed from a restored blob of its
    first 14 tokens, monolithic and layer-streamed; tokens equal to the
    reference's."""
    jm, jp, m = world
    toks = _tokens(30, seed=5)
    eng = InferenceEngine(m, max_len=MAX_LEN)
    cold = eng.start({"tokens": toks})
    cold_logits = cold.last_logits
    want = [int(t) for t in eng.generate(cold, 8)[0]]
    assert want == _reference_tokens(jm, jp, toks, 8)
    pre = eng.start({"tokens": toks[:, :14]})
    meta = model_meta(m.cfg, "float32")
    chunks = state_io.extract_state_chunks(
        pre.cache, m.cache_len(14), meta, logits=pre.last_logits,
        chunk_layers=1)
    cache, n_eff, _ = state_io.restore_state(state_io.parse_state(
        state_io.pack_container(chunks), meta), eng.new_cache())
    assert n_eff == m.cache_len(14)
    mono = eng.resume({"tokens": toks[:, 14:]}, cache, 14)
    _close(mono.last_logits, cold_logits)
    r = state_io.ChunkedRestorer(meta)
    template = eng.new_cache()

    def groups():
        for c in chunks:
            for gid in r.feed(c):
                yield (state_io.segment_index(gid[0]), gid[1], gid[2],
                       r.group_tree(gid, template))
    streamed = eng.resume_streamed({"tokens": toks[:, 14:]}, 14, groups(),
                                   template)
    _close(streamed.last_logits, cold_logits)
    assert [int(t) for t in eng.generate(mono, 8)[0]] == want
    assert [int(t) for t in eng.generate(streamed, 8)[0]] == want


def test_batched_engine_tokens_equal_sequential_runs(world):
    """6 requests over 4 slots, exact per-row prefill (one of them past
    the ring's wrap and one resumed into its slot from a prefix state),
    rows decoding at their own positions: the port's sequential tokens,
    which are the reference's."""
    jm, jp, m = world
    prompts = [_tokens(n, seed=10 + n)[0] for n in (5, 9, 23, 12)]
    seq = InferenceEngine(m, max_len=MAX_LEN)
    want = []
    for p in prompts:
        want.append([int(t) for t in seq.generate(
            seq.start({"tokens": p[None]}), N_NEW)[0]])
    assert want[2] == _reference_tokens(jm, jp, prompts[2][None], N_NEW)
    eng = BatchedEngine(m, max_len=MAX_LEN, batch_size=4)
    assert not eng._pad_prefill
    logits = eng.prefill_slots([0, 1, 2], prompts[:3])
    pre = seq.start({"tokens": prompts[3][None, :7]})
    logits = np.concatenate([logits, eng.prefill_slot(
        3, prompts[3][7:], cache1=pre.cache, start_pos=7)])
    toks = greedy(logits)
    got = [[int(t)] for t in toks]
    for _ in range(N_NEW - 1):
        toks = greedy(eng.decode_batch(toks))
        for b in range(4):
            got[b].append(int(toks[b]))
    assert got == want
    # a recycled slot takes a fresh prompt while the others decode on
    eng.free_slot(1)
    fresh = _tokens(17, seed=3)[0]
    first = greedy(eng.prefill_slots([1], [fresh]))
    want_fresh = [int(t) for t in seq.generate(
        seq.start({"tokens": fresh[None]}), 3)[0]]
    toks[1] = first[0]
    row = [int(first[0])]
    for _ in range(2):
        toks = greedy(eng.decode_batch(toks))
        row.append(int(toks[1]))
    assert row == want_fresh


def _client(model, name, server, overlap=False):
    return EdgeClient(name, InferenceEngine(model, max_len=MAX_LEN), server,
                      CacheConfig(), overlap=overlap)


def _extending_prompts(vocab):
    """A: 40 tokens; B: A and 24 more. B's 40-token range is A's prompt."""
    toks = np.random.default_rng(11).integers(3, vocab, 64).tolist()
    return [PromptSegments.make(toks[:40], [8, 16, 24, 40]),
            PromptSegments.make(toks, [8, 16, 24, 40, 64])]


@pytest.mark.parametrize("overlap", [False, True], ids=["whole", "streamed"])
def test_cases_1_4_5_and_range_blobs_equal_cold_runs(world, overlap):
    """A misses and uploads each range's own state (ring and SSM) and
    logits; B's partial hit resumes past the wrap; the full hit adopts;
    every token list equals a cold run's."""
    _, _, m = world
    p_a, p_b = _extending_prompts(m.cfg.vocab)
    server = CacheServer(CacheConfig())
    a, b = _client(m, "a", server), _client(m, "b", server, overlap)
    cold = _client(m, "cold", CacheServer(CacheConfig()))
    r1 = a.infer(p_a, N_NEW)
    assert r1.case == 1 and len(server.store) == 4
    b.sync_catalog()
    r4 = b.infer(p_b, N_NEW, upload_on_miss=False)
    assert r4.case == 4 and r4.matched_tokens == 40
    assert r4.streamed == overlap
    r5 = b.infer(p_a, N_NEW, upload_on_miss=False)
    assert r5.case == 5
    assert r1.output_tokens == r5.output_tokens == cold.infer(
        p_a, N_NEW, upload_on_miss=False).output_tokens
    assert r4.output_tokens == cold.infer(p_b, N_NEW,
                                          upload_on_miss=False).output_tokens
    eng = InferenceEngine(m, max_len=MAX_LEN)
    toks = np.asarray(p_a.token_ids, np.int32)[None]
    for key in p_a.keys(a.meta):
        cache, n_eff, logits = state_io.restore_state(state_io.parse_state(
            server.get(key.digest), a.meta), eng.new_cache())
        want = eng.start({"tokens": toks[:, :key.n_tokens]})
        assert n_eff == m.cache_len(key.n_tokens)
        np.testing.assert_allclose(logits, want.last_logits, rtol=2 ** -11,
                                   atol=TOL)
        for half, name in (("attn", "k"), ("ssm", "ssd")):
            _close(cache["segments"][0][half][name],
                   want.cache["segments"][0][half][name])


class _Fleet:
    def __init__(self, jm, jp, m):
        self.jm, self.jp, self.m = jm, jp, m
        self.clock, self.net = SimClock(), SimNetwork()

    def jax_client(self, name, server):
        return JaxEdgeClient(name, JaxEngine(self.jm, self.jp,
                                             max_len=MAX_LEN),
                             JaxTransport(server, self.net, self.clock),
                             JaxCacheConfig())


def _jseg(p):
    return JaxSegments(p.token_ids, p.boundaries)


@pytest.mark.parametrize("overlap", [False, True], ids=["whole", "streamed"])
def test_hymba_blobs_cross_both_ways(world, overlap):
    """fp32 blobs (ring leaves and the SSM state) cross both ways. The
    port's uploads serve the reference's Cases 4 and 5 with cold tokens.
    The reference's serve the port's Case 4 with cold tokens; its full
    blob carries the logits of its faulty cold prefill (text index S - 1
    - R), so the port's Case 5 on it gives the reference's own miss
    tokens, not a cold run's."""
    jm, jp, m = world
    fleet = _Fleet(jm, jp, m)
    p_a, p_b = _extending_prompts(m.cfg.vocab)
    cold = _client(m, "cold", CacheServer(CacheConfig()))
    cold_a = cold.infer(p_a, N_NEW, upload_on_miss=False).output_tokens
    cold_b = cold.infer(p_b, N_NEW, upload_on_miss=False).output_tokens
    jserver = JaxCacheServer(JaxCacheConfig())
    ja = fleet.jax_client("ja", jserver).infer(_jseg(p_a), N_NEW)
    assert list(ja.output_tokens) != cold_a          # the reference's fault
    tserver = CacheServer(CacheConfig())
    for key, blob in jserver.store.items():
        assert state_io.is_chunked(blob)
        tserver.put(key, blob)
    tb = _client(m, "tb", tserver, overlap)
    tb.sync_catalog()
    r4 = tb.infer(p_b, N_NEW, upload_on_miss=False)
    r5 = tb.infer(p_a, N_NEW, upload_on_miss=False)
    assert (r4.case, r5.case) == (4, 5) and r4.streamed == overlap
    assert r4.output_tokens == cold_b
    assert r5.output_tokens == list(ja.output_tokens)

    tserver2, jserver2 = CacheServer(CacheConfig()), \
        JaxCacheServer(JaxCacheConfig())
    _client(m, "ta", tserver2).infer(p_a, N_NEW)
    for key, blob in tserver2.store.items():
        jserver2.put(key, blob)
    jb = fleet.jax_client("jb", jserver2)
    jb.sync_catalog()
    j4 = jb.infer(_jseg(p_b), N_NEW, upload_on_miss=False)
    j5 = jb.infer(_jseg(p_a), N_NEW, upload_on_miss=False)
    assert (j4.case, j5.case) == (4, 5)
    assert list(j4.output_tokens) == cold_b
    assert list(j5.output_tokens) == cold_a


def test_bf16_matches_the_reference_at_two_layers():
    """bf16, same params and prompt: a cold prefill past the wrap, a
    resume and 4 decode steps within 2e-2 of the reference's bf16 logits
    (the reference's resume and decode paths, whose rows are right)."""
    jcfg = jax_get_config(ARCH).reduced()
    jm = JaxModel(jcfg, dtype=jnp.bfloat16)
    jp = jm.init(jax.random.PRNGKey(3))
    m = _port(jp, dtype=torch.bfloat16)
    toks = _tokens(30, seed=7)
    jc = jm.init_cache(1, jm.cache_len(MAX_LEN))
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :1])}, jc)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, 1:22])}, jc, 1,
                        resume=True)
    c = m.init_cache(1, m.cache_len(MAX_LEN))
    m.prefill({"tokens": toks[:, :1]}, c)
    lg, c = m.prefill({"tokens": toks[:, 1:22]}, c, 1, resume=True)
    _close(lg, jl, TOL_BF16)
    for i in range(22, 26):
        lg, c = m.decode_step(c, toks[:, i:i + 1], i)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, i:i + 1]), i)
        _close(lg, jl, TOL_BF16)


def test_bf16_resume_gap_matches_the_reference():
    """bf16 at full width cut to 2 layers, same params and prompt (284
    tokens, 253 of them a restored prefix): the resumed-vs-cold max |logit|
    gap is bf16 rounding, and the port's equals the reference's within a
    factor of 2 (0.0156 / 0.0181 here; 0.0313 / 0.0352 at 4 layers: it
    grows with depth, as mamba2-780m's does, so the card's 32-layer gap
    is not a fault of the port). The reference's cold run is a one-token
    prefill and a resume (its cold prefill reads the wrong row)."""
    jcfg = jax_get_config(ARCH).replace(n_layers=2)
    jm = JaxModel(jcfg, dtype=jnp.bfloat16)
    jp = jm.init(jax.random.PRNGKey(0))
    m = _port(jp, get_config(ARCH).replace(n_layers=2), torch.bfloat16)
    toks = _tokens(284, seed=0, vocab=jcfg.vocab)
    n, V = 253, jcfg.vocab

    def ref(cut):
        c = jm.init_cache(1, jm.cache_len(512))
        _, c = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :cut])}, c)
        lg, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, cut:])}, c,
                           cut, resume=True)
        return np.asarray(lg)[:, :V]

    def port(cut):
        c = m.init_cache(1, m.cache_len(512))
        if cut:
            m.prefill({"tokens": toks[:, :cut]}, c)
        lg, _ = m.prefill({"tokens": toks[:, cut:]}, c, cut,
                          resume=cut > 0)
        return lg[:, :V].float().numpy()

    gap_ref = float(np.abs(ref(n) - ref(1)).max())
    gap_port = float(np.abs(port(n) - port(0)).max())
    assert 0 < gap_ref < 0.25 and 0 < gap_port < 0.25
    assert gap_port <= 2 * gap_ref and gap_ref <= 2 * gap_port, \
        (gap_port, gap_ref)
