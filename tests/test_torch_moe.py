"""The port's MoE layers (granite-moe-3b-a800m, deepseek-v3-671b past its
dense layers) against the JAX reference, on the CPU.

Params come from the reference (``from_jax_params``), inputs from numpy
seeds. Tolerances: fp32 1e-5 (the same function; the matmuls and the
combine's sums run in another order), bf16 2e-2 (``tests/test_kernels.py``'s
bf16 kernel tolerance: one bf16 rounding of values of order 1). A MoE
layer's output is of order 100 on unit-scale inputs (the reference's
``dense_init`` scales the expert stacks by the expert count, not by d),
so there the tolerance is taken against the output's largest magnitude.
Routing ids are compared exactly.

* ``route``, ``moe_local`` (granite-reduced, deepseek-reduced with its
  shared expert, a padded case of 20 experts stored as 32), at one token
  and at many, in fp32 and bf16; ``moe_gemm``'s plain version against
  ``jax.lax.ragged_dot`` with empty groups;
* the reduced deepseek-v3 with one dense and one MoE layer (``moe_cut``):
  logits and greedy tokens;
* granite-reduced through the edge client (Cases 1/4/5, whole and
  streamed), its blobs and the deepseek cut's byte for byte across
  packages, and ``BatchedEngine`` against the reference's sequential
  engine (the reference's own ``BatchedEngine`` cannot run a MoE model:
  ``ragged_dot`` has no batching rule).
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
from repro.core import state_io as jax_state_io
from repro.core.keys import model_meta as jax_model_meta
from repro.core.segments import PromptSegments as JaxSegments
from repro.core.transport import InProcTransport as JaxTransport
from repro.models import Model as JaxModel
from repro.models import moe as jax_moe
from repro.serving.engine import BatchedEngine as JaxBatchedEngine
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.config import CacheConfig
from repro_torch.configs import get_config
from repro_torch.configs.deepseek_v3_671b import moe_cut
from repro_torch.core import state_io
from repro_torch.core.client import EdgeClient
from repro_torch.core.keys import model_meta
from repro_torch.core.segments import PromptSegments
from repro_torch.core.server import CacheServer
from repro_torch.kernels.moe_gemm import moe_gemm, moe_gemm_plain
from repro_torch.models import moe
from repro_torch.models.model import Model
from repro_torch.models.transformer import segments_for
from repro_torch.params import from_jax_params
from repro_torch.serving.engine import BatchedEngine, InferenceEngine
from repro_torch.serving.scheduler import Request, Scheduler

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MAX_LEN = 96
N_NEW = 5
GRANITE, DEEPSEEK = "granite-moe-3b-a800m", "deepseek-v3-671b"


def _jax_cfg(arch):
    """The reduced config: deepseek with one dense and one MoE layer and
    no MTP head (the ``replace`` that ``moe_cut`` makes)."""
    cfg = jax_get_config(arch).reduced()
    return cfg.replace(mtp=False) if arch == DEEPSEEK else cfg


def _port_cfg(arch):
    cfg = get_config(arch).reduced()
    return moe_cut(cfg, 1) if arch == DEEPSEEK else cfg


# a padded expert axis: 20 experts stored as 32, top 4
PADDED = dataclasses.replace(
    jax_get_config(GRANITE).reduced().moe, n_experts=20, top_k=4)
LAYER_CASES = {"granite": (GRANITE, None), "deepseek": (DEEPSEEK, None),
               "padded": (GRANITE, PADDED)}

_WORLDS = {}


def world(arch):
    """(reference model, its params, the port model carrying them), fp32."""
    if arch not in _WORLDS:
        jm = JaxModel(_jax_cfg(arch))
        jp = jm.init(jax.random.PRNGKey(1))
        m = Model(_port_cfg(arch), device="cpu", seed=None)
        m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)))
        _WORLDS[arch] = (jm, jp, m)
    return _WORLDS[arch]


def _close(a, b, tol=TOL["float32"]):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=tol)


def _close_scaled(a, b, tol):
    """max |a - b| within tol of max(1, max |b|)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max())


def _t(a) -> torch.Tensor:
    """A jax or numpy array (bf16 too) as a torch tensor of the same bits."""
    return from_jax_params({"x": np.asarray(a)})["x"]


def _layer(case, dtype, seed=2):
    """(reference cfg, port cfg, reference MoE params, port params) of one
    MoE layer, drawn by the reference in ``dtype``."""
    arch, mo = LAYER_CASES[case]
    jcfg, tcfg = _jax_cfg(arch), _port_cfg(arch)
    if mo is not None:
        jcfg = jcfg.replace(moe=mo)
        tcfg = tcfg.replace(moe=type(tcfg.moe)(**dataclasses.asdict(mo)))
    jp = jax_moe.init_moe(jax.random.PRNGKey(seed), jcfg, JDT[dtype])
    return jcfg, tcfg, jp, {k: _t(v) for k, v in jp.items()}


def _x(cfg, T, dtype, seed=0):
    x = np.random.default_rng(seed).normal(size=(1, T, cfg.d_model))
    x = x.astype(np.float32)
    return jnp.asarray(x, JDT[dtype]), _t(jnp.asarray(x, JDT[dtype]))


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------

def test_granite_config_and_the_deepseek_moe_cut_equal_the_reference():
    full = get_config(GRANITE)
    assert round(full.param_count() / 1e6, 1) == 3298.7
    assert moe.stored_experts(full) == 48
    assert [tuple(s) for s in segments_for(full)] == [("moe", 32, 0)]
    ds = get_config(DEEPSEEK)
    cut = moe_cut(ds, 1)
    jds = jax_get_config(DEEPSEEK)
    jcut = jds.replace(n_layers=jds.moe.first_k_dense + 1, mtp=False)
    for dt in ("float32", "bfloat16"):
        assert model_meta(cut, dt) == jax_model_meta(jcut, dt)
    assert cut.param_count() == jcut.param_count()
    assert round(cut.param_count() / 1e6, 1) == 15111.0
    assert [tuple(s) for s in segments_for(cut)] == \
        [("mla_dense", 3, 18432), ("mla_moe", 1, 0)]
    assert moe_cut(ds.reduced(), 1) == ds.reduced().replace(mtp=False)


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_init_moe_draws_the_reference_leaves_and_scales(case):
    """The same leaves, shapes and dtypes (router fp32 in a bf16 layer),
    and each leaf's spread the reference's: ``dense_init`` takes fan_in
    from the first axis, the stored-expert count for the stacks."""
    jcfg, tcfg, jp, _ = _layer(case, "bfloat16")
    mine = moe.init_moe(tcfg, torch.bfloat16,
                        torch.Generator().manual_seed(0), device="cpu")
    assert list(mine) == list(jp)
    for name, t in mine.items():
        ref = np.asarray(jp[name], np.float32)
        assert tuple(t.shape) == ref.shape, name
        assert t.dtype == (torch.float32 if name == "router"
                           else torch.bfloat16), name
        assert abs(t.float().std().item() / ref.std() - 1) < 0.1, name
    unset = moe.init_moe(tcfg, torch.bfloat16, None, device="meta")
    assert {k: tuple(v.shape) for k, v in unset.items()} == \
        {k: tuple(v.shape) for k, v in mine.items()}


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_matches_the_reference(dtype):
    """ids equal; weights and the aux loss within the dtype's tolerance."""
    jcfg, tcfg, jp, tp = _layer("padded", dtype)
    jx, tx = _x(tcfg, 37, dtype)
    jw, jids, jaux = jax_moe.route(jp, jcfg, jx[0])
    w, ids, aux = moe.route(tp, tcfg, tx[0])
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(w, jw, TOL[dtype])
    _close(aux.item(), float(jaux), TOL[dtype])
    assert moe.route(tp, tcfg, tx[0], aux=False)[2] is None


@pytest.mark.parametrize("tokens", [1, 29])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_moe_local_matches_the_reference(case, dtype, tokens):
    jcfg, tcfg, jp, tp = _layer(case, dtype)
    jx, tx = _x(tcfg, tokens, dtype, seed=tokens)
    jout, jaux = jax_moe.moe_local(jp, jcfg, jx)
    out, aux = moe.moe_forward(tp, tcfg, tx)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    _close_scaled(out.float(), jout, TOL[dtype])
    _close(aux.item(), float(jaux), TOL[dtype])


def test_dispatch_sorts_rows_by_expert_and_keeps_the_way_back():
    """Rows sorted by expert id, ties by token (the reference's stable
    argsort); offsets the groups' bounds, empty groups included; ``back``
    finds each token's rows in order of expert id."""
    T, k, E = 6, 3, 8
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(np.stack([rng.choice(7, k, replace=False)
                                     for _ in range(T)]))    # expert 7 empty
    w = torch.rand(T, k)
    xf = torch.arange(T, dtype=torch.float32)[:, None].expand(T, 4)
    d = moe.dispatch(xf, w, ids, E)
    eid = ids.reshape(-1).numpy()
    order = np.argsort(eid, kind="stable")
    np.testing.assert_array_equal(d.xs[:, 0].numpy(), order // k)
    assert d.offsets.dtype == torch.int32
    np.testing.assert_array_equal(
        d.offsets.numpy(), np.concatenate([[0], np.cumsum(
            np.bincount(eid, minlength=E))]))
    sorted_ids = np.sort(eid, kind="stable")
    for t in range(T):
        pos = d.back[t].numpy()
        assert (d.xs[pos, 0].numpy() == t).all()
        assert list(sorted_ids[pos]) == sorted(ids[t].tolist())
        np.testing.assert_array_equal(
            np.sort(d.weights[pos].numpy()), np.sort(w[t].numpy()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gemm_plain_matches_ragged_dot(dtype):
    """Empty groups at the start, in the middle and at the end (the
    padded experts), and rows past the last group, which are 0."""
    rng = np.random.default_rng(5)
    M, K, N = 40, 64, 48
    sizes = np.array([0, 7, 0, 12, 1, 0, 13, 0, 0, 0], np.int32)  # 33 rows
    xs = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(len(sizes), K, N)) / 8).astype(np.float32)
    jxs, jw = jnp.asarray(xs, JDT[dtype]), jnp.asarray(w, JDT[dtype])
    want = jax.lax.ragged_dot(jxs, jw, jnp.asarray(sizes))
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)]).astype(
        np.int32))
    got = moe_gemm(_t(jxs), _t(jw), offsets)
    assert got.dtype == TDT[dtype] and got.shape == (M, N)
    _close(got.float(), np.asarray(want, np.float32), TOL[dtype])
    assert torch.count_nonzero(got[sizes.sum():]) == 0
    torch.testing.assert_close(got, moe_gemm_plain(_t(jxs), _t(jw), offsets))


class _PodMesh:
    """A production mesh's axes (``pod``, ``data``, ``model``)."""
    mesh_dim_names = ("pod", "data", "model")

    def size(self, i=None):
        return 2 if i is None else (2, 1, 1)[i]

    def get_local_rank(self, name):
        return 0


def test_moe_forward_refuses_a_mesh():
    """A mesh with a ``pod`` axis (the reference's multi-pod production
    mesh) is refused, naming the ROADMAP item that adds it; so is a
    model built on one."""
    _, tcfg, _, tp = _layer("granite", "float32")
    with pytest.raises(NotImplementedError, match="pod.*item 11b"):
        moe.moe_forward(tp, tcfg, torch.zeros(1, 2, tcfg.d_model),
                        mesh=_PodMesh())
    with pytest.raises(NotImplementedError, match="item 11b"):
        Model(tcfg, device="cpu", seed=None, mesh=_PodMesh())


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [GRANITE, DEEPSEEK])
def test_prefill_and_decode_logits_and_tokens_match_the_reference(arch):
    """A prefill, a resume and 4 decode steps within 1e-5 of the
    reference's logits; 8 greedy tokens through the engines equal."""
    jm, jp, m = world(arch)
    toks = np.random.default_rng(6).integers(3, m.cfg.vocab, (1, 30)).astype(
        np.int32)
    jc = jm.init_cache(1, 64)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :18])}, jc)
    c = m.init_cache(1, 64)
    lg, c = m.prefill({"tokens": toks[:, :18]}, c)
    _close(lg, jl)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, 18:26])}, jc, 18,
                        resume=True)
    lg, c = m.prefill({"tokens": toks[:, 18:26]}, c, 18, resume=True)
    _close(lg, jl)
    for i in range(26, 30):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, i:i + 1]), i)
        lg, c = m.decode_step(c, toks[:, i:i + 1], i)
        _close(lg, jl)
    je, te = JaxEngine(jm, jp, max_len=MAX_LEN), InferenceEngine(m, MAX_LEN)
    jst, tst = je.start({"tokens": toks}), te.start({"tokens": toks})
    _close(tst.last_logits, jst.last_logits)
    assert np.array_equal(te.generate(tst, 8), je.generate(jst, 8))


@pytest.mark.parametrize("arch", [GRANITE, DEEPSEEK])
def test_bf16_logits_match_the_reference(arch):
    """bf16 weights and cache, same params: a prefill and 3 decode steps
    within 2e-2 of the reference's bf16 logits."""
    jm = JaxModel(_jax_cfg(arch), dtype=jnp.bfloat16)
    jp = jm.init(jax.random.PRNGKey(3))
    m = Model(_port_cfg(arch), dtype=torch.bfloat16, device="cpu", seed=None)
    sd = from_jax_params(jax.tree.map(np.asarray, jp))
    assert sd["segments.%d.moe.router" % (len(m.segment_specs) - 1)].dtype \
        == torch.float32
    m.load_state_dict(sd)
    toks = np.random.default_rng(7).integers(3, m.cfg.vocab, (1, 24)).astype(
        np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :21])},
                        jm.init_cache(1, 32))
    lg, c = m.prefill({"tokens": toks[:, :21]}, m.init_cache(1, 32))
    _close(lg, jl, TOL["bfloat16"])
    for i in range(21, 24):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, i:i + 1]), i)
        lg, c = m.decode_step(c, toks[:, i:i + 1], i)
        _close(lg, jl, TOL["bfloat16"])


# ---------------------------------------------------------------------------
# the edge client and blobs
# ---------------------------------------------------------------------------

def _client(model, name, server, overlap=False):
    return EdgeClient(name, InferenceEngine(model, max_len=MAX_LEN), server,
                      CacheConfig(), overlap=overlap)


def _jax_client(jm, jp, name, server):
    return JaxEdgeClient(name, JaxEngine(jm, jp, max_len=MAX_LEN),
                         JaxTransport(server, SimNetwork(), SimClock()),
                         JaxCacheConfig())


def _extending_prompts(vocab):
    """A: 40 tokens; B: A and 24 more."""
    toks = np.random.default_rng(11).integers(3, vocab, 64).tolist()
    return [PromptSegments.make(toks[:40], [8, 16, 24, 40]),
            PromptSegments.make(toks, [8, 16, 24, 40, 64])]


def _jseg(p):
    return JaxSegments(p.token_ids, p.boundaries)


@pytest.mark.parametrize("overlap", [False, True], ids=["whole", "streamed"])
def test_granite_cases_1_4_5_equal_cold_and_the_reference_client(overlap):
    """A misses and uploads; B's partial hit resumes (whole, or layer group
    by layer group as the chunks land) and its full hit adopts; tokens
    equal a cold run's and the reference client's on the same prompts."""
    jm, jp, m = world(GRANITE)
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
    cold_a = cold.infer(p_a, N_NEW, upload_on_miss=False).output_tokens
    cold_b = cold.infer(p_b, N_NEW, upload_on_miss=False).output_tokens
    assert r1.output_tokens == r5.output_tokens == cold_a
    assert r4.output_tokens == cold_b
    jserver = JaxCacheServer(JaxCacheConfig())
    ja = _jax_client(jm, jp, "ja", jserver)
    assert list(ja.infer(_jseg(p_a), N_NEW).output_tokens) == cold_a
    ja.sync_catalog()
    j4 = ja.infer(_jseg(p_b), N_NEW, upload_on_miss=False)
    assert j4.case == 4 and list(j4.output_tokens) == cold_b


@pytest.mark.parametrize("arch", [GRANITE, DEEPSEEK])
def test_blobs_are_byte_identical_and_restore_both_ways(arch):
    """fp32 (the reference cannot write bf16): on the same cache the port
    writes the reference's v2 blob and PC3 chunks byte for byte; each
    package restores the other's blob and resumes to its own cold
    logits."""
    jm, jp, m = world(arch)
    meta = model_meta(m.cfg, "float32")
    assert meta == jax_model_meta(jm.cfg, "float32")
    toks = np.random.default_rng(9).integers(3, m.cfg.vocab, (1, 40)).astype(
        np.int32)
    n_pre = 26
    jl, jpre = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :n_pre])},
                          jm.init_cache(1, 64))
    same = {"segments": [{k: _t(v) for k, v in seg.items()}
                         for seg in jpre["segments"]]}
    logits = np.asarray(jl)
    assert state_io.extract_state(same, n_pre, meta, logits=logits) == \
        jax_state_io.extract_state(jpre, n_pre, meta, logits=logits,
                                   codec="zlib")
    mine = state_io.extract_state_chunks(same, n_pre, meta, logits=logits)
    ref = jax_state_io.extract_state_chunks(jpre, n_pre, meta, logits=logits)
    assert mine == ref
    assert state_io.pack_container(mine) == jax_state_io.pack_container(ref)

    cold, _ = m.prefill({"tokens": toks}, m.init_cache(1, 64))
    jcold, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                          jm.init_cache(1, 64))
    tlg, tpre = m.prefill({"tokens": toks[:, :n_pre]}, m.init_cache(1, 64))
    for blob in (state_io.extract_state(tpre, n_pre, meta,
                                        logits=tlg.numpy()),
                 state_io.pack_container(state_io.extract_state_chunks(
                     tpre, n_pre, meta, logits=tlg.numpy()))):
        jcache, n_eff, _ = jax_state_io.restore_state(
            jax_state_io.parse_state(blob, meta), jm.init_cache(1, 64))
        assert n_eff == n_pre
        jr, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, n_pre:])},
                           jcache, n_pre, resume=True)
        _close(jr, jcold)
    for blob in (jax_state_io.extract_state(jpre, n_pre, meta, codec="zlib"),
                 jax_state_io.pack_container(ref)):
        tcache, n_eff, _ = state_io.restore_state(
            state_io.parse_state(blob, meta), m.init_cache(1, 64))
        assert n_eff == n_pre
        tr, _ = m.prefill({"tokens": toks[:, n_pre:]}, tcache, n_pre,
                          resume=True)
        _close(tr, cold)


# ---------------------------------------------------------------------------
# the batched engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [GRANITE, DEEPSEEK])
def test_batched_engine_gives_the_reference_sequential_tokens(arch):
    """Eight requests over four slots (all slots' rows in one MoE call a
    layer, bucket-padded prefill): the reference's sequential tokens. The
    reference's own BatchedEngine cannot vmap ``ragged_dot``."""
    jm, jp, m = world(arch)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(3, m.cfg.vocab, (n,)).astype(np.int32)
               for n in (12, 26, 9, 18, 22, 15, 11, 24)]
    je = JaxEngine(jm, jp, max_len=64)
    want = []
    for p in prompts:
        st = je.start({"tokens": p[None]})
        want.append([int(t) for t in np.asarray(je.generate(st, 5))[0]])
    sched = Scheduler(BatchedEngine(m, 64, 4))
    stats = sched.run([Request(tokens=p, max_new_tokens=5) for p in prompts])
    assert sched.engine._pad_prefill
    assert [stats[i].output_tokens for i in range(len(prompts))] == want
    with pytest.raises(NotImplementedError, match="ragged_dot"):
        JaxBatchedEngine(jm, jp, max_len=64, batch_size=2).prefill_slots(
            [0], prompts[:1])
