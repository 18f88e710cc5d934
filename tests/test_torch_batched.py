"""The port's batched engine on its three families, the decode kernels'
per-row ``kv_len``, and gemma3-1b (fp32, on the CPU).

Params come from the reference with ``params.from_jax_params``; inputs
from a numpy seed. Logits agree within the reference scheduler test's
tolerances (``atol=2e-5``, ``rtol=1e-4``), tokens are identical:

* reduced gemma3-270m: ``decode_batch`` with slots at different positions
  and an inactive slot equals per-row decode; states restored from the
  port's ``PC3`` blobs adopt and resume as the sequential engine does;
* the reduced deepseek-v3 dense cut: against the reference's sequential
  engine, because the reference's ``BatchedEngine`` raises there
  (``ragged_dot`` under ``jax.vmap``; ROADMAP Queue 3);
* reduced mamba2-780m: against the port's sequential engine and the
  reference's unpadded single-row prefill (the reference's engines pad
  the recurrent state).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import metrics as jax_metrics
from repro.models import Model as JaxModel
from repro.serving.engine import BatchedEngine as JaxBatchedEngine
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.configs.deepseek_v3_671b import dense_cut
from repro_torch.core import metrics, state_io
from repro_torch.core.keys import model_meta
from repro_torch.kernels import flash_decode as decode_mod
from repro_torch.kernels.flash_decode import (arrival_counters,
                                              flash_decode_plain)
from repro_torch.kernels.flash_prefill import grid_plan
from repro_torch.kernels.mla_decode import mla_decode_plain
from repro_torch.models.model import Model
from repro_torch.params import from_jax_params
from repro_torch.serving.engine import BatchedEngine, InferenceEngine
from repro_torch.serving.scheduler import Request, Scheduler

TOL = dict(atol=2e-5, rtol=1e-4)           # tests/test_scheduler.py:45
MAX_LEN = 64


def _port(jcfg, tcfg, seed=0):
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    m = Model(tcfg, device="cpu")
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)))
    return jm, jp, m


@pytest.fixture(scope="module")
def gemma(tiny_setup):
    _, _, jparams = tiny_setup
    m = Model(get_config("gemma3-270m").reduced(), device="cpu")
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jparams)))
    return m


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab, (n,)).astype(np.int32) for n in lens]


def _sequential(engine, prompts, n_new):
    out = []
    for p in prompts:
        st = engine.start({"tokens": p[None]})
        out.append([int(t) for t in np.asarray(engine.generate(st, n_new))[0]])
    return out


def _scheduled(model, prompts, n_new, batch_size=4):
    sched = Scheduler(BatchedEngine(model, MAX_LEN, batch_size))
    stats = sched.run([Request(tokens=p, max_new_tokens=n_new)
                       for p in prompts])
    return [stats[i].output_tokens for i in range(len(prompts))], sched


# -- the decode kernels' plain versions, one kv_len a row -------------------

@pytest.mark.parametrize("window", [None, 5])
def test_plain_decode_kernels_take_one_kv_len_a_row(window):
    """A ``[B]`` kv_len (rows of 0, 1, a few and every key) equals one
    scalar call a row, in both decode kernels' plain versions."""
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    kv = torch.tensor([0, 1, 17, 40], dtype=torch.int32)
    q, k, v = t(4, 4, 32), t(4, 40, 2, 32), t(4, 40, 2, 16)
    got = flash_decode_plain(q, k, v, kv_len=kv, window=window, scale=0.3)
    ql, qr, ckv, kr = t(4, 6, 64), t(4, 6, 16), t(4, 40, 64), t(4, 40, 16)
    got_mla = mla_decode_plain(ql, qr, ckv, kr, kv_len=kv, window=window,
                               scale=0.2)
    for b, n in enumerate(kv.tolist()):
        one = flash_decode_plain(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                 kv_len=n, window=window, scale=0.3)
        torch.testing.assert_close(got[b:b + 1], one, atol=0, rtol=0)
        one = mla_decode_plain(ql[b:b + 1], qr[b:b + 1], ckv[b:b + 1],
                               kr[b:b + 1], kv_len=n, window=window,
                               scale=0.2)
        torch.testing.assert_close(got_mla[b:b + 1], one, atol=0, rtol=0)
    assert torch.count_nonzero(got[0]) == 0 == torch.count_nonzero(got_mla[0])


@pytest.mark.parametrize("window", [None, 5])
def test_plain_decode_kernels_cap_rows_at_kv_max(window):
    """As the kernels do, the plain versions read a row whose kv_len
    passes ``kv_max`` only up to ``kv_max``; a host kv_len is its own
    cap."""
    rng = np.random.default_rng(1)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    q, k, v = t(4, 4, 32), t(4, 40, 2, 32), t(4, 40, 2, 16)
    ql, qr, ckv, kr = t(4, 6, 64), t(4, 6, 16), t(4, 40, 64), t(4, 40, 16)
    lens = torch.tensor([0, 1, 17, 40], dtype=torch.int32)
    capped = torch.tensor([0, 1, 17, 20], dtype=torch.int32)
    for fn, args in ((flash_decode_plain, (q, k, v)),
                     (mla_decode_plain, (ql, qr, ckv, kr))):
        got = fn(*args, kv_len=lens, window=window, scale=0.3, kv_max=20)
        want = fn(*args, kv_len=capped, window=window, scale=0.3)
        torch.testing.assert_close(got, want, atol=0, rtol=0)
        got = fn(*args, kv_len=30, window=window, scale=0.3, kv_max=20)
        want = fn(*args, kv_len=30, window=window, scale=0.3)
        torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H, KV", [(4, 1), (128, 128)])
def test_prefill_grid_plan_takes_a_batch(dtype, H, KV):
    """The batched fresh prefill runs ``flash_prefill`` at B rows: the
    plan at both path shapes, (256, 256) with 4 heads over 1 and
    (192, 128) with 128, puts the batch on the grid's z axis."""
    one = grid_plan(dtype, 1, 512, H, KV)
    four = grid_plan(dtype, 4, 512, H, KV)
    assert four[:2] == one[:2] and four[2] == one[2][:2] + (4,)


def test_arrival_counters_are_reserved_once():
    """The counter buffer grows only when asked for more than it holds,
    never shrinks, and a smaller or equal request returns the same
    memory; a batched engine reserves its largest grid at construction."""
    dev = torch.device("cpu")
    key = decode_mod.counters_key(dev)
    assert key == (dev, 0)
    decode_mod._COUNTERS.pop(key, None)
    small = arrival_counters(dev, 8)
    assert small.numel() == 1024 and torch.count_nonzero(small) == 0
    assert arrival_counters(dev, 1024).data_ptr() == small.data_ptr()
    big = arrival_counters(dev, 5000)
    assert big.numel() == 5000 and big.data_ptr() != small.data_ptr()
    assert arrival_counters(dev, 16).data_ptr() == big.data_ptr()
    decode_mod._COUNTERS.pop(key)
    cfg = get_config("gemma3-270m").reduced().replace(n_heads=8,
                                                      n_kv_heads=8)
    m = Model(cfg, device="cpu", seed=None)
    BatchedEngine(m, 16, batch_size=200)     # 200 rows x 8 head groups
    held = decode_mod._COUNTERS[key]
    assert held.numel() == 1600
    assert arrival_counters(dev, 4 * 8).data_ptr() == held.data_ptr()


# -- reduced gemma3-270m ---------------------------------------------------

def test_decode_batch_equals_per_row_decode(gemma):
    """Three slots at positions 21, 9 and 30 and an inactive slot step
    three times; each active row equals the sequential engine's decode of
    that prompt alone."""
    prompts = _prompts(512, (21, 9, 30), seed=11)
    eng = BatchedEngine(gemma, MAX_LEN, batch_size=4)
    lg = eng.prefill_slots([0, 2, 3], prompts)
    single = InferenceEngine(gemma, MAX_LEN)
    sts = [single.start({"tokens": p[None]}) for p in prompts]
    for i, st in enumerate(sts):
        np.testing.assert_allclose(lg[i], st.last_logits[0], **TOL)
    active = np.array([True, False, True, True])
    toks = np.zeros(4, np.int32)
    for _ in range(3):
        toks[[0, 2, 3]] = [np.argmax(st.last_logits[0]) for st in sts]
        step = eng.decode_batch(toks, active)
        for row, st in zip((0, 2, 3), sts):
            want = single.decode_one(st, toks[row:row + 1, None])
            np.testing.assert_allclose(step[row], want[0], **TOL)
    assert list(eng.pos) == [24, 0, 12, 33]
    # a slot's view is the pool's memory
    view = eng.slot_cache(2)["segments"][0]["k"]
    assert view.data_ptr() == eng.cache["segments"][0]["k"][:, 2].data_ptr()


def test_adopt_and_resume_from_restored_blobs(gemma):
    """States that the port's ``PC3`` restorer brought back: a full hit
    adopted into a slot, and a 20-token prefix resumed by
    ``prefill_slot``, decode the tokens of the sequential adopt and
    resume, beside a fresh request in the same run."""
    meta = model_meta(gemma.cfg, "float32")
    single = InferenceEngine(gemma, MAX_LEN)
    p_full, p_res, p_new = _prompts(512, (30, 26, 17), seed=12)
    st = single.start({"tokens": p_full[None]})
    full_blob = state_io.pack_container(state_io.extract_state_chunks(
        st.cache, 30, meta, logits=st.last_logits))
    st = single.start({"tokens": p_res[None]})
    part_blob = state_io.pack_container(state_io.extract_state_chunks(
        st.cache, 20, meta))

    def restored(blob):
        return state_io.restore_state(state_io.parse_state(blob, meta),
                                      single.new_cache())

    cache1, n_eff, logits = restored(full_blob)
    assert n_eff == 30 and logits is not None
    want_adopt = single.generate(single.adopt(restored(full_blob)[0], 30,
                                              logits), 6)[0].tolist()
    want_resume = single.generate(single.resume(
        {"tokens": p_res[None, 20:]}, restored(part_blob)[0], 20),
        6)[0].tolist()
    want_new = _sequential(single, [p_new], 6)[0]
    sched = Scheduler(BatchedEngine(gemma, MAX_LEN, batch_size=2))
    stats = sched.run([
        Request(tokens=p_full, max_new_tokens=6, cache1=cache1,
                n_prefix=30, prefix_logits=logits),
        Request(tokens=p_res, max_new_tokens=6,
                cache1=restored(part_blob)[0], n_prefix=20),
        Request(tokens=p_new, max_new_tokens=6)])
    assert [stats[i].output_tokens for i in range(3)] == \
        [want_adopt, want_resume, want_new]


def test_serving_report_matches_the_reference():
    """The port's ``ServingReport`` of a set of request stats is the
    reference's, field for field."""
    rng = np.random.default_rng(5)
    reqs, jreqs = [], []
    for i in range(7):
        t = np.cumsum(rng.uniform(0.01, 0.5, 4))
        kw = dict(req_id=i, prompt_tokens=int(rng.integers(5, 50)),
                  output_tokens=list(range(int(rng.integers(1, 9)))),
                  submit_t=t[0], admit_t=t[1], first_token_t=t[2],
                  finish_t=t[3], finish_reason="length",
                  tenant="ab"[i % 2])
        reqs.append(metrics.RequestStats(**kw))
        jreqs.append(jax_metrics.RequestStats(**kw))
    got = metrics.ServingReport.from_requests(reqs, 2.5, shed={"a": 2})
    want = jax_metrics.ServingReport.from_requests(jreqs, 2.5,
                                                   shed={"a": 2})
    assert got.as_dict() == want.as_dict()


# -- the reduced deepseek-v3 dense cut -------------------------------------

def test_dense_mla_cut_matches_the_reference_sequential_engine():
    """Eight requests over four slots on the dense cut: the port's
    scheduler gives the reference's sequential tokens. The reference's
    own batched engine cannot run this model: its vmapped prefill traces
    the empty MoE segment, whose ``ragged_dot`` has no batching rule."""
    jcfg = jax_get_config("deepseek-v3-671b").reduced()
    jcfg = jcfg.replace(n_layers=2, mtp=False,
                        moe=dataclasses.replace(jcfg.moe, first_k_dense=2))
    jm, jp, m = _port(jcfg, dense_cut(
        get_config("deepseek-v3-671b").reduced(), 2))
    prompts = _prompts(m.cfg.vocab, (12, 26, 9, 18, 22, 15, 11, 24), seed=3)
    want = _sequential(JaxEngine(jm, jp, max_len=MAX_LEN), prompts, 5)
    got, sched = _scheduled(m, prompts, 5)
    assert got == want
    assert got == _sequential(InferenceEngine(m, MAX_LEN), prompts, 5)
    with pytest.raises(NotImplementedError, match="ragged_dot"):
        JaxBatchedEngine(jm, jp, max_len=MAX_LEN, batch_size=2
                         ).prefill_slots([0], prompts[:1])


# -- reduced mamba2-780m ---------------------------------------------------

def test_mamba2_prefills_exactly_and_matches_unpadded_runs():
    """An SSM slot is prefilled per row at its exact length (from a zero
    state, though the slot held another request's), then decoded in the
    batch: the tokens equal the port's sequential engine and the
    reference's unpadded single-row prefill and decode."""
    jm, jp, m = _port(jax_get_config("mamba2-780m").reduced(),
                      get_config("mamba2-780m").reduced())
    prompts = _prompts(m.cfg.vocab, (12, 19, 9, 15, 11), seed=4)
    got, sched = _scheduled(m, prompts, 4)
    assert not sched.engine._pad_prefill
    assert got == _sequential(InferenceEngine(m, MAX_LEN), prompts, 4)
    for p, toks in zip(prompts, got):
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(p[None])},
                            jm.init_cache(1, MAX_LEN))
        ref = []
        for i in range(4):
            ref.append(int(np.argmax(np.asarray(jl)[0])))
            jl, jc = jm.decode_step(jp, jc, jnp.asarray([[ref[-1]]],
                                                        jnp.int32),
                                    len(p) + i)
        assert toks == ref


# -- gemma3-1b -------------------------------------------------------------

def test_gemma3_1b_config_and_reduced_model_match_the_reference():
    """gemma3-1b has the reference's fields; its reduced form, with the
    reference's params, gives the reference's prefill logits (fp32, 1e-5)
    and greedy tokens."""
    jcfg, tcfg = jax_get_config("gemma3-1b"), get_config("gemma3-1b")
    for f in ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "dh", "d_ff", "vocab", "act", "gated_mlp",
              "norm", "qk_norm", "attn_bias", "rope", "rope_theta",
              "tie_embeddings", "window", "n_meta_tokens"):
        assert getattr(jcfg, f) == getattr(tcfg, f), f
    jm, jp, m = _port(jcfg.reduced(), tcfg.reduced(), seed=1)
    toks = _prompts(m.cfg.vocab, (23,), seed=9)[0][None]
    tl, _ = m.prefill({"tokens": toks}, m.init_cache(1, MAX_LEN))
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                       jm.init_cache(1, MAX_LEN))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-5)
    prompts = _prompts(m.cfg.vocab, (23, 14, 30), seed=10)
    want = _sequential(JaxEngine(jm, jp, max_len=MAX_LEN), prompts, 6)
    assert _scheduled(m, prompts, 6, batch_size=2)[0] == want
