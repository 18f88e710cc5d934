"""The port's continuous-batching scheduler against the reference's.

Mirrors the seven tests of ``tests/test_scheduler.py`` on the reduced
gemma3-270m (the reference's ``tiny_setup`` params carried over by
``params.from_jax_params``, fp32, on the CPU). Wherever the reference's
``BatchedEngine`` runs, the port's batched prefill logits and scheduler
outputs are held against it and against the port's sequential engine:
logits within the reference test's tolerances (``atol=2e-5``,
``rtol=1e-4``), tokens identical.
"""
import jax
import numpy as np
import pytest

from repro.serving.engine import BatchedEngine as JaxBatchedEngine
from repro.serving.scheduler import Request as JaxRequest
from repro.serving.scheduler import Scheduler as JaxScheduler
from repro_torch.configs import get_config
from repro_torch.models.model import Model
from repro_torch.obs.metrics import REGISTRY
from repro_torch.params import from_jax_params
from repro_torch.serving.engine import BatchedEngine, InferenceEngine
from repro_torch.serving.sampler import greedy
from repro_torch.serving.scheduler import Request, Scheduler

TOL = dict(atol=2e-5, rtol=1e-4)           # tests/test_scheduler.py:45


@pytest.fixture(scope="module")
def port(tiny_setup):
    cfg, _, jparams = tiny_setup
    m = Model(get_config("gemma3-270m").reduced(), device="cpu")
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jparams)))
    return m


@pytest.fixture(scope="module")
def batched(port):
    return BatchedEngine(port, max_len=64, batch_size=4)


@pytest.fixture(scope="module")
def single(port):
    return InferenceEngine(port, max_len=64)


@pytest.fixture(scope="module")
def jax_batched(tiny_setup):
    cfg, model, params = tiny_setup
    return JaxBatchedEngine(model, params, max_len=64, batch_size=4)


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, cfg.vocab, (n,)).astype(np.int32) for n in lens]


def _sequential(single, prompts, max_new):
    out = []
    for p in prompts:
        st = single.start({"tokens": p[None]})
        out.append(list(map(int, single.generate(st, max_new, greedy)[0])))
    return out


def _run(engine, prompts, max_new, sched_cls=Scheduler, req_cls=Request,
         **kw):
    engine.pos[:] = 0
    sched = sched_cls(engine)
    stats = sched.run([req_cls(tokens=p, max_new_tokens=max_new, **kw)
                       for p in prompts])
    return sched, stats


def test_batched_prefill_logits_match_sequential(tiny_setup, batched, single,
                                                 jax_batched):
    """Bucket-padded batched prefill rows == the port's single-engine
    prefill == the reference's batched prefill."""
    cfg = tiny_setup[0]
    prompts = _prompts(cfg, (21, 9, 30, 17), seed=1)
    batched.pos[:] = 0
    logits = batched.prefill_slots([0, 1, 2, 3], prompts)
    jax_batched.pos[:] = 0
    jlogits = jax_batched.prefill_slots([0, 1, 2, 3], prompts)
    for i, p in enumerate(prompts):
        ref = single.start({"tokens": p[None]}).last_logits
        np.testing.assert_allclose(logits[i], ref[0], **TOL)
        np.testing.assert_allclose(logits[i], jlogits[i], **TOL)
    assert list(batched.pos) == [21, 9, 30, 17] == list(jax_batched.pos)


def test_b4_token_identical_to_four_sequential_runs(tiny_setup, batched,
                                                    single, jax_batched):
    """The acceptance bar: B=4 greedy == 4 sequential runs == the
    reference's scheduler."""
    cfg = tiny_setup[0]
    prompts = _prompts(cfg, (21, 9, 30, 17), seed=2)
    ref = _sequential(single, prompts, max_new=8)
    _, stats = _run(batched, prompts, 8)
    _, jstats = _run(jax_batched, prompts, 8, JaxScheduler, JaxRequest)
    got = [stats[i].output_tokens for i in range(4)]
    assert got == ref == [jstats[i].output_tokens for i in range(4)]


def test_more_requests_than_slots_recycles(tiny_setup, batched, single,
                                           jax_batched):
    """8 requests over 4 slots: slots recycle, outputs stay exact, and
    the decode-iteration count shows batching (not serial drain)."""
    cfg = tiny_setup[0]
    prompts = _prompts(cfg, (12, 26, 9, 18, 22, 15, 11, 24), seed=3)
    ref = _sequential(single, prompts, max_new=6)
    sched, stats = _run(batched, prompts, 6)
    jsched, jstats = _run(jax_batched, prompts, 6, JaxScheduler, JaxRequest)
    assert [stats[i].output_tokens for i in range(8)] == ref
    assert [jstats[i].output_tokens for i in range(8)] == ref
    seq_steps = sum(len(o) - 1 for o in ref)
    assert sched.n_steps == jsched.n_steps < seq_steps   # genuinely batched
    assert all(s.finish_reason == "length" for s in stats.values())


def test_admission_is_fifo(tiny_setup, batched):
    cfg = tiny_setup[0]
    prompts = _prompts(cfg, (10,) * 7, seed=4)
    _, stats = _run(batched, prompts, 4)
    admits = [stats[i].admit_t for i in range(7)]
    assert admits == sorted(admits)       # FIFO admission order
    # the first batch_size requests were admitted before any later one
    assert max(admits[:4]) <= min(admits[4:])
    # later arrivals waited for a recycled slot
    assert all(stats[i].queue_wait >= 0 for i in range(7))


def _eos_case(cfg, single, index=2):
    """Prompts whose request 0 first emits some token at ``index`` of its
    sequential output: that token is the EOS the test expects the
    scheduler to stop on. (The reference test takes ``ref[0][2]`` of seed
    5's prompts, which first appears at index 1, so its scheduler rightly
    stops one token early; ROADMAP Queue 3.)"""
    for seed in range(5, 45):
        prompts = _prompts(cfg, (14, 14), seed=seed)
        ref = _sequential(single, prompts, max_new=8)
        if ref[0][index] not in ref[0][:index]:
            return prompts, ref, ref[0][index]
    raise AssertionError("no prompt seed in 5..44 gives a fresh token at "
                         f"index {index}")


def test_eos_recycles_slot_early(tiny_setup, batched, single, jax_batched):
    cfg = tiny_setup[0]
    prompts, ref, eos = _eos_case(cfg, single)
    assert ref[0].index(eos) == 2         # EOS first appears at index 2
    reqs = [dict(tokens=prompts[0], max_new_tokens=8, eos_id=eos),
            dict(tokens=prompts[1], max_new_tokens=8)]
    batched.pos[:] = 0
    stats = Scheduler(batched).run([Request(**r) for r in reqs])
    jax_batched.pos[:] = 0
    jstats = JaxScheduler(jax_batched).run([JaxRequest(**r) for r in reqs])
    for st in (stats, jstats):
        assert st[0].output_tokens == ref[0][:3]     # stopped at EOS
        assert st[0].finish_reason == "eos"
        assert st[1].output_tokens == ref[1]         # unaffected neighbour
        assert st[1].finish_reason == "length"


def test_decode_logits_match_sequential(tiny_setup, batched, single,
                                        jax_batched):
    """Per-slot decode (positions read from device memory) == the port's
    scalar-position single decode and the reference's vmapped decode,
    step by step."""
    cfg = tiny_setup[0]
    prompts = _prompts(cfg, (13, 27), seed=6)
    refs = []
    for p in prompts:
        st = single.start({"tokens": p[None]})
        logits = [st.last_logits[0]]
        tok = np.argmax(logits[-1])[None]
        for _ in range(3):
            logits.append(single.decode_one(st, tok[:, None])[0])
            tok = np.argmax(logits[-1])[None]
        refs.append(logits)
    active = np.array([True, True, False, False])
    got = {}
    for name, eng in (("port", batched), ("reference", jax_batched)):
        eng.pos[:] = 0
        lg = eng.prefill_slots([0, 1], prompts)
        rows = [[lg[0]], [lg[1]]]
        toks = np.zeros(4, np.int32)
        for _ in range(3):
            toks[:2] = [np.argmax(rows[0][-1]), np.argmax(rows[1][-1])]
            step = eng.decode_batch(toks, active)
            rows[0].append(step[0])
            rows[1].append(step[1])
        got[name] = rows
    for i in range(2):
        for a, b, c in zip(got["port"][i], refs[i], got["reference"][i]):
            np.testing.assert_allclose(a, b, **TOL)
            np.testing.assert_allclose(a, c, **TOL)


def test_report_percentiles(tiny_setup, batched):
    cfg = tiny_setup[0]
    prompts = _prompts(cfg, (8, 8, 8), seed=7)
    done = REGISTRY.counter("sched_requests_total", labelnames=("reason",))
    n0 = done.labels(reason="length").get()
    waits = REGISTRY.histogram("sched_queue_wait_seconds")
    w0 = waits.snapshot()["count"]
    sched, _ = _run(batched, prompts, 3)
    rep = sched.report()
    assert rep.n_requests == 3
    assert rep.total_output_tokens == 9
    assert rep.throughput_tok_s > 0
    assert 0 <= rep.ttft_p50 <= rep.ttft_p90 <= rep.ttft_p99
    assert rep.latency_p50 <= rep.latency_p99
    # the scheduler's two metrics saw the three requests
    assert done.labels(reason="length").get() == n0 + 3
    assert waits.snapshot()["count"] == w0 + 3
