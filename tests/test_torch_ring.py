"""The port's ring (sliding-window) KV caches against the JAX reference.

Mirrors ``tests/test_window_ring.py`` (ring positions, ring decode equal
to linear at window 4 and 8, a resume that wraps) and the ring case of
``tests/test_blob_pipeline.py``, on reduced dense configs with a window
and the reference's params (``from_jax_params``), fp32 on the CPU,
within 1e-5 of the reference's own ring path. The port feeds its ring to
kernels that read no ring positions: a prefill gathers the ring in
position order before the new keys (``ring_gather``), a decode reads it
unordered with ``kv_len = min(pos + 1, window)``; these tests hold both
against the reference's masks. Added: one decode step of a batch of rows
at their own positions, some past the wrap, and the batched engine's
tokens against sequential runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_batch, prefill_inputs
from repro.configs import get_config as jax_get_config
from repro.core import state_io as jax_state_io
from repro.core.keys import model_meta as jax_model_meta
from repro.models import Model as JaxModel
from repro.models.attention import ring_positions
from repro_torch.configs import get_config
from repro_torch.core import state_io
from repro_torch.core.keys import model_meta
from repro_torch.models.attention import ring_gather, ring_size
from repro_torch.models.model import Model
from repro_torch.params import from_jax_params
from repro_torch.serving.engine import BatchedEngine, InferenceEngine
from repro_torch.serving.sampler import greedy

TOL = 1e-5


def _pair(arch, window, seed):
    jcfg = jax_get_config(arch).reduced().replace(window=window)
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    m = Model(get_config(arch).reduced().replace(window=window),
              device="cpu")
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)))
    return jm, jp, m


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("size,start", [(4, 6), (4, 0), (4, 4), (4, 3),
                                        (8, 21)])
def test_ring_gather_orders_the_reference_ring_positions(size, start):
    """A ring whose slot s holds the reference's ``ring_positions(size,
    start)[s]`` gathers to the positions ``[max(0, start - size),
    start)`` in order, with the new entries after them."""
    held = np.array(ring_positions(size, start))
    leaf = torch.as_tensor(held, dtype=torch.float32).reshape(1, size, 1)
    new = torch.tensor([[[100.0], [101.0]]])
    got = ring_gather(leaf, new, start)[0, :, 0].tolist()
    live = list(range(max(0, start - size), start))
    assert got == live + [100.0, 101.0]
    assert sorted(p for p in held if p >= 0) == live


@pytest.mark.parametrize("window", [4, 8])
def test_ring_decode_equals_linear(window):
    jm, jp, m = _pair("llama3.2-1b", window, 0)
    cfg = m.cfg
    batch = make_batch(jm.cfg, B=1, S=12)
    toks = np.asarray(batch["tokens"])
    small = m.init_cache(1, 32)
    assert small["segments"][0]["k"].shape[2] == window
    assert ring_size({"k": small["segments"][0]["k"][0]}, cfg.window)
    ref_logits = np.asarray(jm.forward(jp, batch))
    jc = jm.init_cache(1, 32)
    jlg, jc = jm.prefill(jp, prefill_inputs(jm.cfg, batch, slice(0, 8)), jc)
    cache = m.init_cache(1, 32)
    lg, cache = m.prefill({"tokens": toks[:, :8]}, cache)
    _close(lg, jlg)
    np.testing.assert_allclose(lg.numpy(), ref_logits[:, 7], atol=2e-5,
                               rtol=1e-4)
    for i in range(8, 12):
        tok = toks[:, i:i + 1]
        jlg, jc = jm.decode_step(jp, jc, jnp.asarray(tok), i)
        lg, cache = m.decode_step(cache, tok, i)
        _close(lg, jlg)
        np.testing.assert_allclose(lg.numpy(), ref_logits[:, i], atol=2e-5,
                                   rtol=1e-4)
    _close(cache["segments"][0]["k"], jc["segments"][0]["k"])


def test_windowed_prefill_resume_wraps_correctly():
    """Prefill 10, resume 8 more with window 8: equals one 18-token
    windowed prefill, the ring's contents too, and the reference's."""
    jm, jp, m = _pair("qwen3-4b", 8, 1)
    batch = make_batch(jm.cfg, B=1, S=18)
    toks = np.asarray(batch["tokens"])
    jfull = jm.init_cache(1, 24)
    jref, jfull = jm.prefill(jp, prefill_inputs(jm.cfg, batch), jfull)
    full = m.init_cache(1, 24)
    ref, full = m.prefill({"tokens": toks}, full)
    c = m.init_cache(1, 24)
    _, c = m.prefill({"tokens": toks[:, :10]}, c)
    got, c = m.prefill({"tokens": toks[:, 10:]}, c, start_pos=10,
                       resume=True)
    _close(got, ref)
    _close(got, jref)
    for name in ("k", "v"):
        _close(c["segments"][0][name], full["segments"][0][name])
        _close(c["segments"][0][name], jfull["segments"][0][name])


def test_ring_rows_decode_at_their_own_positions():
    """One decode step of 3 rows at positions 5, 11 and 20 over window 8
    (one ring not full, two wrapped), positions as a ``[B]`` tensor,
    equals each row's own int-position step."""
    _, _, m = _pair("llama3.2-1b", 8, 2)
    rng = np.random.default_rng(3)
    lens = [5, 11, 20]
    pool = m.init_cache(3, 32)
    rows = []
    for b, n in enumerate(lens):
        c = m.init_cache(1, 32)
        toks = rng.integers(3, m.cfg.vocab, (1, n))
        m.prefill({"tokens": toks}, c)
        for leaf, big in (("k", "k"), ("v", "v")):
            pool["segments"][0][big][:, b] = c["segments"][0][leaf][:, 0]
        rows.append(c)
    nxt = rng.integers(3, m.cfg.vocab, (3, 1))
    pos = torch.tensor(lens, dtype=torch.int32)
    lg, pool = m.decode_step(pool, nxt, pos, kv_max=max(lens) + 1)
    for b, n in enumerate(lens):
        one, c = m.decode_step(rows[b], nxt[b:b + 1], n)
        _close(lg[b], one[0])
        _close(pool["segments"][0]["k"][:, b], c["segments"][0]["k"][:, 0])


def test_batched_engine_on_a_ring_matches_sequential_runs():
    _, _, m = _pair("llama3.2-1b", 8, 4)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(3, m.cfg.vocab, n) for n in (6, 13, 9, 21)]
    seq = InferenceEngine(m, max_len=48)
    want = []
    for p in prompts:
        st = seq.start({"tokens": p[None]})
        want.append(seq.generate(st, 6)[0].tolist())
    eng = BatchedEngine(m, max_len=48, batch_size=4)
    assert not eng._pad_prefill
    logits = eng.prefill_slots([0, 1, 2, 3], prompts)
    toks = greedy(logits)
    got = [[int(t)] for t in toks]
    for _ in range(5):
        logits = eng.decode_batch(toks)
        toks = greedy(logits)
        for b in range(4):
            got[b].append(int(toks[b]))
    assert got == want


def test_wrapped_ring_blob_is_the_reference_bytes_and_restores():
    """A wrapped ring (12 tokens, window 8) ships whole: the port's v3
    container and v2 blob are the reference's bytes for the same cache,
    quantized too, and restore to the same leaves."""
    jm, jp, m = _pair("llama3.2-1b", 8, 1)
    batch = make_batch(jm.cfg, B=1, S=12)
    meta = model_meta(m.cfg, "float32")
    assert meta == jax_model_meta(jm.cfg, "float32")
    jc = jm.init_cache(1, 24)
    _, jc = jm.prefill(jp, prefill_inputs(jm.cfg, batch), jc)
    c = m.init_cache(1, 24)
    m.prefill({"tokens": np.asarray(batch["tokens"])}, c)
    _close(c["segments"][0]["k"], jc["segments"][0]["k"])
    jc = jax.tree.map(np.asarray, jc)
    # the same cache in both packages: the reference's values
    for name in ("k", "v"):
        c["segments"][0][name].copy_(torch.from_numpy(
            np.array(jc["segments"][0][name])))
    n_eff = m.cache_len(12)
    for quantize in (False, True):
        v3 = state_io.pack_container(state_io.extract_state_chunks(
            c, n_eff, meta, quantize=quantize, codec="zlib"))
        jv3 = jax_state_io.pack_container(jax_state_io.extract_state_chunks(
            jc, n_eff, meta, quantize=quantize, codec="zlib"))
        assert v3 == jv3
        v2 = state_io.extract_state(c, n_eff, meta, quantize=quantize)
        assert v2 == jax_state_io.extract_state(jc, n_eff, meta,
                                                quantize=quantize,
                                                codec="zlib")
        c3, ne, _ = state_io.restore_state(state_io.parse_state(v3, meta),
                                           m.init_cache(1, 24))
        c2, _, _ = state_io.restore_state(state_io.parse_state(v2, meta),
                                          m.init_cache(1, 24))
        assert ne == n_eff
        for name in ("k", "v"):
            assert torch.equal(c3["segments"][0][name],
                               c2["segments"][0][name])
            if not quantize:
                assert torch.equal(c3["segments"][0][name],
                                   c["segments"][0][name])
