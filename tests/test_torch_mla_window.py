"""A windowed MLA model (``deepseek-v3-671b.reduced()`` with window 8:
a dense MLA layer and a MoE MLA layer) against the JAX reference, fp32
on the CPU, logits within 1e-5 and greedy tokens identical.

The reference's model keeps ``min(max_len, window)`` latent rows a layer
(``repro/models/transformer.py:87``) and applies the window by mask:

* a cache of ``max_len < window`` rows is linear, and one of more rows
  would be a ring of ``window``. A prompt longer than the window runs on
  a linear cache of ``max_len`` rows, as the model without a window
  builds it (``init_mla_cache``); the tests build it so in both packages:
  a cold prefill of 20 tokens, a resume at ``start_pos`` 12, 16 decode
  tokens past the window;
* ``size == window``: a ring, filled by a prefill within its first
  ``window`` positions, then decoded past its wrap;
* ``pos >= size`` with ``size != window``: the reference overwrites slot
  ``pos % size`` but reads slot ``s`` as position ``s``, so from ``pos >=
  window`` on its window masks keys the cache holds within it. That is
  the reference's fault: the port refuses a decode past a linear cache.

The ``PC3`` container of a windowed cache is the reference's byte for
byte.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import state_io as jax_state_io
from repro.core.keys import model_meta as jax_model_meta
from repro.models import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.core import state_io
from repro_torch.core.keys import model_meta
from repro_torch.models.model import Model
from repro_torch.params import from_jax_params

TOL = 1e-5
W = 8
ARCH = "deepseek-v3-671b"


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


@pytest.fixture(scope="module")
def world():
    """The reference's windowed model and params, the port's model with
    the same params, and both packages' models without the window (for
    their linear caches)."""
    jcfg = jax_get_config(ARCH).reduced().replace(window=W)
    jm = JaxModel(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(3))
    m = Model(get_config(ARCH).reduced().replace(window=W), device="cpu",
              seed=None)
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)))
    jlin = JaxModel(jcfg.replace(window=None))
    lin = Model(m.cfg.replace(window=None), device="cpu", seed=None)
    return jm, jp, m, jlin, lin


def _tokens(n, seed=0):
    cfg = jax_get_config(ARCH).reduced()
    return np.random.default_rng(seed).integers(3, cfg.vocab, (1, n)).astype(
        np.int32)


_JIT = {}


def _jdecode(jm):
    """The reference's decode step, jitted as its engine jits it (the
    position traced)."""
    if jm not in _JIT:
        _JIT[jm] = jax.jit(lambda p, c, t, pos: jm.decode_step(p, c, t, pos))
    return _JIT[jm]


def _decode_both(jm, jp, jc, m, c, first, pos, n):
    """``n`` greedy steps from token ``first`` at ``pos`` in both
    packages: the port's logits within 1e-5 of the reference's each step,
    the reference's tokens fed to both."""
    tok, toks = int(first), []
    for i in range(n):
        jl, jc = _jdecode(jm)(jp, jc, jnp.asarray([[tok]], jnp.int32),
                              jnp.int32(pos + i))
        lg, c = m.decode_step(c, np.asarray([[tok]]), pos + i)
        _close(lg, jl)
        assert int(np.argmax(lg[0])) == int(np.argmax(np.asarray(jl)[0]))
        tok = int(np.argmax(np.asarray(jl)[0]))
        toks.append(tok)
    return toks, jc, c


def test_cache_has_the_references_rows_and_meta(world):
    jm, _, m, _, _ = world
    assert model_meta(m.cfg, "float32") == jax_model_meta(jm.cfg, "float32")
    for max_len in (64, W, 6):
        c, jc = m.init_cache(1, max_len), jm.init_cache(1, max_len)
        for seg, jseg in zip(c["segments"], jc["segments"]):
            for name in ("ckv", "krope"):
                assert tuple(seg[name].shape) == jseg[name].shape
                assert seg[name].shape[2] == min(max_len, W)


def test_prefill_resume_and_decode_past_the_window_on_a_linear_cache(world):
    """A cold prefill of 20 tokens, a resume at 12 and 16 decode tokens,
    on a linear cache of 40 rows with window 8."""
    jm, jp, m, jlin, lin = world
    toks = _tokens(20)
    jc = jlin.init_cache(1, 40)
    c = lin.init_cache(1, 40)
    assert c["segments"][0]["ckv"].shape[2] == 40
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    lg, c = m.prefill({"tokens": toks}, c)
    _close(lg, jl)
    # the resume: 12 tokens cold, then 8 at start_pos 12
    jr = jlin.init_cache(1, 40)
    r = lin.init_cache(1, 40)
    _, jr = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :12])}, jr)
    m.prefill({"tokens": toks[:, :12]}, r)
    jrl, jr = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, 12:])}, jr,
                         start_pos=12, resume=True)
    rl, r = m.prefill({"tokens": toks[:, 12:]}, r, start_pos=12, resume=True)
    _close(rl, jrl)
    _close(rl, lg)
    for seg, jseg in zip(r["segments"], jr["segments"]):
        _close(seg["ckv"][:, :, :20], np.asarray(jseg["ckv"])[:, :, :20])
    first = int(np.argmax(np.asarray(jl)[0]))
    got, _, _ = _decode_both(jm, jp, jc, m, c, first, 20, 16)
    assert len(got) == 16


def test_ring_decodes_past_its_wrap(world):
    """``size == window``: a prefill of 6 tokens into the ring of 8, then
    16 decode tokens (positions 6..21, the ring wrapped twice)."""
    jm, jp, m, _, _ = world
    toks = _tokens(6, seed=1)
    jc, c = jm.init_cache(1, 64), m.init_cache(1, 64)
    assert c["segments"][0]["ckv"].shape[2] == W
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    lg, c = m.prefill({"tokens": toks}, c)
    _close(lg, jl)
    _, jc, c = _decode_both(jm, jp, jc, m, c, np.argmax(np.asarray(jl)[0]),
                            6, 16)
    for seg, jseg in zip(c["segments"], jc["segments"]):
        _close(seg["ckv"], jseg["ckv"])
        _close(seg["krope"], jseg["krope"])


def test_a_decode_past_a_linear_cache_is_the_references_fault(world):
    """``size`` 6 < window 8. The reference decodes on past slot 5: at
    positions 6 and 7 its answer is that of a ring of 6 slots (every slot
    live, the window reaching past all of them), from position 8 on it
    is not, for its window drops the slots ``s <= pos - 8`` by index,
    though they hold positions within the window. The port decodes to
    position 5 with the reference's logits and refuses position 6."""
    jm, jp, m, _, _ = world
    jring = JaxModel(jm.cfg.replace(window=6))   # the same slots as a ring
    toks = _tokens(4, seed=2)
    feed = _tokens(8, seed=4)[0]
    jc, c = jm.init_cache(1, 6), m.init_cache(1, 6)
    assert c["segments"][0]["ckv"].shape[2] == 6
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    lg, c = m.prefill({"tokens": toks}, c)
    _close(lg, jl)
    jr = jc
    gaps = {}
    for i, pos in enumerate(range(4, 12)):
        t = jnp.asarray([[int(feed[i])]], jnp.int32)
        jl, jc = _jdecode(jm)(jp, jc, t, jnp.int32(pos))
        jrl, jr = _jdecode(jring)(jp, jr, t, jnp.int32(pos))
        gaps[pos] = float(np.max(np.abs(np.asarray(jl) - np.asarray(jrl))))
        if pos < 6:
            lg, c = m.decode_step(c, np.asarray(t), pos)
            _close(lg, jl)
    assert max(gaps[p] for p in range(4, 8)) < 1e-6, gaps
    assert min(gaps[p] for p in range(8, 12)) > 1e-3, gaps
    with pytest.raises(ValueError, match="past a linear MLA cache"):
        m.decode_step(c, np.asarray([[int(feed[2])]]), 6)


def test_a_prefill_must_fit_the_cache(world):
    """A prefill past the cache's rows is refused. The reference fails on
    one longer than the cache, and clamps a resume that runs past it onto
    earlier slots (here positions 6..9 land in slots 4..7, over 4 and
    5)."""
    jm, jp, m, _, _ = world
    toks = _tokens(20, seed=5)
    with pytest.raises(ValueError, match="overflow"):
        m.prefill({"tokens": toks}, m.init_cache(1, 64))
    with pytest.raises(TypeError):
        jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.init_cache(1, 64))
    c = m.init_cache(1, 64)
    m.prefill({"tokens": toks[:, :6]}, c)
    with pytest.raises(ValueError, match="overflow"):
        m.prefill({"tokens": toks[:, 6:10]}, c, start_pos=6, resume=True)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :6])},
                       jm.init_cache(1, 64))
    _, jc2 = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, 6:10])}, jc,
                        start_pos=6, resume=True)
    before = np.asarray(jc["segments"][0]["ckv"])[0, 0]
    after = np.asarray(jc2["segments"][0]["ckv"])[0, 0]
    np.testing.assert_array_equal(after[:4], before[:4])
    assert not np.allclose(after[4:6], before[4:6])


def test_windowed_pc3_blob_is_the_reference_bytes(world):
    """The ring after a prefill of 6 and 6 decode steps (wrapped): the
    port's PC3 container and v2 blob of the reference's cache values are
    the reference's bytes, and restore to the same leaves."""
    jm, jp, m, _, _ = world
    toks = _tokens(6, seed=6)
    meta = model_meta(m.cfg, "float32")
    jc, c = jm.init_cache(1, 64), m.init_cache(1, 64)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    m.prefill({"tokens": toks}, c)
    _, jc, c = _decode_both(jm, jp, jc, m, c, np.argmax(np.asarray(jl)[0]),
                            6, 6)
    jc = jax.tree.map(np.asarray, jc)
    for seg, jseg in zip(c["segments"], jc["segments"]):
        for name in ("ckv", "krope"):
            _close(seg[name], jseg[name])
            seg[name].copy_(torch.from_numpy(np.array(jseg[name])))
    v3 = state_io.pack_container(state_io.extract_state_chunks(
        c, 12, meta, codec="zlib"))
    assert v3 == jax_state_io.pack_container(
        jax_state_io.extract_state_chunks(jc, 12, meta, codec="zlib"))
    v2 = state_io.extract_state(c, 12, meta)
    assert v2 == jax_state_io.extract_state(jc, 12, meta, codec="zlib")
    back, n, _ = state_io.restore_state(state_io.parse_state(v3, meta),
                                        m.init_cache(1, 64))
    assert n == 12
    for seg, jseg in zip(back["segments"], jc["segments"]):
        for name in ("ckv", "krope"):
            np.testing.assert_array_equal(seg[name].numpy(), jseg[name])
