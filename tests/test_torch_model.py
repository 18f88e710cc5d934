"""The port's dense model and engine against the JAX reference.

The reference's ``tiny_setup`` params (reduced gemma3-270m) are carried
into the port with ``params.from_jax_params``; both run in fp32 on the
CPU. Logits agree within 1e-5 (the same fp32 function; only the
summation order of the matmuls and the attention kernel differs) and
greedy tokens are identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.models.model import Model
from repro_torch.params import from_jax_params
from repro_torch.serving.engine import InferenceEngine

TOL = 1e-5


def port_model(jax_params):
    m = Model(get_config("gemma3-270m").reduced(), device="cpu")
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jax_params)))
    return m


@pytest.fixture(scope="module")
def both(tiny_setup):
    cfg, jmodel, jparams = tiny_setup
    return cfg, jmodel, jparams, port_model(jparams)


def _tokens(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(
        3, cfg.vocab, (1, n)).astype(np.int32)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL,
                               rtol=TOL)


def test_config_matches_reference(tiny_setup):
    from repro.configs import get_config as jax_get_config
    for jcfg, tcfg in ((jax_get_config("gemma3-270m"),
                        get_config("gemma3-270m")),
                       (tiny_setup[0], get_config("gemma3-270m").reduced())):
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "dh", "d_ff", "vocab", "act", "gated_mlp",
                  "norm", "qk_norm", "attn_bias", "rope", "rope_theta",
                  "tie_embeddings", "window", "n_meta_tokens"):
            assert getattr(jcfg, f) == getattr(tcfg, f), f


def test_state_dict_covers_every_reference_leaf(both):
    _, _, jparams, model = both
    sd = from_jax_params(jax.tree.map(np.asarray, jparams))
    assert set(sd) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert tuple(t.shape) == tuple(sd[name].shape), name


def test_cold_resume_and_decode_logits_match(both):
    cfg, jm, jp, m = both
    prefill = jax.jit(jm.prefill, static_argnames="resume")
    decode = jax.jit(jm.decode_step)
    toks = _tokens(cfg, 40)
    jc, tc = jm.init_cache(1, 128), m.init_cache(1, 128)
    jl, jc = prefill(jp, {"tokens": jnp.asarray(toks[:, :29])}, jc, 0)
    tl, tc = m.prefill({"tokens": toks[:, :29]}, tc, 0)
    _close(tl, jl)                                 # cold prefill
    jl, jc = prefill(jp, {"tokens": jnp.asarray(toks[:, 29:])}, jc, 29,
                     resume=True)
    tl, tc = m.prefill({"tokens": toks[:, 29:]}, tc, 29, resume=True)
    _close(tl, jl)                                 # resume at start_pos > 0
    tok = int(np.argmax(np.asarray(jl)[0]))
    for i in range(8):                             # 8 decode steps
        jl, jc = decode(jp, jc, jnp.asarray([[tok]], jnp.int32), 40 + i)
        tl, tc = m.decode_step(tc, np.array([[tok]]), 40 + i)
        _close(tl, jl)
        tok = int(np.argmax(np.asarray(jl)[0]))
    for leaf in ("k", "v"):
        np.testing.assert_allclose(tc["segments"][0][leaf].numpy(),
                                   np.asarray(jc["segments"][0][leaf]),
                                   atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("n,split", [(37, 21), (64, 16), (100, 64)])
def test_engine_padding_parity(both, n, split):
    """start/resume on lengths that are not buckets: padded the same way,
    same last logits, same greedy tokens."""
    cfg, jm, jp, m = both
    toks = _tokens(cfg, n, seed=n)
    je, te = JaxEngine(jm, jp, max_len=256), InferenceEngine(m, max_len=256)
    jpad, jn = je._pad_inputs({"tokens": toks})
    tpad, tn = te._pad_inputs({"tokens": toks})
    assert jn == tn and np.array_equal(np.asarray(jpad["tokens"]),
                                       tpad["tokens"])
    js, ts = je.start({"tokens": toks}), te.start({"tokens": toks})
    _close(ts.last_logits, js.last_logits)
    assert ts.pos == js.pos == n
    jout = je.generate(js, 8)
    tout = te.generate(ts, 8)
    assert np.array_equal(jout, tout)
    # resume from a prefix, also on non-bucket lengths
    jpre = je.start({"tokens": toks[:, :split]})
    tpre = te.start({"tokens": toks[:, :split]})
    jr = je.resume({"tokens": toks[:, split:]}, jpre.cache, split)
    tr = te.resume({"tokens": toks[:, split:]}, tpre.cache, split)
    _close(tr.last_logits, jr.last_logits)
    assert np.array_equal(je.generate(jr, 8), te.generate(tr, 8))


def test_resume_near_the_end_of_the_cache(both):
    """A resume whose padded bucket would run past the cache: the port caps
    the bucket at the room left, so the result equals a cold prefill of the
    whole prompt (the reference's engine does not; ROADMAP Queue 3)."""
    cfg, jm, jp, m = both
    toks = _tokens(cfg, 60, seed=1)
    je, te = JaxEngine(jm, jp, max_len=64), InferenceEngine(m, max_len=64)
    cold = je.start({"tokens": toks})
    pre = te.start({"tokens": toks[:, :50]})
    res = te.resume({"tokens": toks[:, 50:]}, pre.cache, 50)
    _close(res.last_logits, cold.last_logits)
    with pytest.raises(ValueError, match="do not fit"):
        te.resume({"tokens": toks[:, 40:]}, pre.cache, 50)


def test_bf16_model_runs_and_tracks_fp32(both):
    """The serving dtype: a bf16 copy of the same params gives finite
    logits close to fp32 (bf16 weights, activations and cache: ~3
    significant digits, so a loose bound)."""
    cfg, _, jp, m = both
    m16 = Model(get_config("gemma3-270m").reduced(), dtype=torch.bfloat16,
                device="cpu")
    m16.load_state_dict(m.state_dict())
    toks = _tokens(cfg, 24, seed=4)
    l32, _ = m.prefill({"tokens": toks}, m.init_cache(1, 32), 0)
    l16, c16 = m16.prefill({"tokens": toks}, m16.init_cache(1, 32), 0)
    assert c16["segments"][0]["k"].dtype == torch.bfloat16
    assert torch.isfinite(l16).all()
    assert (l16 - l32).abs().max() < 0.05
