"""The port's dense, VLM and MoE configs against the JAX reference.

llama3.2-1b (dh 64, GQA 4), qwen3-4b (qk-norm), yi-6b (GQA 8, untied),
nemotron-4-15b (layernorm, ungated relu²), qwen2-vl-2b (q/k/v/o
biases, M-RoPE) and granite-moe-3b-a800m (MoE layers, GQA 3): the
registry holds the reference's fields, the models'
``reduced()`` variants take the reference's params through
``from_jax_params`` and give its prefill and decode logits within 1e-5
in fp32 on the CPU (the same function; only the summation order of the
matmuls and the attention kernel differs) and its greedy tokens, and a
state blob of each new family crosses both ways.
"""
import dataclasses

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
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.configs import ARCHS, get_config, list_archs
from repro_torch.core import state_io
from repro_torch.core.keys import model_meta
from repro_torch.models.model import Model
from repro_torch.params import from_jax_params
from repro_torch.serving.engine import InferenceEngine

TOL = 1e-5
NEW = ("llama3.2-1b", "qwen3-4b", "yi-6b", "nemotron-4-15b", "qwen2-vl-2b",
       "granite-moe-3b-a800m")
# the leaves each new config adds to the parameter tree
NEW_LEAVES = {
    "llama3.2-1b": (),
    "qwen3-4b": ("segments.0.attn.q_norm", "segments.0.attn.k_norm"),
    "yi-6b": ("head",),
    "nemotron-4-15b": ("head", "final_norm.bias", "segments.0.ln1.bias",
                       "segments.0.ln2.bias"),
    "qwen2-vl-2b": ("segments.0.attn.bq", "segments.0.attn.bk",
                    "segments.0.attn.bv", "segments.0.attn.bo"),
    "granite-moe-3b-a800m": ("segments.0.moe.router", "segments.0.moe.w_up",
                             "segments.0.moe.w_gate",
                             "segments.0.moe.w_down"),
}
_WORLDS = {}


def world(arch):
    """(reference model, its params, the port model carrying them) for
    ``arch``'s reduced variant; built once a module."""
    if arch not in _WORLDS:
        jm = JaxModel(jax_get_config(arch).reduced())
        jp = jm.init(jax.random.PRNGKey(1))
        m = Model(get_config(arch).reduced(), device="cpu")
        m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)))
        _WORLDS[arch] = (jm, jp, m)
    return _WORLDS[arch]


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL,
                               rtol=TOL)


def test_registry_lists_what_the_port_runs():
    assert list_archs() == sorted(ARCHS) and len(ARCHS) == 11
    assert set(NEW) <= set(ARCHS)
    from repro.configs.registry import ARCHS as JAX_ARCHS
    assert set(JAX_ARCHS) - set(ARCHS) == {"whisper-base"}
    with pytest.raises(KeyError, match="item 9.5"):
        get_config("whisper-base")
    with pytest.raises(KeyError, match="unknown"):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch", NEW)
def test_config_fields_and_param_count_equal_the_reference(arch):
    for jcfg, tcfg in ((jax_get_config(arch), get_config(arch)),
                       (jax_get_config(arch).reduced(),
                        get_config(arch).reduced())):
        for f in dataclasses.fields(tcfg):
            mine, ref = getattr(tcfg, f.name), getattr(jcfg, f.name)
            if dataclasses.is_dataclass(mine):     # moe, ssm, mla
                mine, ref = dataclasses.asdict(mine), dataclasses.asdict(ref)
            assert mine == ref, f.name
        assert tcfg.dh == jcfg.dh
        assert tcfg.param_count() == jcfg.param_count()
        assert tcfg.active_param_count() == jcfg.active_param_count()


@pytest.mark.parametrize("arch", NEW)
def test_model_meta_bytes_equal_the_reference(arch):
    for full in (True, False):
        tcfg, jcfg = get_config(arch), jax_get_config(arch)
        if not full:
            tcfg, jcfg = tcfg.reduced(), jcfg.reduced()
        for dt in ("float32", "bfloat16"):
            assert model_meta(tcfg, dt) == jax_model_meta(jcfg, dt)
    # M-RoPE's sections are not among the key's fields: the bytes stay
    # the reference's whatever they are
    cfg = get_config(arch)
    assert model_meta(cfg.replace(mrope_sections=(1, 2, 3)), "float32") == \
        model_meta(cfg, "float32")


@pytest.mark.parametrize("arch", NEW)
def test_state_dict_carries_every_reference_leaf(arch):
    jm, jp, m = world(arch)
    sd = from_jax_params(jax.tree.map(np.asarray, jp))
    assert set(sd) == set(m.state_dict())
    for name, t in m.state_dict().items():
        assert tuple(t.shape) == tuple(sd[name].shape), name
    for name in NEW_LEAVES[arch]:
        assert name in sd, name


@pytest.mark.parametrize("arch", NEW)
def test_reduced_decode_step_matches_the_reference(arch):
    """The port's mirror of ``test_arch_smoke.py::test_reduced_decode_step``
    (a VLM's prefill from embeddings and positions), logits against the
    reference's."""
    jm, jp, m = world(arch)
    cfg = m.cfg
    batch = make_batch(jm.cfg, B=1, S=8)
    inp = prefill_inputs(jm.cfg, batch)
    jcache = jm.init_cache(1, jm.cache_len(12))
    jl, jcache = jm.prefill(jp, inp, jcache)
    tcache = m.init_cache(1, m.cache_len(12))
    tl, tcache = m.prefill(jax.tree.map(np.asarray, inp), tcache)
    assert tl.shape == (1, jl.shape[1])
    _close(tl, jl)
    tok = np.asarray([[5]], np.int32)
    jl2, _ = jm.decode_step(jp, jcache, jnp.asarray(tok), 8)
    tl2, _ = m.decode_step(tcache, tok, 8)
    assert np.isfinite(tl2[:, :cfg.vocab].numpy()).all()
    _close(tl2, jl2)


@pytest.mark.parametrize("arch", NEW)
def test_greedy_tokens_through_the_engine_equal_the_reference(arch):
    jm, jp, m = world(arch)
    toks = np.random.default_rng(3).integers(
        3, m.cfg.vocab, (1, 21)).astype(np.int32)
    je = JaxEngine(jm, jp, max_len=64)
    te = InferenceEngine(m, max_len=64)
    jst, tst = je.start({"tokens": toks}), te.start({"tokens": toks})
    _close(tst.last_logits, jst.last_logits)
    assert np.array_equal(te.generate(tst, 8), je.generate(jst, 8))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "nemotron-4-15b",
                                  "qwen2-vl-2b"])
def test_state_blob_crosses_packages_both_ways(arch):
    """One family each: dense at dh 64, dense with layernorm and relu²,
    the VLM. A blob extracted by one package restores in the other and
    resumes to the other's next token."""
    jm, jp, m = world(arch)
    meta = model_meta(m.cfg, "float32")
    assert meta == jax_model_meta(jm.cfg, "float32")
    toks = np.random.default_rng(9).integers(
        3, m.cfg.vocab, (1, 40)).astype(np.int32)
    n_pre = 26
    je, te = JaxEngine(jm, jp, max_len=96), InferenceEngine(m, max_len=96)
    # port prefill -> port blob -> reference restore and resume
    tpre = te.start({"tokens": toks[:, :n_pre]})
    payload = jax_state_io.parse_state(
        state_io.extract_state(tpre.cache, n_pre, meta), meta)
    jcache, n_eff, _ = jax_state_io.restore_state(payload, je.new_cache())
    assert n_eff == n_pre
    jr = je.resume({"tokens": toks[:, n_pre:]}, jcache, n_pre)
    # reference prefill -> reference blob -> port restore and resume
    jpre = je.start({"tokens": toks[:, :n_pre]})
    jblob = jax_state_io.extract_state(jpre.cache, n_pre, meta,
                                       codec="zlib")
    tcache, n_eff, _ = state_io.restore_state(
        state_io.parse_state(jblob, meta), te.new_cache())
    assert n_eff == n_pre
    tr = te.resume({"tokens": toks[:, n_pre:]}, tcache, n_pre)
    _close(tr.last_logits, jr.last_logits)
    assert int(np.argmax(tr.last_logits)) == int(np.argmax(jr.last_logits))
    assert np.array_equal(te.generate(tr, 4), je.generate(jr, 4))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_config_allocates_unset_and_loads_a_drawn_model(arch):
    """``Model(seed=None)`` allocates every family's parameters unset (the
    card's bf16 copy and the layer cuts are made so), and takes a drawn
    model's state dict. deepseek-v3 is cut to its dense layers (its MTP
    head is a training head); granite keeps its MoE layers."""
    from repro_torch.configs.deepseek_v3_671b import dense_cut
    cfg = get_config(arch).reduced()
    if cfg.moe.first_k_dense and cfg.uses_mla:
        cfg = dense_cut(cfg, 2)
    drawn = Model(cfg, device="cpu", seed=0)
    empty = Model(cfg, device="cpu", seed=None)
    empty.load_state_dict(drawn.state_dict())
    for name, t in empty.state_dict().items():
        assert torch.equal(t, drawn.state_dict()[name]), name
