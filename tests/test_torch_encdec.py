"""The port's encoder-decoder (whisper-base) against the JAX reference, on
the CPU.

whisper-base's ``reduced()`` variant (2 encoder and 2 decoder layers, d
128, 4 heads over 2 kv heads of 32, 16 frames, vocab 512) with the
reference's params, its biases and layernorm scales redrawn from a numpy
seed so that each of them counts (the reference draws them as zeros and
ones). Tolerances are the reference's: 1e-5 in fp32 (the same function;
matmuls and softmax sums run in another order) and 2e-2 in bf16 (one
bf16 rounding of values of order 1, ``tests/test_kernels.py``'s bf16
tolerance).

* the config, ``param_count`` and ``model_meta``; the sinusoid; the
  parameter tree;
* ``attend_all`` (the bidirectional attention on the causal
  ``flash_prefill``) against the reference's ``attend(causal=False)``;
* ``enc_layer``, ``dec_layer_prefill`` (cold and from the cache) and
  ``dec_layer_decode`` in fp32 and bf16;
* ``Model.prefill`` cold and resumed, decode continuity after a resume,
  ``test_reduced_decode_step``'s whisper row;
* v2, quantized and ``PC3`` blobs byte for byte, restored both ways, and
  the ``dec`` chunk group of a ``PC3`` stream restored group by group;
* ``InferenceEngine`` Cases 1 / 4 / 5 against the reference's engine;
* what the port refuses, beside what the reference does there.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_batch, prefill_inputs
from repro.config import CacheConfig as JaxCacheConfig
from repro.configs import get_config as jax_get_config
from repro.core import CacheServer as JaxCacheServer
from repro.core import EdgeClient as JaxEdgeClient
from repro.core import SimClock, SimNetwork
from repro.core import sizing as jax_sizing
from repro.core import state_io as jax_state_io
from repro.core.keys import model_meta as jax_model_meta
from repro.core.segments import PromptSegments as JaxSegments
from repro.core.transport import InProcTransport as JaxTransport
from repro.launch import serve as jax_serve
from repro.models import Model as JaxModel
from repro.models import encdec as jax_ed
from repro.models.attention import attend as jax_attend
from repro.models.common import sinusoidal_positions as jax_sinusoid
from repro.serving.engine import BatchedEngine as JaxBatchedEngine
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.config import CacheConfig
from repro_torch.configs import get_config
from repro_torch.core import sizing, state_io
from repro_torch.core.client import EdgeClient
from repro_torch.core.keys import model_meta
from repro_torch.core.server import CacheServer
from repro_torch.launch import serve
from repro_torch.models import encdec as ed
from repro_torch.models.common import (add_sinusoidal, sinusoidal_positions,
                                       tree_map)
from repro_torch.models.model import Model
from repro_torch.models.transformer import layer_params
from repro_torch.params import from_jax_params
from repro_torch.serving.engine import BatchedEngine, InferenceEngine

ARCH = "whisper-base"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MAX_LEN = 32
_WORLDS = {}


def _redraw(jp, seed=7):
    """The reference's params with every bias drawn N(0, 0.1) and every
    layernorm scale 1 + N(0, 0.1), from a numpy seed, in their dtype."""
    rng = np.random.default_rng(seed)

    def f(path, leaf):
        name = path[-1].key
        if name in ("bq", "bk", "bv", "bo", "bias"):
            a = rng.normal(size=leaf.shape) * 0.1
        elif name == "scale":
            a = 1.0 + rng.normal(size=leaf.shape) * 0.1
        else:
            return leaf
        return jnp.asarray(a.astype(np.float32), leaf.dtype)
    return jax.tree_util.tree_map_with_path(f, jp)


def world(dname="float32"):
    """(reference model, its params, the port model carrying them) for the
    reduced whisper-base in ``dname``; built once a module."""
    if dname not in _WORLDS:
        jm = JaxModel(jax_get_config(ARCH).reduced(), dtype=JDT[dname])
        jp = _redraw(jm.init(jax.random.PRNGKey(1)))
        m = Model(get_config(ARCH).reduced(), dtype=TDT[dname], device="cpu",
                  seed=None)
        m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)))
        _WORLDS[dname] = (jm, jp, m)
    return _WORLDS[dname]


def _close(a, b, dname="float32"):
    a = a.float().numpy() if torch.is_tensor(a) else np.asarray(a, np.float32)
    np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=TOL[dname],
                               rtol=TOL[dname])


def _t(a, dname="float32"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(TDT[dname])


def _np_tree(tree):
    return tree_map(lambda a: np.asarray(a), tree)


def _torch_tree(jtree):
    """A reference cache as port tensors (fp32)."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)),
                    jax.tree.map(np.asarray, jtree))


def _frames(cfg, B=1, seed=0):
    """Frame embeddings as ``tests/conftest.py`` makes them."""
    return (np.random.default_rng(seed).normal(
        size=(B, cfg.encdec.n_frames, cfg.d_model)) * 0.02).astype(np.float32)


# ---------------------------------------------------------------------------
# config, positions, parameters
# ---------------------------------------------------------------------------

def test_config_param_count_sizes_and_meta_equal_the_reference():
    for tcfg, jcfg in ((get_config(ARCH), jax_get_config(ARCH)),
                       (get_config(ARCH).reduced(),
                        jax_get_config(ARCH).reduced())):
        for f in dataclasses.fields(tcfg):
            mine, ref = getattr(tcfg, f.name), getattr(jcfg, f.name)
            if dataclasses.is_dataclass(mine):
                mine, ref = dataclasses.asdict(mine), dataclasses.asdict(ref)
            assert mine == ref, f.name
        assert tcfg.dh == jcfg.dh
        assert tcfg.param_count() == jcfg.param_count()
        for dt in ("float32", "bfloat16"):
            assert model_meta(tcfg, dt) == jax_model_meta(jcfg, dt)
        for n in (1, 291):
            for dtype_bytes in (2, 4):
                assert sizing.state_bytes(tcfg, n, dtype_bytes) == \
                    jax_sizing.state_bytes(jcfg, n, dtype_bytes)
    cfg = get_config(ARCH)
    # the audio K/V: 6 layers x 1500 frames x 8 kv heads x 64 x (k, v)
    assert sizing.state_bytes_const(cfg, 4, with_logits=False) == \
        6 * 1500 * 8 * 64 * 2 * 4
    assert (cfg.encdec.n_enc_layers, cfg.encdec.n_frames,
            cfg.encdec.max_target_positions) == (6, 1500, 448)
    assert cfg.reduced().encdec.n_enc_layers == 2
    assert cfg.reduced().encdec.n_frames == 16


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 7, 447])
def test_sinusoid_matches_the_reference(offset, dname):
    tab = sinusoidal_positions(5, 64, offset)
    np.testing.assert_allclose(tab.numpy(), np.asarray(
        jax_sinusoid(5, 64, offset)), atol=1e-6, rtol=1e-6)
    x = np.random.default_rng(offset).normal(size=(2, 5, 64))
    ref = jax_ed.add_sinusoidal(jnp.asarray(x, JDT[dname]), offset)
    _close(add_sinusoidal(_t(x, dname), offset), ref, dname)


def test_state_dict_carries_every_reference_leaf():
    """The ``enc``, ``enc_ln`` and ``dec`` trees, biases and layernorm
    biases included, load strictly into a port model."""
    jm, jp, m = world()
    sd = from_jax_params(jax.tree.map(np.asarray, jp))
    assert set(sd) == set(m.state_dict())
    for name in ("enc.attn.bq", "enc.ln1.bias", "enc_ln.bias", "head",
                 "dec.cross_attn.bk", "dec.ln3.bias", "dec.self_attn.bo",
                 "final_norm.bias"):
        assert name in sd, name
    for name, t in m.state_dict().items():
        assert tuple(t.shape) == tuple(sd[name].shape), name
        assert torch.equal(t, sd[name]), name
    assert not m.supports_layer_stream and not m.has_recurrent_state


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq, sk", [(16, 16), (5, 16), (24, 16)])
def test_attend_all_is_the_reference_bidirectional_attention(sq, sk):
    """``flash_prefill`` with ``q_offset = kv_len = Sk``: every key live for
    every query, whatever ``Sq`` is against ``Sk``."""
    rng = np.random.default_rng(sq)
    q = rng.normal(size=(2, sq, 4, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, sk, 2, 32)).astype(np.float32)
            for _ in range(2))
    ref = jax_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.arange(sq), jnp.arange(sk), causal=False)
    _close(ed.attend_all(_t(q), _t(k), _t(v)), ref)


def _layer(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_enc_layer_matches_the_reference(dname):
    jm, jp, m = world(dname)
    cfg = m.cfg
    x = np.random.default_rng(1).normal(size=(2, cfg.encdec.n_frames,
                                              cfg.d_model))
    for i in range(cfg.encdec.n_enc_layers):
        ref = jax_ed.enc_layer(_layer(jp["enc"], i), jm.cfg,
                               jnp.asarray(x, JDT[dname]))
        mine = ed.enc_layer(layer_params(m.enc.tree(), i), cfg, _t(x, dname))
        _close(mine, ref, dname)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_dec_layers_prefill_resume_and_decode_match_the_reference(dname):
    """One decoder layer: a cold prefill of 10 tokens that computes and
    stores the cross K/V, a 6-token resume that reads them from the
    cache, then a decode step at 16; outputs and cache leaves against
    the reference's."""
    jm, jp, m = world(dname)
    cfg, jcfg = m.cfg, jm.cfg
    rng = np.random.default_rng(2)
    B, T = 2, 20
    x = rng.normal(size=(B, 17, cfg.d_model))
    enc = rng.normal(size=(B, cfg.encdec.n_frames, cfg.d_model))
    lp, jlp = layer_params(m.dec.tree(), 1), _layer(jp["dec"], 1)
    cache = ed.init_dec_cache(cfg, B, T, TDT[dname])
    jcache = jax_ed.init_dec_cache(jcfg, B, T, JDT[dname])
    for lo, hi, with_enc in ((0, 10, True), (10, 16, False)):
        pos = np.broadcast_to(np.arange(lo, hi), (B, hi - lo))
        jy, jcache = jax_ed.dec_layer_prefill(
            jlp, jcfg, jnp.asarray(x[:, lo:hi], JDT[dname]), jnp.asarray(pos),
            jcache, lo, enc_out=jnp.asarray(enc, JDT[dname]) if with_enc
            else None)
        y, _ = ed.dec_layer_prefill(
            lp, cfg, _t(x[:, lo:hi], dname), torch.from_numpy(pos.copy()),
            cache, lo, enc_out=_t(enc, dname) if with_enc else None)
        _close(y, jy, dname)
    jy, jcache = jax_ed.dec_layer_decode(
        jlp, jcfg, jnp.asarray(x[:, 16:17], JDT[dname]), 16, jcache)
    y, _ = ed.dec_layer_decode(lp, cfg, _t(x[:, 16:17], dname), 16, cache)
    _close(y, jy, dname)
    for name in ("cross_k", "cross_v"):
        _close(cache[name], jcache[name], dname)
    for name in ("k", "v"):
        _close(cache["self"][name][:, :17], jcache["self"][name][:, :17],
               dname)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_prefill_cold_and_resumed_match_the_reference():
    """``tests/test_prefill_resume.py``'s whisper row: a prefill of 16
    tokens, and one of 10 then a resume of 6 with no frames, against the
    reference's forward and prefill logits."""
    jm, jp, m = world()
    cfg = jm.cfg
    batch = make_batch(cfg, B=2, S=16)
    ref = np.asarray(jm.forward(jp, batch)[:, -1])
    jl, _ = jm.prefill(jp, prefill_inputs(cfg, batch),
                       jm.init_cache(2, jm.cache_len(20)))
    np.testing.assert_allclose(np.asarray(jl), ref, atol=2e-5, rtol=1e-4)
    inp = _np_tree(prefill_inputs(cfg, batch))
    tl, _ = m.prefill(inp, m.init_cache(2, m.cache_len(20)))
    _close(tl, jl)
    c = m.init_cache(2, m.cache_len(20))
    _, c = m.prefill(_np_tree(prefill_inputs(cfg, batch, slice(0, 10))), c)
    tail = _np_tree(prefill_inputs(cfg, batch, slice(10, 16)))
    del tail["frames"]
    tr, _ = m.prefill(tail, c, start_pos=10, resume=True)
    _close(tr, jl)


def test_decode_continuity_after_resume():
    """``test_decode_continuity_after_resume``'s whisper row: three greedy
    tokens from a fresh prefill of 12 and from 6 + a resume of 6 agree,
    and equal the reference's."""
    jm, jp, m = world()
    cfg = jm.cfg
    batch = make_batch(cfg, B=1, S=12)

    def decode3(start, step):
        toks, (lg, c) = [], start
        for i in range(3):
            t = np.argmax(np.asarray(lg)[:, :cfg.vocab], axis=-1)[:, None]
            toks.append(int(t[0, 0]))
            lg, c = step(c, t.astype(np.int32), 12 + i)
        return toks

    def port_step(c, t, pos):
        return m.decode_step(c, t, pos)

    def ref_step(c, t, pos):
        return jm.decode_step(jp, c, jnp.asarray(t), pos)

    out1 = m.prefill(_np_tree(prefill_inputs(cfg, batch)),
                     m.init_cache(1, 16))
    _, c2 = m.prefill(_np_tree(prefill_inputs(cfg, batch, slice(0, 6))),
                      m.init_cache(1, 16))
    out2 = m.prefill(_np_tree(prefill_inputs(cfg, batch, slice(6, 12))), c2,
                     start_pos=6, resume=True)
    jout = jm.prefill(jp, prefill_inputs(cfg, batch), jm.init_cache(1, 16))
    want = decode3(jout, ref_step)
    assert decode3(out1, port_step) == decode3(out2, port_step) == want


def test_reduced_decode_step_matches_the_reference():
    """``tests/test_arch_smoke.py::test_reduced_decode_step``'s whisper
    row: a prefill of 8 and a decode step at 8, logits against the
    reference's."""
    jm, jp, m = world()
    batch = make_batch(jm.cfg, B=1, S=8)
    inp = prefill_inputs(jm.cfg, batch)
    jl, jcache = jm.prefill(jp, inp, jm.init_cache(1, jm.cache_len(12)))
    tl, tcache = m.prefill(_np_tree(inp), m.init_cache(1, m.cache_len(12)))
    assert tl.shape == (1, jl.shape[1])
    _close(tl, jl)
    tok = np.asarray([[5]], np.int32)
    jl2, _ = jm.decode_step(jp, jcache, jnp.asarray(tok), 8)
    tl2, _ = m.decode_step(tcache, tok, 8)
    assert np.isfinite(tl2[:, :m.cfg.vocab].numpy()).all()
    _close(tl2, jl2)


def test_bf16_model_logits_match_the_reference():
    jm, jp, m = world("bfloat16")
    batch = make_batch(jm.cfg, B=1, S=12)
    inp = prefill_inputs(jm.cfg, batch)
    jl, jcache = jm.prefill(jp, inp, jm.init_cache(1, 16))
    tl, tcache = m.prefill(_np_tree(inp), m.init_cache(1, 16))
    assert tcache["dec"]["cross_k"].dtype == torch.bfloat16
    _close(tl, jl, "bfloat16")
    tok = np.asarray([[7]], np.int32)
    jl2, _ = jm.decode_step(jp, jcache, jnp.asarray(tok), 12)
    tl2, _ = m.decode_step(tcache, tok, 12)
    _close(tl2, jl2, "bfloat16")


# ---------------------------------------------------------------------------
# blobs
# ---------------------------------------------------------------------------

def _blob(pkg, cache, n, meta, logits, kind):
    if kind == "pc3":
        return pkg.pack_container(pkg.extract_state_chunks(
            cache, n, meta, logits=logits))
    return pkg.extract_state(cache, n, meta, logits=logits, codec="zlib",
                             quantize=kind == "int8")


@pytest.mark.parametrize("kind", ["v2", "int8", "pc3"])
def test_blobs_are_byte_identical_and_restore_both_ways(kind):
    """fp32 (the reference cannot write bf16): on the same cache the port
    writes the reference's bytes, the cross K/V whole and the self K/V
    cut to the prefix (int8 quantizes both). Each package restores both
    blobs and resumes the suffix with no frames: the port's logits equal
    the reference's on the same blob, and, unquantized, the cold
    prefill's."""
    jm, jp, m = world()
    cfg = m.cfg
    meta = model_meta(cfg, "float32")
    toks = np.random.default_rng(9).integers(3, cfg.vocab, (1, 24)).astype(
        np.int32)
    frames = _frames(cfg, seed=3)
    n_pre = 15
    pre = {"tokens": toks[:, :n_pre], "frames": frames}
    jl, jpre = jm.prefill(jp, pre, jm.init_cache(1, MAX_LEN))
    logits = np.asarray(jl)
    ref_blob = _blob(jax_state_io, jpre, n_pre, meta, logits, kind)
    assert _blob(state_io, _torch_tree(jpre), n_pre, meta, logits,
                 kind) == ref_blob
    if kind != "pc3":
        leaves = {d["path"]: d["shape"] for d in state_io.parse_state(
            ref_blob, meta)["leaves"]}
        assert leaves["dec/cross_k"] == [cfg.n_layers, 1, cfg.encdec.n_frames,
                                         cfg.n_kv_heads, cfg.dh]
        assert leaves["dec/self/k"] == [cfg.n_layers, 1, n_pre,
                                        cfg.n_kv_heads, cfg.dh]
    tl, tpre = m.prefill(pre, m.init_cache(1, MAX_LEN))
    cold, _ = m.prefill({"tokens": toks, "frames": frames},
                        m.init_cache(1, MAX_LEN))
    suffix = {"tokens": toks[:, n_pre:]}
    for blob in (ref_blob, _blob(state_io, tpre, n_pre, meta, tl.numpy(),
                                 kind)):
        jcache, n_eff, jlg = jax_state_io.restore_state(
            jax_state_io.parse_state(blob, meta), jm.init_cache(1, MAX_LEN))
        tcache, t_eff, tlg = state_io.restore_state(
            state_io.parse_state(blob, meta), m.init_cache(1, MAX_LEN))
        assert n_eff == t_eff == n_pre
        np.testing.assert_array_equal(tlg, jlg)
        jr, _ = jm.prefill(jp, suffix, jcache, n_pre, resume=True)
        tr, _ = m.prefill(suffix, tcache, n_pre, resume=True)
        _close(tr, jr)
        if kind != "int8":
            _close(tr, cold)


def test_pc3_dec_group_restores_group_by_group():
    """A ``PC3`` stream of an encoder-decoder has one chunk group, ``dec``,
    a layer group at a time: ``group_tree`` walks the template to it (it
    took only ``segments/<i>`` before), places each group, and gives the
    cut leaves the reference's ``group_tree`` gives."""
    jm, jp, m = world()
    cfg = m.cfg
    meta = model_meta(cfg, "float32")
    toks = np.random.default_rng(4).integers(3, cfg.vocab, (1, 11)).astype(
        np.int32)
    _, tpre = m.prefill({"tokens": toks, "frames": _frames(cfg)},
                        m.init_cache(1, MAX_LEN))
    chunks = state_io.extract_state_chunks(tpre, 11, meta)
    mine, ref = state_io.ChunkedRestorer(meta), \
        jax_state_io.ChunkedRestorer(meta)
    template = m.init_cache(1, MAX_LEN)
    jtemplate = jm.init_cache(1, MAX_LEN)
    groups = []
    for c in chunks:
        got = mine.feed(c)
        assert got == ref.feed(c)
        for gid in got:
            tree = mine.group_tree(gid, template)
            jtree = ref.group_tree(gid, jtemplate)
            for path in (("cross_k",), ("cross_v",), ("self", "k"),
                         ("self", "v")):
                a, b = tree, jtree
                for p in path:
                    a, b = a[p], b[p]
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            groups.append(gid)
    assert groups == [("dec", i, i + 1) for i in range(cfg.n_layers)]
    for name in ("cross_k", "cross_v"):
        assert torch.equal(template["dec"][name], tpre["dec"][name])
    for name in ("k", "v"):
        assert torch.equal(template["dec"]["self"][name][:, :, :11],
                           tpre["dec"]["self"][name][:, :, :11])
    with pytest.raises(state_io.ChunkError, match="not in the restore"):
        mine.group_tree(("enc", 0, 1), template)


# ---------------------------------------------------------------------------
# the engine, and what the port refuses
# ---------------------------------------------------------------------------

def test_engine_cases_1_4_5_equal_the_reference_engine():
    """Case 1: a cold start on tokens and frames (the frames pass the
    bucket padding untouched). Case 5: Case 1's blob restored and adopted.
    Case 4: a blob of two thirds of the prompt restored and the rest
    resumed with no frames. Greedy tokens equal the reference engine's,
    and Cases 4 and 5 give Case 1's."""
    jm, jp, m = world()
    cfg = m.cfg
    meta = model_meta(cfg, "float32")
    toks = np.random.default_rng(5).integers(3, cfg.vocab, (1, 21)).astype(
        np.int32)
    frames = _frames(cfg, seed=8)
    inp = {"tokens": toks, "frames": frames}
    te, je = InferenceEngine(m, MAX_LEN), JaxEngine(jm, jp, max_len=MAX_LEN)
    padded, n = te._pad_inputs(inp)
    assert n == 21 and padded["tokens"].shape == (1, 32)
    assert padded["frames"] is frames
    t1, j1 = te.start(inp), je.start(inp)
    _close(t1.last_logits, j1.last_logits)
    blob1 = state_io.extract_state(t1.cache, 21, meta, logits=t1.last_logits)
    want = np.asarray(je.generate(j1, 6))
    assert np.array_equal(te.generate(t1, 6), want)

    cache, n_eff, lg = state_io.restore_state(
        state_io.parse_state(blob1, meta), te.new_cache())
    t5 = te.adopt(cache, n_eff, lg)
    assert np.array_equal(te.generate(t5, 6), want)

    n_pre = 14
    pre = te.start({"tokens": toks[:, :n_pre], "frames": frames})
    blob = state_io.pack_container(state_io.extract_state_chunks(
        pre.cache, n_pre, meta))
    for eng in (te, je):
        pkg = state_io if eng is te else jax_state_io
        c, n_eff, _ = pkg.restore_state(pkg.parse_state(blob, meta),
                                        eng.new_cache())
        st = eng.resume({"tokens": toks[:, n_pre:]}, c, n_eff)
        assert st.pos == 21
        assert np.array_equal(np.asarray(eng.generate(st, 6)), want)


def test_the_batched_engine_refuses_an_encoder_decoder():
    """The reference's ``BatchedEngine`` builds and then fails at its first
    prefill (``KeyError: 'frames'``); the port's refuses at construction."""
    jm, jp, m = world()
    with pytest.raises(NotImplementedError, match="frames"):
        BatchedEngine(m, MAX_LEN, 2)
    jb = JaxBatchedEngine(jm, jp, max_len=MAX_LEN, batch_size=2)
    toks = np.arange(3, 11, dtype=np.int32)
    with pytest.raises(KeyError, match="frames"):
        jb.prefill_slot(0, toks)
    with pytest.raises(KeyError, match="frames"):
        jb.prefill_slots([0], [toks])


def test_resume_streamed_refuses_an_encoder_decoder_as_the_reference():
    jm, jp, m = world()
    for eng in (InferenceEngine(m, MAX_LEN), JaxEngine(jm, jp, MAX_LEN)):
        assert not eng.supports_layer_stream
        args = ({"tokens": np.arange(3, 7, dtype=np.int32)[None]}, 4, iter(()))
        if eng.model is m:
            args += (m.init_cache(1, MAX_LEN),)
        with pytest.raises(NotImplementedError, match="encdec"):
            eng.resume_streamed(*args)


def test_edge_client_refuses_an_encoder_decoder():
    """The reference's client builds and then fails at its first request:
    it hands the engine tokens alone (``KeyError: 'frames'``). The port's
    refuses at construction."""
    jm, jp, m = world()
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        EdgeClient("a", InferenceEngine(m, MAX_LEN),
                   CacheServer(CacheConfig()), CacheConfig())
    ja = JaxEdgeClient("ja", JaxEngine(jm, jp, max_len=MAX_LEN),
                       JaxTransport(JaxCacheServer(JaxCacheConfig()),
                                    SimNetwork(), SimClock()),
                       JaxCacheConfig())
    prompt = JaxSegments(list(range(3, 19)), [8, 16])
    with pytest.raises(KeyError, match="frames"):
        ja.infer(prompt, 2)


def test_serve_offers_no_encoder_decoder(monkeypatch):
    """``serve client --arch whisper-base``: the port's parser refuses it
    (its client refuses the model); the reference's parser takes it and
    its client then fails for want of frames."""
    with pytest.raises(SystemExit):
        serve.parser().parse_args(["client", "--arch", ARCH])
    assert serve.parser().parse_args(
        ["client", "--arch", "llama3.2-1b"]).arch == "llama3.2-1b"
    got = []
    monkeypatch.setattr(jax_serve, "run_client", got.append)
    monkeypatch.setattr(sys, "argv", ["serve", "client", "--arch", ARCH])
    jax_serve.main()
    assert [a.arch for a in got] == [ARCH]
