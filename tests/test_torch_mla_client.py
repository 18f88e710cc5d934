"""The edge client and state blobs on MLA: deepseek-v3-671b cut to its
dense MLA layers (reduced widths, MLA widths full, fp32, on the CPU).

The cut leaves an empty MoE segment, whose cache leaves have a zero
layer axis. The reference cannot serialize such a leaf
(``core/state_io.py::_buffers``: ``memoryview`` of an array with a zero
in its shape raises), so its own client cannot upload this model. The
port writes the empty leaves as empty buffers, and the reference reads
them back. The port's cases are therefore held against the reference
``Model``'s greedy tokens, not against the reference client.
"""
import dataclasses

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
from repro_torch.configs.deepseek_v3_671b import dense_cut
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
N_NEW = 4


@pytest.fixture(scope="module")
def world():
    jcfg = jax_get_config("deepseek-v3-671b").reduced()
    jcfg = jcfg.replace(n_layers=2, mtp=False,
                        moe=dataclasses.replace(jcfg.moe, first_k_dense=2))
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    model = Model(dense_cut(get_config("deepseek-v3-671b").reduced(), 2),
                  device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)))
    gen = mmlu.MMLUGenerator(WordHashTokenizer(model.cfg.vocab), n_shot=2)
    return jm, jp, model, gen


def _client(model, name, server):
    return EdgeClient(name, InferenceEngine(model, max_len=MAX_LEN), server,
                      CacheConfig())


def _tokens(prompt):
    return np.asarray(prompt.token_ids, np.int32)[None]


def _reference_greedy(jm, jp, tokens, n=N_NEW):
    """The reference Model's unpadded prefill and greedy decode."""
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens)},
                        jm.init_cache(1, MAX_LEN))
    out = []
    for i in range(n):
        t = int(np.argmax(np.asarray(jl)[0]))
        out.append(t)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray([[t]], jnp.int32),
                                tokens.shape[1] + i)
    return out


def test_cases_and_false_positive_give_the_reference_tokens(world):
    jm, jp, model, gen = world
    server = CacheServer(CacheConfig())
    a, b = _client(model, "a", server), _client(model, "b", server)
    p_a, p_b, p_c = (gen.prompt("astronomy", 0).segments,
                     gen.prompt("astronomy", 1).segments,
                     gen.prompt("virology", 7).segments)
    r1 = a.infer(p_a, max_new_tokens=N_NEW)
    assert r1.case == 1 and r1.blob_bytes_up > 0
    b.sync_catalog()
    r4 = b.infer(p_b, max_new_tokens=N_NEW)
    assert r4.case == 4 and 0 < r4.matched_tokens < r4.prompt_tokens
    assert r4.blob_bytes_down > 0
    r5 = b.infer(p_a, max_new_tokens=N_NEW)
    assert r5.case == 5 and r5.timings["prefill_s"] == 0.0
    poisoned = _client(model, "p", server)
    for key in p_c.keys(poisoned.meta):
        poisoned.catalog.register(key.digest)
    rfp = poisoned.infer(p_c, max_new_tokens=N_NEW, upload_on_miss=False)
    assert rfp.case == 1 and rfp.false_positive and rfp.blob_bytes_down == 0
    ref_a = _reference_greedy(jm, jp, _tokens(p_a))
    assert r1.output_tokens == r5.output_tokens == ref_a
    assert r4.output_tokens == _reference_greedy(jm, jp, _tokens(p_b))
    assert rfp.output_tokens == _reference_greedy(jm, jp, _tokens(p_c))


def test_range_blobs_are_cut_latents_with_empty_moe_leaves(world):
    """Every range blob holds the latent cache cut to its range, the
    empty segment's leaves as empty buffers, and logits on the full
    prompt's range only; resuming B from a shared range gives B's cold
    logits."""
    _, _, model, gen = world
    server = CacheServer(CacheConfig())
    a = _client(model, "a", server)
    p_a, p_b = (gen.prompt("nutrition", i).segments for i in (0, 1))
    a.infer(p_a, max_new_tokens=2)
    toks_a, toks_b = _tokens(p_a), _tokens(p_b)
    eng = InferenceEngine(model, max_len=MAX_LEN)
    cold_b, _ = model.prefill({"tokens": toks_b},
                              model.init_cache(1, MAX_LEN))
    resumed = 0
    for key in p_a.keys(a.meta):
        blob = server.get(key.digest)
        assert state_io.is_chunked(blob)
        payload = state_io.parse_state(blob, a.meta)
        pieces = _pieces(payload)
        n = key.n_tokens
        for leaf, w in (("ckv", 512), ("krope", 64)):
            # the layers' latents, cut to n positions in bands
            got = pieces[f"segments/0/{leaf}"]
            for lo in (0, 1):
                bands = sorted((off, shape) for glo, _, off, shape in got
                               if glo == lo)
                assert [off for off, _ in bands] == \
                    [0] + list(np.cumsum([s[2] for _, s in bands])[:-1])
                assert sum(s[2] for _, s in bands) == n
                assert all(s[:2] == [1, 1] and s[3] == w for _, s in bands)
            # the empty segment: one empty piece in a lo = hi = 0 group
            (lo, hi, off, shape), = pieces[f"segments/1/{leaf}"]
            assert (lo, hi, off) == (0, 0, 0) and shape[0] == 0 \
                and shape[3] == w
        assert (payload["logits"] is not None) == (n == toks_a.shape[1])
        cache, n_eff, _ = state_io.restore_state(payload, eng.new_cache())
        assert n_eff == n
        if n < toks_b.shape[1] and \
                np.array_equal(toks_a[:, :n], toks_b[:, :n]):
            res = eng.resume({"tokens": toks_b[:, n:]}, cache, n)
            np.testing.assert_allclose(res.last_logits, cold_b.numpy(),
                                       atol=TOL, rtol=TOL)
            resumed += 1
    assert resumed > 0


def _pieces(payload):
    """path -> [(lo, hi, off, shape)] of a PC3 payload's stored pieces."""
    out = {}
    for man in payload["_restorer"].header["chunks"]:
        for ent in man["pieces"]:
            out.setdefault(ent["path"], []).append(
                (man["lo"], man["hi"], ent["off"], ent["shape"]))
    return out


def test_port_blob_of_the_cut_resumes_in_the_reference(world):
    """Port prefill -> PC3 container (its empty segment as one lo = hi = 0
    chunk of empty pieces), and the v2 blob too -> the reference's
    parse_state + restore_state -> the reference's resume equals the
    port's cold prefill. The reference's v2 writer cannot write this
    blob, and it cannot restore the PC3 blob it writes itself."""
    jm, jp, model, _ = world
    meta = model_meta(model.cfg, "float32")
    toks = np.random.default_rng(2).integers(3, 512, (1, 40)).astype(
        np.int32)
    lg, pre = model.prefill({"tokens": toks[:, :25]},
                            model.init_cache(1, 64))
    cold, _ = model.prefill({"tokens": toks}, model.init_cache(1, 64))
    pc3 = state_io.pack_container(state_io.extract_state_chunks(
        pre, 25, meta, logits=lg.numpy()))
    v2 = state_io.extract_state(pre, 25, meta, logits=lg.numpy())
    for blob in (pc3, v2):
        jcache, n_eff, jlogits = jax_state_io.restore_state(
            jax_state_io.parse_state(blob, meta), jm.init_cache(1, 64))
        assert n_eff == 25
        np.testing.assert_allclose(jlogits, lg.numpy(), rtol=2 ** -11,
                                   atol=TOL)
        assert jcache["segments"][1]["ckv"].shape == (0, 1, 64, 512)
        jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, 25:])},
                           jcache, 25, resume=True)
        np.testing.assert_allclose(cold.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
    # the reference's own writers: v2 fails on the zero-size leaves; PC3
    # writes no chunk for them, and its reader then refuses the blob
    jpre = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :25])},
                      jm.init_cache(1, 64))[1]
    with pytest.raises((TypeError, ValueError)):
        jax_state_io.extract_state(jpre, 25, meta, codec="zlib")
    jpc3 = jax_state_io.pack_container(jax_state_io.extract_state_chunks(
        jpre, 25, meta))
    with pytest.raises(jax_state_io.ChunkError, match="missing leaves"):
        jax_state_io.restore_state(jax_state_io.parse_state(jpc3, meta),
                                   jm.init_cache(1, 64))
    # on the same cache, every chunk but the empty segment's is the
    # reference's, byte for byte, and that one comes last
    same = {"segments": [{k: torch.from_numpy(np.array(v))
                          for k, v in seg.items()}
                         for seg in jpre["segments"]]}
    mine = state_io.extract_state_chunks(same, 25, meta)
    ref = jax_state_io.extract_state_chunks(jpre, 25, meta)
    assert mine[1:-1] == ref[1:]
    mans = state_io.parse_state(state_io.pack_container(mine), meta)[
        "_restorer"].header["chunks"]
    assert mans[:-1] == jax_state_io.parse_state(
        jax_state_io.pack_container(ref), meta)["_restorer"].header["chunks"]
    assert (mans[-1]["seg"], mans[-1]["lo"], mans[-1]["hi"]) == \
        ("segments/1", 0, 0)


def test_bf16_blob_of_the_cut_reads_back_bit_for_bit(world):
    """A bf16 latent cache with its empty segment, as a v2 blob and as a
    PC3 container: the port and the reference read the same bits back."""
    jm, _, model, _ = world
    cfg = model.cfg
    template = Model(cfg, dtype=torch.bfloat16, device="cpu",
                     seed=None).init_cache(1, 16)
    rng = np.random.default_rng(3)
    for seg in template["segments"]:
        for t in seg.values():
            t.copy_(torch.from_numpy(
                rng.normal(size=tuple(t.shape)).astype(np.float32)))
    meta = model_meta(cfg, "bfloat16")
    for blob in (state_io.extract_state(template, 9, meta),
                 state_io.pack_container(state_io.extract_state_chunks(
                     template, 9, meta))):
        fresh = Model(cfg, dtype=torch.bfloat16, device="cpu",
                      seed=None).init_cache(1, 16)
        back, _, _ = state_io.restore_state(
            state_io.parse_state(blob, meta), fresh)
        jback, _, _ = jax_state_io.restore_state(
            jax_state_io.parse_state(blob, meta),
            jm.init_cache(1, 16, dtype=jnp.bfloat16))
        for si, seg in enumerate(template["segments"]):
            for leaf, t in seg.items():
                got = back["segments"][si][leaf]
                assert got.dtype == torch.bfloat16
                assert torch.equal(got[:, :, :9], t[:, :, :9])
                assert torch.count_nonzero(got[:, :, 9:]) == 0
                j = np.asarray(jback["segments"][si][leaf])
                assert j.shape == tuple(t.shape)
                np.testing.assert_array_equal(
                    j[:, :, :9].view(np.int16),
                    t[:, :, :9].contiguous().view(torch.int16).numpy())
