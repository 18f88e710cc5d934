"""M-RoPE (qwen2-vl) and the VLM serving path in the port.

Mirrors of ``tests/test_mrope_vlm.py``'s three tests on the port, then
the port against the reference on the same inputs: ``apply_mrope``
within 1e-6 (the same fp32 arithmetic), and the reduced qwen2-vl-2b's
logits from embeddings and image positions within 1e-5 (the summation
order of the matmuls and the attention kernel differs). Inputs come from
numpy seeds; params cross with ``from_jax_params``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from hypo_compat import given, settings, st

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models.common import apply_mrope as jax_apply_mrope
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.models.attention import decode_positions
from repro_torch.models.common import apply_mrope, apply_rope, mrope_band
from repro_torch.models.model import Model
from repro_torch.params import from_jax_params
from repro_torch.serving.engine import BatchedEngine, InferenceEngine

ATOL, RTOL = 2e-5, 1e-4        # tests/test_mrope_vlm.py's round-trip bound


@pytest.fixture(scope="module")
def vlm():
    """The reduced qwen2-vl-2b in both packages, the same params."""
    jm = JaxModel(jax_get_config("qwen2-vl-2b").reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    m = Model(get_config("qwen2-vl-2b").reduced(), device="cpu")
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)))
    return jm, jp, m


def _image_inputs(cfg, S=16, B=1):
    """Stub patch embeddings; patches at 4..7 span a 2x2 grid in height
    and width, their temporal index each its own position (``pos_t =
    arange(S)``, as in tests/test_mrope_vlm.py, whose comment says they
    share one; tests/test_torch_vlm_train.py repeats it)."""
    rng = np.random.default_rng(1)
    embeds = (rng.normal(size=(B, S, cfg.d_model)) * 0.02).astype(np.float32)
    pos_t, pos_h, pos_w = np.arange(S), np.arange(S), np.arange(S)
    pos_h[4:8] = [4, 4, 5, 5]
    pos_w[4:8] = [4, 5, 4, 5]
    positions = np.broadcast_to(np.stack([pos_t, pos_h, pos_w])[:, None, :],
                                (3, B, S)).copy()
    return embeds, positions


def test_mrope_equals_rope_for_text():
    rng = np.random.default_rng(0)
    B, S, H, dh = 2, 8, 4, 32
    x = torch.from_numpy(rng.normal(size=(B, S, H, dh)).astype(np.float32))
    pos = torch.arange(S).expand(B, S)
    a = apply_rope(x, pos, 10000.0)
    b = apply_mrope(x, torch.arange(S).expand(3, B, S), 10000.0, (4, 6, 6))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 1000), st.integers(0, 50), st.integers(0, 50))
def test_mrope_sections_use_their_component(t, h, w):
    x = torch.ones((1, 1, 1, 32))
    sections, half = (4, 6, 6), 16
    base = apply_mrope(x, torch.tensor([t, h, w]).reshape(3, 1, 1), 1e4,
                       sections).numpy()
    moved = apply_mrope(x, torch.tensor([t, h + 7, w]).reshape(3, 1, 1), 1e4,
                        sections).numpy()
    np.testing.assert_allclose(moved[..., :4], base[..., :4], atol=1e-6)
    np.testing.assert_allclose(moved[..., half:half + 4],
                               base[..., half:half + 4], atol=1e-6)
    np.testing.assert_allclose(moved[..., 10:half], base[..., 10:half],
                               atol=1e-6)
    assert not np.allclose(moved[..., 4:10], base[..., 4:10], atol=1e-9)


def test_vlm_prefill_decode_roundtrip(vlm):
    """Prefill from stub embeddings at image positions, against a prefill
    of 10 then a resume of 6; then one decode step on each."""
    _, _, model = vlm
    embeds, positions = _image_inputs(model.cfg)
    S = embeds.shape[1]
    lg, cache = model.prefill({"embeds": embeds, "positions": positions},
                              model.init_cache(1, 24))
    _, cache2 = model.prefill({"embeds": embeds[:, :10],
                               "positions": positions[:, :, :10]},
                              model.init_cache(1, 24))
    lg2, cache2 = model.prefill({"embeds": embeds[:, 10:],
                                 "positions": positions[:, :, 10:]}, cache2,
                                start_pos=10, resume=True)
    np.testing.assert_allclose(lg.numpy(), lg2.numpy(), atol=ATOL, rtol=RTOL)
    tok = np.asarray([[7]], np.int32)
    d1, _ = model.decode_step(cache, tok, S)
    d2, _ = model.decode_step(cache2, tok, S)
    np.testing.assert_allclose(d1.numpy(), d2.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("sections,dh", [((4, 6, 6), 32), ((16, 24, 24), 128)])
def test_apply_mrope_equals_the_reference(sections, dh):
    rng = np.random.default_rng(4)
    B, S, H = 2, 11, 3
    x = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    pos3 = rng.integers(0, 4000, (3, B, S)).astype(np.int32)
    mine = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6,
                       sections)
    ref = jax_apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6, sections)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)
    with pytest.raises(ValueError, match="sum"):
        apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6,
                    sections[:2])


def test_band_index_is_built_once_per_sections_and_device():
    a = mrope_band((16, 24, 24), torch.device("cpu"))
    assert a is mrope_band((16, 24, 24), torch.device("cpu"))
    assert a.tolist() == [0] * 16 + [1] * 24 + [2] * 24


def test_decode_positions_under_mrope():
    cfg = get_config("qwen2-vl-2b").reduced()
    p = decode_positions(cfg, 9, 2, "cpu")
    assert p.shape == (3, 2, 1) and (p == 9).all()
    rows = torch.tensor([3, 7], dtype=torch.int32)
    p = decode_positions(cfg, rows, 2, "cpu")
    assert p.shape == (3, 2, 1) and p.data_ptr() == rows.data_ptr()
    assert p[:, :, 0].tolist() == [[3, 7]] * 3
    std = decode_positions(get_config("llama3.2-1b").reduced(), rows, 2,
                           "cpu")
    assert std.shape == (2, 1)


def test_vlm_logits_equal_the_reference(vlm):
    """The image prefill, its resume and a decode step against the
    reference's on the same embeddings and positions."""
    jm, jp, model = vlm
    embeds, positions = _image_inputs(model.cfg)
    S = embeds.shape[1]
    jl, jc = jm.prefill(jp, {"embeds": jnp.asarray(embeds),
                             "positions": jnp.asarray(positions)},
                        jm.init_cache(1, 24))
    tl, tc = model.prefill({"embeds": embeds, "positions": positions},
                           model.init_cache(1, 24))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-5)
    tok = np.asarray([[7]], np.int32)
    jd, _ = jm.decode_step(jp, jc, jnp.asarray(tok), S)
    td, _ = model.decode_step(tc, tok, S)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5,
                               rtol=1e-5)


def test_engine_pads_embeddings_as_the_reference(vlm):
    """The engine's bucket padding of a VLM input (zero embeddings,
    edge-padded positions) gives the reference engine's logits and the
    unpadded prefill's."""
    jm, jp, model = vlm
    embeds, positions = _image_inputs(model.cfg, S=11)
    inp = {"embeds": embeds, "positions": positions}
    te = InferenceEngine(model, max_len=32)
    padded, n = te._pad_inputs(inp)
    assert n == 11 and padded["embeds"].shape[1] == 16
    assert not padded["embeds"][:, 11:].any()
    assert (padded["positions"][:, :, 11:] == positions[:, :, -1:]).all()
    st = te.start(inp)
    jst = JaxEngine(jm, jp, max_len=32).start(
        {"embeds": jnp.asarray(embeds), "positions": jnp.asarray(positions)})
    np.testing.assert_allclose(st.last_logits, jst.last_logits, atol=1e-5,
                               rtol=1e-5)
    exact, _ = model.prefill(inp, model.init_cache(1, 32))
    np.testing.assert_allclose(st.last_logits, exact.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_text_batches_on_the_vlm(vlm):
    """Text on qwen2-vl: a BatchedEngine pool of rows at their own
    positions decodes each row as its own sequential run."""
    _, _, model = vlm
    rng = np.random.default_rng(5)
    rows = [rng.integers(3, model.cfg.vocab, n).astype(np.int32)
            for n in (9, 17, 5)]
    eng = BatchedEngine(model, max_len=48, batch_size=3)
    logits = eng.prefill_slots([0, 1, 2], rows)
    single = InferenceEngine(model, max_len=48)
    states = [single.start({"tokens": r[None]}) for r in rows]
    for b, st_ in enumerate(states):
        np.testing.assert_allclose(logits[b], st_.last_logits[0], atol=1e-5,
                                   rtol=1e-5)
    toks = np.asarray([int(np.argmax(lg)) for lg in logits], np.int32)
    for _ in range(4):
        out = eng.decode_batch(toks)
        ref = np.concatenate([single.decode_one(st_, t.reshape(1, 1))
                              for st_, t in zip(states, toks)])
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
        toks = out.argmax(-1).astype(np.int32)


def test_engine_resumes_embeddings_monolithic_and_streamed(vlm):
    """``resume`` and ``resume_streamed`` take a VLM's embeddings and
    positions as ``start`` does: a prefix of 10 then the other 6 gives
    the one-shot prefill's logits, one layer group at a time too."""
    _, _, model = vlm
    embeds, positions = _image_inputs(model.cfg)

    def part(sl):
        return {"embeds": embeds[:, sl], "positions": positions[:, :, sl]}
    te = InferenceEngine(model, max_len=32)
    whole = te.start(part(slice(None)))
    pre = te.start(part(slice(0, 10)))
    mono = te.resume(part(slice(10, None)), pre.cache, 10)
    np.testing.assert_allclose(mono.last_logits, whole.last_logits,
                               atol=ATOL, rtol=RTOL)
    pre = te.start(part(slice(0, 10)))
    seg = pre.cache["segments"][0]
    groups = [(0, i, i + 1, {k: t[i:i + 1] for k, t in seg.items()})
              for i in range(model.cfg.n_layers)]
    streamed = te.resume_streamed(part(slice(10, None)), 10, iter(groups),
                                  pre.cache)
    assert streamed.pos == mono.pos == 16
    np.testing.assert_allclose(streamed.last_logits, mono.last_logits,
                               atol=1e-6, rtol=1e-6)
