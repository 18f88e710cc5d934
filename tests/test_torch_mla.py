"""The port's MLA path (deepseek-v3-671b cut to its dense MLA layers)
against the JAX reference.

* ``mla_decode``: on the CPU the wrapper runs its plain version, held
  against the reference's kernel (Pallas, interpret mode) and its oracle
  ``ref.mla_decode_ref`` at the reference's kernel cases, within 1e-5
  (fp32) and 2e-2 (bf16), the tolerances of ``tests/test_kernels.py``.
* ``flash_prefill`` with values narrower than keys (dh 192, dv 128, MLA's
  prefill) against the reference's ``attend``, within 1e-5 (fp32).
* ``mla_prefill`` / ``mla_decode`` against the reference's, within atol
  2e-5, rtol 1e-4 (``tests/test_kernels.py``'s MLA model tolerance).
* The whole ``Model`` on ``deepseek-v3-671b.reduced()`` cut to 2 dense
  MLA layers (MLA widths stay full): fp32 logits within 1e-5 and
  identical greedy tokens; the reference's params (with the empty MoE
  segment) load strictly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.keys import model_meta as jax_model_meta
from repro.kernels.mla_decode import mla_decode_kernel
from repro.kernels.ref import mla_decode_ref
from repro.models import Model as JaxModel
from repro.models import mla as jax_mla
from repro.models.attention import attend
from repro_torch.configs import get_config
from repro_torch.configs.deepseek_v3_671b import dense_cut
from repro_torch.core.keys import model_meta
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.mla_decode import mla_decode
from repro_torch.models import mla
from repro_torch.models.model import Model
from repro_torch.params import from_jax_params

TOL = 1e-5
KERNEL_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LAYER_TOL = dict(atol=2e-5, rtol=1e-4)
N_LAYERS = 2

MLA_CASES = [
    # B, S, H, R, Dr, kv_len, win  (tests/test_kernels.py MLA_CASES)
    (2, 128, 4, 64, 16, 100, None),
    (1, 256, 8, 128, 32, 256, None),
    (1, 192, 2, 32, 16, 150, 64),
]


def jax_cut(n_layers=N_LAYERS, cfg=None):
    """The reference's config (reduced by default) under the same cut as
    ``dense_cut``."""
    cfg = cfg or jax_get_config("deepseek-v3-671b").reduced()
    return cfg.replace(n_layers=n_layers, mtp=False,
                       moe=dataclasses.replace(cfg.moe,
                                               first_k_dense=n_layers))


def port_cut(n_layers=N_LAYERS):
    return dense_cut(get_config("deepseek-v3-671b").reduced(), n_layers)


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _both(a, dtype):
    """numpy fp32 -> (jax array, torch tensor) of the same dtype and bits."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", MLA_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_plain_vs_pallas_and_oracle(case, dtype):
    B, S, H, R, Dr, kv_len, win = case
    rng = np.random.default_rng(0)
    (jq, tq), (jr, tr), (jc, tc), (jk, tk) = (
        _both(_normal(rng, s), dtype)
        for s in ((B, H, R), (B, H, Dr), (B, S, R), (B, S, Dr)))
    out = mla_decode(tq, tr, tc, tk, kv_len=kv_len, window=win,
                     scale=1.0 / 192 ** 0.5)
    assert out.dtype == tq.dtype and out.shape == (B, H, R)
    pallas = mla_decode_kernel(jq, jr, jc, jk, kv_len=kv_len,
                               qk_head_dim=192, window=win, block_k=64,
                               interpret=True)
    oracle = mla_decode_ref(jq, jr, jc, jk, kv_len, 192, window=win)
    for ref in (pallas, oracle):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   atol=KERNEL_TOL[dtype],
                                   rtol=KERNEL_TOL[dtype])


def test_mla_decode_with_no_live_key_gives_zero():
    rng = np.random.default_rng(1)
    t = [torch.from_numpy(_normal(rng, s))
         for s in ((1, 4, 64), (1, 4, 16), (1, 32, 64), (1, 32, 16))]
    out = mla_decode(*t, kv_len=0, scale=0.1)
    assert torch.count_nonzero(out) == 0


def test_mla_decode_never_falls_back_off_the_cpu():
    q = torch.empty((1, 4, 512), device="meta")
    r = torch.empty((1, 4, 64), device="meta")
    ckv = torch.empty((1, 8, 512), device="meta")
    krope = torch.empty((1, 8, 64), device="meta")
    n0 = mla_decode.launches
    with pytest.raises(ValueError, match="no kernel"):
        mla_decode(q, r, ckv, krope, kv_len=4, scale=0.1)
    assert mla_decode.launches == n0


@pytest.mark.parametrize("Sq,Sk,off,kv_len,win", [
    (24, 24, 0, 24, None),          # cold prefill
    (7, 40, 17, 24, None),          # resume at q_offset over a longer cache
    (16, 32, 0, 16, 8),             # sliding window
])
def test_flash_prefill_narrow_values_vs_attend(Sq, Sk, off, kv_len, win):
    """MLA's prefill shape: 192-wide keys, 128-wide values, scale
    1/sqrt(192), one kv head per query head."""
    rng = np.random.default_rng(2)
    B, H = 2, 3
    q = _normal(rng, (B, Sq, H, 192))
    k = _normal(rng, (B, Sk, H, 192))
    v = _normal(rng, (B, Sk, H, 128))
    out = flash_prefill(*map(torch.from_numpy, (q, k, v)), q_offset=off,
                        kv_len=kv_len, window=win)
    assert out.shape == (B, Sq, H, 128)
    kpos = np.where(np.arange(Sk) < kv_len, np.arange(Sk), -1)
    ref = attend(*map(jnp.asarray, (q, k, v)), jnp.arange(off, off + Sq),
                 jnp.asarray(kpos), window=win)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


# ---------------------------------------------------------------------------
# config, params, layer and model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference():
    jcfg = jax_cut()
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jcfg, jm, jp


def port_model(jp, dtype=torch.float32):
    m = Model(port_cut(), dtype=dtype, device="cpu")
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)))
    return m


def test_config_and_meta_match_reference():
    full_j, full_t = (jax_get_config("deepseek-v3-671b"),
                      get_config("deepseek-v3-671b"))
    pairs = [(full_j, full_t),
             (full_j.reduced(), full_t.reduced()),
             (jax_cut(3, full_j), dense_cut(full_t, 3)),
             (jax_cut(), port_cut())]
    for jcfg, tcfg in pairs:
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "dh", "d_ff", "vocab", "act",
                  "tie_embeddings", "window", "mtp", "uses_mla"):
            assert getattr(jcfg, f) == getattr(tcfg, f), f
        assert vars(jcfg.mla) == vars(tcfg.mla)
        assert vars(jcfg.moe) == vars(tcfg.moe)
        for name in ("float32", "bfloat16"):
            assert model_meta(tcfg, name) == jax_model_meta(jcfg, name)


def test_the_cut_keeps_full_widths_and_an_empty_moe_segment():
    from repro.models.transformer import segments_for as jax_segments
    from repro_torch.models.transformer import segments_for
    cut = dense_cut(get_config("deepseek-v3-671b"), 3)
    assert (cut.d_model, cut.n_heads, cut.vocab, cut.moe.dense_ff) == \
        (7168, 128, 129280, 18432)
    segs = segments_for(cut)
    assert [tuple(s) for s in segs] == [("mla_dense", 3, 18432),
                                        ("mla_moe", 0, 0)]
    jcut = jax_cut(3, jax_get_config("deepseek-v3-671b"))
    assert [tuple(s) for s in jax_segments(jcut)] == \
        [tuple(s) for s in segs]


def test_model_refuses_what_it_cannot_run():
    with pytest.raises(NotImplementedError, match="MTP"):
        Model(get_config("deepseek-v3-671b").reduced(), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1, item 7"):
        Model(get_config("deepseek-v3-671b").reduced().replace(mtp=False),
              device="cpu")


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_state_dict_carries_the_mla_tree_and_the_empty_segment(dtype):
    """Every leaf of the reference's tree, same shape and dtype: the MLA
    leaves and the empty MoE segment's (router fp32 in a bf16 model)."""
    jp = JaxModel(jax_cut(), dtype=dtype).init(jax.random.PRNGKey(1))
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    m = Model(port_cut(), dtype=tdt, device="cpu")
    sd = from_jax_params(jax.tree.map(np.asarray, jp))
    assert set(sd) == set(m.state_dict())
    for name, t in m.state_dict().items():
        assert tuple(t.shape) == tuple(sd[name].shape), name
        assert t.dtype == sd[name].dtype, name
    assert sd["segments.1.moe.router"].dtype == torch.float32
    assert sd["segments.1.mla.wq_b"].shape == (0, 1536, 4, 192)
    m.load_state_dict(sd, strict=True)
    assert m.segments[0]["mla"]["wk_b"].shape == (N_LAYERS, 512, 4, 128)


def test_mla_prefill_and_decode_match_reference(reference):
    jcfg, _, jp = reference
    tcfg = port_cut()
    lp = jax.tree.map(lambda a: np.array(a[0]), jp["segments"][0]["mla"])
    tp = {k: torch.from_numpy(v) for k, v in lp.items()}
    jpar = jax.tree.map(jnp.asarray, lp)
    rng = np.random.default_rng(5)
    x = _normal(rng, (2, 19, jcfg.d_model))
    jc = jax_mla.init_mla_cache(jcfg, 2, 32, jnp.float32)
    tc = mla.init_mla_cache(tcfg, 2, 32, torch.float32)
    # cold prefill of 12, then a resume of 7 at start_pos 12
    for start, sl in ((0, slice(0, 12)), (12, slice(12, 19))):
        pos = np.broadcast_to(np.arange(sl.start, sl.stop), (2, sl.stop -
                                                              sl.start))
        jy, jc = jax_mla.mla_prefill(jpar, jcfg, jnp.asarray(x[:, sl]),
                                     jnp.asarray(pos), jc, start)
        ty, tc = mla.mla_prefill(tp, tcfg, torch.from_numpy(x[:, sl]),
                                 torch.from_numpy(pos.copy()), tc, start)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
        for leaf in ("ckv", "krope"):
            np.testing.assert_allclose(tc[leaf].numpy(),
                                       np.asarray(jc[leaf]), **LAYER_TOL)
    for pos in (19, 20, 21):
        x1 = _normal(rng, (2, 1, jcfg.d_model))
        jy, jc = jax_mla.mla_decode(jpar, jcfg, jnp.asarray(x1), pos, jc)
        ty, tc = mla.mla_decode(tp, tcfg, torch.from_numpy(x1), pos, tc)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
        np.testing.assert_allclose(tc["ckv"].numpy(), np.asarray(jc["ckv"]),
                                   **LAYER_TOL)


def test_model_matches_reference(reference):
    """Cold ``Model.prefill`` of a prefix, a resume at ``start_pos``, then
    4 greedy decode steps, through both packages (unpadded)."""
    jcfg, jm, jp = reference
    m = port_model(jp)
    toks = np.random.default_rng(0).integers(3, jcfg.vocab, (1, 37)).astype(
        np.int32)
    jc, tc = jm.init_cache(1, 64), m.init_cache(1, 64)
    assert [tuple(s["ckv"].shape) for s in tc["segments"]] == \
        [(N_LAYERS, 1, 64, 512), (0, 1, 64, 512)]
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :23])}, jc, 0)
    tl, tc = m.prefill({"tokens": toks[:, :23]}, tc, 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, 23:])}, jc, 23,
                        resume=True)
    tl, tc = m.prefill({"tokens": toks[:, 23:]}, tc, 23, resume=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    jtok, ttok = [], []
    for i in range(4):
        jt = int(np.argmax(np.asarray(jl)[0]))
        tt = int(np.argmax(tl.numpy()[0]))
        jtok.append(jt)
        ttok.append(tt)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray([[jt]], jnp.int32),
                                37 + i)
        tl, tc = m.decode_step(tc, np.array([[tt]]), 37 + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
    assert ttok == jtok
    np.testing.assert_allclose(tc["segments"][0]["ckv"].numpy(),
                               np.asarray(jc["segments"][0]["ckv"]),
                               atol=TOL, rtol=TOL)


def test_bf16_model_tracks_fp32(reference):
    """The serving dtype: bf16 weights, activations and latent cache;
    logits close to fp32 (~3 significant digits, so a loose bound)."""
    jp = reference[2]
    m32, m16 = port_model(jp), port_model(jp, torch.bfloat16)
    toks = np.random.default_rng(4).integers(3, 512, (1, 24)).astype(
        np.int32)
    l32, _ = m32.prefill({"tokens": toks}, m32.init_cache(1, 32), 0)
    l16, c16 = m16.prefill({"tokens": toks}, m16.init_cache(1, 32), 0)
    assert c16["segments"][0]["ckv"].dtype == torch.bfloat16
    assert torch.isfinite(l16).all()
    assert (l16 - l32).abs().max() < 0.05
