"""The port's SSM path (mamba2-780m) against the JAX reference.

* ``ssd_scan``: on the CPU the wrapper runs its plain version, held
  against the Pallas kernel (interpret mode) and the sequential oracle
  ``ref.ssd_chunk_ref`` within atol 2e-4, rtol 1e-3, the reference's own
  kernel tolerance (``tests/test_kernels.py``: the chunked form sums in
  another order than the step-by-step recurrence).
* ``ssm_prefill`` / ``ssm_decode`` and the whole ``Model`` on
  ``mamba2-780m.reduced()`` with the reference's params: fp32 within
  1e-5 (the same fp32 function; only summation orders differ) and
  identical greedy tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.keys import model_meta as jax_model_meta
from repro.kernels.ref import ssd_chunk_ref
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models import Model as JaxModel
from repro.models import ssm as jax_ssm
from repro_torch.configs import get_config
from repro_torch.core.keys import model_meta
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import ssm
from repro_torch.models.model import Model
from repro_torch.params import from_jax_params

TOL = 1e-5
SCAN_TOL = dict(atol=2e-4, rtol=1e-3)

SSD_CASES = [
    # B, S, H, P, N, chunk, G  (tests/test_kernels.py:68-72, G = H, plus
    # grouped B/C as the model passes them)
    (2, 64, 3, 16, 8, 16, 3),
    (1, 100, 2, 32, 16, 32, 2),            # ragged S vs chunk
    (1, 32, 4, 64, 128, 16, 4),            # mamba2-780m head geometry
    (1, 70, 4, 16, 8, 16, 2),              # two groups, ragged
    (1, 48, 4, 64, 128, 256, 1),           # one group, chunk > S
]


def _scan_inputs(B, S, H, P, N, G, seed=0):
    """The reference test's distributions, made with numpy."""
    rng = np.random.default_rng(seed)

    def n(shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    x = n((B, S, H, P), 0.5)
    dt = np.abs(n((B, S, H), 0.1)) + 0.01
    A = -np.abs(n((H,))) - 0.1
    Bg, Cg = n((B, S, G, N), 0.5), n((B, S, G, N), 0.5)
    h0 = n((B, H, P, N), 0.2)
    return x, dt, A, Bg, Cg, h0


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_plain_vs_pallas_and_oracle(case):
    B, S, H, P, N, chunk, G = case
    x, dt, A, Bg, Cg, h0 = _scan_inputs(B, S, H, P, N, G)
    y, h = ssd_scan(*_t(x, dt, A, Bg, Cg, h0), chunk=chunk)
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (B, S, H, P) and h.shape == (B, H, P, N)
    # the reference kernel and oracle take B/C per head
    Bh, Ch = (jnp.asarray(np.repeat(a, H // G, axis=2)) for a in (Bg, Cg))
    jx, jdt, jA, jh0 = map(jnp.asarray, (x, dt, A, h0))
    yp, hp = jax_ssd_scan(jx, jdt, jA, Bh, Ch, jh0, chunk=chunk,
                          interpret=True)
    yr, hr = ssd_chunk_ref(jx, jdt, jA, Bh, Ch, jh0, chunk)
    for ref_y, ref_h in ((yp, hp), (yr, hr)):
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), **SCAN_TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), **SCAN_TOL)


def test_ssd_scan_h0_resume_identity():
    """scan(all) == scan(a) then scan(b, h_a): the kernel-level form of a
    prompt-cache resume."""
    x, dt, A, Bg, Cg, _ = _t(*_scan_inputs(1, 90, 4, 16, 16, 2, seed=3))
    h0 = torch.zeros((1, 4, 16, 16))
    y_all, h_all = ssd_scan(x, dt, A, Bg, Cg, h0, chunk=32)
    _, h_a = ssd_scan(x[:, :37], dt[:, :37], A, Bg[:, :37], Cg[:, :37], h0,
                      chunk=32)
    y_b, h_b = ssd_scan(x[:, 37:], dt[:, 37:], A, Bg[:, 37:], Cg[:, 37:],
                        h_a, chunk=32)
    torch.testing.assert_close(y_b, y_all[:, 37:], **SCAN_TOL)
    torch.testing.assert_close(h_b, h_all, **SCAN_TOL)


def test_ssd_scan_never_falls_back_off_the_cpu():
    x = torch.empty((1, 8, 2, 16), device="meta")
    dt = torch.empty((1, 8, 2), device="meta")
    bc = torch.empty((1, 8, 1, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ssd_scan(x, dt, dt[0, 0], bc, bc, torch.empty((1, 2, 16, 8),
                                                      device="meta"), chunk=4)


# ---------------------------------------------------------------------------
# config, params, layer and model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference():
    jcfg = jax_get_config("mamba2-780m").reduced()
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jcfg, jm, jp


def port_model(jp, dtype=torch.float32):
    m = Model(get_config("mamba2-780m").reduced(), dtype=dtype, device="cpu")
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)))
    return m


def test_config_and_meta_match_reference(reference):
    for jcfg, tcfg in ((jax_get_config("mamba2-780m"),
                        get_config("mamba2-780m")),
                       (reference[0], get_config("mamba2-780m").reduced())):
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "dh", "d_ff", "vocab", "rope",
                  "tie_embeddings", "window", "ssm_d_inner", "ssm_n_heads"):
            assert getattr(jcfg, f) == getattr(tcfg, f), f
        assert vars(jcfg.ssm) == vars(tcfg.ssm)
        for name in ("float32", "bfloat16"):
            assert model_meta(tcfg, name) == jax_model_meta(jcfg, name)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_state_dict_carries_the_ssm_tree(dtype):
    """Every leaf of the reference's tree, same shape and dtype (A_log, D
    and dt_bias stay fp32 in a bf16 model)."""
    jcfg = jax_get_config("mamba2-780m").reduced()
    jp = JaxModel(jcfg, dtype=dtype).init(jax.random.PRNGKey(1))
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    m = Model(get_config("mamba2-780m").reduced(), dtype=tdt, device="cpu")
    sd = from_jax_params(jax.tree.map(np.asarray, jp))
    assert set(sd) == set(m.state_dict())
    for name, t in m.state_dict().items():
        assert tuple(t.shape) == tuple(sd[name].shape), name
        assert t.dtype == sd[name].dtype, name
    for leaf in ("A_log", "D", "dt_bias"):
        assert sd[f"segments.0.ssm.{leaf}"].dtype == torch.float32
    m.load_state_dict(sd)
    assert m.segments[0]["ssm"]["in_proj"].dtype == tdt


def test_ssm_prefill_and_decode_match_reference(reference):
    jcfg, _, jp = reference
    tcfg = get_config("mamba2-780m").reduced()
    lp = jax.tree.map(lambda a: np.array(a[0]), jp["segments"][0]["ssm"])
    tp = {k: torch.from_numpy(v) for k, v in lp.items()}
    jpar = jax.tree.map(jnp.asarray, lp)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 37, jcfg.d_model)).astype(np.float32)
    jc = jax_ssm.init_ssm_cache(jcfg, 2, jnp.float32)
    tc = ssm.init_ssm_cache(tcfg, 2, torch.float32)
    assert tc["ssd"].dtype == torch.float32
    # cold, then a resume from the state the first piece left
    for sl in (slice(0, 23), slice(23, 37)):
        jy, jc = jax_ssm.ssm_prefill(jpar, jcfg, jnp.asarray(x[:, sl]), jc)
        ty, tc = ssm.ssm_prefill(tp, tcfg, torch.from_numpy(x[:, sl]), tc)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL,
                                   rtol=TOL)
        for leaf in ("conv", "ssd"):
            np.testing.assert_allclose(tc[leaf].numpy(),
                                       np.asarray(jc[leaf]), atol=TOL,
                                       rtol=TOL)
    for i in range(3):
        x1 = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
        jy, jc = jax_ssm.ssm_decode(jpar, jcfg, jnp.asarray(x1), jc)
        ty, tc = ssm.ssm_decode(tp, tcfg, torch.from_numpy(x1), tc)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(tc["ssd"].numpy(), np.asarray(jc["ssd"]),
                                   atol=TOL, rtol=TOL)


def test_model_matches_reference(reference):
    """Unpadded ``Model.prefill`` of a prefix, a resume at ``start_pos``,
    then 3 greedy decode steps, through both packages."""
    jcfg, jm, jp = reference
    m = port_model(jp)
    toks = np.random.default_rng(0).integers(3, jcfg.vocab, (1, 41)).astype(
        np.int32)
    prefill = jax.jit(jm.prefill, static_argnames="resume")
    decode = jax.jit(jm.decode_step)
    jc, tc = jm.init_cache(1, 64), m.init_cache(1, 64)
    assert tc["segments"][0]["ssd"].dtype == torch.float32
    jl, jc = prefill(jp, {"tokens": jnp.asarray(toks[:, :26])}, jc, 0)
    tl, tc = m.prefill({"tokens": toks[:, :26]}, tc, 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    jl, jc = prefill(jp, {"tokens": jnp.asarray(toks[:, 26:])}, jc, 26,
                     resume=True)
    tl, tc = m.prefill({"tokens": toks[:, 26:]}, tc, 26, resume=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    jtok, ttok = [], []
    for i in range(3):
        jt = int(np.argmax(np.asarray(jl)[0]))
        tt = int(np.argmax(tl.numpy()[0]))
        jtok.append(jt)
        ttok.append(tt)
        jl, jc = decode(jp, jc, jnp.asarray([[jt]], jnp.int32), 41 + i)
        tl, tc = m.decode_step(tc, np.array([[tt]]), 41 + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
    assert ttok == jtok
    for leaf in ("conv", "ssd"):
        np.testing.assert_allclose(tc["segments"][0][leaf].numpy(),
                                   np.asarray(jc["segments"][0][leaf]),
                                   atol=TOL, rtol=TOL)


def test_bf16_model_keeps_an_fp32_state_and_tracks_fp32(reference):
    """The serving dtype: bf16 weights, activations and conv window, an
    fp32 SSD state; logits close to fp32 (~3 significant digits, so a
    loose bound)."""
    jp = reference[2]
    m32, m16 = port_model(jp), port_model(jp, torch.bfloat16)
    toks = np.random.default_rng(4).integers(3, 512, (1, 24)).astype(
        np.int32)
    l32, _ = m32.prefill({"tokens": toks}, m32.init_cache(1, 32), 0)
    l16, c16 = m16.prefill({"tokens": toks}, m16.init_cache(1, 32), 0)
    seg = c16["segments"][0]
    assert seg["conv"].dtype == torch.bfloat16
    assert seg["ssd"].dtype == torch.float32
    assert m16.segments[0]["ssm"]["A_log"].dtype == torch.float32
    assert torch.isfinite(l16).all()
    assert (l16 - l32).abs().max() < 0.05
