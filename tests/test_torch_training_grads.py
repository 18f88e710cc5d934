"""The port's training loss and gradients against the JAX reference's
``jax.value_and_grad(model.loss)``, on the CPU, for the dense, VLM and
encoder-decoder families (the MoE, MLA, SSM and hybrid ones:
``test_torch_training_grads_moe_ssm.py``).

Each reduced config's params come from the reference (``from_jax_params``)
and each batch from a numpy seed: tokens, targets and a mask with zeros.
The port runs with ``remat`` (a checkpoint a layer), the reference
without: remat changes no value. Tolerances (fp32): the loss and each
metric within 1e-5 of its value (at least 1e-5 absolute), each
parameter's gradient within 1e-4 of that leaf's largest reference
gradient (the same sums in another order, through a softmax over a
512-token vocab and two layers), or within 1e-7 where that is smaller:
a gradient that is 0 in exact arithmetic (a key bias, since softmax
ignores a shift shared by every key) is rounding noise of ~1e-10 in
both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.models import model as model_mod
from repro_torch.models.model import Model
from repro_torch.params import from_jax_params

B, S = 2, 24
LOSS_TOL, GRAD_TOL, GRAD_FLOOR = 1e-5, 1e-4, 1e-7
FAMILIES = ["llama3.2-1b", "gemma3-270m", "qwen2-vl-2b", "whisper-base"]


def batch_for(cfg, seed=0, S=S):
    """Tokens, targets and a mask (row 1's last 5 positions 0) as numpy;
    an encoder-decoder's frames too."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "mask": np.ones((B, S), np.float32)}
    b["mask"][1, -5:] = 0.0
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal(
            (B, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32)
    return b


def pair(name, remat=True, seed=0):
    """(reference model, its params, port model with those params,
    trainable)."""
    jcfg, cfg = jax_get_config(name).reduced(), get_config(name).reduced()
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    m = Model(cfg, device="cpu", seed=None, remat=remat)
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)),
                      strict=True)
    m.requires_grad_(True)
    return jm, jp, m


def reference_loss_and_grads(jm, jp, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jp, jb)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            from_jax_params(jax.tree.map(np.asarray, grads)))


def port_loss_and_grads(m, batch):
    for p in m.parameters():
        p.grad = None
    loss, metrics = m.loss(batch)
    loss.backward()
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in m.named_parameters()}
    return float(loss.detach()), {k: float(v.detach()) for k, v in
                                  metrics.items()}, grads


def assert_matches(port, ref):
    loss, metrics, grads = port
    rloss, rmetrics, rgrads = ref
    assert abs(loss - rloss) <= LOSS_TOL * max(1.0, abs(rloss))
    assert set(metrics) == set(rmetrics)
    for k, v in rmetrics.items():
        assert abs(metrics[k] - v) <= LOSS_TOL * max(1.0, abs(v)), k
    assert set(grads) == set(rgrads)
    for k, g in rgrads.items():
        scale = g.abs().max().item()
        err = (grads[k].float() - g.float()).abs().max().item() \
            if g.numel() else 0.0
        assert err <= max(GRAD_TOL * scale, GRAD_FLOOR), (k, err, scale)


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_grads_match_the_reference(name):
    jm, jp, m = pair(name)
    b = batch_for(m.cfg)
    assert_matches(port_loss_and_grads(m, b),
                   reference_loss_and_grads(jm, jp, b))


@pytest.mark.parametrize("name", ["llama3.2-1b", "whisper-base"])
def test_remat_changes_no_value(name):
    """A checkpoint a layer (the encoder's and decoder's too) recomputes
    the same loss and gradients as keeping every activation."""
    _, _, m = pair(name, remat=True)
    b = batch_for(m.cfg, seed=3)
    with_remat = port_loss_and_grads(m, b)
    m.remat = False
    without = port_loss_and_grads(m, b)
    assert with_remat[0] == without[0]
    for k, g in without[2].items():
        torch.testing.assert_close(with_remat[2][k], g, rtol=0, atol=1e-7)


def test_chunked_ce_matches_the_unchunked_reference(monkeypatch):
    """The sequence-chunked CE, each chunk under a checkpoint, gives the
    whole CE's loss and gradients. The reference chunks only past S·V =
    2^25 (too large for a CPU test), so here the port's thresholds are
    lowered and held against the reference's unchunked result."""
    jm, jp, m = pair("gemma3-270m")
    b = batch_for(m.cfg, seed=5, S=32)
    ref = reference_loss_and_grads(jm, jp, b)
    monkeypatch.setattr(model_mod, "CE_CHUNK", 8)
    monkeypatch.setattr(model_mod, "CE_CHUNKED_ABOVE", 0)
    calls = []
    real = Model._ce_chunk
    monkeypatch.setattr(Model, "_ce_chunk",
                        lambda self, *a: calls.append(1) or real(self, *a))
    assert_matches(port_loss_and_grads(m, b), ref)
    assert len(calls) == 2 * 4          # 4 chunks, each recomputed once


def test_forward_logits_match_the_reference():
    jm, jp, m = pair("qwen2-vl-2b")
    b = batch_for(m.cfg, seed=7)
    ref = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(b["tokens"])}))
    with torch.no_grad():
        got = m.forward({"tokens": b["tokens"]}).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
