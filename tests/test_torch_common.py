"""The port's building blocks against ``repro.models.common`` on the same
numpy inputs, fp32 within 1e-6 (elementwise math; only ``exp``/``tanh``
/``rsqrt`` implementations differ in the last bits)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jc
from repro_torch.models import common as tc

TOL = 1e-6


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL,
                               rtol=TOL)


def test_rmsnorm_scales_by_one_plus_scale():
    x, s = _x((2, 5, 64)), _x((64,), seed=1, scale=0.1)
    _close(tc.rmsnorm(torch.from_numpy(x), torch.from_numpy(s)),
           jc.rmsnorm(jnp.asarray(x), jnp.asarray(s)))


def test_layernorm():
    x, s, b = _x((3, 48)), _x((48,), seed=1), _x((48,), seed=2)
    _close(tc.layernorm(*map(torch.from_numpy, (x, s, b))),
           jc.layernorm(*map(jnp.asarray, (x, s, b))))


@pytest.mark.parametrize("kind", ["silu", "gelu", "relu2"])
def test_activation(kind):
    x = _x((4, 100), scale=3.0)
    _close(tc.activation(torch.from_numpy(x), kind),
           jc.activation(jnp.asarray(x), kind))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_rotates_halves(theta):
    x = _x((2, 7, 4, 32))
    pos = np.broadcast_to(np.arange(100, 107), (2, 7)).astype(np.int32)
    np.testing.assert_allclose(
        tc.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
        jc.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
        atol=1e-5, rtol=1e-5)       # angles up to ~100 rad: fp32 sin/cos


def test_safe_softmax_gives_zero_for_a_fully_masked_row():
    s = _x((3, 10), scale=4.0)
    mask = np.ones((3, 10), bool)
    mask[1] = False
    mask[2, 5:] = False
    out = tc.safe_softmax(torch.from_numpy(s), torch.from_numpy(mask))
    _close(out, jc.safe_softmax(jnp.asarray(s), jnp.asarray(mask)))
    assert torch.count_nonzero(out[1]) == 0
