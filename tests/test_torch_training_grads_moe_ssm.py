"""The port's training loss and gradients against the JAX reference's
``jax.value_and_grad(model.loss)``, on the CPU, for the MoE families
(deepseek-v3-671b reduced: MLA, one dense and one MoE layer and the MTP
head; granite-moe-3b-a800m), the SSM (mamba2-780m) and the hybrid
(hymba-1.5b, meta tokens and a window). Helpers, inputs and tolerances
as ``test_torch_training_grads.py`` (fp32: loss and metrics 1e-5, each
gradient 1e-4 of its leaf's largest). The MoE routing ids agree exactly
on these inputs, so the routed products are the same.
"""
import pytest

from test_torch_training_grads import (assert_matches, batch_for, pair,
                                       port_loss_and_grads,
                                       reference_loss_and_grads)


@pytest.mark.parametrize("name", ["deepseek-v3-671b", "granite-moe-3b-a800m",
                                  "mamba2-780m", "hymba-1.5b"])
def test_loss_and_grads_match_the_reference(name):
    jm, jp, m = pair(name)
    b = batch_for(m.cfg, seed=1)
    port = port_loss_and_grads(m, b)
    assert_matches(port, reference_loss_and_grads(jm, jp, b))
    if m.cfg.family == "moe":
        assert port[1]["aux"] > 0
    if m.cfg.mtp:
        assert "mtp" in port[1]
