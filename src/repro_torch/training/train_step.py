"""The train step: loss, gradients, the optimizer's update, the global
gradient norm (``repro.training.train_step``).

The step works on the model in place: :func:`make_train_step` makes its
parameters trainable, and each step runs ``model.loss`` forward and
backward (on the card through the kernels' backward kernels), hands the
gradients to the optimizer, which updates parameters and moments in
place, and frees the gradients.
"""
from __future__ import annotations

from repro_torch.training.optimizer import global_norm


def make_train_step(model, optimizer):
    """``step(state, batch) -> (state, metrics)`` for a model whose
    parameters ``optimizer.init`` gave ``state``; ``metrics`` are the
    loss's (0-d fp32 tensors, detached) plus ``grad_norm``, the norm of
    the gradients before clipping."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())

    def train_step(state, batch):
        for p in params.values():
            p.grad = None
        loss, metrics = model.loss(batch)
        loss.backward()
        grads = {k: p.grad for k, p in params.items()}
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(
            {k: g for k, g in grads.items() if g is not None})
        _, state = optimizer.update(grads, state, params)
        for p in params.values():
            p.grad = None
        return state, metrics
    return train_step
