"""AdamW with optional low-precision moments, as ``repro.training.optimizer``.

The reference's formula, not ``torch.optim.AdamW``: a linear warmup of
the learning rate over ``warmup_steps``, gradients clipped to
``grad_clip`` by their global norm (``sqrt(sum g^2 + 1e-12)``, the
scale cast to each gradient's dtype), the update in fp32 whatever the
parameter's dtype, and the moments stored in ``moment_dtype`` (bf16
halves their memory). The state is ``AdamWState(count, mu, nu)``: an
int32 step count and one moment tensor a parameter, keyed as the
parameters are. Unlike the reference, :meth:`Optimizer.update` writes
the new parameters and moments into the given tensors IN PLACE (the
parameters stay the model's own) and returns them.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

Tree = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    count: torch.Tensor            # int32, 0-d
    mu: Tree
    nu: Tree


class Optimizer(NamedTuple):
    init: object
    update: object


def global_norm(grads: Tree) -> torch.Tensor:
    """``sqrt(sum of every gradient's squares in fp32 + 1e-12)``."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads.values()) + 1e-12)


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          grad_clip: Optional[float] = 1.0,
          moment_dtype: Optional[torch.dtype] = None,
          warmup_steps: int = 100) -> Optimizer:

    def schedule(count: torch.Tensor) -> torch.Tensor:
        warm = torch.clamp(count.float() / max(warmup_steps, 1), max=1.0)
        return lr * warm

    def init(params: Tree) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=moment_dtype or p.dtype,
                               device=p.device)
        dev = next(iter(params.values())).device if params else None
        return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                          {k: zeros(p) for k, p in params.items()},
                          {k: zeros(p) for k, p in params.items()})

    @torch.no_grad()
    def update(grads: Tree, state: AdamWState, params: Tree):
        """One step on every parameter of ``params`` (a missing or None
        gradient counts as zeros, as JAX's would be). Returns ``(params,
        state)``, both updated in place."""
        grads = {k: torch.zeros_like(p) if grads.get(k) is None
                 else grads[k] for k, p in params.items()}
        count = state.count + 1
        if grad_clip is not None:
            scale = torch.clamp(grad_clip / global_norm(grads), max=1.0)
            grads = {k: g * scale.to(g.dtype) for k, g in grads.items()}
        c = count.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, device=c.device), c)
        bc2 = 1 - torch.pow(torch.tensor(b2, device=c.device), c)
        rate = schedule(count)
        for k, p in params.items():
            m, v = state.mu[k], state.nu[k]
            gf = grads[k].float()
            mf = m.float() * b1 + gf * (1 - b1)
            vf = v.float() * b2 + gf * gf * (1 - b2)
            step = rate * ((mf / bc1) / (torch.sqrt(vf / bc2) + eps)
                           + weight_decay * p.float())
            p.copy_(p.float() - step)
            m.copy_(mf)
            v.copy_(vf)
        state.count.copy_(count)
        return params, state

    return Optimizer(init=init, update=update)
