"""Carry a parameter tree from the JAX package into the port.

The reference's parameters are a pytree keyed by path
(``segments/0/attn/wq`` of shape ``[L, d, H, dh]``, ...). The port keeps
the same layouts under the same names with ``.`` for ``/``, so the
conversion is a copy: give :func:`from_jax_params` the tree with its
leaves as numpy arrays (``jax.tree.map(np.asarray, params)``) and load
the result with ``model.load_state_dict``. Leaves with no elements (an
empty MoE segment's ``[0, ...]`` stacks) come across as empty tensors of
the same shape.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _flatten(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _flatten(item, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _tensor(arr) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":        # ml_dtypes bf16: move the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def from_jax_params(tree) -> Dict[str, torch.Tensor]:
    """The reference's params pytree (numpy leaves) -> a state dict."""
    return {name: _tensor(leaf) for name, leaf in _flatten(tree)}
