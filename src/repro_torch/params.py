"""Carry a parameter tree from the JAX package into the port.

The reference's parameters are a pytree keyed by path
(``segments/0/attn/wq`` of shape ``[L, d, H, dh]``, ...). The port keeps
the same layouts under the same names with ``.`` for ``/``, so the
conversion is a copy: give :func:`from_jax_params` the tree with its
leaves as numpy arrays (``jax.tree.map(np.asarray, params)``) and load
the result with ``model.load_state_dict``. A MoE segment's expert stacks
``[L, E, d, f]`` are copied as they are, and its router stays fp32 in a
bf16 model, as the reference keeps it. An encoder-decoder's ``enc``
(stacked ``[L_enc, ...]``), ``enc_ln`` and ``dec`` trees come across the
same way, their q/k/v/o and layernorm biases with them. Leaves with no
elements (an empty MoE segment's ``[0, ...]`` stacks) come across as
empty tensors of the same shape. :func:`to_tree` is the inverse: a
state dict back to the reference's nested tree (``segments`` a list),
as a checkpoint in the reference's format holds it.

:func:`expert_slice` is a rank's slice of an expert stack under a mesh:
a ``Model`` built with a mesh holds only that (``models/moe.py::init_moe``)
and cuts every whole stack it loads to it.
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


def to_tree(state: Dict[str, torch.Tensor]) -> Dict:
    """A state dict (``segments.0.attn.wq``, ...) -> the reference's
    nested tree: dicts by name, a level whose keys are all indices a
    list in index order (``segments``)."""
    root: Dict = {}
    for name, t in state.items():
        *path, leaf = name.split(".")
        node = root
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t
    return _lists(root)


def _lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_lists(node[k]) for k in sorted(node, key=int)]
    return {k: _lists(v) for k, v in node.items()}


def expert_slice(t: torch.Tensor, m: int, n_model: int, e_stored: int,
                 axis: int = 0) -> torch.Tensor:
    """Model index ``m``'s slice of the expert stack ``t`` along ``axis``:
    experts ``[m e_loc, (m + 1) e_loc)`` of the stack padded with zero
    experts to ``e_pad`` (a multiple of ``n_model``), as a new tensor that
    holds no reference to ``t``; ``t`` itself with one model rank."""
    from repro_torch.models.moe import ep_layout
    if n_model == 1:
        return t
    e_loc = ep_layout(e_stored, n_model)[1]
    lo = min(m * e_loc, e_stored)
    part = t.narrow(axis, lo, min(e_loc, e_stored - lo))
    if part.shape[axis] == e_loc:
        return part.clone()
    shape = list(t.shape)
    shape[axis] = e_loc - part.shape[axis]
    return torch.cat([part, part.new_zeros(shape)], dim=axis)
