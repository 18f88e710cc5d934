"""Grouped expert GEMM: each expert's rows times that expert's weights.

    out[r] = xs[r] @ w[e]   for offsets[e] <= r < offsets[e + 1]

``xs`` [M, K] holds a MoE layer's routed rows sorted by expert, ``w``
[E, K, N] the stacked experts in the layout the model stores them,
``offsets`` [E + 1] int32 the groups' bounds (``offsets[0] = 0``,
``offsets[E] = M``; an expert with no rows, a padded one included, is an
empty group). Rows outside ``[offsets[0], offsets[E])`` are 0. This is
``jax.lax.ragged_dot(xs, w, group_sizes)`` with ``offsets`` the running
sum of ``group_sizes``.

Replaces no TPU kernel: the reference's expert FFN calls
``jax.lax.ragged_dot`` (``repro/models/moe.py:93``, ``:95``, ``:99``), an
XLA op. It is a hand-written kernel because a loop of per-expert
matmuls needs the group sizes on the host, a device-to-host read in
every MoE layer of every step. On the card the wrapper launches
``csrc/moe_gemm.cu`` (one launch a product; the kernel reads ``offsets``
from device memory), so nothing here reads a size on the host. On the
CPU it runs :func:`moe_gemm_plain`, the per-group loop. A CUDA tensor
never falls back to the plain version: an input the kernel does not take
raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def moe_gemm_plain(xs: torch.Tensor, w: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """xs [M, K], w [E, K, N], offsets [E + 1] -> [M, N] in xs' dtype: a
    loop over the groups with ``torch.matmul`` (reads ``offsets`` on the
    host)."""
    off = [int(v) for v in offsets.tolist()]
    out = torch.zeros((xs.shape[0], w.shape[2]), dtype=xs.dtype,
                      device=xs.device)
    for e in range(w.shape[0]):
        lo, hi = off[e], off[e + 1]
        if hi > lo:
            out[lo:hi] = xs[lo:hi] @ w[e]
    return out


def moe_gemm(xs: torch.Tensor, w: torch.Tensor,
             offsets: torch.Tensor) -> torch.Tensor:
    """xs [M, K], w [E, K, N] (last axis contiguous, e.g. a layer's view of
    the stacked ``[L, E, K, N]`` parameter), offsets [E + 1] int32 on xs'
    device -> [M, N] in xs' dtype."""
    if xs.device.type == "cpu":
        return moe_gemm_plain(xs, w, offsets)
    _check(xs, w, offsets)
    M, K = xs.shape
    E, _, N = w.shape
    out = torch.empty((M, N), dtype=xs.dtype, device=xs.device)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        build.launch("moe_gemm", xs.data_ptr(), w.data_ptr(),
                     offsets.data_ptr(), out.data_ptr(), _DTYPES[xs.dtype],
                     M, K, N, E, xs.stride(0), w.stride(0), w.stride(1),
                     out.stride(0), stream)
    moe_gemm.launches += 1
    return out


moe_gemm.launches = 0


def _check(xs, w, offsets) -> None:
    if xs.device.type != "cuda":
        raise ValueError(f"moe_gemm: no kernel for device {xs.device}")
    if w.device != xs.device or offsets.device != xs.device:
        raise ValueError("moe_gemm: inputs on different devices")
    if xs.dtype not in _DTYPES or w.dtype != xs.dtype:
        raise ValueError(f"moe_gemm: dtypes {xs.dtype}, {w.dtype}; the "
                         "kernel takes float32 or bfloat16, both alike")
    if offsets.dtype != torch.int32:
        raise ValueError(f"moe_gemm: offsets must be int32, not "
                         f"{offsets.dtype}")
    if xs.dim() != 2 or w.dim() != 3 or offsets.dim() != 1:
        raise ValueError("moe_gemm: xs [M, K], w [E, K, N], offsets [E + 1]")
    E, K, N = w.shape
    if xs.shape[1] != K or offsets.shape[0] != E + 1:
        raise ValueError(f"moe_gemm: shapes xs {tuple(xs.shape)}, w "
                         f"{tuple(w.shape)}, offsets {tuple(offsets.shape)} "
                         "do not agree")
    if xs.stride(1) != 1 or w.stride(2) != 1 or not offsets.is_contiguous():
        raise ValueError("moe_gemm: the last axis must be contiguous")
    vec = 16 // xs.element_size()     # the kernel loads 16-byte rows
    if K % vec or N % vec or xs.stride(0) % vec or w.stride(0) % vec or \
            w.stride(1) % vec or xs.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("moe_gemm: rows must start on 16-byte boundaries "
                         f"(K, N and strides a multiple of {vec} elements)")
