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

The bf16 kernel runs the work plan of :func:`moe_plan`, chosen from the
host-known shapes alone (M, N and E), so one plan serves every call of a
shape and a CUDA graph of it (the CPU tests in
``tests/test_torch_moe_plan.py`` hold a model of the kernel's tile walk).

Under autograd the CUDA call goes through :class:`MoeGemmFn`: dX runs on
the same kernel reading ``w`` transposed (a view, no copy of the stack),
dW on :func:`moe_gemm_wgrad` (``moe_gemm.cu``'s second entry point). On
the CPU autograd runs through the plain loop.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE_COLS = 128                 # a bf16 tile's columns (moe_gemm.cu fw::BN)


class MoePlan(NamedTuple):
    """A launch of the kernel: ``form`` "decode" or "bucket" (bf16, on
    ``wgmma``) or "scalar" (fp32); tiles of ``rows`` x ``cols``; grid
    (``col_tiles``, ``row_tiles``), the row tile slots bounding the tiles
    of any routing."""
    form: str
    rows: int
    cols: int
    row_tiles: int
    col_tiles: int

    @property
    def warpgroups(self) -> int:
        """Consumer warpgroups of a bf16 CTA (64 rows each)."""
        return self.rows // 64

    @property
    def grid(self) -> Tuple[int, int]:
        return self.col_tiles, self.row_tiles


@functools.lru_cache(maxsize=256)
def moe_plan(dtype: torch.dtype, M: int, N: int, E: int) -> MoePlan:
    """The kernel's plan for ``xs [M, K]``, ``w [E, K, N]``, from M, N and
    E alone: it never sees the group sizes, which lie on the device.

    Of the ``min(E, M)`` expert slots any routing fills at most ``M`` rows.
    bf16:
      - "bucket" where the rows exceed 64 a slot (a prefill bucket at
        granite's 48 experts): tiles of 128 rows on two consumer
        warpgroups, so an expert of ~100 rows reads its weights once a
        column tile.
      - "decode" otherwise: tiles of 64 rows on one consumer warpgroup.
    Both take 128 columns a tile, the whole of K, and ``M // rows +
    min(E, M)`` row tile slots (a slot with no tile leaves at once). fp32
    keeps the scalar kernel's grid: 64-column tiles by ``min(E, M)``
    expert slots."""
    slots = min(E, M)
    if dtype != torch.bfloat16:
        return MoePlan("scalar", 64, 64, slots, -(-N // 64))
    col_tiles = -(-N // TILE_COLS)
    if M > 64 * slots:
        return MoePlan("bucket", 128, TILE_COLS, M // 128 + slots, col_tiles)
    return MoePlan("decode", 64, TILE_COLS, M // 64 + slots, col_tiles)


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
    """xs [M, K], w [E, K, N] (one of its last two axes contiguous, e.g. a
    layer's view of the stacked ``[L, E, K, N]`` parameter or its
    transpose), offsets [E + 1] int32 on xs' device -> [M, N] in xs'
    dtype, differentiable in xs and w."""
    if xs.device.type == "cpu":
        return moe_gemm_plain(xs, w, offsets)
    if torch.is_grad_enabled() and (xs.requires_grad or w.requires_grad):
        return MoeGemmFn.apply(xs, w, offsets)
    return _launch(xs, w, offsets)


moe_gemm.launches = 0


def _launch(xs, w, offsets) -> torch.Tensor:
    _check(xs, w, offsets)
    M, K = xs.shape
    E, _, N = w.shape
    plan = moe_plan(xs.dtype, M, N, E)
    out = torch.empty((M, N), dtype=xs.dtype, device=xs.device)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        build.launch("moe_gemm", xs.data_ptr(), w.data_ptr(),
                     offsets.data_ptr(), out.data_ptr(), _DTYPES[xs.dtype],
                     M, K, N, E, plan.warpgroups, plan.row_tiles,
                     xs.stride(0), w.stride(0), w.stride(1),
                     w.stride(2), out.stride(0), stream)
    moe_gemm.launches += 1
    return out


class MoeGemmFn(torch.autograd.Function):
    """``moe_gemm`` on the card with its gradient: dX = dY · W[e]^T on the
    forward kernel with ``w`` read transposed, dW = xs^T · dY a group on
    :func:`moe_gemm_wgrad`."""

    @staticmethod
    def forward(ctx, xs, w, offsets):
        ctx.save_for_backward(xs, w, offsets)
        return _launch(xs, w, offsets)

    @staticmethod
    def backward(ctx, dy):
        xs, w, offsets = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _launch(dy, w.transpose(1, 2), offsets)
        if ctx.needs_input_grad[1]:
            dw = moe_gemm_wgrad(xs, dy, offsets, w.shape[0])
        return dx, dw, None


def moe_gemm_wgrad_plain(xs: torch.Tensor, dy: torch.Tensor,
                         offsets: torch.Tensor, n_experts: int
                         ) -> torch.Tensor:
    """dW [E, K, N] in xs' dtype: ``xs[lo:hi]^T @ dy[lo:hi]`` a group, zeros
    for an empty one (reads ``offsets`` on the host)."""
    off = [int(v) for v in offsets.tolist()]
    dw = torch.zeros((n_experts, xs.shape[1], dy.shape[1]), dtype=xs.dtype,
                     device=xs.device)
    for e in range(n_experts):
        lo, hi = off[e], off[e + 1]
        if hi > lo:
            dw[e] = (xs[lo:hi].float().t() @ dy[lo:hi].float()).to(xs.dtype)
    return dw


def moe_gemm_wgrad(xs: torch.Tensor, dy: torch.Tensor, offsets: torch.Tensor,
                   n_experts: int) -> torch.Tensor:
    """The weight gradient of :func:`moe_gemm`: xs [M, K], dy [M, N],
    offsets [E + 1] -> dW [E, K, N] in xs' dtype, every expert written
    (an empty one is 0). On the card one launch that reads the offsets
    from device memory and accumulates in fp32."""
    if xs.device.type == "cpu":
        return moe_gemm_wgrad_plain(xs, dy, offsets, n_experts)
    E = n_experts
    M, K = xs.shape
    N = dy.shape[1]
    w_like = torch.empty((E, K, N), dtype=xs.dtype, device=xs.device)
    _check(xs, w_like, offsets)
    _check(dy, w_like.transpose(1, 2), offsets)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        build.launch("moe_gemm_wgrad", xs.data_ptr(), dy.data_ptr(),
                     offsets.data_ptr(), w_like.data_ptr(),
                     _DTYPES[xs.dtype], M, K, N, E, xs.stride(0),
                     dy.stride(0), w_like.stride(0), w_like.stride(1),
                     stream)
    moe_gemm_wgrad.launches += 1
    return w_like


moe_gemm_wgrad.launches = 0


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
    if xs.stride(1) != 1 or 1 not in (w.stride(1), w.stride(2)) or \
            not offsets.is_contiguous():
        raise ValueError("moe_gemm: xs' last axis and one of w's last two "
                         "must be contiguous")
    vec = 16 // xs.element_size()     # the kernel loads 16-byte rows
    w_row = w.stride(1) if w.stride(2) == 1 else w.stride(2)
    if K % vec or N % vec or xs.stride(0) % vec or w.stride(0) % vec or \
            w_row % vec or xs.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("moe_gemm: rows must start on 16-byte boundaries "
                         f"(K, N and strides a multiple of {vec} elements)")
