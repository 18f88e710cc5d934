"""Device selection for the port's entry points.

Entry points default to the card. A caller that wants the CPU (the
tests) says so with ``device="cpu"``; a missing card is an error, never
a silent fall back to the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. Raises if a CUDA device is asked for and
    this machine has none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: a CUDA device was requested (the default) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path")
    return dev


def dtype_name(dtype: torch.dtype) -> str:
    """The dtype string the JAX package writes into keys and blobs."""
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    if dtype not in names:
        raise ValueError(f"unsupported cache dtype {dtype}")
    return names[dtype]


def dtype_from_name(name: str) -> torch.dtype:
    names = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in names:
        raise ValueError(f"unsupported blob dtype {name!r}")
    return names[name]
