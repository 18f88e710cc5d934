"""Checkpoints in the reference's format (``repro.training.checkpoint``).

A checkpoint is one msgpack payload, ``{"step": int, "leaves": [{"path",
"shape", "dtype", "data"}, ...]}``, inside the blob codec frame of
``core/state_io`` (``codec="auto"``: zstd where ``zstandard`` imports,
else zlib; level 3), written through a temporary file and renamed. The
leaves and their paths are those of JAX's ``tree_flatten_with_path``:
dict keys sorted, lists by index, a NamedTuple's fields in order as
``.name`` (``opt/.count``, ``opt/.mu/segments/0/attn/wq``), so a
:class:`repro_torch.training.AdamWState` of ``params.to_tree`` trees is
laid out as the reference's ``AdamWState``. dtypes are numpy's names
(``float32``, ``bfloat16``, ``int32``), data the little-endian bytes. So
each package reads what the other wrote, and for the same tree and
codec the files are byte for byte equal.

``python -m repro_torch.training.checkpoint PATH`` prints a checkpoint's
step, leaf count, bytes and digest (blake2b of the payload as it reads
back); :func:`save` returns the same digest of what it wrote.
"""
from __future__ import annotations

import hashlib
import os
import sys
from typing import Any, List, Tuple

import numpy as np
import torch

from repro_torch.core.packer import pack_into, packb, unpackb
from repro_torch.core.state_io import _compress, _decompress

LEVEL = 3
_NP = {torch.float32: "float32", torch.bfloat16: "bfloat16",
       torch.int32: "int32"}
_TORCH = {v: k for k, v in _NP.items()}

Items = List[Tuple[str, torch.Tensor]]


def flatten(tree: Any, prefix: str = "") -> Items:
    """``(path, leaf)`` in JAX's flatten order (see the module
    docstring); ``None`` is an empty subtree, as in JAX."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [it for f in tree._fields
                for it in flatten(getattr(tree, f), f"{prefix}.{f}/")]
    if isinstance(tree, dict):
        return [it for k in sorted(tree)
                for it in flatten(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [it for i, v in enumerate(tree)
                for it in flatten(v, f"{prefix}{i}/")]
    return [(prefix[:-1], torch.as_tensor(tree))]


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def payload(items: Items, step: int = 0) -> bytes:
    """The msgpack body of a checkpoint of ``items``."""
    leaves = []
    for path, t in items:
        if t.dtype not in _NP:
            raise ValueError(f"checkpoint: leaf {path} of dtype {t.dtype}")
        a = _bits(t)
        leaves.append({"path": path, "shape": list(t.shape),
                       "dtype": _NP[t.dtype],
                       "data": memoryview(a).cast("B") if a.size else b""})
    return packb({"step": int(step), "leaves": leaves})


def digest(body: bytes) -> str:
    return hashlib.blake2b(body, digest_size=16).hexdigest()


def save(path: str, tree: Any, step: int = 0, codec: str = "auto") -> str:
    """Write ``tree`` (nested dicts / lists / NamedTuples of tensors) at
    ``step``. Returns the digest of the payload written."""
    body = payload(flatten(tree), step)
    raw = _compress(body, codec, LEVEL)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(raw)
    os.replace(tmp, path)
    return digest(body)


def _array(d: dict) -> np.ndarray:
    """A stored leaf's bytes as a numpy array of its shape (bf16 as its
    int16 bits), a view of them."""
    if d["dtype"] not in _TORCH:
        raise ValueError(f"checkpoint: leaf {d['path']} of dtype "
                         f"{d['dtype']!r}")
    np_dt = np.int16 if d["dtype"] == "bfloat16" else d["dtype"]
    return np.frombuffer(d["data"], dtype=np_dt).reshape(d["shape"])


def _leaf(d: dict) -> torch.Tensor:
    t = torch.from_numpy(_array(d).copy())
    return t.view(torch.bfloat16) if d["dtype"] == "bfloat16" else t


def read(path: str) -> Tuple[Items, int]:
    """Every leaf of a checkpoint, in its order, as CPU tensors, and its
    step."""
    with open(path, "rb") as f:
        body = _decompress(f.read())
    data = unpackb(body)
    return [(d["path"], _leaf(d)) for d in data["leaves"]], data["step"]


def load(path: str, template: Any) -> Tuple[Any, int]:
    """``template``'s tree with each leaf read from the checkpoint at
    ``path`` (CPU tensors; shapes must match). Returns ``(tree, step)``."""
    items, step = read(path)
    stored = dict(items)

    def fill(node, prefix=""):
        if node is None:
            return None
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(fill(getattr(node, f), f"{prefix}.{f}/")
                                for f in node._fields))
        if isinstance(node, dict):
            return {k: fill(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(fill(v, f"{prefix}{i}/")
                              for i, v in enumerate(node))
        key = prefix[:-1]
        if key not in stored:
            raise ValueError(f"checkpoint missing leaf {key}")
        t = stored[key]
        if tuple(t.shape) != tuple(np.shape(node)):
            raise ValueError(f"shape mismatch for {key}")
        return t
    return fill(template), step


class _Digest:
    """An ``append`` sink that hashes what it is given."""

    def __init__(self):
        self.h, self.n = hashlib.blake2b(digest_size=16), 0

    def append(self, piece: bytes) -> None:
        self.h.update(piece)
        self.n += len(piece)


def main(argv=None) -> None:
    """Read a checkpoint back: every leaf's bytes as its dtype and shape,
    then the digest of the payload those leaves pack to (no copy of the
    payload is joined, so a 10 GB checkpoint needs ~2x its size of
    memory)."""
    path = (argv or sys.argv[1:])[0]
    with open(path, "rb") as f:
        body = _decompress(f.read())
    data = unpackb(body)
    del body
    for d in data["leaves"]:           # each leaf's bytes as its array
        a = _array(d)
        d["data"] = memoryview(a).cast("B") if a.size else b""
    sink = _Digest()
    pack_into({"step": data["step"], "leaves": data["leaves"]}, sink)
    print(f"checkpoint {path}: step {data['step']}, {len(data['leaves'])} "
          f"leaves, {sink.n} bytes, digest {sink.h.hexdigest()}")


if __name__ == "__main__":
    main()
