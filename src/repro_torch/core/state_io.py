"""Prompt-cache state (de)serialization, v2 single-frame blobs.

The state blob is the paper's transferable artifact: the per-layer KV
cache cut to the prompt prefix, the last-token logits (so a full hit
runs no model at all) and a hash of the model metadata. This module
writes and reads the reference's v2 format byte for byte:

* a 3-byte codec tag, ``ZLB`` (zlib) or ``RAW``, then a msgpack map
  ``{version: 2, meta_hash, n_eff, logits, leaves}``;
* one leaf per cache tensor, in JAX's flatten order (dict keys sorted),
  at paths such as ``segments/0/k``; sequence leaves (``k``, ``v`` and
  MLA's ``ckv``, ``krope``) are cut to ``n_eff`` positions along axis 2
  of ``[L, B, S, ...]``, and state leaves (an SSM's ``conv`` and ``ssd``)
  ship whole; a leaf with no elements (an empty MoE segment's, ``L = 0``)
  is written as an empty buffer of its shape;
* each leaf's own dtype string, ``float32`` / ``bfloat16`` (an SSM's
  ``ssd`` stays fp32 in a bf16 cache; bf16 travels as the raw 16-bit
  pattern, through an ``int16`` view, since numpy has no bf16);
* logits as float16 bytes; ``meta_hash = blake2b(meta, 16)``.

A JAX peer reads this port's blobs and the other way round. The ``ZST``
codec and the v3 chunked ``PC3`` container are later work: both raise.
"""
from __future__ import annotations

import hashlib
import zlib
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import packer
from repro_torch.device import dtype_from_name, dtype_name

SEQ_LEAVES = {"k", "v", "ckv", "krope"}
FORMAT_VERSION = 2
CHUNK_MAGIC = b"PC3"


def _flatten(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) pairs in JAX's flatten order: dict keys sorted,
    lists in index order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _flatten(item, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _to_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _from_bytes(data: bytes, dtype: str, shape) -> torch.Tensor:
    td = dtype_from_name(dtype)
    if len(data) == 0:
        return torch.zeros(tuple(shape), dtype=td)
    raw = torch.frombuffer(bytearray(data),
                           dtype=torch.int16 if td == torch.bfloat16 else td)
    if td == torch.bfloat16:
        raw = raw.view(torch.bfloat16)
    return raw.reshape(tuple(shape))


def _compress(raw: bytes, level: int) -> bytes:
    return b"ZLB" + zlib.compress(raw, min(max(level, 1), 9))


def _decompress(blob: bytes) -> bytes:
    tag, body = bytes(blob[:3]), blob[3:]
    if tag == b"ZLB":
        return zlib.decompress(body)
    if tag == b"RAW":
        return bytes(body)
    if tag == b"ZST":
        raise ValueError("state blob is zstd-compressed (ZST); this port "
                         "reads ZLB and RAW blobs only")
    raise ValueError("bad state blob tag")


def _fp16_bytes(logits) -> bytes:
    """Logits as float16 bytes. The masked tail of a padded vocab (-1e30)
    becomes -inf, as in the reference's blobs."""
    with np.errstate(over="ignore"):
        return np.asarray(logits, np.float16).tobytes()


def extract_state(cache, n_eff: int, meta: bytes,
                  logits: Optional[np.ndarray] = None,
                  compress: bool = True, level: int = 1) -> bytes:
    """Serialize ``cache`` cut to ``n_eff`` positions as a v2 blob."""
    leaves = []
    for path, t in _flatten(cache):
        name = path.rsplit("/", 1)[-1]
        if name in SEQ_LEAVES:
            t = t[:, :, :min(int(n_eff), t.shape[2])]
        leaves.append({"path": path, "shape": list(t.shape),
                       "dtype": dtype_name(t.dtype), "data": _to_bytes(t)})
    payload = {
        "version": FORMAT_VERSION,
        "meta_hash": hashlib.blake2b(meta, digest_size=16).digest(),
        "n_eff": int(n_eff),
        "logits": (None if logits is None else {
            "shape": list(np.shape(logits)),
            "data": _fp16_bytes(logits),
        }),
        "leaves": leaves,
    }
    raw = packer.packb(payload)
    return _compress(raw, level) if compress else b"RAW" + raw


def parse_state(blob: bytes, meta: bytes) -> Dict[str, Any]:
    """Decode and check a v2 blob; the payload goes to
    :func:`restore_state`."""
    if bytes(blob[:3]) == CHUNK_MAGIC:
        raise NotImplementedError(
            "v3 chunked (PC3) state blobs are not read by this port yet "
            "(ROADMAP Queue 1, item 4: v3 PC3 chunks and resume_streamed)")
    payload = packer.unpackb(_decompress(blob))
    if payload.get("version") != FORMAT_VERSION:
        raise ValueError("state blob version mismatch")
    want = hashlib.blake2b(meta, digest_size=16).digest()
    if payload.get("meta_hash") != want:
        raise ValueError("state blob was produced by a different model "
                         "configuration (integrity check failed)")
    return payload


def restore_state(payload: Dict[str, Any], template
                  ) -> Tuple[Any, int, Optional[np.ndarray]]:
    """Write the stored leaves into ``template`` (a fresh cache of the
    engine's size) IN PLACE and return ``(template, n_eff, logits|None)``.
    A sequence leaf may be shorter than the template: it fills the first
    positions and the rest stays as the template had it."""
    stored = {d["path"]: d for d in payload["leaves"]}
    for path, leaf in _flatten(template):
        d = stored.get(path)
        if d is None:
            raise ValueError(f"blob missing leaf {path}")
        if "q_scale" in d:
            raise ValueError(f"leaf {path} is int8-quantized; this port "
                             "reads unquantized blobs only")
        # to the leaf's device first: the strided write below then runs
        # there, not as a strided copy on the host
        arr = _from_bytes(d["data"], d["dtype"], d["shape"]).to(leaf.device)
        shape = tuple(leaf.shape)
        if tuple(arr.shape) != shape:
            name = path.rsplit("/", 1)[-1]
            if name not in SEQ_LEAVES:
                raise ValueError(f"shape mismatch on {path}")
            if arr.shape[2] > shape[2] or tuple(arr.shape[:2]) != shape[:2] \
                    or tuple(arr.shape[3:]) != shape[3:]:
                raise ValueError(
                    f"stored prefix longer than engine cache on {path}: "
                    f"{tuple(arr.shape)} vs {shape}")
            leaf[:, :, :arr.shape[2]].copy_(arr)
        else:
            leaf.copy_(arr)
    logits = None
    if payload.get("logits"):
        lg = payload["logits"]
        logits = np.frombuffer(lg["data"], np.float16).reshape(
            lg["shape"]).astype(np.float32)
    return template, int(payload["n_eff"]), logits
