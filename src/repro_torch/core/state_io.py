"""Prompt-cache state (de)serialization: v2 single-frame blobs and v3
chunked ``PC3`` containers.

The state blob is the paper's transferable artifact: the per-layer cache
cut to the prompt prefix, the last-token logits (so a full hit runs no
model at all) and a hash of the model metadata. This module writes and
reads the reference's two formats (``repro.core.state_io``) byte for
byte, so a JAX peer and a torch peer share one cache.

* **v2, single frame.** A 3-byte codec tag, ``ZST`` (zstandard), ``ZLB``
  (zlib) or ``RAW``, then a msgpack map ``{version: 2, meta_hash, n_eff,
  logits, leaves}``.
* **v3, chunked.** A header chunk ``{version: 3, meta_hash, n_eff,
  n_chunks, logits, chunks}`` whose ``chunks`` manifest gives each data
  chunk's segment, layer group ``[lo:hi)``, sequence band, size, 12-byte
  blake2b digest and pieces; then the data chunks, each a msgpack array
  of leaf buffers under its own codec tag. Chunks run segment-major, in
  layer groups of ``chunk_layers``, sequence bands minor: a sequence leaf
  is also cut at every range boundary, so :func:`extract_state_ranges`
  serializes the longest range once and every shorter range is a new
  header over a prefix of the same chunks. At rest the chunks travel as
  one container (:mod:`repro_torch.core.chunkfmt`); a streaming fetch
  feeds them one by one to a :class:`ChunkedRestorer`.

The leaves: one per cache tensor, in JAX's flatten order (dict keys
sorted), at paths such as ``segments/0/k``. Sequence leaves (``k``,
``v`` and MLA's ``ckv``, ``krope``; a MoE segment's cache is its
attention's) are cut to ``n_eff`` positions along axis 2 of ``[L, B, S,
...]``; state leaves (an SSM's ``conv`` and
``ssd``) ship whole, and so do an encoder-decoder's audio K/V
(``dec/cross_k``, ``dec/cross_v``; its ``dec/self/k`` and ``v`` are
cut). A chunk group is a segment (``segments/0``) or ``dec``. Each leaf
keeps its dtype string, ``float32`` or ``bfloat16`` (an SSM's ``ssd``
stays fp32 in a bf16 cache); bf16 travels
as its raw 16-bit pattern, since numpy has no bf16. With ``quantize``,
the leaves in ``QUANT_LEAVES`` travel as int8 with fp16 scales, one per
last-axis row. Logits travel as float16; ``meta_hash = blake2b(meta,
16)``.

Where the port differs from the reference, on purpose:

* A zero-layer segment (the empty MoE segment of deepseek-v3 cut to its
  dense layers). The reference writes no chunk for it and then cannot
  restore its own blob; its v2 writer cannot write it at all. The port
  writes one band-0 chunk with ``lo = hi = 0`` holding each leaf's empty
  piece, which the reference's reader accepts; and its reader counts a
  template leaf with no elements as covered, so it also restores the
  reference's blob. This chunk is the only place where the port's bytes
  differ from the reference's.
* Errors. Every fault of a fetched blob, a ``ZST`` blob where
  ``zstandard`` does not import included, raises ``ValueError`` (a v3
  stream's faults its subclass :class:`ChunkError`), which the client
  counts as a miss.
* Placement. The restorer writes each stored piece into its slice of
  the template, on the template's device: one host-to-device copy per
  piece and no whole-cache host buffer.
"""
from __future__ import annotations

import hashlib
import zlib
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import clock
from repro_torch.core import packer
from repro_torch.core.chunkfmt import (  # noqa: F401  (re-exported)
    CHUNK_MAGIC, is_chunked, pack_container, split_container)
from repro_torch.device import dtype_from_name, dtype_name
from repro_torch.models.common import tree_map

try:                                   # optional: nothing is installed for it
    import zstandard as zstd
except ImportError:
    zstd = None

SEQ_LEAVES = {"k", "v", "ckv", "krope"}
# int8 per-row quantization applies to the large K/V and latent leaves;
# SSM states ship unquantized
QUANT_LEAVES = {"k", "v", "ckv", "krope", "cross_k", "cross_v"}
FORMAT_VERSION = 2
CHUNK_VERSION = 3
_CHUNK_DIGEST_BYTES = 12

# one increment per walk over a cache: extract_state, and one for a whole
# extract_state_ranges call however many ranges it emits
STATS = {"serialize_passes": 0}


class ChunkError(ValueError):
    """A v3 chunk stream broke its manifest: a bad version, an
    out-of-order, truncated or corrupt chunk, a leaf the template lacks.
    The fetch is abandoned and counted as a miss."""


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


def _leaf_name(path: str) -> str:
    return path.rsplit("/", 1)[-1]


def _seg_key(path: str) -> str:
    """The segment a leaf belongs to: ``segments/0/k`` -> ``segments/0``.
    A segment's leaves share the leading layer axis, and a streamed
    resume consumes one (segment, layer group) at a time."""
    parts = path.split("/")
    if parts[0] == "segments" and len(parts) > 2:
        return "/".join(parts[:2])
    return parts[0]


def _host_bits(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host as a numpy array of its bits (bf16 as int16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _buf(arr: np.ndarray):
    """A byte view of a C-contiguous array for msgpack; empty bytes for an
    array with no elements (numpy refuses a byte view of one)."""
    return memoryview(arr).cast("B") if arr.size else b""


def _from_bytes(data: bytes, dtype: str, shape) -> torch.Tensor:
    td = dtype_from_name(dtype)
    if len(data) == 0:
        return torch.zeros(tuple(shape), dtype=td)
    raw = torch.frombuffer(bytearray(data),
                           dtype=torch.int16 if td == torch.bfloat16 else td)
    if td == torch.bfloat16:
        raw = raw.view(torch.bfloat16)
    return raw.reshape(tuple(shape))


def _quantize(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 over the last axis of an fp32 array: (q, scale
    fp16). A scale per last-axis row, so a sequence slice of (q, scale)
    equals quantizing the slice: range uploads share quantized chunks."""
    scale = np.max(np.abs(a), axis=-1, keepdims=True) / 127.0
    scale = np.where(scale == 0, 1.0, scale)
    q = np.clip(np.round(a / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float16)


def _dequantize(q: np.ndarray, scale: np.ndarray, dtype: str
                ) -> torch.Tensor:
    """The reference's fp32 multiply, then a round-to-nearest-even cast
    to the leaf's dtype."""
    prod = q.astype(np.float32) * scale.astype(np.float32)
    return torch.from_numpy(prod).to(dtype_from_name(dtype))


def _quantizable(name: str, t: torch.Tensor) -> bool:
    return name in QUANT_LEAVES and t.ndim >= 3


def _fp16_bytes(logits) -> bytes:
    """Logits as float16 bytes. The masked tail of a padded vocab (-1e30)
    becomes -inf, as in the reference's blobs."""
    with np.errstate(over="ignore"):
        return np.asarray(logits, np.float16).tobytes()


def _logits_entry(logits) -> Optional[dict]:
    if logits is None:
        return None
    return {"shape": list(np.shape(logits)), "data": _fp16_bytes(logits)}


def default_codec() -> str:
    """zstd where ``zstandard`` imports, else zlib (the reference's
    ``auto``)."""
    return "zstd" if zstd is not None else "zlib"


def _compress(raw: bytes, codec: str, level: int) -> bytes:
    if codec == "auto":
        codec = default_codec()
    if codec == "zstd":
        if zstd is None:
            raise RuntimeError("zstd codec requested but zstandard does not "
                               "import; use codec='zlib' or 'auto'")
        return b"ZST" + zstd.ZstdCompressor(level=level).compress(raw)
    if codec == "zlib":
        return b"ZLB" + zlib.compress(raw, min(max(level, 1), 9))
    raise ValueError(f"unknown codec {codec!r}")


def _decompress(blob) -> bytes:
    tag, body = bytes(blob[:3]), blob[3:]
    if tag == b"ZST" and zstd is None:
        raise ValueError("state blob is zstd-compressed (ZST) and "
                         "zstandard does not import here")
    try:
        if tag == b"ZLB":
            return zlib.decompress(body)
        if tag == b"RAW":
            return bytes(body)
        if tag == b"ZST":
            return zstd.ZstdDecompressor().decompress(body)
    except Exception as e:             # zlib.error, zstd.ZstdError
        raise ValueError(f"undecodable {tag!r} body: {e!r}") from e
    raise ValueError("bad state blob tag")


# ---------------------------------------------------------------------------
# v2: single-frame blobs
# ---------------------------------------------------------------------------

def extract_state(cache, n_eff: int, meta: bytes,
                  logits: Optional[np.ndarray] = None,
                  compress: bool = True, level: int = 1,
                  quantize: bool = False, codec: str = "zlib") -> bytes:
    """Serialize ``cache`` cut to ``n_eff`` positions as a v2 blob. The
    codec defaults to zlib, as this writer always wrote (the client now
    writes v3); ``auto`` is the reference's default."""
    STATS["serialize_passes"] += 1
    leaves = []
    for path, t in _flatten(cache):
        name = _leaf_name(path)
        if name in SEQ_LEAVES:
            t = t[:, :, :min(int(n_eff), t.shape[2])]
        entry = {"path": path, "shape": list(t.shape),
                 "dtype": dtype_name(t.dtype)}
        if quantize and _quantizable(name, t):
            q, scale = _quantize(t.detach().cpu().float().numpy())
            entry["data"] = _buf(q)
            entry["q_scale"] = _buf(scale)
            entry["q_scale_shape"] = list(scale.shape)
        else:
            entry["data"] = _buf(np.ascontiguousarray(_host_bits(t)))
        leaves.append(entry)
    payload = {
        "version": FORMAT_VERSION,
        "meta_hash": hashlib.blake2b(meta, digest_size=16).digest(),
        "n_eff": int(n_eff),
        "logits": _logits_entry(logits),
        "leaves": leaves,
    }
    raw = packer.packb(payload)
    return _compress(raw, codec, level) if compress else b"RAW" + raw


# ---------------------------------------------------------------------------
# v3: chunked, one serialization pass for every range
# ---------------------------------------------------------------------------

def extract_state_ranges(cache, n_effs: Sequence[int], meta: bytes,
                         logits: Optional[np.ndarray] = None,
                         compress: bool = True, level: int = 1,
                         quantize: bool = False, codec: str = "auto",
                         chunk_layers: int = 1) -> Dict[int, List[bytes]]:
    """ONE serialization pass over ``cache``; a chunk list per prefix
    length in ``n_effs``.

    A chunk is keyed (segment, layer group of ``chunk_layers``, sequence
    band): sequence leaves are cut at the ``n_effs`` boundaries, state
    leaves ride band 0 whole. The longest range owns every chunk; a
    shorter range's list is its own header over the same chunk bytes
    restricted to its bands. ``logits`` go to the longest range only.
    Returns ``{n_eff: [header, chunk, ...]}``; wrap a list with
    :func:`pack_container` to store it."""
    bounds = sorted({int(n) for n in n_effs})
    if not bounds:
        raise ValueError("need at least one range length")
    n_max = bounds[-1]
    STATS["serialize_passes"] += 1
    meta_hash = hashlib.blake2b(meta, digest_size=16).digest()

    seg_order: List[str] = []
    by_seg: Dict[str, list] = {}
    for path, t in _flatten(cache):
        sk = _seg_key(path)
        if sk not in by_seg:
            by_seg[sk] = []
            seg_order.append(sk)
        by_seg[sk].append((path, _leaf_name(path), t))

    manifests: List[dict] = []
    bodies: List[bytes] = []
    for sk in seg_order:
        entries = by_seg[sk]
        n_layers = entries[0][2].shape[0]
        step = max(int(chunk_layers), 1)
        prepared = []
        for path, name, t in entries:
            if name in SEQ_LEAVES:
                keep = min(n_max, t.shape[2])
                t = t[:, :, :keep]
                # band edges: the range boundaries clipped to the leaf
                cuts = [0] + sorted({min(b, keep) for b in bounds})
            else:
                cuts = None            # whole leaf, band 0 only
            if quantize and _quantizable(name, t):
                qa, scale = _quantize(t.detach().cpu().float().numpy())
            else:
                qa, scale = _host_bits(t), None
            prepared.append((path, qa, scale, cuts, dtype_name(t.dtype)))
        groups = [(lo, min(lo + step, n_layers))
                  for lo in range(0, n_layers, step)]
        bands = range(len(bounds))
        if not n_layers:
            # a zero-layer segment gets one band-0 chunk of empty pieces,
            # so a reader finds every leaf of the tree in the manifest
            groups, bands = [(0, 0)], [0]
        for lo, hi in groups:
            for band in bands:
                pieces, bufs = [], []
                for path, qa, scale, cuts, dt in prepared:
                    if cuts is None:
                        if band:
                            continue   # state leaves ride band 0
                        b0 = None
                        piece = qa[lo:hi]
                        sp = scale[lo:hi] if scale is not None else None
                    else:
                        if band + 1 >= len(cuts):
                            continue   # the leaf is already covered
                        b0, b1 = cuts[band], cuts[band + 1]
                        if b1 <= b0:
                            continue
                        piece = qa[lo:hi, :, b0:b1]
                        sp = scale[lo:hi, :, b0:b1] \
                            if scale is not None else None
                    piece = np.ascontiguousarray(piece)
                    ent = {"path": path, "shape": list(piece.shape),
                           "dtype": dt, "off": 0 if b0 is None else b0}
                    bufs.append(_buf(piece))
                    if sp is not None:
                        sp = np.ascontiguousarray(sp)
                        ent["q_scale_shape"] = list(sp.shape)
                        bufs.append(_buf(sp))
                    pieces.append(ent)
                if not pieces:
                    continue
                raw = packer.packb(bufs)
                body = _compress(raw, codec, level) if compress \
                    else b"RAW" + raw
                manifests.append({
                    "seg": sk, "lo": lo, "hi": hi, "band": band,
                    "nbytes": len(body),
                    "digest": hashlib.blake2b(
                        body, digest_size=_CHUNK_DIGEST_BYTES).digest(),
                    "pieces": pieces,
                })
                bodies.append(body)

    def header(n_eff: int, with_logits: bool, idx: List[int]) -> bytes:
        hdr = {
            "version": CHUNK_VERSION,
            "meta_hash": meta_hash,
            "n_eff": int(n_eff),
            "n_chunks": len(idx),
            "logits": _logits_entry(logits if with_logits else None),
            "chunks": [manifests[i] for i in idx],
        }
        raw = packer.packb(hdr)
        return _compress(raw, codec, level) if compress else b"RAW" + raw

    out: Dict[int, List[bytes]] = {}
    for bi, n_eff in enumerate(bounds):
        # bands above bi hold positions past this range: left out
        idx = [i for i, m in enumerate(manifests) if m["band"] <= bi]
        out[n_eff] = [header(n_eff, n_eff == n_max, idx)] + \
            [bodies[i] for i in idx]
    return out


def extract_state_chunks(cache, n_eff: int, meta: bytes,
                         logits: Optional[np.ndarray] = None,
                         **kw) -> List[bytes]:
    """The v3 chunk list of one prefix length (one serialization pass)."""
    return extract_state_ranges(cache, [n_eff], meta, logits=logits,
                                **kw)[int(n_eff)]


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------

def segment_index(seg: str) -> int:
    """``segments/3`` -> 3: the model segment a chunk group belongs to (a
    streamed resume runs segments; an encoder-decoder's ``dec`` is
    none)."""
    parts = seg.split("/")
    if len(parts) != 2 or parts[0] != "segments" or not parts[1].isdigit():
        raise ChunkError(f"chunk group of an unknown segment {seg!r}")
    return int(parts[1])


def _segment_of(template, seg: str) -> Dict[str, Any]:
    """The subtree of ``template`` at a chunk group's path, as the
    reference walks it: ``segments/3`` (a segment), or ``dec`` (an
    encoder-decoder's decoder)."""
    sub = template
    try:
        for part in seg.split("/"):
            sub = sub[int(part)] if part.isdigit() else sub[part]
    except (KeyError, IndexError, TypeError) as e:
        raise ChunkError(f"segment {seg!r} not in the restore template"
                         ) from e
    if not isinstance(sub, dict):
        raise ChunkError(f"chunk group {seg!r} is a leaf of the template")
    return sub


class ChunkedRestorer:
    """Incremental reader of a v3 chunk stream.

    :meth:`feed` takes the chunks in wire order. It checks the header's
    version and model hash, and each data chunk's size and integrity
    digest against the manifest, and raises :class:`ChunkError` as soon
    as the stream breaks it. It returns the layer groups ``(seg, lo,
    hi)`` that chunk completed, in stream (= compute) order.
    :meth:`group_tree` writes one group's pieces into the template and
    returns that segment's leaves cut to layers ``[lo:hi)``: what a
    streamed resume runs on; :meth:`result` writes the whole cache.

    A v2 blob fed as the only chunk is accepted (:attr:`v2_payload`), so
    a streaming client reads what an older peer stores.

    ``phase_s`` adds up the seconds spent in each phase: ``header``
    (decode of the header chunk), ``digest``, ``inflate``, ``unpack``
    (msgpack and bytes to tensors, int8 dequantized) and ``place`` (the
    copies into the template; asynchronous on a card, so a caller that
    times it synchronises first).
    """

    def __init__(self, meta: bytes):
        self.meta = meta
        self.header: Optional[dict] = None
        self.v2_payload: Optional[dict] = None
        self.fed = 0
        self.bytes_fed = 0
        self.bytes_inflated = 0
        self.phase_s = {"header": 0.0, "digest": 0.0, "inflate": 0.0,
                        "unpack": 0.0, "place": 0.0}
        self._chunks: List[bytes] = []
        self._pieces: Dict[Tuple[str, int, int], list] = {}
        self._order: List[Tuple[str, int, int]] = []
        self._remaining: Dict[Tuple[str, int, int], int] = {}

    # -- stream ingestion -------------------------------------------------
    def feed(self, chunk: bytes) -> List[Tuple[str, int, int]]:
        chunk = bytes(chunk)
        if self.fed == 0:
            t0 = clock.monotonic()
            self._feed_header(chunk)
            self.phase_s["header"] += clock.monotonic() - t0
            self.fed = 1
            self.bytes_fed += len(chunk)
            self._chunks.append(chunk)
            return []
        if self.v2_payload is not None:
            raise ChunkError("trailing chunk after a v2 single-frame blob")
        if self.header is None or self.fed > self.header["n_chunks"]:
            raise ChunkError("chunk beyond the manifest's n_chunks")
        man = self.header["chunks"][self.fed - 1]
        if len(chunk) != man["nbytes"]:
            raise ChunkError(f"chunk {self.fed} size {len(chunk)} != "
                             f"manifest {man['nbytes']} (truncated/corrupt "
                             f"stream)")
        t0 = clock.monotonic()
        got = hashlib.blake2b(chunk, digest_size=_CHUNK_DIGEST_BYTES).digest()
        t1 = clock.monotonic()
        self.phase_s["digest"] += t1 - t0
        if got != bytes(man["digest"]):
            raise ChunkError(f"chunk {self.fed} integrity digest mismatch")
        try:
            raw = _decompress(chunk)
            self.bytes_inflated += len(raw)
            t2 = clock.monotonic()
            self.phase_s["inflate"] += t2 - t1
            arrs = self._decode_pieces(man["pieces"], packer.unpackb(raw))
            self.phase_s["unpack"] += clock.monotonic() - t2
        except ChunkError:
            raise
        except Exception as e:
            raise ChunkError(f"undecodable chunk {self.fed}: {e!r}") from e
        gid = (man["seg"], int(man["lo"]), int(man["hi"]))
        self._pieces.setdefault(gid, []).extend(arrs)
        self._remaining[gid] -= 1
        self.fed += 1
        self.bytes_fed += len(chunk)
        self._chunks.append(chunk)
        done = []
        while self._order and self._remaining[self._order[0]] == 0:
            done.append(self._order.pop(0))
        return done

    def _feed_header(self, chunk: bytes) -> None:
        try:
            payload = packer.unpackb(_decompress(chunk))
        except Exception as e:
            raise ChunkError(f"undecodable header chunk: {e!r}") from e
        if not isinstance(payload, dict):
            raise ChunkError("header chunk is not a map")
        version = payload.get("version")
        want = hashlib.blake2b(self.meta, digest_size=16).digest()
        if payload.get("meta_hash") != want:
            raise ValueError("state blob was produced by a different model "
                             "configuration (integrity check failed)")
        if version == FORMAT_VERSION:          # a v2 blob, one chunk
            if not isinstance(payload.get("leaves"), list):
                raise ChunkError("v2 blob without a leaf list")
            self.v2_payload = payload
            return
        if version != CHUNK_VERSION:
            raise ChunkError(f"unsupported chunk-stream version {version!r}")
        chunks = payload.get("chunks")
        if not isinstance(chunks, list) or \
                payload.get("n_chunks") != len(chunks):
            raise ChunkError("header manifest inconsistent with n_chunks")
        try:
            for man in chunks:
                if not isinstance(man.get("pieces"), list) or \
                        not isinstance(man["nbytes"], int) or \
                        not isinstance(man["digest"], bytes):
                    raise ValueError("bad manifest entry")
                gid = (man["seg"], int(man["lo"]), int(man["hi"]))
                if gid not in self._remaining:
                    self._remaining[gid] = 0
                    self._order.append(gid)
                self._remaining[gid] += 1
        except (AttributeError, KeyError, TypeError, ValueError) as e:
            raise ChunkError(f"malformed chunk manifest: {e!r}") from e
        self.header = payload

    @staticmethod
    def _decode_pieces(manifest_pieces: list, bufs: list) -> list:
        out, bi = [], 0
        for ent in manifest_pieces:
            if bi >= len(bufs):
                raise ChunkError("chunk body has fewer buffers than its "
                                 "manifest")
            if "q_scale_shape" in ent:
                # int8 data and fp16 row scales; ent["dtype"] is the target
                q = np.frombuffer(bufs[bi], np.int8).reshape(ent["shape"])
                scale = np.frombuffer(bufs[bi + 1], np.float16).reshape(
                    ent["q_scale_shape"])
                bi += 2
                arr = _dequantize(q, scale, ent["dtype"])
            else:
                arr = _from_bytes(bufs[bi], ent["dtype"], ent["shape"])
                bi += 1
            out.append((ent["path"], int(ent.get("off", 0)), arr))
        return out

    # -- state ------------------------------------------------------------
    @property
    def complete(self) -> bool:
        if self.v2_payload is not None:
            return True
        return self.header is not None and \
            self.fed == self.header["n_chunks"] + 1

    @property
    def n_eff(self) -> int:
        src = self.v2_payload or self.header
        if src is None:
            raise ChunkError("no header chunk fed yet")
        return int(src["n_eff"])

    def logits(self) -> Optional[np.ndarray]:
        src = self.v2_payload or self.header or {}
        lg = src.get("logits")
        if not lg:
            return None
        return np.frombuffer(lg["data"], np.float16).reshape(
            lg["shape"]).astype(np.float32)

    def raw_chunks(self) -> List[bytes]:
        """The chunks as fed: :func:`pack_container` stores them again
        with no second serialization."""
        return list(self._chunks)

    # -- placement ----------------------------------------------------------
    @staticmethod
    def _place(dst: torch.Tensor, off: int, arr: torch.Tensor,
               path: str) -> None:
        """Copy one piece into ``dst`` (a view of a template leaf)."""
        if tuple(arr.shape) == tuple(dst.shape) and off == 0:
            dst.copy_(arr)
            return
        if _leaf_name(path) not in SEQ_LEAVES:
            raise ChunkError(f"shape mismatch on state leaf {path}: "
                             f"{tuple(arr.shape)} vs {tuple(dst.shape)}")
        end = off + arr.shape[2]
        if end > dst.shape[2] or arr.shape[:2] != dst.shape[:2] \
                or arr.shape[3:] != dst.shape[3:]:
            raise ChunkError(f"stored prefix exceeds engine cache on {path}: "
                             f"{tuple(arr.shape)}@{off} vs "
                             f"{tuple(dst.shape)}")
        dst[:, :, off:end].copy_(arr)

    def _place_group(self, gid, leaves: Dict[str, torch.Tensor]) -> set:
        """Write group ``gid``'s pieces into the template ``leaves``
        (path -> full leaf); returns the paths written."""
        t0 = clock.monotonic()
        _, lo, hi = gid
        done = set()
        for path, off, arr in self._pieces.get(gid, []):
            leaf = leaves.get(path)
            if leaf is None:
                raise ChunkError(f"blob leaf {path} not in the restore "
                                 f"template")
            self._place(leaf[lo:hi], off, arr, path)
            done.add(path)
        self.phase_s["place"] += clock.monotonic() - t0
        return done

    def group_tree(self, gid: Tuple[str, int, int], template
                   ) -> Dict[str, torch.Tensor]:
        """Write group ``gid`` = (seg, lo, hi) into ``template`` and return
        that segment's leaves cut to layers ``[lo:hi)``, views of the
        template: a streamed resume runs those layers on them in place.
        Positions the blob does not hold keep the template's values."""
        seg, lo, hi = gid
        leaves = _segment_of(template, seg)
        self._place_group(gid, dict(_flatten(leaves, f"{seg}/")))
        return tree_map(lambda t: t[lo:hi], leaves)

    def result(self, template):
        """Write the whole stored cache into ``template`` and return
        ``(template, n_eff, logits|None)``. Raises on an incomplete stream
        or a template leaf with elements that no chunk covers."""
        if self.v2_payload is not None:
            return restore_state(self.v2_payload, template)
        if not self.complete:
            raise ChunkError(
                f"chunk stream incomplete ({self.fed - 1}/"
                f"{0 if self.header is None else self.header['n_chunks']}"
                f" data chunks)")
        leaves = dict(_flatten(template))
        covered = set()
        for gid in self._pieces:
            covered |= self._place_group(gid, leaves)
        missing = sorted(p for p, t in leaves.items()
                         if p not in covered and t.numel())
        if missing:
            raise ChunkError(f"blob missing leaves {missing}")
        return template, self.n_eff, self.logits()


def parse_state(blob: bytes, meta: bytes) -> Dict[str, Any]:
    """Decode and check a blob of either format; the payload goes to
    :func:`restore_state`. A v3 container is read through a
    :class:`ChunkedRestorer` (its payload carries it); a fault of the
    blob raises ``ValueError`` (:class:`ChunkError` for v3)."""
    if is_chunked(blob):
        try:
            chunks = split_container(blob)
        except ValueError as e:
            raise ChunkError(str(e)) from e
        r = ChunkedRestorer(meta)
        for c in chunks:
            r.feed(c)
        if r.v2_payload is not None:
            return r.v2_payload
        if not r.complete:
            raise ChunkError("container holds an incomplete chunk stream")
        return {"version": CHUNK_VERSION, "n_eff": r.n_eff,
                "logits": r.header.get("logits"), "_restorer": r}
    payload = packer.unpackb(_decompress(blob))
    if not isinstance(payload, dict) or \
            payload.get("version") != FORMAT_VERSION:
        raise ValueError("state blob version mismatch")
    want = hashlib.blake2b(meta, digest_size=16).digest()
    if payload.get("meta_hash") != want:
        raise ValueError("state blob was produced by a different model "
                         "configuration (integrity check failed)")
    return payload


def _v2_leaf(d: dict) -> torch.Tensor:
    try:
        if "q_scale" in d:
            q = np.frombuffer(d["data"], np.int8).reshape(d["shape"])
            scale = np.frombuffer(d["q_scale"], np.float16).reshape(
                d["q_scale_shape"])
            return _dequantize(q, scale, d["dtype"])
        return _from_bytes(d["data"], d["dtype"], d["shape"])
    except (KeyError, TypeError, RuntimeError) as e:
        raise ValueError(f"undecodable leaf {d.get('path')}: {e!r}") from e


def restore_state(payload: Dict[str, Any], template
                  ) -> Tuple[Any, int, Optional[np.ndarray]]:
    """Write the stored leaves into ``template`` (a fresh cache of the
    engine's size) IN PLACE and return ``(template, n_eff, logits|None)``.
    A sequence leaf may be shorter than the template: it fills the first
    positions and the rest stays as the template had it."""
    if "_restorer" in payload:
        return payload["_restorer"].result(template)
    stored = {d["path"]: d for d in payload["leaves"]}
    for path, leaf in _flatten(template):
        d = stored.get(path)
        if d is None:
            raise ValueError(f"blob missing leaf {path}")
        # to the leaf's device first: the strided write below then runs
        # there, not as a strided copy on the host
        arr = _v2_leaf(d).to(leaf.device)
        shape = tuple(leaf.shape)
        if tuple(arr.shape) != shape:
            if _leaf_name(path) not in SEQ_LEAVES:
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
