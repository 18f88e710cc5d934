"""The v3 chunked state-blob container (transport side).

A copy of ``repro.core.chunkfmt`` on the port's own msgpack codec. A v3
blob is a header chunk (manifest and integrity digests) followed by
per-layer-group data chunks. At rest, in a cache server's store or in a
``put`` / ``get`` message, the chunks travel as one container::

    +-------+----------------------------------------+
    | b"PC3"| msgpack [header, chunk_1, ... chunk_K] |
    +-------+----------------------------------------+

so every layer that does not look inside a blob keeps working. What a
chunk holds (leaf manifests, codecs, int8 leaves) belongs to
:mod:`repro_torch.core.state_io`.
"""
from __future__ import annotations

from typing import List, Sequence

from repro_torch.core import packer

CHUNK_MAGIC = b"PC3"


def is_chunked(blob: bytes) -> bool:
    """True for a v3 container; a v2 blob starts with its codec tag
    (``ZST``, ``ZLB`` or ``RAW``)."""
    return bytes(blob[:3]) == CHUNK_MAGIC


def pack_container(chunks: Sequence[bytes]) -> bytes:
    """One storable blob from a chunk sequence."""
    return CHUNK_MAGIC + packer.packb(list(chunks))


def container_size(chunks: Sequence[bytes]) -> int:
    """``len(pack_container(chunks))``, without packing: the magic, the
    msgpack array header, and a bin header and body a chunk."""
    n = len(chunks)
    size = len(CHUNK_MAGIC) + (1 if n < 16 else 3 if n < 1 << 16 else 5)
    for c in chunks:
        k = len(c)
        size += k + (2 if k < 1 << 8 else 3 if k < 1 << 16 else 5)
    return size


def split_container(blob: bytes) -> List[bytes]:
    """The chunk sequence of a container. A v2 blob is its own single
    chunk, so the streaming ``get_chunks`` op serves it as a one-chunk
    stream. A corrupt container raises ``ValueError``."""
    if not is_chunked(blob):
        return [bytes(blob)]
    try:
        chunks = packer.unpackb(memoryview(blob)[3:])
    except Exception as e:
        raise ValueError(f"corrupt chunk container: {e!r}") from e
    if not isinstance(chunks, list) or not chunks or \
            not all(isinstance(c, bytes) for c in chunks):
        raise ValueError("corrupt chunk container: empty/non-list body")
    return chunks
