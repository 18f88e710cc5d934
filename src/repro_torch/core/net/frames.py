"""Versioned length-prefixed frames of the peer wire protocol.

A copy of ``repro.core.net.frames`` on the port's own msgpack codec
(:mod:`repro_torch.core.packer`), whose bytes equal
``msgpack.packb(obj, use_bin_type=True)`` for every value the wire
carries, so a port peer and a reference peer speak one protocol. Every
message on a peer socket is one frame::

    +-------+---------+-----+-------------+------------------+
    | magic | version | pad | length (u32)| msgpack payload  |
    | b"PC" |  1 byte | 1B  | little end. | ``length`` bytes |
    +-------+---------+-----+-------------+------------------+

The magic catches cross-protocol accidents (an HTTP client, a port
scan) before a length is trusted; the version byte makes a future wire
change fail loudly. Violations raise :class:`FrameError`, a
``ConnectionError``, so transports handle it on their socket-failure
path.

**Chunk streams**: a streamed response is a header frame carrying
``n_chunks``, then exactly that many ``{"chunk": <bytes>}`` frames, one
per state-blob chunk. The count bounds the stream, so a truncated stream
is a :class:`FrameError` at the next read, never a hang.

**Cancel frame** (client to server): while it reads a chunk stream the
client may send one ``{"cancel": True}`` frame. A server mid-stream
answers ``{"cancelled": True}`` in place of the next chunk frame and
stops; a cancel that arrives after the stream ended is dropped. Either
way the connection stays at a frame boundary and reusable.
"""
from __future__ import annotations

import struct
from typing import Optional

from repro_torch.core import packer

MAGIC = b"PC"
VERSION = 1
_HDR = struct.Struct("<2sBxI")          # magic, version, pad, payload len
HEADER_SIZE = _HDR.size
# a blob of a long prompt is tens of MB; 1 GiB bounds memory against a
# corrupt length field
MAX_FRAME_BYTES = 1 << 30


class FrameError(ConnectionError):
    """Malformed frame: bad magic, unknown version, oversized or
    truncated payload. The stream can no longer be trusted."""


def pack_payload(obj) -> bytes:
    return packer.packb(obj)


def unpack_payload(raw: bytes):
    """Decode a frame payload; any failure (corrupt bytes, trailing
    garbage) is a protocol violation."""
    try:
        return packer.unpackb(raw)
    except (ValueError, TypeError, UnicodeDecodeError) as e:
        raise FrameError(f"undecodable frame payload: {e!r}") from e


def encode_frame(obj, version: int = VERSION) -> bytes:
    payload = pack_payload(obj)
    if len(payload) > MAX_FRAME_BYTES:
        raise FrameError(f"frame payload {len(payload)}B exceeds "
                         f"{MAX_FRAME_BYTES}B limit")
    return _HDR.pack(MAGIC, version, len(payload)) + payload


def parse_header(hdr: bytes) -> int:
    """Validate a header; returns the payload length."""
    magic, version, n = _HDR.unpack(hdr)
    if magic != MAGIC:
        raise FrameError(f"bad frame magic {magic!r} (expected {MAGIC!r})")
    if version != VERSION:
        raise FrameError(f"unsupported frame version {version} "
                         f"(speaking {VERSION})")
    if n > MAX_FRAME_BYTES:
        raise FrameError(f"frame length {n}B exceeds limit")
    return n


# -- blocking sockets (client transports) ------------------------------------

def _recv_exact(sock, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], min(1 << 20, n - got))
        if not k:
            raise FrameError(f"connection closed mid-frame ({got}/{n} bytes)")
        got += k
    return bytes(buf)


def send_frame(sock, obj) -> int:
    """Send one frame; returns the bytes put on the wire."""
    data = encode_frame(obj)
    sock.sendall(data)
    return len(data)


def recv_frame_with_size(sock):
    """``(message, wire bytes: header and payload)`` of one frame;
    :class:`FrameError` on EOF or a violation."""
    n = parse_header(_recv_exact(sock, HEADER_SIZE))
    return unpack_payload(_recv_exact(sock, n)), HEADER_SIZE + n


# -- asyncio streams (peer server) -------------------------------------------

async def recv_frame_async(reader) -> Optional[tuple]:
    """``(message, wire_bytes)`` of one frame from a ``StreamReader``, or
    ``None`` on a clean EOF between frames; :class:`FrameError` on EOF
    mid-frame or a violation."""
    import asyncio
    try:
        hdr = await reader.readexactly(HEADER_SIZE)
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None                 # the peer hung up between requests
        raise FrameError(f"connection closed mid-header ({len(e.partial)}/"
                         f"{HEADER_SIZE} bytes)") from e
    n = parse_header(hdr)
    try:
        payload = await reader.readexactly(n)
    except asyncio.IncompleteReadError as e:
        raise FrameError(f"connection closed mid-frame ({len(e.partial)}/"
                         f"{n} bytes)") from e
    return unpack_payload(payload), HEADER_SIZE + n
