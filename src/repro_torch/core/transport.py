"""In-process transport between an edge client and the cache server.

The request runs in this process. The transport encodes the request and
the response as msgpack frames, as a wire would, and reports the bytes
and the wall time of the whole exchange. Every request returns
``(response, wall_seconds, n_bytes)``, the reference transport's
contract; :meth:`InProcTransport.request_stream` delivers a response's
chunks one at a time. The simulated network, TCP and the multi-peer
fabric are later slices of the port.
"""
from __future__ import annotations

from typing import Callable, Tuple

from repro_torch import clock
from repro_torch.core import packer
from repro_torch.core.server import CacheServer

CHUNK_FRAME_BYTES = 16             # the reference's per-chunk frame overhead


class StreamCancelled(Exception):
    """A chunk stream was cancelled by its client between two chunks."""


class InProcTransport:
    def __init__(self, server: CacheServer):
        self.server = server

    def request(self, op: str, payload: dict) -> Tuple[dict, float, int]:
        t0 = clock.monotonic()
        nbytes = len(packer.packb({"op": op, **payload}))
        resp = self.server.handle(op, payload)
        nbytes += len(packer.packb(resp))
        return resp, clock.monotonic() - t0, nbytes

    def request_stream(self, op: str, payload: dict,
                       on_chunk: Callable[[bytes, float, int], None],
                       cancel=None) -> Tuple[dict, float, int]:
        """A streamed request: the response's ``chunks`` go to
        ``on_chunk(chunk, seconds, nbytes)`` one at a time, each with the
        wall seconds the transport spent on it and its bytes on the wire
        (``len(chunk) + 16``). ``cancel`` (anything with ``is_set()``) is
        checked between chunks and raises :class:`StreamCancelled`.
        Returns ``(header, seconds, nbytes)``: the response without its
        chunks, with ``n_chunks``; the transport's own wall seconds (the
        time inside ``on_chunk`` is the caller's, not counted); and the
        bytes of the whole exchange."""
        t0 = clock.monotonic()
        nbytes = len(packer.packb({"op": op, **payload}))
        resp = self.server.handle(op, payload)
        chunks = resp.get("chunks") or []
        header = {k: v for k, v in resp.items() if k != "chunks"}
        header["n_chunks"] = len(chunks)
        nbytes += len(packer.packb(header))
        seconds = clock.monotonic() - t0
        for c in chunks:
            if cancel is not None and cancel.is_set():
                raise StreamCancelled(f"stream {op!r} cancelled after "
                                      f"{nbytes} bytes")
            t = clock.monotonic()
            chunk = bytes(c)
            nb = len(chunk) + CHUNK_FRAME_BYTES
            dt = clock.monotonic() - t
            seconds += dt
            nbytes += nb
            on_chunk(chunk, dt, nb)
        return header, seconds, nbytes
