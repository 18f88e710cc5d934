"""In-process transport between an edge client and the cache server.

The request runs in this process. The transport encodes the request and
the response as msgpack frames, as a wire would, and reports the bytes
and the wall time of the whole exchange. Every request returns ``(response, wall_seconds, n_bytes)``,
the reference transport's contract. The simulated network, TCP and the
multi-peer fabric are later slices of the port.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch import clock
from repro_torch.core import packer
from repro_torch.core.server import CacheServer


class InProcTransport:
    def __init__(self, server: CacheServer):
        self.server = server

    def request(self, op: str, payload: dict) -> Tuple[dict, float, int]:
        t0 = clock.monotonic()
        nbytes = len(packer.packb({"op": op, **payload}))
        resp = self.server.handle(op, payload)
        nbytes += len(packer.packb(resp))
        return resp, clock.monotonic() - t0, nbytes
