"""Client-side link to one real (TCP) cache peer.

:class:`TCPPeerLink` is the socket twin of the in-process
:class:`~repro_torch.core.cluster.PeerTransport`: it carries a
``peer_id`` and plugs into a
:class:`~repro_torch.core.cluster.PeerDirectory` where the simulated
link goes. No ``SimNetwork`` stands behind it (``net`` is ``None``), so
fetch costs come from the directory's link estimator. It connects at its
first request, and a failed request poisons the socket so the next one
reconnects (a peer restarted on the same port is reached again).
"""
from __future__ import annotations

from repro_torch.core.transport import TCPTransport


class TCPPeerLink(TCPTransport):
    net = None                         # no simulated link behind a socket

    def __init__(self, peer_id: str, host: str, port: int,
                 timeout: float = 5.0):
        self.peer_id = peer_id
        super().__init__(host, port, timeout=timeout, eager=False)

    def __repr__(self) -> str:
        return f"TCPPeerLink({self.peer_id!r}, {self.addr[0]}:{self.addr[1]})"
