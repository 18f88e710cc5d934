"""The port's real peer runtime over TCP: the versioned frame format
(:mod:`~repro_torch.core.net.frames`), the asyncio peer server
(:mod:`~repro_torch.core.net.server`), socket links
(:mod:`~repro_torch.core.net.link`), per-link bandwidth and RTT
estimation (:mod:`~repro_torch.core.net.estimator`), the peer daemon
(``python -m repro_torch.core.net.daemon``) and the supervisor of a fleet
of them (:mod:`~repro_torch.core.net.supervisor`).

Nothing here imports ``torch``: a daemon's closure is config, server,
codec and sockets, so a fleet of peers starts in a fraction of a second.
"""
