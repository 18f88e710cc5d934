"""Transports between an edge client and a cache server or peer.

* :class:`InProcTransport` — the request runs in this process and the
  request and response are packed as the wire's frames would be. With a
  :class:`~repro_torch.core.netsim.SimNetwork` it returns the modeled
  Wi-Fi seconds of those bytes and advances a
  :class:`~repro_torch.core.netsim.SimClock`, as the reference's does;
  without one it returns the wall seconds of the exchange.
* :class:`TCPTransport` — frames over a real socket
  (:mod:`repro_torch.core.net.frames`), served by :func:`serve_tcp`.

Every request returns ``(response, seconds, n_bytes)``; ``request_stream``
delivers a response's chunks one at a time.

A payload with a ``_trace`` envelope is served under a ``peer.<op>`` span
and answered with ``_spans`` descriptors, as the TCP peer server answers
it, so an in-process fabric gives the same cross-"process" trees. Unlike
the reference, :class:`InProcTransport` charges the op's own frames
only, without that envelope: tracing does not move the modeled seconds.

Failure contract: a dead, unreachable or too-slow peer raises
:class:`TransportError` (never a bare socket error, never a hang: the
connect and every request are bounded by timeouts, and a close
mid-request is a clean error). Callers fall back to local prefill.
"""
from __future__ import annotations

import socket
import threading
from typing import Callable, Optional, Tuple

from repro_torch import clock
from repro_torch.core.deadline import expired_reply
from repro_torch.core.net import frames
from repro_torch.core.netsim import SimClock, SimNetwork
from repro_torch.core.server import CacheServer
from repro_torch.obs.trace import SPANS_KEY, TRACE_KEY, Tracer, extract_trace

CHUNK_FRAME_BYTES = 16             # the reference's per-chunk frame overhead
# a client socket's receive buffer, fixed before the connect. Left to the
# stack's autotuning, a kept-alive socket can pause ~200 ms in the middle
# of a large response (PERF.md §7).
RCVBUF_BYTES = 2 << 20


class TransportError(ConnectionError):
    """A cache peer could not be reached (refused connect, closed or
    timed-out socket, protocol violation). Costs latency, never
    correctness: the client prefills locally (paper §3.3)."""


class StreamCancelled(Exception):
    """A chunk stream was cut short at the client's request. Not a
    ``ConnectionError``: the socket is left at a frame boundary and the
    peer is healthy, so callers must not mark it suspect."""


class InProcTransport:
    """``net=None`` reports wall seconds; with a ``SimNetwork`` the
    modeled seconds of the packed bytes, advancing ``clock``."""

    def __init__(self, server, net: Optional[SimNetwork] = None,
                 clock: Optional[SimClock] = None):
        self.server = server
        self.net = net
        self.clock = (clock or SimClock()) if net is not None else None
        self._tracer = None            # made at the first traced request

    def _serve(self, op: str, payload: dict) -> dict:
        """The in-process wire: subclasses gate liveness here so request
        and request_stream share one failure contract. A request whose
        deadline budget is already spent is answered as the peer server
        answers it, without running the handler."""
        expired = expired_reply(payload)
        if expired is not None:
            return expired
        ctx = extract_trace(payload)
        if ctx is None:
            return self.server.handle(op, payload)
        if self._tracer is None:
            self._tracer = Tracer(proc="sim-peer", max_traces=32)
        root = self._tracer.start(f"peer.{op}", attrs={"op": op})
        with root:
            resp = self.server.handle(op, payload)
        if isinstance(resp, dict):
            resp[SPANS_KEY] = [
                {"name": d["name"], "rel_s": d["t0"] - root.t0,
                 "dur_s": d["dur"], "attrs": d["attrs"]}
                for d in sorted(self._tracer.trace(root.trace_id) or [],
                                key=lambda d: d["t0"])]
        return resp

    @staticmethod
    def _op_bytes(op: str, payload: dict) -> int:
        """The request frame's bytes without the trace envelope."""
        return len(frames.pack_payload(
            {"op": op, **{k: v for k, v in payload.items()
                          if k != TRACE_KEY}}))

    @staticmethod
    def _reply_bytes(resp: dict) -> int:
        """The reply frame's bytes without the folded spans."""
        return len(frames.pack_payload(
            {k: v for k, v in resp.items() if k != SPANS_KEY}
            if isinstance(resp, dict) else resp))

    def request(self, op: str, payload: dict,
                advance_clock: bool = True) -> Tuple[dict, float, int]:
        t0 = clock.monotonic()
        nbytes = self._op_bytes(op, payload)
        resp = self._serve(op, payload)
        nbytes += self._reply_bytes(resp)
        if self.net is None:
            return resp, clock.monotonic() - t0, nbytes
        dt = self.net.transfer_time(nbytes)
        if advance_clock:
            self.clock.advance(dt)
        return resp, dt, nbytes

    def request_stream(self, op: str, payload: dict,
                       on_chunk: Callable[[bytes, float, int], None],
                       advance_clock: bool = True,
                       cancel=None) -> Tuple[dict, float, int]:
        """A streamed request: the response's ``chunks`` go to
        ``on_chunk(chunk, seconds, nbytes)`` one at a time, each with its
        bytes on the wire (``len(chunk) + 16``) and its seconds: modeled
        serialization time on a sim link (the RTT is paid once, on the
        header), the transport's own wall time otherwise. ``cancel``
        (anything with ``is_set()``) is checked between chunks and raises
        :class:`StreamCancelled`. Returns ``(header, seconds, nbytes)``:
        the response without its chunks, with ``n_chunks``; the
        transport's seconds (wall time inside ``on_chunk`` is the
        caller's, not counted); and the bytes of the whole exchange."""
        t0 = clock.monotonic()
        nbytes = self._op_bytes(op, payload)
        resp = self._serve(op, payload)
        chunks = resp.get("chunks") or []
        header = {k: v for k, v in resp.items() if k != "chunks"}
        header["n_chunks"] = len(chunks)
        nbytes += self._reply_bytes(header)
        if self.net is None:
            seconds = clock.monotonic() - t0
        else:
            seconds = self.net.transfer_time(nbytes)
            if advance_clock:
                self.clock.advance(seconds)
        head_bytes = nbytes
        for c in chunks:
            if cancel is not None and cancel.is_set():
                raise StreamCancelled(f"stream {op!r} cancelled after "
                                      f"{nbytes - head_bytes} chunk bytes")
            t = clock.monotonic()
            chunk = bytes(c)
            nb = len(chunk) + CHUNK_FRAME_BYTES
            if self.net is None:
                dt = clock.monotonic() - t
            else:
                dt = nb * 8.0 / self.net.bandwidth_bps
                if advance_clock:
                    self.clock.advance(dt)
            seconds += dt
            nbytes += nb
            on_chunk(chunk, dt, nb)
        return header, seconds, nbytes


class TCPTransport:
    """Versioned frames over one socket.

    ``timeout`` bounds the connect and every request round trip. Any socket or framing failure raises
    :class:`TransportError` and poisons the socket, so a late response
    can never pair with a later request; the next request reconnects.
    With ``eager=False`` the connect waits for the first request."""

    def __init__(self, host: str, port: int, timeout: float = 5.0,
                 eager: bool = True):
        self.addr = (host, port)
        self.timeout = timeout
        self.lock = threading.Lock()
        self.sock: Optional[socket.socket] = None
        if eager:
            with self.lock:
                self._connect()

    def _connect(self) -> None:
        try:
            # socket.create_connection, with the receive buffer fixed
            # before the connect (RCVBUF_BYTES)
            err: Optional[OSError] = None
            for family, kind, proto, _, sa in socket.getaddrinfo(
                    *self.addr, type=socket.SOCK_STREAM):
                sock = socket.socket(family, kind, proto)
                try:
                    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                    RCVBUF_BYTES)
                    sock.settimeout(self.timeout)
                    sock.connect(sa)
                except OSError as e:
                    sock.close()
                    err = e
                    continue
                self.sock = sock
                return
            raise err or OSError("no address")
        except OSError as e:
            self.sock = None
            raise TransportError(f"connect to {self.addr[0]}:{self.addr[1]}"
                                 f" failed: {e}") from e

    def _poison(self) -> None:
        try:
            self.sock.close()
        finally:
            self.sock = None

    def request(self, op: str, payload: dict,
                advance_clock: bool = True) -> Tuple[dict, float, int]:
        t0 = clock.monotonic()
        with self.lock:
            if self.sock is None:          # lazy connect, or a poisoned one
                self._connect()
            try:
                n_up = frames.send_frame(self.sock, {"op": op, **payload})
                resp, n_down = frames.recv_frame_with_size(self.sock)
            except OSError as e:           # FrameError is a ConnectionError
                self._poison()
                raise TransportError(f"request {op!r} to {self.addr} "
                                     f"failed: {e}") from e
        return resp, clock.monotonic() - t0, n_up + n_down

    def request_stream(self, op: str, payload: dict, on_chunk,
                       advance_clock: bool = True,
                       cancel=None) -> Tuple[dict, float, int]:
        """A streamed request over the socket: a header frame carrying
        ``n_chunks``, then one frame a chunk, each handed to
        ``on_chunk(chunk, wall_dt, wire_bytes)`` as it lands (``wall_dt``:
        seconds since the previous frame was handed over). With ``cancel`` set between
        chunks the transport sends one cancel frame, drains to the
        server's ack (or the announced count) and raises
        :class:`StreamCancelled` with the socket clean. A socket, framing
        or ``on_chunk`` failure poisons the socket. Returns ``(header,
        wall_seconds, total_bytes)``; the seconds inside ``on_chunk`` are
        the caller's and are not counted."""
        t0 = clock.monotonic()
        with self.lock:
            if self.sock is None:
                self._connect()
            try:
                total = frames.send_frame(
                    self.sock, {"op": op, "stream": True, **payload})
                header, n_down = frames.recv_frame_with_size(self.sock)
                total += n_down
                n_chunks = int(header.get("n_chunks", 0)) \
                    if isinstance(header, dict) else 0
                cancel_sent = False
                caller_s = 0.0             # seconds spent inside on_chunk
                t_prev = clock.monotonic()
                for i in range(n_chunks):
                    if not cancel_sent and cancel is not None \
                            and cancel.is_set():
                        total += frames.send_frame(self.sock,
                                                   {"cancel": True})
                        cancel_sent = True
                    msg, nb = frames.recv_frame_with_size(self.sock)
                    now = clock.monotonic()
                    total += nb
                    if cancel_sent and isinstance(msg, dict) \
                            and msg.get("cancelled"):
                        raise StreamCancelled(f"stream {op!r} cancelled "
                                              f"after {i} chunks")
                    chunk = msg.get("chunk") if isinstance(msg, dict) \
                        else None
                    if chunk is None:
                        raise frames.FrameError(
                            f"stream frame {i} carries no chunk")
                    if not cancel_sent:    # after a cancel: drain
                        on_chunk(bytes(chunk), now - t_prev, nb)
                    t_prev = clock.monotonic()
                    caller_s += t_prev - now
                if cancel is not None and n_chunks \
                        and (cancel_sent or cancel.is_set()):
                    # the stream ended before the server read the cancel
                    raise StreamCancelled(f"stream {op!r} cancelled at "
                                          f"stream end")
            except OSError as e:
                self._poison()
                raise TransportError(f"stream {op!r} to {self.addr} "
                                     f"failed: {e}") from e
            except StreamCancelled:
                raise                      # the socket is clean
            except BaseException:
                # on_chunk refused the stream: unread frames remain
                self._poison()
                raise
        return header, clock.monotonic() - t0 - caller_s, total

    def close(self) -> None:
        with self.lock:
            if self.sock is not None:
                self._poison()


def serve_tcp(server: CacheServer, host: str = "127.0.0.1", port: int = 0):
    """Serve a cache server over TCP. Returns ``(port, shutdown_fn)``;
    a thin wrapper over :func:`repro_torch.core.net.server.serve_peer_tcp`,
    which owns the socket loop and its graceful drain."""
    from repro_torch.core.net.server import serve_peer_tcp
    srv = serve_peer_tcp(server, host, port)
    return srv.port, srv.close
