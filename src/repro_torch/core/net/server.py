"""Asyncio TCP server hosting one cache peer's ``handle(op, payload)``.

The port's copy of ``repro.core.net.server``. A request whose
:data:`~repro_torch.core.deadline.DEADLINE_KEY` budget is already spent
is answered ``{"ok": False, "deadline_exceeded": True}`` and never
dispatched. :func:`serve_peer_tcp` puts any handler (a
:class:`~repro_torch.core.cluster.CachePeer`, a bare
:class:`~repro_torch.core.server.CacheServer`, a daemon's handler)
behind a socket speaking :mod:`repro_torch.core.net.frames`. The event
loop runs on its own daemon thread, so the call returns at once;
handlers run on the loop's default executor, so a large GET on one
connection never blocks a ping on another. A handler that raises is
answered with ``{"ok": False, "error": ...}`` and the connection stays.

Shutdown: a graceful ``close()`` stops accepting, then drains (every
request whose frame was read gets its handler run and its response
flushed), then closes idle connections at a frame boundary. A client
caught by the close sees a whole response or a clean close, which its
transport reports as ``TransportError``; never a truncated frame.

Tracing: a request whose payload carries ``_trace`` runs under a
``peer.<op>`` span, and its reply carries the finished spans as
``_spans`` descriptors (relative seconds) for the client to fold into its
tree; a request without it takes the untraced path and gets no
``_spans``. Every op is counted (``peer_ops_total{op}``) and timed
(``peer_op_seconds{op}``) in the process's metrics registry.

Faults, set live by the daemon's ``inject`` and ``set_throttle`` ops
(:mod:`repro_torch.chaos`): ``throttle_bps`` paces every outgoing frame
as if the link moved that many bits a second; ``chaos`` holds
``corrupt_chunks`` (flip the first byte of the next N stream chunks),
``stall_chunk_s`` (sleep before each chunk frame), ``close_mid_stream``
(drop the connection after N chunks of the next stream), ``delay_ack_s``
(sleep before each single-frame reply) and ``partition_inbound`` (read
requests and never answer them, ``inject`` excepted, so a partition can
always be healed).
"""
from __future__ import annotations

import asyncio
import os
import threading
from typing import Optional, Set

from repro_torch import clock
from repro_torch.core.deadline import expired_reply
from repro_torch.core.net import frames
from repro_torch.obs.flight import FLIGHT
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import SPANS_KEY, Tracer, extract_trace

DRAIN_TIMEOUT_S = 5.0              # a graceful close waits this long at most
# a throttled link may send this many seconds' worth of bytes in a burst
# after an idle spell (the pacer's credit)
THROTTLE_BURST_S = 0.2
# what _stream_chunks returns when an injected fault dropped the
# connection mid-stream
_CONN_DROPPED = object()


class PeerServer:
    """One handler behind an asyncio TCP server; use
    :func:`serve_peer_tcp`."""

    def __init__(self, handler, host: str = "127.0.0.1", port: int = 0):
        self.handle = handler.handle if hasattr(handler, "handle") \
            else handler
        self.host = host
        self.port = port               # the bound port after start()
        self.throttle_bps: Optional[float] = None   # outbound pacing
        self.chaos: dict = {}          # injected faults (module docstring)
        self.tracer = Tracer(proc=f"pid:{os.getpid()}", max_traces=32)
        self._m_ops = REGISTRY.counter(
            "peer_ops_total", "requests served by op", ("op",))
        self._m_op_secs = REGISTRY.histogram(
            "peer_op_seconds", "handler wall seconds by op", ("op",))
        self.stats = {"connections": 0, "requests": 0, "frame_errors": 0,
                      "bytes_in": 0, "bytes_out": 0, "chunks_out": 0,
                      "cancels": 0, "handler_errors": 0,
                      "deadline_exceeded": 0}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        self._writers: Set[asyncio.StreamWriter] = set()
        self._inflight = 0             # requests read, not yet flushed
        self._stopping = False
        self._closed = threading.Event()

    def start(self) -> "PeerServer":
        started = threading.Event()
        fail: list = []

        def run_loop():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._loop = loop
            try:
                self._server = loop.run_until_complete(
                    asyncio.start_server(self._conn, self.host, self.port))
            except OSError as e:
                fail.append(e)
                loop.close()
                self._closed.set()
                started.set()
                return
            self.port = self._server.sockets[0].getsockname()[1]
            started.set()
            try:
                loop.run_forever()
            finally:
                loop.close()
                self._closed.set()

        self._thread = threading.Thread(target=run_loop, daemon=True,
                                        name=f"peer-srv:{self.host}")
        self._thread.start()
        started.wait()
        if fail:
            raise fail[0]
        return self

    # ------------------------------------------------------------------
    async def _conn(self, reader: asyncio.StreamReader,
                    writer: asyncio.StreamWriter) -> None:
        self.stats["connections"] += 1
        self._writers.add(writer)
        loop = asyncio.get_running_loop()
        # a read-ahead task that outlives one request: during a chunk
        # stream the next frame may be the client's cancel, and a read
        # started then is awaited here if it is anything else
        pending: Optional[asyncio.Task] = None
        try:
            while not self._stopping:
                if pending is None:
                    pending = asyncio.ensure_future(
                        frames.recv_frame_async(reader))
                task, pending = pending, None
                try:
                    got = await task
                except frames.FrameError:
                    self.stats["frame_errors"] += 1
                    return             # a poisoned stream: drop it
                if got is None:        # the client hung up cleanly
                    return
                msg, n_in = got
                self.stats["bytes_in"] += n_in
                if not isinstance(msg, dict):
                    self.stats["frame_errors"] += 1
                    return
                if set(msg) == {"cancel"}:
                    continue           # a stale cancel: the stream ended
                self._inflight += 1    # a graceful close waits for it
                try:
                    self.stats["requests"] += 1
                    op = msg.pop("op", None)
                    if self.chaos.get("partition_inbound") \
                            and op != "inject":
                        # the inbound half of an asymmetric partition:
                        # no answer, while this peer's own gossip and
                        # pushes still flow
                        FLIGHT.record("chaos.fault",
                                      kind="partition_inbound", op=str(op))
                        return
                    # only a client that asked for a stream gets chunk
                    # frames: a plain request reads exactly one frame
                    want_stream = bool(msg.pop("stream", False))
                    ctx = extract_trace(msg)
                    # a request whose budget is spent is not dispatched:
                    # its answer could only occupy the executor and link
                    resp = expired_reply(msg)
                    if resp is not None:
                        self.stats["deadline_exceeded"] += 1
                    else:
                        try:
                            resp = await loop.run_in_executor(
                                None, self._dispatch, op, msg, ctx)
                        except Exception as e:  # a handler fault: answer
                            self.stats["handler_errors"] += 1
                            FLIGHT.record("peer.op_error", op=str(op),
                                          error=repr(e))
                            resp = {"ok": False, "error": repr(e)}
                    chunks = resp.pop("chunks", None) \
                        if (want_stream and isinstance(resp, dict)) else None
                    pace = {"t": loop.time()}   # this reply's pacer
                    if chunks is None:
                        delay = self.chaos.get("delay_ack_s")
                        if delay:
                            FLIGHT.record("chaos.fault", kind="delay_ack",
                                          op=str(op), delay_s=delay)
                            await asyncio.sleep(delay)
                        self.stats["bytes_out"] += \
                            await self._send(writer, resp, pace)
                    else:
                        resp["n_chunks"] = len(chunks)
                        self.stats["bytes_out"] += \
                            await self._send(writer, resp, pace)
                        pending = await self._stream_chunks(
                            reader, writer, str(op), chunks, pace, pending)
                        if pending is _CONN_DROPPED:
                            return
                finally:
                    self._inflight -= 1
        except ConnectionError:
            pass                       # the client went away
        finally:
            if pending is not None and pending is not _CONN_DROPPED \
                    and not pending.done():
                pending.cancel()
            self._writers.discard(writer)
            try:
                writer.close()
            except RuntimeError:
                pass                   # the loop is already closing

    async def _stream_chunks(self, reader, writer, op: str, chunks,
                             pace: dict, pending: Optional[asyncio.Task]):
        """Write a chunk stream, watching for the client's cancel frame
        between chunks: a cancel cuts the stream with a ``{"cancelled":
        True}`` frame in place of the next chunk. Any other read result
        (EOF, an error, a pipelined request) goes back to the main loop
        in the returned read-ahead task. The injected chunk faults apply
        here; ``_CONN_DROPPED`` is returned when one closed the
        connection."""
        sent = 0
        for c in chunks:
            if pending is None:
                pending = asyncio.ensure_future(
                    frames.recv_frame_async(reader))
            await asyncio.sleep(0)     # let the read-ahead task progress
            if pending.done() and not pending.cancelled() \
                    and pending.exception() is None:
                got = pending.result()
                if got is not None and isinstance(got[0], dict) \
                        and set(got[0]) == {"cancel"}:
                    self.stats["bytes_in"] += got[1]
                    self.stats["cancels"] += 1
                    self.stats["bytes_out"] += await self._send(
                        writer, {"cancelled": True}, pace)
                    return None
            ch = self.chaos
            if ch.get("close_mid_stream") is not None \
                    and sent >= int(ch["close_mid_stream"]):
                ch.pop("close_mid_stream", None)
                FLIGHT.record("chaos.fault", kind="close_mid_stream", op=op,
                              after_chunks=sent)
                if not pending.done():
                    pending.cancel()
                return _CONN_DROPPED   # the client: a FrameError mid-stream
            stall = ch.get("stall_chunk_s")
            if stall:
                if sent == 0:
                    FLIGHT.record("chaos.fault", kind="stall_chunks", op=op,
                                  stall_s=stall)
                await asyncio.sleep(stall)
            if ch.get("corrupt_chunks", 0) > 0 and len(c) > 0:
                ch["corrupt_chunks"] -= 1
                FLIGHT.record("chaos.fault", kind="corrupt_chunk", op=op,
                              chunk=sent)
                b = bytes(c)
                c = bytes([b[0] ^ 0xFF]) + b[1:]
            self.stats["bytes_out"] += await self._send(
                writer, {"chunk": c}, pace)
            self.stats["chunks_out"] += 1
            sent += 1
        return pending

    def _dispatch(self, op, payload: dict, ctx) -> dict:
        """Run the handler (on the executor), counted and timed. With a
        trace context the handler runs under a ``peer.<op>`` span on a
        trace of this process's own (the processes share no clock), and
        the reply carries its spans as relative-time descriptors."""
        t0 = clock.monotonic()
        o = str(op)
        root = None
        try:
            if ctx is None:
                return self.handle(op, payload)
            root = self.tracer.start(f"peer.{op}", attrs={
                "pid": os.getpid(), "op": o})
            with root:                 # ambient: handler phases nest
                resp = self.handle(op, payload)
        finally:
            self._m_ops.labels(op=o).inc()
            self._m_op_secs.labels(op=o).observe(clock.monotonic() - t0)
        if isinstance(resp, dict):
            resp[SPANS_KEY] = [
                {"name": d["name"], "rel_s": d["t0"] - root.t0,
                 "dur_s": d["dur"], "attrs": d["attrs"]}
                for d in sorted(self.tracer.trace(root.trace_id) or [],
                                key=lambda d: d["t0"])]
        return resp

    async def _send(self, writer, obj, pace: dict) -> int:
        """Send one frame; with ``throttle_bps`` set, not before the
        modeled link has moved its bytes. ``pace`` holds the reply's
        cumulative release time, so a chunk stream is paced like one
        large frame (a late wake shortens the next wait)."""
        data = frames.encode_frame(obj)
        if self.throttle_bps:
            loop = asyncio.get_running_loop()
            due = max(pace["t"], loop.time() - THROTTLE_BURST_S) \
                + len(data) * 8.0 / self.throttle_bps
            pace["t"] = due
            delay = due - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
        writer.write(data)
        await writer.drain()
        return len(data)

    # ------------------------------------------------------------------
    async def _shutdown(self, graceful: bool) -> None:
        self._stopping = True
        if self._server is not None:
            self._server.close()       # stop accepting
        if graceful:
            deadline = self._loop.time() + DRAIN_TIMEOUT_S
            while self._inflight > 0 and self._loop.time() < deadline:
                await asyncio.sleep(0.005)
        for w in list(self._writers):  # idle connections: a clean close
            w.close()
        me = asyncio.current_task()
        tasks = [t for t in asyncio.all_tasks(self._loop) if t is not me]
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        self._loop.stop()

    def close(self, graceful: bool = True) -> None:
        """Stop the server; ``graceful`` drains in-flight requests
        (bounded by ``DRAIN_TIMEOUT_S``) before closing connections."""
        loop = self._loop
        if loop is None or self._closed.is_set() or not loop.is_running():
            return
        try:
            asyncio.run_coroutine_threadsafe(self._shutdown(graceful), loop)
        except RuntimeError:
            return                     # the loop is already gone
        self._closed.wait(DRAIN_TIMEOUT_S + 2.0)

    def __enter__(self) -> "PeerServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serve_peer_tcp(handler, host: str = "127.0.0.1",
                   port: int = 0) -> PeerServer:
    """Serve ``handler.handle(op, payload)`` over TCP. Returns a started
    :class:`PeerServer`: ``.port`` is the bound port (the OS picks one
    for ``port=0``) and ``.close()`` shuts it down with a drain."""
    return PeerServer(handler, host, port).start()
