"""Asyncio TCP server hosting one cache peer's ``handle(op, payload)``.

A copy of ``repro.core.net.server`` without its fault-injection flags,
outbound throttle and server-side spans. A request whose
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
"""
from __future__ import annotations

import asyncio
import threading
from typing import Optional, Set

from repro_torch.core.deadline import expired_reply
from repro_torch.core.net import frames

DRAIN_TIMEOUT_S = 5.0              # a graceful close waits this long at most


class PeerServer:
    """One handler behind an asyncio TCP server; use
    :func:`serve_peer_tcp`."""

    def __init__(self, handler, host: str = "127.0.0.1", port: int = 0):
        self.handle = handler.handle if hasattr(handler, "handle") \
            else handler
        self.host = host
        self.port = port               # the bound port after start()
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
                    # only a client that asked for a stream gets chunk
                    # frames: a plain request reads exactly one frame
                    want_stream = bool(msg.pop("stream", False))
                    # a request whose budget is spent is not dispatched:
                    # its answer could only occupy the executor and link
                    resp = expired_reply(msg)
                    if resp is not None:
                        self.stats["deadline_exceeded"] += 1
                    else:
                        try:
                            resp = await loop.run_in_executor(
                                None, self.handle, op, msg)
                        except Exception as e:  # a handler fault: answer
                            self.stats["handler_errors"] += 1
                            resp = {"ok": False, "error": repr(e)}
                    chunks = resp.pop("chunks", None) \
                        if (want_stream and isinstance(resp, dict)) else None
                    if chunks is None:
                        self.stats["bytes_out"] += \
                            await frames.send_frame_async(writer, resp)
                    else:
                        resp["n_chunks"] = len(chunks)
                        self.stats["bytes_out"] += \
                            await frames.send_frame_async(writer, resp)
                        pending = await self._stream_chunks(
                            reader, writer, chunks, pending)
                finally:
                    self._inflight -= 1
        except ConnectionError:
            pass                       # the client went away
        finally:
            if pending is not None and not pending.done():
                pending.cancel()
            self._writers.discard(writer)
            try:
                writer.close()
            except RuntimeError:
                pass                   # the loop is already closing

    async def _stream_chunks(self, reader, writer, chunks,
                             pending: Optional[asyncio.Task]
                             ) -> Optional[asyncio.Task]:
        """Write a chunk stream, watching for the client's cancel frame
        between chunks: a cancel cuts the stream with a ``{"cancelled":
        True}`` frame in place of the next chunk. Any other read result
        (EOF, an error, a pipelined request) goes back to the main loop
        in the returned read-ahead task."""
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
                    self.stats["bytes_out"] += await frames.send_frame_async(
                        writer, {"cancelled": True})
                    return None
            self.stats["bytes_out"] += await frames.send_frame_async(
                writer, {"chunk": c})
            self.stats["chunks_out"] += 1
        return pending

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
