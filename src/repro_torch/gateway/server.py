"""Asyncio HTTP/1.1 front door: OpenAI-compatible endpoints + SSE.

The port's copy of ``repro.gateway.server``, hand-rolled on
``asyncio.start_server`` in the shape of
:class:`~repro_torch.core.net.server.PeerServer` (the event loop on a
daemon thread, the OS-assigned port read back after bind, a drain on
close), with no HTTP framework. Connections are HTTP/1.1 keep-alive:
sequential requests on one socket are served in order until the client
sends ``Connection: close`` or hangs up; an SSE response has no
``Content-Length``, so it is the connection's last. Requests sharing a
connection are linked: each root span carries ``conn`` / ``seq`` and a
``follows`` attribute naming the previous request's root span.

Routes:

* ``POST /v1/completions``        — OpenAI text completion (+SSE)
* ``POST /v1/chat/completions``   — OpenAI chat completion (+SSE)
* ``GET  /v1/models``             — the one served model
* ``GET  /v1/traces/<id>``        — span tree by trace id or request id
* ``GET  /v1/decisions``          — decision-ledger totals + recent records
* ``GET  /v1/decisions/<id>``     — one decision record by request id,
  trace id or ``dec-N`` (candidates, attempts, outcome, regret)
* ``GET  /v1/flight``             — flight-recorder ring + dumps
* ``GET  /healthz``               — liveness + slot counts
* ``GET  /metrics``               — Prometheus text exposition 0.0.4
* ``GET  /metrics.json``          — ServingReport, admission snapshot and
  the directory's calibration

The handler path never touches a tensor: parse -> validate -> tokenize
-> admit (429/503 + ``Retry-After`` on refusal) -> hand a
:class:`GatewayJob` to the engine thread -> relay its event queue back
as JSON or SSE frames. Every accepted completion opens a ``gw.request``
root span in the engine's tracer (``gw.parse`` as Table-3 ``token`` and
``gw.admission`` under it here; the engine thread adds the resolve and
slot spans) that ``GET /v1/traces/<request-id>`` resolves afterwards; a
shed request triggers a ``shed`` flight dump.
"""
from __future__ import annotations

import asyncio
import itertools
import json
import math
import threading
from typing import Optional

from repro_torch.gateway import protocol
from repro_torch.gateway.admission import AdmissionController, ShedError
from repro_torch.gateway.engine import (GatewayClosed, GatewayEngine,
                                        GatewayJob)
from repro_torch import clock
from repro_torch.obs.export import span_tree
from repro_torch.obs.flight import FLIGHT, SHED
from repro_torch.obs.ledger import LEDGER
from repro_torch.obs.metrics import REGISTRY

REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
           405: "Method Not Allowed", 408: "Request Timeout",
           413: "Payload Too Large", 429: "Too Many Requests",
           500: "Internal Server Error", 503: "Service Unavailable",
           504: "Gateway Timeout"}
MAX_HEADER_BYTES = 32 * 1024


class _HttpError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class GatewayServer:
    """The HTTP surface over one :class:`GatewayEngine`."""

    def __init__(self, engine: GatewayEngine,
                 admission: AdmissionController, tokenizer,
                 host: str = "127.0.0.1", port: int = 0,
                 model_name: str = "repro-edge-cache",
                 max_body_bytes: int = 1 << 20,
                 request_timeout_s: float = 120.0):
        self.engine = engine
        self.admission = admission
        self.tok = tokenizer
        self.host = host
        self.port = port               # actual port after start()
        self.model_name = model_name
        self.max_body_bytes = max_body_bytes
        self.request_timeout_s = request_timeout_s
        self.stats = {"connections": 0, "requests": 0, "streamed": 0,
                      "shed_429": 0, "shed_503": 0, "errors_400": 0,
                      "errors_5xx": 0, "keepalive_reuses": 0}
        self._conn_ids = itertools.count()
        self._m_http = REGISTRY.counter(
            "gateway_http_requests_total",
            "HTTP responses by status code", ("code",))
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._closed = threading.Event()

    # ------------------------------------------------------------------
    def start(self) -> "GatewayServer":
        started = threading.Event()
        fail: list = []

        def run_loop():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._loop = loop
            try:
                self._server = loop.run_until_complete(
                    asyncio.start_server(self._conn, self.host,
                                         self.port,
                                         limit=MAX_HEADER_BYTES))
            except OSError as e:
                fail.append(e)
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
                                        name=f"gateway-http:{self.host}")
        self._thread.start()
        started.wait()
        if fail:
            raise fail[0]
        return self

    async def _shutdown(self) -> None:
        self._stopping = True
        if self._server is not None:
            self._server.close()
        me = asyncio.current_task()
        tasks = [t for t in asyncio.all_tasks(self._loop) if t is not me]
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        self._loop.stop()

    def close(self) -> None:
        loop = self._loop
        if loop is None or self._closed.is_set() or not loop.is_running():
            return
        try:
            asyncio.run_coroutine_threadsafe(self._shutdown(), loop)
        except RuntimeError:
            return
        self._closed.wait(5.0)

    # ------------------------------------------------------------------
    # HTTP plumbing
    # ------------------------------------------------------------------
    async def _read_request(self, reader: asyncio.StreamReader):
        try:
            line = await reader.readline()
        except (ValueError, ConnectionError):
            raise _HttpError(400, "oversized or malformed request line")
        if not line:
            return None                # client connected and hung up
        try:
            method, path, _version = line.decode("ascii").split(None, 2)
        except ValueError:
            raise _HttpError(400, "malformed request line")
        headers = {}
        hdr_bytes = 0
        while True:
            try:
                line = await reader.readline()
            except (ValueError, ConnectionError):
                raise _HttpError(400, "malformed headers")
            hdr_bytes += len(line)
            if hdr_bytes > MAX_HEADER_BYTES:
                raise _HttpError(400, "headers too large")
            if line in (b"\r\n", b"\n", b""):
                break
            if b":" not in line:
                raise _HttpError(400, "malformed header line")
            k, v = line.split(b":", 1)
            headers[k.decode("latin1").strip().lower()] = \
                v.decode("latin1").strip()
        body = b""
        if "content-length" in headers:
            try:
                n = int(headers["content-length"])
            except ValueError:
                raise _HttpError(400, "bad Content-Length")
            if n > self.max_body_bytes:
                raise _HttpError(413, "request body too large")
            try:
                body = await reader.readexactly(n)
            except (asyncio.IncompleteReadError, ConnectionError):
                raise _HttpError(400, "truncated request body")
        elif "chunked" in headers.get("transfer-encoding", ""):
            raise _HttpError(400, "chunked bodies are not supported")
        return method.upper(), path.split("?", 1)[0], headers, body

    def _head(self, status: int, ctype: str, length: Optional[int],
              extra: Optional[dict] = None, close: bool = True) -> bytes:
        lines = [f"HTTP/1.1 {status} {REASONS.get(status, 'Unknown')}",
                 f"Content-Type: {ctype}",
                 "Connection: " + ("close" if close else "keep-alive")]
        if length is not None:
            lines.append(f"Content-Length: {length}")
        for k, v in (extra or {}).items():
            lines.append(f"{k}: {v}")
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin1")

    async def _respond(self, writer, status: int, body: bytes,
                       ctype: str = "application/json",
                       extra: Optional[dict] = None,
                       close: bool = True) -> None:
        self._m_http.labels(code=str(status)).inc()
        writer.write(self._head(status, ctype, len(body), extra,
                                close=close) + body)
        await writer.drain()

    # ------------------------------------------------------------------
    async def _conn(self, reader: asyncio.StreamReader,
                    writer: asyncio.StreamWriter) -> None:
        self.stats["connections"] += 1
        conn_id = next(self._conn_ids)
        seq = 0
        prev_span = ""
        try:
            while True:
                try:
                    got = await asyncio.wait_for(
                        self._read_request(reader),
                        self.request_timeout_s)
                except asyncio.TimeoutError:
                    if seq == 0:       # idle keep-alive just closes
                        await self._respond(writer, 408,
                                            protocol.error_body(
                                                "timed out reading "
                                                "request"))
                    return
                except _HttpError as e:
                    self.stats["errors_400"] += 1
                    await self._respond(writer, e.status,
                                        protocol.error_body(e.message))
                    return
                if got is None:
                    return             # client hung up between requests
                method, path, headers, body = got
                self.stats["requests"] += 1
                if seq:
                    self.stats["keepalive_reuses"] += 1
                # HTTP/1.1 default: keep the socket for the next
                # pipelined request unless the client opts out (or we
                # are draining)
                keep = (headers.get("connection", "").lower() != "close"
                        and not self._stopping)
                link = {"conn": conn_id, "seq": seq, "follows": prev_span}
                span_id, keep = await self._route(writer, method, path,
                                                  headers, body, keep, link)
                if span_id:
                    prev_span = span_id
                seq += 1
                if not keep:
                    return
        except (ConnectionError, asyncio.CancelledError):
            pass
        except Exception as e:         # keep the front door up
            self.stats["errors_5xx"] += 1
            try:
                await self._respond(writer, 500, protocol.error_body(
                    repr(e), etype="internal_error"))
            except Exception:
                pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _route(self, writer, method: str, path: str,
                     headers: dict, body: bytes, keep: bool, link: dict):
        """Dispatch one request; returns ``(root_span_id, keep)``, so the
        connection loop can link the next request's root span and honour
        downgrades (SSE has no Content-Length, so it closes the
        connection)."""
        if path in ("/v1/completions", "/v1/chat/completions"):
            if method != "POST":
                await self._respond(
                    writer, 405,
                    protocol.error_body(f"{method} not allowed"),
                    extra={"Allow": "POST"}, close=not keep)
                return None, keep
            kind = "chat" if path.startswith("/v1/chat") else "completion"
            return await self._complete(writer, kind, headers, body, keep,
                                        link)
        elif path == "/healthz" and method == "GET":
            await self._respond(writer, 200, json.dumps({
                "ok": self.engine.alive, "model": self.model_name,
                "slots": self.engine.batch_size,
                "max_len": self.engine.max_len}).encode(),
                close=not keep)
        elif path == "/v1/models" and method == "GET":
            await self._respond(writer, 200, json.dumps({
                "object": "list",
                "data": [{"id": self.model_name, "object": "model",
                          "owned_by": "repro"}]}).encode(),
                close=not keep)
        elif path == "/metrics" and method == "GET":
            # Prometheus text exposition of the process-wide registry
            await self._respond(
                writer, 200, REGISTRY.render().encode(),
                ctype="text/plain; version=0.0.4; charset=utf-8",
                close=not keep)
        elif path == "/metrics.json" and method == "GET":
            snap = {"report": self.engine.report().as_dict(),
                    "admission": self.admission.snapshot(),
                    "http": dict(self.stats)}
            if self.engine.fetcher is not None:
                snap["fetcher"] = dict(self.engine.fetcher.stats)
                d = self.engine.fetcher.directory
                if d is not None:      # est-vs-actual a peer, drift flags
                    snap["calibration"] = d.calibration.snapshot()
            await self._respond(writer, 200,
                                json.dumps(snap, default=str).encode(),
                                close=not keep)
        elif path.startswith("/v1/traces/") and method == "GET":
            tid = path[len("/v1/traces/"):]
            spans = self.engine.tracer.trace(tid)
            if not spans:
                await self._respond(writer, 404, protocol.error_body(
                    f"unknown trace {tid!r}", etype="not_found"),
                    close=not keep)
            else:
                await self._respond(writer, 200, json.dumps({
                    "trace_id": spans[0]["trace"], "n_spans": len(spans),
                    "spans": spans, "tree": span_tree(spans)},
                    default=str).encode(), close=not keep)
        elif path.startswith("/v1/decisions/") and method == "GET":
            did = path[len("/v1/decisions/"):]
            rec = LEDGER.get(did)
            if rec is None:
                await self._respond(writer, 404, protocol.error_body(
                    f"unknown decision {did!r}", etype="not_found"),
                    close=not keep)
            else:
                await self._respond(writer, 200,
                                    json.dumps(rec, default=str).encode(),
                                    close=not keep)
        elif path == "/v1/decisions" and method == "GET":
            await self._respond(writer, 200, json.dumps({
                "totals": LEDGER.totals(), "recent": LEDGER.records(50)},
                default=str).encode(), close=not keep)
        elif path == "/v1/flight" and method == "GET":
            await self._respond(writer, 200, json.dumps({
                "snapshot": FLIGHT.snapshot(), "dumps": FLIGHT.dumps()},
                default=str).encode(), close=not keep)
        else:
            await self._respond(writer, 404, protocol.error_body(
                f"no route for {method} {path}", etype="not_found"),
                close=not keep)
        return None, keep

    # ------------------------------------------------------------------
    async def _complete(self, writer, kind: str, headers: dict,
                        body: bytes, keep: bool, link: dict):
        """One completion request under a ``gw.request`` root span: parse
        -> admission -> the engine's queue -> the response (the engine
        thread's spans as children). Returns ``(root_span_id, keep)``."""
        tr = self.engine.tracer
        attrs = {"route": kind, "conn": link["conn"], "seq": link["seq"]}
        if link.get("follows"):        # the previous request on this socket
            attrs["follows"] = link["follows"]
        root = tr.start("gw.request", attrs=attrs)
        t_parse = clock.monotonic()
        try:
            parsed = self._parse(kind, headers, body)
            segments = protocol.tokenize_request(self.tok, parsed)
        except protocol.BadRequest as e:
            self.stats["errors_400"] += 1
            root.set(status=400).end()
            await self._respond(writer, 400, protocol.error_body(str(e)),
                                close=not keep)
            return root.span_id or None, keep
        tr.add("gw.parse", clock.monotonic() - t_parse, parent=root,
               t0=t_parse, component="token",
               prompt_tokens=len(segments.token_ids))
        n = len(segments.token_ids)
        if n + parsed.max_tokens > self.engine.max_len:
            self.stats["errors_400"] += 1
            root.set(status=400).end()
            await self._respond(writer, 400, protocol.error_body(
                f"prompt ({n} tokens) + max_tokens "
                f"({parsed.max_tokens}) exceeds the engine context of "
                f"{self.engine.max_len} tokens"), close=not keep)
            return root.span_id or None, keep
        t_admit = clock.monotonic()
        try:
            self.admission.admit(parsed.tenant)
        except ShedError as e:
            self.stats["shed_429" if e.status == 429 else "shed_503"] += 1
            FLIGHT.trigger(SHED, tenant=parsed.tenant, status=e.status,
                           retry_after_s=e.retry_after_s)
            root.set(status=e.status, shed=True).end()
            etype = "rate_limit_exceeded" if e.status == 429 \
                else "overloaded"
            await self._respond(
                writer, e.status,
                protocol.error_body(str(e), etype=etype, code=e.status),
                extra={"Retry-After":
                       str(int(math.ceil(e.retry_after_s)))},
                close=not keep)
            return root.span_id or None, keep
        tr.add("gw.admission", clock.monotonic() - t_admit, parent=root,
               t0=t_admit, tenant=parsed.tenant)
        job = GatewayJob(parsed, segments, asyncio.get_running_loop(),
                         asyncio.Queue())
        job.span = root if root else None
        try:
            self.engine.submit(job)
        except GatewayClosed:
            self.admission.release(parsed.tenant)
            root.set(status=503).end()
            await self._respond(writer, 503, protocol.error_body(
                "engine is shutting down", etype="overloaded"),
                extra={"Retry-After": "5"}, close=not keep)
            return root.span_id or None, keep
        try:
            if parsed.stream:
                # SSE has no Content-Length: this response ends the
                # connection, so the loop must not read another request
                keep = False
                self.stats["streamed"] += 1
                await self._stream_response(writer, job, kind, n)
            else:
                await self._unary_response(writer, job, kind, n,
                                           close=not keep)
        finally:
            root.set(rid=job.rid, tenant=parsed.tenant).end()
        return root.span_id or None, keep

    def _parse(self, kind: str, headers: dict,
               body: bytes) -> protocol.ParsedRequest:
        try:
            payload = json.loads(body.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError):
            raise protocol.BadRequest("request body is not valid JSON")
        cap = max(self.engine.max_len - 1, 1)
        parsed = protocol.parse_chat(payload, cap) if kind == "chat" \
            else protocol.parse_completion(payload, cap)
        # the X-Tenant header wins over the body's "user" field (the
        # proxy/sidecar sets it; the body is client-controlled)
        tenant = headers.get("x-tenant", "")
        if tenant:
            parsed.tenant = tenant
        return parsed

    async def _next_event(self, q: asyncio.Queue):
        return await asyncio.wait_for(q.get(), self.request_timeout_s)

    async def _unary_response(self, writer, job: GatewayJob, kind: str,
                              n_prompt: int,
                              close: bool = True) -> None:
        tokens, finish, meta = [], "", {}
        try:
            while True:
                ev = await self._next_event(job.q)
                if ev[0] == "token":
                    tokens.append(ev[1])
                elif ev[0] == "done":
                    finish, meta = ev[1], ev[2]
                    break
                else:                  # ("error", message)
                    self.stats["errors_5xx"] += 1
                    await self._respond(writer, 500, protocol.error_body(
                        ev[1], etype="internal_error"), close=close)
                    return
        except asyncio.TimeoutError:
            self.stats["errors_5xx"] += 1
            await self._respond(writer, 504, protocol.error_body(
                "generation timed out", etype="timeout"), close=close)
            return
        build = protocol.chat_response if kind == "chat" \
            else protocol.completion_response
        payload = build(self.tok, job.rid, job.created, self.model_name,
                        tokens, n_prompt, finish, meta)
        await self._respond(writer, 200, json.dumps(payload).encode(),
                            close=close)

    async def _stream_response(self, writer, job: GatewayJob, kind: str,
                               n_prompt: int) -> None:
        self._m_http.labels(code="200").inc()
        writer.write(self._head(200, "text/event-stream", None,
                                {"Cache-Control": "no-cache"}))
        await writer.drain()
        try:
            while True:
                ev = await self._next_event(job.q)
                if ev[0] == "token":
                    writer.write(protocol.stream_chunk(
                        self.tok, job.rid, job.created, self.model_name,
                        kind, ev[1], None))
                    await writer.drain()
                elif ev[0] == "done":
                    writer.write(protocol.stream_chunk(
                        self.tok, job.rid, job.created, self.model_name,
                        kind, None, ev[1]))
                    writer.write(protocol.SSE_DONE)
                    await writer.drain()
                    return
                else:
                    writer.write(b"data: " + protocol.error_body(
                        ev[1], etype="internal_error") + b"\n\n")
                    writer.write(protocol.SSE_DONE)
                    await writer.drain()
                    return
        except asyncio.TimeoutError:
            writer.write(b"data: " + protocol.error_body(
                "generation timed out", etype="timeout") + b"\n\n")
            writer.write(protocol.SSE_DONE)
            await writer.drain()
        except ConnectionError:
            pass                       # client went away mid-stream; the
            # engine finishes the request and admission releases then
