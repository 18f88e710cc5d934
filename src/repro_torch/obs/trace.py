"""Request tracing: span trees across threads and processes.

The port's copy of ``repro.obs.trace``; its ids and its wire envelope are
the reference's byte for byte, so a JAX client and a port daemon (or the
other way round) build one tree. A :class:`Tracer` mints :class:`Span`
objects, named and timed on :mod:`repro_torch.clock`, each carrying a
``trace_id`` shared by one request's spans and a ``parent_id`` that forms
the tree. Finished spans are kept in a bounded store a trace, so a
request id resolves to its tree afterwards (the gateway's
``GET /v1/traces/<id>``).

Spans that the client projects into a
:class:`~repro_torch.core.metrics.Breakdown` carry a ``component``
attribute naming the paper's Table-3 column: ``token``, ``bloom``,
``redis`` (fabric transfer), ``p_decode`` (prefill), ``r_decode``
(decode) or ``sample``. Device work is asynchronous, so a span that
times it is closed where the host already waited for the device (the
logits on the host): the tracer itself never synchronises or launches.

Cross-thread handoff is explicit: ``span.ctx`` is a :class:`SpanContext`
that another thread passes as ``parent=`` or enters with
``tracer.attach(ctx)``. Nothing leaks through thread ancestry.

Across processes the context rides an op's payload: :func:`inject_trace`
adds ``_trace`` (``[trace_id, span_id]``), :func:`extract_trace` pops it
server-side. A traced server answers with ``_spans``, compact
descriptors (``{"name", "rel_s", "dur_s", "attrs"}``, relative seconds:
the processes share no clock) that the client re-anchors inside its own
network span (:meth:`Tracer.fold_remote`). A request without ``_trace``
is served untraced and answered without ``_spans``.

Imports nothing but the standard library and :mod:`repro_torch.clock`:
the peer daemons import it.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, List, NamedTuple, Optional, Sequence

from repro_torch import clock

TRACE_KEY = "_trace"          # payload-envelope key carrying the context
SPANS_KEY = "_spans"          # response key carrying server descriptors
MAX_SPANS_PER_TRACE = 2048    # spans kept a trace; later ones are dropped


def _hex_id(nbytes: int = 8) -> str:
    return os.urandom(nbytes).hex()


class SpanContext(NamedTuple):
    """The picklable handle another thread/process parents onto."""
    trace_id: str
    span_id: str


# thread-local ambient state: the tracer+span most recently entered on
# THIS thread — what ``phase(...)`` instrumentation (the directory's
# ``net.<op>`` spans) parents onto without threading a tracer through
# every call signature. Handoff between threads stays explicit (attach/ctx).
_ambient = threading.local()


class Span:
    """One timed, attributed node of a trace tree.

    Use as a context manager (enters as the thread's ambient parent)
    or call :meth:`end` explicitly for spans held across callbacks or
    threads. ``end()`` is idempotent; attributes may be added until
    then via :meth:`set`.
    """

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "proc",
                 "t0", "dur", "attrs", "_tracer", "_prev", "_ended")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: str, parent_id: str, proc: str, t0: float,
                 attrs: Optional[dict] = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.proc = proc
        self.t0 = t0
        self.dur = 0.0
        self.attrs = dict(attrs or {})
        self._tracer = tracer
        self._prev = None
        self._ended = False

    @property
    def ctx(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def end(self, t1: Optional[float] = None) -> "Span":
        if not self._ended:
            self._ended = True
            self.dur = max((t1 if t1 is not None else clock.monotonic())
                           - self.t0, 0.0)
            self._tracer._record(self)
        return self

    def as_dict(self) -> dict:
        return {"name": self.name, "trace": self.trace_id,
                "span": self.span_id, "parent": self.parent_id,
                "proc": self.proc, "t0": self.t0, "dur": self.dur,
                "attrs": dict(self.attrs)}

    # -- ambient-parent plumbing --------------------------------------
    def __enter__(self) -> "Span":
        self._prev = (getattr(_ambient, "tracer", None),
                      getattr(_ambient, "span", None))
        _ambient.tracer, _ambient.span = self._tracer, self
        return self

    def __exit__(self, etype, exc, tb) -> None:
        _ambient.tracer, _ambient.span = self._prev
        self._prev = None
        if etype is not None:
            self.attrs.setdefault("error", repr(exc))
        self.end()

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, trace={self.trace_id[:8]}, "
                f"dur={self.dur * 1e3:.2f}ms)")


class _NullSpan:
    """Inert span: every op is a no-op so disabled-tracer call sites
    stay branch-free."""

    __slots__ = ()
    name = ""
    trace_id = span_id = parent_id = proc = ""
    t0 = dur = 0.0
    attrs: dict = {}
    ctx = None

    def set(self, **attrs):
        return self

    def end(self, t1=None):
        return self

    def as_dict(self):
        return {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def __bool__(self):
        return False


NULL_SPAN = _NullSpan()


class Tracer:
    """Thread-safe span factory + bounded finished-trace store.

    ``proc`` labels which process/component minted each span (e.g.
    ``"client"``, ``"gateway"``, ``"peer:peer0"``). ``max_traces``
    bounds memory: oldest complete traces are evicted FIFO.
    """

    def __init__(self, proc: str = "", enabled: bool = True,
                 max_traces: int = 256):
        self.proc = proc
        self.enabled = enabled
        self.max_traces = max_traces
        self._lock = threading.Lock()
        self._spans: "OrderedDict[str, List[dict]]" = OrderedDict()
        self._aliases: "OrderedDict[str, str]" = OrderedDict()

    # -- span creation -------------------------------------------------
    def _resolve_parent(self, parent) -> Optional[SpanContext]:
        if parent is None:
            amb = getattr(_ambient, "span", None)
            if amb is not None and amb._tracer is self:
                return amb.ctx
            return None
        if isinstance(parent, (Span, _NullSpan)):
            return parent.ctx
        if isinstance(parent, SpanContext):
            return parent
        if isinstance(parent, (tuple, list)) and len(parent) == 2:
            return SpanContext(str(parent[0]), str(parent[1]))
        raise TypeError(f"cannot parent a span on {parent!r}")

    def start(self, name: str, parent=None, attrs: Optional[dict] = None,
              t0: Optional[float] = None):
        """Open a span. ``parent`` is a Span, a :class:`SpanContext`
        (cross-thread/process handoff), or ``None`` — which adopts the
        thread's ambient span if this tracer owns it, else starts a new
        trace. Returns :data:`NULL_SPAN` when disabled."""
        if not self.enabled:
            return NULL_SPAN
        ctx = self._resolve_parent(parent)
        trace_id = ctx.trace_id if ctx else _hex_id()
        return Span(self, name, trace_id, _hex_id(),
                    ctx.span_id if ctx else "", self.proc,
                    clock.monotonic() if t0 is None else t0, attrs)

    def add(self, name: str, dur: float, parent=None,
            t0: Optional[float] = None, **attrs):
        """Record an already-measured phase as a completed span —
        the instrumentation shape for code that computes a duration
        itself (e.g. device timings). Anchored at ``t0`` or at
        ``now - dur``."""
        if not self.enabled:
            return NULL_SPAN
        if t0 is None:
            t0 = clock.monotonic() - max(dur, 0.0)
        sp = self.start(name, parent=parent, attrs=attrs, t0=t0)
        sp.end(t0 + max(dur, 0.0))
        return sp

    @contextmanager
    def attach(self, parent):
        """Adopt ``parent`` (Span or SpanContext) as this thread's
        ambient parent — the explicit cross-thread handoff."""
        if not self.enabled or parent is None:
            yield
            return
        ctx = self._resolve_parent(parent)
        holder = Span(self, "", ctx.trace_id, ctx.span_id, "",
                      self.proc, 0.0)     # never recorded: pure handle
        prev = (getattr(_ambient, "tracer", None),
                getattr(_ambient, "span", None))
        _ambient.tracer, _ambient.span = self, holder
        try:
            yield
        finally:
            _ambient.tracer, _ambient.span = prev

    # -- the store -----------------------------------------------------
    def _record(self, span: Span) -> None:
        d = span.as_dict()
        with self._lock:
            spans = self._spans.get(span.trace_id)
            if spans is None:
                spans = self._spans[span.trace_id] = []
                while len(self._spans) > self.max_traces:
                    old, _ = self._spans.popitem(last=False)
                    for alias, tid in list(self._aliases.items()):
                        if tid == old:
                            del self._aliases[alias]
            if len(spans) < MAX_SPANS_PER_TRACE:
                spans.append(d)

    def alias(self, name: str, trace_id: str) -> None:
        """Register a secondary lookup key (e.g. the gateway request id
        ``cmpl-42``) for a trace."""
        with self._lock:
            self._aliases[name] = trace_id
            while len(self._aliases) > 4 * self.max_traces:
                self._aliases.popitem(last=False)

    def trace(self, trace_or_alias: str) -> Optional[List[dict]]:
        """All finished spans of one trace (insertion order), by trace
        id or alias; ``None`` if unknown/evicted."""
        with self._lock:
            tid = self._aliases.get(trace_or_alias, trace_or_alias)
            spans = self._spans.get(tid)
            return list(spans) if spans is not None else None

    # -- cross-process stitching --------------------------------------
    def fold_remote(self, parent: Span, descriptors: Sequence[dict],
                    proc: str = "") -> int:
        """Re-anchor server-side span *descriptors* under a finished
        client-side network span. The processes share no clock, so each
        descriptor carries only (rel_s, dur_s) relative to the server's
        request start; the server window is centered inside the client
        span, splitting the residual RTT evenly between the two
        directions. Returns the number of spans folded."""
        if not self.enabled or not descriptors \
                or isinstance(parent, _NullSpan):
            return 0
        window = max((float(d.get("rel_s", 0.0)) +
                      float(d.get("dur_s", 0.0)) for d in descriptors),
                     default=0.0)
        base = parent.t0 + max((parent.dur - window) / 2.0, 0.0)
        n = 0
        for d in descriptors:
            if not isinstance(d, dict) or "name" not in d:
                continue
            sp = Span(self, str(d["name"]), parent.trace_id, _hex_id(),
                      parent.span_id, proc or str(d.get("proc", "")),
                      base + float(d.get("rel_s", 0.0)),
                      d.get("attrs") or {})
            sp.attrs.setdefault("remote", True)
            sp.end(sp.t0 + float(d.get("dur_s", 0.0)))
            n += 1
        return n


NULL_TRACER = Tracer(enabled=False)


def current_span() -> Optional[Span]:
    """The calling thread's ambient span, or ``None`` outside any —
    what a caller captures before spawning a worker thread and hands
    to :meth:`Tracer.attach` inside it (explicit handoff)."""
    return getattr(_ambient, "span", None)


@contextmanager
def phase(name: str, **attrs):
    """Ambient child span on whatever tracer/span the calling thread
    most recently entered — the zero-plumbing instrumentation the
    directory's ``net.<op>`` spans use. A no-op
    (yields :data:`NULL_SPAN`) when no span is active on this thread."""
    tracer = getattr(_ambient, "tracer", None)
    if tracer is None or not tracer.enabled:
        yield NULL_SPAN
        return
    with tracer.start(name, attrs=attrs) as sp:
        yield sp


# ---------------------------------------------------------------------------
# wire propagation (payload envelope)
# ---------------------------------------------------------------------------

def inject_trace(payload: dict, span) -> dict:
    """Copy of ``payload`` carrying the span's trace context under
    :data:`TRACE_KEY`. With a null/absent span, returns the payload
    unchanged — the peer then answers without ``_spans``, exactly like
    a pre-tracing client."""
    ctx = getattr(span, "ctx", None)
    if ctx is None and isinstance(span, SpanContext):
        ctx = span
    if ctx is None:
        return payload
    out = dict(payload)
    out[TRACE_KEY] = [ctx.trace_id, ctx.span_id]
    return out


def extract_trace(payload: dict) -> Optional[SpanContext]:
    """Pop the trace context from an op payload server-side. Tolerant
    of anything malformed (a garbled envelope must never fail an op):
    returns ``None`` unless a well-formed ``[trace_id, span_id]`` pair
    is present."""
    raw = payload.pop(TRACE_KEY, None)
    if (isinstance(raw, (list, tuple)) and len(raw) == 2
            and all(isinstance(x, (str, bytes)) for x in raw)):
        tid, sid = (x.decode() if isinstance(x, bytes) else x
                    for x in raw)
        return SpanContext(tid, sid)
    return None
