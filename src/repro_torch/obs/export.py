"""Trace export: Chrome / Perfetto ``traceEvents`` JSON and JSONL logs.

The port's copy of ``repro.obs.export``. :func:`perfetto_trace` turns
stored span dicts (what ``Tracer.trace()`` gives)
into the Trace Event Format that ``chrome://tracing`` and
https://ui.perfetto.dev load: complete events (``"ph": "X"``) with
microsecond ``ts`` / ``dur``, one pid a process label (``client``,
``gateway``, ``peer:peer0``, ...) with its ``process_name`` event, so a
request's tree across processes shows as parallel tracks. Attributes go
to ``args``; the Table-3 ``component`` is the event's category.

:func:`write_jsonl` is the structured event log: one JSON object a line,
for flight-recorder dumps and ledger records. :func:`span_tree` nests
span dicts under their parents (the gateway's ``/v1/traces/<id>``).
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence


def perfetto_trace(spans: Sequence[dict]) -> dict:
    """Build a Trace Event Format document from stored span dicts (a
    span without a process label goes under ``proc``)."""
    pids: Dict[str, int] = {}
    events: List[dict] = []
    for d in spans:
        if not d:
            continue
        proc = str(d.get("proc") or "proc")
        pid = pids.get(proc)
        if pid is None:
            pid = pids[proc] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name",
                           "pid": pid, "tid": 0,
                           "args": {"name": proc}})
        args = dict(d.get("attrs") or {})
        args["trace_id"] = d.get("trace", "")
        args["span_id"] = d.get("span", "")
        if d.get("parent"):
            args["parent_span"] = d["parent"]
        events.append({
            "ph": "X",
            "name": str(d.get("name", "?")),
            "cat": str(args.get("component", "span")),
            "pid": pid,
            "tid": 1,
            "ts": round(float(d.get("t0", 0.0)) * 1e6, 3),
            "dur": round(float(d.get("dur", 0.0)) * 1e6, 3),
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_perfetto(path: str, spans: Sequence[dict]) -> str:
    """Write a Perfetto-loadable JSON trace; returns ``path``."""
    doc = perfetto_trace(spans)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=None, separators=(",", ":"),
                  sort_keys=True, default=repr)
    return path


def write_jsonl(path: str, events: Iterable[dict]) -> int:
    """Append events as one-JSON-object-per-line; returns the count."""
    n = 0
    with open(path, "a") as fh:
        for ev in events:
            fh.write(json.dumps(ev, sort_keys=True, default=repr))
            fh.write("\n")
            n += 1
    return n


def span_tree(spans: Sequence[dict]) -> Optional[dict]:
    """Nest stored span dicts into a tree (children under their
    parent). Returns the root node, or a synthetic root if several
    spans are parentless. Handy for test assertions and the
    ``/v1/traces/<id>`` JSON response."""
    nodes = {d["span"]: dict(d, children=[]) for d in spans if d}
    roots = []
    for d in nodes.values():
        parent = nodes.get(d.get("parent") or "")
        (parent["children"] if parent else roots).append(d)
    if not roots:
        return None
    if len(roots) == 1:
        return roots[0]
    return {"name": "(multi-root)", "span": "", "parent": "",
            "proc": "", "t0": min(r["t0"] for r in roots), "dur": 0.0,
            "attrs": {}, "children": roots}
