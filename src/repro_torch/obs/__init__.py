"""Observability for the port: tracing, metrics, export, flight recorder,
decision ledger, calibration and the fleet console.

The port's copy of ``repro.obs``. Like the reference's, this
package imports nothing but the standard library and
:mod:`repro_torch.clock`, never ``torch``: the peer daemons, the
gateway's HTTP thread and the supervisor import it.

* :mod:`~repro_torch.obs.trace` — ``Tracer`` / ``Span``: a request's span
  tree, with explicit handoff across threads and processes; spans named
  for the paper's Table-3 columns make the client's
  ``Breakdown.from_spans`` a projection of the tree;
* :mod:`~repro_torch.obs.metrics` — counters, gauges and histograms with
  Prometheus text exposition (the gateway's ``GET /metrics``);
* :mod:`~repro_torch.obs.export` — Perfetto ``traceEvents`` JSON and JSONL;
* :mod:`~repro_torch.obs.flight` — the bounded flight recorder that dumps
  its last events on a trigger (plan exhausted, corrupt chunk, shed, a
  dead peer, estimator drift);
* :mod:`~repro_torch.obs.ledger` — the planner's decision records, closed
  with the realized outcome for regret and savings;
* :mod:`~repro_torch.obs.calibrate` — estimate-vs-actual error a peer,
  drift alarms, and the Bloom false-positive probe;
* :mod:`~repro_torch.obs.console` — the operator's terminal view of a
  gateway and its daemons (``python -m repro_torch.obs.console``); not
  imported here, it is an entry point.
"""
from repro_torch.obs.calibrate import CalibrationTracker  # noqa: F401
from repro_torch.obs.export import (  # noqa: F401
    perfetto_trace, span_tree, write_jsonl, write_perfetto,
)
from repro_torch.obs.flight import FLIGHT, FlightRecorder  # noqa: F401
from repro_torch.obs.ledger import LEDGER, DecisionLedger  # noqa: F401
from repro_torch.obs.metrics import (  # noqa: F401
    REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,
)
from repro_torch.obs.trace import (  # noqa: F401
    NULL_TRACER, Span, SpanContext, Tracer, extract_trace, inject_trace,
    phase,
)
