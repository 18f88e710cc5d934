"""Observability for the port: the metrics registry (counters, gauges,
histograms, the Prometheus text of the gateway's ``/metrics``).

The tracer, flight recorder, decision ledger and calibration
(``repro/obs/``) are not ported yet (ROADMAP Queue 1, item 7.5), so the
port's ``Scheduler`` and ``Gateway`` take no ``tracer``.
"""
