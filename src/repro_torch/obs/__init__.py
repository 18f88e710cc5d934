"""Observability for the port: the metrics registry the scheduler uses.

The tracer (``repro/obs/trace.py``) is not ported yet, so the port's
``Scheduler`` takes no ``tracer``.
"""
