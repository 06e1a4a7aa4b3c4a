"""Per-layer metrics, one module each, named as in BENCHMARK.json.

A module gives ``WRAPS``, the ``"module:attribute"`` entries of the program
that its traced run wraps in a profiler range, and ``read(trace)``, which
returns the metric from a `tracing.Trace`, or None when the trace holds
nothing for it to read (the harness then leaves the metric out).
"""
