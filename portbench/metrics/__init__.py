"""Per-layer metrics, one module each, found by the metric's name in
``BENCHMARK.json``. Each has ``read(summary, cell) -> float | None``: it takes
its number from the traced run's ``tracing.TraceSummary`` and returns None
where it finds nothing to read. Work counts live beside the metric that
divides by them (``fwd_work``, ``bwd_work``)."""
