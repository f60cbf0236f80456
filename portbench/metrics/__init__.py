"""Per-layer readers, one file per metric of ``BENCHMARK.json``'s
``per_layer``, each ``read(run) -> float | None`` over the traced run
(``run.trace``, ``run.requests``, ``run.launches``).  A reader that finds
nothing to read returns None, and the metric is left out of the line."""
