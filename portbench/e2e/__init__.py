"""End-to-end readers, one file per metric of ``BENCHMARK.json``'s
``end_to_end``, each ``read(run) -> float | None`` over the host clock."""
