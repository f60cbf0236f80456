"""What the readers of the program's own spans and counters share.

The program records its spans (``cfmm_routing_tpu_torch.utils.profiling``)
while the profiler is on: during the traced run's window, and whenever
else a process profiles it.  A reader keeps the program's ``route`` roots
that lie inside one of the benchmark's traced requests (``run.trace.spans``,
on the same clock) and returns the median over those routes.  It finds
nothing to read where the run had no device activity (``busy_ns`` 0: on
the CPU no host wait is real), or where the program has no spans."""
from __future__ import annotations

import statistics

# the program's records and the profiler's events agree to well within
# this on one host (tests/test_torch_tracing.py holds them to it)
CLOCK_NS = 1_000_000


def routes(run) -> list:
    """[(root, {span_id: record})] for every ``route`` root of the program
    inside a traced request, with the records of its request."""
    tr = run.trace
    if tr is None or not tr.busy_ns:
        return []
    try:
        from cfmm_routing_tpu_torch.utils.profiling import spans
    except ImportError:  # a program without spans
        return []
    records = spans()
    requests = [(sp["start"], sp["end"]) for sp in tr.spans]
    out = []
    for root in records:
        if root.parent_id is not None or root.name != "route":
            continue
        if any(s - CLOCK_NS <= root.start_ns and root.end_ns <= e + CLOCK_NS
               for s, e in requests):
            tree = {r.span_id: r for r in records if r.request_id == root.request_id}
            out.append((root, tree))
    return out


def _median(vals):
    return statistics.median(vals) if vals else None


def _outermost(rec, tree, names) -> bool:
    """Whether no ancestor of ``rec`` has one of ``names``."""
    parent = tree.get(rec.parent_id)
    while parent is not None:
        if parent.name in names:
            return False
        parent = tree.get(parent.parent_id)
    return True


def total_ms(run, *names) -> float | None:
    """Median over the traced routes of the summed time of their spans
    named ``names`` (a span inside another of them counted once), in ms."""
    names = set(names)
    return _median([
        sum(r.end_ns - r.start_ns for r in tree.values()
            if r.name in names and _outermost(r, tree, names)) / 1e6
        for _, tree in routes(run)])


def self_ms(run, name) -> float | None:
    """Median over the traced routes of the summed self time of their
    spans named ``name`` (each one's duration less its children's), in ms."""
    vals = []
    for _, tree in routes(run):
        children = {}
        for r in tree.values():
            children[r.parent_id] = children.get(r.parent_id, 0) + r.end_ns - r.start_ns
        vals.append(sum(r.end_ns - r.start_ns - children.get(r.span_id, 0)
                        for r in tree.values() if r.name == name) / 1e6)
    return _median(vals)


def counter(run, name) -> float | None:
    """Median over the traced routes of the counter ``name``'s change over
    the route."""
    return _median([root.counts.get(name, 0) for root, _ in routes(run)])
