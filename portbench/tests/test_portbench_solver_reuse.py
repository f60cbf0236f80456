"""``solver_reuse.route`` (``metrics/solver_reuse.route.py``) on synthetic
records of the program: the solvers a traced route took from the
program's cache, by its ``solvers.reused`` counter."""
import types

import pytest

from portbench import run as harness
from cfmm_routing_tpu_torch.utils import profiling

START, END = 10**18, 10**18 + 2 * 10**9


def record(name, span_id, parent_id, request_id, counts=None):
    return profiling.SpanRecord(name, span_id, parent_id, request_id,
                                START + span_id, END - span_id, counts)


def fake_run(busy_ns=1):
    trace = types.SimpleNamespace(spans=[{"start": START, "end": END}],
                                  busy_ns=busy_ns)
    return types.SimpleNamespace(trace=trace)


def read_with(monkeypatch, records, run=None):
    monkeypatch.setattr(profiling, "spans", lambda: list(records))
    return harness.reader("metrics", "solver_reuse.route")(run or fake_run())


@pytest.mark.parametrize("counts,want", [
    ({"iters.base": 3000, "solvers.reused": 2}, 2),
    ({"iters.base": 3000}, 0),  # a program that keeps no solvers
])
def test_solver_reuse_reads_the_route_counter(monkeypatch, counts, want):
    records = [record("solver.build", 2, 1, 1), record("route", 1, None, 1, counts)]
    assert read_with(monkeypatch, records) == want


def test_solver_reuse_is_the_median_over_the_traced_routes(monkeypatch):
    records = [record("route", i, None, i, {"solvers.reused": k})
               for i, k in ((1, 0), (2, 2), (3, 2))]
    assert read_with(monkeypatch, records) == 2


@pytest.mark.parametrize("case", ["no route root", "no device activity"])
def test_solver_reuse_finds_nothing(monkeypatch, case):
    name = "sweep" if case == "no route root" else "route"
    records = [record(name, 1, None, 1, {"solvers.reused": 2})]
    run = fake_run(busy_ns=0 if case == "no device activity" else 1)
    assert read_with(monkeypatch, records, run) is None
