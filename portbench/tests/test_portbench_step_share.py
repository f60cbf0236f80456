"""``step_share.route`` (``metrics/step_share.route.py``) on synthetic
records of the program: the share of a route's base iterations that its
counters say ran as the classic step kernels."""
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
    return harness.reader("metrics", "step_share.route")(run or fake_run())


@pytest.mark.parametrize("counts,want", [
    ({"iters.base": 1675, "iters.step": 1608, "iters.refine": 500}, 96.0),
    ({"iters.base": 1675}, 0.0),  # a program without the kernels
])
def test_step_share_reads_the_route_counters(monkeypatch, counts, want):
    records = [record("admm.solve", 2, 1, 1), record("route", 1, None, 1, counts)]
    assert read_with(monkeypatch, records) == pytest.approx(want)


@pytest.mark.parametrize("case", ["no route root", "no base iterations",
                                  "no device activity"])
def test_step_share_finds_nothing(monkeypatch, case):
    if case == "no route root":
        records = [record("sweep", 1, None, 1, {"iters.base": 25, "iters.step": 24})]
    else:
        records = [record("route", 1, None, 1,
                          {} if case == "no base iterations"
                          else {"iters.base": 25, "iters.step": 24})]
    run = fake_run(busy_ns=0 if case == "no device activity" else 1)
    assert read_with(monkeypatch, records, run) is None
