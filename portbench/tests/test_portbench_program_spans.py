"""The readers of the program's own spans and counters
(``metrics/program.py``) on the records of routes run on the CPU, through
the route cell's own call at a tiny size, under the profiler."""
import statistics
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import run as harness
from portbench.calls import route as call
from portbench.gen import traffic as gen
from portbench.tests.conftest import SEED, TINY

READERS = ("setup_ms.route", "capture_ms.route", "check_ms.route",
           "sync_wait_ms.route", "certify_ms.route", "base_iters.route",
           "refine_iters.route")


@pytest.fixture(scope="module")
def routes():
    """Two routes of the cell's mix under the profiler: [(start_ns, end_ns)]
    of each call and the program's records."""
    from cfmm_routing_tpu_torch.utils import profiling

    config = harness.load_json("configs", "synth-100k-256.json")
    config["generator"].update(TINY)
    traffic = harness.load_json("traffic", "block-route.json")
    net = gen.network(config)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    calls = []
    try:
        profiling.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            for i in range(2):
                t0 = time.time_ns()
                call.call(net, gen.draw(traffic, net, SEED, i), traffic, device="cpu")
                calls.append((t0, time.time_ns()))
    finally:
        torch.set_num_threads(n)
    return calls, profiling.spans()


def fake_run(spans, busy_ns=1):
    trace = types.SimpleNamespace(spans=[{"start": s, "end": e} for s, e in spans],
                                  busy_ns=busy_ns)
    return types.SimpleNamespace(trace=trace)


def expected(records, root):
    """Each reader's number for one route, summed straight from its records."""
    tree = [r for r in records if r.request_id == root.request_id]
    ms = {}

    def total(*names):
        return sum(r.end_ns - r.start_ns for r in tree if r.name in names) / 1e6

    checks = {r.span_id for r in tree if r.name == "admm.check"}
    ms["setup_ms.route"] = total("route.equilibrate", "route.compile", "solver.build")
    ms["capture_ms.route"] = total("graphs.capture")
    ms["check_ms.route"] = total("admm.check") - sum(
        r.end_ns - r.start_ns for r in tree if r.parent_id in checks) / 1e6
    ms["sync_wait_ms.route"] = total("host.sync")
    ms["certify_ms.route"] = total("certify")
    ms["base_iters.route"] = root.counts.get("iters.base", 0)
    ms["refine_iters.route"] = root.counts.get("iters.refine", 0)
    return ms


def roots(records):
    return [r for r in records if r.parent_id is None and r.name == "route"]


def test_readers_read_the_route_inside_the_request(routes):
    calls, records = routes
    first, second = roots(records)
    for (s, e), root in zip(calls, (first, second)):
        assert s <= root.start_ns and root.end_ns <= e
    # a request span around the second call only: the first route is not read
    run = fake_run([calls[1]])
    want = expected(records, second)
    assert want["base_iters.route"] > 0 and want["check_ms.route"] > 0
    assert want["setup_ms.route"] > 0 and want["certify_ms.route"] > 0
    for name in READERS:
        assert harness.reader("metrics", name)(run) == pytest.approx(want[name]), name


def test_readers_take_the_median_over_the_traced_routes(routes):
    calls, records = routes
    both = [expected(records, root) for root in roots(records)]
    run = fake_run(calls)
    for name in READERS:
        want = statistics.median([b[name] for b in both])
        assert harness.reader("metrics", name)(run) == pytest.approx(want), name


@pytest.mark.parametrize("case", ["no device activity", "outside", "no program spans"])
def test_readers_find_nothing(routes, case, monkeypatch):
    calls, _ = routes
    if case == "no device activity":
        run = fake_run(calls, busy_ns=0)
    elif case == "outside":
        end = calls[-1][1]
        run = fake_run([(end + 10**9, end + 2 * 10**9)])
    else:  # a program from before its spans
        from cfmm_routing_tpu_torch.utils import profiling

        monkeypatch.delattr(profiling, "spans")
        run = fake_run(calls)
    for name in READERS:
        assert harness.reader("metrics", name)(run) is None, name
