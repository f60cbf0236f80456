"""The trace reduction and each per-layer reader on a recorded event
list."""
import types

import pytest

from portbench import run as harness
from portbench import trace
from portbench.gen import synth

PROJ2 = "void (anonymous namespace)::project_kernel<float, 2>((anonymous namespace)::Table<float>, int, int, int)"
PROJ4 = "void (anonymous namespace)::project_kernel<float, 4>((anonymous namespace)::Table<float>, int, int, int)"
ADD = "void at::native::vectorized_elementwise_kernel<4, add>"


class Event:
    """A profiler event as ``kineto_results.events()`` yields it; without
    ``kind`` it has no ``activity_type`` (older torch builds)."""

    def __init__(self, name, start, dur, cuda, kind=None):
        self._n, self._s, self._d, self._c = name, start, dur, cuda
        if kind is not None:
            self.activity_type = lambda: kind

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._c else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._n == trace.SPAN


def recorded(with_kinds=True):
    """Two requests: [0, 1000) and [2000, 2600) ns."""
    k = (lambda x: x) if with_kinds else (lambda x: None)
    return [
        Event(trace.SPAN, 0, 1000, False, k("user_annotation")),
        Event(trace.SPAN, 0, 1000, True, k("gpu_user_annotation")),
        Event("aten::mul", 40, 30, False, k("cpu_op")),
        Event("cudaGraphLaunch", 150, 30, False, k("cuda_runtime")),
        Event(PROJ2, 100, 100, True, k("kernel")),  # lead 100
        Event(PROJ4, 300, 200, True, k("kernel")),
        Event(ADD, 450, 150, True, k("kernel")),  # last end 600: tail 400
        Event(trace.SPAN, 2000, 600, False, k("user_annotation")),
        Event("Memcpy HtoD", 2300, 100, True, k("gpu_memcpy")),  # lead 300, tail 200
    ]


@pytest.mark.parametrize("with_kinds", [True, False])
def test_reduction(with_kinds):
    tr = trace.reduce_events(recorded(with_kinds))
    assert [(s["start"], s["end"], s["first_device"], s["last_device"])
            for s in tr.spans] == [(0, 1000, 100, 600), (2000, 2600, 2300, 2400)]
    assert tr.window_ns == 2600
    # busy: [100, 200) + [300, 600) + [2300, 2400)
    assert tr.busy_ns == 100 + 300 + 100
    assert tr.kernels[PROJ2] == [1, 100] and tr.kernels[ADD] == [1, 150]
    assert trace.SPAN not in tr.kernels
    # the middle of the gap [0, 100) falls in aten::mul (40-70); no host
    # event covers the middle of the others
    assert tr.gaps["aten::mul"] == 100
    assert sum(tr.gaps.values()) == 2600 - 500
    b = tr.breakdown()
    assert b["device_ops"][0] == [PROJ4, 200e-9]
    assert len(b["idle_gaps"]) <= 10


def fake_run(net=None):
    run = types.SimpleNamespace(trace=trace.reduce_events(recorded()), net=net,
                                launches={}, traffic={},
                                requests=[{"answer": {"iters": 3000}},
                                          {"answer": {"iters": 3500}}])
    return run


def test_span_readers():
    run = fake_run()
    assert harness.reader("metrics", "host_lead_ms.route")(run) == pytest.approx(200e-6)
    assert harness.reader("metrics", "host_tail_ms.route")(run) == pytest.approx(300e-6)
    assert harness.reader("metrics", "idle_share.route")(run) == pytest.approx(
        100 * (1 - 500 / 2600))
    assert harness.reader("metrics", "iters_per_route")(run) == 3250


def test_roofline_reader_counts_real_slots():
    net = synth.random_network_table(8, 40, seed=3)
    run = fake_run(net)
    got = harness.reader("metrics", "project_roofline.route")(run)
    from portbench import roofline

    g = roofline.pools_by_lanes(net, [2, 4])
    want = 100 * (roofline.project_bound_s(*g[2], "float")
                  + roofline.project_bound_s(*g[4], "float")) / 300e-9
    assert got == pytest.approx(want)


def test_readers_find_nothing_without_device_activity():
    run = types.SimpleNamespace(
        trace=trace.reduce_events([Event(trace.SPAN, 0, 10, False, "user_annotation")]),
        net=synth.random_network_table(8, 40, seed=3), requests=[], launches={})
    for name in ("host_lead_ms.route", "host_tail_ms.route", "idle_share.route",
                 "project_roofline.route", "iters_per_route"):
        assert harness.reader("metrics", name)(run) is None


def test_end_to_end_readers():
    run = types.SimpleNamespace(
        setup_s=12.5, window_s=10.0,
        requests=[{"certified": True, "latency_s": v} for v in
                  (1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0, 10.0)]
        + [{"certified": False, "latency_s": 11.0}])
    assert harness.reader("e2e", "route_s")(run) == 1.0
    assert harness.reader("e2e", "setup_s")(run) == 12.5
