"""The reserve-scenario cell (``scenarios-100k-8``) at a tiny size on the
CPU: its command end to end, traced and untraced; its judge against the
reference by hand; a planted fault (one state answered with another
state's trades) that turns ``correct`` false; the control; the two fold
roofline readers and the program readers on recorded events, checked by
hand; the judge's isolation from the program."""
import json
import os
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import control, roofline, roofline_fold
from portbench import run as harness
from portbench import trace
from portbench.calls import scenarios as call
from portbench.gen import scenarios as gen_scenarios
from portbench.gen import synth
from portbench.gen import traffic as gen
from portbench.judges import route as route_judge
from portbench.judges import scenarios as judge
from portbench.tests.conftest import SEED, run_cell

CELL = "scenarios-100k-8"
CHECKOUT = Path(harness.__file__).resolve().parent.parent
STATES = 3  # the mix's states at the tiny size
GROUPED2 = ("void (anonymous namespace)::grouped_kernel<float, 2>"
            "((anonymous namespace)::Table<float>, float const*, int, float, float, int, int, int)")
DELTA4 = ("void (anonymous namespace)::fused_delta_kernel<float, 4>"
          "((anonymous namespace)::Table<float>, float const*, int, float, float, int, int, int)")


@pytest.fixture
def few(tiny, monkeypatch):
    """``tiny``, with the mix's states cut to ``STATES``."""
    orig = harness.load_json

    def load(*parts):
        d = orig(*parts)
        if parts[0] == "traffic" and "scenarios" in d:
            d["scenarios"] = STATES
        return d

    monkeypatch.setattr(harness, "load_json", load)
    return tiny


def bench():
    return json.loads((CHECKOUT / "BENCHMARK.json").read_text())


def test_cell_end_to_end(few, capsys):
    rc, res, err = run_cell(capsys, CELL)
    assert rc == 0
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"route_s", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    limits = harness.load_json("workloads", f"{CELL}.json")["limits"]
    assert set(res["checks"]) == set(limits) == {"gap", "feas"}
    for k, v in res["checks"].items():
        assert v["limit"] == limits[k] and v["value"] <= v["limit"]
    tail = err.strip().splitlines()[-len(limits):]
    assert [line.split(":")[0] for line in tail] == [f"check {k}" for k in limits]


def test_cell_traced(few, capsys):
    """Traced on the CPU: no device activity, so the readers of the
    program's records and of the device trace find nothing to read."""
    rc, res, _ = run_cell(capsys, CELL, trace=1)
    assert rc == 0 and res["correct"] is True
    names = {m["name"] for m in bench()["per_layer"] if CELL in m.get("workloads", [])}
    assert names == {"fused_step_roofline.scenarios", "fused_step_delta_roofline.scenarios",
                     "fallback_points.scenarios", "reserves_ms.scenarios"}
    assert set(res["metrics"]) <= names and res["metrics"] == {}
    assert res["device"]["busy_s"] == 0.0


def test_one_state_answered_with_another_states_trades(few, capsys, monkeypatch):
    orig = call.answer

    def swapped(out):
        ans = orig(out)
        ans["states"][0] = ans["states"][1]
        return ans

    monkeypatch.setattr(call, "answer", swapped)
    rc, res, _ = run_cell(capsys, CELL)
    assert rc == 0 and res["correct"] is False and res["failed"] >= 1


def test_judge_is_the_worst_state_by_hand(few):
    """The judge of a request equals the route judge of each state on the
    state's own reserves, worst over the states; a missing state reads NaN."""
    config = harness.load_json("configs", "synth-100k-256-x8.json")
    traffic = harness.load_json("traffic", "block-scenarios.json")
    net = gen.network(config)
    req = gen.draw(traffic, net, SEED, 0)
    assert req["scale"].shape == (STATES, len(net["width"]))
    assert np.all((req["scale"] >= 0.7) & (req["scale"] < 1.3))
    out = call.call(net, req, traffic, device="cpu")
    assert call.certified(out) and len(out) == STATES
    ans = call.answer(out)
    got = judge.judge(net, req, ans, "cpu")
    by_state = []
    for s in range(STATES):
        reserves = req["reserves"] * np.repeat(req["scale"][s], net["width"])
        np.testing.assert_array_equal(reserves, gen_scenarios.state_reserves(net, req, s))
        by_state.append(route_judge.judge(net, dict(req, reserves=reserves),
                                          ans["states"][s], "cpu"))
    for k in ("gap", "feas"):
        assert got[k] == max(b[k] for b in by_state)
        assert got[k] <= harness.load_json("workloads", f"{CELL}.json")["limits"][k]
    # another state's reserves judge a state's trades as worse
    wrong = route_judge.judge(net, dict(req, reserves=gen_scenarios.state_reserves(net, req, 1)),
                              ans["states"][0], "cpu")
    assert wrong["feas"] > by_state[0]["feas"] or wrong["gap"] > by_state[0]["gap"]
    short = dict(ans, states=ans["states"][:-1])
    assert all(np.isnan(v) for v in judge.judge(net, req, short, "cpu").values())


def test_control_runs_without_the_refinement(few):
    sound, = control.readings(CELL, [SEED], 1, control=False, device="cpu")
    low, = control.readings(CELL, [SEED], 1, control=True, device="cpu")
    assert sound["certified"] and low["control"] and not sound["control"]
    assert low["gap"] >= 0 and low["feas"] >= 0


def test_fold_roofline_readers_by_hand():
    """One K = 2 base launch of 100 ns and one K = 4 delta launch of 300
    ns over a 40-pool network in 8 states, ProjectionConfig(24, 4)."""
    net = synth.random_network_table(8, 40, seed=3)
    events = [(trace.SPAN, 0, 1000, False, "user_annotation"),
              (GROUPED2, 100, 100, True, "kernel"),
              (DELTA4, 300, 300, True, "kernel")]

    class Event:
        def __init__(self, name, start, dur, cuda, kind):
            self._e = (name, start, dur, cuda)
            self.activity_type = lambda: kind

        def name(self):
            return self._e[0]

        def start_ns(self):
            return self._e[1]

        def duration_ns(self):
            return self._e[2]

    run = types.SimpleNamespace(
        trace=trace.reduce_events([Event(*e) for e in events]), net=net,
        traffic={"scenarios": 8, "options": {"projection": [24, 4]}})
    width = np.asarray(net["width"])
    # the base launch holds the pools of width <= 2 (the only variant seen)
    sel = width <= 2
    slots, pools = int(width[sel].sum()), int(sel.sum())
    bytes_ = 8 * (4 * (11 * slots + 3 * pools) + 4 * slots) + 4 * 8 * 8
    flops = 8 * 60 * 28 * slots
    want = 100 * max(bytes_ / 3.35e12, flops / 67e12) / 100e-9
    got = harness.reader("metrics", "fused_step_roofline.scenarios")(run)
    assert got == pytest.approx(want)
    # the delta launch: every pool (one variant of 4 lanes), 14 planes, 2 vectors
    slots, pools = int(width.sum()), len(width)
    bytes_ = 8 * (4 * (14 * slots + 2 * pools) + 4 * slots) + 4 * 8 * 8
    flops = 8 * 80 * 28 * slots
    want = 100 * max(bytes_ / 3.35e12, flops / 67e12) / 300e-9
    got = harness.reader("metrics", "fused_step_delta_roofline.scenarios")(run)
    assert got == pytest.approx(want)
    assert roofline.variant(GROUPED2, roofline_fold.KERNELS[False]) == ("float", 2)
    assert roofline.variant(GROUPED2, roofline_fold.KERNELS[True]) is None
    # a trace without fold launches reads nothing
    empty = types.SimpleNamespace(trace=trace.reduce_events([Event(*events[0])]), net=net,
                                  traffic=run.traffic)
    assert harness.reader("metrics", "fused_step_roofline.scenarios")(empty) is None


def test_program_readers_on_recorded_requests(few):
    """Two requests of the mix under the profiler on the CPU: the counter
    and span readers give the medians of the records, by hand."""
    from cfmm_routing_tpu_torch.utils import profiling

    config = harness.load_json("configs", "synth-100k-256-x8.json")
    traffic = harness.load_json("traffic", "block-scenarios.json")
    net = gen.network(config)
    calls = []
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(2):
            t0 = time.time_ns()
            call.call(net, gen.draw(traffic, net, SEED, i), traffic, device="cpu")
            calls.append((t0, time.time_ns()))
    records = profiling.spans()
    run = types.SimpleNamespace(trace=types.SimpleNamespace(
        spans=[{"start": s, "end": e} for s, e in calls], busy_ns=1))
    roots = [r for r in records if r.parent_id is None and r.name == "route"]
    assert len(roots) == 2 and all(r.counts["scenarios.points"] == STATES for r in roots)
    want = statistics.median(
        sum(r.end_ns - r.start_ns for r in records
            if r.request_id == root.request_id and r.name == "scenarios.reserves") / 1e6
        for root in roots)
    assert harness.reader("metrics", "reserves_ms.scenarios")(run) == pytest.approx(want)
    assert want > 0
    assert harness.reader("metrics", "fallback_points.scenarios")(run) == 0
    # no device activity: nothing to read
    idle = types.SimpleNamespace(trace=types.SimpleNamespace(spans=run.trace.spans, busy_ns=0))
    for name in ("reserves_ms.scenarios", "fallback_points.scenarios"):
        assert harness.reader("metrics", name)(idle) is None


def test_judge_imports_nothing_of_the_program():
    code = ("import sys, json, portbench.judges.scenarios; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    env = dict(os.environ, PYTHONPATH=str(CHECKOUT))
    out = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT, env=env,
                         capture_output=True, text=True, timeout=120)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"cfmm_routing_tpu_torch", "cfmm_routing_tpu", "jax", "jaxlib",
                       "flax"}
