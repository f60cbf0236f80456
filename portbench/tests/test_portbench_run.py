"""The command end to end at a tiny size on the CPU (the program's plain
paths), its result line, and what it refuses."""
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from portbench import control
from portbench import run as harness
from portbench.tests.conftest import SEED, run_cell

CHECKOUT = Path(harness.__file__).resolve().parent.parent
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def bench():
    return json.loads((CHECKOUT / "BENCHMARK.json").read_text())


def test_route_cell_end_to_end(tiny, capsys):
    rc, res, err = run_cell(capsys, "route-100k-block")
    assert rc == 0
    assert list(res) == KEYS  # the contract's keys, the checks last
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    e2e = {m["name"]: m for m in bench()["end_to_end"]}
    assert set(res["metrics"]) == {"route_s", "setup_s"}
    for name, m in res["metrics"].items():
        assert m["unit"] == e2e[name]["unit"] and m["value"] > 0
    assert res["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                             "memory_peak_bytes": 0}
    limits = json.loads((CHECKOUT / "portbench/workloads/route-100k-block.json")
                        .read_text())["limits"]
    assert res["checks"] == {k: {"value": res["checks"][k]["value"], "limit": v}
                             for k, v in limits.items()}
    # the numbers compared, beside their limits, are the last lines of stderr
    tail = err.strip().splitlines()[-len(limits):]
    assert [line.split(":")[0] for line in tail] == [f"check {k}" for k in limits]


def test_route_cell_traced(tiny, capsys):
    rc, res, _ = run_cell(capsys, "route-100k-block", trace=1)
    assert rc == 0 and res["correct"] is True
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device",
                         "breakdown", "checks"]
    names = {m["name"] for m in bench()["per_layer"]
             if "route-100k-block" in m["workloads"]}
    assert set(res["metrics"]) <= names
    # the CPU has no device trace: only the program's counter reads
    assert set(res["metrics"]) == {"iters_per_route"}
    assert res["metrics"]["iters_per_route"]["value"] > 0
    assert res["device"]["busy_s"] == 0.0 and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_frontier_traffic_through_api_sweep(tiny):
    """The frontier mix (a 3-point grid here) through ``api.sweep``,
    judged by the reference: certified and within the limits."""
    tiny["points"] = 3
    (row,) = control.readings("frontier-10k-51", [5], 1, control=False,
                              device="cpu")
    limits = harness.load_json("workloads", "frontier-10k-51.json")["limits"]
    assert row["certified"]
    assert all(row[k] <= v for k, v in limits.items()), row


def test_control_runs_without_the_refinement(tiny):
    """The control is the program's float32 route alone: the same request,
    no refinement, its readings judged like any other."""
    sound, = control.readings("route-100k-block", [SEED], 1, control=False,
                              device="cpu")
    low, = control.readings("route-100k-block", [SEED], 1, control=True,
                            device="cpu")
    assert set(sound) == set(low) and low["control"] and not sound["control"]
    assert low["gap"] >= 0 and low["feas"] >= 0


def test_no_jax_in_a_fresh_process():
    """A run in a fresh process loads no module whose top-level name is
    jax, jaxlib, flax or the JAX package (the port's name begins with the
    JAX package's, so names are compared whole)."""
    code = """
import json, sys
from portbench import run as harness
orig = harness.load_json
def load(*parts):
    d = orig(*parts)
    if parts[0] == "configs":
        d["generator"].update(n_pools=12, n_assets=4)
    return d
harness.load_json = load
rc = harness.main(["--workload", "route-100k-block", "--seed", "7",
                   "--seconds", "0.01", "--trace", "0"], device="cpu")
tops = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps({"rc": rc, "tops": tops}))
"""
    env = dict(os.environ, PYTHONPATH=str(CHECKOUT))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT, env=env,
                         capture_output=True, text=True, timeout=600)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["rc"] == 0
    assert not set(got["tops"]) & {"jax", "jaxlib", "flax", "cfmm_routing_tpu"}
    assert "cfmm_routing_tpu_torch" in got["tops"]


def test_forbidden_modules_compares_whole_names(monkeypatch):
    assert harness.forbidden_modules() == [] or "jax" in sys.modules
    for name in ("cfmm_routing_tpu_torch", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not {"cfmm_routing_tpu_torch", "jaxtyping", "flaxen"} & set(
        harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "cfmm_routing_tpu.solver",
                        types.ModuleType("cfmm_routing_tpu.solver"))
    assert "cfmm_routing_tpu.solver" in harness.forbidden_modules()


def test_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal is for machines without one")
    rc = harness.main(["--workload", "route-100k-block", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "CUDA" in err


def test_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, a run
    exits with another code than 0 and prints no result."""
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(CHECKOUT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; from portbench import run; "
            "sys.exit(run.main(sys.argv[1:], device='cpu'))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, "--workload",
                          "route-100k-block", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
