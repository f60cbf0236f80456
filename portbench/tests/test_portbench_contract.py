"""BENCHMARK.json against the benchmark's contract, every name found as a
file, and the reference's isolation from the program."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run as harness

CHECKOUT = Path(harness.__file__).resolve().parent.parent
BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert len(BENCH["command"]) <= 32 and all(line(w) for w in BENCH["command"])
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert not p.endswith("_torch") and (CHECKOUT / p).is_dir()
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert (CHECKOUT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_configs_and_cells_are_files_found_by_name():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("portbench/") and (CHECKOUT / c["file"]).is_file()
        assert json.loads((CHECKOUT / c["file"]).read_text())["reduced"] == c["reduced"]
    used = set()
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and line(w["why"])
        assert w["config"] in configs and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        cell = harness.load_json("workloads", f"{w['name']}.json")
        assert (cell["config"], cell["traffic"], cell["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        assert (CHECKOUT / "portbench/traffic" / f"{w['traffic']}.json").is_file()
        assert cell["limits"] and all(v > 0 for v in cell["limits"].values())
    assert used == set(configs)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics_have_readers_and_cover_every_cell():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
        assert callable(harness.reader("e2e", m["name"]))
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert m["source"] in SOURCES and line(m["layer"]) and m["moves"] in e2e
        layers.setdefault(m["layer"], []).append(m["name"])
        assert callable(harness.reader("metrics", m["name"]))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        e = harness.metrics_of(BENCH, w["name"], trace=False)
        assert "setup_s" in {m["name"] for m in e} and len(e) >= 2
        assert harness.metrics_of(BENCH, w["name"], trace=True)


@pytest.mark.parametrize("module", ["portbench.reference", "portbench.judges.route",
                                    "portbench.judges.sweep"])
def test_reference_imports_nothing_of_the_program(module):
    """``reference.py`` and the judges, imported in a fresh process, load no
    module of the port, of the JAX package or of JAX."""
    code = (f"import sys, json, {module}; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    env = dict(os.environ, PYTHONPATH=str(CHECKOUT))
    out = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT, env=env,
                         capture_output=True, text=True, timeout=120)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"cfmm_routing_tpu_torch", "cfmm_routing_tpu", "jax", "jaxlib",
                       "flax"}
