"""Shared helpers of the benchmark's CPU tests: the harness at a tiny size,
with the program's plain paths on the CPU.

Run from the root of the repository:

    python -m pytest portbench/tests -q
"""
import json

import pytest
import torch

from portbench import run as harness

# a network small enough for the plain paths (a certified route takes
# seconds on the CPU), on which sound routes read within the cell's limits
TINY = {"n_pools": 12, "n_assets": 4}
SEED = 2147483659


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny(monkeypatch):
    """Shrink every configuration's network to ``TINY`` (and a frontier's
    grid to ``points`` points) for the harness's file loader."""
    orig = harness.load_json
    sizes = dict(TINY)

    def load(*parts):
        d = orig(*parts)
        if parts[0] == "configs":
            d["generator"].update(n_pools=sizes["n_pools"], n_assets=sizes["n_assets"])
        if parts[0] == "traffic" and "points" in sizes:
            d["points"] = sizes["points"]
        return d

    monkeypatch.setattr(harness, "load_json", load)
    return sizes


def run_cell(capsys, workload, seed=SEED, seconds=0.01, trace=0):
    """One run of the harness on the CPU; returns (exit code, result line
    as a dict or None, standard error)."""
    rc = harness.main(["--workload", workload, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace)], device="cpu")
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err
