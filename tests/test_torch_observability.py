"""Determinism, profiling hooks and the scipy oracle of the port, on the
CPU.

* Two classic solves of the same problem with the same options are bitwise
  equal (``tests/test_observability.py``'s determinism check).
* ``time_phases`` returns the JAX package's four phases, each > 0 seconds
  per iteration; on the CPU its phases run the solver's own plain versions.
* ``trace`` writes a trace file into its directory and yields the profiler.
* ``oracle_solve`` agrees with the JAX package's oracle on the three
  reference instances (the same algorithm on the same data: to 1e-12) and
  with the BASELINE.md pins to 1e-6, at ``maxiter=150``, which both
  oracles reach on these instances.
"""
import os

import numpy as np
import pytest
import torch

from cfmm_routing_tpu.models import reference_instances as ref_instances
from cfmm_routing_tpu.oracle import oracle_solve as ref_oracle_solve
from cfmm_routing_tpu_torch.models import reference_instances
from cfmm_routing_tpu_torch.models.reference_instances import arbitrage_instance
from cfmm_routing_tpu_torch.oracle import oracle_solve
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver
from cfmm_routing_tpu_torch.solver.compiler import compile_spec
from cfmm_routing_tpu_torch.utils.profiling import time_phases, trace

torch.set_num_threads(1)


def _solver(max_iters):
    spec, obj = arbitrage_instance()
    opts = AdmmOptions(max_iters=max_iters, eps_abs=1e-8, eps_rel=1e-8)
    return AdmmSolver(compile_spec(spec), dtype=torch.float32, options=opts,
                      device="cpu"), obj


def test_determinism_bitwise():
    solver_a, obj = _solver(50)
    solver_b, _ = _solver(50)
    a, b = solver_a.solve(obj), solver_b.solve(obj)
    for x, y in ((a.objective, b.objective), (a.psi, b.psi), (a.prices, b.prices)):
        assert torch.equal(x, y)
    for name in a.deltas:
        assert torch.equal(a.deltas[name], b.deltas[name])
        assert torch.equal(a.lambdas[name], b.lambdas[name])


def test_time_phases():
    solver, obj = _solver(10)
    t = time_phases(solver, obj, inner=3)
    assert set(t) == {"project+bcast", "edge-reduce", "psi-prox", "full-iteration"}
    assert all(v > 0 for v in t.values())


def test_trace_writes_profile(tmp_path):
    solver, obj = _solver(2)
    with trace(str(tmp_path)) as prof:
        solver.solve(obj)
    produced = [p for p in tmp_path.rglob("*") if p.is_file()]
    assert produced and all(os.path.getsize(p) > 0 for p in produced)
    assert len(prof.key_averages()) > 0


@pytest.mark.parametrize("instance, pin", [
    ("arbitrage_instance", 21.499805),
    ("liquidation_instance", 15.883010),
    ("two_asset_instance", 6.233000),
])
def test_oracle_matches_reference(instance, pin):
    spec, obj = getattr(reference_instances, instance)()
    ref_spec, ref_obj = getattr(ref_instances, instance)()
    ours = oracle_solve(spec, obj, maxiter=150)
    theirs = ref_oracle_solve(ref_spec, ref_obj, maxiter=150)
    assert abs(ours.objective - theirs.objective) <= 1e-12 * abs(theirs.objective)
    np.testing.assert_allclose(ours.psi, theirs.psi, rtol=1e-9, atol=1e-9)
    value = ours.psi[4] if instance == "liquidation_instance" else ours.objective
    assert abs(value - pin) <= 1e-6 * pin
