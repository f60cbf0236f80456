"""The chunked solve driver and the infeasibility certificate: the port
against the JAX package on the CPU.

* ``ChunkedDriver``: classic chunks in float64 follow the reference's
  trajectory and ``SolveLog`` to 1e-9; fused chunks in float32 to the fused
  bar (atol 2e-4, rtol 1e-5); a stalled run returns its best iterate, as
  the reference's does; checkpoint then resume equals an uninterrupted
  run; the log exports to CSV.
* ``certify_infeasible`` matches the reference's fields to 1e-9 on the
  reference's infeasible liquidation (``tests/test_infeasible.py``), and
  ``ChunkedDriver`` reports that program as infeasible.
"""
import csv
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cfmm_routing_tpu.models.pools import ProductPool as RefProductPool
from cfmm_routing_tpu.models.reference_instances import arbitrage_instance as ref_arb
from cfmm_routing_tpu.models.utility import Objective as RefObjective
from cfmm_routing_tpu.solver import admm as ref_admm
from cfmm_routing_tpu.solver import certify as ref_certify
from cfmm_routing_tpu.solver import driver as ref_driver
from cfmm_routing_tpu.solver.compiler import ProblemSpec as RefSpec
from cfmm_routing_tpu.solver.compiler import compile_spec as ref_compile_spec
from cfmm_routing_tpu_torch.models.pools import ProductPool
from cfmm_routing_tpu_torch.models.reference_instances import arbitrage_instance
from cfmm_routing_tpu_torch.models.utility import Objective
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver
from cfmm_routing_tpu_torch.solver.certify import certify_infeasible
from cfmm_routing_tpu_torch.solver.compiler import ProblemSpec, compile_spec
from cfmm_routing_tpu_torch.solver.driver import ChunkedDriver

torch.set_num_threads(1)


def _driver_pair(dtype, **opts):
    spec, obj = arbitrage_instance()
    spec_r, obj_r = ref_arb()
    port = AdmmSolver(compile_spec(spec), dtype=dtype, device="cpu",
                      options=AdmmOptions(**opts))
    ref = ref_admm.AdmmSolver(ref_compile_spec(spec_r),
                              dtype=jnp.float64 if dtype == torch.float64 else jnp.float32,
                              options=ref_admm.AdmmOptions(**opts))
    return port, ref, obj, obj_r


def _assert_same_run(got, want, atol, rtol=0.0):
    (res, log), (res_r, log_r) = got, want
    assert log.status == log_r.status
    assert len(log) == len(log_r)
    for a, b in zip(log.records, log_r.records):
        assert a.iteration == b.iteration
        np.testing.assert_allclose(
            [a.r_norm, a.s_norm, a.eps_pri, a.eps_dua, a.rho, a.objective],
            [b.r_norm, b.s_norm, b.eps_pri, b.eps_dua, b.rho, b.objective],
            atol=atol, rtol=rtol)
    np.testing.assert_allclose(res.psi.numpy(), np.asarray(res_r.psi), atol=atol,
                               rtol=rtol)
    np.testing.assert_allclose(res.prices.numpy(), np.asarray(res_r.prices),
                               atol=atol, rtol=rtol)
    for name in res.deltas:
        np.testing.assert_allclose(res.deltas[name].numpy(),
                                   np.asarray(res_r.deltas[name]), atol=atol,
                                   rtol=rtol)
    assert int(res.iters) == int(res_r.iters)


def test_chunked_classic_matches_reference_float64():
    port, ref, obj, obj_r = _driver_pair(torch.float64, eps_abs=1e-12,
                                         eps_rel=1e-12)
    got = ChunkedDriver(port, chunk=20).solve(obj, max_iters=100)
    want = ref_driver.ChunkedDriver(ref, chunk=20).solve(obj_r, max_iters=100)
    assert got[1].status == "max_iters"
    _assert_same_run(got, want, atol=1e-9, rtol=1e-9)


def test_stalled_run_returns_best_iterate():
    """Unreachable tolerances: the run stalls (no 30% progress in 12 chunks)
    and returns the iterate with the best residual score, as the
    reference's driver does."""
    port, ref, obj, obj_r = _driver_pair(torch.float64, eps_abs=1e-15,
                                         eps_rel=1e-15, adapt_rho=False)
    got = ChunkedDriver(port, chunk=1).solve(obj, max_iters=400)
    want = ref_driver.ChunkedDriver(ref, chunk=1).solve(obj_r, max_iters=400)
    res, log = got
    assert log.status == "stalled"
    best = min(log.records, key=lambda r: max(r.r_norm / r.eps_pri,
                                              r.s_norm / r.eps_dua))
    assert float(res.r_norm) == best.r_norm and float(res.s_norm) == best.s_norm
    _assert_same_run(got, want, atol=1e-9, rtol=1e-9)


def test_chunked_fused_matches_reference_float32():
    """The arbitrage instance padded to 128 pools per bucket (three
    buckets: the reference's interpret-mode kernels compile per bucket)."""
    spec, obj = arbitrage_instance()
    spec_r, _ = ref_arb()
    opts = dict(eps_abs=1e-12, eps_rel=1e-12)
    port = AdmmSolver(compile_spec(spec, pad_pools_to=128), device="cpu",
                      options=AdmmOptions(**opts))
    ref = ref_admm.AdmmSolver(ref_compile_spec(spec_r, pad_pools_to=128),
                              dtype=jnp.float32, options=ref_admm.AdmmOptions(**opts))
    got = ChunkedDriver(port, chunk=6, fused=True).solve(obj, max_iters=12)
    want = ref_driver.ChunkedDriver(ref, chunk=6, fused=True,
                                    interpret=True).solve(obj, max_iters=12)
    _assert_same_run(got, want, atol=2e-4, rtol=1e-5)


def test_checkpoint_then_resume_equals_uninterrupted(tmp_path):
    port, _, obj, _ = _driver_pair(torch.float64, eps_abs=1e-12, eps_rel=1e-12)
    drv = ChunkedDriver(port, chunk=10)
    full, full_log = drv.solve(obj, max_iters=60)
    path = str(tmp_path / "state")
    drv.solve(obj, max_iters=30, checkpoint_path=path)
    res, log = drv.solve(obj, max_iters=60, checkpoint_path=path, resume=True)
    assert [r.iteration for r in log.records] == [40, 50, 60]
    assert [r.as_dict() for r in log.records] == [
        r.as_dict() for r in full_log.records[3:]]
    for a, b in zip((res.psi, res.prices), (full.psi, full.prices)):
        assert torch.equal(a, b)
    for name in res.deltas:
        assert torch.equal(res.deltas[name], full.deltas[name])
    log.to_csv(str(tmp_path / "log.csv"))
    with open(tmp_path / "log.csv") as fh:
        rows = list(csv.DictReader(fh))
    assert [int(r["iteration"]) for r in rows] == [40, 50, 60]
    assert [float(r["r_norm"]) for r in rows] == [r.r_norm for r in log.records]


def _infeasible_case(demand):
    """The reference's own infeasibility instance (``tests/test_infeasible.py``):
    one 10/10 product pool, at most 10 units of asset 0 to spend, at least
    ``demand`` of asset 1 to end with (infeasible above 10)."""
    pools = [((0, 1), [10.0, 10.0], 0.997)]
    spec = ProblemSpec(2, [ProductPool(a, r, fee=f) for a, r, f in pools])
    spec_r = RefSpec(2, [RefProductPool(a, r, fee=f) for a, r, f in pools])
    box = dict(c=np.array([0.0, 1.0]), lo=np.array([-10.0, demand]),
               hi=np.array([np.inf, np.inf]))
    return spec, spec_r, Objective(**box), RefObjective(**box)


@pytest.mark.parametrize("demand", [50.0, 2.0])
def test_certify_infeasible_matches_reference(demand):
    spec, spec_r, obj, obj_r = _infeasible_case(demand)
    compiled, compiled_r = compile_spec(spec), ref_compile_spec(spec_r)
    for u in ([0.0, 1.0], [1.0, 1.0], [3.0, 0.1], [0.0, 0.0]):
        got = certify_infeasible(compiled, obj, np.array(u), device="cpu")
        want = ref_certify.certify_infeasible(compiled_r, obj_r, np.array(u))
        assert got.infeasible == want.infeasible
        if demand < 10:
            assert not got.infeasible and got.margin >= 0.0
        np.testing.assert_allclose(got.margin, want.margin, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(got.prices, want.prices, rtol=1e-9, atol=1e-9)
    if demand > 10:  # the pools emit at most 10 units of asset 1
        got = certify_infeasible(compiled, obj, np.array([0.0, 1.0]), device="cpu")
        assert got.infeasible and got.margin < -35.0 and "INFEASIBLE" in got.summary()


def test_driver_reports_infeasible_program():
    spec, _, obj, _ = _infeasible_case(50.0)
    solver = AdmmSolver(compile_spec(spec), dtype=torch.float64, device="cpu",
                        options=dataclasses.replace(AdmmOptions(), eps_abs=1e-9,
                                                    eps_rel=1e-9))
    res, log = ChunkedDriver(solver, chunk=10).solve(obj, max_iters=20000)
    assert log.status == "infeasible", log.status
    assert log.infeasibility.infeasible and log.infeasibility.margin < -35.0
    assert not bool(res.converged)
