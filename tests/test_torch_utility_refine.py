"""Port device refinement of separable concave utilities (CPU).

* The delta-dual correction solve with a ``DeltaUtility`` prox equals the
  reference's, in float64 for 10 iterations from the same base point and
  delta arrays: 1e-9.
* Its fused form (9 fused iterations + the classic harvest) equals the
  classic one stopped at 10, at the bars of ``tests/test_refine_device.py``.
* ``refine_device`` certifies the instances of
  ``tests/test_refine_device.py`` (log atoms on every asset of the
  arbitrage instance; quadratic and power atoms, from a looser base so that
  the correction solves have work to do) at 1e-6, with the certified
  utility value within 1e-6 (relative) of the JAX package's scipy
  ``oracle_solve``.

The base point of the delta solves is the reference's float32 solve of the
300-pool / 16-asset network with log atoms on assets 1 and 3 (``_with_logs``
of ``tests/test_refine_device.py``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfmm_routing_tpu.models.reference_instances import (
    arbitrage_instance as ref_arbitrage_instance,
)
from cfmm_routing_tpu.models.utility import ConcaveUtility as RefUtility
from cfmm_routing_tpu.oracle import oracle_solve
from cfmm_routing_tpu.solver import admm as ref_admm
from cfmm_routing_tpu.solver import refine_device as ref_rd
from cfmm_routing_tpu.solver.compiler import compile_table as ref_compile_table
from cfmm_routing_tpu.utils.synth import random_arbitrage_table as ref_table
from cfmm_routing_tpu_torch.models.reference_instances import arbitrage_instance
from cfmm_routing_tpu_torch.models.utility import ConcaveUtility
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver
from cfmm_routing_tpu_torch.solver.compiler import compile_spec, compile_table
from cfmm_routing_tpu_torch.solver.refine_device import (
    DeltaAdmmSolver, _delta_objective, _psi_from_trades, refine_device,
)
from cfmm_routing_tpu_torch.utils.synth import random_arbitrage_table

torch.set_num_threads(1)

EPS = 1e-3
F32, F64 = torch.float32, torch.float64


def _with_logs(cls, obj):
    util = cls.linear(obj.c, lo=obj.lo, hi=obj.hi)
    return util.with_log(1, c=1.0, b=2.0).with_log(3, c=0.5, b=1.0)


@pytest.fixture(scope="module")
def case():
    r_table, r_obj = ref_table(16, 300, seed=4, reserve_scale=1.0)
    ref_compiled = ref_compile_table(r_table, pad_pools_to=256, backend="numpy")
    table, obj = random_arbitrage_table(16, 300, seed=4, reserve_scale=1.0)
    ref_util, util = _with_logs(RefUtility, r_obj), _with_logs(ConcaveUtility, obj)
    ref_solver = ref_admm.AdmmSolver(
        ref_compiled, dtype=jnp.float32,
        options=ref_admm.AdmmOptions(max_iters=200, check_every=25))
    base = jax.tree_util.tree_map(np.asarray, ref_solver.solve(ref_util))
    base = base._replace(psi=ref_rd._psi_from_trades(ref_compiled, base))
    rho = float(np.clip(base.rho_final, 0.25, 4.0))
    nu0f = (base.prices / rho).astype(np.float32).astype(np.float64)
    return dict(ref_compiled=ref_compiled, compiled=compile_table(table, pad_pools_to=256),
                ref_util=ref_util, util=util, base=base, rho=rho, nu0f=nu0f)


def _opts(cls, k):
    return cls(max_iters=k, eps_abs=0.0, eps_rel=0.0, adapt_rho=False)


def test_utility_delta_solve_matches_reference_float64(case):
    base, rho, nu0f = case["base"], case["rho"], case["nu0f"]
    ref_ds = ref_rd.DeltaAdmmSolver(case["ref_compiled"], dtype=jnp.float64,
                                    options=_opts(ref_admm.AdmmOptions, 10))
    ref_b, _ = ref_ds.delta_buckets(base, EPS, nu0=nu0f)
    want = ref_ds.solve_delta(ref_rd._delta_objective(case["ref_util"], base.psi, EPS),
                              ref_b, nu0f, rho, 10)
    ds = DeltaAdmmSolver(case["compiled"], dtype=F64, device="cpu",
                         options=_opts(AdmmOptions, 10))
    bdict, min_x0 = ds.delta_buckets(base, EPS, nu0=nu0f)
    assert min_x0 > 0
    psi0 = _psi_from_trades(case["compiled"], base)
    got = ds.solve_delta(_delta_objective(case["util"], psi0, EPS), bdict, nu0f,
                         rho, 10)
    assert int(got.iters) == int(want.iters) == 10
    for g, w, label in ((got.psi, want.psi, "psi"), (got.prices, want.prices, "prices"),
                        (got.objective, want.objective, "objective")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-9, rtol=1e-9,
                                   err_msg=label)
    for name in want.deltas:
        np.testing.assert_allclose(got.deltas[name].numpy(), np.asarray(want.deltas[name]),
                                   atol=1e-9, err_msg=name)


def test_utility_solve_delta_fused_matches_classic(case):
    ds = DeltaAdmmSolver(case["compiled"], dtype=F32, device="cpu",
                         options=_opts(AdmmOptions, 10))
    bdict, _ = ds.delta_buckets(case["base"], EPS, nu0=case["nu0f"])
    dobj = _delta_objective(case["util"],
                            _psi_from_trades(case["compiled"], case["base"]), EPS)
    rc = ds.solve_delta(dobj, bdict, case["nu0f"], case["rho"], 10)
    rf = ds.solve_delta(dobj, bdict, case["nu0f"], case["rho"], 9, fused=True)
    assert int(rf.iters) == int(rc.iters) == 10
    np.testing.assert_allclose(rf.psi.numpy(), rc.psi.numpy(), atol=5e-5)
    np.testing.assert_allclose(rf.prices.numpy(), rc.prices.numpy(), atol=5e-6)
    for name in rc.deltas:
        np.testing.assert_allclose(rf.deltas[name].numpy(), rc.deltas[name].numpy(),
                                   atol=2e-5, err_msg=f"D[{name}]")
    assert abs(float(rf.r_norm) - float(rc.r_norm)) < 1e-4
    assert abs(float(rf.s_norm) - float(rc.s_norm)) < 1e-4


def _all_logs(cls, n):
    util = cls.linear(np.zeros(n), lo=np.zeros(n), hi=np.full(n, np.inf))
    for j in range(n):
        util = util.with_log(j, c=1.0, b=2.0)
    return util


def _quad_power(cls, obj, n):
    util = cls.linear(obj.c, lo=np.zeros(n))
    util = util.with_quadratic(1, c=float(obj.c[1]), a=0.5)
    return util.with_power(3, c=float(obj.c[3]), p=0.5, b=1.0)


@pytest.mark.parametrize("flavour", ["log", "quad_power"])
def test_refine_device_certifies_utility_routes(flavour):
    spec, obj = arbitrage_instance()
    ref_spec, ref_obj = ref_arbitrage_instance()
    n = spec.n_assets
    if flavour == "log":
        util, ref_util = _all_logs(ConcaveUtility, n), _all_logs(RefUtility, n)
        base_eps = 1e-7
    else:
        util, ref_util = _quad_power(ConcaveUtility, obj, n), _quad_power(RefUtility,
                                                                          ref_obj, n)
        base_eps = 1e-5
    compiled = compile_spec(spec)
    solver = AdmmSolver(compiled, dtype=F32, device="cpu", options=AdmmOptions(
        max_iters=8000, eps_abs=base_eps, eps_rel=base_eps, check_every=25))
    res = solver.solve(util)
    out = refine_device(compiled, util, res, target_gap=1e-6, chunk_iters=50,
                        device="cpu")
    cert = out.certificate
    assert out.achieved, cert.summary()
    assert abs(cert.gap_rel) <= 1e-6 and cert.feasibility_rel <= 1e-6
    if flavour == "quad_power":
        assert out.iters > 0
    truth = oracle_solve(ref_spec, ref_util).objective
    assert abs(cert.objective - truth) <= 1e-6 * max(1.0, abs(truth))
