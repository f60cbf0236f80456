"""The port's certified classic route vs the JAX package, in float64.

* ``_iterate`` matches the reference step by step for 50 steps on psi, nu
  and the trades (atol 1e-9).
* ``api.arbitrage(..., certify=True)`` at a fixed iteration count gives the
  same objective and Certificate fields in both packages (1e-9).
* ``equilibrate`` / ``unscale_result`` match on a network whose assets live
  in units 1e-6 .. 1e6 apart.
* ``convert.compiled_from_numpy`` carries the reference's compiled arrays
  across unchanged, and both packages solve them to the same route.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfmm_routing_tpu import api as ref_api
from cfmm_routing_tpu.models.reference_instances import arbitrage_instance as ref_arb
from cfmm_routing_tpu.solver import admm as ref_admm
from cfmm_routing_tpu.solver import precondition as ref_pre
from cfmm_routing_tpu.solver.compiler import compile_table as ref_compile_table
from cfmm_routing_tpu.utils.synth import random_arbitrage_table as ref_table
from cfmm_routing_tpu_torch import api, convert
from cfmm_routing_tpu_torch.models.reference_instances import arbitrage_instance
from cfmm_routing_tpu_torch.solver import precondition
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver
from cfmm_routing_tpu_torch.solver.compiler import compile_table
from cfmm_routing_tpu_torch.utils.synth import random_arbitrage_table

torch.set_num_threads(1)

F64 = torch.float64
TOL = dict(rtol=1e-9, atol=1e-9)


def _ref_and_port(n_assets, n_pools, seed):
    r_table, _ = ref_table(n_assets, n_pools, seed=seed, reserve_scale=1.0)
    table, obj = random_arbitrage_table(n_assets, n_pools, seed=seed,
                                        reserve_scale=1.0)
    return (ref_compile_table(r_table, backend="numpy"), compile_table(table),
            obj)


def test_classic_iterate_matches_reference_50_steps():
    ref_c, port_c, obj = _ref_and_port(12, 60, seed=3)
    assert {b.kind + str(b.needs_floor) for b in port_c.buckets.values()} == {
        "gmFalse", "gmTrue", "csTrue"}
    ref = ref_admm.AdmmSolver(ref_c, dtype=jnp.float64)
    port = AdmmSolver(port_c, dtype=F64, device="cpu")
    c, lo, hi = port._objective_arrays(obj)
    rc, rlo, rhi = (jnp.asarray(x.numpy()) for x in (c, lo, hi))
    step = jax.jit(lambda z, nu: ref._iterate(z, nu, 1.0, rc, rlo, rhi))
    z = {n: (jnp.zeros_like(a["mask"]), jnp.zeros_like(a["mask"]))
         for n, a in ref.buckets.items()}
    zp = {n: (torch.zeros_like(a["mask"]), torch.zeros_like(a["mask"]))
          for n, a in port.buckets.items()}
    nu = jnp.zeros(ref.n)
    nup = torch.zeros(port.n, dtype=F64)
    rho = torch.tensor(1.0, dtype=F64)
    for k in range(50):
        z, nu, psi, w, _ = step(z, nu)
        zp, nup, psip, wp, _ = port._iterate(zp, nup, rho, c, lo, hi)
        np.testing.assert_allclose(psip.numpy(), np.asarray(psi), **TOL,
                                   err_msg=f"psi step {k}")
        np.testing.assert_allclose(nup.numpy(), np.asarray(nu), **TOL,
                                   err_msg=f"nu step {k}")
        for name in w:
            for i in range(2):
                np.testing.assert_allclose(
                    wp[name][i].numpy(), np.asarray(w[name][i]), **TOL,
                    err_msg=f"trades[{name}][{i}] step {k}",
                )


def test_certified_arbitrage_matches_reference():
    opts = dict(max_iters=100, eps_abs=0.0, eps_rel=0.0, check_every=5)
    spec_r, obj_r = ref_arb()
    spec, obj = arbitrage_instance()
    want = ref_api.arbitrage(spec_r, obj_r.c, certify=True, dtype=jnp.float64,
                             options=ref_admm.AdmmOptions(**opts))
    got = api.arbitrage(spec, obj.c, certify=True, dtype=F64,
                        options=AdmmOptions(**opts), device="cpu")
    assert got.iters == want.iters == 100
    np.testing.assert_allclose(got.objective, want.objective, **TOL)
    np.testing.assert_allclose(got.psi, want.psi, **TOL)
    np.testing.assert_allclose(got.prices, want.prices, **TOL)
    for a, b in zip(got.deltas + got.lambdas, want.deltas + want.lambdas):
        np.testing.assert_allclose(a, b, **TOL)
    gc, wc = got.certificate, want.certificate
    for field in ("objective", "dual_bound", "gap_abs", "gap_rel",
                  "phi_violation", "nonneg_violation", "floor_violation",
                  "box_violation", "psi_consistency", "psi_scale",
                  "feasibility_rel"):
        np.testing.assert_allclose(getattr(gc, field), getattr(wc, field), **TOL,
                                   err_msg=field)
    np.testing.assert_allclose(gc.prices, wc.prices, **TOL)


def _skewed_tables():
    """Assets in mismatched base units: reserves of asset j scaled 10^(j%13-6)."""
    r_table, r_obj = ref_table(16, 80, seed=9)
    table, obj = random_arbitrage_table(16, 80, seed=9)
    unit = 10.0 ** (np.arange(16) % 13 - 6)
    for t in (r_table, table):
        t.reserves = t.reserves * unit[t.assets]
        t.shifts = t.shifts * unit[t.assets]
    return r_table, r_obj, table, obj


def test_equilibrate_and_unscale_match_reference():
    r_table, r_obj, table, obj = _skewed_tables()
    want = ref_pre.equilibrate(r_table, r_obj)
    got = precondition.equilibrate(table, obj)
    np.testing.assert_array_equal(got.d, want.d)
    for field in ("reserves", "weights", "shifts", "assets", "width"):
        np.testing.assert_array_equal(getattr(got.table, field),
                                      getattr(want.table, field))
    for field in ("c", "lo", "hi"):
        np.testing.assert_array_equal(getattr(got.objective, field),
                                      getattr(want.objective, field))
    comp = compile_table(got.table)
    rng = np.random.default_rng(2)
    arrays = dict(
        objective=1.0, psi=rng.normal(size=16), prices=rng.uniform(size=16),
        deltas={n: rng.uniform(size=(b.width, b.m)) for n, b in comp.buckets.items()},
        lambdas={n: rng.uniform(size=(b.width, b.m)) for n, b in comp.buckets.items()},
        iters=7, r_norm=0.1, s_norm=0.2, converged=False, rho_final=1.0,
    )
    res = convert.route_result_from_numpy(**arrays, dtype=F64, device="cpu")
    ours = precondition.unscale_result(res, got.d, comp)
    theirs = ref_pre.unscale_result(ref_admm.RouteResult(**arrays), want.d,
                                    ref_compile_table(want.table, backend="numpy"))
    np.testing.assert_array_equal(ours.psi, theirs.psi)
    np.testing.assert_array_equal(ours.prices, theirs.prices)
    for name in comp.buckets:
        np.testing.assert_array_equal(ours.deltas[name], theirs.deltas[name])
        np.testing.assert_array_equal(ours.lambdas[name], theirs.lambdas[name])


def test_preconditioned_route_matches_reference():
    """route(precondition=True, certify=True) on the skewed network: same
    route and certificate in the caller's units."""
    r_table, r_obj, table, obj = _skewed_tables()
    opts = dict(max_iters=60, eps_abs=0.0, eps_rel=0.0)
    want = ref_api.route(_spec_from_table(r_table, ref=True), r_obj, certify=True,
                         precondition=True, dtype=jnp.float64,
                         options=ref_admm.AdmmOptions(**opts))
    got = api.route(_spec_from_table(table, ref=False), obj, certify=True,
                    precondition=True, dtype=F64, options=AdmmOptions(**opts),
                    device="cpu")
    np.testing.assert_allclose(got.objective, want.objective, **TOL)
    np.testing.assert_allclose(got.psi, want.psi, **TOL)
    for field in ("gap_rel", "dual_bound", "feasibility_rel"):
        np.testing.assert_allclose(getattr(got.certificate, field),
                                   getattr(want.certificate, field), **TOL,
                                   err_msg=field)


def _spec_from_table(t, ref):
    """ProblemSpec with the table's pools (geo-mean / bounded / sum)."""
    if ref:
        from cfmm_routing_tpu.models import pools as P
        from cfmm_routing_tpu.solver.compiler import ProblemSpec
    else:
        from cfmm_routing_tpu_torch.models import pools as P
        from cfmm_routing_tpu_torch.solver.compiler import ProblemSpec
    pools = []
    for i in range(t.n_pools):
        o, k = t.offset[i], t.width[i]
        a, r = t.assets[o:o + k], t.reserves[o:o + k]
        if t.kind[i] == 1:
            pools.append(P.ConstantSumPool(a, r, fee=t.fees[i]))
        elif t.floor[i]:
            pools.append(P.BoundedProductPool(a, r, t.shifts[o:o + k], fee=t.fees[i]))
        else:
            pools.append(P.GeoMeanPool(a, r, t.weights[o:o + k], fee=t.fees[i]))
    return ProblemSpec(t.n_assets, pools)


def test_compiled_from_numpy_round_trips_reference_arrays():
    ref_c, port_c, obj = _ref_and_port(10, 40, seed=1)
    fields = ("kind", "width", "reserves", "weights", "shift", "gamma", "logk0",
              "k0", "mask", "asset", "pool_ids", "needs_floor")
    carried = convert.compiled_from_numpy(
        ref_c.n_assets, ref_c.degree,
        {n: {f: getattr(b, f) for f in fields} for n, b in ref_c.buckets.items()},
        ref_c.n_pools, ref_c.widths,
    )
    assert list(carried.buckets) == list(port_c.buckets)
    np.testing.assert_array_equal(carried.degree, port_c.degree)
    assert (carried.n_pools, carried.n_slots) == (port_c.n_pools, port_c.n_slots)
    for name, b in port_c.buckets.items():
        cb = carried.buckets[name]
        for f in fields:
            np.testing.assert_array_equal(getattr(cb, f), getattr(b, f))
    opts = AdmmOptions(max_iters=40, eps_abs=0.0, eps_rel=0.0)
    a = AdmmSolver(carried, dtype=F64, options=opts, device="cpu").solve(obj)
    b = AdmmSolver(port_c, dtype=F64, options=opts, device="cpu").solve(obj)
    assert torch.equal(a.psi, b.psi)


@pytest.mark.parametrize("kw,err", [(dict(refine_to=1e-7), NotImplementedError),
                                    (dict(precondition=True), ValueError)])
def test_api_rejects_unported_or_conflicting_options(kw, err):
    spec, obj = arbitrage_instance()
    solver = api.make_solver(spec, device="cpu")
    with pytest.raises(err):
        api.arbitrage(spec, obj.c, solver=solver, **kw)
