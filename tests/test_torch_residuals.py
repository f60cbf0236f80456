"""The port's device gate (``solver/residuals.py``) vs the JAX package (CPU).

* The two cases of ``tests/test_residuals.py`` (identity scaling, and an
  equilibrated solve gated in original units with ``d=eq.d``): the port's
  ``DeviceGate`` evaluates the JAX solve's own state (z, nu, rho), carried
  across with ``convert.state_from_numpy``, and matches the JAX gate on that
  state at the JAX test's bars (objective 1e-5 relative, dual 1e-9 relative,
  gap and feasibility 1e-5 absolute), in float32; and matches the port's own
  float64 ``certify`` of the same projected point at those bars.
* Float64 at ProjectionConfig(48, 6): gate against gate, 1e-10.
* A short gated loop of ``chip_smoke.gated_route`` (the card route's own
  function) on the reference liquidation instance, 128-padded, in 50-
  iteration chunks (fused chunks of the plain kernels, the device gate
  every second chunk, a confirming certificate, then ``refine_device``): it
  hands off and certifies at 1e-6, at the liquidation pin (2e-6, the
  float32 refined bar).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfmm_routing_tpu.solver.admm import AdmmOptions as RefOptions
from cfmm_routing_tpu.solver.admm import AdmmSolver as RefSolver
from cfmm_routing_tpu.solver.compiler import compile_table as ref_compile_table
from cfmm_routing_tpu.solver.precondition import equilibrate as ref_equilibrate
from cfmm_routing_tpu.solver.precondition import scale_objective as ref_scale_objective
from cfmm_routing_tpu.solver.precondition import scale_table as ref_scale_table
from cfmm_routing_tpu.solver.residuals import DeviceGate as RefGate
from cfmm_routing_tpu.utils.synth import random_arbitrage_table as ref_table
from cfmm_routing_tpu_torch.convert import state_from_numpy
from cfmm_routing_tpu_torch.ops.projection import ProjectionConfig
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver
from cfmm_routing_tpu_torch.solver.certify import certify
from cfmm_routing_tpu_torch.solver.compiler import compile_table
from cfmm_routing_tpu_torch.solver.precondition import (
    equilibrate, scale_objective, scale_table,
)
from cfmm_routing_tpu_torch.solver.residuals import DeviceGate, GateEstimate
from cfmm_routing_tpu_torch.utils.synth import random_arbitrage_table

torch.set_num_threads(1)


def _ref_state(solver, obj, iters, dtype):
    """The JAX classic iterate after ``iters`` iterations from zero, rho 1
    (``tests/test_residuals.py:_solve_state``), as numpy."""
    c = jnp.asarray(obj.c, dtype)
    lo = jnp.asarray(np.maximum(obj.lo, -3e38), dtype)
    hi = jnp.asarray(np.minimum(obj.hi, 3e38), dtype)
    z = {nm: (jnp.zeros_like(a["mask"]), jnp.zeros_like(a["mask"]))
         for nm, a in solver.buckets.items()}
    nu = jnp.zeros((solver.n,), dtype)
    rho = jnp.asarray(1.0, dtype)
    step = jax.jit(lambda z, nu: solver._iterate(z, nu, rho, c, lo, hi)[:2])
    for _ in range(iters):
        z, nu = step(z, nu)
    return jax.tree_util.tree_map(np.asarray, (z, nu))


def _skewed(table_fn, scale_table_fn, scale_objective_fn, seed):
    table, obj = table_fn(12, 64, seed=seed)
    d_skew = np.exp2(np.round(np.linspace(-6, 6, table.n_assets)))
    return (scale_table_fn(table, 1.0 / d_skew), scale_objective_fn(obj, 1.0 / d_skew))


def _case(equilibrated, dtype, cfg=None):
    """(ref gate estimate, port gate, port state) on one problem: the JAX
    solve's state after 400 (identity) or 500 (equilibrated) iterations."""
    ref_opts = RefOptions(max_iters=10)
    opts = AdmmOptions(max_iters=10)
    if cfg is not None:
        from cfmm_routing_tpu.ops.projection import ProjectionConfig as RefCfg

        ref_opts = RefOptions(max_iters=10, projection=RefCfg(*cfg))
        opts = AdmmOptions(max_iters=10, projection=ProjectionConfig(*cfg))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    if equilibrated:
        r_table, r_obj = _skewed(ref_table, ref_scale_table, ref_scale_objective, 6)
        table, obj = _skewed(random_arbitrage_table, scale_table, scale_objective, 6)
        r_eq, eq = ref_equilibrate(r_table, r_obj), equilibrate(table, obj)
        np.testing.assert_array_equal(r_eq.d, eq.d)
        r_solver = RefSolver(ref_compile_table(r_eq.table), dtype=jdt, options=ref_opts)
        solver = AdmmSolver(compile_table(eq.table), dtype=dtype, options=opts,
                            device="cpu")
        z, nu = _ref_state(r_solver, r_eq.objective, 500, jdt)
        r_gate = RefGate(r_solver, ref_compile_table(r_table), r_obj, d=r_eq.d)
        gate = DeviceGate(solver, compile_table(table), obj, d=eq.d)
        d = eq.d
    else:
        r_table, r_obj = ref_table(12, 64, seed=4)
        table, obj = random_arbitrage_table(12, 64, seed=4)
        r_solver = RefSolver(ref_compile_table(r_table), dtype=jdt, options=ref_opts)
        solver = AdmmSolver(compile_table(table), dtype=dtype, options=opts,
                            device="cpu")
        z, nu = _ref_state(r_solver, r_obj, 400, jdt)
        r_gate = RefGate(r_solver, ref_compile_table(r_table), r_obj)
        gate = DeviceGate(solver, compile_table(table), obj)
        d = np.ones(table.n_assets)
    want = r_gate.finish(r_gate.evaluate(
        jax.tree_util.tree_map(jnp.asarray, z), jnp.asarray(nu), 1.0))
    zt, nut = state_from_numpy(z, nu, dtype=dtype, device="cpu")
    return want, gate, solver, zt, nut, obj, d


def _certify_same_point(gate, solver, z, nu, obj, d):
    """The port's float64 certificate of the gate's projected point, in
    original units."""
    d_ext = np.concatenate([d, [1.0]])
    inputs = {}
    for name in solver.buckets:
        nu_e = solver._bcast_nu(nu, name)
        inputs[name] = (z[name][0] - nu_e, z[name][1] + nu_e)
    proj = solver._project_groups(inputs, solver.buckets)
    deltas, lambdas = {}, {}
    for name, (D, L) in proj.items():
        ds = d_ext[solver.compiled.buckets[name].asset].T
        deltas[name] = D.numpy().astype(np.float64) * ds
        lambdas[name] = L.numpy().astype(np.float64) * ds
    prices = nu.numpy().astype(np.float64) / d
    return certify(gate.compiled_orig, obj, deltas, lambdas, prices, device="cpu")


@pytest.mark.parametrize("equilibrated", [False, True], ids=["identity", "equilibrated"])
def test_gate_matches_reference_gate_and_certificate(equilibrated):
    want, gate, solver, z, nu, obj, d = _case(equilibrated, torch.float32)
    got = gate.finish(gate.evaluate(z, nu, 1.0))
    assert isinstance(got, GateEstimate)
    assert abs(got.objective - want.objective) <= 1e-5 * max(1.0, abs(want.objective))
    assert abs(got.dual - want.dual) <= 1e-9 * max(1.0, abs(want.dual))
    assert abs(got.gap_rel - want.gap_rel) <= 1e-5
    assert abs(got.feasibility_rel - want.feasibility_rel) <= 1e-5
    cert = _certify_same_point(gate, solver, z, nu, obj, d)
    obj_bar = 1e-4 if equilibrated else 1e-5  # tests/test_residuals.py's bars
    assert abs(got.objective - cert.objective) <= obj_bar * max(1.0, abs(cert.objective))
    assert abs(got.gap_rel - cert.gap_rel) <= 1e-5
    assert abs(got.feasibility_rel - cert.feasibility_rel) <= 1e-5
    assert got.score == max(abs(got.gap_rel), got.feasibility_rel)


@pytest.mark.parametrize("equilibrated", [False, True], ids=["identity", "equilibrated"])
def test_gate_matches_reference_gate_float64(equilibrated):
    want, gate, _, z, nu, _, _ = _case(equilibrated, torch.float64, cfg=(48, 6))
    got = gate.finish(gate.evaluate(z, nu, 1.0))
    for field in ("gap_rel", "feasibility_rel", "objective", "dual"):
        a, b = getattr(got, field), getattr(want, field)
        assert abs(a - b) <= 1e-10 * max(1.0, abs(b)), (field, a, b)


def test_gate_takes_a_linear_objective_only():
    from cfmm_routing_tpu_torch.models.utility import ConcaveUtility

    table, obj = random_arbitrage_table(12, 64, seed=4)
    compiled = compile_table(table)
    solver = AdmmSolver(compiled, device="cpu")
    with pytest.raises(TypeError, match="linear Objective"):
        DeviceGate(solver, compiled, ConcaveUtility.from_objective(obj))


def test_gated_route_hands_off_and_certifies():
    import chip_smoke
    from cfmm_routing_tpu_torch.models.reference_instances import liquidation_instance
    from cfmm_routing_tpu_torch.solver.compiler import PoolTable

    spec, obj = liquidation_instance()
    out = chip_smoke.gated_route(PoolTable.from_spec(spec), obj, device="cpu", pad=128,
                                 chunk=50, say=lambda msg: None)
    assert out["handoff"] and out["achieved"]
    assert out["gate_passes"] >= 1 and out["confirms"] == 1
    assert out["iters_to_1e3"] is not None and out["refine_iters"] > 0
    assert abs(out["gap_rel"]) <= 1e-6 and out["feasibility_rel"] <= 1e-6
    assert abs(out["objective"] - 15.883010) <= 2e-6 * 15.883010
