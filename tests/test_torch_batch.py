"""Reserve-scenario batches and folded batches: the port against the JAX
package on the CPU, on the reference's two-asset instance.

* ``AdmmSolver.solve_batch_reserves`` in float64 on 2 per-pool reserve
  scenarios that stop at different iteration counts: every point matches
  the reference's vmapped batch to 1e-9 with equal counts, and the point
  that stops first equals the port's single ``solve`` on that scenario's
  reserves.
* ``solve_batch_folded`` and ``solve_batch_reserves_folded`` (float32)
  match the reference's at ``tests/test_fold.py``'s bars, 5e-5 and 5e-4
  relative; their fused paths (``fused_step(fold=)``'s plain version here)
  follow the classic ones on a 128-padded compile.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from cfmm_routing_tpu.models.reference_instances import two_asset_instance as ref_two
from cfmm_routing_tpu.ops.projection import ProjectionConfig as RefConfig
from cfmm_routing_tpu.solver import admm as ref_admm
from cfmm_routing_tpu.solver import fold as ref_fold
from cfmm_routing_tpu.solver.compiler import compile_spec as ref_compile_spec
from cfmm_routing_tpu_torch.models.reference_instances import two_asset_instance
from cfmm_routing_tpu_torch.ops.projection import ProjectionConfig
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver
from cfmm_routing_tpu_torch.solver.compiler import compile_spec
from cfmm_routing_tpu_torch.solver.fold import (
    fold_compiled, solve_batch_folded, solve_batch_reserves_folded,
)

torch.set_num_threads(1)

AMOUNTS = np.array([2.0, 10.0])
OPTS64 = dict(max_iters=3000, eps_abs=1e-6, eps_rel=1e-6)


def _grid(amounts=AMOUNTS, n=3):
    """u(t) = max psi[2] s.t. psi >= -t e_0, one row per amount."""
    T = len(amounts)
    c = np.zeros((T, n))
    c[:, 2] = 1.0
    lo = np.zeros((T, n))
    lo[:, 0] = -np.asarray(amounts)
    hi = np.full((T, n), np.finfo(np.float32).max / 4)
    return c, lo, hi


def _opts(ref=False, **kw):
    """The float32 main path's (24, 4) root-find, in both packages."""
    if ref:
        return ref_admm.AdmmOptions(projection=RefConfig(24, 4), **kw)
    return AdmmOptions(projection=ProjectionConfig(24, 4), **kw)


def _assert_points_close(got, want, tol):
    np.testing.assert_array_equal(np.asarray(got.iters), np.asarray(want.iters))
    for field in ("objective", "psi", "prices"):
        np.testing.assert_allclose(np.asarray(getattr(got, field)),
                                   np.asarray(getattr(want, field)),
                                   rtol=tol, atol=tol, err_msg=field)
    for name in want.deltas:
        for field in ("deltas", "lambdas"):
            np.testing.assert_allclose(np.asarray(getattr(got, field)[name]),
                                       np.asarray(getattr(want, field)[name]),
                                       rtol=tol, atol=tol, err_msg=f"{field}.{name}")


def test_solve_batch_reserves_matches_reference_float64():
    spec, obj = two_asset_instance(2.0)
    _, obj_r = ref_two(2.0)
    port = AdmmSolver(compile_spec(spec), dtype=torch.float64, device="cpu",
                      options=AdmmOptions(**OPTS64))
    ref = ref_admm.AdmmSolver(ref_compile_spec(ref_two()[0]), dtype=jnp.float64,
                              options=ref_admm.AdmmOptions(**OPTS64))
    compiled = port.compiled
    scale = np.random.default_rng(9).uniform(0.7, 1.3, size=(2, compiled.n_pools))
    got = port.solve_batch_reserves(obj, scale)
    want = jax.tree_util.tree_map(np.asarray, ref.solve_batch_reserves(obj_r, scale))
    assert len(set(got.iters.tolist())) == 2
    assert bool(got.converged.all())
    _assert_points_close(got, want, 1e-9)
    # the point that stops first, alone on its own reserves
    t = int(np.argmin(got.iters))
    single = AdmmSolver(fold_compiled(compiled, 1, scale[t:t + 1]), dtype=torch.float64,
                        device="cpu", options=AdmmOptions(**OPTS64)).solve(obj)
    assert int(single.iters) == int(got.iters[t])
    np.testing.assert_allclose(single.psi.numpy(), got.psi[t].numpy(), atol=1e-12)
    np.testing.assert_allclose(single.prices.numpy(), got.prices[t].numpy(), atol=1e-12)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)) / np.maximum(1.0, np.abs(np.asarray(b)))


def test_solve_batch_folded_matches_reference():
    """The joint (folded) stopping test: 5e-5 relative, as tests/test_fold.py
    holds the reference's folded batch to its per-point solves."""
    c, lo, hi = _grid()
    opts = dict(max_iters=3000, eps_abs=1e-5, eps_rel=1e-5, adapt_rho=False)
    got = solve_batch_folded(compile_spec(two_asset_instance()[0]), c, lo, hi,
                             options=_opts(**opts), device="cpu")
    want = ref_fold.solve_batch_folded(ref_compile_spec(ref_two()[0]), c, lo, hi,
                                       options=_opts(ref=True, **opts))
    assert bool(np.all(got.converged)) and bool(np.all(want.converged))
    np.testing.assert_array_equal(got.iters, np.asarray(want.iters))
    assert np.all(_rel(got.objective, want.objective) <= 5e-5)
    np.testing.assert_allclose(got.psi, np.asarray(want.psi), atol=5e-4)


def test_solve_batch_folded_fused_follows_classic():
    """``fused=True`` runs the fused chunked driver on the fold kernel's
    plain version: with a fixed budget it follows the classic folded solve."""
    c, lo, hi = _grid()
    compiled = compile_spec(two_asset_instance()[0], pad_pools_to=128)
    opts = _opts(max_iters=60, eps_abs=0.0, eps_rel=0.0, adapt_rho=False)
    fused = solve_batch_folded(compiled, c, lo, hi, options=opts, fused=True, chunk=30,
                               device="cpu")
    classic = solve_batch_folded(compiled, c, lo, hi, options=opts, fused=False,
                                 device="cpu")
    np.testing.assert_array_equal(fused.iters, [60, 60])
    np.testing.assert_allclose(fused.psi, classic.psi, atol=2e-4)
    assert np.all(_rel(fused.objective, classic.objective) <= 5e-5)


def test_solve_batch_reserves_folded_matches_reference():
    """Fixed-length reserve batches (BASELINE config 5): 5e-4 relative to
    the reference's folded batch.  The fused path runs ``n_iters`` fused
    iterations plus one classic, the classic path ``n_iters``: given one
    iteration fewer, the fused batch follows the classic one."""
    spec, obj = two_asset_instance(10.0)
    _, obj_r = ref_two(10.0)
    compiled = compile_spec(spec, pad_pools_to=128)
    scale = np.random.default_rng(4).uniform(0.7, 1.3, size=(3, compiled.n_pools))
    opts = dict(max_iters=40, eps_abs=0.0, eps_rel=0.0, adapt_rho=False)
    want = ref_fold.solve_batch_reserves_folded(
        ref_compile_spec(ref_two()[0], pad_pools_to=128), obj_r, scale,
        options=_opts(ref=True, **opts), n_iters=40, fused=False)
    got = solve_batch_reserves_folded(compiled, obj, scale, options=_opts(**opts),
                                      n_iters=40, fused=False, device="cpu")
    assert np.all(_rel(got.objective, want.objective) <= 5e-4)
    fused = solve_batch_reserves_folded(compiled, obj, scale, options=_opts(**opts),
                                        n_iters=39, fused=True, device="cpu")
    np.testing.assert_array_equal(fused.iters, [40] * 3)
    assert np.all(_rel(fused.objective, got.objective) <= 5e-4)
    np.testing.assert_allclose(fused.psi, got.psi, atol=2e-4)
