"""Batched and folded scenario solves: the port against the JAX package on
the CPU, on the reference's two-asset instance (``two-asset.py``).

* ``AdmmSolver.solve_batch`` in float64 on 4 trade sizes that converge at
  different iteration counts: every point's objective, psi, prices and
  trades match the reference's vmapped ``solve_batch`` to 1e-9 with equal
  iteration counts, and equal the port's own single ``solve`` of that
  point.
* ``certify_batch`` on that batch: every field matches the reference's to
  1e-9.

Reserve batches and the folded batches are held against the reference's in
``tests/test_torch_batch.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfmm_routing_tpu.models.reference_instances import two_asset_instance as ref_two
from cfmm_routing_tpu.solver import admm as ref_admm
from cfmm_routing_tpu.solver import certify as ref_certify
from cfmm_routing_tpu.solver.compiler import compile_spec as ref_compile_spec
from cfmm_routing_tpu_torch.models.reference_instances import two_asset_instance
from cfmm_routing_tpu_torch.models.utility import Objective
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver
from cfmm_routing_tpu_torch.solver.certify import certify_batch
from cfmm_routing_tpu_torch.solver.compiler import compile_spec

torch.set_num_threads(1)

AMOUNTS = np.array([2.0, 10.0, 25.0, 40.0])
OPTS64 = dict(max_iters=3000, eps_abs=1e-6, eps_rel=1e-6)
_CERT_FIELDS = ("objective", "dual_bound", "gap_abs", "gap_rel", "phi_violation",
                "nonneg_violation", "floor_violation", "box_violation",
                "psi_consistency", "psi_scale", "feasibility_rel")


def _grid(amounts=AMOUNTS, n=3):
    """u(t) = max psi[2] s.t. psi >= -t e_0, one row per amount."""
    T = len(amounts)
    c = np.zeros((T, n))
    c[:, 2] = 1.0
    lo = np.zeros((T, n))
    lo[:, 0] = -np.asarray(amounts)
    hi = np.full((T, n), np.finfo(np.float32).max / 4)
    return c, lo, hi


def _host(res):
    return jax.tree_util.tree_map(np.asarray, res)


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


@pytest.fixture(scope="module")
def batch64():
    spec, _ = two_asset_instance()
    port = AdmmSolver(compile_spec(spec), dtype=torch.float64, device="cpu",
                      options=AdmmOptions(**OPTS64))
    ref = ref_admm.AdmmSolver(ref_compile_spec(ref_two()[0]), dtype=jnp.float64,
                              options=ref_admm.AdmmOptions(**OPTS64))
    c, lo, hi = _grid()
    return dict(port=port, ref=ref, c=c, lo=lo, hi=hi,
                got=port.solve_batch(c, lo, hi),
                want=_host(ref.solve_batch(c, lo, hi)))


def test_solve_batch_matches_reference_float64(batch64):
    got, want = batch64["got"], batch64["want"]
    assert len(set(want.iters.tolist())) == len(AMOUNTS)  # all stop apart
    assert bool(np.all(want.converged)) and bool(got.converged.all())
    _assert_points_close(got, want, 1e-9)
    np.testing.assert_allclose(got.rho_final.numpy(), want.rho_final, rtol=1e-12)


@pytest.mark.parametrize("which", ["first", "last"])
def test_solve_batch_point_equals_single_solve(batch64, which):
    """A point that converged early stays frozen while the others run."""
    got = batch64["got"]
    t = int(np.argmin(got.iters) if which == "first" else np.argmax(got.iters))
    c, lo, hi = batch64["c"], batch64["lo"], batch64["hi"]
    single = batch64["port"].solve(Objective(c[t], lo=lo[t], hi=hi[t]))
    assert int(single.iters) == int(got.iters[t])
    for field in ("objective", "psi", "prices", "r_norm", "s_norm", "rho_final"):
        np.testing.assert_allclose(getattr(single, field).numpy(),
                                   getattr(got, field)[t].numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=field)
    for name in single.deltas:
        np.testing.assert_allclose(single.deltas[name].numpy(),
                                   got.deltas[name][t].numpy(), atol=1e-12)


def test_certify_batch_matches_reference(batch64):
    got, c, lo = batch64["got"], batch64["c"], batch64["lo"]
    hi = np.full_like(c, np.inf)
    deltas = {k: v.numpy() for k, v in got.deltas.items()}
    lambdas = {k: v.numpy() for k, v in got.lambdas.items()}
    prices, psi = got.prices.numpy(), got.psi.numpy()
    port = certify_batch(batch64["port"].compiled, c, lo, hi, deltas, lambdas, prices,
                         psi_claimed=psi, device="cpu")
    ref = ref_certify.certify_batch(batch64["ref"].compiled, c, lo, hi, deltas, lambdas,
                                    prices, psi_claimed=psi)
    assert len(port) == len(ref) == len(AMOUNTS)
    for p, r in zip(port, ref):
        for field in _CERT_FIELDS:
            np.testing.assert_allclose(getattr(p, field), getattr(r, field), rtol=1e-9,
                                       atol=1e-9, err_msg=field)
        np.testing.assert_allclose(p.prices, r.prices, rtol=1e-9, atol=1e-9)
        assert np.isfinite([p.gap_rel, p.feasibility_rel]).all()
