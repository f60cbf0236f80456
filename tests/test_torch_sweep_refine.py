"""Sweep refinement: the port against the JAX package on the CPU, on the
reference's two-asset frontier (``two-asset.py``) at 4 trade sizes.

``refine_sweep(fold=True)`` (the folded correction solve) and
``(fold=False)`` (one correction solve per point, each with its own
stopping test), from the same float32 base near its floor: every point
certifies at 1e-6, and the certified objectives match the reference's
``refine_sweep`` to 1e-6 relative.

The plain root-find costs ~20-30 ms per iteration here, so the correction
solves run 40 iterations per chunk (``iters_per_pass``) instead of 1000.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfmm_routing_tpu.models.reference_instances import two_asset_instance as ref_two
from cfmm_routing_tpu.solver import admm as ref_admm
from cfmm_routing_tpu.solver.compiler import compile_spec as ref_compile_spec
from cfmm_routing_tpu.solver.refine_device import refine_sweep as ref_refine_sweep
from cfmm_routing_tpu_torch.models.reference_instances import two_asset_instance
from cfmm_routing_tpu_torch.solver import refine_device as rd
from cfmm_routing_tpu_torch.solver.compiler import compile_spec

torch.set_num_threads(1)

AMOUNTS = np.array([2.0, 10.0, 25.0, 40.0])
BASE = dict(max_iters=3000, eps_abs=1e-5, eps_rel=1e-5, check_every=25)
IPP = 40


def _grid(hi_value):
    T, n = len(AMOUNTS), 3
    c = np.zeros((T, n))
    c[:, 2] = 1.0
    lo = np.zeros((T, n))
    lo[:, 0] = -AMOUNTS
    return c, lo, np.full((T, n), hi_value)


def _score(ct):
    return max(abs(ct.gap_rel), ct.feasibility_rel)


@pytest.fixture(scope="module")
def base():
    """The reference's float32 batched solve, as host arrays."""
    c, lo, hi32 = _grid(np.finfo(np.float32).max / 4)
    solver = ref_admm.AdmmSolver(ref_compile_spec(ref_two()[0]), dtype=jnp.float32,
                                 options=ref_admm.AdmmOptions(**BASE))
    return jax.tree_util.tree_map(np.asarray, solver.solve_batch(c, lo, hi32))


@pytest.mark.parametrize("fold", [True, False])
def test_refine_sweep_certifies_like_reference(base, fold):
    c, lo, hi = _grid(np.inf)
    want = ref_refine_sweep(ref_compile_spec(ref_two()[0]), c, lo, hi, base,
                            target_gap=1e-6, fold=fold, iters_per_pass=IPP)
    got = rd.refine_sweep(compile_spec(two_asset_instance()[0]), c, lo, hi, base,
                          target_gap=1e-6, fold=fold, iters_per_pass=IPP, device="cpu")
    assert bool(np.all(want.achieved))
    assert bool(np.all(got.achieved)), [f"{_score(ct):.2e}" for ct in got.certificates]
    assert all(_score(ct) <= 1e-6 for ct in got.certificates)
    np.testing.assert_allclose(got.objectives, want.objectives, rtol=1e-6)
    assert got.prices.shape == (len(AMOUNTS), 3)
    for name, d in got.deltas.items():
        assert d.shape == np.asarray(base.deltas[name]).shape
