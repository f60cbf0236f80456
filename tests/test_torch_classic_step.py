"""The classic step kernels' plain versions (``ops/iteration_cuda.py``:
``classic_step_plain``, ``consensus_plain``, ``classic_z_plain``, what the
kernels of ``csrc/classic_step.cu`` are held against on the card) and the
rule that picks the kernel path in ``AdmmSolver._solve_impl``, on the CPU.

* ``AdmmSolver._classic_block`` on CPU tensors, a chain of 25 plain steps
  with the z update deferred between them, is bitwise equal to 25 calls of
  ``AdmmSolver._iterate(with_stats=False)`` with the card's grouped
  reduction, in float32 and float64, at alpha 1 and 1.6, with a box that
  clips and an asset of degree 0.
* The kernel path is taken only by an ``AdmmSolver``'s own iteration on
  the card with a linear objective: a ``DeltaAdmmSolver``, a subclass
  that overrides ``_iterate``, a ``PackedUtility`` or ``CustomUtility``
  objective, a fold, a ``segment_sum_fn``, a ``consensus_prox`` and a
  process group keep the torch ops; on the CPU no solve counts
  ``iters.step``.

The network: 300 pools over 16 assets in five buckets, K = 2 (cs2f gm2
gm2f) and K = 4 (cs4f gm4): geo-mean, floored geo-mean and constant sum.
"""
import numpy as np
import pytest
import torch

from cfmm_routing_tpu_torch.models.utility import ConcaveUtility, Objective
from cfmm_routing_tpu_torch.ops import _build
from cfmm_routing_tpu_torch.ops.iteration_cuda import (
    classic_step, classic_step_plain, classic_z, consensus, consensus_plain,
)
from cfmm_routing_tpu_torch.ops.projection import ProjectionConfig
from cfmm_routing_tpu_torch.ops.segment import segment_sum
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver
from cfmm_routing_tpu_torch.solver.compiler import compile_table
from cfmm_routing_tpu_torch.solver.fold import fold_compiled
from cfmm_routing_tpu_torch.solver.refine_device import DeltaAdmmSolver
from cfmm_routing_tpu_torch.utils import profiling
from cfmm_routing_tpu_torch.utils.synth import random_arbitrage_table

torch.set_num_threads(1)

CFG = ProjectionConfig(24, 4)
ITERS = 25


@pytest.fixture(scope="module")
def network():
    table, obj = random_arbitrage_table(16, 300, seed=4, reserve_scale=1.0)
    return compile_table(table), obj


def _start(solver, obj, seed):
    """A random masked state, a random nu, a box that clips about half the
    assets, and rho."""
    rng = np.random.default_rng(seed)
    z = {name: tuple(solver._t(rng.uniform(-2.0, 2.0, tuple(a["mask"].shape)))
                     * a["mask"] for _ in range(2))
         for name, a in solver.buckets.items()}
    nu = solver._t(rng.normal(size=solver.n))
    lo = np.where(rng.random(solver.n) < 0.5, -0.05, -1e3)
    hi = np.where(rng.random(solver.n) < 0.5, 0.05, 1e3)
    c, lo, hi = solver._objective_arrays(Objective(obj.c, lo=lo, hi=hi))
    return z, nu, (solver._t(0.7), c, lo, hi, None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("alpha", [1.0, 1.6])
def test_plain_chain_matches_iterate_bitwise(network, monkeypatch, dtype, alpha):
    compiled, obj = network
    degree = compiled.degree.astype(np.float64).copy()
    degree[3] = 0.0  # an asset the prox pins to 0
    solver = AdmmSolver(compiled, dtype=dtype, device="cpu", degree_override=degree,
                        options=AdmmOptions(alpha=alpha, projection=CFG))
    assert [g["names"] for g in solver._groups] == [["cs2f", "gm2", "gm2f"],
                                                    ["cs4f", "gm4"]]
    # the card's reduction: one segment sum per K-group, summed in group order
    monkeypatch.setattr(solver, "_reduce_edges",
                        lambda planes, buckets: solver._reduce_groups(planes))
    z, nu, k = _start(solver, obj, seed=3)
    want_z, want_nu = z, nu
    for _ in range(ITERS):
        want_z, want_nu, _, _, _ = solver._iterate(want_z, want_nu, *k[:4],
                                                   with_stats=False)
    _build.reset_launch_counts()
    got_z, got_nu = solver._classic_block((z, nu), k, ITERS, solver.buckets)
    assert all(n == 0 for n in _build.LAUNCHES.values())
    assert list(got_z) == list(z)
    assert torch.equal(got_nu, want_nu)
    assert float(torch.abs(got_nu - nu).max()) > 0.0 and float(got_nu[3]) == 0.0
    for name in z:
        for i in range(2):
            assert torch.equal(got_z[name][i], want_z[name][i]), name


def test_wrappers_run_plain_versions_on_cpu(network):
    """On CPU tensors the three wrappers are their plain versions and launch
    nothing; a deferred step on (h, dm) equals a first step on the z that
    ``classic_z`` makes of them."""
    compiled, obj = network
    solver = AdmmSolver(compiled, device="cpu", options=AdmmOptions(projection=CFG))
    z, nu, (rho, c, lo, hi, _) = _start(solver, obj, seed=5)
    g = solver._groups[1]
    sizes = [solver.buckets[nm]["mask"].numel() for nm in g["names"]]
    _build.reset_launch_counts()
    h, vals = classic_step(z, nu, None, solver.buckets, g, 1.0, 0.0, CFG)
    _, vals0 = classic_step_plain(z, nu, None, solver.buckets, g, 1.0, 0.0, CFG)
    assert torch.equal(vals, vals0) and vals.numel() == sum(sizes)
    ys = [segment_sum(vals, g["order"], g["seg"], solver.n)]
    mu, dm = consensus(ys, solver.degree, nu, c, lo, hi, rho)
    mu0, dm0 = consensus_plain(ys, solver.degree, nu, c, lo, hi, rho)
    assert torch.equal(mu, mu0) and torch.equal(dm, dm0)
    h2, vals2 = classic_step(h, mu, dm, solver.buckets, g, 1.0, 0.0, CFG)
    z2 = classic_z(h, dm, solver.buckets, g)
    h2b, vals2b = classic_step(z2, mu, None, solver.buckets, g, 1.0, 0.0, CFG)
    assert torch.equal(vals2, vals2b)
    for nm in g["names"]:
        assert torch.equal(h2[nm][0], h2b[nm][0]) and torch.equal(h2[nm][1], h2b[nm][1])
    assert all(n == 0 for n in _build.LAUNCHES.values())


class GlueSolver(AdmmSolver):
    """A solver whose ``_iterate`` is its own: ``_solve_impl`` runs the torch
    ops of the classic iteration for it, not the step kernels (also the
    card tests' reference path)."""

    def _iterate(self, *args, **kwargs):
        return super()._iterate(*args, **kwargs)


def _as_card(solver):
    """``solver`` with its groups built and its device read as the card's,
    for :meth:`AdmmSolver._step_kernels` alone (nothing is launched)."""
    _ = solver._groups
    solver.device = torch.device("cuda")
    return solver


def test_step_kernels_rule(network):
    compiled, obj = network
    opts = AdmmOptions(check_every=25, projection=CFG)
    plain = _as_card(AdmmSolver(compiled, options=opts, device="cpu"))
    assert plain._step_kernels(None)
    assert _as_card(AdmmSolver(compiled, dtype=torch.float64, options=opts,
                               device="cpu"))._step_kernels(None)
    util = ConcaveUtility.linear(obj.c, lo=obj.lo, hi=obj.hi).with_log(1, c=1.0, b=2.0)
    assert not plain._step_kernels(util.pack(torch.float32, "cpu"))
    assert not plain._step_kernels(object())  # a CustomUtility's instance
    keep = {
        "delta": DeltaAdmmSolver(compiled, options=opts, device="cpu"),
        "own _iterate": GlueSolver(compiled, options=opts, device="cpu"),
        "fold": AdmmSolver(fold_compiled(compiled, 2), options=opts, device="cpu",
                           fold=(2, compiled.n_assets)),
        "segment_sum_fn": AdmmSolver(
            compiled, options=opts, device="cpu",
            segment_sum_fn=lambda v, i: torch.zeros(16).index_add_(0, i, v)),
        "consensus_prox": AdmmSolver(compiled, options=opts, device="cpu",
                                     consensus_prox=lambda *a: None),
        "float16": AdmmSolver(compiled, dtype=torch.float16, options=opts,
                              device="cpu"),
    }
    for name, solver in keep.items():
        assert not _as_card(solver)._step_kernels(None), name
    grouped = _as_card(AdmmSolver(compiled, options=opts, device="cpu"))
    grouped.axis_name = "pools"
    assert not grouped._step_kernels(None)
    assert not AdmmSolver(compiled, options=opts, device="cpu")._step_kernels(None)


def test_cpu_solves_count_no_kernel_steps(network):
    """On the CPU every solve runs the torch ops: ``iters.step`` stays 0
    while ``iters.base`` counts the solve's iterations."""
    compiled, obj = network
    solver = AdmmSolver(compiled, device="cpu", options=AdmmOptions(
        max_iters=100, eps_abs=0.0, eps_rel=0.0, check_every=25, projection=CFG))
    profiling.reset()
    res = solver.solve(obj)
    assert int(res.iters) == 100
    assert profiling.COUNTS.get("iters.base") == 100
    assert profiling.COUNTS.get("iters.step", 0) == 0
