"""The grouped base projection's plain version (what the CUDA kernel of
``csrc/projection.cu`` is held against) and the classic iteration that now
projects by K-group, on the CPU.

* ``project_grouped_plain`` on each K-group of a mixed network (K=2: cs2f
  gm2 gm2f, K=4: cs4f gm4; geo-mean, floored geo-mean and constant-sum
  buckets) is bitwise equal to the per-bucket plain ``project_gm`` /
  ``project_cs``, in float32 and float64 and on a T=2 fold with 128 pools
  per point; ``project_grouped`` and the per-bucket wrappers on CPU tensors
  are that plain version and launch nothing.
* The same numpy inputs through the JAX package's ``project_gm_pallas`` /
  ``project_cs_pallas`` (``interpret=True``) and the port's grouped plain
  version agree to atol 5e-5 in float32, the bar of
  ``tests/test_torch_projection.py``.
* The regrouped classic ``AdmmSolver._iterate`` follows the reference's
  step by step in float64 (1e-9, the bar of ``tests/test_torch_slice.py``),
  and ``ChunkedDriver``'s final projection pass gives the reference's
  trades.
* ``_iterate(buckets=...)`` projects with the arrays it is given (reserve
  scenarios), and raises when they lack a bucket of the solver's groups.

The network: 150 pools over 16 assets, unit-scale reserves, every bucket
padded to 128 pools.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfmm_routing_tpu.ops.projection import ProjectionConfig as RefProjectionConfig
from cfmm_routing_tpu.ops.projection_pallas import project_cs_pallas, project_gm_pallas
from cfmm_routing_tpu.solver import admm as ref_admm
from cfmm_routing_tpu.solver import driver as ref_driver
from cfmm_routing_tpu.solver.compiler import compile_table as ref_compile_table
from cfmm_routing_tpu.utils.synth import random_arbitrage_table as ref_table
from cfmm_routing_tpu_torch.ops import _build
from cfmm_routing_tpu_torch.ops.projection import ProjectionConfig, project_cs, project_gm
from cfmm_routing_tpu_torch.ops.projection_cuda import (
    project_cs_cuda, project_gm_cuda, project_grouped, project_grouped_plain,
)
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver, _reserve_buckets
from cfmm_routing_tpu_torch.solver.compiler import compile_table
from cfmm_routing_tpu_torch.solver.driver import ChunkedDriver
from cfmm_routing_tpu_torch.solver.fold import fold_compiled
from cfmm_routing_tpu_torch.utils.synth import random_arbitrage_table

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
CFG = ProjectionConfig()
GROUPS = [["cs2f", "gm2", "gm2f"], ["cs4f", "gm4"]]
TOL = dict(rtol=1e-9, atol=1e-9)


@pytest.fixture(scope="module")
def case():
    r_table, r_obj = ref_table(16, 150, seed=4, reserve_scale=1.0)
    table, obj = random_arbitrage_table(16, 150, seed=4, reserve_scale=1.0)
    compiled = compile_table(table, pad_pools_to=128, backend="numpy")
    assert {n: b.m for n, b in compiled.buckets.items()} == dict.fromkeys(
        ["gm2", "gm2f", "gm4", "cs2f", "cs4f"], 128)
    return dict(ref_compiled=ref_compile_table(r_table, pad_pools_to=128,
                                               backend="numpy"),
                r_obj=r_obj, compiled=compiled, obj=obj)


def _inputs(solver, seed, scale=3.0):
    """Random masked (p, q) planes per bucket, from a numpy seed."""
    rng = np.random.default_rng(seed)
    return {name: tuple(torch.as_tensor(x, dtype=solver.dtype) * a["mask"]
                        for x in rng.uniform(-scale, scale, (2,) + tuple(a["mask"].shape)))
            for name, a in solver.buckets.items()}


def _per_bucket(solver, name, p, q):
    a = solver.buckets[name]
    kind, floor = solver._meta[name]
    if kind == "gm":
        return project_gm(p, q, a["R"], a["w"], a["s"], a["gamma"], a["logk0"], a["k0"],
                          a["mask"], needs_floor=floor, cfg=CFG)
    return project_cs(p, q, a["R"], a["gamma"], a["w"], a["k0"], a["mask"], cfg=CFG)


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("fold", [False, True], ids=["unfolded", "fold2"])
def test_grouped_plain_is_per_bucket_plain_bitwise(case, dtype, fold):
    compiled = case["compiled"]
    if fold:  # T=2 points of 128 pools each, a per-point stride of 16 assets
        solver = AdmmSolver(fold_compiled(compiled, 2), dtype=dtype, device="cpu",
                            fold=(2, compiled.n_assets))
        assert all(a["mask"].shape[1] == 2 * 128 for a in solver.buckets.values())
    else:
        solver = AdmmSolver(compiled, dtype=dtype, device="cpu")
    assert [g["names"] for g in solver._groups] == GROUPS
    assert [g["K"] for g in solver._groups] == [2, 4]
    assert {k for g in solver._groups for k in g["kinds"]} == {
        ("gm", False), ("gm", True), ("cs", True)}
    inputs = _inputs(solver, seed=1)
    _build.reset_launch_counts()
    for g in solver._groups:
        got = project_grouped_plain(inputs, solver.buckets, g, cfg=CFG)
        wrapped = project_grouped(inputs, solver.buckets, g, cfg=CFG)
        assert list(got) == list(wrapped) == g["names"]
        for name in g["names"]:
            want = _per_bucket(solver, name, *inputs[name])
            for x, y, z in zip(got[name], wrapped[name], want):
                assert x.dtype == dtype and x.shape == y.shape == z.shape
                assert torch.equal(x, z) and torch.equal(y, z), name
    # the per-bucket wrappers on CPU tensors: the plain version, no launch
    for name, (kind, floor) in solver._meta.items():
        a = solver.buckets[name]
        p, q = inputs[name]
        got = (project_gm_cuda(p, q, a["R"], a["w"], a["s"], a["gamma"], a["logk0"],
                               a["k0"], a["mask"], needs_floor=floor, cfg=CFG)
               if kind == "gm" else
               project_cs_cuda(p, q, a["R"], a["gamma"], a["w"], a["k0"], a["mask"],
                               cfg=CFG))
        for x, y in zip(got, _per_bucket(solver, name, p, q)):
            assert torch.equal(x, y), name
    assert all(n == 0 for n in _build.LAUNCHES.values())


@pytest.mark.parametrize("cfg", [CFG, ProjectionConfig(24, 4)], ids=["48-6", "24-4"])
def test_grouped_plain_matches_pallas_interpret(case, cfg):
    """The JAX package's Pallas kernels in interpret mode against the grouped
    plain version, float32, on every bucket of both K-groups, at the
    default root-find and at the main path's (24, 4)."""
    solver = AdmmSolver(case["compiled"], dtype=F32, device="cpu")
    inputs = _inputs(solver, seed=2)
    ref_cfg = RefProjectionConfig(n_bisect=cfg.n_bisect, n_polish=cfg.n_polish)
    checked = []
    for g in solver._groups:
        got = project_grouped_plain(inputs, solver.buckets, g, cfg=cfg)
        for name, (kind, floor) in zip(g["names"], g["kinds"]):
            a = {k: jnp.asarray(v.numpy()) for k, v in solver.buckets[name].items()
                 if v.is_floating_point()}
            p, q = (jnp.asarray(x.numpy()) for x in inputs[name])
            if kind == "gm":
                want = project_gm_pallas(p, q, a["R"], a["w"], a["s"], a["gamma"],
                                         a["logk0"], a["k0"], a["mask"],
                                         needs_floor=floor, cfg=ref_cfg, interpret=True)
            else:
                want = project_cs_pallas(p, q, a["R"], a["gamma"], a["w"], a["k0"],
                                         a["mask"], cfg=ref_cfg, interpret=True)
            for x, y in zip(got[name], want):
                np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=5e-5, rtol=0,
                                           err_msg=name)
            checked.append(name)
    assert sorted(checked) == sorted(solver.buckets)


def test_regrouped_iterate_matches_reference_float64(case):
    ref = ref_admm.AdmmSolver(case["ref_compiled"], dtype=jnp.float64)
    port = AdmmSolver(case["compiled"], dtype=F64, device="cpu")
    c, lo, hi = port._objective_arrays(case["obj"])
    rc, rlo, rhi = (jnp.asarray(x.numpy()) for x in (c, lo, hi))
    step = jax.jit(lambda z, nu: ref._iterate(z, nu, 1.0, rc, rlo, rhi))
    z = {n: (jnp.zeros_like(a["mask"]), jnp.zeros_like(a["mask"]))
         for n, a in ref.buckets.items()}
    zp = {n: (torch.zeros_like(a["mask"]), torch.zeros_like(a["mask"]))
          for n, a in port.buckets.items()}
    nu = jnp.zeros(ref.n)
    nup = torch.zeros(port.n, dtype=F64)
    rho = torch.tensor(1.0, dtype=F64)
    for k in range(30):
        z, nu, psi, w, _ = step(z, nu)
        zp, nup, psip, wp, _ = port._iterate(zp, nup, rho, c, lo, hi)
        np.testing.assert_allclose(psip.numpy(), np.asarray(psi), **TOL,
                                   err_msg=f"psi step {k}")
        np.testing.assert_allclose(nup.numpy(), np.asarray(nu), **TOL,
                                   err_msg=f"nu step {k}")
        assert sorted(wp) == sorted(w)
        for name in w:
            for i in range(2):
                np.testing.assert_allclose(wp[name][i].numpy(), np.asarray(w[name][i]),
                                           **TOL, err_msg=f"trades[{name}][{i}] step {k}")


def test_chunked_driver_final_trades_match_reference(case):
    opts = dict(eps_abs=1e-12, eps_rel=1e-12)
    port = AdmmSolver(case["compiled"], dtype=F64, device="cpu",
                      options=AdmmOptions(**opts))
    ref = ref_admm.AdmmSolver(case["ref_compiled"], dtype=jnp.float64,
                              options=ref_admm.AdmmOptions(**opts))
    res, log = ChunkedDriver(port, chunk=10).solve(case["obj"], max_iters=30)
    res_r, log_r = ref_driver.ChunkedDriver(ref, chunk=10).solve(case["r_obj"],
                                                                 max_iters=30)
    assert log.status == log_r.status and int(res.iters) == int(res_r.iters) == 30
    np.testing.assert_allclose(res.psi.numpy(), np.asarray(res_r.psi), **TOL)
    np.testing.assert_allclose(res.prices.numpy(), np.asarray(res_r.prices), **TOL)
    assert sorted(res.deltas) == sorted(res_r.deltas)
    for name in res.deltas:
        np.testing.assert_allclose(res.deltas[name].numpy(),
                                   np.asarray(res_r.deltas[name]), **TOL, err_msg=name)
        np.testing.assert_allclose(res.lambdas[name].numpy(),
                                   np.asarray(res_r.lambdas[name]), **TOL, err_msg=name)


def test_iterate_projects_with_the_buckets_it_is_given(case):
    """Reserve buckets (``_reserve_buckets``: R, k0, logk0 of a scaled
    problem, the names of the solver's own) give the iteration of a solver
    built on the scaled problem, bit for bit."""
    compiled = case["compiled"]
    scale = np.random.default_rng(7).uniform(0.7, 1.3, size=(1, compiled.n_pools))
    scaled = fold_compiled(compiled, 1, scale)
    solver = AdmmSolver(compiled, dtype=F64, device="cpu")
    on_scaled = AdmmSolver(scaled, dtype=F64, device="cpu")
    rb = _reserve_buckets(solver, scaled)
    assert list(rb) == list(solver.buckets)
    c, lo, hi = solver._objective_arrays(case["obj"])
    rho = torch.tensor(1.0, dtype=F64)
    z = _inputs(solver, seed=3, scale=0.5)
    nu = torch.as_tensor(np.random.default_rng(4).normal(0.0, 0.2, solver.n), dtype=F64)
    got = solver._iterate(z, nu, rho, c, lo, hi, buckets=rb)
    want = on_scaled._iterate(z, nu, rho, c, lo, hi)
    own = solver._iterate(z, nu, rho, c, lo, hi)
    for name in solver.buckets:
        for x, y, o in zip(got[3][name], want[3][name], own[3][name]):
            assert torch.equal(x, y), name
            assert not torch.equal(x, o), name
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    with pytest.raises(KeyError, match="gm4"):
        solver._iterate(z, nu, rho, c, lo, hi,
                        buckets={k: v for k, v in rb.items() if k != "gm4"})
