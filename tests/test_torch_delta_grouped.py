"""The grouped delta kernels' plain versions (what the CUDA kernels are held
against) and the grouped refinement iteration, on the CPU.

* ``fused_step_delta_grouped_plain`` on each K-group of a mixed network
  (K=2: cs2f gm2 gm2f, K=4: cs4f gm4; geo-mean, floored geo-mean and
  constant-sum buckets) against the per-bucket ``fused_step_delta_plain``:
  the planes bitwise (the same arithmetic), y to 1e-12 in float64 (the
  group's segment sum adds the same terms in another order).  The same
  on a T=2 fold with 128 pools per point.
* ``project_delta_grouped_plain`` against the per-bucket plain delta
  projections: bitwise.
* The group slot order lists every real slot of the group's planes
  exactly once, under its asset.
* ``solve_delta(fused=True)`` and the classic ``solve_delta`` now run
  their buckets by K-group; both still match the JAX package's classic
  ``solve_delta`` at the bar of ``tests/test_torch_delta.py``'s
  trajectory test (2e-4).

The network: 150 pools over 16 assets, unit-scale reserves, every bucket
padded to 128 pools; the base point is the reference's float32 solve,
handed to both packages as numpy arrays.
"""
import numpy as np
import pytest
import torch

import jax

from cfmm_routing_tpu.solver import admm as ref_admm
from cfmm_routing_tpu.solver import refine_device as ref_rd
from cfmm_routing_tpu.solver.compiler import compile_table as ref_compile_table
from cfmm_routing_tpu.utils.synth import random_arbitrage_table as ref_table
from cfmm_routing_tpu_torch.ops.iteration_cuda import (
    fused_step_delta_grouped, fused_step_delta_grouped_plain, fused_step_delta_plain,
)
from cfmm_routing_tpu_torch.ops.projection import ProjectionConfig
from cfmm_routing_tpu_torch.ops.projection_cuda import (
    project_delta_grouped, project_delta_grouped_plain,
)
from cfmm_routing_tpu_torch.ops.projection_delta import project_cs_delta, project_gm_delta
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions
from cfmm_routing_tpu_torch.solver.compiler import compile_table
from cfmm_routing_tpu_torch.solver.fold import fold_compiled
from cfmm_routing_tpu_torch.solver.refine_device import (
    DeltaAdmmSolver, _delta_buckets_folded, _delta_objective, _psi_from_trades,
)
from cfmm_routing_tpu_torch.utils.synth import random_arbitrage_table

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
EPS = 1e-3  # correction scale of the delta arrays
CFG = ProjectionConfig()
GROUPS = [["cs2f", "gm2", "gm2f"], ["cs4f", "gm4"]]


@pytest.fixture(scope="module")
def case():
    r_table, r_obj = ref_table(16, 150, seed=4, reserve_scale=1.0)
    ref_compiled = ref_compile_table(r_table, pad_pools_to=128, backend="numpy")
    table, obj = random_arbitrage_table(16, 150, seed=4, reserve_scale=1.0)
    compiled = compile_table(table, pad_pools_to=128, backend="numpy")
    assert {n: b.m for n, b in compiled.buckets.items()} == dict.fromkeys(
        ["gm2", "gm2f", "gm4", "cs2f", "cs4f"], 128)
    ref_solver = ref_admm.AdmmSolver(
        ref_compiled, dtype=jax.numpy.float32,
        options=ref_admm.AdmmOptions(max_iters=200, check_every=25))
    base = jax.tree_util.tree_map(np.asarray, ref_solver.solve(r_obj))
    rho = float(np.clip(base.rho_final, 0.25, 4.0))
    nu0f = (base.prices / rho).astype(np.float32).astype(np.float64)
    return dict(r_obj=r_obj, ref_compiled=ref_compiled, obj=obj, compiled=compiled,
                base=base, rho=rho, nu0f=nu0f)


def _solver(case, dtype, **kw):
    return DeltaAdmmSolver(case["compiled"], dtype=dtype, device="cpu",
                           options=AdmmOptions(max_iters=10, eps_abs=0.0, eps_rel=0.0,
                                               adapt_rho=False, projection=CFG), **kw)


def _state(bdict, dtype, seed):
    """A random masked state per bucket and a price vector of n_pad = 128."""
    rng = np.random.default_rng(seed)
    s = {name: tuple(torch.as_tensor(x, dtype=dtype) * a["mask"]
                     for x in rng.uniform(-0.5, 0.5, (2,) + tuple(a["mask"].shape)))
         for name, a in bdict.items()}
    n_v = -(-int(max(int(a["asset"].max()) for a in bdict.values()) + 1) // 128) * 128
    v = torch.as_tensor(0.3 * rng.normal(size=n_v), dtype=dtype)
    return s, v


def _check_group_step(solver, bdict, s, v, fold=None):
    """Each K-group: the grouped plain step against the per-bucket plain
    steps (planes bitwise, y to 1e-12), and the wrapper on CPU tensors is
    the grouped plain version."""
    for g in solver._groups:
        s_new, w, y = fused_step_delta_grouped_plain(s, v, bdict, g, 1.5, cfg=CFG,
                                                     fold=fold)
        y_sum = torch.zeros_like(v)
        for name, (kind, floor) in zip(g["names"], g["kinds"]):
            want = fused_step_delta_plain(*s[name], v, bdict[name], kind, floor, 1.5,
                                          cfg=CFG, fold=fold)
            for got, exp in zip(s_new[name] + w[name], want[:4]):
                assert torch.equal(got, exp), name
            y_sum = y_sum + want[4]
        np.testing.assert_allclose(y.numpy(), y_sum.numpy(), rtol=1e-12, atol=1e-12)
        again = fused_step_delta_grouped(s, v, bdict, g, 1.5, cfg=CFG, fold=fold)
        assert torch.equal(again[2], y)


def test_grouped_fused_step_matches_per_bucket(case):
    ds = _solver(case, F64)
    assert [g["names"] for g in ds._groups] == GROUPS
    assert [g["K"] for g in ds._groups] == [2, 4]
    bdict, min_x0 = ds.delta_buckets(case["base"], EPS, nu0=case["nu0f"])
    assert min_x0 > 0
    s, v = _state(bdict, F64, seed=1)
    _check_group_step(ds, bdict, s, v)


def test_grouped_projection_matches_per_bucket(case):
    ds = _solver(case, F64)
    bdict, _ = ds.delta_buckets(case["base"], EPS, nu0=case["nu0f"])
    s, _ = _state(bdict, F64, seed=2)
    for g in ds._groups:
        got = project_delta_grouped_plain(s, bdict, g, cfg=CFG)
        assert project_delta_grouped(s, bdict, g, cfg=CFG).keys() == got.keys()
        for name, (kind, floor) in zip(g["names"], g["kinds"]):
            a = bdict[name]
            if kind == "gm":
                want = project_gm_delta(*s[name], a["X0"], a["w"], a["sS"], a["gamma"],
                                        a["nsig"], a["aD"], a["aL"], a["mask"],
                                        needs_floor=floor, cfg=CFG)
            else:
                want = project_cs_delta(*s[name], a["X0"], a["gamma"], a["w"], a["nsig"],
                                        a["aD"], a["aL"], a["mask"], cfg=CFG)
            for x, y in zip(got[name], want):
                assert torch.equal(x, y), name


def test_grouped_fold_step_matches_per_bucket(case):
    """T=2 points of 128 pools each (every bucket), a per-point stride of
    16 prices."""
    compiled, T = case["compiled"], 2
    n = compiled.n_assets
    ds = DeltaAdmmSolver(fold_compiled(compiled, T), dtype=F64, device="cpu",
                         fold=(T, n), options=AdmmOptions(projection=CFG))
    rng = np.random.default_rng(3)
    trades = {k: 0.01 * rng.uniform(0, 1, (T, b.width, b.m)) * b.mask.T[None]
              for k, b in compiled.buckets.items()}
    bdict, min_x0 = _delta_buckets_folded(ds, trades, trades, rng.uniform(1e-3, 1e-2, T),
                                          rng.uniform(0.5, 2.0, (T, n)))
    assert (min_x0 > 0).all()
    assert all(a["mask"].shape[1] == T * 128 for a in bdict.values())
    assert [g["names"] for g in ds._groups] == GROUPS
    s, v = _state(bdict, F64, seed=4)
    _check_group_step(ds, bdict, s, v, fold=ds._fold)


@pytest.mark.parametrize("fold", [False, True], ids=["unfolded", "fold2"])
def test_group_slot_order_covers_every_real_slot_once(case, fold):
    compiled = case["compiled"]
    ds = (DeltaAdmmSolver(fold_compiled(compiled, 2), device="cpu",
                          fold=(2, compiled.n_assets)) if fold
          else DeltaAdmmSolver(compiled, device="cpu"))
    for g in ds._groups:
        asset = np.concatenate([ds.buckets[nm]["asset"].numpy().reshape(-1)
                                for nm in g["names"]])
        mask = np.concatenate([ds.buckets[nm]["mask"].numpy().reshape(-1)
                               for nm in g["names"]])
        order, seg = g["order"].numpy(), g["seg"].numpy()
        assert order.dtype == seg.dtype == np.int32
        np.testing.assert_array_equal(np.sort(order), np.flatnonzero(mask > 0))
        assert seg[0] == 0 and seg[-1] == order.size and seg.size == ds.n + 1
        owner = np.repeat(np.arange(ds.n), np.diff(seg))
        np.testing.assert_array_equal(asset[order], owner)


def test_solve_delta_fused_and_classic_match_reference(case):
    """Ten delta-dual iterations (9 fused + 1 classic harvest, or 10
    classic) on the port against the reference's classic solve_delta."""
    base, rho, nu0f = case["base"], case["rho"], case["nu0f"]
    ref_ds = ref_rd.DeltaAdmmSolver(
        case["ref_compiled"], dtype=jax.numpy.float32,
        options=ref_admm.AdmmOptions(max_iters=10, eps_abs=0.0, eps_rel=0.0,
                                     adapt_rho=False))
    ref_b, _ = ref_ds.delta_buckets(base, EPS, nu0=nu0f)
    psi0 = ref_rd._psi_from_trades(case["ref_compiled"], base)
    want = jax.tree_util.tree_map(np.asarray, ref_ds.solve_delta(
        ref_rd._delta_objective(case["r_obj"], psi0, EPS), ref_b, nu0f, rho, 10))
    ds = _solver(case, F32)
    bdict, _ = ds.delta_buckets(base, EPS, nu0=nu0f)
    dobj = _delta_objective(case["obj"], _psi_from_trades(ds.compiled, base), EPS)
    for fused, iters in ((False, 10), (True, 9)):
        got = ds.solve_delta(dobj, bdict, nu0f, rho, iters, fused=fused)
        assert int(got.iters) == int(want.iters) == 10
        np.testing.assert_allclose(got.psi.numpy(), want.psi, atol=2e-4,
                                   err_msg=f"psi fused={fused}")
        np.testing.assert_allclose(got.prices.numpy(), want.prices, atol=2e-4,
                                   err_msg=f"prices fused={fused}")
        for name in want.deltas:
            np.testing.assert_allclose(got.deltas[name].numpy(), want.deltas[name],
                                       atol=2e-4, err_msg=f"D[{name}] fused={fused}")
            np.testing.assert_allclose(got.lambdas[name].numpy(), want.lambdas[name],
                                       atol=2e-4, err_msg=f"L[{name}] fused={fused}")
