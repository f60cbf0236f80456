"""The port's refinement kernels' plain versions vs the JAX package.

* The plain delta projections match the reference ``project_gm_delta`` /
  ``project_cs_delta`` with K in {2, 3}, m = 16, the floor on and off:
  atol 1e-10 (float64) and 5e-5 (float32).
* ``fused_step_delta_plain`` (what the CUDA kernel is held against)
  matches the reference Pallas ``fused_step_delta`` in interpret mode on
  every output, on the delta arrays of a real base solve: atol 2e-5, with
  rtol 1e-5 also on y (a sum of many slots per asset, in another order).
* ``DeltaAdmmSolver.delta_buckets`` gives the reference's arrays, equal to
  float32 rounding.
* On the port, ``solve_delta(fused=True, k=9)`` equals the classic
  ``solve_delta`` stopped at 10 iterations (the reference's own bars), and
  the classic delta iteration follows the reference's for 10 steps (2e-4).
* The plain consensus segment sum equals ``index_add_`` (1e-6) and is
  bitwise repeatable.

The network has unit-scale reserves (``reserve_scale=1.0``), its buckets
padded to 256 pools as in ``tests/test_torch_fused.py``; the base point is
the reference's float32 solve, handed to both packages as numpy arrays.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfmm_routing_tpu.ops import projection_delta as ref_delta
from cfmm_routing_tpu.ops.iteration_pallas import fused_step_delta as ref_fused_delta
from cfmm_routing_tpu.ops.projection import ProjectionConfig as RefConfig
from cfmm_routing_tpu.solver import admm as ref_admm
from cfmm_routing_tpu.solver import refine_device as ref_rd
from cfmm_routing_tpu.solver.compiler import compile_table as ref_compile_table
from cfmm_routing_tpu.utils.synth import random_arbitrage_table as ref_table
from cfmm_routing_tpu_torch.ops import projection_delta as port_delta
from cfmm_routing_tpu_torch.ops.iteration_cuda import fused_step_delta_plain
from cfmm_routing_tpu_torch.ops.projection import ProjectionConfig
from cfmm_routing_tpu_torch.ops.projection_cuda import (
    project_cs_delta_cuda, project_gm_delta_cuda,
)
from cfmm_routing_tpu_torch.ops.segment import segment_sum_plain, slot_order
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions
from cfmm_routing_tpu_torch.solver.compiler import compile_table
from cfmm_routing_tpu_torch.solver.refine_device import (
    DeltaAdmmSolver, _delta_objective, _psi_from_trades,
)
from cfmm_routing_tpu_torch.utils.synth import random_arbitrage_table

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
EPS = 1e-3  # correction scale of the delta arrays
_DELTA_KEYS = ("X0", "aD", "aL", "sS", "nsig", "nu0e")


# ---- delta projections ------------------------------------------------------

def _projection_case(kind, K, floor, seed):
    """A random bucket of m = 16 pools (the last slot of four pools is
    padding) and a base point inside it, re-parametrized as refinement does
    with eps = 1: X0 the base's post-trade reserves, aD/aL minus its trades,
    nsig the constraint slack."""
    rng = np.random.default_rng(seed)
    m = 16
    mask = np.ones((K, m))
    mask[-1, :4] = 0.0
    R = rng.uniform(0.5, 3.0, (K, m)) * mask
    w = rng.uniform(0.5, 2.0, (K, m)) * mask
    gamma = rng.uniform(0.95, 1.0, m)
    D0 = rng.uniform(0.0, 0.3, (K, m)) * mask
    L0 = rng.uniform(0.0, 0.3, (K, m)) * mask
    p = rng.uniform(-1.0, 1.0, (K, m)) * mask
    q = rng.uniform(-1.0, 1.0, (K, m)) * mask
    if kind == "gm":
        w = w / w.sum(axis=0)
        s = rng.uniform(0.1, 0.5, (K, m)) * mask if floor else np.zeros((K, m))
        x0 = np.where(mask > 0, R + s + gamma * D0 - L0, 1.0)
        logk0 = np.sum(w * np.log(np.where(mask > 0, R + s, 1.0)), axis=0)
        nsig = logk0 - np.sum(w * np.log(x0), axis=0)
        return (p, q, x0, w, s, gamma, nsig, -D0, -L0, mask)
    x0 = np.where(mask > 0, R + gamma * D0 - L0, 1.0)
    tgt = np.sum(w * R, axis=0) - np.sum(w * x0 * mask, axis=0)
    return (p, q, x0, gamma, w, tgt, -D0, -L0, mask)


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("floor", [False, True], ids=["nofloor", "floor"])
@pytest.mark.parametrize("K", [2, 3])
@pytest.mark.parametrize("kind", ["gm", "cs"])
def test_delta_projection_matches_reference(kind, K, floor, dtype):
    args = _projection_case(kind, K, floor, seed=10 * K + floor)
    jdt = jnp.float32 if dtype == F32 else jnp.float64
    if kind == "gm":
        port_fn, ref_fn = port_delta.project_gm_delta, ref_delta.project_gm_delta
    else:
        port_fn, ref_fn = port_delta.project_cs_delta, ref_delta.project_cs_delta
    targs = [torch.as_tensor(a, dtype=dtype) for a in args]
    got = port_fn(*targs, needs_floor=floor, cfg=ProjectionConfig())
    if kind == "gm" or floor:  # the kernel wrapper: the plain version here
        wrapper = project_gm_delta_cuda if kind == "gm" else project_cs_delta_cuda
        kw = dict(needs_floor=floor) if kind == "gm" else {}
        for a, b in zip(wrapper(*targs, cfg=ProjectionConfig(), **kw), got):
            assert torch.equal(a, b)
    want = ref_fn(*(jnp.asarray(a, jdt) for a in args), needs_floor=floor,
                  cfg=RefConfig())
    atol = 5e-5 if dtype == F32 else 1e-10
    for g, w_, label in zip(got, want, ("a", "b")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=atol, rtol=0,
                                   err_msg=label)


# ---- the fused delta step, delta arrays, delta solves ----------------------

def _base_case():
    """The reference's float32 base solve of a 300-pool, 16-asset network
    (buckets gm2, gm2f, gm4, cs2f, cs4f of 256 pools), the two packages'
    delta solvers and their delta arrays at eps = 1e-3."""
    r_table, r_obj = ref_table(16, 300, seed=4, reserve_scale=1.0)
    ref_compiled = ref_compile_table(r_table, pad_pools_to=256, backend="numpy")
    table, obj = random_arbitrage_table(16, 300, seed=4, reserve_scale=1.0)
    ref_solver = ref_admm.AdmmSolver(
        ref_compiled, dtype=jnp.float32,
        options=ref_admm.AdmmOptions(max_iters=200, check_every=25))
    base = jax.tree_util.tree_map(np.asarray, ref_solver.solve(r_obj))
    rho = float(np.clip(base.rho_final, 0.25, 4.0))
    nu0f = (base.prices / rho).astype(np.float32).astype(np.float64)
    ref_ds = ref_rd.DeltaAdmmSolver(
        ref_compiled, dtype=jnp.float32,
        options=ref_admm.AdmmOptions(max_iters=10, eps_abs=0.0, eps_rel=0.0,
                                     adapt_rho=False))
    ref_b, _ = ref_ds.delta_buckets(base, EPS, nu0=nu0f)
    port_ds = DeltaAdmmSolver(
        compile_table(table, pad_pools_to=256), dtype=F32, device="cpu",
        options=AdmmOptions(max_iters=10, eps_abs=0.0, eps_rel=0.0,
                            adapt_rho=False))
    port_b, min_x0 = port_ds.delta_buckets(base, EPS, nu0=nu0f)
    assert min_x0 > 0
    return dict(obj=obj, base=base, rho=rho, nu0f=nu0f, ref_ds=ref_ds,
                ref_b=ref_b, port_ds=port_ds, port_b=port_b)


@pytest.fixture(scope="module")
def case():
    return _base_case()


def test_delta_buckets_match_reference(case):
    assert set(case["port_b"]) == {"gm2", "gm2f", "gm4", "cs2f", "cs4f"}
    for name, arrs in case["port_b"].items():
        for key in _DELTA_KEYS + ("w", "mask", "gamma"):
            got = arrs[key].numpy()
            want = np.asarray(case["ref_b"][name][key])
            assert got.dtype == want.dtype == np.float32, (name, key)
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {key}")
        np.testing.assert_array_equal(arrs["asset"].numpy(),
                                      np.asarray(case["ref_b"][name]["asset"]))


_ref_step = jax.jit(
    ref_fused_delta,
    static_argnames=("kind", "needs_floor", "alpha", "cfg", "interpret", "fold"),
)


@pytest.mark.parametrize("name", ["gm2", "gm2f", "gm4", "cs2f", "cs4f"])
def test_fused_step_delta_matches_reference(case, name):
    kind, floor = case["port_ds"]._meta[name]
    arrs = case["port_b"][name]
    K, m = arrs["mask"].shape
    assert m == 256
    rng = np.random.default_rng(20)
    mask = arrs["mask"].numpy()
    sD, sL = (rng.uniform(-0.5, 0.5, (K, m)) * mask for _ in range(2))
    v = np.zeros(128)
    v[:16] = 0.3 * rng.normal(size=16)
    want = _ref_step(
        jnp.asarray(sD, jnp.float32), jnp.asarray(sL, jnp.float32),
        jnp.asarray(v, jnp.float32), case["ref_b"][name], kind=kind,
        needs_floor=floor, alpha=1.5, cfg=RefConfig(), interpret=True,
    )
    got = fused_step_delta_plain(
        torch.as_tensor(sD, dtype=F32), torch.as_tensor(sL, dtype=F32),
        torch.as_tensor(v, dtype=F32), arrs, kind, floor, 1.5,
        cfg=ProjectionConfig(),
    )
    for g, w_, label in zip(got, want, ("sD'", "sL'", "a", "b", "y")):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w_), atol=2e-5,
            rtol=1e-5 if label == "y" else 0, err_msg=f"{name} {label}",
        )


def _delta_problem(case):
    base, rho, nu0f = case["base"], case["rho"], case["nu0f"]
    psi0 = _psi_from_trades(case["port_ds"].compiled, base)
    return _delta_objective(case["obj"], psi0, EPS), rho, nu0f


def test_solve_delta_fused_matches_classic(case):
    """solve_delta(fused=True, k=9) == classic solve_delta stopped at k+1
    (k fused steps plus the classic residual harvest), at the reference's
    bars (tests/test_refine_device.py)."""
    ds, bdict = case["port_ds"], case["port_b"]
    dobj, rho, nu0f = _delta_problem(case)
    rc = ds.solve_delta(dobj, bdict, nu0f, rho, 10)
    rf = ds.solve_delta(dobj, bdict, nu0f, rho, 9, fused=True)
    assert int(rf.iters) == int(rc.iters) == 10
    np.testing.assert_allclose(rf.psi.numpy(), rc.psi.numpy(), atol=5e-5)
    np.testing.assert_allclose(rf.prices.numpy(), rc.prices.numpy(), atol=5e-6)
    for name in rc.deltas:
        np.testing.assert_allclose(rf.deltas[name].numpy(), rc.deltas[name].numpy(),
                                   atol=2e-5, err_msg=f"D[{name}]")
        np.testing.assert_allclose(rf.lambdas[name].numpy(),
                                   rc.lambdas[name].numpy(),
                                   atol=2e-5, err_msg=f"L[{name}]")
    assert abs(float(rf.r_norm) - float(rc.r_norm)) < 1e-4
    assert abs(float(rf.s_norm) - float(rc.s_norm)) < 1e-4


def test_classic_delta_trajectory_matches_reference(case):
    """Ten delta-dual iterations from zero, both packages: psi, the delta
    dual and the trades agree to 2e-4 at every step."""
    dobj, rho, nu0f = _delta_problem(case)
    ref_ds, ds = case["ref_ds"], case["port_ds"]
    e0 = np.asarray(dobj.c, np.float64) / rho - nu0f
    lo = np.maximum(dobj.lo, -3e38)
    hi = np.minimum(dobj.hi, 3e38)
    rargs = [jnp.asarray(x, jnp.float32) for x in (rho, e0, lo, hi)]
    ref_b = case["ref_b"]
    step = jax.jit(lambda z, nu: ref_ds._iterate(z, nu, *rargs, buckets=ref_b))
    pargs = [torch.as_tensor(x, dtype=F32) for x in (rho, e0, lo, hi)]
    z = {n: (jnp.zeros_like(a["mask"]), jnp.zeros_like(a["mask"]))
         for n, a in ref_b.items()}
    zp = {n: (torch.zeros_like(a["mask"]), torch.zeros_like(a["mask"]))
          for n, a in case["port_b"].items()}
    nu = jnp.zeros(ref_ds.n, jnp.float32)
    nup = torch.zeros(ds.n, dtype=F32)
    for k in range(10):
        z, nu, psi, w, _ = step(z, nu)
        zp, nup, psip, wp, _ = ds._iterate(zp, nup, *pargs, buckets=case["port_b"])
        np.testing.assert_allclose(psip.numpy(), np.asarray(psi), atol=2e-4,
                                   err_msg=f"psi step {k}")
        np.testing.assert_allclose(nup.numpy(), np.asarray(nu), atol=2e-4,
                                   err_msg=f"dnu step {k}")
        for name in w:
            for i in range(2):
                np.testing.assert_allclose(
                    wp[name][i].numpy(), np.asarray(w[name][i]), atol=2e-4,
                    err_msg=f"trades[{name}][{i}] step {k}")


# ---- the consensus segment sum ---------------------------------------------

def test_segment_sum_plain_matches_index_add_and_repeats():
    rng = np.random.default_rng(3)
    K, m, n = 4, 700, 37
    asset = rng.integers(0, n, (K, m)).astype(np.int32)
    asset[:, :50] = 5  # one asset with several hundred slots
    mask = (rng.uniform(size=(K, m)) > 0.2).astype(np.float64)
    asset = np.where(mask > 0, asset, 0).astype(np.int32)
    order, seg = (torch.as_tensor(a) for a in slot_order(asset, mask, n))
    vals = torch.as_tensor(rng.normal(size=(K, m)) * mask, dtype=F64)
    y = segment_sum_plain(vals, order, seg, 128)
    want = torch.zeros(128, dtype=F64).index_add_(
        0, torch.as_tensor(asset.reshape(-1)).long(), vals.reshape(-1))
    np.testing.assert_allclose(y.numpy(), want.numpy(), atol=1e-6, rtol=0)
    assert torch.equal(y, segment_sum_plain(vals, order, seg, 128))
    assert int(seg[-1]) == int(mask.sum())
