"""Port fused iteration vs the JAX package: per call and along a trajectory.

* The port's plain ``fused_step`` (what the CUDA kernel is held against)
  matches the reference Pallas ``fused_step`` in interpret mode on every
  output, on one bucket each of gm (K = 2, 4), gm with reserve floor and
  cs (K = 2, 4), from a nonzero state: atol 2e-5 (y: also rtol 1e-5, a sum
  of many slots per asset taken in another order).
* The port's ``_iterate_fused`` trajectory equals the reference classic
  ``_iterate`` for 12 steps (atol 2e-4, as ``tests/test_fused.py``).
* ``solve_fused(k)`` equals the port's classic solve stopped at k+1.

The networks use unit-scale reserves (``reserve_scale=1.0``, trades of
order 1), so the absolute bars sit hundreds of float32 ulps above the
values.  At the generator's default scale of 100 the trades reach ~200,
where 2e-4 is about 13 ulps and the summation order of the consensus
reduction alone (``index_add_`` here, a one-hot matrix product in the
reference) moves psi by that much.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfmm_routing_tpu.ops.iteration_pallas import fused_step as ref_fused_step
from cfmm_routing_tpu.ops.projection import ProjectionConfig as RefConfig
from cfmm_routing_tpu.solver import admm as ref_admm
from cfmm_routing_tpu.solver.compiler import compile_table as ref_compile_table
from cfmm_routing_tpu.utils.synth import random_arbitrage_table as ref_table
from cfmm_routing_tpu_torch.models.utility import Objective
from cfmm_routing_tpu_torch.ops.iteration_cuda import fused_step_plain
from cfmm_routing_tpu_torch.ops.projection import ProjectionConfig
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver
from cfmm_routing_tpu_torch.solver.compiler import compile_table
from cfmm_routing_tpu_torch.solver.fold import fold_compiled
from cfmm_routing_tpu_torch.utils.synth import random_arbitrage_table

torch.set_num_threads(1)

N_STEPS = 12
_ref_step = jax.jit(
    ref_fused_step,
    static_argnames=("kind", "needs_floor", "alpha", "cfg", "interpret", "fold"),
)


def _per_call_case():
    """300 pools, 16 assets, buckets padded to 256 pools: gm2, gm2f, gm4,
    cs2f, cs4f.  Nonzero masked state planes and a random price vector."""
    table, _ = random_arbitrage_table(16, 300, seed=4, reserve_scale=1.0)
    compiled = compile_table(table, pad_pools_to=256)
    rng = np.random.default_rng(12)
    state = {}
    for name, b in compiled.buckets.items():
        mask = b.mask.T
        state[name] = (rng.uniform(-0.5, 0.5, mask.shape) * mask,
                       rng.uniform(-0.5, 0.5, mask.shape) * mask)
    v = np.zeros(128)
    v[:16] = 0.3 * rng.normal(size=16)
    return compiled, state, v


_CASE = _per_call_case()


@pytest.mark.parametrize("name", ["gm2", "gm2f", "gm4", "cs2f", "cs4f"])
def test_fused_step_matches_reference_per_call(name):
    compiled, state, v = _CASE
    b = compiled.buckets[name]
    assert b.m == 256
    ref_compiled = ref_compile_table(
        ref_table(16, 300, seed=4, reserve_scale=1.0)[0], pad_pools_to=256,
        backend="numpy",
    )
    ref_arrs = ref_admm._bucket_device_arrays(ref_compiled, jnp.float32)[name]
    port = AdmmSolver(compiled, dtype=torch.float32, device="cpu")
    sD, sL = state[name]
    want = _ref_step(
        jnp.asarray(sD, jnp.float32), jnp.asarray(sL, jnp.float32),
        jnp.asarray(v, jnp.float32), ref_arrs, kind=b.kind,
        needs_floor=b.needs_floor, alpha=1.5, cfg=RefConfig(), interpret=True,
    )
    got = fused_step_plain(
        torch.as_tensor(sD, dtype=torch.float32),
        torch.as_tensor(sL, dtype=torch.float32),
        torch.as_tensor(v, dtype=torch.float32), port.buckets[name],
        b.kind, b.needs_floor, 1.5, cfg=ProjectionConfig(),
    )
    for g, w, label in zip(got, want, ("sD'", "sL'", "D", "L", "y")):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w), atol=2e-5,
            rtol=1e-5 if label == "y" else 0, err_msg=f"{name} {label}",
        )


@pytest.mark.parametrize("alpha", [1.0, 1.7])
def test_fused_trajectory_matches_reference_classic(alpha):
    r_table, _ = ref_table(64, 320, seed=0, reserve_scale=1.0)
    ref = ref_admm.AdmmSolver(
        ref_compile_table(r_table, pad_pools_to=128),
        dtype=jnp.float32,
        options=ref_admm.AdmmOptions(max_iters=50, alpha=alpha, consensus="onehot"),
    )
    table, obj = random_arbitrage_table(64, 320, seed=0, reserve_scale=1.0)
    port = AdmmSolver(compile_table(table, pad_pools_to=128), dtype=torch.float32,
                      options=AdmmOptions(max_iters=50, alpha=alpha), device="cpu")
    c = np.asarray(obj.c, np.float32)
    lo = np.asarray(np.maximum(obj.lo, -3e38), np.float32)
    hi = np.asarray(np.minimum(obj.hi, 3e38), np.float32)
    step = jax.jit(lambda z, nu: ref._iterate(z, nu, jnp.float32(1.0), c, lo, hi))

    z = {n: (jnp.zeros_like(a["mask"]), jnp.zeros_like(a["mask"]))
         for n, a in ref.buckets.items()}
    nu = jnp.zeros((ref.n,), jnp.float32)
    s, wdef, nuf = port.fused_init()
    ct, lt, ht = (torch.as_tensor(x) for x in (c, lo, hi))
    rho = torch.tensor(1.0)
    for k in range(N_STEPS):
        z, nu, psi, w, _ = step(z, nu)
        s, wdef, nuf, psi_f, w_f = port._iterate_fused(s, wdef, nuf, rho, ct, lt, ht)
        np.testing.assert_allclose(psi_f.numpy(), np.asarray(psi), atol=2e-4,
                                   err_msg=f"psi step {k}")
        np.testing.assert_allclose(nuf.numpy(), np.asarray(nu), atol=2e-4,
                                   err_msg=f"nu step {k}")
        for name in w:
            np.testing.assert_allclose(w_f[name][0].numpy(), np.asarray(w[name][0]),
                                       atol=2e-4, err_msg=f"D[{name}] step {k}")
    zf = port.fused_to_z(s, wdef)
    for name in z:
        for i in range(2):
            np.testing.assert_allclose(zf[name][i].numpy(), np.asarray(z[name][i]),
                                       atol=2e-4, err_msg=f"z[{name}][{i}]")


def test_solve_fused_matches_classic_fixed_iters():
    """solve_fused(iters=k) == classic solve stopped at k+1 iterations
    (the fused loop plus its one classic residual-harvest step)."""
    table, obj = random_arbitrage_table(16, 256, seed=2)
    k = 10
    opts = AdmmOptions(max_iters=k + 1, eps_abs=0.0, eps_rel=0.0, adapt_rho=False)
    solver = AdmmSolver(compile_table(table, pad_pools_to=128), options=opts,
                        device="cpu")
    res_c = solver.solve(obj)
    res_f = solver.solve_fused(obj, iters=k)
    np.testing.assert_allclose(res_f.psi.numpy(), res_c.psi.numpy(), atol=2e-4)
    assert abs(float(res_f.r_norm) - float(res_c.r_norm)) < 2e-4
    assert abs(float(res_f.s_norm) - float(res_c.s_norm)) < 2e-4
    assert int(res_f.iters) == int(res_c.iters) == k + 1


def test_solve_fused_rejects_unaligned_and_unported_options():
    table, obj = random_arbitrage_table(16, 100, seed=1)
    solver = AdmmSolver(compile_table(table), options=AdmmOptions(max_iters=5),
                        device="cpu")
    with pytest.raises(ValueError, match="pad_pools_to=128"):
        solver.solve_fused(obj, iters=3)
    with pytest.raises(ValueError, match="pad_pools_to=128"):
        solver.solve_fused(obj, iters=3, merged=True)
    folded = AdmmSolver(fold_compiled(compile_table(table, pad_pools_to=64), 2),
                        options=AdmmOptions(max_iters=5), device="cpu",
                        fold=(2, table.n_assets))
    with pytest.raises(ValueError, match="pad_pools_to=128"):
        folded.solve_fused(Objective(np.tile(obj.c, 2), lo=np.tile(obj.lo, 2),
                                     hi=np.tile(obj.hi, 2)), iters=3)
