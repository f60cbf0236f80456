"""The port's pool-sharded solver on gloo ranks against the port's
single-device solver and the JAX package's sharded solver, on the CPU
(counterparts of ``tests/test_sharding.py``, at its tolerances).

One group of 4 rank processes (``tests/torch_ranks.py``, suite
``sharding``) runs every sharded case, started once for the module: on all
4 ranks, or on two 2-rank meshes side by side.  The tests compute their
references while the ranks run, then compare.

* The reference instance, 4 ranks, float64 to 1e-10: the single-device
  objective to 1e-8, psi to 1e-7, the unbucketed trades to 1e-6.
* A random 12-asset, 24-pool network, 2 and 4 ranks, 60 iterations: the
  single-device objective to 1e-6; the asset-sharded consensus
  (reduce-scatter, block prox, all-gather) likewise, and the reference
  instance's pin with it.
* The fused kernels' path, 2 and 4 ranks, against the fused single-device
  solve of the same padded problem (psi 2e-4, objective 1e-4, relative
  drift 1e-5); unaligned shards raise naming ``pad_pools_to``;
  ``ChunkedDriver(fused=True)`` around a sharded solver to 1e-3.
* Concave utilities (classic and fused) and a custom utility (with a warm
  re-solve); ``precise_consensus`` against the plain all-reduce (1e-9).
* The JAX package's ``ShardedAdmmSolver`` on as many virtual CPU devices,
  fed the same compiled arrays: a float64 classic case and a float32 fused
  case (its kernels in interpret mode).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cfmm_routing_tpu.models.pools import (
    ConstantSumPool as RefConstantSumPool,
    GeoMeanPool as RefGeoMeanPool,
    ProductPool as RefProductPool,
)
from cfmm_routing_tpu.models.utility import Objective as RefObjective
from cfmm_routing_tpu.ops.projection import ProjectionConfig as RefProjectionConfig
from cfmm_routing_tpu.parallel.mesh import pool_mesh as ref_pool_mesh
from cfmm_routing_tpu.parallel.sharded import ShardedAdmmSolver as RefShardedAdmmSolver
from cfmm_routing_tpu.solver.admm import AdmmOptions as RefAdmmOptions
from cfmm_routing_tpu.solver.compiler import (
    ProblemSpec as RefProblemSpec,
    compile_spec as ref_compile_spec,
)
from cfmm_routing_tpu.utils.synth import random_arbitrage as ref_random_arbitrage

import torch_ranks as tr
from cfmm_routing_tpu_torch.solver.admm import AdmmSolver
from cfmm_routing_tpu_torch.solver.compiler import compile_spec
from cfmm_routing_tpu_torch.utils.synth import random_arbitrage

F64 = torch.float64

# the in-process references run beside the rank processes (each already
# at OMP_NUM_THREADS=1): one thread here too
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    group = tr.Ranks("sharding", 4, tmp_path_factory.mktemp("sharding_ranks"))
    yield group
    group.close()


def single(spec, options, dtype=F64, pad=1):
    return AdmmSolver(compile_spec(spec, pad_pools_to=pad), dtype=dtype, options=options,
                      device="cpu")


def fused_single(n_dev, k):
    spec, obj = random_arbitrage(16, 96, seed=11)
    sol = single(spec, tr.fused_options(k), dtype=torch.float32, pad=128 * n_dev)
    return sol, obj


@pytest.fixture(scope="module")
def refs(ranks):
    """The references, solved while the ranks run: the port's single-device
    solves and the JAX package's sharded ones."""
    out = {}
    spec, obj = tr.arbitrage_instance()
    sol = single(spec, tr.OPTS)
    out["reference"] = sol.solve(obj)
    out["reference_unbucket"] = unbucketed(sol, out["reference"])
    for seed in (42, 7):
        spec, obj = tr.random_case(seed)
        out[f"random{seed}"] = single(spec, tr.BUDGET).solve(obj)
    for n_dev in (2, 4):
        sol, obj = fused_single(n_dev, 10)
        out[f"fused{n_dev}"] = sol.solve_fused(obj, iters=10)
    sol, obj = fused_single(2, 8)
    out["fused_concave"] = sol.solve_fused(tr.fused_concave(obj), iters=8)
    spec, obj = tr.arbitrage_instance()
    out["driver"] = single(spec, tr.DRIVER_OPTS, dtype=torch.float32, pad=512).solve(obj)
    spec, util = tr.concave_utility()
    out["concave"] = single(spec, tr.BUDGET).solve(util)
    spec, util = tr.custom_utility()
    sol = single(spec, tr.CUSTOM_OPTS, pad=2)
    out["custom"] = sol.solve(util)
    out["custom_warm"] = sol.solve(util, warm=out["custom"], max_iters=20)
    out["jax_classic"] = jax_classic()
    out["jax_fused"] = jax_fused()
    return out


def unbucketed(solver, res):
    d, lam = solver.unbucket(res)
    return np.concatenate(d), np.concatenate(lam)


# ---- classic: the reference instance and a random network ------------------------


def test_sharded_matches_single_device_reference_instance(ranks, refs):
    res_1 = refs["reference"]
    got = ranks.result("reference_4")
    assert bool(got["converged"])
    np.testing.assert_allclose(float(got["objective"]), float(res_1.objective), rtol=1e-8)
    np.testing.assert_allclose(got["psi"], res_1.psi.numpy(), atol=1e-7)


def test_sharded_trades_unbucket_correctly(ranks, refs):
    """The gathered per-pool trades of the sharded solve, unbucketed, match
    the single-device ones (same spec order, same values)."""
    d_1, l_1 = refs["reference_unbucket"]
    got = ranks.result("reference_4")
    np.testing.assert_allclose(got["unbucket_D"], d_1, atol=1e-6)
    np.testing.assert_allclose(got["unbucket_L"], l_1, atol=1e-6)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_random_network(ranks, refs, n_dev):
    res_1 = refs["random42"]
    got = ranks.result(f"random_{n_dev}")
    assert int(got["iters"]) == int(res_1.iters) == tr.BUDGET.max_iters
    np.testing.assert_allclose(float(got["objective"]), float(res_1.objective),
                               rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_asset_sharded_consensus_matches_single_device(ranks, refs, n_dev):
    """shard_assets=True: reduce-scatter + block prox + all-gather gives the
    replicated result; n = 12 over 4 ranks is 3 assets a block, over 2 six."""
    res_1 = refs["random7"]
    got = ranks.result(f"assets_{n_dev}")
    np.testing.assert_allclose(float(got["objective"]), float(res_1.objective),
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(got["psi"], res_1.psi.numpy(), atol=1e-6)


def test_asset_sharded_reference_instance(ranks):
    got = ranks.result("assets_reference_4")
    assert bool(got["converged"])
    np.testing.assert_allclose(float(got["objective"]), 21.499805, rtol=1e-6)


# ---- the fused kernels' path -------------------------------------------------------


@pytest.mark.parametrize("n_dev", [2, 4])
def test_fused_sharded_matches_fused_single_device(ranks, refs, n_dev):
    """solve_fused on every rank's shard == solve_fused single-device over the
    same padded compiled problem (the consensus's reduction order is the only
    difference)."""
    res_1 = refs[f"fused{n_dev}"]
    got = ranks.result(f"fused_{n_dev}")
    np.testing.assert_allclose(got["psi"], res_1.psi.numpy(), atol=2e-4)
    np.testing.assert_allclose(float(got["objective"]), float(res_1.objective),
                               rtol=1e-4, atol=1e-3)
    assert int(got["iters"]) == 10 + 1


def test_fused_sharded_trajectory_parity_relative(ranks, refs):
    """The sharded fused trajectory against the single-device one, judged
    relative to the iterate's scale."""
    p1 = refs["fused2"].psi.numpy()
    got = ranks.result("fused_2")
    rel = float(np.max(np.abs(got["psi"] - p1))) / max(1.0, float(np.max(np.abs(p1))))
    assert rel <= 1e-5


def test_fused_sharded_rejects_unaligned_shards(ranks):
    """96 pools padded to 128 over 4 ranks leaves 32 a rank."""
    got = ranks.result("unaligned_4")
    assert "pad_pools_to" in str(got["error"])


def test_chunked_driver_on_sharded_solver_fused(ranks, refs):
    """ChunkedDriver(fused=True) around a ShardedAdmmSolver converges to the
    single-device answer; each rank checkpoints its own shard."""
    got = ranks.result("driver_4")
    assert str(got["status"]) == "converged"
    assert list(got["checkpoints"]) == [f"driver_checkpoint.rank{r}.npz" for r in range(4)]
    np.testing.assert_allclose(float(got["objective"]), float(refs["driver"].objective),
                               rtol=1e-3)


# ---- utilities and the compensated consensus --------------------------------------


def test_sharded_concave_utility_matches_single_device(ranks, refs):
    res_1 = refs["concave"]
    got = ranks.result("concave_4")
    np.testing.assert_allclose(float(got["objective"]), float(res_1.objective),
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(got["psi"], res_1.psi.numpy(), atol=1e-6)


def test_fused_sharded_concave_utility(ranks, refs):
    got = ranks.result("fused_concave_2")
    np.testing.assert_allclose(got["psi"], refs["fused_concave"].psi.numpy(), atol=2e-4)


def test_sharded_custom_utility_matches_single_device(ranks, refs):
    """A non-separable CustomUtility: the FISTA prox runs replicated after the
    all-reduce, the pools shard.  A warm re-solve from the sharded result
    continues as the single-device one does from its own."""
    res_1, warm_1 = refs["custom"], refs["custom_warm"]
    got = ranks.result("custom_2")
    np.testing.assert_allclose(float(got["objective"]), float(res_1.objective), rtol=1e-7)
    np.testing.assert_allclose(got["psi"], res_1.psi.numpy(), atol=1e-7)
    np.testing.assert_allclose(float(got["warm_objective"]), float(warm_1.objective),
                               rtol=1e-7)
    np.testing.assert_allclose(got["warm_psi"], warm_1.psi.numpy(), atol=1e-7)


def test_precise_consensus_solves_identically(ranks):
    """precise_consensus (the rank-ordered compensated sum) solves to the
    plain all-reduce's answer."""
    got = ranks.result("precise_2")
    np.testing.assert_allclose(float(got["objective_True"]), float(got["objective_False"]),
                               rtol=1e-9)
    np.testing.assert_allclose(got["psi_True"], got["psi_False"], atol=1e-9)


# ---- against the JAX package's ShardedAdmmSolver ------------------------------------


def ref_random_case(seed):
    """tests/test_sharding.py's network with the JAX package's pools (the same
    draws as ``torch_ranks.random_network``)."""
    rng = np.random.default_rng(seed)
    pools = []
    for _ in range(24):
        kind = rng.integers(0, 3)
        k = int(rng.integers(2, 6))
        assets = tuple(rng.choice(12, size=k, replace=False))
        reserves = rng.uniform(1.0, 100.0, size=k)
        fee = float(rng.uniform(0.95, 1.0))
        if kind == 0:
            pools.append(RefProductPool(assets, reserves, fee=fee))
        elif kind == 1:
            pools.append(RefGeoMeanPool(assets, reserves, rng.uniform(1.0, 4.0, size=k),
                                        fee=fee))
        else:
            pools.append(RefConstantSumPool(assets, reserves, fee=fee))
    return (RefProblemSpec(n_assets=12, pools=pools),
            RefObjective.arbitrage(rng.uniform(0.5, 5.0, size=12)))


def same_buckets(ref_compiled, port_compiled):
    """The two packages' compiled arrays: the same layout and ids, the same
    values to the last bit or two (the invariants' logs round alike but for
    an ulp)."""
    assert sorted(ref_compiled.buckets) == sorted(port_compiled.buckets)
    for name, b in ref_compiled.buckets.items():
        p = port_compiled.buckets[name]
        for key in ("mask", "asset", "pool_ids"):
            np.testing.assert_array_equal(np.asarray(getattr(b, key)), getattr(p, key))
        for key in ("reserves", "weights", "shift", "gamma", "logk0", "k0"):
            np.testing.assert_allclose(getattr(p, key), np.asarray(getattr(b, key)),
                                       rtol=1e-15, atol=0)
    np.testing.assert_array_equal(np.asarray(ref_compiled.degree), port_compiled.degree)


def jax_classic():
    """The reference's sharded classic solve of the random network on 4
    virtual CPU devices, 60 iterations."""
    spec, obj = ref_random_case(42)
    port_spec, _ = tr.random_case(42)
    same_buckets(ref_compile_spec(spec, pad_pools_to=4),
                 compile_spec(port_spec, pad_pools_to=4))
    opts = RefAdmmOptions(max_iters=tr.BUDGET.max_iters, eps_abs=0.0, eps_rel=0.0,
                          projection=RefProjectionConfig(*tr.PCFG))
    mesh = ref_pool_mesh(n_devices=4, platform="cpu")
    return RefShardedAdmmSolver(spec, mesh, dtype=jnp.float64, options=opts).solve(obj)


def jax_fused(k=10):
    """The reference's sharded fused solve (Pallas kernels in interpret mode)
    on 2 virtual CPU devices, the random arbitrage network padded to 128 a
    device."""
    spec, obj = ref_random_arbitrage(16, 96, seed=11)
    port_spec, _ = random_arbitrage(16, 96, seed=11)
    same_buckets(ref_compile_spec(spec, pad_pools_to=256),
                 compile_spec(port_spec, pad_pools_to=256))
    opts = RefAdmmOptions(max_iters=k + 1, eps_abs=0.0, eps_rel=0.0, adapt_rho=False,
                          consensus="onehot")
    mesh = ref_pool_mesh(n_devices=2, platform="cpu")
    return RefShardedAdmmSolver(spec, mesh, dtype=jnp.float32, options=opts,
                                pad_pools_to=256).solve_fused(obj, iters=k, interpret=True)


def test_against_jax_sharded_classic_float64(ranks, refs):
    """The port on 4 gloo ranks against the reference on 4 virtual CPU
    devices, on the same compiled arrays."""
    want = refs["jax_classic"]
    got = ranks.result("random_4")
    np.testing.assert_allclose(float(got["objective"]), float(want.objective),
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(got["psi"], np.asarray(want.psi), atol=1e-7)
    np.testing.assert_allclose(got["prices"], np.asarray(want.prices), atol=1e-7)


def test_against_jax_sharded_fused_float32(ranks, refs):
    """The port on 2 gloo ranks (plain fused steps) against the reference on
    2 virtual CPU devices, on the same padded compiled arrays."""
    want = refs["jax_fused"]
    got = ranks.result("fused_2")
    np.testing.assert_allclose(got["psi"], np.asarray(want.psi), atol=2e-4)
    np.testing.assert_allclose(float(got["objective"]), float(want.objective),
                               rtol=1e-4, atol=1e-3)
    assert int(got["iters"]) == int(want.iters) == 10 + 1
