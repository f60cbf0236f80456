"""One rank of the port's sharded CPU tests (pytest does not collect it).

    python tests/torch_ranks.py SUITE RANK WORLD STORE OUT

joins a gloo group of WORLD ranks through the file store STORE
(``init_distributed``), runs every case of SUITE in order on meshes of its
ranks, and has rank 0 write each case's result to ``OUT/<case>.npz``.  A
rank that fails writes its traceback to ``OUT/rank<r>.err`` and exits at
once, so its peers fail fast instead of waiting out the group timeout.
Imports no JAX: the test process compares the results with the JAX
package's.

Suites: ``sharding`` (``tests/test_torch_sharding.py``) and ``distributed``
(``tests/test_torch_distributed.py``).
"""
import dataclasses
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cfmm_routing_tpu_torch.models.pools import (  # noqa: E402
    ConstantSumPool, GeoMeanPool, ProductPool,
)
from cfmm_routing_tpu_torch.models.reference_instances import (  # noqa: E402
    arbitrage_instance, two_asset_instance,
)
from cfmm_routing_tpu_torch.models.utility import (  # noqa: E402
    ConcaveUtility, CustomUtility, Objective,
)
from cfmm_routing_tpu_torch.ops.projection import ProjectionConfig  # noqa: E402
from cfmm_routing_tpu_torch.parallel.mesh import (  # noqa: E402
    init_distributed, pool_batch_mesh, pool_mesh,
)
from cfmm_routing_tpu_torch.parallel.sharded import (  # noqa: E402
    ShardedAdmmSolver, ShardedDeltaAdmmSolver,
)
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver  # noqa: E402
from cfmm_routing_tpu_torch.solver.compiler import ProblemSpec, compile_spec  # noqa: E402
from cfmm_routing_tpu_torch.solver.driver import ChunkedDriver  # noqa: E402
from cfmm_routing_tpu_torch.solver.refine import refine, to_host  # noqa: E402
from cfmm_routing_tpu_torch.solver.refine_device import refine_device  # noqa: E402
from cfmm_routing_tpu_torch.utils.synth import random_arbitrage  # noqa: E402

GROUP_TIMEOUT_S = 90  # a rank waiting on a failed peer gives up after this
OPTS = AdmmOptions(max_iters=20000, eps_abs=1e-10, eps_rel=1e-10)
# the random networks converge in 500-2,300 iterations, and a plain CPU
# iteration costs ~20-35 ms: they run a fixed budget instead (rho adapting
# twice, the stopping test evaluated and never met), with the main path's
# projection trips
PCFG = ProjectionConfig(n_bisect=24, n_polish=4)
BUDGET = AdmmOptions(max_iters=60, eps_abs=0.0, eps_rel=0.0, projection=PCFG)
F64 = torch.float64


def random_network(rng, n_assets, n_pools):
    """``tests/test_sharding.py``'s network, with the port's pools: the same
    draws from ``rng`` give the same problem."""
    pools = []
    for _ in range(n_pools):
        kind = rng.integers(0, 3)
        k = int(rng.integers(2, min(5, n_assets) + 1))
        assets = tuple(rng.choice(n_assets, size=k, replace=False))
        reserves = rng.uniform(1.0, 100.0, size=k)
        fee = float(rng.uniform(0.95, 1.0))
        if kind == 0:
            pools.append(ProductPool(assets, reserves, fee=fee))
        elif kind == 1:
            w = rng.uniform(1.0, 4.0, size=k)
            pools.append(GeoMeanPool(assets, reserves, w, fee=fee))
        else:
            pools.append(ConstantSumPool(assets, reserves, fee=fee))
    return ProblemSpec(n_assets=n_assets, pools=pools)


def random_case(seed):
    rng = np.random.default_rng(seed)
    spec = random_network(rng, n_assets=12, n_pools=24)
    return spec, Objective.arbitrage(rng.uniform(0.5, 5.0, size=12))


def fused_options(k):
    return AdmmOptions(max_iters=k + 1, eps_abs=0.0, eps_rel=0.0, adapt_rho=False,
                       consensus="onehot")


def leaves(res, sharded=None):
    """A result's leaves as numpy arrays (planes under ``D/<bucket>`` and
    ``L/<bucket>``; with ``sharded`` also the unbucketed per-pool trades,
    flattened in spec order)."""
    out = {f: np.asarray(to_host(res)._asdict()[f]) for f in
           ("objective", "psi", "prices", "iters", "converged", "r_norm", "s_norm")}
    for name in res.deltas:
        out[f"D/{name}"] = to_host(res).deltas[name]
        out[f"L/{name}"] = to_host(res).lambdas[name]
    if sharded is not None:
        d, lam = sharded.unbucket(res)
        out["unbucket_D"] = np.concatenate(d)
        out["unbucket_L"] = np.concatenate(lam)
    return out


# ---- the sharding suite -------------------------------------------------------


def case_reference(mesh, out):
    spec, obj = arbitrage_instance()
    sh = ShardedAdmmSolver(spec, mesh, dtype=F64, options=OPTS)
    return leaves(sh.solve(obj), sharded=sh)


def case_random(mesh, out):
    spec, obj = random_case(42)
    return leaves(ShardedAdmmSolver(spec, mesh, dtype=F64, options=BUDGET).solve(obj))


def case_assets(mesh, out):
    spec, obj = random_case(7)
    sh = ShardedAdmmSolver(spec, mesh, dtype=F64, options=BUDGET, shard_assets=True)
    return leaves(sh.solve(obj))


def case_assets_reference(mesh, out):
    spec, obj = arbitrage_instance()
    sh = ShardedAdmmSolver(spec, mesh, dtype=F64, options=OPTS, shard_assets=True)
    return leaves(sh.solve(obj))


def fused_solver(mesh, k, pad_per_rank=128):
    spec, obj = random_arbitrage(16, 96, seed=11)
    sh = ShardedAdmmSolver(spec, mesh, dtype=torch.float32, options=fused_options(k),
                           pad_pools_to=pad_per_rank * mesh.size())
    return sh, obj


def case_fused(mesh, out, k=10):
    sh, obj = fused_solver(mesh, k)
    return leaves(sh.solve_fused(obj, iters=k))


def case_unaligned(mesh, out):
    spec, obj = random_arbitrage(16, 96, seed=11)
    sh = ShardedAdmmSolver(spec, mesh, dtype=torch.float32,
                           options=AdmmOptions(max_iters=5), pad_pools_to=128)
    try:
        sh.solve_fused(obj, iters=3)
    except ValueError as err:
        return {"error": np.asarray(str(err))}
    return {"error": np.asarray("")}


DRIVER_OPTS = AdmmOptions(max_iters=10**6, eps_abs=2e-5, eps_rel=2e-5)


def case_driver(mesh, out):
    """ChunkedDriver(fused=True) around a sharded solver, checkpointing every
    chunk (each rank its own shard's file)."""
    spec, obj = arbitrage_instance()
    sh = ShardedAdmmSolver(spec, mesh, dtype=torch.float32, options=DRIVER_OPTS,
                           pad_pools_to=128 * mesh.size())
    path = os.path.join(out, "driver_checkpoint")
    res, log = ChunkedDriver(sh, chunk=25, fused=True).solve(obj, max_iters=4000,
                                                              checkpoint_path=path)
    got = leaves(res)
    got["status"] = np.asarray(log.status)
    torch.distributed.barrier(group=sh.group)  # every rank's checkpoint written
    got["checkpoints"] = np.asarray(sorted(f for f in os.listdir(out)
                                           if f.startswith("driver_checkpoint")))
    return got


def concave_utility():
    rng = np.random.default_rng(5)
    spec = random_network(rng, n_assets=12, n_pools=24)
    c = rng.uniform(0.5, 5.0, size=12)
    util = ConcaveUtility.linear(c, lo=np.zeros(12))
    for j in (0, 3, 7):
        util = util.with_log(j, float(c[j]), 2.0).with_box(j, 0.0, 50.0)
    return spec, util


def case_concave(mesh, out):
    spec, util = concave_utility()
    return leaves(ShardedAdmmSolver(spec, mesh, dtype=F64, options=BUDGET).solve(util))


def fused_concave(obj):
    util = ConcaveUtility.linear(obj.c, lo=np.asarray(obj.lo))
    return util.with_log(1, float(obj.c[1]), 3.0).with_box(1, 0.0, 40.0)


def case_fused_concave(mesh, out):
    sh, obj = fused_solver(mesh, 8)
    return leaves(sh.solve_fused(fused_concave(obj), iters=8))


def custom_utility():
    """A linear value minus a softplus coupling penalty on total inventory
    (``tests/test_sharding.py``'s)."""
    spec, obj = arbitrage_instance()
    n = spec.n_assets
    c = torch.as_tensor(obj.c)

    def fn(psi):
        return torch.sum(c.to(psi) * psi) - 0.5 * torch.log1p(torch.exp(torch.sum(psi) - 4.0))

    return spec, CustomUtility(fn, np.zeros(n), np.full(n, np.inf), smoothness=2.0,
                               prox_iters=60)


CUSTOM_OPTS = dataclasses.replace(BUDGET, max_iters=40)


def case_custom(mesh, out):
    """A budget of 40 iterations, then a warm re-solve of 20 from it."""
    spec, util = custom_utility()
    sh = ShardedAdmmSolver(spec, mesh, dtype=F64, options=CUSTOM_OPTS)
    res = sh.solve(util)
    out = leaves(res)
    warm = leaves(sh.solve(util, warm=res, max_iters=20))
    out.update({f"warm_{k}": v for k, v in warm.items()})
    return out


def case_precise(mesh, out):
    spec, obj = arbitrage_instance()
    out = {}
    for precise in (False, True):
        opts = dataclasses.replace(BUDGET, precise_consensus=precise)
        res = ShardedAdmmSolver(spec, mesh, dtype=F64, options=opts).solve(obj)
        out[f"objective_{precise}"] = np.asarray(to_host(res).objective)
        out[f"psi_{precise}"] = to_host(res).psi
    return out


# ---- the distributed suite ------------------------------------------------------

# the reference test's 1e-8 costs ~28 s of plain CPU iterations for the
# sweep alone; 1e-6 with the main path's projection trips (~11 s) still
# lands the pinned u(25) to ~3e-5
BATCH_OPTS = AdmmOptions(max_iters=4000, eps_abs=1e-6, eps_rel=1e-6, projection=PCFG)


def sweep_rows(B=8):
    spec, _ = two_asset_instance()
    n = spec.n_assets
    c = np.zeros((B, n))
    c[:, 2] = 1.0
    lo = np.zeros((B, n))
    lo[:, 0] = -np.linspace(0.0, 25.0, B)
    hi = np.full((B, n), np.finfo(np.float32).max / 4)
    return spec, c, lo, hi


def case_batch(mesh, out):
    spec, c, lo, hi = sweep_rows()
    sh = ShardedAdmmSolver(spec, mesh, dtype=F64, options=BATCH_OPTS)
    return leaves(sh.solve_batch(c, lo, hi))


def reserve_scenarios(B=4):
    spec, obj = arbitrage_instance()
    return spec, obj, np.random.default_rng(5).uniform(0.7, 1.4, size=(B, len(spec.pools)))


def case_batch_reserves(mesh, out):
    spec, obj, scale = reserve_scenarios()
    sh = ShardedAdmmSolver(spec, mesh, dtype=F64, options=BATCH_OPTS)
    return leaves(sh.solve_batch_reserves(obj, scale))


def case_no_batch_axis(mesh, out):
    spec, _ = two_asset_instance()
    sh = ShardedAdmmSolver(spec, mesh, dtype=F64, options=BATCH_OPTS)
    try:
        sh.solve_batch(np.zeros((2, 3)), np.zeros((2, 3)), np.ones((2, 3)))
    except ValueError as err:
        return {"error": np.asarray(str(err))}
    return {"error": np.asarray("")}


REFINE_BASE_OPTS = AdmmOptions(max_iters=6000, eps_abs=1e-5, eps_rel=1e-5)


def refine_base():
    """The reference instance (compiled for 4 shards) and its float32 base
    solve, which every rank solves alike.  (``tests/test_refine_device.py``
    refines a 32-pool network, whose base solve and refinement cost ~50 s of
    plain CPU iterations on 4 ranks.)"""
    spec, obj = arbitrage_instance()
    compiled = compile_spec(spec, pad_pools_to=4)
    res = AdmmSolver(compiled, dtype=torch.float32, options=REFINE_BASE_OPTS,
                     device="cpu").solve(obj)
    return compiled, obj, res


def cert_leaves(out):
    c = out.certificate
    return {"achieved": np.asarray(out.achieved), "gap_rel": np.asarray(c.gap_rel),
            "feasibility_rel": np.asarray(c.feasibility_rel),
            "cert_objective": np.asarray(c.objective),
            "objective": np.asarray(out.result.objective), "iters": np.asarray(out.iters)}


REFINE_CHUNK = 50  # 250 (the default) costs 500 delta iterations on this base, 50 costs 200
REFINE_DELTA_OPTS = dataclasses.replace(REFINE_BASE_OPTS, max_iters=250, eps_abs=1e-8,
                                        eps_rel=1e-8, adapt_rho=False)


def case_refine_device(mesh, out):
    compiled, obj, res = refine_base()
    dsolver = ShardedDeltaAdmmSolver(compiled, mesh, dtype=torch.float32,
                                     options=REFINE_DELTA_OPTS)
    return cert_leaves(refine_device(compiled, obj, res, target_gap=1e-7,
                                     chunk_iters=REFINE_CHUNK, solver=dsolver))


def refine_cpu_base():
    spec, obj = arbitrage_instance()
    compiled = compile_spec(spec, pad_pools_to=4)
    res = AdmmSolver(compiled, dtype=torch.float32, device="cpu", options=AdmmOptions(
        max_iters=1500, eps_abs=1e-5, eps_rel=1e-5)).solve(obj)
    return compiled, obj, res


def case_refine_cpu_shards(mesh, out):
    compiled, obj, res = refine_cpu_base()
    return cert_leaves(refine(compiled, obj, res, target_gap=1e-6, cpu_shards=4,
                              strict=True, device="cpu"))


# (case name, mesh name, function) in run order.  A rank outside a case's
# mesh skips it: the cases on "pools2a" (ranks 0, 1) and "pools2b" (ranks 2,
# 3) next to each other run at the same time.
SUITES = {
    "sharding": [
        ("reference_4", "pools4", case_reference),
        ("random_4", "pools4", case_random),
        ("assets_4", "pools4", case_assets),
        ("assets_reference_4", "pools4", case_assets_reference),
        ("fused_4", "pools4", case_fused),
        ("unaligned_4", "pools4", case_unaligned),
        ("driver_4", "pools4", case_driver),
        ("concave_4", "pools4", case_concave),
        ("random_2", "pools2a", case_random),
        ("assets_2", "pools2b", case_assets),
        ("fused_2", "pools2a", case_fused),
        ("fused_concave_2", "pools2b", case_fused_concave),
        ("custom_2", "pools2a", case_custom),
        ("precise_2", "pools2b", case_precise),
    ],
    "distributed": [
        ("batch_2x2", "batch2x2", case_batch),
        ("batch_reserves_2x2", "batch2x2", case_batch_reserves),
        ("no_batch_axis_2", "pools2a", case_no_batch_axis),
        ("refine_device_4", "pools4", case_refine_device),
        ("refine_cpu_shards_4", "pools4", case_refine_cpu_shards),
    ],
}


class Ranks:
    """WORLD rank processes of one suite, started at once; :meth:`result`
    waits for them (at most ``timeout`` seconds in all, then kills them)."""

    def __init__(self, suite, world, tmp, timeout=180):
        self.out = str(tmp)
        self.timeout = timeout
        self.procs = []
        env = dict(os.environ, OMP_NUM_THREADS="1")
        for r in range(world):
            with open(os.path.join(self.out, f"rank{r}.log"), "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), suite, str(r), str(world),
                     os.path.join(self.out, "store"), self.out],
                    stdout=log, stderr=subprocess.STDOUT, env=env))
        self._started = time.monotonic()
        self._waited = False

    def wait(self):
        if self._waited:
            return
        self._waited = True
        try:
            for p in self.procs:
                left = self.timeout - (time.monotonic() - self._started)
                p.wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            self.close()

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def result(self, case):
        """A case's arrays; raises with the ranks' errors if it has none."""
        self.wait()
        path = os.path.join(self.out, case + ".npz")
        if not os.path.exists(path):
            errs = [open(os.path.join(self.out, f)).read()
                    for f in sorted(os.listdir(self.out)) if f.endswith(".err")]
            codes = [p.returncode for p in self.procs]
            raise AssertionError(f"no result for {case} (rank exit codes {codes}):\n"
                                 + "\n".join(errs))
        with np.load(path) as data:
            return {k: data[k] for k in data.files}


def main(suite, rank, world, store, out):
    torch.set_num_threads(1)
    assert init_distributed(f"file://{store}", world, rank,
                            timeout=GROUP_TIMEOUT_S) == world
    meshes = {"pools4": pool_mesh(platform="cpu"),
              "pools2a": pool_mesh(devices=[0, 1], platform="cpu"),
              "pools2b": pool_mesh(devices=[2, 3], platform="cpu"),
              "batch2x2": pool_batch_mesh(pools=2, batch=2, platform="cpu")}
    for name, mesh_name, fn in SUITES[suite]:
        mesh = meshes[mesh_name]
        if mesh.get_coordinate() is None:
            continue
        t0 = time.perf_counter()
        result = fn(mesh, out)
        if not any(mesh.get_coordinate()):  # the mesh's first rank writes
            result["seconds"] = np.asarray(time.perf_counter() - t0)
            np.savez(os.path.join(out, name + ".npz"), **result)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    suite, rank, world, store, out = sys.argv[1:6]
    try:
        main(suite, int(rank), int(world), store, out)
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        sys.stderr.write(traceback.format_exc())
        sys.stderr.flush()
        os._exit(1)
