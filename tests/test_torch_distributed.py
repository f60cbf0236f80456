"""The port's process groups and meshes, batch-sharded solves and sharded
refinement, on the CPU.

In this process: ``init_distributed()`` given nothing is a no-op that
returns 1; ``pool_mesh(platform="cpu")`` builds a one-rank mesh over an
in-memory store, on which a sharded solve is the single-device one bit for
bit; a 2x2 ``pool_batch_mesh`` needs 4 ranks; ``refine(cpu_shards=10_000,
strict=True)`` raises naming the ``SINGLE-DEVICE`` fallback.

On a group of 4 rank processes (``tests/torch_ranks.py``, suite
``distributed``), each against the single-device solve of the same compiled
problem, solved here while the ranks run:

* a 2x2 ``pool_batch_mesh``: ``solve_batch`` over the two-asset sweep
  (B = 8; u(25) = 31.005495 to 1e-4) and ``solve_batch_reserves`` (B = 4;
  1e-6); without a ``batch`` axis, ``ValueError``;
* ``refine_device`` with a ``ShardedDeltaAdmmSolver`` on 4 ranks: certified
  at 1e-7 and within 1e-6 of the single-device refinement;
* ``refine(cpu_shards=4)`` in the 4-rank gloo group: certified at 1e-6, the
  pin 21.499805 to 2e-6, the single-device polish's certificate to 1e-6.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_ranks as tr
from cfmm_routing_tpu_torch.parallel.mesh import (
    init_distributed, pool_batch_mesh, pool_mesh,
)
from cfmm_routing_tpu_torch.parallel.sharded import ShardedAdmmSolver
from cfmm_routing_tpu_torch.solver.admm import AdmmSolver
from cfmm_routing_tpu_torch.solver.compiler import compile_spec
from cfmm_routing_tpu_torch.solver.refine import refine
from cfmm_routing_tpu_torch.solver.refine_device import DeltaAdmmSolver, refine_device

F64 = torch.float64

# the in-process references run beside the rank processes (each already
# at OMP_NUM_THREADS=1): one thread here too
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    group = tr.Ranks("distributed", 4, tmp_path_factory.mktemp("distributed_ranks"))
    yield group
    group.close()


@pytest.fixture(scope="module")
def refs(ranks):
    """The single-device references, solved while the ranks run."""
    out = {}
    spec, c, lo, hi = tr.sweep_rows()
    out["batch"] = AdmmSolver(compile_spec(spec, pad_pools_to=2), dtype=F64,
                              options=tr.BATCH_OPTS, device="cpu").solve_batch(c, lo, hi)
    spec, obj, scale = tr.reserve_scenarios()
    out["batch_reserves"] = AdmmSolver(
        compile_spec(spec, pad_pools_to=2), dtype=F64, options=tr.BATCH_OPTS,
        device="cpu").solve_batch_reserves(obj, scale)
    compiled, obj, res = tr.refine_base()
    dsolver = DeltaAdmmSolver(compiled, dtype=torch.float32, options=tr.REFINE_DELTA_OPTS,
                              device="cpu")
    out["refine_device"] = refine_device(compiled, obj, res, target_gap=1e-7,
                                         chunk_iters=tr.REFINE_CHUNK, solver=dsolver)
    compiled, obj, res = tr.refine_cpu_base()
    out["refine"] = refine(compiled, obj, res, target_gap=1e-6, device="cpu")
    return out


@pytest.fixture
def own_group():
    """Destroys the one-rank group a test's ``pool_mesh`` made, so the
    worker's later tests see no group."""
    had = dist.is_initialized()
    yield
    if dist.is_initialized() and not had:
        dist.destroy_process_group()


# ---- 4 rank processes -----------------------------------------------------------------


def test_batch_sharded_sweep_matches_single_device(ranks, refs):
    res_1 = refs["batch"]
    got = ranks.result("batch_2x2")
    assert got["converged"].all()
    np.testing.assert_allclose(got["objective"], res_1.objective.numpy(), rtol=1e-6)
    # u(t) is nondecreasing along the grid and lands on the pinned value
    u = got["objective"]
    assert np.all(np.diff(u) > -1e-6)
    np.testing.assert_allclose(u[-1], 31.005495, rtol=1e-4)


def test_batch_mesh_requires_batch_axis(ranks):
    assert "batch" in str(ranks.result("no_batch_axis_2")["error"])


def test_sharded_batch_reserves_matches_single_device(ranks, refs):
    res_1 = refs["batch_reserves"]
    got = ranks.result("batch_reserves_2x2")
    assert got["objective"].shape == (4,)
    np.testing.assert_allclose(got["objective"], res_1.objective.numpy(), rtol=1e-6)
    np.testing.assert_allclose(got["psi"], res_1.psi.numpy(), atol=1e-6)


def test_refine_device_sharded_delta_solver(ranks, refs):
    """refine_device with a ShardedDeltaAdmmSolver runs its correction solves
    across the pools mesh and certifies like the single-device path."""
    got = ranks.result("refine_device_4")
    assert bool(got["achieved"])
    assert abs(float(got["gap_rel"])) <= 1e-7
    assert float(got["feasibility_rel"]) <= 1e-7
    want = refs["refine_device"].certificate.objective
    assert abs(float(got["cert_objective"]) - want) <= 1e-6 * max(1.0, abs(want))


def test_refine_cpu_shards_in_a_gloo_group(ranks, refs):
    """refine(cpu_shards=4) on 4 gloo ranks polishes through ShardedAdmmSolver
    and certifies the same instance to the same target."""
    got = ranks.result("refine_cpu_shards_4")
    out1 = refs["refine"]
    assert bool(got["achieved"]) and out1.achieved
    assert abs(float(got["gap_rel"])) <= 1e-6
    np.testing.assert_allclose(float(got["cert_objective"]), out1.certificate.objective,
                               rtol=1e-6)
    np.testing.assert_allclose(float(got["objective"]), 21.499805, rtol=2e-6)


# ---- one process -----------------------------------------------------------------


def test_init_distributed_given_nothing_is_a_no_op(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    had = dist.is_initialized()
    assert init_distributed() == (dist.get_world_size() if had else 1)
    assert dist.is_initialized() == had


def test_one_rank_mesh_solves_as_the_single_device_solver(own_group):
    """The counterpart of the JAX package's one-device mesh: a sharded solve
    on it is the single-device solve, bit for bit (the all-reduce of one rank
    is the identity)."""
    mesh = pool_mesh(platform="cpu")
    assert mesh.mesh_dim_names == ("pools",) and mesh.size() == 1
    spec, obj = tr.arbitrage_instance()
    opts = dataclasses.replace(tr.BUDGET, max_iters=30)
    got = ShardedAdmmSolver(spec, mesh, dtype=F64, options=opts).solve(obj)
    want = AdmmSolver(compile_spec(spec), dtype=F64, options=opts, device="cpu").solve(obj)
    assert torch.equal(got.psi, want.psi) and torch.equal(got.prices, want.prices)
    for name in want.deltas:
        assert torch.equal(got.deltas[name], want.deltas[name])


def test_pool_batch_mesh_needs_enough_ranks(own_group):
    with pytest.raises(ValueError, match="need 4 devices"):
        pool_batch_mesh(pools=2, batch=2, devices=[0], platform="cpu")


def test_refine_cpu_shards_strict_raises_without_the_ranks():
    spec, obj = tr.arbitrage_instance()
    compiled = compile_spec(spec)
    base = AdmmSolver(compiled, dtype=torch.float32, device="cpu",
                      options=dataclasses.replace(tr.BUDGET, max_iters=20)).solve(obj)
    with pytest.raises(RuntimeError, match="SINGLE-DEVICE"):
        refine(compiled, obj, base, cpu_shards=10_000, strict=True, device="cpu")
