"""Port merged K-group fused path vs the JAX package (CPU).

* ``_merged_groups`` builds the reference's groups: same K-groups in the same
  order, the same bucket concatenation (sorted names inside a group), and a
  per-128-pool-block class table that spells out the reference's per-tile
  ``bid`` table.
* The port's plain ``fused_step_merged`` (what the CUDA kernel is held
  against) matches the reference Pallas ``fused_step_merged`` in interpret
  mode on every output, one call per group, from a nonzero state: atol 2e-5,
  y also rtol 1e-5 (the bars of ``tests/test_torch_fused.py``).
* ``solve_fused(k, merged=True)`` matches the reference's
  ``solve_fused(k, merged=True, interpret=True)``: atol 2e-4 (as
  ``tests/test_fused.py``).
* The merged trajectory equals the unmerged one in float64 to 1e-12 for 12
  steps (the two add the same consensus terms in different orders), with a
  linear objective and with a concave utility.
* ``merged=True`` on a scenario fold or on a bucket whose pool count is not
  a multiple of 128 raises ``ValueError``.
* Each group's class spans (the merged kernel's descriptors) are built once
  on the host: they tile the group's pools in order, equal the runs of its
  class table, and carry each bucket's kind; a group of more than
  ``MAX_GROUP`` spans raises ``ValueError``; the plain merged step walking
  them is bitwise equal to the per-bucket plain step on the same state.

The network is the 300-pool / 16-asset instance at ``pad_pools_to=1024``,
unit-scale reserves: groups K=2 (cs2f + gm2 + gm2f, 3072 pools) and K=4
(cs4f + gm4, 2048 pools).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfmm_routing_tpu.models.utility import Objective as RefObjective
from cfmm_routing_tpu.ops.iteration_pallas import (
    fused_step_merged as ref_fused_step_merged,
)
from cfmm_routing_tpu.ops.projection import ProjectionConfig as RefConfig
from cfmm_routing_tpu.solver import admm as ref_admm
from cfmm_routing_tpu.solver.compiler import compile_table as ref_compile_table
from cfmm_routing_tpu.utils.synth import random_arbitrage_table as ref_table
from cfmm_routing_tpu_torch.models.utility import ConcaveUtility, Objective
from cfmm_routing_tpu_torch.ops import _build
from cfmm_routing_tpu_torch.ops.iteration_cuda import (
    class_spans, fused_step_merged_plain, fused_step_plain,
)
from cfmm_routing_tpu_torch.ops.projection import ProjectionConfig
from cfmm_routing_tpu_torch.ops.projection_cuda import _KIND, MAX_GROUP
from cfmm_routing_tpu_torch.ops.segment import segment_sum_plain
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver
from cfmm_routing_tpu_torch.solver.compiler import compile_table
from cfmm_routing_tpu_torch.solver.fold import fold_compiled
from cfmm_routing_tpu_torch.utils.synth import random_arbitrage_table

torch.set_num_threads(1)

_ref_step = jax.jit(ref_fused_step_merged,
                    static_argnames=("tile_rows", "alpha", "cfg", "interpret"))


def _instance():
    table, obj = random_arbitrage_table(16, 300, seed=4, reserve_scale=1.0)
    ref_t, ref_obj = ref_table(16, 300, seed=4, reserve_scale=1.0)
    return (table, obj, compile_table(table, pad_pools_to=1024, backend="numpy"),
            ref_t, ref_obj, ref_compile_table(ref_t, pad_pools_to=1024, backend="numpy"))


_CASE = _instance()


def test_merged_groups_match_reference_layout():
    _, _, compiled, _, _, ref_compiled = _CASE
    port = AdmmSolver(compiled, dtype=torch.float64, device="cpu")
    ref = ref_admm.AdmmSolver(ref_compiled, dtype=jnp.float64)
    groups, ref_groups = port._merged_groups(), ref._merged_groups()
    assert port._merged_groups() is groups  # cached
    assert [(g["K"], g["names"]) for g in groups] == [
        (2, ["cs2f", "gm2", "gm2f"]), (4, ["cs4f", "gm4"])]
    for g, rg in zip(groups, ref_groups):
        assert (g["K"], g["names"], g["ms"]) == (rg["K"], rg["names"], rg["ms"])
        for key in ("R", "w", "s", "mask", "asset", "gamma", "logk0", "k0"):
            np.testing.assert_array_equal(g["arrs"][key].numpy(),
                                          np.asarray(rg["arrs"][key]), err_msg=key)
        # the reference's per-tile class, spelled out per 128-pool block
        per_block = np.repeat(np.asarray(rg["arrs"]["bid"]), rg["tile"])
        np.testing.assert_array_equal(g["arrs"]["cls"].numpy(), per_block)
        # the group's own slot order covers every real slot of the group
        assert g["arrs"]["order"].numel() == int(g["arrs"]["mask"].sum())


@pytest.mark.parametrize("K", [2, 4])
def test_merged_step_matches_reference_per_call(K):
    _, _, compiled, _, _, ref_compiled = _CASE
    port = AdmmSolver(compiled, dtype=torch.float32, device="cpu")
    ref = ref_admm.AdmmSolver(ref_compiled, dtype=jnp.float32)
    g = next(g for g in port._merged_groups() if g["K"] == K)
    rg = next(g for g in ref._merged_groups() if g["K"] == K)
    rng = np.random.default_rng(12 + K)
    mask = g["arrs"]["mask"].numpy()
    sD = (rng.uniform(-0.5, 0.5, mask.shape) * mask).astype(np.float32)
    sL = (rng.uniform(-0.5, 0.5, mask.shape) * mask).astype(np.float32)
    v = np.zeros(128, np.float32)
    v[:16] = 0.3 * rng.normal(size=16)
    want = _ref_step(jnp.asarray(sD), jnp.asarray(sL), jnp.asarray(v), rg["arrs"],
                     tile_rows=rg["tile"], alpha=1.5, cfg=RefConfig(), interpret=True)
    _build.reset_launch_counts()
    got = fused_step_merged_plain(torch.as_tensor(sD), torch.as_tensor(sL),
                                  torch.as_tensor(v), g["arrs"], 1.5,
                                  cfg=ProjectionConfig())
    assert _build.LAUNCHES["fused_step_merged"] == 0
    for a, b, label in zip(got, want, ("sD'", "sL'", "D", "L", "y")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5,
                                   rtol=1e-5 if label == "y" else 0,
                                   err_msg=f"K={K} {label}")


def test_solve_fused_merged_matches_reference():
    _, obj, compiled, _, ref_obj, ref_compiled = _CASE
    k = 5
    ref = ref_admm.AdmmSolver(ref_compiled, dtype=jnp.float32,
                              options=ref_admm.AdmmOptions(max_iters=k + 1))
    want = ref.solve_fused(RefObjective(ref_obj.c, ref_obj.lo, ref_obj.hi), iters=k,
                           interpret=True, merged=True)
    port = AdmmSolver(compiled, dtype=torch.float32,
                      options=AdmmOptions(max_iters=k + 1), device="cpu")
    got = port.solve_fused(obj, iters=k, merged=True)
    np.testing.assert_allclose(got.psi.numpy(), np.asarray(want.psi), atol=2e-4)
    np.testing.assert_allclose(got.prices.numpy(), np.asarray(want.prices), atol=2e-4)
    for name in want.deltas:
        np.testing.assert_allclose(got.deltas[name].numpy(),
                                   np.asarray(want.deltas[name]), atol=2e-4,
                                   err_msg=name)
    assert abs(float(got.objective) - float(want.objective)) < 2e-4
    assert int(got.iters) == int(want.iters) == k + 1


def _log_utility(obj):
    util = ConcaveUtility.linear(obj.c, lo=obj.lo, hi=obj.hi)
    return util.with_log(1, c=1.0, b=2.0).with_log(3, c=0.5, b=1.0)


@pytest.mark.parametrize("flavour", ["linear", "utility"])
def test_merged_trajectory_matches_unmerged_float64(flavour):
    _, obj, compiled, _, _, _ = _CASE
    objective = obj if flavour == "linear" else _log_utility(obj)
    port = AdmmSolver(compiled, dtype=torch.float64, device="cpu",
                      options=AdmmOptions(projection=ProjectionConfig(48, 6)))
    c, lo, hi, util = port._pack(objective)
    rho = port._t(1.0)
    groups = port._merged_groups()
    s, wdef, nu = port.fused_init()
    sm, wdef_m, nu_m = port._merge_state(s, groups), wdef, nu
    for k in range(12):
        s, wdef, nu, psi, _ = port._iterate_fused(s, wdef, nu, rho, c, lo, hi,
                                                  util=util)
        sm, wdef_m, nu_m, psi_m, _ = port._iterate_fused_merged(
            sm, wdef_m, nu_m, rho, c, lo, hi, groups, util=util)
        np.testing.assert_allclose(psi_m.numpy(), psi.numpy(), atol=1e-12,
                                   err_msg=f"psi step {k}")
        np.testing.assert_allclose(nu_m.numpy(), nu.numpy(), atol=1e-12,
                                   err_msg=f"nu step {k}")
    split = port._split_state(sm, groups)
    assert set(split) == set(s)
    for name in s:
        for i in range(2):
            np.testing.assert_allclose(split[name][i].numpy(), s[name][i].numpy(),
                                       atol=1e-12, err_msg=f"s[{name}][{i}]")


def test_merged_rejects_folds_and_unaligned_buckets():
    table, obj = random_arbitrage_table(16, 100, seed=1)
    solver = AdmmSolver(compile_table(table), options=AdmmOptions(max_iters=5),
                        device="cpu")
    with pytest.raises(ValueError, match="pad_pools_to=128"):
        solver.solve_fused(obj, iters=3, merged=True)
    T = 2
    folded = AdmmSolver(fold_compiled(compile_table(table, pad_pools_to=128), T),
                        options=AdmmOptions(max_iters=5), device="cpu",
                        fold=(T, table.n_assets))
    tiled = Objective(np.tile(obj.c, T), lo=np.tile(obj.lo, T), hi=np.tile(obj.hi, T))
    with pytest.raises(ValueError, match="scenario fold"):
        folded.solve_fused(tiled, iters=3, merged=True)
    folded.solve_fused(tiled, iters=3)  # the fold kernels take it unmerged


def test_merged_spans_tile_the_group_with_bucket_kinds():
    _, _, compiled, _, _, _ = _CASE
    port = AdmmSolver(compiled, dtype=torch.float32, device="cpu")
    for g in port._merged_groups():
        spans = g["arrs"]["spans"]
        assert isinstance(spans, list)
        assert spans == class_spans(g["arrs"]["cls"].numpy())
        M = g["arrs"]["mask"].shape[1]
        assert [a for a, _, _, _ in spans] == [0] + [b for _, b, _, _ in spans[:-1]]
        assert spans[-1][1] == M and all(a % 128 == 0 for a, _, _, _ in spans)
        off = 0
        for name, m in zip(g["names"], g["ms"]):  # every pool's span has its bucket's kind
            for a, b, kind, floor in spans:
                if a < off + m and off < b:  # constant sum floors either way
                    assert _KIND[(kind, floor)] == _KIND[port._meta[name]], (name, spans)
            off += m


def test_merged_groups_reject_more_spans_than_the_table():
    _, _, compiled, _, _, _ = _CASE
    port = AdmmSolver(compiled, dtype=torch.float32, device="cpu")
    n = MAX_GROUP + 1  # alternating kinds: one span per bucket
    port.buckets = {f"b{i}": port.buckets["gm2" if i % 2 else "cs2f"] for i in range(n)}
    port._meta = {f"b{i}": ("gm", False) if i % 2 else ("cs", True) for i in range(n)}
    with pytest.raises(ValueError, match=f"{n} runs of one pool kind"):
        port._merged_groups()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_merged_plain_over_spans_matches_per_bucket_bitwise(dtype):
    _, _, compiled, _, _, _ = _CASE
    cfg = ProjectionConfig(24, 4) if dtype == torch.float32 else ProjectionConfig(48, 6)
    port = AdmmSolver(compiled, dtype=dtype, device="cpu")
    rng = np.random.default_rng(7)
    s = {name: tuple(torch.as_tensor(x, dtype=dtype) * a["mask"]
                     for x in rng.uniform(-2.0, 2.0, (2,) + tuple(a["mask"].shape)))
         for name, a in port.buckets.items()}
    v = torch.as_tensor(rng.normal(size=128), dtype=dtype)
    groups = port._merged_groups()
    for g, (sD, sL) in zip(groups, port._merge_state(s, groups)):
        got = fused_step_merged_plain(sD, sL, v, g["arrs"], 1.5, cfg=cfg)
        parts = [fused_step_plain(*s[nm], v, port.buckets[nm], *port._meta[nm], 1.5,
                                  cfg=cfg) for nm in g["names"]]
        want = [torch.cat([p[j] for p in parts], dim=1) for j in range(4)]
        for j, label in enumerate(("sD'", "sL'", "D", "L")):
            assert torch.equal(got[j], want[j]), (g["names"], label)
        val = 1.5 * (want[3] - want[2]) + (1.0 - 1.5) * (sL - sD)
        y = segment_sum_plain(val, g["arrs"]["order"], g["arrs"]["seg"], 128)
        assert torch.equal(got[4], y), g["names"]
