"""The chunked segment sum and the grouped base fused step: their plain
versions (what the CUDA kernels are held against), on the CPU.

* ``segment_sum_plain`` (each asset's run cut into pieces at the multiples
  of the chunk width C = 64, pieces summed lane-strided and added in order)
  against the order of the first design (one warp per asset) and against
  ``index_add_``: 1e-12 in float64, on every bucket and K-group of a
  150-pool network and of a T=2 fold of 128 pools per point.
* ``fused_step_grouped_plain`` on each K-group against the per-bucket
  ``fused_step_plain``: planes bitwise (the same arithmetic), y to 1e-12 in
  float64 (the group's segment sum adds the same terms in another order);
  the wrapper on CPU tensors is the grouped plain version.  Unfolded and
  on the fold.
* The grouped step against the JAX package, bucket by bucket, y summed
  over the group: in float32 its Pallas ``fused_step`` in interpret mode,
  atol 2e-5; in float64 its float64 projections (the Pallas kernel
  computes in float32 whatever its input dtype), atol 1e-10; y also rtol
  1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfmm_routing_tpu.ops.iteration_pallas import fused_step as ref_fused_step
from cfmm_routing_tpu.ops.projection import ProjectionConfig as RefConfig
from cfmm_routing_tpu.ops.projection import project_cs as ref_project_cs
from cfmm_routing_tpu.ops.projection import project_gm as ref_project_gm
from cfmm_routing_tpu.solver import admm as ref_admm
from cfmm_routing_tpu.solver.compiler import compile_table as ref_compile_table
from cfmm_routing_tpu.utils.synth import random_arbitrage_table as ref_table
from cfmm_routing_tpu_torch.ops.iteration_cuda import (
    fused_step_grouped, fused_step_grouped_plain, fused_step_plain,
)
from cfmm_routing_tpu_torch.ops.projection import ProjectionConfig
from cfmm_routing_tpu_torch.ops.segment import segment_sum_plain
from cfmm_routing_tpu_torch.solver.admm import AdmmSolver
from cfmm_routing_tpu_torch.solver.compiler import compile_table
from cfmm_routing_tpu_torch.solver.fold import fold_compiled
from cfmm_routing_tpu_torch.utils.synth import random_arbitrage_table

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
CFG = ProjectionConfig()
_ref_step = jax.jit(
    ref_fused_step,
    static_argnames=("kind", "needs_floor", "alpha", "cfg", "interpret", "fold"),
)


def _network():
    table, _ = random_arbitrage_table(16, 150, seed=4, reserve_scale=1.0)
    compiled = compile_table(table, pad_pools_to=128)
    assert {n: b.m for n, b in compiled.buckets.items()} == dict.fromkeys(
        ["gm2", "gm2f", "gm4", "cs2f", "cs4f"], 128)
    return compiled


_COMPILED = _network()


def _solver(dtype, fold):
    if not fold:
        return AdmmSolver(_COMPILED, dtype=dtype, device="cpu")
    return AdmmSolver(fold_compiled(_COMPILED, 2), dtype=dtype, device="cpu",
                      fold=(2, _COMPILED.n_assets))


def _state(solver, dtype, seed):
    rng = np.random.default_rng(seed)
    s = {name: tuple(torch.as_tensor(x, dtype=dtype) * a["mask"]
                     for x in rng.uniform(-0.5, 0.5, (2,) + tuple(a["mask"].shape)))
         for name, a in solver.buckets.items()}
    v = torch.zeros(128, dtype=dtype)
    v[:solver.n] = torch.as_tensor(0.3 * rng.normal(size=solver.n), dtype=dtype)
    return s, v


def _warp_per_asset_sum(vals, order, seg, n_out):
    """The first design's order: one warp per asset, lanes in stride order
    over the whole run, then the halving tree."""
    flat = vals.reshape(-1)[order.long()].numpy()
    out = np.zeros(n_out)
    for j in range(seg.numel() - 1):
        run = flat[int(seg[j]):int(seg[j + 1])]
        lanes = np.zeros(32)
        for i, x in enumerate(run):
            lanes[i % 32] += x
        half = 16
        while half:
            lanes = lanes[:half] + lanes[half:2 * half]
            half //= 2
        out[j] = lanes[0]
    return out


@pytest.mark.parametrize("fold", [False, True], ids=["unfolded", "fold"])
def test_segment_sum_new_order_matches_old_and_index_add(fold):
    solver = _solver(F64, fold)
    rng = np.random.default_rng(1)
    planes = [(name, a) for name, a in solver.buckets.items()]
    planes += [(str(g["names"]), g) for g in solver._groups]
    for label, a in planes:
        if "mask" in a:
            mask, asset = a["mask"], a["asset"]
        else:  # a K-group: its buckets' planes one after another
            mask = torch.cat([solver.buckets[nm]["mask"].reshape(-1)
                              for nm in a["names"]])
            asset = torch.cat([solver.buckets[nm]["asset"].reshape(-1)
                               for nm in a["names"]])
        vals = torch.as_tensor(rng.normal(size=mask.numel()), dtype=F64) * mask.reshape(-1)
        y = segment_sum_plain(vals, a["order"], a["seg"], 256)
        old = _warp_per_asset_sum(vals, a["order"], a["seg"], 256)
        want = torch.zeros(256, dtype=F64).index_add_(0, asset.reshape(-1).long(), vals)
        np.testing.assert_allclose(y.numpy(), old, rtol=0, atol=1e-12, err_msg=label)
        np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=0, atol=1e-12,
                                   err_msg=label)


@pytest.mark.parametrize("fold", [False, True], ids=["unfolded", "fold"])
def test_grouped_plain_matches_per_bucket(fold):
    solver = _solver(F64, fold)
    s, v = _state(solver, F64, seed=2)
    f = solver._fold
    assert [g["names"] for g in solver._groups] == [["cs2f", "gm2", "gm2f"],
                                                    ["cs4f", "gm4"]]
    for g in solver._groups:
        s_new, w, y = fused_step_grouped_plain(s, v, solver.buckets, g, 1.5, cfg=CFG,
                                               fold=f)
        y_sum = torch.zeros_like(v)
        for name, (kind, floor) in zip(g["names"], g["kinds"]):
            want = fused_step_plain(*s[name], v, solver.buckets[name], kind, floor, 1.5,
                                    cfg=CFG, fold=f)
            for got, exp in zip(s_new[name] + w[name], want[:4]):
                assert torch.equal(got, exp), name
            y_sum = y_sum + want[4]
        np.testing.assert_allclose(y.numpy(), y_sum.numpy(), rtol=0, atol=1e-12)
        again = fused_step_grouped(s, v, solver.buckets, g, 1.5, cfg=CFG, fold=f)
        assert torch.equal(again[2], y)


def _ref_float64_step(sD, sL, v, arrs, kind, floor, alpha):
    """The fused step in float64 through the JAX package's plain projections
    (``ops/projection.py`` there), the relaxation and y in numpy: the
    reference's Pallas ``fused_step`` computes in float32 whatever its
    input dtype (its alpha, one-hot gather and y are float32), so float64
    is held against the same arithmetic in the reference's float64 code."""
    a = {k: np.asarray(x) for k, x in arrs.items()}
    ve = v[a["asset"]] * a["mask"]
    p, q = sD + ve, sL - ve
    if kind == "gm":
        D, L = ref_project_gm(p, q, a["R"], a["w"], a["s"], a["gamma"], a["logk0"],
                              a["k0"], a["mask"], needs_floor=floor, cfg=RefConfig())
    else:
        D, L = ref_project_cs(p, q, a["R"], a["gamma"], a["w"], a["k0"], a["mask"],
                              cfg=RefConfig())
    D, L = np.asarray(D), np.asarray(L)
    val = alpha * (L - D) + (1.0 - alpha) * (sL - sD)
    y = np.zeros(v.shape[0])
    np.add.at(y, a["asset"].reshape(-1), (val * a["mask"]).reshape(-1))
    return (alpha * D + (1.0 - alpha) * sD, alpha * L + (1.0 - alpha) * sL, D, L, y)


@pytest.mark.parametrize("dtype", [F32, F64], ids=["float32", "float64"])
def test_grouped_step_matches_jax_fused_step(dtype):
    """float32: the Pallas ``fused_step`` in interpret mode; float64: the
    same step through the reference's float64 projections."""
    jdt = jnp.float32 if dtype == F32 else jnp.float64
    atol = 2e-5 if dtype == F32 else 1e-10
    ref_compiled = ref_compile_table(ref_table(16, 150, seed=4, reserve_scale=1.0)[0],
                                     pad_pools_to=128, backend="numpy")
    ref_arrs = ref_admm._bucket_device_arrays(ref_compiled, jdt)
    solver = _solver(dtype, False)
    s, v = _state(solver, dtype, seed=3)
    for g in solver._groups:
        s_new, w, y = fused_step_grouped(s, v, solver.buckets, g, 1.5, cfg=CFG)
        y_ref = np.zeros(128)
        for name, (kind, floor) in zip(g["names"], g["kinds"]):
            if dtype == F32:
                want = _ref_step(jnp.asarray(s[name][0].numpy(), jdt),
                                 jnp.asarray(s[name][1].numpy(), jdt),
                                 jnp.asarray(v.numpy(), jdt), ref_arrs[name], kind=kind,
                                 needs_floor=floor, alpha=1.5, cfg=RefConfig(),
                                 interpret=True)
            else:
                want = _ref_float64_step(s[name][0].numpy(), s[name][1].numpy(),
                                         v.numpy(), ref_arrs[name], kind, floor, 1.5)
            for got, exp, label in zip(s_new[name] + w[name], want[:4],
                                       ("sD'", "sL'", "D", "L")):
                np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=atol,
                                           rtol=0, err_msg=f"{name} {label}")
            y_ref = y_ref + np.asarray(want[4], np.float64)
        np.testing.assert_allclose(y.numpy(), y_ref, atol=atol, rtol=1e-5)
