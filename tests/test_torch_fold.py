"""Scenario folds, the chunked driver and the infeasibility certificate: the
port against the JAX package on the CPU.

* ``fold_compiled`` (plain and with ``reserve_scale``) gives bucket arrays
  bit-identical to the reference's; ``fold_planes``/``unfold_planes``
  round-trip.
* The plain fold versions of both fused kernels (what the CUDA kernels are
  held against on the card) match the reference Pallas kernels in interpret
  mode with ``fold=(2, 16)``, on three buckets of a 300-pool / 16-asset
  network padded to 256 pools per point, so both points carry padding
  slots: atol 2e-5 on the planes, and on y (unpacked from each package's
  price layout) also rtol 1e-5.  A fold whose points are not 128-aligned
  raises ``ValueError``, on the CPU as on the card.

The folded solves are in ``tests/test_torch_batch.py``; ``ChunkedDriver``
is in ``tests/test_torch_driver.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfmm_routing_tpu.ops.iteration_pallas import fused_step as ref_fused_step
from cfmm_routing_tpu.ops.iteration_pallas import fused_step_delta as ref_fused_delta
from cfmm_routing_tpu.ops.projection import ProjectionConfig as RefConfig
from cfmm_routing_tpu.solver import admm as ref_admm
from cfmm_routing_tpu.solver import fold as ref_fold
from cfmm_routing_tpu.solver import refine_device as ref_rd
from cfmm_routing_tpu.solver.compiler import compile_table as ref_compile_table
from cfmm_routing_tpu.utils.synth import random_arbitrage_table as ref_table
from cfmm_routing_tpu_torch.ops.iteration_cuda import (
    fused_step, fused_step_delta, fused_step_delta_plain, fused_step_plain,
)
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver
from cfmm_routing_tpu_torch.solver.compiler import compile_table
from cfmm_routing_tpu_torch.solver.driver import ChunkedDriver
from cfmm_routing_tpu_torch.solver.fold import (
    fold_compiled, fold_planes, folded_solver, unfold_planes,
)
from cfmm_routing_tpu_torch.solver.refine_device import (
    DeltaAdmmSolver, _delta_buckets_folded,
)
from cfmm_routing_tpu_torch.utils.synth import random_arbitrage_table

torch.set_num_threads(1)

# a floored geo-mean, a K = 4 geo-mean and a constant-sum bucket: the three
# projections and both pool widths (the card checks all five, phase 6a)
NAMES = ["gm2f", "gm4", "cs4f"]
FOLD = (2, 16)
_BUCKET_FIELDS = ("reserves", "weights", "shift", "gamma", "logk0", "k0", "mask",
                  "asset", "pool_ids")
_ref_step = jax.jit(ref_fused_step, static_argnames=(
    "kind", "needs_floor", "alpha", "cfg", "interpret", "fold"))
_ref_delta_step = jax.jit(ref_fused_delta, static_argnames=(
    "kind", "needs_floor", "alpha", "cfg", "interpret", "fold"))


def _compiled_pair():
    table, _ = random_arbitrage_table(16, 300, seed=4, reserve_scale=1.0)
    ref = ref_compile_table(ref_table(16, 300, seed=4, reserve_scale=1.0)[0],
                            pad_pools_to=256, backend="numpy")
    return compile_table(table, pad_pools_to=256, backend="numpy"), ref


@pytest.mark.parametrize("scaled", [False, True])
def test_fold_compiled_is_bit_identical(scaled):
    compiled, ref = _compiled_pair()
    scale = (np.random.default_rng(9).uniform(0.7, 1.3, (3, compiled.n_pools))
             if scaled else None)
    got = fold_compiled(compiled, 3, scale)
    want = ref_fold.fold_compiled(ref, 3, scale)
    assert (got.n_assets, got.n_pools, got.n_slots) == (
        want.n_assets, want.n_pools, want.n_slots)
    np.testing.assert_array_equal(got.degree, want.degree)
    np.testing.assert_array_equal(got.widths, want.widths)
    assert got.buckets.keys() == want.buckets.keys()
    for name, b in got.buckets.items():
        w = want.buckets[name]
        assert (b.kind, b.width, b.needs_floor) == (w.kind, w.width, w.needs_floor)
        for field in _BUCKET_FIELDS:
            np.testing.assert_array_equal(getattr(b, field), getattr(w, field),
                                          err_msg=f"{name}.{field}")


def test_fold_planes_roundtrip():
    rng = np.random.default_rng(0)
    planes = {"a": rng.standard_normal((4, 2, 256)),
              "b": rng.standard_normal((4, 4, 128))}
    back = unfold_planes(fold_planes(planes), 4)
    for k in planes:
        np.testing.assert_array_equal(back[k], planes[k])


@pytest.fixture(scope="module")
def fold_case():
    """Both packages' folded solvers and folded delta arrays for T = 2, a
    random state, and one price vector in each package's layout."""
    compiled, ref = _compiled_pair()
    T, n = FOLD
    opts = AdmmOptions(adapt_rho=False)
    ref_opts = ref_admm.AdmmOptions(adapt_rho=False)
    port = AdmmSolver(fold_compiled(compiled, T), dtype=torch.float32,
                      device="cpu", fold=FOLD)
    ref_arrs = ref_admm._bucket_device_arrays(ref_fold.fold_compiled(ref, T),
                                             jnp.float32)
    dport, _ = folded_solver(compiled, T, opts, torch.float32,
                             cls=DeltaAdmmSolver, device="cpu")
    dref, _ = ref_fold.folded_solver(ref, T, ref_opts, jnp.float32,
                                     cls=ref_rd.DeltaAdmmSolver)
    rng = np.random.default_rng(12)
    # small base trades (post-trade reserves stay positive), per point
    deltas, lambdas = {}, {}
    for name, b in compiled.buckets.items():
        mask = b.mask.T[None]
        deltas[name] = 0.01 * rng.uniform(0, 1, (T,) + mask.shape[1:]) * mask
        lambdas[name] = 0.01 * rng.uniform(0, 1, (T,) + mask.shape[1:]) * mask
    eps = np.array([1e-2, 3e-2])
    nu0f = rng.uniform(0.5, 2.0, (T, n)).astype(np.float32).astype(np.float64)
    d_port, min_port = _delta_buckets_folded(dport, deltas, lambdas, eps, nu0f)
    d_ref, min_ref = ref_rd._delta_buckets_folded(dref, deltas, lambdas, eps, nu0f)
    np.testing.assert_allclose(min_port, min_ref, rtol=1e-12)
    state = {}
    for name, b in port.compiled.buckets.items():
        mask = b.mask.T
        state[name] = (rng.uniform(-0.5, 0.5, mask.shape) * mask,
                       rng.uniform(-0.5, 0.5, mask.shape) * mask)
    v_pt = 0.3 * rng.normal(size=(T, n))
    v_ref = np.zeros((T, 1024))  # the reference's per-point 1024-value blocks
    v_ref[:, :n] = v_pt
    v_port = np.zeros(128)  # the port's layout: stride n, padded once
    v_port[: T * n] = v_pt.reshape(-1)
    return dict(port=port, ref_arrs=ref_arrs, d_port=d_port, d_ref=d_ref,
                state=state, v_ref=v_ref.reshape(-1), v_port=v_port,
                compiled=port.compiled)


@pytest.mark.parametrize("kernel", ["fused_step", "fused_step_delta"])
@pytest.mark.parametrize("name", NAMES)
def test_fold_kernels_match_reference(fold_case, name, kernel):
    b = fold_case["compiled"].buckets[name]
    assert b.m == 512 and (b.mask[256:] == 0).any()  # point t = 1 has padding
    sD, sL = fold_case["state"][name]
    f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    t32 = lambda x: torch.as_tensor(x, dtype=torch.float32)  # noqa: E731
    if kernel == "fused_step":
        ref_fn, port_fn = _ref_step, fused_step_plain
        ref_arrs, port_arrs = fold_case["ref_arrs"][name], fold_case["port"].buckets[name]
    else:
        ref_fn, port_fn = _ref_delta_step, fused_step_delta_plain
        ref_arrs, port_arrs = fold_case["d_ref"][name], fold_case["d_port"][name]
    want = ref_fn(f32(sD), f32(sL), f32(fold_case["v_ref"]), ref_arrs, kind=b.kind,
                  needs_floor=b.needs_floor, alpha=1.5, cfg=RefConfig(),
                  interpret=True, fold=FOLD)
    got = port_fn(t32(sD), t32(sL), t32(fold_case["v_port"]), port_arrs, b.kind,
                  b.needs_floor, 1.5, fold=FOLD)
    for g, w, label in zip(got[:4], want[:4], ("sD'", "sL'", "D", "L")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   err_msg=f"{kernel} {name} {label}")
    T, n = FOLD
    y_ref = np.asarray(want[4]).reshape(T, -1)[:, :n].reshape(-1)
    np.testing.assert_allclose(got[4][: T * n].numpy(), y_ref, atol=2e-5,
                               rtol=1e-5, err_msg=f"{kernel} {name} y")
    assert not got[4][T * n:].any()


def test_misaligned_fold_raises():
    table, _ = random_arbitrage_table(16, 300, seed=4, reserve_scale=1.0)
    compiled = compile_table(table, pad_pools_to=64)  # 64 pools per point
    solver = AdmmSolver(fold_compiled(compiled, 2), device="cpu", fold=FOLD)
    arrs = solver.buckets["gm4"]
    assert arrs["mask"].shape[1] == 128
    sD = torch.zeros_like(arrs["mask"])
    for fn in (fused_step, fused_step_plain, fused_step_delta):
        with pytest.raises(ValueError, match="multiple of 128"):
            fn(sD, sD, torch.zeros(128), arrs, "gm", False, 1.0, fold=FOLD)
    with pytest.raises(ValueError, match="multiple of 128"):
        ChunkedDriver(solver, chunk=5, fused=True)
