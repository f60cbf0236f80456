"""Port projections vs the JAX package's ``ops/projection.py``.

The same numpy inputs (made from a seed, as in ``tests/test_pallas.py``)
go through the reference jnp projections and the port's plain PyTorch
projections on the CPU, in float32 (atol 5e-5, the reference's own
Pallas-vs-jnp bar) and float64 (atol 1e-10).  The CUDA kernels are held
against the same plain versions by ``tests/test_torch_gpu.py`` (skips
without a card) and by ``chip_smoke.py`` at full width.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cfmm_routing_tpu.ops import projection as ref_proj
from cfmm_routing_tpu_torch.ops import _build
from cfmm_routing_tpu_torch.ops import projection as port_proj
from cfmm_routing_tpu_torch.ops.projection_cuda import project_cs_cuda, project_gm_cuda

torch.set_num_threads(1)

CFG_REF = ref_proj.ProjectionConfig(n_bisect=48, n_polish=6)
CFG = port_proj.ProjectionConfig(n_bisect=48, n_polish=6)
M = 256
ATOL = {np.float32: 5e-5, np.float64: 1e-10}


def _gm_batch(seed, K, m=M, shifted=False):
    rng = np.random.default_rng(seed)
    R = rng.uniform(0.3, 40.0, size=(K, m))
    w = rng.uniform(0.5, 4.0, size=(K, m))
    mask = np.ones((K, m))
    # ~1/4 of pools use only 2 of the K slots (padding path)
    if K > 2:
        pad = rng.random(m) < 0.25
        mask[2:, pad] = 0.0
        w[2:, pad] = 0.0
        R[2:, pad] = 1.0
    w = w / np.maximum(w.sum(axis=0, keepdims=True), 1e-30)
    s = rng.uniform(0.5, 10.0, size=(K, m)) * mask if shifted else np.zeros((K, m))
    gamma = rng.uniform(0.9, 1.0, size=m)
    p = rng.uniform(-6, 6, size=(K, m)) * mask
    q = rng.uniform(-6, 6, size=(K, m)) * mask
    logk0 = np.sum(w * np.log(R + s), axis=0, where=mask > 0)
    return (p, q, R, w, s, gamma, logk0, np.exp(logk0), mask)


def _cs_batch(seed, K, weighted):
    rng = np.random.default_rng(seed)
    R = rng.uniform(0.3, 30.0, size=(K, M))
    w = rng.uniform(0.25, 4.0, size=(K, M)) if weighted else np.ones((K, M))
    mask = np.ones((K, M))
    gamma = rng.uniform(0.9, 1.0, size=M)
    p = rng.uniform(-8, 8, size=(K, M))
    q = rng.uniform(-8, 8, size=(K, M))
    k0 = (w * R).sum(axis=0)
    return (p, q, R, gamma, w, k0, mask)


def _both(args, dtype):
    ref = tuple(jnp.asarray(a, dtype) for a in args)
    port = tuple(torch.as_tensor(np.asarray(a, dtype)) for a in args)
    return ref, port


def _close(port_out, ref_out, dtype):
    for a, b in zip(port_out, ref_out):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed,K,floor", [(0, 2, False), (1, 3, False),
                                          (2, 4, False), (3, 2, True)])
def test_gm_matches_reference(seed, K, floor, dtype):
    ref, port = _both(_gm_batch(seed, K, shifted=floor), dtype)
    _close(
        port_proj.project_gm(*port, needs_floor=floor, cfg=CFG),
        ref_proj.project_gm(*ref, needs_floor=floor, cfg=CFG_REF),
        dtype,
    )


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed,K,weighted", [(5, 2, False), (6, 3, False),
                                             (11, 2, True)])
def test_cs_matches_reference(seed, K, weighted, dtype):
    ref, port = _both(_cs_batch(seed, K, weighted), dtype)
    _close(
        port_proj.project_cs(*port, cfg=CFG),
        ref_proj.project_cs(*ref, cfg=CFG_REF),
        dtype,
    )


def test_wrappers_run_plain_version_on_cpu_tensors():
    """On CPU tensors the kernel wrappers are the plain versions (same
    numbers) and launch nothing."""
    _build.reset_launch_counts()
    _, gm = _both(_gm_batch(7, 4), np.float32)
    _, cs = _both(_cs_batch(8, 2, True), np.float32)
    for a, b in zip(project_gm_cuda(*gm, cfg=CFG), port_proj.project_gm(*gm, cfg=CFG)):
        assert torch.equal(a, b)
    for a, b in zip(project_cs_cuda(*cs, cfg=CFG), port_proj.project_cs(*cs, cfg=CFG)):
        assert torch.equal(a, b)
    assert set(_build.LAUNCHES) == {
        "project_gm", "project_cs", "project_gm_delta", "project_cs_delta",
        "fused_step", "fused_step_delta", "fused_step_fold",
        "fused_step_delta_fold", "segment_sum"}
    assert all(n == 0 for n in _build.LAUNCHES.values())

