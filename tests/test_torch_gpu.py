"""CUDA kernels vs their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one: a CUDA kernel
has no CPU mode.  The file imports no JAX, so it also runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

Tolerances are the port's parity bars: atol 5e-5 (float32) and 1e-10
(float64) for a projection, 2e-5 (1e-10) for one fused step, 2e-4 for a 20-step
fused trajectory.  The fused step's y sums many slots per asset with
atomics, in another order than ``index_add_``, so y also gets rtol 1e-5
(float32 roundoff of a sum of up to thousands of terms).
"""
import numpy as np
import pytest
import torch

from cfmm_routing_tpu_torch.ops import _build
from cfmm_routing_tpu_torch.ops import projection as plain
from cfmm_routing_tpu_torch.ops.iteration_cuda import fused_step, fused_step_plain
from cfmm_routing_tpu_torch.ops.projection_cuda import project_cs_cuda, project_gm_cuda
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver
from cfmm_routing_tpu_torch.solver.compiler import compile_table
from cfmm_routing_tpu_torch.utils.synth import random_arbitrage_table

pytestmark = pytest.mark.gpu

CFG = plain.ProjectionConfig(48, 6)
ATOL = {torch.float32: 5e-5, torch.float64: 1e-10}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _state(compiled, dtype, device, seed):
    """A solver plus a random, nonzero, masked fused state."""
    solver = AdmmSolver(compiled, dtype=dtype, device=device,
                        options=AdmmOptions(alpha=1.5, projection=CFG))
    rng = np.random.default_rng(seed)
    s = {}
    for name, arrs in solver.buckets.items():
        K, m = arrs["mask"].shape
        planes = rng.uniform(-2.0, 2.0, size=(2, K, m))
        mask = arrs["mask"].cpu().numpy()
        s[name] = tuple(torch.as_tensor(x * mask, dtype=dtype, device=device)
                        for x in planes)
    v = torch.as_tensor(rng.normal(size=128), dtype=dtype, device=device)
    return solver, s, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_projection_kernels_match_plain(cuda_device, dtype):
    table, _ = random_arbitrage_table(16, 600, seed=4)
    solver, s, v = _state(compile_table(table, pad_pools_to=128), dtype,
                          cuda_device, seed=1)
    before = dict(_build.LAUNCHES)
    for name, arrs in solver.buckets.items():
        kind, floor = solver._meta[name]
        sD, sL = s[name]
        args = (arrs["R"], arrs["w"], arrs["s"], arrs["gamma"], arrs["logk0"],
                arrs["k0"], arrs["mask"])
        if kind == "gm":
            got = project_gm_cuda(sD, sL, *args, needs_floor=floor, cfg=CFG)
            want = plain.project_gm(sD, sL, *args, needs_floor=floor, cfg=CFG)
        else:
            cs = (arrs["R"], arrs["gamma"], arrs["w"], arrs["k0"], arrs["mask"])
            got = project_cs_cuda(sD, sL, *cs, cfg=CFG)
            want = plain.project_cs(sD, sL, *cs, cfg=CFG)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=ATOL[dtype], rtol=0)
    n_gm = sum(k == "gm" for k, _ in solver._meta.values())
    assert _build.LAUNCHES["project_gm"] - before["project_gm"] == n_gm
    assert _build.LAUNCHES["project_cs"] - before["project_cs"] == len(solver._meta) - n_gm


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_step_kernel_matches_plain(cuda_device, dtype):
    table, _ = random_arbitrage_table(16, 600, seed=4)
    solver, s, v = _state(compile_table(table, pad_pools_to=128), dtype,
                          cuda_device, seed=2)
    atol = 2e-5 if dtype == torch.float32 else 1e-10
    for name, arrs in solver.buckets.items():
        kind, floor = solver._meta[name]
        sD, sL = s[name]
        got = fused_step(sD, sL, v, arrs, kind, floor, 1.5, cfg=CFG)
        want = fused_step_plain(sD, sL, v, arrs, kind, floor, 1.5, cfg=CFG)
        torch.cuda.synchronize()
        for a, b in zip(got[:4], want[:4]):
            torch.testing.assert_close(a, b, atol=atol, rtol=0)
        torch.testing.assert_close(got[4], want[4], atol=atol, rtol=1e-5)


def test_fused_trajectory_card_matches_cpu(cuda_device):
    # unit-scale reserves: trades of order 1, so atol 2e-4 is far above
    # float32 roundoff (at the default scale of 100, psi reaches ~1e3)
    table, obj = random_arbitrage_table(32, 700, seed=6, reserve_scale=1.0)
    compiled = compile_table(table, pad_pools_to=128)
    opts = AdmmOptions(max_iters=21, eps_abs=0.0, eps_rel=0.0, adapt_rho=False)
    on_card = AdmmSolver(compiled, options=opts, device=cuda_device)
    on_cpu = AdmmSolver(compiled, options=opts, device="cpu")
    _build.reset_launch_counts()
    res_card = on_card.solve_fused(obj, iters=20)
    assert _build.LAUNCHES["fused_step"] == 20 * len(compiled.buckets)
    res_cpu = on_cpu.solve_fused(obj, iters=20)
    np.testing.assert_allclose(res_card.psi.cpu().numpy(), res_cpu.psi.numpy(),
                               atol=2e-4, rtol=0)
    np.testing.assert_allclose(float(res_card.objective), float(res_cpu.objective),
                               rtol=1e-4)
