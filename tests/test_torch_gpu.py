"""CUDA kernels vs their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one: a CUDA kernel
has no CPU mode.  The file imports no JAX, so it also runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

Tolerances are the port's parity bars: atol 5e-5 (float32) and 1e-10
(float64) for a projection, 2e-5 (1e-10) for one fused step (plain or
delta), 2e-4 for a 20-step fused trajectory; y also gets rtol 1e-5.  The
fused steps' y is the same fixed-order segment sum in the kernel path and
the plain version, so with equal planes it is equal too.  The scenario-fold
variants (``fold=``) must equal their plain versions bit for bit, and a
folded solve run twice must give bitwise-equal results.
"""
import numpy as np
import pytest
import torch

from cfmm_routing_tpu_torch.models.reference_instances import arbitrage_instance
from cfmm_routing_tpu_torch.ops import _build
from cfmm_routing_tpu_torch.ops import projection as plain
from cfmm_routing_tpu_torch.ops.iteration_cuda import (
    fused_step, fused_step_delta, fused_step_delta_plain, fused_step_plain,
)
from cfmm_routing_tpu_torch.ops.projection_cuda import (
    project_cs_cuda, project_cs_delta_cuda, project_gm_cuda, project_gm_delta_cuda,
)
from cfmm_routing_tpu_torch.ops.projection_delta import (
    project_cs_delta, project_gm_delta,
)
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver
from cfmm_routing_tpu_torch.solver.compiler import compile_spec, compile_table
from cfmm_routing_tpu_torch.solver.fold import (
    fold_compiled, solve_batch_folded, solve_batch_reserves_folded,
)
from cfmm_routing_tpu_torch.solver.refine import to_host
from cfmm_routing_tpu_torch.solver.refine_device import (
    DeltaAdmmSolver, _delta_buckets_folded, refine_device,
)
from cfmm_routing_tpu_torch.utils.synth import (
    mixed_width_arbitrage, random_arbitrage_table,
)

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


def _delta_state(compiled, obj, dtype, device, seed):
    """Delta bucket arrays from a real base solve (DeltaAdmmSolver
    .delta_buckets, as refinement builds them) plus a random masked
    state and price vector."""
    base = AdmmSolver(compiled, device=device,
                      options=AdmmOptions(max_iters=200, check_every=25)).solve(obj)
    solver = DeltaAdmmSolver(compiled, dtype=dtype, device=device,
                             options=AdmmOptions(alpha=1.5, projection=CFG,
                                                 adapt_rho=False))
    nu0 = to_host(base).prices.astype(np.float32).astype(np.float64)
    bdict, min_x0 = solver.delta_buckets(to_host(base), 1e-3, nu0=nu0)
    assert min_x0 > 0
    rng = np.random.default_rng(seed)
    s = {}
    for name, arrs in bdict.items():
        mask = arrs["mask"].cpu().numpy()
        s[name] = tuple(torch.as_tensor(x * mask, dtype=dtype, device=device)
                        for x in rng.uniform(-2.0, 2.0, size=(2,) + mask.shape))
    v = torch.as_tensor(rng.normal(size=128), dtype=dtype, device=device)
    return solver, bdict, s, v


def _check_delta_projection(sD, sL, a, kind, floor, atol):
    """The standalone delta projection kernel vs its plain version."""
    if kind == "gm":
        args = (sD, sL, a["X0"], a["w"], a["sS"], a["gamma"], a["nsig"], a["aD"],
                a["aL"], a["mask"])
        got = project_gm_delta_cuda(*args, needs_floor=floor, cfg=CFG)
        want = project_gm_delta(*args, needs_floor=floor, cfg=CFG)
    else:
        args = (sD, sL, a["X0"], a["gamma"], a["w"], a["nsig"], a["aD"], a["aL"],
                a["mask"])
        got = project_cs_delta_cuda(*args, cfg=CFG)
        want = project_cs_delta(*args, cfg=CFG)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, atol=atol, rtol=0)


def _check_fused(got, want, atol):
    torch.cuda.synchronize()
    for a, b in zip(got[:4], want[:4]):
        torch.testing.assert_close(a, b, atol=atol, rtol=0)
    torch.testing.assert_close(got[4], want[4], atol=atol, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_step_delta_kernel_matches_plain(cuda_device, dtype):
    table, obj = random_arbitrage_table(16, 600, seed=4)
    solver, bdict, s, v = _delta_state(compile_table(table, pad_pools_to=128),
                                       obj, dtype, cuda_device, seed=3)
    atol = 2e-5 if dtype == torch.float32 else 1e-10
    before = _build.LAUNCHES["fused_step_delta"]
    for name, arrs in bdict.items():
        kind, floor = solver._meta[name]
        got = fused_step_delta(*s[name], v, arrs, kind, floor, 1.5, cfg=CFG)
        want = fused_step_delta_plain(*s[name], v, arrs, kind, floor, 1.5, cfg=CFG)
        _check_fused(got, want, atol)
        _check_delta_projection(*s[name], arrs, kind, floor, ATOL[dtype])
    assert _build.LAUNCHES["fused_step_delta"] - before == len(bdict)


@pytest.mark.parametrize("pad_pow2", [False, True])
def test_any_k_kernels_match_plain(cuda_device, pad_pow2):
    """Pools of 3, 5 and 12 assets: the run-time-K kernels (pad_pow2=False)
    and the register kernels at K = 4, 8, 16 (pad_pow2=True), every
    projection and fused-step kernel against its plain version in float32."""
    spec, obj = mixed_width_arbitrage(seed=2)
    compiled = compile_spec(spec, pad_pow2=pad_pow2, pad_pools_to=128)
    widths = {b.width for b in compiled.buckets.values()}
    assert widths == ({4, 8, 16} if pad_pow2 else {3, 5, 12})
    solver, s, v = _state(compiled, torch.float32, cuda_device, seed=5)
    dsolver, bdict, ds, dv = _delta_state(compiled, obj, torch.float32,
                                          cuda_device, seed=6)
    for name, arrs in solver.buckets.items():
        kind, floor = solver._meta[name]
        sD, sL = s[name]
        if kind == "gm":
            args = (arrs["R"], arrs["w"], arrs["s"], arrs["gamma"],
                    arrs["logk0"], arrs["k0"], arrs["mask"])
            got = project_gm_cuda(sD, sL, *args, needs_floor=floor, cfg=CFG)
            want = plain.project_gm(sD, sL, *args, needs_floor=floor, cfg=CFG)
        else:
            cs = (arrs["R"], arrs["gamma"], arrs["w"], arrs["k0"], arrs["mask"])
            got = project_cs_cuda(sD, sL, *cs, cfg=CFG)
            want = plain.project_cs(sD, sL, *cs, cfg=CFG)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=ATOL[torch.float32], rtol=0)
        _check_fused(fused_step(sD, sL, v, arrs, kind, floor, 1.5, cfg=CFG),
                     fused_step_plain(sD, sL, v, arrs, kind, floor, 1.5, cfg=CFG),
                     2e-5)
        darrs = bdict[name]
        _check_delta_projection(*ds[name], darrs, kind, floor, ATOL[torch.float32])
        _check_fused(
            fused_step_delta(*ds[name], dv, darrs, kind, floor, 1.5, cfg=CFG),
            fused_step_delta_plain(*ds[name], dv, darrs, kind, floor, 1.5, cfg=CFG),
            2e-5,
        )


def test_two_runs_are_bitwise_equal(cuda_device):
    """The consensus sums are fixed-order segment sums: two fused solves
    and two classic solves give bitwise-equal results."""
    table, obj = random_arbitrage_table(64, 3000, seed=8)
    compiled = compile_table(table, pad_pools_to=128)
    solver = AdmmSolver(compiled, device=cuda_device,
                        options=AdmmOptions(max_iters=50, eps_abs=0.0, eps_rel=0.0))
    for run in (lambda: solver.solve_fused(obj, iters=60), lambda: solver.solve(obj)):
        a, b = run(), run()
        for x, y in zip((a.objective, a.psi, a.prices), (b.objective, b.psi, b.prices)):
            assert torch.equal(x, y)
        for name in compiled.buckets:
            assert torch.equal(a.deltas[name], b.deltas[name])
            assert torch.equal(a.lambdas[name], b.lambdas[name])


def test_refine_device_fused_certifies_arbitrage(cuda_device, monkeypatch):
    spec, obj = arbitrage_instance()
    compiled = compile_spec(spec, pad_pools_to=128)
    base = AdmmSolver(compiled, device=cuda_device, options=AdmmOptions(
        max_iters=6000, eps_abs=2e-6, eps_rel=2e-6)).solve(obj)
    calls = []
    solve_delta = DeltaAdmmSolver.solve_delta

    def counted(self, *a, **k):
        res = solve_delta(self, *a, **k)
        calls.append(int(res.iters) - 1)  # fused iterations of this chunk
        return res

    monkeypatch.setattr(DeltaAdmmSolver, "solve_delta", counted)
    _build.reset_launch_counts()
    out = refine_device(compiled, obj, base, target_gap=1e-7, fused=True)
    assert out.achieved, out.certificate.summary()
    assert abs(out.certificate.objective - 21.499805) / 21.499805 < 2e-6
    assert _build.LAUNCHES["fused_step_delta"] == len(compiled.buckets) * sum(calls) > 0


def _fold_case(dtype, device, T=3, seed=6):
    """A T-point fold of a 128-padded network (padding slots in every
    point), its delta arrays, a random state and a price vector."""
    table, _ = random_arbitrage_table(16, 300, seed=4, reserve_scale=1.0)
    compiled = compile_table(table, pad_pools_to=128)
    n = compiled.n_assets
    solver = AdmmSolver(fold_compiled(compiled, T), dtype=dtype, device=device,
                        fold=(T, n), options=AdmmOptions(projection=CFG))
    rng = np.random.default_rng(seed)
    trades = {k: 0.01 * rng.uniform(0, 1, (T, b.width, b.m)) * b.mask.T[None]
              for k, b in compiled.buckets.items()}
    dbk, min_x0 = _delta_buckets_folded(solver, trades, trades,
                                        rng.uniform(1e-3, 1e-2, T),
                                        rng.uniform(0.5, 2.0, (T, n)))
    assert (min_x0 > 0).all()
    s = {}
    for name, arrs in solver.buckets.items():
        mask = arrs["mask"].cpu().numpy()
        s[name] = tuple(torch.as_tensor(x * mask, dtype=dtype, device=device)
                        for x in rng.uniform(-2.0, 2.0, size=(2,) + mask.shape))
    v = torch.as_tensor(rng.normal(size=128), dtype=dtype, device=device)
    return solver, dbk, s, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fold_kernels_match_plain_bitwise(cuda_device, dtype):
    solver, dbk, s, v = _fold_case(dtype, cuda_device)
    _build.reset_launch_counts()
    for name, arrs in solver.buckets.items():
        kind, floor = solver._meta[name]
        for kfn, pfn, a in ((fused_step, fused_step_plain, arrs),
                            (fused_step_delta, fused_step_delta_plain, dbk[name])):
            got = kfn(*s[name], v, a, kind, floor, 1.5, cfg=CFG, fold=solver._fold)
            want = pfn(*s[name], v, a, kind, floor, 1.5, cfg=CFG, fold=solver._fold)
            for x, y in zip(got, want):
                assert torch.equal(x, y), (kfn.__name__, name)
    n_buckets = len(solver.buckets)
    assert _build.LAUNCHES["fused_step_fold"] == n_buckets
    assert _build.LAUNCHES["fused_step_delta_fold"] == n_buckets


def test_misaligned_fold_raises(cuda_device):
    """Points of 64 pools cannot be tiled by 128-pool blocks: the wrappers
    raise instead of falling back to a plain version."""
    table, _ = random_arbitrage_table(16, 300, seed=4, reserve_scale=1.0)
    compiled = compile_table(table, pad_pools_to=64)
    solver = AdmmSolver(fold_compiled(compiled, 2), device=cuda_device,
                        fold=(2, compiled.n_assets))
    arrs = solver.buckets["gm4"]
    assert arrs["mask"].shape[1] == 128
    sD = torch.zeros_like(arrs["mask"])
    v = torch.zeros(128, device=cuda_device)
    for fn in (fused_step, fused_step_delta):
        with pytest.raises(ValueError, match="multiple of 128"):
            fn(sD, sD, v, arrs, "gm", False, 1.0, fold=solver._fold)


def test_folded_solves_twice_are_bitwise_equal(cuda_device):
    table, obj = random_arbitrage_table(64, 3000, seed=8)
    compiled = compile_table(table, pad_pools_to=128)
    opts = AdmmOptions(max_iters=60, eps_abs=0.0, eps_rel=0.0, adapt_rho=False)
    c = np.asarray(obj.c)[None, :] * np.array([[0.9], [1.0], [1.1]])
    lo = np.tile(np.maximum(obj.lo, -3e38), (3, 1))
    hi = np.full_like(c, 3e38)
    scale = np.random.default_rng(2).uniform(0.7, 1.3, (3, compiled.n_pools))
    # two driver chunks of 29 fused + 1 classic; 59 fused + 1 classic
    for fused_iters, run in (
            (58, lambda: solve_batch_folded(compiled, c, lo, hi, options=opts, chunk=30)),
            (59, lambda: solve_batch_reserves_folded(compiled, obj, scale, options=opts,
                                                     n_iters=59))):
        _build.reset_launch_counts()
        a = run()
        assert _build.LAUNCHES["fused_step_fold"] == fused_iters * len(compiled.buckets)
        b = run()
        for x, y in zip((a.objective, a.psi, a.prices), (b.objective, b.psi, b.prices)):
            assert np.array_equal(x, y)
        for name in compiled.buckets:
            assert np.array_equal(a.deltas[name], b.deltas[name])
            assert np.array_equal(a.lambdas[name], b.lambdas[name])
