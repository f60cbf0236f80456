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
variants (``fold=``), the merged K-group step (``fused_step_merged``) and
the grouped kernels (``project_grouped``, ``fused_step_grouped``,
``fused_step_delta_grouped``, ``project_delta_grouped``: one launch per
group of buckets with the same K, one lane per slot up to K = 32, one
thread per pool above) must equal their plain versions bit for bit, and a
folded, merged or refined solve run twice must give bitwise-equal results.
"""
import numpy as np
import pytest
import torch

from cfmm_routing_tpu_torch.models.reference_instances import arbitrage_instance
from cfmm_routing_tpu_torch.models.utility import ConcaveUtility, Objective
from cfmm_routing_tpu_torch.ops import _build
from cfmm_routing_tpu_torch.ops import projection as plain
from cfmm_routing_tpu_torch.ops.iteration_cuda import (
    fused_step, fused_step_delta, fused_step_delta_grouped,
    fused_step_delta_grouped_plain, fused_step_delta_plain, fused_step_grouped,
    fused_step_grouped_plain, fused_step_merged, fused_step_merged_plain,
    fused_step_plain,
)
from cfmm_routing_tpu_torch.ops.projection_cuda import (
    project_cs_cuda, project_cs_delta_cuda, project_delta_grouped,
    project_delta_grouped_plain, project_gm_cuda, project_gm_delta_cuda,
    project_grouped, project_grouped_plain,
)
from cfmm_routing_tpu_torch.ops.projection_delta import (
    project_cs_delta, project_gm_delta,
)
from cfmm_routing_tpu_torch.ops.segment import (
    segment_sum, segment_sum_plain, slot_order,
)
from cfmm_routing_tpu_torch.solver import graphs
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver
from cfmm_routing_tpu_torch.solver.driver import ChunkedDriver
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
    """The per-bucket wrappers, each a grouped launch on a group of one:
    bitwise equal to the plain version, one ``project`` launch a bucket."""
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
            assert torch.equal(a, b), name
    assert _build.LAUNCHES["project"] - before["project"] == len(solver._meta)


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
    assert _build.LAUNCHES["fused_step"] == 20 * len(on_card._groups)
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
    groups = len({b.width for b in compiled.buckets.values()})  # one per K
    assert _build.LAUNCHES["fused_step_delta"] == groups * sum(calls) > 0
    again = refine_device(compiled, obj, base, target_gap=1e-7, fused=True)
    assert np.array_equal(again.result.psi, out.result.psi)
    assert np.array_equal(again.result.prices, out.result.prices)


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
        n_groups = len({b.width for b in compiled.buckets.values()})
        assert _build.LAUNCHES["fused_step_fold"] == fused_iters * n_groups
        b = run()
        for x, y in zip((a.objective, a.psi, a.prices), (b.objective, b.psi, b.prices)):
            assert np.array_equal(x, y)
        for name in compiled.buckets:
            assert np.array_equal(a.deltas[name], b.deltas[name])
            assert np.array_equal(a.lambdas[name], b.lambdas[name])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_merged_kernel_matches_plain_bitwise(cuda_device, dtype):
    """One launch per K-group (K=2: cs2f+gm2+gm2f, K=4: cs4f+gm4), bitwise
    equal to the plain version, and twice the same; then merged groups at
    K = 3, 5, 12 (4, 8, 16 lanes, idle lanes masked), 4, 8, 16 and 40 (one
    thread per pool), each of three class spans."""
    table, _ = random_arbitrage_table(16, 300, seed=4, reserve_scale=1.0)
    networks = [(compile_table(table, pad_pools_to=1024), [2, 4])]
    for widths, pad_pow2, want_k in (((3, 5, 12), False, [3, 5, 12]),
                                     ((3, 5, 12), True, [4, 8, 16]),
                                     ((40,), False, [40])):
        spec, _ = mixed_width_arbitrage(widths=widths, n_assets=48 if 40 in widths else 16,
                                        seed=2)
        networks.append((compile_spec(spec, pad_pow2=pad_pow2, pad_pools_to=128), want_k))
    for compiled, want_k in networks:
        solver, s, v = _state(compiled, dtype, cuda_device, seed=3)
        groups = solver._merged_groups()
        assert [g["K"] for g in groups] == want_k
        sm = solver._merge_state(s, groups)
        _build.reset_launch_counts()
        for g, (sD, sL) in zip(groups, sm):
            got = fused_step_merged(sD, sL, v, g["arrs"], 1.5, cfg=CFG)
            again = fused_step_merged(sD, sL, v, g["arrs"], 1.5, cfg=CFG)
            want = fused_step_merged_plain(sD, sL, v, g["arrs"], 1.5, cfg=CFG)
            for x, y, z in zip(got, again, want):
                assert torch.equal(x, y) and torch.equal(x, z), (g["K"], g["names"])
        assert _build.LAUNCHES["fused_step_merged"] == 2 * len(groups)
        assert _build.LAUNCHES["fused_step"] == 0


def test_merged_solve_matches_unmerged_on_card(cuda_device):
    """solve_fused(merged=True) on the card: 2 launches per iteration, the
    unmerged solve's result to float32 rounding (the consensus terms are
    added in another order), bitwise equal to itself; also with a concave
    utility."""
    table, obj = random_arbitrage_table(16, 300, seed=4, reserve_scale=1.0)
    compiled = compile_table(table, pad_pools_to=1024)
    solver = AdmmSolver(compiled, device=cuda_device, options=AdmmOptions(
        max_iters=21, eps_abs=0.0, eps_rel=0.0, adapt_rho=False))
    util = ConcaveUtility.linear(obj.c, lo=obj.lo, hi=obj.hi).with_log(1, c=1.0, b=2.0)
    for objective in (obj, util):
        _build.reset_launch_counts()
        a = solver.solve_fused(objective, iters=20, merged=True)
        assert _build.LAUNCHES["fused_step_merged"] == 40
        assert _build.LAUNCHES["fused_step"] == 0
        b = solver.solve_fused(objective, iters=20, merged=True)
        c = solver.solve_fused(objective, iters=20)
        assert torch.equal(a.psi, b.psi) and torch.equal(a.prices, b.prices)
        np.testing.assert_allclose(a.psi.cpu().numpy(), c.psi.cpu().numpy(),
                                   atol=2e-4, rtol=0)
        np.testing.assert_allclose(float(a.objective), float(c.objective), rtol=1e-5)


def _check_grouped(solver, bdict, s, v, fold=None):
    """Every group of ``solver._groups``: the grouped fused delta step
    and the grouped delta projection bitwise equal to their plain versions,
    and a second launch bitwise equal to the first.  Returns the number of
    groups."""
    groups = solver._groups
    for g in groups:
        runs = [fused_step_delta_grouped(s, v, bdict, g, 1.5, cfg=CFG, fold=fold)
                for _ in range(2)]
        want = fused_step_delta_grouped_plain(s, v, bdict, g, 1.5, cfg=CFG, fold=fold)
        pin = {name: (sD + 0.25, sL - 0.25) for name, (sD, sL) in s.items()}
        runs += [project_delta_grouped(pin, bdict, g, cfg=CFG) for _ in range(2)]
        want_p = project_delta_grouped_plain(pin, bdict, g, cfg=CFG)
        torch.cuda.synchronize()
        for got in runs[:2]:
            for name in g["names"]:
                for i in range(2):
                    assert torch.equal(got[0][name][i], want[0][name][i]), (g["names"], name)
                    assert torch.equal(got[1][name][i], want[1][name][i]), (g["names"], name)
            assert torch.equal(got[2], want[2]), g["names"]
        for got in runs[2:]:
            for name in g["names"]:
                for i in range(2):
                    assert torch.equal(got[name][i], want_p[name][i]), (g["names"], name)
    return len(groups)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_grouped_delta_kernels_match_plain_bitwise(cuda_device, dtype):
    """K=2 (cs2f, gm2, gm2f) and K=4 (cs4f, gm4): one grouped launch per
    group, bitwise equal to the plain grouped versions and to themselves;
    then the same on a T=2 fold (points of 128 and 256 pools)."""
    table, obj = random_arbitrage_table(16, 300, seed=4, reserve_scale=1.0)
    compiled = compile_table(table, pad_pools_to=128)
    solver, bdict, s, v = _delta_state(compiled, obj, dtype, cuda_device, seed=7)
    assert [g["names"] for g in solver._groups] == [["cs2f", "gm2", "gm2f"],
                                                           ["cs4f", "gm4"]]
    _build.reset_launch_counts()
    n = _check_grouped(solver, bdict, s, v)
    assert _build.LAUNCHES["fused_step_delta"] == 2 * n
    assert _build.LAUNCHES["project_delta"] == 2 * n

    T, nA = 2, compiled.n_assets
    fsolver = DeltaAdmmSolver(fold_compiled(compiled, T), dtype=dtype, device=cuda_device,
                              fold=(T, nA), options=AdmmOptions(projection=CFG))
    rng = np.random.default_rng(8)
    trades = {k: 0.01 * rng.uniform(0, 1, (T, b.width, b.m)) * b.mask.T[None]
              for k, b in compiled.buckets.items()}
    fb, min_x0 = _delta_buckets_folded(fsolver, trades, trades,
                                       rng.uniform(1e-3, 1e-2, T),
                                       rng.uniform(0.5, 2.0, (T, nA)))
    assert (min_x0 > 0).all()
    fs = {name: tuple(torch.as_tensor(x, dtype=dtype, device=cuda_device) * a["mask"]
                      for x in rng.uniform(-2.0, 2.0, (2,) + tuple(a["mask"].shape)))
          for name, a in fb.items()}
    fv = torch.as_tensor(rng.normal(size=128), dtype=dtype, device=cuda_device)
    _build.reset_launch_counts()
    n = _check_grouped(fsolver, fb, fs, fv, fold=fsolver._fold)
    assert _build.LAUNCHES["fused_step_delta_fold"] == 2 * n


@pytest.mark.parametrize("widths,pad_pow2", [((3, 5, 12), False), ((3, 5, 12), True),
                                             ((40,), False)],
                         ids=["K3-5-12", "K4-8-16", "K40"])
def test_lanes_per_slot_any_k_bitwise(cuda_device, widths, pad_pow2):
    """Lanes per slot at K = 3, 5, 12 (4, 8 and 16 lanes, idle lanes
    masked) and K = 4, 8, 16, and the one-thread-per-pool form at K = 40:
    the grouped delta kernels bitwise equal to their plain versions."""
    spec, obj = mixed_width_arbitrage(widths=widths, n_assets=48 if 40 in widths else 16,
                                      seed=2)
    compiled = compile_spec(spec, pad_pow2=pad_pow2, pad_pools_to=128)
    solver, bdict, s, v = _delta_state(compiled, obj, torch.float32, cuda_device, seed=9)
    want_k = sorted({K if not pad_pow2 else 1 << (K - 1).bit_length() for K in widths})
    assert [g["K"] for g in solver._groups] == want_k
    _check_grouped(solver, bdict, s, v)


# ---- slice 6: the chunked segment sum, the grouped base step, graph replays --

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segment_sum_kernel_matches_plain_bitwise(cuda_device, dtype):
    """The chunked kernel bitwise equal to its plain version: a random
    bucket with an empty asset and a crowded one, on a skewed network where
    one asset sits in every pool."""
    rng = np.random.default_rng(3)
    K, m, n = 4, 5000, 300
    asset = rng.integers(0, n, (K, m)).astype(np.int32)
    asset[asset == 7] = 8  # asset 7 has no slot
    asset[0] = 5  # asset 5 in every pool
    mask = (rng.uniform(size=(K, m)) > 0.2).astype(np.float64)
    mask[0] = 1.0
    asset = np.where(mask > 0, asset, 0).astype(np.int32)
    order, seg = (torch.as_tensor(a, device=cuda_device)
                  for a in slot_order(asset, mask, n))
    vals = torch.as_tensor(rng.normal(size=(K, m)) * mask, dtype=dtype,
                           device=cuda_device)
    _build.reset_launch_counts()
    got = segment_sum(vals, order, seg, 384)
    again = segment_sum(vals, order, seg, 384)
    want = segment_sum_plain(vals, order, seg, 384)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(again, got)
    assert _build.LAUNCHES["segment_sum"] == 2


def test_classic_iteration_sums_once_per_k_group(cuda_device):
    """The classic iteration reduces each K-group's consensus terms with one
    segment sum over the group's slot order: as many launches as K-groups,
    and the iterate equal to the CPU's (index_add_ bucket by bucket) to
    1e-10 in float64."""
    table, obj = random_arbitrage_table(16, 300, seed=4, reserve_scale=1.0)
    compiled = compile_table(table, pad_pools_to=128)
    out = {}
    for dev in ("cpu", cuda_device):
        solver = AdmmSolver(compiled, dtype=torch.float64, device=dev,
                            options=AdmmOptions(projection=CFG))
        c, lo, hi = solver._objective_arrays(obj)
        z = {name: (0.1 * a["mask"], -0.2 * a["mask"]) for name, a in solver.buckets.items()}
        nu = solver._t(np.linspace(-1.0, 1.0, solver.n))
        _build.reset_launch_counts()
        out[str(dev)] = solver._iterate(z, nu, solver._t(1.0), c, lo, hi)
    assert [g["names"] for g in solver._groups] == [["cs2f", "gm2", "gm2f"],
                                                    ["cs4f", "gm4"]]
    assert _build.LAUNCHES["segment_sum"] == 2
    (zc, nuc, psic, _, _), (zg, nug, psig, _, _) = out["cpu"], out[str(cuda_device)]
    for a, b in [(psig, psic), (nug, nuc)] + [(zg[n][i], zc[n][i]) for n in zc for i in (0, 1)]:
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0, atol=1e-10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_grouped_fused_step_matches_plain_bitwise(cuda_device, dtype):
    """One grouped fused_step launch per K-group, unfolded and on a T=2
    fold: planes and y bitwise equal to fused_step_grouped_plain, and the
    per-bucket wrapper (a group of one) bitwise equal to fused_step_plain."""
    table, _ = random_arbitrage_table(16, 300, seed=4, reserve_scale=1.0)
    compiled = compile_table(table, pad_pools_to=128)
    for solver, fold in (
            (AdmmSolver(compiled, dtype=dtype, device=cuda_device), None),
            (AdmmSolver(fold_compiled(compiled, 2), dtype=dtype, device=cuda_device,
                        fold=(2, compiled.n_assets)), (2, compiled.n_assets))):
        rng = np.random.default_rng(5)
        s = {name: tuple(torch.as_tensor(x, dtype=dtype, device=cuda_device) * a["mask"]
                         for x in rng.uniform(-2.0, 2.0, (2,) + tuple(a["mask"].shape)))
             for name, a in solver.buckets.items()}
        v = torch.as_tensor(rng.normal(size=128), dtype=dtype, device=cuda_device)
        _build.reset_launch_counts()
        for g in solver._groups:
            got = fused_step_grouped(s, v, solver.buckets, g, 1.5, cfg=CFG, fold=fold)
            want = fused_step_grouped_plain(s, v, solver.buckets, g, 1.5, cfg=CFG,
                                            fold=fold)
            torch.cuda.synchronize()
            for name in g["names"]:
                for i in range(2):
                    assert torch.equal(got[0][name][i], want[0][name][i]), name
                    assert torch.equal(got[1][name][i], want[1][name][i]), name
            assert torch.equal(got[2], want[2]), g["names"]
        key = "fused_step" if fold is None else "fused_step_fold"
        assert _build.LAUNCHES[key] == len(solver._groups)
        for name, arrs in solver.buckets.items():
            kind, floor = solver._meta[name]
            got = fused_step(*s[name], v, arrs, kind, floor, 1.5, cfg=CFG, fold=fold)
            want = fused_step_plain(*s[name], v, arrs, kind, floor, 1.5, cfg=CFG,
                                    fold=fold)
            for x, y in zip(got, want):
                assert torch.equal(x, y), name


@pytest.mark.parametrize("widths,pad_pow2", [((3, 5, 12), False), ((3, 5, 12), True),
                                             ((40,), False)],
                         ids=["K3-5-12", "K4-8-16", "K40"])
def test_grouped_fused_step_any_k_bitwise(cuda_device, widths, pad_pow2):
    """Lanes per slot at K = 3, 5, 12 (idle lanes masked) and 4, 8, 16, one
    thread per pool at K = 40: the grouped base step bitwise equal to its
    plain version."""
    spec, _ = mixed_width_arbitrage(widths=widths, n_assets=48 if 40 in widths else 16,
                                    seed=2)
    solver, s, v = _state(compile_spec(spec, pad_pow2=pad_pow2, pad_pools_to=128),
                          torch.float32, cuda_device, seed=9)
    for g in solver._groups:
        got = fused_step_grouped(s, v, solver.buckets, g, 1.5, cfg=CFG)
        want = fused_step_grouped_plain(s, v, solver.buckets, g, 1.5, cfg=CFG)
        torch.cuda.synchronize()
        assert all(torch.equal(got[j][name][i], want[j][name][i])
                   for j in (0, 1) for name in g["names"] for i in (0, 1)), g["K"]
        assert torch.equal(got[2], want[2]), g["K"]


def _leaves(res):
    """A RouteResult's arrays in a fixed order, as tensors."""
    out = [res.objective, res.psi, res.prices, res.iters, res.r_norm, res.s_norm,
           res.rho_final]
    out += [res.deltas[k] for k in sorted(res.deltas)]
    out += [res.lambdas[k] for k in sorted(res.lambdas)]
    return [torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
            for x in out]


def _replay_paths(dtype, device):
    """name -> zero-argument run of every path whose loop is replayed."""
    table, obj = random_arbitrage_table(16, 300, seed=4, reserve_scale=1.0)
    compiled = compile_table(table, pad_pools_to=128)
    fixed = AdmmOptions(max_iters=100, eps_abs=0.0, eps_rel=0.0, check_every=25,
                        projection=CFG)
    solver = AdmmSolver(compiled, dtype=dtype, device=device, options=fixed)
    util = ConcaveUtility.linear(obj.c, lo=obj.lo, hi=obj.hi).with_log(1, c=1.0, b=2.0)
    base = to_host(AdmmSolver(compiled, device=device, options=AdmmOptions(
        max_iters=200, check_every=25)).solve(obj))
    dsolver = DeltaAdmmSolver(compiled, dtype=dtype, device=device, options=AdmmOptions(
        max_iters=60, eps_abs=0.0, eps_rel=0.0, check_every=25, adapt_rho=False,
        projection=CFG))
    nu0 = base.prices.astype(np.float32).astype(np.float64)
    bdict, _ = dsolver.delta_buckets(base, 1e-3, nu0=nu0)
    dobj = Objective(obj.c, lo=np.full(compiled.n_assets, -1e3),
                     hi=np.full(compiled.n_assets, 1e3))
    rng = np.random.default_rng(2)
    c3 = np.asarray(obj.c)[None, :] * np.array([[0.9], [1.0], [1.1]])
    lo3 = np.tile(np.maximum(obj.lo, -3e38), (3, 1))
    scale = rng.uniform(0.7, 1.3, (2, compiled.n_pools))
    return {
        "classic": lambda: solver.solve(obj),
        "classic utility": lambda: solver.solve(util),
        "fused": lambda: solver.solve_fused(obj, iters=60),
        "fused utility": lambda: solver.solve_fused(util, iters=60),
        "merged": lambda: solver.solve_fused(obj, iters=60, merged=True),
        "fused delta": lambda: dsolver.solve_delta(dobj, bdict, nu0, 1.0, 60, fused=True),
        "classic delta": lambda: dsolver.solve_delta(dobj, bdict, nu0, 1.0, 60),
        "fold": lambda: solve_batch_reserves_folded(compiled, obj, scale, options=fixed,
                                                    dtype=dtype, n_iters=59,
                                                    device=device),
        "batch": lambda: solver.solve_batch(c3, lo3, np.full_like(c3, 3e38)),
        "driver": lambda: ChunkedDriver(solver, chunk=30).solve(obj, max_iters=60)[0],
        "driver fused": lambda: ChunkedDriver(solver, chunk=30, fused=True).solve(
            obj, max_iters=60)[0],
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_graph_replay_matches_eager_bitwise(cuda_device, dtype):
    """Every replayed path (classic, fused, merged, fused and classic delta,
    fold, batch per point, ChunkedDriver classic and fused), with a linear
    objective and with a concave utility where the path takes one: the
    replayed run bitwise equal to the eager one, with the same launch
    counts, and a second replayed run equal again."""
    for name, run in _replay_paths(dtype, cuda_device).items():
        with graphs.eager():
            _build.reset_launch_counts()
            want = _leaves(run())
            eager_counts = dict(_build.LAUNCHES)
        _build.reset_launch_counts()
        got = _leaves(run())
        torch.cuda.synchronize()
        assert dict(_build.LAUNCHES) == eager_counts, name
        again = _leaves(run())
        for a, b, c in zip(got, want, again):
            assert torch.equal(a.cpu(), b.cpu()) and torch.equal(c.cpu(), a.cpu()), name


# ---- slice 7: the grouped base projection ------------------------------------

def _check_project_grouped(solver, inputs):
    """Each K-group through ``project_grouped`` (twice) against
    ``project_grouped_plain``: bitwise.  Returns the number of groups."""
    for g in solver._groups:
        got = project_grouped(inputs, solver.buckets, g, cfg=CFG)
        again = project_grouped(inputs, solver.buckets, g, cfg=CFG)
        want = project_grouped_plain(inputs, solver.buckets, g, cfg=CFG)
        torch.cuda.synchronize()
        assert list(got) == list(want) == g["names"]
        for name in g["names"]:
            for i in range(2):
                assert torch.equal(got[name][i], want[name][i]), (g["K"], name)
                assert torch.equal(again[name][i], got[name][i]), (g["K"], name)
    return len(solver._groups)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_grouped_projection_matches_plain_bitwise(cuda_device, dtype):
    """K=2 (cs2f, gm2, gm2f) and K=4 (cs4f, gm4): one ``project`` launch
    per group, bitwise equal to the plain grouped version and to itself."""
    table, _ = random_arbitrage_table(16, 300, seed=4, reserve_scale=1.0)
    solver, s, _ = _state(compile_table(table, pad_pools_to=128), dtype, cuda_device,
                          seed=11)
    assert [g["names"] for g in solver._groups] == [["cs2f", "gm2", "gm2f"],
                                                    ["cs4f", "gm4"]]
    _build.reset_launch_counts()
    n = _check_project_grouped(solver, s)
    assert _build.LAUNCHES["project"] == 2 * n


@pytest.mark.parametrize("widths,pad_pow2", [((3, 5, 8, 16), False), ((40,), False)],
                         ids=["K3-5-8-16", "K40"])
def test_grouped_projection_any_k_bitwise(cuda_device, widths, pad_pow2):
    """Lanes per slot at K = 3, 5 (idle lanes masked), 8 and 16, one thread
    per pool at K = 40: the grouped projection bitwise equal to its plain
    version in float32 and float64."""
    spec, _ = mixed_width_arbitrage(widths=widths, n_assets=48 if 40 in widths else 16,
                                    seed=2)
    compiled = compile_spec(spec, pad_pow2=pad_pow2, pad_pools_to=128)
    for dtype in (torch.float32, torch.float64):
        solver, s, _ = _state(compiled, dtype, cuda_device, seed=12)
        assert [g["K"] for g in solver._groups] == sorted(widths)
        _check_project_grouped(solver, s)


def test_classic_iteration_projects_once_per_k_group(cuda_device):
    """A classic iteration makes one ``project`` launch per K-group, and its
    trades equal the plain projection of the same inputs bit for bit."""
    table, obj = random_arbitrage_table(16, 300, seed=4, reserve_scale=1.0)
    solver = AdmmSolver(compile_table(table, pad_pools_to=128), device=cuda_device,
                        options=AdmmOptions(projection=CFG))
    c, lo, hi = solver._objective_arrays(obj)
    z = {name: (0.1 * a["mask"], -0.2 * a["mask"]) for name, a in solver.buckets.items()}
    nu = solver._t(np.linspace(-1.0, 1.0, solver.n))
    _ = solver._groups  # built before the count
    _build.reset_launch_counts()
    _, _, _, w, _ = solver._iterate(z, nu, solver._t(1.0), c, lo, hi)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["project"] == len(solver._groups) == 2
    inputs = {}
    for name in solver.buckets:
        nu_e = solver._bcast_nu(nu, name)
        inputs[name] = (z[name][0] - nu_e, z[name][1] + nu_e)
    for g in solver._groups:
        want = project_grouped_plain(inputs, solver.buckets, g, cfg=CFG)
        for name in g["names"]:
            for i in range(2):
                assert torch.equal(w[name][i], want[name][i]), name


def test_failed_capture_raises(cuda_device):
    """A block that reads a value back to the host cannot be captured: the
    capture raises, and nothing runs the block eagerly instead."""
    table, _ = random_arbitrage_table(16, 300, seed=4, reserve_scale=1.0)
    solver = AdmmSolver(compile_table(table, pad_pools_to=128), device=cuda_device)
    x = torch.ones(4, device=cuda_device)

    def step(state, k):
        return state * float(state.sum())  # a device-to-host copy

    with pytest.raises(RuntimeError):
        graphs.run_block(solver, "sync", step, 3, 1, x, ())


# ---- slice 9: the device gate and non-separable utilities --------------------

def test_device_gate_card_matches_cpu(cuda_device):
    """``DeviceGate`` on the card against the same gate on the CPU, on the
    same equilibrated state: one ``project`` launch per K-group and two
    segment sums per K-group a pass, estimates at ``tests/test_residuals.py``'s
    bars (objective 1e-5 relative, dual 1e-9 relative, gap and feasibility
    1e-5)."""
    from cfmm_routing_tpu_torch.solver.precondition import equilibrate
    from cfmm_routing_tpu_torch.solver.residuals import DeviceGate

    table, obj = random_arbitrage_table(16, 300, seed=4, reserve_scale=1.0)
    eq = equilibrate(table, obj)
    compiled = compile_table(eq.table, pad_pools_to=128)
    orig = compile_table(table, pad_pools_to=128)
    opts = AdmmOptions(max_iters=100, check_every=25, projection=CFG)
    cpu = AdmmSolver(compiled, options=opts, device="cpu")
    res = cpu.solve(eq.objective)
    z, nu = cpu.warm_state(res, 1.0)
    gate_cpu = DeviceGate(cpu, orig, obj, d=eq.d)
    want = gate_cpu.finish(gate_cpu.evaluate(z, nu, 1.0))
    card = AdmmSolver(compiled, options=opts, device=cuda_device)
    gate = DeviceGate(card, orig, obj, d=eq.d)
    zc = {k: (a.to(cuda_device), b.to(cuda_device)) for k, (a, b) in z.items()}
    _ = card._groups
    _build.reset_launch_counts()
    got = gate.finish(gate.evaluate(zc, nu.to(cuda_device), 1.0))
    assert _build.LAUNCHES["project"] == len(card._groups) == 2
    assert _build.LAUNCHES["segment_sum"] == 2 * len(card._groups)
    assert abs(got.objective - want.objective) <= 1e-5 * max(1.0, abs(want.objective))
    assert abs(got.dual - want.dual) <= 1e-9 * max(1.0, abs(want.dual))
    assert abs(got.gap_rel - want.gap_rel) <= 1e-5
    assert abs(got.feasibility_rel - want.feasibility_rel) <= 1e-5


def _card_quadratic(device, prox_iters, read_host=False):
    """A (network, CustomUtility) pair: c@psi - psi^T Q psi / 2 on the
    random_arbitrage(5, 8, seed=13) network, Q and c on the card."""
    from cfmm_routing_tpu_torch.models.utility import CustomUtility
    from cfmm_routing_tpu_torch.utils.synth import random_arbitrage

    spec, lin = random_arbitrage(5, 8, seed=13)
    n = spec.n_assets
    A = np.random.default_rng(5).normal(size=(n, n)) / np.sqrt(n)
    Qt = torch.as_tensor(A @ A.T + 0.1 * np.eye(n), device=device)
    ct = torch.as_tensor(np.asarray(lin.c), device=device)

    def fn(p):
        v = torch.dot(ct.to(p), p) - 0.5 * torch.dot(p, Qt.to(p) @ p)
        return v * float(p.sum() * 0 + 1) if read_host else v

    return spec, CustomUtility(fn, lo=np.full(n, -5.0), hi=np.full(n, 50.0),
                               smoothness=float(torch.linalg.eigvalsh(Qt)[-1]),
                               prox_iters=prox_iters)


def test_custom_solve_replay_matches_eager_bitwise(cuda_device):
    """A CustomUtility's classic solve (its FISTA prox and autograd inside
    the captured check blocks): replayed bitwise equal to eager, with the
    same launch counts; the ``project`` and ``segment_sum`` kernels run."""
    spec, util = _card_quadratic(cuda_device, prox_iters=20)
    for dtype in (torch.float32, torch.float64):
        solver = AdmmSolver(compile_spec(spec), dtype=dtype, device=cuda_device,
                            options=AdmmOptions(max_iters=40, eps_abs=0.0, eps_rel=0.0,
                                                check_every=10, projection=CFG))
        with graphs.eager():
            _build.reset_launch_counts()
            want = _leaves(solver.solve(util))
            eager_counts = dict(_build.LAUNCHES)
        _build.reset_launch_counts()
        got = _leaves(solver.solve(util))
        torch.cuda.synchronize()
        assert dict(_build.LAUNCHES) == eager_counts
        assert eager_counts["project"] > 0 and eager_counts["segment_sum"] > 0
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b.cpu())


def test_custom_fn_reading_the_host_raises(cuda_device):
    """A CustomUtility whose fn reads a value back to the host cannot be
    captured: the solve raises and says why, and nothing runs eagerly
    instead."""
    spec, util = _card_quadratic(cuda_device, prox_iters=5, read_host=True)
    solver = AdmmSolver(compile_spec(spec), device=cuda_device,
                        options=AdmmOptions(max_iters=20, check_every=10))
    with pytest.raises(RuntimeError, match="CustomUtility"):
        solver.solve(util)
