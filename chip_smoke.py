#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card and check it.

Run from the repository root on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py [--out results.json]

Phases (any failure raises and the script exits nonzero):

1. The card's name and power limit, the torch and CUDA versions, and the
   build of every CUDA kernel from ``cfmm_routing_tpu_torch/csrc``.
2. Each kernel against its plain PyTorch version on the card.
   a. At the five bucket shapes of the 100k-pool network, from a mid-solve
      state (20 plain fused iterations): ``project_gm`` (gm2, gm2f, gm4)
      and ``project_cs`` (cs2f, cs4f) in float32 at the main path's
      ProjectionConfig(24, 4) and in float64 at the default (48, 6);
      ``fused_step`` and ``segment_sum`` on every bucket.
   b. ``fused_step_delta`` and the standalone ``project_gm_delta`` /
      ``project_cs_delta`` at the same five shapes, on the delta arrays
      that ``DeltaAdmmSolver.delta_buckets`` builds from a real 100k base
      solve, after 5 plain fused delta iterations: float32 and float64 at
      (48, 6).
   c. Any K: a network of 3-, 5- and 12-asset pools compiled with
      ``pad_pow2=False`` (the run-time-K kernels) and ``pad_pow2=True``
      (K = 4, 8, 16): all six kernels in float32.
   Tolerances: projections atol 5e-5 (float32) / 1e-10 (float64); fused
   steps atol 2e-5 (1e-10) on the planes and also rtol 1e-5 on y; the
   segment sum must be bitwise equal to its plain version, whose order of
   additions the plain fused steps share.
3. The reference optima on the card: in float64 through ``api.arbitrage`` /
   ``api.liquidate`` / ``api.route(certify=True)``, each pin to 1e-6; in
   float32 through the same calls with ``refine_to=1e-7`` (bench.py's base
   options), each certified and pinned to 2e-6; and again compiled with
   ``pad_pools_to=128`` through ``refine_device(fused=True)``, where the
   ``fused_step_delta`` launches must equal buckets x fused iterations.
4. The main path at full width: ``random_arbitrage_table(256, 100_000,
   seed=7)`` -> ``equilibrate`` -> ``compile_table(pad_pools_to=1024)`` ->
   ``AdmmSolver.solve_fused(iters=499)`` in float32 -> ``unscale_result`` ->
   ``certify``, with every kernel's launch count reset just before and read
   just after.  The kernel path's objective must match the plain path's and
   the classic path's to 1e-3 relative; a second kernel run, and a second
   50-iteration classic solve, must be bitwise equal to the first.
5. The certified route at full width: the same network -> float32 classic
   ``AdmmSolver.solve`` (max_iters=3000, eps 1e-7, ProjectionConfig(24, 4))
   -> ``refine_device(target_gap=1e-6)`` on the fused delta kernel, with the
   certificate in original units.  Counts reset before, read after; the
   kernel must run 5 launches per fused delta iteration, no host fallback
   may be taken, and the certificate must be finite and no worse than at
   entry.  Whether 1e-6 was reached is printed, not asserted.
6. Sweeps and batches (each main-path run with the counts reset just
   before it and read just after, and every call a kernel wrapper makes to
   a plain version counted: there must be none).
   a. The fold kernels ``fused_step(fold=)`` and ``fused_step_delta(fold=)``
      against their plain versions at the folded shapes of 6b (float32 at
      (24, 4) and (48, 6), float64 at (48, 6)) and at 1,000 pools / 64
      assets x T = 1,024 in float32, whose 65,536 prices exceed one block's
      shared memory: bitwise equal, planes and y.
   b. BASELINE config 5: the 100k network of phase 4 under 8 reserve
      scenarios (``uniform(0.7, 1.3, (8, n_pools))``, ``bench_grid.py:529``)
      -> ``solve_batch_reserves_folded(n_iters=749)`` in float32: 749 fused
      iterations (exactly 5 x 749 fold launches) + 1 classic, 750 in all.
      Per-point objectives match the batched classic
      ``solve_batch_reserves`` at 750 iterations to 5e-4 relative; a second
      run is bitwise equal.
   c. A certified objective sweep: ``random_arbitrage_table(64, 10_000,
      seed=7)``, equilibrated, ``pad_pools_to=1024``, 50 objective points
      (``bench_grid.py:443-481``) -> ``solve_batch_folded`` (fused
      ``ChunkedDriver``, eps 1e-6) -> ``refine_sweep(target_gap=1e-6)`` on
      ``fused_step_delta(fold=)``.  Every certificate finite and no worse
      than at entry; how many points reach 1e-6 is printed.
   d. The reference's 51-point frontier: ``api.sweep(two-asset, 0, 2,
      linspace(0, 50, 51), refine_to=1e-6)`` in float32: every point
      certified at 1e-6, u(25) = 31.005495 to 2e-6.

It prints one JSON line describing every kernel of the path (device times
from CUDA events around CUDA-graph replays of back-to-back calls, summed
over the buckets one iteration runs; the plain fused steps and the plain
segment sum, which read a size back to the host, from eager calls; the
fused steps' times include their segment-sum launch; the fold kernels'
times are summed over the 6b buckets; bounds from this run's shapes;
launches summed over the main-path runs of phases 4, 5 and 6b-6d), the card's name and power limit as ``nvidia-smi``
reports them, and last ``{"ok": true, "device": {"platform": "gpu",
"kind": ..., "count": ...}}``.
"""
import argparse
import contextlib
import dataclasses
import json
import logging
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Card peaks for the bounds (NVIDIA H100 SXM data sheet, dense, 700 W):
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}  # CUDA cores
EXPECTED_BUCKETS = {"gm2": (73728, 2), "gm2f": (10240, 2), "gm4": (7168, 4),
                    "cs2f": (4096, 2), "cs4f": (7168, 4)}
PINS = (("arbitrage", 21.499805), ("liquidation", 15.883010),
        ("two-asset t=25", 31.005495))
SOURCES = {  # kernel -> (CUDA source, the TPU kernel it replaces)
    "project_gm": ("cfmm_routing_tpu_torch/csrc/projection.cu",
                   "cfmm_routing_tpu/ops/projection_pallas.py:303"),
    "project_cs": ("cfmm_routing_tpu_torch/csrc/projection.cu",
                   "cfmm_routing_tpu/ops/projection_pallas.py:319"),
    # the refinement's classic projections: plain jnp on the TPU, no Pallas
    "project_gm_delta": ("cfmm_routing_tpu_torch/csrc/projection_delta.cu",
                         "cfmm_routing_tpu/ops/projection_delta.py:188"),
    "project_cs_delta": ("cfmm_routing_tpu_torch/csrc/projection_delta.cu",
                         "cfmm_routing_tpu/ops/projection_delta.py:237"),
    "fused_step": ("cfmm_routing_tpu_torch/csrc/fused_step.cu",
                   "cfmm_routing_tpu/ops/iteration_pallas.py:260"),
    "fused_step_delta": ("cfmm_routing_tpu_torch/csrc/fused_step_delta.cu",
                         "cfmm_routing_tpu/ops/iteration_pallas.py:602"),
    # the consensus reduction of both fused kernels (one-hot products)
    "segment_sum": ("cfmm_routing_tpu_torch/csrc/segment_sum.cu",
                    "cfmm_routing_tpu/ops/iteration_pallas.py:252"),
    # the scenario-fold variants of the two fused steps (phase 6)
    "fused_step_fold": ("cfmm_routing_tpu_torch/csrc/fused_step.cu",
                        "cfmm_routing_tpu/ops/iteration_pallas.py:260 (fold=)"),
    "fused_step_delta_fold": ("cfmm_routing_tpu_torch/csrc/fused_step_delta.cu",
                              "cfmm_routing_tpu/ops/iteration_pallas.py:602 (fold=)"),
}
F32_BIG = float(np.finfo(np.float32).max) / 4


def log(msg):
    print(msg, flush=True)


def graph_ms(fn, n=20, reps=5):
    """Device time of one call of ``fn``: CUDA events around replays of a
    CUDA graph that holds ``n`` back-to-back calls, so the host's launch
    overhead is not in the time.  Median over ``reps`` replays."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / n)
    del graph
    return statistics.median(samples)


def eager_ms(fn, n=5):
    """Time of one call of ``fn`` from CUDA events around ``n`` eager calls,
    host launch overhead included: for a plain version that reads a size
    back to the host and so cannot be captured in a CUDA graph."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


def max_err(got, want):
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def check_close(label, got, want, atol, rtol=0.0):
    for i, (a, b) in enumerate(zip(got, want)):
        bad = (a - b).abs() > atol + rtol * b.abs()
        if bool(bad.any()):
            raise AssertionError(
                f"{label}: output {i} differs from the plain version by "
                f"{float((a - b).abs().max()):.3e} (atol {atol}, rtol {rtol})"
            )


def check_fused(label, got, want, atol):
    """A fused step's (sD', sL', D, L) to atol, y also to rtol 1e-5."""
    check_close(label, got[:4], want[:4], atol)
    check_close(f"{label} y", got[4:], want[4:], atol, rtol=1e-5)


def gm_or_cs_bytes(kind, K, m, es):
    # each input read once, each output written once
    if kind == "gm":  # p q R w s mask, gamma logk0 k0 -> D L
        return es * (8 * K * m + 3 * m)
    return es * (7 * K * m + 2 * m)  # p q R w mask, gamma k0 -> D L


def bound_ms(bytes_, flops, dtype):
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def projection_flops(cfg, K, m, per_step=60):
    # the Pallas kernels' own cost models, without their one-hot exchange:
    # 60 flops per slot per root-find step (projection_pallas.py:292-296,
    # iteration_pallas.py:357-361), 80 for the delta projection (:701-705)
    return per_step * (cfg.n_bisect + cfg.n_polish) * K * m


def delta_projection_calls(kind, floor, p, q, a, cfg, kernels, plains):
    """(kernel, plain) zero-argument calls of the standalone delta
    projection of one delta bucket ``a`` at input (p, q)."""
    if kind == "gm":
        args = (p, q, a["X0"], a["w"], a["sS"], a["gamma"], a["nsig"], a["aD"],
                a["aL"], a["mask"])
        return (lambda: kernels[0](*args, needs_floor=floor, cfg=cfg),
                lambda: plains[0](*args, needs_floor=floor, cfg=cfg))
    args = (p, q, a["X0"], a["gamma"], a["w"], a["nsig"], a["aD"], a["aL"],
            a["mask"])
    return (lambda: kernels[1](*args, cfg=cfg), lambda: plains[1](*args, cfg=cfg))


def segment_bytes(n_real, n, n_out, es):
    # each real slot's value and its index read once, the offsets, y out
    return es * n_real + 4 * n_real + 4 * (n + 1) + es * n_out


def bitwise(label, got, want):
    """Raise unless every output equals its plain version bit for bit."""
    for i, (a, b) in enumerate(zip(got, want)):
        if not torch.equal(a, b):
            raise AssertionError(
                f"{label}: output {i} is not bitwise equal to the plain version "
                f"(max diff {float((a - b).abs().max()):.3e})")


def fused_fold_bytes(K, m, n_pad, es, delta):
    """Bytes a fused step must move on one bucket: each input read once
    (slot planes, int32 ids, per-pool vectors, the price vector), each
    output written once (new state, trades, consensus-term plane)."""
    planes_in = 9 if delta else 6  # sD sL (X0 w sS aD aL mask nu0e | R w s mask)
    vectors = 2 if delta else 3  # gamma nsig | gamma logk0 k0
    return es * ((planes_in + 5) * K * m + vectors * m + n_pad) + 4 * K * m


@contextlib.contextmanager
def count_plain_calls(counter):
    """Count every call a kernel wrapper makes to its plain version (the
    wrappers fall back to them only on CPU tensors)."""
    from cfmm_routing_tpu_torch.ops import iteration_cuda, projection_cuda, segment

    targets = [(iteration_cuda, "fused_step_plain"),
               (iteration_cuda, "fused_step_delta_plain"),
               (projection_cuda, "project_gm"), (projection_cuda, "project_cs"),
               (projection_cuda, "project_gm_delta"),
               (projection_cuda, "project_cs_delta"),
               (segment, "segment_sum_plain")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def counted(name, fn):
        def call(*a, **k):
            counter[name] = counter.get(name, 0) + 1
            return fn(*a, **k)
        return call

    for mod, name, fn in saved:
        setattr(mod, name, counted(name, fn))
    try:
        yield counter
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def sweep_phase(report, rows, card, cfg_main, cfg64):
    """Phase 6, sweeps and batches (module docstring).  Appends the fold
    kernels' rows to ``rows`` and returns the launch counts of its three
    main-path runs (6b, 6c, 6d)."""
    from cfmm_routing_tpu_torch import api
    from cfmm_routing_tpu_torch.models.reference_instances import two_asset_instance
    from cfmm_routing_tpu_torch.ops import _build
    from cfmm_routing_tpu_torch.ops.iteration_cuda import (
        fused_step, fused_step_delta, fused_step_delta_plain, fused_step_plain,
    )
    from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver, _reserve_buckets
    from cfmm_routing_tpu_torch.solver.certify import certify_batch
    from cfmm_routing_tpu_torch.solver.compiler import compile_table
    from cfmm_routing_tpu_torch.solver.fold import (
        fold_compiled, folded_solver, solve_batch_folded, solve_batch_reserves_folded,
    )
    from cfmm_routing_tpu_torch.solver.precondition import equilibrate
    from cfmm_routing_tpu_torch.solver.refine_device import (
        _delta_buckets_folded, _psi_batch, refine_sweep,
    )
    from cfmm_routing_tpu_torch.utils.synth import random_arbitrage_table

    out = {}
    score = lambda ct: max(abs(ct.gap_rel), ct.feasibility_rel)  # noqa: E731

    def as64(arrs):
        return {k: (v.double() if v.is_floating_point() else v) for k, v in arrs.items()}

    def delta_state(arrs, rng):
        K, m = arrs["mask"].shape
        return tuple(torch.as_tensor(rng.uniform(-1, 1, (K, m)), dtype=arrs["mask"].dtype,
                                     device="cuda") * arrs["mask"] for _ in range(2))

    # ---- the 6b network: 100k pools x 8 reserve scenarios, folded ----------
    t_phase = time.perf_counter()
    table, obj = random_arbitrage_table(256, 100_000, seed=7)
    eq = equilibrate(table, obj)
    compiled = compile_table(eq.table, pad_pools_to=1024)
    B = 8
    scale_r = np.random.default_rng(3).uniform(0.7, 1.3, size=(B, compiled.n_pools))
    opts6 = AdmmOptions(max_iters=750, eps_abs=0.0, eps_rel=0.0, adapt_rho=False,
                        projection=cfg_main)
    t0 = time.perf_counter()
    fs, _ = folded_solver(compiled, B, opts6, torch.float32)
    bdict = _reserve_buckets(fs, fold_compiled(compiled, B, scale_r))
    setup_s = time.perf_counter() - t0
    fshapes = {k: tuple(a["mask"].shape) for k, a in bdict.items()}
    n_slots = sum(int(a["mask"].sum()) for a in bdict.values())
    log(f"# 6: 100k pools x {B} reserve scenarios folded: buckets (K, T*m) {fshapes}, "
        f"{n_slots} real slots; folded solver and reserve planes built in {setup_s:.1f} s")

    # ---- 6a. fold kernels vs their plain versions at the 6b shapes ---------
    c_f, lo_f, hi_f = (fs._t(np.tile(x, B)) for x in (
        eq.objective.c, np.maximum(eq.objective.lo, -F32_BIG),
        np.minimum(eq.objective.hi, F32_BIG)))
    rho = fs._t(1.0)
    s, wdef, nu = fs.fused_init(bdict)
    for _ in range(20):  # a mid-solve state, on the kernels
        s, wdef, nu, _, _ = fs._iterate_fused(s, wdef, nu, rho, c_f, lo_f, hi_f, buckets=bdict)
    v, _ = fs._fold_pack(wdef - nu)
    n_pad = v.shape[0]
    fold = fs._fold
    for name, arrs in bdict.items():
        kind, floor = fs._meta[name]
        K, m = arrs["mask"].shape
        sD, sL = s[name]
        kfn = lambda: fused_step(sD, sL, v, arrs, kind, floor, 1.0, cfg=cfg_main, fold=fold)  # noqa: E731
        pfn = lambda: fused_step_plain(sD, sL, v, arrs, kind, floor, 1.0, cfg=cfg_main, fold=fold)  # noqa: E731
        got, want = kfn(), pfn()
        torch.cuda.synchronize()
        bitwise(f"fused_step fold[{name}, float32]", got, want)
        row = dict(bucket=name, dtype="float32", K=K, m=m, fold=list(fold), cfg=list(cfg_main),
                   max_abs_err=max_err(got, want), ms=graph_ms(kfn), plain_ms=eager_ms(pfn, n=1))
        row["bound_ms"], row["bound_by"] = bound_ms(
            fused_fold_bytes(K, m, n_pad, 4, False), projection_flops(cfg_main, K, m),
            torch.float32)
        rows["fused_step_fold"].append(row)
        a64 = as64(arrs)
        got = fused_step(sD.double(), sL.double(), v.double(), a64, kind, floor, 1.0,
                         cfg=cfg64, fold=fold)
        want = fused_step_plain(sD.double(), sL.double(), v.double(), a64, kind, floor, 1.0,
                                cfg=cfg64, fold=fold)
        torch.cuda.synchronize()
        bitwise(f"fused_step fold[{name}, float64]", got, want)
        log(f"# 6a fused_step fold {name:5s} K={K} T*m={m}: bitwise equal to plain in "
            f"float32 and float64; kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.2f} ms  "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        del a64, got, want
    del s, wdef, nu

    # ---- 6b. BASELINE config 5: 8 reserve scenarios at 100k pools ----------
    _build.reset_launch_counts()
    plain6 = {}
    t0 = time.perf_counter()
    with count_plain_calls(plain6):
        res_b = solve_batch_reserves_folded(compiled, eq.objective, scale_r, options=opts6,
                                            n_iters=749)
    fold_s = time.perf_counter() - t0
    launches6b = dict(_build.LAUNCHES)
    expect = 749 * len(compiled.buckets)
    log(f"# 6b folded reserve batch: 749 fused + 1 classic iterations in {fold_s:.3f} s "
        f"(host clock, reserve planes included) -> {750 / fold_s:.1f} it/s, "
        f"{B * 750 / fold_s:.1f} scenario-it/s; launches {launches6b}")
    if launches6b["fused_step_fold"] != expect:
        raise AssertionError(f"fused_step_fold launches {launches6b['fused_step_fold']} != {expect}")
    if plain6:
        raise AssertionError(f"plain versions ran on the folded reserve batch: {plain6}")
    objs = np.asarray(res_b.objective, np.float64)
    if not (objs.shape == (B,) and np.isfinite(objs).all() and np.isfinite(res_b.psi).all()):
        raise AssertionError("folded reserve batch: non-finite or misshapen result")
    t0 = time.perf_counter()
    res_b2 = solve_batch_reserves_folded(compiled, eq.objective, scale_r, options=opts6,
                                         n_iters=749)
    fold2_s = time.perf_counter() - t0
    leaves = [(res_b.objective, res_b2.objective), (res_b.psi, res_b2.psi),
              (res_b.prices, res_b2.prices)]
    leaves += [(res_b.deltas[k], res_b2.deltas[k]) for k in res_b.deltas]
    leaves += [(res_b.lambdas[k], res_b2.lambdas[k]) for k in res_b.lambdas]
    if not all(np.array_equal(a, b) for a, b in leaves):
        raise AssertionError("a second folded reserve batch is not bitwise equal to the first")
    st = fs.fused_init(bdict)
    iter_dev_ms = graph_ms(lambda: fs._iterate_fused(*st, rho, c_f, lo_f, hi_f, buckets=bdict),
                           n=5, reps=3)
    log(f"# 6b second run bitwise equal ({fold2_s:.3f} s, {750 / fold2_s:.1f} it/s); one folded "
        f"fused iteration {iter_dev_ms:.4f} ms on the device (CUDA graph) vs "
        f"{1e3 * fold2_s / 750:.4f} ms per iteration on the host clock")
    t0 = time.perf_counter()
    solver_b = AdmmSolver(compiled, dtype=torch.float32, options=opts6)
    res_c = solver_b.solve_batch_reserves(eq.objective, scale_r)
    obj_c = np.asarray(res_c.objective.cpu(), np.float64)
    classic_s = time.perf_counter() - t0
    rel = np.abs(objs - obj_c) / np.maximum(1.0, np.abs(obj_c))
    log(f"# 6b batched classic solve_batch_reserves: iters {res_c.iters.tolist()} in "
        f"{classic_s:.3f} s; per-point objectives {objs.tolist()}; max rel diff vs the "
        f"folded fused batch {rel.max():.3e}")
    if not (res_c.iters == 750).all() or not rel.max() <= 5e-4:
        raise AssertionError(f"folded vs batched classic objectives differ: {rel.tolist()}")
    out["reserve_batch"] = dict(
        B=B, folded_buckets=fshapes, real_slots=n_slots, setup_s=setup_s, fold_s=fold_s,
        fold2_s=fold2_s, iters_per_s=750 / fold2_s, iteration_device_ms=iter_dev_ms,
        classic_s=classic_s, objectives=objs.tolist(), max_rel_vs_classic=float(rel.max()),
        launches=launches6b, repeat_bitwise_equal=True)
    del solver_b, res_c

    # ---- 6a (cont.). fused_step_delta(fold=) at the 6b shapes --------------
    nu0f = np.asarray(res_b.prices, np.float64).astype(np.float32).astype(np.float64)
    half = lambda d: {k: 0.5 * np.asarray(x, np.float64) for k, x in d.items()}  # noqa: E731
    bd, min_x0 = _delta_buckets_folded(fs, half(res_b.deltas), half(res_b.lambdas),
                                       np.full(B, 1e-3), nu0f)
    if not (min_x0 > 0).all():
        raise AssertionError(f"delta arrays at the 6b shapes: min x0 {min_x0}")
    rng = np.random.default_rng(5)
    vd = torch.as_tensor(0.3 * rng.normal(size=n_pad), dtype=torch.float32, device="cuda")
    for name, arrs in bd.items():
        kind, floor = fs._meta[name]
        K, m = arrs["mask"].shape
        sD, sL = delta_state(arrs, rng)
        kfn = lambda: fused_step_delta(sD, sL, vd, arrs, kind, floor, 1.0, cfg=cfg64, fold=fold)  # noqa: E731
        pfn = lambda: fused_step_delta_plain(sD, sL, vd, arrs, kind, floor, 1.0, cfg=cfg64, fold=fold)  # noqa: E731
        got, want = kfn(), pfn()
        torch.cuda.synchronize()
        bitwise(f"fused_step_delta fold[{name}, float32]", got, want)
        row = dict(bucket=name, dtype="float32", K=K, m=m, fold=list(fold), cfg=list(cfg64),
                   max_abs_err=max_err(got, want), ms=graph_ms(kfn), plain_ms=eager_ms(pfn, n=1))
        row["bound_ms"], row["bound_by"] = bound_ms(
            fused_fold_bytes(K, m, n_pad, 4, True), projection_flops(cfg64, K, m, per_step=80),
            torch.float32)
        rows["fused_step_delta_fold"].append(row)
        a64 = as64(arrs)
        got = fused_step_delta(sD.double(), sL.double(), vd.double(), a64, kind, floor, 1.0,
                               cfg=cfg64, fold=fold)
        want = fused_step_delta_plain(sD.double(), sL.double(), vd.double(), a64, kind, floor,
                                      1.0, cfg=cfg64, fold=fold)
        torch.cuda.synchronize()
        bitwise(f"fused_step_delta fold[{name}, float64]", got, want)
        log(f"# 6a fused_step_delta fold {name:5s} K={K} T*m={m}: bitwise equal to plain in "
            f"float32 and float64; kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.2f} ms  "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        del a64, got, want
    del bd, bdict, st, fs, res_b, res_b2
    torch.cuda.empty_cache()

    # ---- 6a (cont.). 1,000 pools / 64 assets x T = 1,024, float32 ---------
    t_1k, _ = random_arbitrage_table(64, 1000, seed=7)
    c_1k = compile_table(t_1k, pad_pools_to=128)
    T1 = 1024
    s1k = AdmmSolver(fold_compiled(c_1k, T1), dtype=torch.float32, fold=(T1, c_1k.n_assets),
                     options=AdmmOptions(projection=cfg_main))
    zeros = {k: np.zeros((T1, b.width, b.m)) for k, b in c_1k.buckets.items()}
    bd1, _ = _delta_buckets_folded(s1k, zeros, zeros, np.full(T1, 1e-3),
                                   np.ones((T1, c_1k.n_assets)))
    v1 = torch.as_tensor(0.3 * rng.normal(size=T1 * c_1k.n_assets), dtype=torch.float32,
                         device="cuda")
    big = []
    for name, arrs in s1k.buckets.items():
        kind, floor = s1k._meta[name]
        K, m = arrs["mask"].shape
        sD, sL = delta_state(arrs, rng)
        for label, kfn, pfn, a, cfg in (
                ("fused_step", fused_step, fused_step_plain, arrs, cfg_main),
                ("fused_step_delta", fused_step_delta, fused_step_delta_plain, bd1[name], cfg64)):
            got = kfn(sD, sL, v1, a, kind, floor, 1.0, cfg=cfg, fold=s1k._fold)
            want = pfn(sD, sL, v1, a, kind, floor, 1.0, cfg=cfg, fold=s1k._fold)
            torch.cuda.synchronize()
            bitwise(f"{label} fold[{name}, 1k x {T1}]", got, want)
        big.append(dict(bucket=name, K=K, m=m))
    log(f"# 6a 1,000 pools / 64 assets x T={T1} ({sum(b['m'] for b in big)} folded pools; "
        f"{T1 * c_1k.n_assets} prices, {T1 * c_1k.n_assets * 4 // 1024} KB, more than one "
        f"block's 227 KB of shared memory): both fold kernels bitwise equal to plain on "
        f"{[b['bucket'] for b in big]}")
    out["fold_1k_x_1024"] = big
    del s1k, bd1

    # ---- 6c. a certified objective sweep: 10k pools x 50 points -------------
    table, obj = random_arbitrage_table(64, 10_000, seed=7)
    eq = equilibrate(table, obj)
    compiled = compile_table(eq.table, pad_pools_to=1024)
    Tc = 50
    n = compiled.n_assets
    c_s = np.asarray(eq.objective.c)[None, :] * np.random.default_rng(11).uniform(
        0.8, 1.25, size=(Tc, 1))
    lo_s = np.tile(np.asarray(eq.objective.lo)[None, :], (Tc, 1))
    hi_s = np.full((Tc, n), np.inf)
    opts_s = AdmmOptions(max_iters=4000, eps_abs=1e-6, eps_rel=1e-6, projection=cfg_main)
    _build.reset_launch_counts()
    plain6 = {}
    t0 = time.perf_counter()
    with count_plain_calls(plain6):
        out_s = solve_batch_folded(compiled, c_s, np.maximum(lo_s, -3e38),
                                   np.full((Tc, n), 3e38), options=opts_s, chunk=250)
        solve_s = time.perf_counter() - t0
        entry = certify_batch(compiled, c_s, lo_s, hi_s, out_s.deltas, out_s.lambdas,
                              out_s.prices, psi_claimed=_psi_batch(
                                  compiled, out_s.deltas, out_s.lambdas))
        t1 = time.perf_counter()
        ref_s = refine_sweep(compiled, c_s, lo_s, hi_s, out_s, target_gap=1e-6)
        refine_s = time.perf_counter() - t1
    launches6c = dict(_build.LAUNCHES)
    n_ok = int(np.sum(ref_s.achieved))
    log(f"# 6c certified sweep, 10k pools x {Tc} objectives: folded fused solve "
        f"{int(out_s.iters[0])} iterations in {solve_s:.3f} s (converged "
        f"{bool(out_s.converged[0])}); refine_sweep {ref_s.iters} correction iterations "
        f"in {refine_s:.3f} s; {n_ok}/{Tc} points certified at 1e-6; launches {launches6c}")
    if launches6c["fused_step_fold"] == 0 or launches6c["fused_step_delta_fold"] == 0:
        raise AssertionError(f"6c: a fold kernel never launched: {launches6c}")
    if plain6:
        raise AssertionError(f"6c: plain versions ran: {plain6}")
    for t, (ct, ce) in enumerate(zip(ref_s.certificates, entry)):
        vals = (ct.objective, ct.dual_bound, ct.gap_rel, ct.feasibility_rel)
        if not all(math.isfinite(x) for x in vals) or not score(ct) <= score(ce):
            raise AssertionError(f"6c point {t}: {ct.summary()} (entry {score(ce):.3e})")
    out["certified_sweep"] = dict(
        T=Tc, solve_iters=int(out_s.iters[0]), solve_s=solve_s, refine_iters=int(ref_s.iters),
        refine_s=refine_s, certified=n_ok, launches=launches6c,
        entry_worst=max(score(ce) for ce in entry),
        final_worst=max(score(ct) for ct in ref_s.certificates))

    # ---- 6d. the reference's 51-point frontier (two-asset.py) ---------------
    spec, _ = two_asset_instance()
    _build.reset_launch_counts()
    plain6 = {}
    t0 = time.perf_counter()
    with count_plain_calls(plain6):
        sw = api.sweep(spec, 0, 2, np.linspace(0, 50, 51), refine_to=1e-6)
    sweep_s = time.perf_counter() - t0
    launches6d = dict(_build.LAUNCHES)
    u25 = float(sw.utilities[25])
    rel25 = abs(u25 - 31.005495) / 31.005495
    worst = max(score(ct) for ct in sw.certificates)
    log(f"# 6d 51-point frontier: {sweep_s:.3f} s (host clock, base solve + refinement); "
        f"{int(np.sum(sw.converged))}/51 certified at 1e-6 (worst score {worst:.3e}); "
        f"u(25) {u25:.7f} (rel {rel25:.2e} vs 31.005495); launches {launches6d}")
    if plain6:
        raise AssertionError(f"6d: plain versions ran: {plain6}")
    if not (bool(np.all(sw.converged)) and worst <= 1e-6 and rel25 <= 2e-6):
        raise AssertionError(f"6d: frontier not certified: worst {worst:.3e}, u(25) {u25}")
    out["frontier"] = dict(seconds=sweep_s, certified=int(np.sum(sw.converged)),
                           worst_score=worst, u25=u25, rel25=rel25, launches=launches6d)
    report["sweeps"] = out
    log(f"# phase 6 (sweeps and batches) done in {time.perf_counter() - t_phase:.1f} s on {card}")
    return [launches6b, launches6c, launches6d]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    from cfmm_routing_tpu_torch import api
    from cfmm_routing_tpu_torch.models.reference_instances import (
        arbitrage_instance, liquidation_instance, two_asset_instance,
    )
    from cfmm_routing_tpu_torch.ops import _build
    from cfmm_routing_tpu_torch.ops import projection as plain
    from cfmm_routing_tpu_torch.ops.iteration_cuda import (
        fused_step, fused_step_delta, fused_step_delta_plain, fused_step_plain,
    )
    from cfmm_routing_tpu_torch.ops.projection_cuda import (
        project_cs_cuda, project_cs_delta_cuda, project_gm_cuda,
        project_gm_delta_cuda,
    )
    from cfmm_routing_tpu_torch.ops.projection_delta import (
        project_cs_delta, project_gm_delta,
    )
    from cfmm_routing_tpu_torch.ops.segment import segment_sum, segment_sum_plain
    from cfmm_routing_tpu_torch.solver import admm as admm_mod
    from cfmm_routing_tpu_torch.solver import refine_device as rd_mod
    from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver
    from cfmm_routing_tpu_torch.solver.certify import certify
    from cfmm_routing_tpu_torch.solver.compiler import compile_spec, compile_table
    from cfmm_routing_tpu_torch.solver.precondition import equilibrate, unscale_result
    from cfmm_routing_tpu_torch.solver.refine import to_host
    from cfmm_routing_tpu_torch.solver.refine_device import (
        DeltaAdmmSolver, _delta_objective, _prep_delta_solve, _psi_from_trades,
        refine_device,
    )
    from cfmm_routing_tpu_torch.utils.synth import (
        mixed_width_arbitrage, random_arbitrage_table,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    t_script = time.perf_counter()

    # ---- 1. card, versions, build -------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = f"{smi} (nvidia-smi name, power.limit)"
    log(f"# card: {card}")
    log(f"# torch {torch.__version__}  CUDA {torch.version.cuda}  "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build_times = _build.build()
    log(f"# kernels built in {time.perf_counter() - t0:.1f} s "
        f"(per library: {build_times})")
    report.update(card=smi, torch=torch.__version__, cuda=torch.version.cuda,
                  build_s=build_times)

    @contextlib.contextmanager
    def plain_versions():
        """For the comparison runs only: the solver modules' kernel
        wrappers are replaced by their plain PyTorch versions."""
        swaps = [(admm_mod, "fused_step", fused_step_plain),
                 (admm_mod, "project_gm_cuda", plain.project_gm),
                 (admm_mod, "project_cs_cuda", plain.project_cs),
                 (admm_mod, "segment_sum", segment_sum_plain),
                 (rd_mod, "fused_step_delta", fused_step_delta_plain),
                 (rd_mod, "project_gm_delta_cuda", project_gm_delta),
                 (rd_mod, "project_cs_delta_cuda", project_cs_delta)]
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        try:
            yield
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)

    # ---- the full-width problem ---------------------------------------------
    t0 = time.perf_counter()
    table, obj = random_arbitrage_table(256, 100_000, seed=7)
    eq = equilibrate(table, obj)
    compiled = compile_table(eq.table, pad_pools_to=1024)
    shapes = {n: (b.m, b.width) for n, b in compiled.buckets.items()}
    log(f"# 100k pools / 256 assets: buckets {shapes} "
        f"({compiled.n_slots} real slots; built in {time.perf_counter() - t0:.1f} s)")
    if shapes != EXPECTED_BUCKETS:
        raise AssertionError(f"bucket shapes {shapes} != {EXPECTED_BUCKETS}")
    cfg_main = plain.ProjectionConfig(n_bisect=24, n_polish=4)
    cfg64 = plain.ProjectionConfig()
    opts = AdmmOptions(max_iters=500, eps_abs=0.0, eps_rel=0.0, adapt_rho=False,
                       projection=cfg_main)

    # ---- 2a. base kernels vs plain at the full-width shapes ------------------
    t_phase = time.perf_counter()
    solver = AdmmSolver(compiled, dtype=torch.float32, options=opts)
    c, lo, hi = solver._objective_arrays(eq.objective)
    rho = solver._t(1.0)
    s, wdef, nu = solver.fused_init()
    with plain_versions():
        for _ in range(20):
            s, wdef, nu, _, _ = solver._iterate_fused(s, wdef, nu, rho, c, lo, hi)
    z = solver.fused_to_z(s, wdef)
    v, _ = solver._fold_pack(wdef - nu)
    solver64 = AdmmSolver(compiled, dtype=torch.float64)
    n_pad = v.shape[0]
    rows = {k: [] for k in SOURCES}
    for name, arrs in solver.buckets.items():
        kind, floor = solver._meta[name]
        K, m = arrs["mask"].shape
        nu_e = solver._bcast_nu(nu, name)
        p, q = z[name][0] - nu_e, z[name][1] + nu_e
        kname = "project_gm" if kind == "gm" else "project_cs"
        for dtype, slv, cfg, atol in ((torch.float32, solver, cfg_main, 5e-5),
                                      (torch.float64, solver64, cfg64, 1e-10)):
            a = slv.buckets[name]
            pp, qq = p.to(dtype), q.to(dtype)
            if kind == "gm":
                largs = (pp, qq, a["R"], a["w"], a["s"], a["gamma"], a["logk0"],
                         a["k0"], a["mask"])
                kfn = lambda: project_gm_cuda(*largs, needs_floor=floor, cfg=cfg)  # noqa: E731
                pfn = lambda: plain.project_gm(*largs, needs_floor=floor, cfg=cfg)  # noqa: E731
            else:
                largs = (pp, qq, a["R"], a["gamma"], a["w"], a["k0"], a["mask"])
                kfn = lambda: project_cs_cuda(*largs, cfg=cfg)  # noqa: E731
                pfn = lambda: plain.project_cs(*largs, cfg=cfg)  # noqa: E731
            got, want = kfn(), pfn()
            torch.cuda.synchronize()
            err = max_err(got, want)
            check_close(f"{kname}[{name}, {dtype}]", got, want, atol)
            row = dict(bucket=name, dtype=str(dtype).split(".")[1], K=K, m=m,
                       cfg=list(cfg), max_abs_err=err,
                       ms=graph_ms(kfn), plain_ms=graph_ms(pfn, n=2, reps=3))
            es = 4 if dtype == torch.float32 else 8
            row["bound_ms"], row["bound_by"] = bound_ms(
                gm_or_cs_bytes(kind, K, m, es), projection_flops(cfg, K, m), dtype)
            rows[kname].append(row)
            log(f"# {kname:10s} {name:5s} {row['dtype']} K={K} m={m}: max|kernel-plain| "
                f"{err:.3e}  kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.2f} ms  "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        sD, sL = s[name]
        ffn = lambda: fused_step(sD, sL, v, arrs, kind, floor, 1.0, cfg=cfg_main)  # noqa: E731
        fpl = lambda: fused_step_plain(sD, sL, v, arrs, kind, floor, 1.0, cfg=cfg_main)  # noqa: E731
        got, want = ffn(), fpl()
        torch.cuda.synchronize()
        err = max_err(got, want)
        check_fused(f"fused_step[{name}]", got, want, 2e-5)
        y_rel = float(((got[4] - want[4]).abs() / want[4].abs().clamp_min(1.0)).max())
        log(f"# fused_step {name:5s}: max|planes| err {max_err(got[:4], want[:4]):.3e}, "
            f"y max|y| {float(want[4].abs().max()):.4g} max rel err {y_rel:.3e}")
        row = dict(bucket=name, dtype="float32", K=K, m=m, cfg=list(cfg_main),
                   max_abs_err=err, y_max_rel_err=y_rel, ms=graph_ms(ffn),
                   plain_ms=eager_ms(fpl))
        # sD sL R w s mask + asset ids + gamma logk0 k0 + v in;
        # sD' sL' D L + the consensus-term plane out
        fbytes = 4 * (11 * K * m + 3 * m + n_pad) + 4 * K * m
        row["bound_ms"], row["bound_by"] = bound_ms(
            fbytes, projection_flops(cfg_main, K, m), torch.float32)
        rows["fused_step"].append(row)
        log(f"# fused_step {name:5s} float32 K={K} m={m}: max|kernel-plain| {err:.3e}  "
            f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.2f} ms  "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        # the segment sum on this bucket's consensus terms (alpha = 1)
        val = (want[3] - want[2]).contiguous()
        order, seg = arrs["order"], arrs["seg"]
        sfn = lambda: segment_sum(val, order, seg, n_pad)  # noqa: E731
        spl = lambda: segment_sum_plain(val, order, seg, n_pad)  # noqa: E731
        got_y, want_y = sfn(), spl()
        torch.cuda.synchronize()
        if not torch.equal(got_y, want_y):
            raise AssertionError(f"segment_sum[{name}] is not bitwise equal to "
                                 f"its plain version ({max_err([got_y], [want_y]):.3e})")
        # the library call for the same sum: index_add_ over every slot's
        # asset id (padding slots add their zero), in no fixed order
        ids, flat, y0 = arrs["asset"].reshape(-1).long(), val.reshape(-1), torch.zeros_like(v)
        lfn = lambda: torch.index_add(y0, 0, ids, flat)  # noqa: E731
        check_close(f"index_add_[{name}]", [lfn()], [want_y], 1e-4 * float(want_y.abs().max()),
                    rtol=1e-4)
        n_real = int(order.numel())
        row = dict(bucket=name, dtype="float32", K=K, m=m, n_real=n_real,
                   max_abs_err=0.0, ms=graph_ms(sfn), plain_ms=eager_ms(spl),
                   library_ms=graph_ms(lfn))
        row["bound_ms"], row["bound_by"] = bound_ms(
            segment_bytes(n_real, solver.n, n_pad, 4), n_real, torch.float32)
        rows["segment_sum"].append(row)
        log(f"# segment_sum {name:5s} ({n_real} real slots): bitwise equal; kernel "
            f"{row['ms']:.4f} ms  plain {row['plain_ms']:.2f} ms  index_add_ "
            f"{row['library_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    del solver64
    log(f"# phase 2a (base kernels vs plain) done in {time.perf_counter() - t_phase:.1f} s")

    # ---- 2b. fused_step_delta vs plain on real delta arrays -----------------
    t_phase = time.perf_counter()
    base = to_host(solver.solve_fused(eq.objective, iters=20))
    base = base._replace(psi=_psi_from_trades(compiled, base))
    rho_d = float(np.clip(np.asarray(base.rho_final), 0.25, 4.0))
    nu0f = (np.asarray(base.prices, np.float64) / rho_d).astype(np.float32).astype(np.float64)
    eps = 1e-3
    dobj = _delta_objective(eq.objective, base.psi, eps)
    delta_opts = AdmmOptions(adapt_rho=False, projection=cfg64)
    for dtype, atol in ((torch.float32, 2e-5), (torch.float64, 1e-10)):
        ds = DeltaAdmmSolver(compiled, dtype=dtype, options=delta_opts)
        bdict, min_x0 = ds.delta_buckets(base, eps, nu0=nu0f)
        if not min_x0 > 0:
            raise AssertionError(f"100k base point has min x0 = {min_x0}")
        dc, dlo, dhi, start = _prep_delta_solve(dobj, nu0f, rho_d, ds)
        rho_t = ds._t(rho_d)
        st, wd, dnu = ds.fused_init(bdict)
        dnu = ds._t(start)
        with plain_versions():
            for _ in range(5):
                st, wd, dnu, _, _ = ds._iterate_fused(st, wd, dnu, rho_t, dc, dlo, dhi,
                                                      buckets=bdict)
        dv, _ = ds._fold_pack(wd - dnu)
        for name, arrs in bdict.items():
            kind, floor = ds._meta[name]
            K, m = arrs["mask"].shape
            sD, sL = st[name]
            kfn = lambda: fused_step_delta(sD, sL, dv, arrs, kind, floor, 1.0, cfg=cfg64)  # noqa: E731
            pfn = lambda: fused_step_delta_plain(sD, sL, dv, arrs, kind, floor, 1.0, cfg=cfg64)  # noqa: E731
            got, want = kfn(), pfn()
            torch.cuda.synchronize()
            err = max_err(got, want)
            dname = str(dtype).split(".")[1]
            check_fused(f"fused_step_delta[{name}, {dname}]", got, want, atol)
            row = dict(bucket=name, dtype=dname, K=K, m=m, cfg=list(cfg64),
                       max_abs_err=err, planes_err=max_err(got[:4], want[:4]),
                       ms=graph_ms(kfn), plain_ms=eager_ms(pfn))
            es = 4 if dtype == torch.float32 else 8
            # sD sL X0 w sS aD aL mask nu0e + asset ids + gamma nsig + v in;
            # sD' sL' A B + the consensus-term plane out
            dbytes = es * (14 * K * m + 2 * m + n_pad) + 4 * K * m
            row["bound_ms"], row["bound_by"] = bound_ms(
                dbytes, projection_flops(cfg64, K, m, per_step=80), dtype)
            rows["fused_step_delta"].append(row)
            log(f"# fused_step_delta {name:5s} {dname} K={K} m={m}: max|kernel-plain| "
                f"planes {row['planes_err']:.3e} all {err:.3e}  kernel {row['ms']:.4f} ms  "
                f"plain {row['plain_ms']:.2f} ms  bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']})")
            # the standalone delta projection at this step's input
            off = ds._bcast_nu(wd - dnu, name, bdict) - arrs["nu0e"]
            kfn, pfn = delta_projection_calls(
                kind, floor, sD + off, sL - off, arrs, cfg64,
                (project_gm_delta_cuda, project_cs_delta_cuda),
                (project_gm_delta, project_cs_delta))
            got, want = kfn(), pfn()
            torch.cuda.synchronize()
            kname = "project_gm_delta" if kind == "gm" else "project_cs_delta"
            check_close(f"{kname}[{name}, {dname}]", got, want,
                        5e-5 if dtype == torch.float32 else 1e-10)
            row = dict(bucket=name, dtype=dname, K=K, m=m, cfg=list(cfg64),
                       max_abs_err=max_err(got, want), ms=graph_ms(kfn),
                       plain_ms=graph_ms(pfn, n=2, reps=3))
            # p q X0 w (sS) aD aL mask + gamma nsig in; a b out
            planes = 10 if kind == "gm" else 9
            row["bound_ms"], row["bound_by"] = bound_ms(
                es * (planes * K * m + 2 * m), projection_flops(cfg64, K, m, per_step=80),
                dtype)
            rows[kname].append(row)
            log(f"# {kname} {name:5s} {dname} K={K} m={m}: max|kernel-plain| "
                f"{row['max_abs_err']:.3e}  kernel {row['ms']:.4f} ms  plain "
                f"{row['plain_ms']:.2f} ms  bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        del ds, bdict, st
    log(f"# phase 2b (fused_step_delta vs plain) done in {time.perf_counter() - t_phase:.1f} s")

    # ---- 2c. any K: run-time-K and K = 4, 8, 16 instantiations ---------------
    t_phase = time.perf_counter()
    spec_w, obj_w = mixed_width_arbitrage(seed=2)
    cfg_w = plain.ProjectionConfig()
    any_k = []
    for pad_pow2 in (False, True):
        comp_w = compile_spec(spec_w, pad_pow2=pad_pow2, pad_pools_to=128)
        widths = sorted({b.width for b in comp_w.buckets.values()})
        want_w = [4, 8, 16] if pad_pow2 else [3, 5, 12]
        if widths != want_w:
            raise AssertionError(f"widths {widths} != {want_w}")
        sw = AdmmSolver(comp_w, options=AdmmOptions(max_iters=200, check_every=25,
                                                    projection=cfg_w))
        base_w = to_host(sw.solve(obj_w))
        dsw = DeltaAdmmSolver(comp_w, options=AdmmOptions(adapt_rho=False,
                                                          projection=cfg_w))
        nu_w = np.asarray(base_w.prices).astype(np.float32).astype(np.float64)  # rho 1
        bd_w, min_x0 = dsw.delta_buckets(base_w, 1e-3, nu0=nu_w)
        if not min_x0 > 0:
            raise AssertionError(f"mixed-width base point has min x0 = {min_x0}")
        rng = np.random.default_rng(5)
        vw = torch.as_tensor(rng.normal(size=128), dtype=torch.float32, device="cuda")
        worst = 0.0
        for name, arrs in sw.buckets.items():
            kind, floor = sw._meta[name]
            K, m = arrs["mask"].shape
            sD, sL = (torch.as_tensor(rng.uniform(-2, 2, (K, m)), dtype=torch.float32,
                                      device="cuda") * arrs["mask"] for _ in range(2))
            if kind == "gm":
                largs = (sD, sL, arrs["R"], arrs["w"], arrs["s"], arrs["gamma"],
                         arrs["logk0"], arrs["k0"], arrs["mask"])
                got = project_gm_cuda(*largs, needs_floor=floor, cfg=cfg_w)
                want = plain.project_gm(*largs, needs_floor=floor, cfg=cfg_w)
            else:
                largs = (sD, sL, arrs["R"], arrs["gamma"], arrs["w"], arrs["k0"],
                         arrs["mask"])
                got = project_cs_cuda(*largs, cfg=cfg_w)
                want = plain.project_cs(*largs, cfg=cfg_w)
            torch.cuda.synchronize()
            check_close(f"any-K projection[{name}, K={K}]", got, want, 5e-5)
            worst = max(worst, max_err(got, want))
            kfn, pfn = delta_projection_calls(
                kind, floor, sD, sL, bd_w[name], cfg_w,
                (project_gm_delta_cuda, project_cs_delta_cuda),
                (project_gm_delta, project_cs_delta))
            got, want = kfn(), pfn()
            torch.cuda.synchronize()
            check_close(f"any-K delta projection[{name}, K={K}]", got, want, 5e-5)
            worst = max(worst, max_err(got, want))
            for label, kfn, pfn, a2 in (
                    ("fused_step", fused_step, fused_step_plain, arrs),
                    ("fused_step_delta", fused_step_delta, fused_step_delta_plain,
                     bd_w[name])):
                got = kfn(sD, sL, vw, a2, kind, floor, 1.5, cfg=cfg_w)
                want = pfn(sD, sL, vw, a2, kind, floor, 1.5, cfg=cfg_w)
                torch.cuda.synchronize()
                check_fused(f"any-K {label}[{name}, K={K}]", got, want, 2e-5)
                worst = max(worst, max_err(got[:4], want[:4]))
            any_k.append(dict(pad_pow2=pad_pow2, bucket=name, K=K, m=m))
        log(f"# any K (pad_pow2={pad_pow2}): buckets "
            f"{[(n, b.width) for n, b in comp_w.buckets.items()]}; all six kernels "
            f"match their plain versions (worst plane error {worst:.3e})")
        # the run-time-K fused step's time on the widest bucket
        name = max(sw.buckets, key=lambda n: sw.buckets[n]["mask"].shape[0])
        arrs = sw.buckets[name]
        kind, floor = sw._meta[name]
        sD = sL = torch.zeros_like(arrs["mask"])
        t_k = graph_ms(lambda: fused_step(sD, sL, vw, arrs, kind, floor, 1.0, cfg=cfg_w))
        any_k.append(dict(pad_pow2=pad_pow2, timed_bucket=name,
                          K=int(arrs["mask"].shape[0]), m=int(arrs["mask"].shape[1]),
                          fused_step_ms=t_k))
        log(f"# any K (pad_pow2={pad_pow2}): fused_step on {name} "
            f"(K={arrs['mask'].shape[0]}, m={arrs['mask'].shape[1]}) {t_k:.4f} ms")
    report["any_k"] = any_k
    log(f"# phase 2c (any K) done in {time.perf_counter() - t_phase:.1f} s")
    report["kernel_checks"] = rows

    # ---- 3. reference pins on the card ---------------------------------------
    t_phase = time.perf_counter()
    pin_opts = AdmmOptions(max_iters=30000, eps_abs=1e-11, eps_rel=1e-11,
                           check_every=25)
    bench_opts = AdmmOptions(max_iters=6000, eps_abs=2e-6, eps_rel=2e-6)
    instances = {"arbitrage": arbitrage_instance, "liquidation": liquidation_instance,
                 "two-asset t=25": lambda: two_asset_instance(25.0)}

    def api_call(label, **kw):
        spec, o = instances[label]()
        if label == "arbitrage":
            route = api.arbitrage(spec, o.c, **kw)
            return route, route.objective
        if label == "liquidation":
            route = api.liquidate(spec, [2, 1, 3, 5, 10], numeraire=4, **kw)
            return route, float(route.psi[4])
        route = api.route(spec, o, **kw)
        return route, route.objective

    pins = []
    for (label, pin) in PINS:
        for mode, kw, bar in (
                ("float64 certify", dict(certify=True, dtype=torch.float64,
                                         options=pin_opts), 1e-6),
                ("float32 refine_to=1e-7", dict(refine_to=1e-7, options=bench_opts),
                 2e-6)):
            t0 = time.perf_counter()
            route, value = api_call(label, **kw)
            rel = abs(value - pin) / abs(pin)
            cert = route.certificate
            log(f"# pin {label} ({mode}): {value:.9f} vs {pin} (rel {rel:.2e}) "
                f"iters {route.iters} gap_rel {cert.gap_rel:.3e} feasibility_rel "
                f"{cert.feasibility_rel:.3e} ({time.perf_counter() - t0:.2f} s)")
            if not rel < bar:
                raise AssertionError(f"pin {label} ({mode}): {value} is {rel:.2e} from {pin}")
            if "refine" in mode and not route.converged:
                raise AssertionError(f"pin {label} ({mode}): not certified: {cert.summary()}")
            pins.append(dict(label=label, mode=mode, value=value, pin=pin, rel=rel,
                             iters=route.iters, gap_rel=cert.gap_rel,
                             feasibility_rel=cert.feasibility_rel))

    class CountingDeltaSolver(DeltaAdmmSolver):
        """Counts the correction solves (chunks) refine_device runs."""
        chunks = 0

        def solve_delta(self, *a, **k):
            self.chunks += 1
            return super().solve_delta(*a, **k)

    refine_opts = dataclasses.replace(AdmmOptions(), eps_abs=1e-8, eps_rel=1e-8,
                                      adapt_rho=False)  # refine_device's own
    for (label, pin) in PINS:
        spec, o = instances[label]()
        comp128 = compile_spec(spec, pad_pools_to=128)
        res = AdmmSolver(comp128, options=bench_opts).solve(o)
        dsolver = CountingDeltaSolver(comp128, options=refine_opts)
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        out = refine_device(comp128, o, res, target_gap=1e-7, fused=True, solver=dsolver)
        torch.cuda.synchronize()
        fused_iters = out.iters - dsolver.chunks  # each chunk: k fused + 1 classic
        launches = _build.LAUNCHES["fused_step_delta"]
        value = float(out.result.psi[4]) if label == "liquidation" else float(
            out.certificate.objective)
        rel = abs(value - pin) / abs(pin)
        log(f"# refine_device(fused=True) {label}: {value:.9f} (rel {rel:.2e}) "
            f"gap_rel {out.certificate.gap_rel:.3e} feasibility_rel "
            f"{out.certificate.feasibility_rel:.3e}; {dsolver.chunks} chunks, "
            f"{fused_iters} fused iterations, fused_step_delta launches {launches} "
            f"({time.perf_counter() - t0:.2f} s)")
        if not (out.achieved and rel < 2e-6):
            raise AssertionError(f"refine_device(fused=True) {label}: "
                                 f"{out.certificate.summary()} rel {rel:.2e}")
        if launches != len(comp128.buckets) * fused_iters or launches == 0:
            raise AssertionError(f"fused_step_delta launches {launches} != "
                                 f"{len(comp128.buckets)} x {fused_iters}")
        pins.append(dict(label=label, mode="refine_device(fused=True)", value=value,
                         pin=pin, rel=rel, chunks=dsolver.chunks,
                         fused_iters=fused_iters, launches=launches,
                         gap_rel=out.certificate.gap_rel,
                         feasibility_rel=out.certificate.feasibility_rel))
    log(f"# phase 3 (pins) done in {time.perf_counter() - t_phase:.1f} s")
    report["pins"] = pins

    # ---- 4. the main path at full width -------------------------------------
    t_phase = time.perf_counter()
    _build.reset_launch_counts()
    table, obj = random_arbitrage_table(256, 100_000, seed=7)
    eq = equilibrate(table, obj)
    compiled = compile_table(eq.table, pad_pools_to=1024)
    solver = AdmmSolver(compiled, dtype=torch.float32, options=opts)
    res = solver.solve_fused(eq.objective, iters=499)
    res0 = unscale_result(res, eq.d, compiled)
    cert = certify(compile_table(table, pad_pools_to=1024), obj, res0.deltas,
                   res0.lambdas, res0.prices, psi_claimed=res0.psi)
    torch.cuda.synchronize()
    launches4 = dict(_build.LAUNCHES)
    log(f"# main path (fused base): launches {launches4} "
        f"({time.perf_counter() - t_phase:.1f} s with the host set-up)")
    missing = [k for k in ("project_gm", "project_cs", "fused_step", "segment_sum")
               if launches4[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    expect_fused = 499 * len(compiled.buckets)
    if launches4["fused_step"] != expect_fused:
        raise AssertionError(f"fused_step launches {launches4['fused_step']} != {expect_fused}")
    obj_k = float(res.objective)
    psi0 = np.asarray(res0.psi)
    if not (math.isfinite(obj_k) and psi0.shape == (256,) and np.isfinite(psi0).all()):
        raise AssertionError("main path returned a non-finite or misshapen result")
    cvals = [cert.objective, cert.dual_bound, cert.gap_rel, cert.feasibility_rel]
    if not all(math.isfinite(x) for x in cvals):
        raise AssertionError(f"certificate not finite: {cert.summary()}")
    log(f"# certificate: {cert.summary()}  feasibility_rel {cert.feasibility_rel:.3e}")

    def bitwise_equal(a, b):
        leaves = [(a.objective, b.objective), (a.psi, b.psi), (a.prices, b.prices)]
        leaves += [(a.deltas[k], b.deltas[k]) for k in a.deltas]
        leaves += [(a.lambdas[k], b.lambdas[k]) for k in a.lambdas]
        return all(torch.equal(x, y) for x, y in leaves)

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    res2 = solver.solve_fused(eq.objective, iters=499)
    stop.record()
    stop.synchronize()
    fused_s = start.elapsed_time(stop) / 1e3
    log(f"# fused kernel path: 500 iterations in {fused_s:.4f} s -> "
        f"{500 / fused_s:.1f} it/s on {smi}; objective {obj_k:.6f}")
    if not bitwise_equal(res, res2):
        raise AssertionError("a second fused kernel run is not bitwise equal to the first")
    classic50 = AdmmSolver(compiled, dtype=torch.float32, options=dataclasses.replace(
        opts, max_iters=50))
    if not bitwise_equal(classic50.solve(eq.objective), classic50.solve(eq.objective)):
        raise AssertionError("two 50-iteration classic solves are not bitwise equal")
    log("# repeat runs: two 499+1-iteration fused solves and two 50-iteration classic "
        "solves are bitwise equal (objective, psi, prices, every D/L plane)")

    # device time of one whole fused iteration (graph replay: no host
    # launch gaps) against the eager loop's time per iteration
    st = solver.fused_init()
    rho = solver._t(1.0)
    c, lo, hi = solver._objective_arrays(eq.objective)
    iter_dev_ms = graph_ms(
        lambda: solver._iterate_fused(*st, rho, c, lo, hi), n=10, reps=5)
    iter_wall_ms = 1e3 * fused_s / 500
    idle = 1.0 - iter_dev_ms / iter_wall_ms
    log(f"# one fused iteration: {iter_dev_ms:.4f} ms on the device (CUDA graph) vs "
        f"{iter_wall_ms:.4f} ms per iteration in the eager loop: the card idles "
        f"{100 * idle:.1f}% of the loop")

    t0 = time.perf_counter()
    res_c = solver.solve(eq.objective)
    torch.cuda.synchronize()
    classic_s = time.perf_counter() - t0
    with plain_versions():
        t0 = time.perf_counter()
        res_p = solver.solve_fused(eq.objective, iters=499)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    obj_c, obj_p = float(res_c.objective), float(res_p.objective)
    rel_c = abs(obj_k - obj_c) / max(1.0, abs(obj_c))
    rel_p = abs(obj_k - obj_p) / max(1.0, abs(obj_p))
    log(f"# classic kernel path: {int(res_c.iters)} iterations in {classic_s:.3f} s "
        f"({int(res_c.iters) / classic_s:.1f} it/s, host clock); objective {obj_c:.6f} "
        f"(rel {rel_c:.2e} vs fused)")
    log(f"# fused plain path: 500 iterations in {plain_s:.2f} s "
        f"({500 / plain_s:.1f} it/s, host clock); objective {obj_p:.6f} "
        f"(rel {rel_p:.2e} vs kernel)")
    if not (rel_c <= 1e-3 and rel_p <= 1e-3):
        raise AssertionError(f"objective mismatch: classic {rel_c:.2e}, plain {rel_p:.2e}")
    report["main_path"] = dict(
        launches=launches4, objective=obj_k, fused_iters_per_s=500 / fused_s,
        classic_iters_per_s=int(res_c.iters) / classic_s,
        plain_iters_per_s=500 / plain_s, rel_classic=rel_c, rel_plain=rel_p,
        iteration_device_ms=iter_dev_ms, iteration_wall_ms=iter_wall_ms,
        idle_share=idle, repeat_bitwise_equal=True,
        r_norm=float(res.r_norm), s_norm=float(res.s_norm),
        certificate=dict(objective=cert.objective, dual_bound=cert.dual_bound,
                         gap_rel=cert.gap_rel, feasibility_rel=cert.feasibility_rel),
    )
    del solver, classic50, res, res2, res_c, res_p
    log(f"# phase 4 (main path) done in {time.perf_counter() - t_phase:.1f} s")

    # ---- 5. the certified route at full width --------------------------------
    t_phase = time.perf_counter()
    fallbacks = []

    class Fallbacks(logging.Handler):
        def emit(self, record):
            if record.levelno >= logging.WARNING:
                fallbacks.append(record.getMessage())

    rd_log = logging.getLogger("cfmm_routing_tpu_torch.refine_device")
    rd_log.setLevel(logging.DEBUG)
    rd_log.addHandler(Fallbacks())
    chunk_log = logging.StreamHandler(sys.stdout)
    chunk_log.setFormatter(logging.Formatter("# %(message)s"))
    rd_log.addHandler(chunk_log)

    _build.reset_launch_counts()
    t_start = time.perf_counter()
    table, obj = random_arbitrage_table(256, 100_000, seed=7)
    eq = equilibrate(table, obj)
    compiled = compile_table(eq.table, pad_pools_to=1024)
    cert_compiled = compile_table(table, pad_pools_to=1024)
    base_solver = AdmmSolver(compiled, dtype=torch.float32, options=AdmmOptions(
        max_iters=3000, eps_abs=1e-7, eps_rel=1e-7, check_every=25,
        projection=cfg_main))
    t_base0 = time.perf_counter()
    res = base_solver.solve(eq.objective)
    torch.cuda.synchronize()
    base_s = time.perf_counter() - t_base0
    base_iters = int(res.iters)
    log(f"# certified route: base solve {base_iters} classic iterations in "
        f"{base_s:.3f} s (converged {bool(res.converged)})")

    def unscale(r):
        return unscale_result(r, eq.d, compiled)

    r0 = unscale(to_host(res))
    entry = certify(cert_compiled, obj, r0.deltas, r0.lambdas, r0.prices,
                    psi_claimed=r0.psi)
    log(f"# certified route: entry certificate {entry.summary()} "
        f"feasibility_rel {entry.feasibility_rel:.3e}")
    dsolver = CountingDeltaSolver(compiled, options=refine_opts)
    t0 = time.perf_counter()
    out = refine_device(compiled, eq.objective, res, target_gap=1e-6,
                        cert_space=(cert_compiled, obj, unscale), entry_cert=entry,
                        solver=dsolver)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    refine_s = t_end - t0
    wall_s = t_end - t_base0
    launches5 = dict(_build.LAUNCHES)
    rd_log.removeHandler(chunk_log)
    fc = out.certificate
    fused_iters = out.iters - dsolver.chunks
    log(f"# certified route: refinement {out.iters} iterations ({dsolver.chunks} "
        f"chunks, {fused_iters} fused) in {refine_s:.3f} s")
    log(f"# certified route: final gap_rel {fc.gap_rel:.3e} feasibility_rel "
        f"{fc.feasibility_rel:.3e}; target 1e-6 achieved: {bool(out.achieved)}")
    log(f"# certified route: wall clock from the start of the base solve to the "
        f"accepted certificate {wall_s:.3f} s (network set-up before it: "
        f"{t_base0 - t_start:.3f} s)")
    log(f"# certified route: launches {launches5}")
    if launches5["fused_step_delta"] == 0:
        raise AssertionError("fused_step_delta was never launched on the certified route")
    if launches5["fused_step_delta"] != len(compiled.buckets) * fused_iters:
        raise AssertionError(f"fused_step_delta launches {launches5['fused_step_delta']} "
                             f"!= {len(compiled.buckets)} x {fused_iters}")
    missing = [k for k in ("project_gm", "project_cs", "project_gm_delta",
                           "project_cs_delta", "segment_sum") if launches5[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the certified route: {missing}")
    if fallbacks:
        raise AssertionError(f"refine_device took a fallback: {fallbacks}")
    score = lambda ct: max(abs(ct.gap_rel), ct.feasibility_rel)  # noqa: E731
    if not all(math.isfinite(x) for x in (fc.objective, fc.dual_bound, fc.gap_rel,
                                          fc.feasibility_rel)):
        raise AssertionError(f"certificate not finite: {fc.summary()}")
    if not score(fc) <= score(entry):
        raise AssertionError(f"refinement made the certificate worse: "
                             f"{score(fc):.3e} > {score(entry):.3e}")
    report["certified_route"] = dict(
        base_iters=base_iters, base_s=base_s, refine_iters=int(out.iters),
        refine_chunks=dsolver.chunks, fused_iters=fused_iters, refine_s=refine_s,
        wall_s=wall_s, achieved=bool(out.achieved), launches=launches5,
        entry=dict(gap_rel=entry.gap_rel, feasibility_rel=entry.feasibility_rel),
        final=dict(objective=fc.objective, dual_bound=fc.dual_bound,
                   gap_rel=fc.gap_rel, feasibility_rel=fc.feasibility_rel),
    )
    log(f"# phase 5 (certified route) done in {time.perf_counter() - t_phase:.1f} s")
    del base_solver, dsolver, res, out

    # ---- 6. sweeps and batches ------------------------------------------------
    phase6 = sweep_phase(report, rows, card=smi, cfg_main=cfg_main, cfg64=cfg64)
    main_launches = [launches4, launches5] + phase6

    # ---- report -------------------------------------------------------------
    kernels = []
    for kname, (src, replaces) in SOURCES.items():
        dtype = "float32"
        f32 = [r for r in rows[kname] if r["dtype"] == dtype]
        # one main-path iteration's worth: every bucket the kernel serves
        tot = {k: sum(r[k] for r in f32) for k in ("ms", "plain_ms", "bound_ms")}
        kernels.append(dict(
            name=kname, route="cuda", source=src, replaces=replaces,
            launches=sum(counts[kname] for counts in main_launches),
            max_abs_err=max(r["max_abs_err"] for r in f32),
            ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
            bound_by=("operations" if all(r["bound_by"] == "operations" for r in f32)
                      else "bytes"),
            # no PyTorch call projects onto a trading set; index_add_ sums
            # the consensus terms as the segment sum does
            library_ms=(sum(r["library_ms"] for r in f32) if "library_ms" in f32[0]
                        else None),
        ))
    report["kernels"] = kernels
    report["script_s"] = time.perf_counter() - t_script
    log(f"# chip_smoke done in {report['script_s']:.1f} s")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
