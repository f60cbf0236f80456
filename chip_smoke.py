#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card and check it.

Run from the repository root on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py [--out results.json]

Phases (any failure raises and the script exits nonzero):

1. The card's name and power limit, the torch and CUDA versions, and the
   build of every CUDA kernel from ``cfmm_routing_tpu_torch/csrc``.
2. Each kernel against its plain PyTorch version on the card, at the five
   bucket shapes of the 100k-pool network, from a mid-solve state (20 plain
   fused iterations): ``project_gm`` (gm2, gm2f, gm4) and ``project_cs``
   (cs2f, cs4f) in float32 at the main path's ProjectionConfig(24, 4) and in
   float64 at the default (48, 6); ``fused_step`` on every bucket.
   Tolerances: projections atol 5e-5 (float32) / 1e-10 (float64); the fused
   step atol 2e-5 on (sD', sL', D, L) and atol 2e-5 + rtol 1e-5 on y, whose
   per-asset sums of thousands of slots are taken with atomics.
3. The reference optima in float64 on the card through ``api.arbitrage`` /
   ``api.liquidate`` / ``api.route`` with ``certify=True``; each pin must
   hold to 1e-6 relative.
4. The main path at full width: ``random_arbitrage_table(256, 100_000,
   seed=7)`` -> ``equilibrate`` -> ``compile_table(pad_pools_to=1024)`` ->
   ``AdmmSolver.solve_fused(iters=499)`` in float32 -> ``unscale_result`` ->
   ``certify``, with every kernel's launch count reset just before and read
   just after.  The kernel path's objective must match the plain path's
   (the same solve with the solver's kernel wrappers replaced by their
   plain versions) and the classic path's to 1e-3 relative, and a second
   kernel run must match the first to 1e-5 relative.

It prints one JSON line describing every kernel of the path (device times
from CUDA events around CUDA-graph replays of back-to-back calls, summed
over the buckets one iteration runs; bounds from this run's shapes), the
card's name and power limit as ``nvidia-smi`` reports them, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
import argparse
import contextlib
import json
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


def gm_or_cs_bytes(kind, K, m, es):
    # each input read once, each output written once
    if kind == "gm":  # p q R w s mask, gamma logk0 k0 -> D L
        return es * (8 * K * m + 3 * m)
    return es * (7 * K * m + 2 * m)  # p q R w mask, gamma k0 -> D L


def bound_ms(bytes_, flops, dtype):
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def projection_flops(cfg, K, m):
    # the Pallas kernels' own cost model: 60 flops per slot per root-find
    # step (projection_pallas.py:292-296, iteration_pallas.py:357-361)
    return 60 * (cfg.n_bisect + cfg.n_polish) * K * m


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
    from cfmm_routing_tpu_torch.ops.iteration_cuda import fused_step, fused_step_plain
    from cfmm_routing_tpu_torch.ops.projection_cuda import (
        project_cs_cuda, project_gm_cuda,
    )
    from cfmm_routing_tpu_torch.solver import admm as admm_mod
    from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver
    from cfmm_routing_tpu_torch.solver.certify import certify
    from cfmm_routing_tpu_torch.solver.compiler import compile_table
    from cfmm_routing_tpu_torch.solver.precondition import equilibrate, unscale_result
    from cfmm_routing_tpu_torch.utils.synth import random_arbitrage_table

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}

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
        """For the comparison runs only: the solver module's kernel
        wrappers are replaced by their plain PyTorch versions."""
        saved = (admm_mod.fused_step, admm_mod.project_gm_cuda,
                 admm_mod.project_cs_cuda)
        admm_mod.fused_step = fused_step_plain
        admm_mod.project_gm_cuda = plain.project_gm
        admm_mod.project_cs_cuda = plain.project_cs
        try:
            yield
        finally:
            (admm_mod.fused_step, admm_mod.project_gm_cuda,
             admm_mod.project_cs_cuda) = saved

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
    opts = AdmmOptions(max_iters=500, eps_abs=0.0, eps_rel=0.0, adapt_rho=False,
                       projection=cfg_main)

    # ---- 2. kernels vs plain at the full-width shapes ------------------------
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
    cfg64 = plain.ProjectionConfig()
    n_pad = v.shape[0]
    rows = {k: [] for k in ("project_gm", "project_cs", "fused_step")}
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
        check_close(f"fused_step[{name}]", got[:4], want[:4], 2e-5)
        check_close(f"fused_step[{name}] y", got[4:], want[4:], 2e-5, rtol=1e-5)
        y_rel = float(((got[4] - want[4]).abs() / want[4].abs().clamp_min(1.0)).max())
        log(f"# fused_step {name:5s}: max|planes| err {max_err(got[:4], want[:4]):.3e}, "
            f"y max|y| {float(want[4].abs().max()):.4g} max rel err {y_rel:.3e}")
        row = dict(bucket=name, dtype="float32", K=K, m=m, cfg=list(cfg_main),
                   max_abs_err=err, y_max_rel_err=y_rel, ms=graph_ms(ffn),
                   plain_ms=graph_ms(fpl, n=2, reps=3))
        # sD sL R w s mask (4 B) + asset ids (4 B) + gamma logk0 k0 + v in;
        # sD' sL' D L + y out
        fbytes = 4 * (10 * K * m + 3 * m + 2 * n_pad) + 4 * K * m
        row["bound_ms"], row["bound_by"] = bound_ms(
            fbytes, projection_flops(cfg_main, K, m), torch.float32)
        rows["fused_step"].append(row)
        log(f"# fused_step {name:5s} float32 K={K} m={m}: max|kernel-plain| {err:.3e}  "
            f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.2f} ms  "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    del solver64
    log(f"# phase 2 (kernels vs plain) done in {time.perf_counter() - t_phase:.1f} s")
    report["kernel_checks"] = rows

    # ---- 3. reference pins in float64 on the card ---------------------------
    t_phase = time.perf_counter()
    pin_opts = AdmmOptions(max_iters=30000, eps_abs=1e-11, eps_rel=1e-11,
                           check_every=25)
    pins = []
    for (label, pin) in PINS:
        if label == "arbitrage":
            spec, o = arbitrage_instance()
            route = api.arbitrage(spec, o.c, certify=True, dtype=torch.float64,
                                  options=pin_opts)
            value = route.objective
        elif label == "liquidation":
            spec, o = liquidation_instance()
            route = api.liquidate(spec, [2, 1, 3, 5, 10], numeraire=4, certify=True,
                                  dtype=torch.float64, options=pin_opts)
            value = float(route.psi[4])
        else:
            spec, o = two_asset_instance(25.0)
            route = api.route(spec, o, certify=True, dtype=torch.float64,
                              options=pin_opts)
            value = route.objective
        rel = abs(value - pin) / abs(pin)
        cert = route.certificate
        log(f"# pin {label}: {value:.9f} vs {pin} (rel {rel:.2e}) iters {route.iters} "
            f"gap_rel {cert.gap_rel:.3e} feasibility_rel {cert.feasibility_rel:.3e}")
        if not rel < 1e-6:
            raise AssertionError(f"pin {label}: {value} is {rel:.2e} from {pin}")
        pins.append(dict(label=label, value=value, pin=pin, rel=rel,
                         iters=route.iters, gap_rel=cert.gap_rel,
                         feasibility_rel=cert.feasibility_rel))
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
    launches = dict(_build.LAUNCHES)
    log(f"# main path: launches {launches} "
        f"({time.perf_counter() - t_phase:.1f} s with the host set-up)")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    expect_fused = 499 * len(compiled.buckets)
    if launches["fused_step"] != expect_fused:
        raise AssertionError(f"fused_step launches {launches['fused_step']} != {expect_fused}")
    obj_k = float(res.objective)
    psi0 = np.asarray(res0.psi)
    if not (math.isfinite(obj_k) and psi0.shape == (256,) and np.isfinite(psi0).all()):
        raise AssertionError("main path returned a non-finite or misshapen result")
    cvals = [cert.objective, cert.dual_bound, cert.gap_rel, cert.feasibility_rel]
    if not all(math.isfinite(x) for x in cvals):
        raise AssertionError(f"certificate not finite: {cert.summary()}")
    log(f"# certificate: {cert.summary()}  feasibility_rel {cert.feasibility_rel:.3e}")

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    res2 = solver.solve_fused(eq.objective, iters=499)
    stop.record()
    stop.synchronize()
    fused_s = start.elapsed_time(stop) / 1e3
    rel_repeat = abs(float(res2.objective) - obj_k) / max(1.0, abs(obj_k))
    log(f"# fused kernel path: 500 iterations in {fused_s:.4f} s -> "
        f"{500 / fused_s:.1f} it/s on {smi}; objective {obj_k:.6f}, "
        f"repeat run differs by {rel_repeat:.2e} relative")
    if not rel_repeat <= 1e-5:
        raise AssertionError(f"second kernel run differs by {rel_repeat:.2e}")

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
        launches=launches, objective=obj_k, fused_iters_per_s=500 / fused_s,
        classic_iters_per_s=int(res_c.iters) / classic_s,
        plain_iters_per_s=500 / plain_s, rel_classic=rel_c, rel_plain=rel_p,
        iteration_device_ms=iter_dev_ms, iteration_wall_ms=iter_wall_ms,
        idle_share=idle,
        rel_repeat=rel_repeat, r_norm=float(res.r_norm), s_norm=float(res.s_norm),
        certificate=dict(objective=cert.objective, dual_bound=cert.dual_bound,
                         gap_rel=cert.gap_rel, feasibility_rel=cert.feasibility_rel),
    )
    log(f"# phase 4 (main path) done in {time.perf_counter() - t_phase:.1f} s")

    # ---- report -------------------------------------------------------------
    sources = {
        "project_gm": ("cfmm_routing_tpu_torch/csrc/projection.cu",
                       "cfmm_routing_tpu/ops/projection_pallas.py:303"),
        "project_cs": ("cfmm_routing_tpu_torch/csrc/projection.cu",
                       "cfmm_routing_tpu/ops/projection_pallas.py:319"),
        "fused_step": ("cfmm_routing_tpu_torch/csrc/fused_step.cu",
                       "cfmm_routing_tpu/ops/iteration_pallas.py:260"),
    }
    kernels = []
    for kname, (src, replaces) in sources.items():
        f32 = [r for r in rows[kname] if r["dtype"] == "float32"]
        # one main-path iteration's worth: every bucket the kernel serves
        tot = {k: sum(r[k] for r in f32) for k in ("ms", "plain_ms", "bound_ms")}
        kernels.append(dict(
            name=kname, route="cuda", source=src, replaces=replaces,
            launches=launches[kname],
            max_abs_err=max(r["max_abs_err"] for r in f32),
            ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
            bound_by=("operations" if all(r["bound_by"] == "operations" for r in f32)
                      else "bytes"),
            library_ms=None,
        ))
    report["kernels"] = kernels
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
