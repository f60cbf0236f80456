#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card and check it.

Run from the repository root on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py [--out results.json]

Phases (any failure raises and the script exits nonzero):

1. The card's name and power limit, the torch and CUDA versions, and the
   build of every CUDA kernel from ``cfmm_routing_tpu_torch/csrc``.
2. Each kernel against its plain PyTorch version on the card.
   a. At the five bucket shapes of the 100k-pool network, from a mid-solve
      state (20 plain fused iterations): the grouped projection
      ``project_grouped`` (``project_gm`` + ``project_cs``, one launch per
      K-group: K=2: cs2f gm2 gm2f, K=4: cs4f gm4) and, launched per bucket
      as groups of one, ``project_gm_cuda`` (gm2, gm2f, gm4) and
      ``project_cs_cuda`` (cs2f, cs4f), in float32 at the main path's
      ProjectionConfig(24, 4) and in float64 at the default (48, 6), bitwise
      equal to their plain versions (and to a second launch), with the
      projection library's registers and spills;
      ``segment_sum`` on every bucket and on each K-group's slot order;
      ``fused_step`` on every bucket (a group of one) and grouped, one
      launch + one segment sum per K-group (K=2: cs2f gm2 gm2f, K=4: cs4f
      gm4), float32 and float64; the classic base's step kernels
      (``classic_step`` per K-group as a block's first and as a deferred
      step, ``consensus``, ``classic_z``) and a 24-step ``_classic_block``
      against 24 stats-free ``_iterate`` calls, float32 at (24, 4) and
      float64 at (48, 6), with the device time of a stats-free iteration
      both ways.
   b. The grouped delta kernels: ``fused_step_delta_grouped`` (with its
      segment sum) and the standalone delta projection
      ``project_delta_grouped`` (``project_gm_delta`` + ``project_cs_delta``)
      on the two K-groups of the five 100k bucket shapes (K=2: cs2f gm2
      gm2f, K=4: cs4f gm4), on the delta arrays that
      ``DeltaAdmmSolver.delta_buckets`` builds from a real 100k base solve,
      after 5 plain fused delta iterations: float32 and float64 at (48, 6),
      bitwise equal to their plain versions and to a second launch.  Device
      times per iteration from CUDA graphs, also of the same kernel
      launched once per bucket (five groups of one).
   c. Any K: a network of 3-, 5- and 12-asset pools compiled with
      ``pad_pow2=False`` (the run-time-K kernels; 4, 8 and 16 lanes per
      delta pool) and ``pad_pow2=True`` (K = 4, 8, 16), and one of
      40-asset pools (one thread per pool): every kernel in float32, the
      projections (per bucket and grouped, the grouped one in float64 too),
      the fused steps (per bucket and grouped) and the grouped delta
      kernels bitwise.
   Every kernel must be bitwise equal to its plain version, whose
   arithmetic and order of additions it shares.
3. The reference optima on the card: in float64 through ``api.arbitrage`` /
   ``api.liquidate`` / ``api.route(certify=True)``, each pin to 1e-6; in
   float32 through the same calls with ``refine_to=1e-7`` (bench.py's base
   options), each certified and pinned to 2e-6; and again compiled with
   ``pad_pools_to=128`` through ``refine_device(fused=True)``, where the
   ``fused_step_delta`` launches must equal K-groups x fused iterations.
4. The main path at full width: ``random_arbitrage_table(256, 100_000,
   seed=7)`` -> ``equilibrate`` -> ``compile_table(pad_pools_to=1024)`` ->
   ``AdmmSolver.solve_fused(iters=499)`` in float32 -> ``unscale_result`` ->
   ``certify``, with every kernel's launch count reset just before and read
   just after: exactly 499 grouped ``fused_step`` launches per K-group.
   The kernel path's objective must match the plain path's and the
   classic path's to 1e-3 relative; two more replayed runs and two eager
   ones (``graphs.eager()``, in turns, the counts reset before each), and
   a second 50-iteration classic solve, must be bitwise equal to the first,
   the four runs with equal launch counts; it/s and the card's idle share
   replayed and eager.
5. The certified route at full width: the same network -> float32 classic
   ``AdmmSolver.solve`` (max_iters=3000, eps 1e-7, ProjectionConfig(24, 4))
   -> ``refine_device(target_gap=1e-6)`` on the fused delta kernel, with the
   certificate in original units, run eagerly and then replayed (the base's
   24-iteration check blocks and the refinement's 25-iteration fused blocks
   as CUDA graphs): the two bitwise equal in the base, with the same final
   certificate and launches; the seconds of both.  Counts reset before each
   run, read after; each base block must be 24 kernel steps (``classic_step``
   per K-group and ``consensus`` a step, ``classic_z`` per K-group a block)
   and one checked iteration (``project`` per K-group); the
   fused delta kernel must run 2 launches per fused delta iteration (one
   per K-group) and the delta projection 2 per classic delta iteration, no
   host fallback may be taken, and the certificate must be finite and no
   worse than at entry.  Whether 1e-6 was reached is printed, not
   asserted.
5b. The reference's gated route (``bench_grid.py:run_config``, fused, its
   constants: 250-iteration chunks, a gate finished every second chunk,
   12,000 iterations at most) at the three sizes of ``BENCH_GRID.md``:
   ``random_arbitrage_table(64, 1_000)``, ``(64, 10_000)`` and ``(256,
   100_000)``, seed 7, each equilibrated and ``pad_pools_to=1024``, float32
   at (24, 4).  Before each size's route, its kernels against their plain
   versions on that size's buckets and delta buckets, bitwise and across
   launches: the grouped ``fused_step``, ``project``, ``segment_sum``,
   ``fused_step_delta`` and ``project_delta`` on every K-group
   (``gated_kernel_checks``).  The route: ``ChunkedDriver(fused=True)``
   chunks, a ``DeviceGate`` pass
   queued after every second chunk and finished (its float64 dual bound on
   a side stream) while the next chunk runs, a float64 certificate only to
   confirm a hand-off, the roll-back to the held snapshot, the rho
   adaptation, then ``refine_device(fused=True, cert_space=...)``.  Each
   size must end certified at 1e-6 in original units; the loop's launches
   must be exactly the fused base's (K-groups x 249 ``fused_step`` a chunk)
   plus one classic iteration a chunk and the gate's and the certificates'
   projections and sums.  At 100k the route also runs eagerly and must take
   the same path.  Printed: iterations and seconds to gate score 1e-3 and
   to the hand-off, gate passes and host seconds, certificate and
   refinement seconds, the wall clock, the host gate's time beside the
   device chunk it runs during, and the card's idle time before the next
   chunk, after a gated chunk and after any other.
6. Sweeps and batches (each main-path run with the counts reset just
   before it and read just after, and every call a kernel wrapper makes to
   a plain version counted: there must be none).
   a. The fold kernels ``fused_step(fold=)`` and ``fused_step_delta(fold=)``
      against their plain versions at the folded shapes of 6b (float32 at
      (24, 4) and (48, 6), float64 at (48, 6)) and at 1,000 pools / 64
      assets x T = 1,024 in float32, whose 65,536 prices exceed one block's
      shared memory: bitwise equal, planes and y (the delta step grouped
      by K).
   b. BASELINE config 5: the 100k network of phase 4 under 8 reserve
      scenarios (``uniform(0.7, 1.3, (8, n_pools))``, ``bench_grid.py:529``)
      -> ``solve_batch_reserves_folded(n_iters=749)`` in float32: 749 fused
      iterations (exactly 2 x 749 grouped fold launches) + 1 classic, 750
      in all.  Per-point objectives match the batched classic
      ``solve_batch_reserves`` at 750 iterations to 5e-4 relative; two
      more replayed runs and two eager ones are bitwise equal (seconds and
      scenario-iterations/s of both).
   c. A certified objective sweep: ``random_arbitrage_table(64, 10_000,
      seed=7)``, equilibrated, ``pad_pools_to=1024``, 50 objective points
      (``bench_grid.py:443-481``) -> ``solve_batch_folded`` (fused
      ``ChunkedDriver``, eps 1e-6) -> ``refine_sweep(target_gap=1e-6)`` on
      ``fused_step_delta(fold=)``, replayed and then eagerly: equal.  Every
      certificate finite and no worse than at entry; how many points reach
      1e-6 is printed.  Then both grouped fold steps at these 10k x 50
      shapes, where their launches happen: bitwise equal to their plain
      versions, and their device times.
   d. The reference's 51-point frontier: ``api.sweep(two-asset, 0, 2,
      linspace(0, 50, 51), refine_to=1e-6)`` in float32: every point
      certified at 1e-6, u(25) = 31.005495 to 2e-6.
7. The merged K-group kernel and separable concave utilities (counts reset
   before each main-path run and read after it; no plain version may run).
   a. ``fused_step_merged`` against its plain version at the two merged
      groups of the 100k network (K=2: cs2f + gm2 + gm2f, K=4: cs4f + gm4),
      from a mid-solve state, in float32 at (24, 4) and float64 at (48, 6):
      bitwise equal, and two launches bitwise equal; then merged groups at
      the any-K shapes of 2c (K = 3, 5, 12; 4, 8, 16; 40), float32 and
      float64 at (48, 6), likewise.  The fused-step library's registers,
      spills and SASS root-find loops (the merged step is its grouped
      kernel over the group's class spans).  Device times of the two merged
      launches (with their segment sums) against the five unmerged
      ``fused_step`` launches, from CUDA graphs.
   b. Path 1: ``solve_fused(iters=499, merged=True)`` on the phase-4
      network, exactly 2 x 499 merged launches, against ``merged=False`` in
      the same run (objective to 1e-4 relative, psi to 1e-3 of max|psi|;
      they add the consensus terms in different orders), a second merged
      run bitwise equal; it/s and the card's idle share of both; then the
      same with a ConcaveUtility (the phase-4 objective's linear atoms, log
      atoms on assets 1 and 3), with its certificate in original units.
   c. Path 2: the 100k utility route, classic float32 base (phase 5's
      options) -> ``refine_device(target_gap=1e-6, fused=True)`` with the
      certificate in original units, eager and replayed (equal, both
      timed), and ``api.route(table, utility,
      precondition=True, refine_to=1e-6)``: both certified at 1e-6.
   d. The three ``tests/test_utilities.py`` flavours (log, power, quad on
      ``random_arbitrage(5, 8, seed=11)``, boxed) through
      ``api.route(certify=True)`` in float64, 300 iterations, on the card and
      on the CPU: equal to 1e-9.
7e. A certified non-separable utility: U = c@psi - psi^T Q psi / 2 (the
   quadratic form of ``tests/test_custom_utility.py``, Q = A A^T / n + 0.1 I
   scaled to curvature 1e-4 on the 100k network and to 1e-3 on the 10k /
   64-asset one, a box of +-1e6 so that the box-free conjugate
   is tight) as a ``CustomUtility`` with ``prox_iters=80``, each
   solved in the linear part's equilibrated space with the scales
   composed into the utility by hand (``precondition`` refuses a custom
   utility) and certified in original units: the float32 classic base
   (phase 5's options), then ``refine_device(target_gap=1e-6)`` on the
   classic delta path; it must certify at 1e-6, launch ``project`` and
   ``segment_sum`` in the base and ``project_delta`` in refinement, and a
   50-iteration replayed base must equal its eager run bit for bit.
   Printed: the capture's seconds and memory, base and refinement
   iterations and seconds.
8. CUDA-graph replays (``solver/graphs.py``) against eager runs: at 100k
   pools in float32 (60 iterations, folds of 8) and float64 (30, folds of
   2), the classic solve (linear and concave utility), the fused and
   merged solves, the fused and classic delta solves, the folded reserve
   batch, the per-point batch and ``ChunkedDriver`` classic and fused:
   replayed bitwise equal to eager, with equal launch counts.  Peak device
   memory of the 100k fused solve and the 100k x 8 folded batch, eager and
   replayed.  ``torch.profiler`` windows over 50 and 500 fused-base
   iterations and over one classic check block, replayed and eager: the
   CUDA kernels' busy share of their span.
9. Scale-out (``parallel/``, ``torch.distributed``).
   a. One rank, NCCL, in this process (``pool_mesh()`` with no group: an
      in-memory store), replayed, the 100k network of phase 4:
      ``ShardedAdmmSolver.solve_fused(499)``, the classic solve (phase 5's
      options), ``ChunkedDriver(fused=True)`` and
      ``ShardedDeltaAdmmSolver.solve_delta(fused=True)`` bitwise equal to
      the unsharded solvers'; the certified route through
      ``refine_device(solver=ShardedDeltaAdmmSolver)`` at 1e-6; the
      sharded and unsharded fused it/s in turns and the NCCL kernels'
      device ms an iteration (profiler).
   b. Two spawned ranks sharing the card over gloo (NCCL refuses two ranks
      on one device), eager, the same network with ``pad_pools_to=2048``:
      phase 5b's five kernels bitwise on each rank's K-groups, the sharded
      ``solve_fused(499)`` against the unsharded one (1e-4), the certified
      route (sharded classic base and ``ShardedDeltaAdmmSolver``) at 1e-6
      and within 1e-6 of the single-device route, ``shard_assets=True``
      against the replicated consensus (1e-8, float64).
   c. Four spawned ranks on a 2x2 ``pool_batch_mesh``: 4 reserve scenarios
      (``uniform(0.7, 1.3)``) at 10k / 64, float64, against the unsharded
      ``solve_batch_reserves`` (1e-6).
   A rank that fails or outlasts its timeout fails the phase.  Two or four
   ranks on one card measure no scale-out: their seconds are the host
   round trips of gloo.
10. The native packer, the command line and the host extras (each
   main-path run with the counts reset just before it and read just after).
   a. ``random_arbitrage_table(256, 100_000, seed=7)`` compiled with
      ``pad_pools_to=1024`` by the C++ packer (``native/``, built with g++)
      and by the numpy packer, in turns, both timed: integer arrays equal,
      float arrays within 1e-12 (absolute and relative, the bar of
      ``tests/test_native.py``); ``backend="auto"`` fills every bucket
      natively and equals ``"native"`` bit for bit; ``solve_fused(499)``
      on the native compile launches exactly K-groups x 499 ``fused_step``
      and one classic iteration's ``project``.
   b. ``python -m cfmm_routing_tpu_torch`` in this process
      (``__main__.main``): ``export-reference`` of the three instances;
      ``solve --certify --refine-to 1e-7 --max-iters 6000 --eps 2e-6
      --json`` on each, certified and pinned to BASELINE.md at phase 3's
      float32 bar (2e-6); ``solve --refine-to 1e-6 --max-iters 3000
      --json`` on a JSON file of ``random_arbitrage(256, 100_000,
      seed=7)`` (``spec_to_json``, its arbitrage objective) -- seconds,
      iterations and certificate printed, 1e-6 printed and not asserted,
      ``project``, ``segment_sum`` and ``project_delta`` launched; ``sweep
      --points 51 --t-max 50 --json`` on the two-asset instance.
   c. ``time_phases`` on the 100k classic solver (its four phases, each >
      0, through the ``project`` and ``segment_sum`` kernels), and
      ``trace`` around a 25-iteration fused solve: at least one file
      written, the five operations with the most device time printed.
   d. ``examples/arbitrage_torch.py``, ``liquidation_torch.py`` and
      ``two_asset_torch.py`` in this process: each certified and within
      2e-6 of its pins.

It prints one JSON line describing every kernel of the path (device times
from CUDA events around CUDA-graph replays of back-to-back calls, summed
over the buckets one iteration runs; the plain fused steps and the plain
segment sum, which read a size back to the host, from eager calls; the
fused steps' times include their segment-sum launch; the fold kernels'
times are summed over the 6b buckets; the grouped delta kernels' times
over the K-groups of one iteration; bounds from this run's shapes;
launches summed over the main-path runs of phases 4, 5, 5b, 6b-6d, 7b-7d,
7e, 9 (9b's and 9c's over their ranks) and 10),
the card's name and power limit as ``nvidia-smi``
reports them, and last ``{"ok": true, "device": {"platform": "gpu",
"kind": ..., "count": ...}}``.
"""
import argparse
import contextlib
import dataclasses
import json
import logging
import math
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

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
    # project_gm_pallas and project_cs_pallas: one grouped launch per K-group
    "project": ("cfmm_routing_tpu_torch/csrc/projection.cu",
                "cfmm_routing_tpu/ops/projection_pallas.py:303,319"),
    # the refinement's classic projections (project_gm_delta and
    # project_cs_delta, one grouped launch): plain jnp on the TPU, no Pallas
    "project_delta": ("cfmm_routing_tpu_torch/csrc/projection_delta.cu",
                      "cfmm_routing_tpu/ops/projection_delta.py:188,237"),
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
    # one launch per channel count (phase 7)
    "fused_step_merged": ("cfmm_routing_tpu_torch/csrc/fused_step.cu",
                          "cfmm_routing_tpu/ops/iteration_pallas.py:837"),
    # the classic base's replayed stats-free iterations (phases 2a and 5):
    # one XLA program on the TPU, no Pallas kernel.  classic_step: one
    # launch per K-group a step; consensus: one a step (the linear prox);
    # classic_z: one per K-group a block
    "classic_step": ("cfmm_routing_tpu_torch/csrc/classic_step.cu",
                     "cfmm_routing_tpu/solver/admm.py:347 (_iterate)"),
    "consensus": ("cfmm_routing_tpu_torch/csrc/classic_step.cu",
                  "cfmm_routing_tpu/ops/prox.py:68 (psi_prox)"),
    "classic_z": ("cfmm_routing_tpu_torch/csrc/classic_step.cu",
                  "cfmm_routing_tpu/solver/admm.py:347 (_iterate's z update)"),
}
BASE_BLOCK = 24  # stats-free iterations between two checks of the classic base
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


def grouped_leaves(out):
    """The tensors of a grouped delta kernel's result in a fixed order: the
    fused step's (s', w, y) or the projection's {bucket: (a, b)}."""
    if isinstance(out, dict):
        return [t for name in sorted(out) for t in out[name]]
    s_new, w, y = out
    return [t for d in (s_new, w) for name in sorted(d) for t in d[name]] + [y]


def group_bound(bounds):
    """A K-group's bound: its buckets' (bound_ms, bound_by) summed, as the
    per-bucket rows were."""
    by = {b for _, b in bounds}
    return sum(t for t, _ in bounds), ("operations" if by == {"operations"} else "bytes")


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
               (iteration_cuda, "fused_step_grouped_plain"),
               (iteration_cuda, "fused_step_delta_plain"),
               (iteration_cuda, "fused_step_delta_grouped_plain"),
               (iteration_cuda, "fused_step_merged_plain"),
               (iteration_cuda, "classic_step_plain"),
               (iteration_cuda, "classic_z_plain"),
               (iteration_cuda, "consensus_plain"),
               (projection_cuda, "project_gm"), (projection_cuda, "project_cs"),
               (projection_cuda, "project_grouped_plain"),
               (projection_cuda, "project_gm_delta"),
               (projection_cuda, "project_cs_delta"),
               (projection_cuda, "project_delta_grouped_plain"),
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


# ---- the reference's gated route (bench_grid.py:run_config) -----------------
# 250-iteration fused chunks, a device gate finished every second chunk, the
# float64 certificate paid for only to confirm a hand-off (bench_grid.py:59-63)
CHUNK = 250
GATE_EVERY = 2
MAX_ITERS = 12_000
GAP_LOOSE = 1e-3
GAP_TIGHT = 1e-6


def certify_orig(solver, compiled_orig, obj, d, z, nu, rho, psi):
    """``bench_grid.py:_certify_orig``: project once for exactly feasible
    trades (solve space, one ``project`` launch per K-group), read every
    plane back in one copy, un-scale to original units and certify in
    float64 there.  Returns (certificate, original-units trades, solve-space
    trades), trades as {bucket: (D, L)} numpy planes."""
    from cfmm_routing_tpu_torch.solver.certify import certify

    d_ext = np.concatenate([d, [1.0]])
    inputs = {}
    for name in solver.buckets:
        nu_e = solver._bcast_nu(nu, name)
        zD, zL = z[name]
        inputs[name] = (zD - nu_e, zL + nu_e)
    proj = solver._project_groups(inputs, solver.buckets)
    names = list(solver.buckets)
    flat = torch.cat([t.reshape(-1) for nm in names for t in proj[nm]]).cpu().numpy()
    w_scaled, w_out, off = {}, {}, 0
    for nm in names:
        K, m = solver.buckets[nm]["mask"].shape
        D, L = flat[off:off + K * m].reshape(K, m), flat[off + K * m:off + 2 * K * m]
        off += 2 * K * m
        w_scaled[nm] = (D, L.reshape(K, m))
        ds = d_ext[solver.compiled.buckets[nm].asset].T  # (K, m)
        w_out[nm] = (w_scaled[nm][0] * ds, w_scaled[nm][1] * ds)
    prices = (rho * nu).cpu().numpy().astype(np.float64) / d
    cert = certify(compiled_orig, obj, {k: v[0] for k, v in w_out.items()},
                   {k: v[1] for k, v in w_out.items()}, prices,
                   psi_claimed=np.asarray(psi.cpu(), np.float64) * d,
                   device=solver.device)
    return cert, w_out, w_scaled


def gated_route(table, obj, device=None, pad=1024, chunk=CHUNK, gate_every=GATE_EVERY,
                max_iters=MAX_ITERS, say=log):
    """``bench_grid.py:run_config`` (fused) with the port: equilibrate,
    ``compile_table(pad_pools_to=pad)``, float32 at ProjectionConfig(24, 4);
    ``ChunkedDriver(fused=True)`` chunks from zero at rho 1, a
    :class:`DeviceGate` dispatched after every ``gate_every``-th chunk and
    finished while the next chunk runs, the hand-off test
    (``bench_grid.py:245-310``), the roll-back to the held snapshot, the rho
    adaptation (never off an exact fixed point), the confirming float64
    certificate, then ``refine_device(fused=True, cert_space=...)``.  Warm-up
    (the chunk's capture, the delta solve, the certificate paths) runs before
    the clock.  Returns the route's numbers and launch counts."""
    from cfmm_routing_tpu_torch.ops import _build
    from cfmm_routing_tpu_torch.ops.projection import ProjectionConfig
    from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver, RouteResult
    from cfmm_routing_tpu_torch.solver.compiler import compile_table
    from cfmm_routing_tpu_torch.solver.driver import ChunkedDriver
    from cfmm_routing_tpu_torch.solver.precondition import equilibrate, unscale_result
    from cfmm_routing_tpu_torch.solver.refine_device import (
        DeltaAdmmSolver, _delta_objective, refine_device,
    )
    from cfmm_routing_tpu_torch.solver.residuals import DeviceGate

    t_set = time.perf_counter()
    eq = equilibrate(table, obj)
    compiled = compile_table(eq.table, pad_pools_to=pad)
    compiled_orig = compile_table(table, pad_pools_to=pad)
    opts = AdmmOptions(max_iters=10**6, eps_abs=0.0, eps_rel=0.0,
                       projection=ProjectionConfig(n_bisect=24, n_polish=4))
    solver = AdmmSolver(compiled, dtype=torch.float32, options=opts, device=device)
    on_card = solver.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    drv = ChunkedDriver(solver, chunk=chunk, fused=True)
    c, lo, hi = solver._objective_arrays(eq.objective)
    sqn = solver._sqrt_edges()
    groups = len(solver._groups)
    z = {nm: (solver._zeros(*a["mask"].shape), solver._zeros(*a["mask"].shape))
         for nm, a in solver.buckets.items()}
    nu = solver._zeros(solver.n)
    rho = solver._t(1.0)
    setup_s = time.perf_counter() - t_set

    # warm-up outside the clock: the chunk's capture, one delta iteration
    # (the refinement's graphs are captured per pass, on its own arrays,
    # inside the clock), the certificate paths
    t0 = time.perf_counter()
    _, _, psi_w, _ = drv._run_chunk_fused(z, nu, rho, c, lo, hi)
    dopts = dataclasses.replace(opts, max_iters=chunk, eps_abs=1e-8, eps_rel=1e-8,
                                adapt_rho=False, projection=AdmmOptions().projection)
    dsolver = DeltaAdmmSolver(compiled, dtype=torch.float32, options=dopts,
                              device=solver.device)
    zeros = {nm: np.zeros(a["mask"].shape) for nm, a in solver.buckets.items()}
    dummy = RouteResult(objective=0.0, psi=np.zeros(solver.n), prices=np.zeros(solver.n),
                        deltas=zeros, lambdas=zeros, iters=0, r_norm=0.0, s_norm=0.0,
                        converged=False, rho_final=1.0)
    bdict_w, _ = dsolver.delta_buckets(dummy, 1.0, nu0=np.zeros(solver.n))
    dsolver.solve_delta(_delta_objective(eq.objective, np.zeros(solver.n), 1.0), bdict_w,
                        np.zeros(solver.n), 1.0, 1, fused=True)
    gate = DeviceGate(solver, compiled_orig, obj, d=eq.d)
    certify_orig(solver, compiled_orig, obj, eq.d, z, nu, rho, psi_w)
    gate.finish(gate.evaluate(z, nu, rho))
    sync()
    del bdict_w
    warm_s = time.perf_counter() - t0

    st = dict(solve_s=0.0, gate_s=0.0, confirm_s=0.0, gates=0, confirms=0, loose=None,
              tight=None, cert=None, w_scaled=None, handoff=False, r_stall=0,
              looseness=[], confirmed=[])
    # the host gate's ms per pass; on the card each kept chunk's events and
    # whether a host gate ran while it did
    gate_ms, events = [], []

    def host_gate(pend):
        it_p, z_p, nu_p, rho_p, solve_p, go_p = pend
        tc = time.perf_counter()
        est = gate.finish(go_p)
        dt = time.perf_counter() - tc
        st["gate_s"] += dt
        st["gates"] += 1
        gate_ms.append(1e3 * dt)
        score = est.score
        say(f"#   it={it_p}: gate gap={est.gap_rel:.2e} feas={est.feasibility_rel:.2e} "
            f"solve={solve_p:.3f}s")
        if st["loose"] is None and score <= GAP_LOOSE:
            st["loose"] = (it_p, solve_p)
        floor_suspect = st["loose"] is not None and st["r_stall"] >= 12
        # hand-off wants a near-converged dual: small negative gaps are taken
        # (refinement repairs feasibility), large overshoot is not
        # (bench_grid.py:245-310)
        confirm = (score <= GAP_TIGHT
                   or (st["loose"] is not None and -1.5e-5 <= est.gap_rel <= 5e-6
                       and est.feasibility_rel <= 1.5e-4)
                   or (floor_suspect and score <= 3e-4))
        if not confirm:
            if floor_suspect:
                st["r_stall"] = 0
            return False
        tc = time.perf_counter()
        cert, _, w_scaled = certify_orig(solver, compiled_orig, obj, eq.d, z_p, nu_p,
                                         rho_p, go_p["psi_solve"])
        st["confirm_s"] += time.perf_counter() - tc
        st["confirms"] += 1
        st["cert"], st["w_scaled"] = cert, w_scaled
        # how far the gate's cheap dual bound sits above the certificate's
        st["looseness"].append((est.dual - cert.dual_bound)
                               / max(1.0, abs(cert.dual_bound)))
        # the prices both bounds were taken at (original units), for a
        # check of the gate's bound against the reference's on the host
        st["confirmed"].append(dict(
            iters=it_p, gate_dual=est.dual, gate_objective=est.objective,
            cert_dual=cert.dual_bound, cert_objective=cert.objective,
            prices=go_p["host"].numpy()[3:].astype(np.float64).tolist()))
        score_c = max(abs(cert.gap_rel), cert.feasibility_rel)
        say(f"#   it={it_p}: CONFIRM gap={cert.gap_rel:.2e} "
            f"feas={cert.feasibility_rel:.2e} (gate objective {est.objective:.9g} dual "
            f"{est.dual:.9g}; certificate {cert.objective:.9g} / {cert.dual_bound:.9g})")
        if score_c <= GAP_TIGHT:
            st["tight"] = (it_p, solve_p)
            return True
        if (-1.5e-5 <= cert.gap_rel <= 5e-6 and cert.feasibility_rel <= 1.5e-4) or (
                floor_suspect and score_c <= 3e-4):
            st["handoff"] = True
            return True
        return False

    _build.reset_launch_counts()
    sync()
    t_e2e0 = time.perf_counter()
    iters = ci = evals = 0
    r_min = math.inf
    pending = None
    psi = psi_w
    while iters < max_iters:
        t0 = time.perf_counter()
        if on_card:
            ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            ev0.record()
        z_n, nu_n, psi_n, stats = drv._run_chunk_fused(z, nu, rho, c, lo, hi)
        if on_card:
            ev1.record()
        iters += chunk
        ci += 1
        gate_out = None
        if ci % gate_every == 0:
            # the gate of this chunk's state: queued behind it, finished
            # while the next chunk runs
            gate_out = gate.evaluate(z_n, nu_n, rho)
            gate_out["psi_solve"] = psi_n
            evals += 1
        prev, pending = pending, None
        if prev is not None and host_gate(prev):
            # decisions act on the held snapshot: roll back to it (the chunk
            # in flight is discarded, its time already overlapped)
            iters, z, nu, rho, st["solve_s"] = prev[:5]
            psi = prev[5]["psi_solve"]
            break
        r_t, s_t = solver._residuals(solver._joint(stats), sqn)[:2]
        r, s = (float(x) for x in torch.stack([r_t, s_t]).cpu())
        if on_card:
            events.append((ev0, ev1, prev is not None))
        st["solve_s"] += time.perf_counter() - t0
        z, nu, psi = z_n, nu_n, psi_n
        if gate_out is not None:
            pending = (iters, z_n, nu_n, rho, st["solve_s"], gate_out)
        # never adapt off an exact float32 fixed point: r can reach 0 there
        if min(r, s) > 1e-6:
            if r > 3.0 * s:
                rho, nu = rho * 2.0, nu / 2.0
            elif s > 3.0 * r:
                rho, nu = rho / 2.0, nu * 2.0
        st["r_stall"] = 0 if r < 0.9 * r_min else st["r_stall"] + 1
        r_min = min(r_min, r)
    if pending is not None and st["tight"] is None and not st["handoff"]:
        host_gate(pending)
        iters, z, nu, rho, st["solve_s"] = pending[:5]
        psi = pending[5]["psi_solve"]
    if st["cert"] is None:
        tc = time.perf_counter()
        st["cert"], _, st["w_scaled"] = certify_orig(solver, compiled_orig, obj, eq.d, z,
                                                     nu, rho, psi)
        st["confirm_s"] += time.perf_counter() - tc
        st["confirms"] += 1
    sync()
    loop_wall_s = time.perf_counter() - t_e2e0
    loop_launches = dict(_build.LAUNCHES)
    # the card's time between one chunk's end and the next one's start:
    # after a chunk during which a host gate ran (the part of the gate the
    # chunk did not hide, plus the residual read and the next launch) and
    # after any other chunk (the gate's device pass, the residual read and
    # the next launch)
    chunk_ms = [a0.elapsed_time(a1) for a0, a1, gated in events if gated]
    idle_gated, idle_other = [], []
    for (_, a1, gated), (b0, _, _) in zip(events, events[1:]):
        (idle_gated if gated else idle_other).append(a1.elapsed_time(b0))
    cert, final = st["cert"], st["cert"]
    refine_s, refine_iters, achieved = 0.0, 0, st["tight"] is not None
    refine_launches = {}
    if st["tight"] is None:
        w = st["w_scaled"]
        res32 = RouteResult(
            objective=float(solver._objective_value(c, psi)),
            psi=np.asarray(psi.cpu(), np.float64),
            prices=np.asarray((rho * nu).cpu(), np.float64),
            deltas={k: v[0] for k, v in w.items()}, lambdas={k: v[1] for k, v in w.items()},
            iters=iters, r_norm=0.0, s_norm=0.0, converged=False,
            rho_final=float(rho))
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        ref = refine_device(compiled, eq.objective, res32, target_gap=GAP_TIGHT,
                            solver=dsolver, fused=True, entry_cert=cert,
                            cert_space=(compiled_orig, obj,
                                        lambda r: unscale_result(r, eq.d, compiled)))
        sync()
        refine_s = time.perf_counter() - t0
        refine_launches = dict(_build.LAUNCHES)
        refine_iters, achieved, final = ref.iters, bool(ref.achieved), ref.certificate
    return dict(
        n_pools=table.n_pools, n_assets=table.n_assets, groups=groups, chunk=chunk,
        setup_s=setup_s, warm_s=warm_s,
        iters_to_1e3=st["loose"][0] if st["loose"] else None,
        solve_s_to_1e3=st["loose"][1] if st["loose"] else None,
        iters_to_1e6=st["tight"][0] if st["tight"] else None,
        device_iters=iters, device_solve_s=st["solve_s"], handoff=st["handoff"],
        chunks=ci, gates_evaluated=evals, gate_passes=st["gates"],
        gate_s_total=st["gate_s"], gate_s_per_pass=st["gate_s"] / max(1, st["gates"]),
        confirms=st["confirms"], confirm_s=st["confirm_s"], loop_wall_s=loop_wall_s,
        gate_dual_looseness=st["looseness"], confirmed=st["confirmed"],
        entry=dict(gap_rel=cert.gap_rel, feasibility_rel=cert.feasibility_rel),
        refine_s=refine_s, refine_iters=refine_iters, wall_s=loop_wall_s + refine_s,
        gap_rel=final.gap_rel, feasibility_rel=final.feasibility_rel,
        objective=final.objective, achieved=achieved,
        gate_host_ms=gate_ms, chunk_device_ms=chunk_ms, idle_after_gate_ms=idle_gated,
        idle_other_ms=idle_other,
        loop_launches=loop_launches, refine_launches=refine_launches)


# the three rows of BENCH_GRID.md's table: (assets, pools)
GATED_SIZES = ((64, 1_000), (64, 10_000), (256, 100_000))


def check_gated(label, out):
    """Raise unless a gated route ended certified at 1e-6 and, on the card,
    its loop ran the fused base with exactly one classic iteration a chunk:
    ``fused_step`` K-groups x (chunk - 1) x chunks; ``project`` K-groups x
    (chunks + gate passes + confirming certificates); ``segment_sum``
    K-groups x (chunk x chunks + 2 x gate passes)."""
    if not (out["achieved"] and abs(out["gap_rel"]) <= GAP_TIGHT
            and out["feasibility_rel"] <= GAP_TIGHT):
        raise AssertionError(f"{label}: no certificate at 1e-6: gap {out['gap_rel']:.3e} "
                             f"feasibility {out['feasibility_rel']:.3e}")
    g, ch, n = out["groups"], out["chunk"], out["chunks"]
    want = dict(fused_step=g * (ch - 1) * n,
                project=g * (n + out["gates_evaluated"] + out["confirms"]),
                segment_sum=g * (ch * n + 2 * out["gates_evaluated"]))
    got = {k: out["loop_launches"][k] for k in want}
    if got != want:
        raise AssertionError(f"{label}: gated loop launches {got} != {want} (a classic "
                             "iteration ran beyond one per chunk, or a kernel did not run)")
    if out["refine_iters"] and out["refine_launches"]["fused_step_delta"] == 0:
        raise AssertionError(f"{label}: the refinement never launched fused_step_delta")


def gated_kernel_checks(label, table, obj, pad=1024, device=None, mesh=None, phase="5b"):
    """Phase 5b's kernels against their plain versions at one size of the
    gated route: its bucket dict (equilibrated, ``pad_pools_to=pad``,
    float32 at (24, 4)) from a state of 20 fused iterations, and its delta
    buckets (float32 at the refinement's (48, 6)) from a 20-iteration base
    and 5 fused delta iterations.  Per K-group, bitwise: the grouped
    ``fused_step``, ``project_grouped``, ``segment_sum``,
    ``fused_step_delta_grouped`` and ``project_delta_grouped``, each also
    bitwise across two launches.  With a ``mesh`` (phase 9b) the solvers
    are this rank's shards of the sharded ones and the K-groups its own.
    Returns the checked calls per kernel."""
    from cfmm_routing_tpu_torch.ops.iteration_cuda import (
        fused_step_delta_grouped, fused_step_delta_grouped_plain, fused_step_grouped,
        fused_step_grouped_plain,
    )
    from cfmm_routing_tpu_torch.ops.projection import ProjectionConfig
    from cfmm_routing_tpu_torch.ops.projection_cuda import (
        project_delta_grouped, project_delta_grouped_plain, project_grouped,
        project_grouped_plain,
    )
    from cfmm_routing_tpu_torch.ops.segment import segment_sum, segment_sum_plain
    from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver
    from cfmm_routing_tpu_torch.solver.compiler import compile_table
    from cfmm_routing_tpu_torch.solver.precondition import equilibrate
    from cfmm_routing_tpu_torch.solver.refine import to_host
    from cfmm_routing_tpu_torch.solver.refine_device import (
        DeltaAdmmSolver, _delta_objective, _prep_delta_solve, _psi_from_trades,
    )

    cfg, cfg_delta = ProjectionConfig(n_bisect=24, n_polish=4), ProjectionConfig()
    eq = equilibrate(table, obj)
    compiled = compile_table(eq.table, pad_pools_to=pad)
    opts, dopts = AdmmOptions(projection=cfg), AdmmOptions(adapt_rho=False,
                                                            projection=cfg_delta)
    if mesh is None:
        top = solver = AdmmSolver(compiled, dtype=torch.float32, options=opts,
                                  device=device)
        dtop = ds = DeltaAdmmSolver(compiled, dtype=torch.float32, options=dopts,
                                    device=device)
    else:
        from cfmm_routing_tpu_torch.parallel.sharded import (
            ShardedAdmmSolver, ShardedDeltaAdmmSolver,
        )

        top = ShardedAdmmSolver(compiled, mesh, options=opts)
        dtop = ShardedDeltaAdmmSolver(compiled, mesh, options=dopts)
        solver, ds = top.inner, dtop.inner
    sync = torch.cuda.synchronize if solver.device.type == "cuda" else (lambda: None)
    c, lo, hi = solver._objective_arrays(eq.objective)
    rho = solver._t(1.0)
    s, wdef, nu = solver.fused_init()
    for _ in range(20):
        s, wdef, nu, _, _ = solver._iterate_fused(s, wdef, nu, rho, c, lo, hi)
    z = solver.fused_to_z(s, wdef)
    v, _ = solver._fold_pack(wdef - nu)
    pin = {}
    for name in solver.buckets:
        nu_e = solver._bcast_nu(nu, name)
        pin[name] = (z[name][0] - nu_e, z[name][1] + nu_e)
    checked = {k: 0 for k in ("fused_step", "project", "segment_sum", "fused_step_delta",
                              "project_delta")}

    def check(kname, K, kfn, pfn):
        got, again, want = kfn(), kfn(), pfn()
        sync()
        if kname == "segment_sum":
            got, again, want = [got], [again], [want]
        else:
            got, again, want = (grouped_leaves(x) for x in (got, again, want))
        bitwise(f"{phase} {label}: {kname}[K={K}]", got, want)
        bitwise(f"{phase} {label}: {kname}[K={K}] second launch", again, got)
        checked[kname] += 1

    for g in solver._groups:
        val = torch.cat([((s[nm][1] - s[nm][0]) * solver.buckets[nm]["mask"]).reshape(-1)
                         for nm in g["names"]])
        check("fused_step", g["K"],
              lambda: fused_step_grouped(s, v, solver.buckets, g, 1.0, cfg=cfg),
              lambda: fused_step_grouped_plain(s, v, solver.buckets, g, 1.0, cfg=cfg))
        check("project", g["K"],
              lambda: project_grouped(pin, solver.buckets, g, cfg=cfg),
              lambda: project_grouped_plain(pin, solver.buckets, g, cfg=cfg))
        check("segment_sum", g["K"],
              lambda: segment_sum(val, g["order"], g["seg"], v.shape[0]),
              lambda: segment_sum_plain(val, g["order"], g["seg"], v.shape[0]))
    base = to_host(top.solve_fused(eq.objective, iters=20))
    base = base._replace(psi=_psi_from_trades(compiled, base))
    rho_d = float(np.clip(np.asarray(base.rho_final), 0.25, 4.0))
    nu0 = (np.asarray(base.prices, np.float64) / rho_d).astype(np.float32).astype(np.float64)
    bdict, min_x0 = dtop.delta_buckets(base, 1e-3, nu0=nu0)
    if not min_x0 > 0:
        raise AssertionError(f"{phase} {label}: the base point has min x0 = {min_x0}")
    dc, dlo, dhi, _, start = _prep_delta_solve(
        _delta_objective(eq.objective, base.psi, 1e-3), nu0, rho_d, ds)
    rho_t = ds._t(rho_d)
    st, wd, _ = ds.fused_init(bdict)
    dnu = ds._t(start)
    for _ in range(5):
        st, wd, dnu, _, _ = ds._iterate_fused(st, wd, dnu, rho_t, dc, dlo, dhi, buckets=bdict)
    dv, _ = ds._fold_pack(wd - dnu)
    dpin = {}
    for name, arrs in bdict.items():
        off = ds._bcast_nu(wd - dnu, name, bdict) - arrs["nu0e"]
        dpin[name] = (st[name][0] + off, st[name][1] - off)
    for g in ds._groups:
        check("fused_step_delta", g["K"],
              lambda: fused_step_delta_grouped(st, dv, bdict, g, 1.0, cfg=cfg_delta),
              lambda: fused_step_delta_grouped_plain(st, dv, bdict, g, 1.0, cfg=cfg_delta))
        check("project_delta", g["K"],
              lambda: project_delta_grouped(dpin, bdict, g, cfg=cfg_delta),
              lambda: project_delta_grouped_plain(dpin, bdict, g, cfg=cfg_delta))
    log(f"# {phase} {label}: fused_step, project, segment_sum, fused_step_delta and "
        f"project_delta bitwise equal to their plain versions on every K-group of this "
        f"size's buckets ({[g['names'] for g in solver._groups]}) and delta buckets, and "
        f"across launches: {checked}")
    return checked


def gated_phase(report, card):
    """Phase 5b: the reference's gated route (``gated_route``) at 1k, 10k
    and 100k pools, replayed, and at 100k also eagerly (equal to the
    replayed run: the same iterations, certificate and launches).  Returns
    the replayed runs' launch counts (loop and refinement)."""
    from cfmm_routing_tpu_torch.solver import graphs
    from cfmm_routing_tpu_torch.utils.synth import random_arbitrage_table

    t_phase = time.perf_counter()
    rows, main, checks = {}, [], {}
    for n_assets, m in GATED_SIZES:
        table, obj = random_arbitrage_table(n_assets, m, seed=7)
        checks[m] = gated_kernel_checks(f"{m} pools / {n_assets} assets", table, obj)
        for mode in (("replayed", "eager") if m == 100_000 else ("replayed",)):
            label = f"gated route {m} pools / {n_assets} assets ({mode})"
            log(f"# 5b {label}:")
            ctx = graphs.eager() if mode == "eager" else contextlib.nullcontext()
            with ctx:
                out = gated_route(table, obj)
            check_gated(label, out)
            med = lambda xs: statistics.median(xs) if xs else float("nan")  # noqa: E731
            log(f"# 5b {label}: to gate score 1e-3 {out['iters_to_1e3']} iterations "
                f"{out['solve_s_to_1e3']:.3f} s; hand-off at {out['device_iters']} "
                f"iterations {out['device_solve_s']:.3f} s of device solve ({out['chunks']} "
                f"chunks of {out['chunk']}); {out['gate_passes']} gate passes, host "
                f"{out['gate_s_total']:.3f} s ({1e3 * out['gate_s_per_pass']:.2f} ms a pass); "
                f"confirm certificate {out['confirm_s']:.3f} s ({out['confirms']}; the "
                f"gate's dual bound above the certificate's by "
                f"{', '.join(f'{x:.2e}' for x in out['gate_dual_looseness'])} relative); "
                f"entry gap {out['entry']['gap_rel']:.2e} feas "
                f"{out['entry']['feasibility_rel']:.2e}")
            log(f"# 5b {label}: refinement {out['refine_iters']} iterations "
                f"{out['refine_s']:.3f} s; gated loop + refinement {out['wall_s']:.3f} s "
                f"(loop {out['loop_wall_s']:.3f} s; set-up {out['setup_s']:.2f} s and "
                f"warm-up {out['warm_s']:.2f} s before the clock); final gap "
                f"{out['gap_rel']:.3e} feasibility {out['feasibility_rel']:.3e} (original "
                f"units); overlap (medians): host gate {med(out['gate_host_ms']):.2f} ms a "
                f"pass beside the {med(out['chunk_device_ms']):.2f} ms device chunk it "
                f"runs during; the card then idles {med(out['idle_after_gate_ms']):.3f} ms "
                f"(max {max(out['idle_after_gate_ms'], default=float('nan')):.3f}) before "
                f"the next chunk, against {med(out['idle_other_ms']):.3f} ms after a chunk "
                f"with no host gate")
            log(f"# 5b {label}: loop launches {out['loop_launches']}; refinement "
                f"{out['refine_launches']}")
            rows[f"{m} {mode}"] = out
            if mode == "replayed":
                main += [out["loop_launches"], out["refine_launches"]]
        if m == 100_000:
            a, b = rows["100000 replayed"], rows["100000 eager"]
            same = [a["device_iters"] == b["device_iters"], a["gap_rel"] == b["gap_rel"],
                    a["refine_iters"] == b["refine_iters"],
                    a["loop_launches"] == b["loop_launches"],
                    a["refine_launches"] == b["refine_launches"]]
            if not all(same):
                raise AssertionError(f"gated route 100k: the eager run differs from the "
                                     f"replayed one (iterations, gap, refinement, "
                                     f"launches): {same}")
            log(f"# 5b gated route 100k: replayed {a['wall_s']:.3f} s vs eager "
                f"{b['wall_s']:.3f} s, the same route (iterations, certificate, launches) "
                f"on {card}")
    report["gated_route"] = rows
    report["gated_kernel_checks"] = checks
    log(f"# phase 5b (gated route) done in {time.perf_counter() - t_phase:.1f} s")
    return main


# phase 7e's utility: U = c@psi - psi^T Q psi / 2, Q's largest eigenvalue
# the cell's curvature, on a box wide enough that the optimum is interior
# and the box-free conjugate is tight.  Its cells: the 100k network at
# curvature 1e-4, and the 10k / 64-asset network at 1e-3.  At the 100k
# network's degree (~900 slots an asset) curvature 1e-3 does not certify:
# the reference's own refine_device stalls there too (gap 6.4e-6 at
# 3,000 pools / 8 assets, degree ~860, chunk for chunk the port's;
# ``tests/cross_check.py custom``), while at degree ~360 (10k / 64) both
# certify.  At the test's own curvature (~4) the base alone certifies and
# refinement never runs.
QUAD_CURV = 1e-4
QUAD_BOX = 1e6
CUSTOM_CELLS = ((256, 100_000, QUAD_CURV), (64, 10_000, 1e-3))


def quad_data(n, curvature):
    """Phase 7e's Q: A A^T / n + 0.1 I (``tests/test_custom_utility.py:77-108``,
    A from seed 5) scaled to largest eigenvalue ``curvature``, rounded to
    the float32 values the card computes with (the utility's exact data)."""
    A = np.random.default_rng(5).normal(size=(n, n))
    Q = A @ A.T / n + 0.1 * np.eye(n)
    Q = Q * (curvature / np.linalg.eigvalsh(Q)[-1])
    return Q.astype(np.float32).astype(np.float64)


def custom_route(n_assets, m, cfg_main, curvature=QUAD_CURV):
    """Phase 7e's route at one size: the float32 classic base (phase 5's
    options) with the quadratic CustomUtility of :func:`quad_data`, then
    ``refine_device(target_gap=1e-6)`` (classic delta
    path, residual check every 25 iterations so that its blocks replay),
    certified in original units.  It solves in the equilibrated space of the
    utility's linear part, the power-of-two scales d composed into the
    utility by hand (U_d(p) = U(d p), conjugate conj(nu / d)), as
    ``precondition``'s refusal asks.  Returns its numbers; raises unless
    certified at 1e-6."""
    from cfmm_routing_tpu_torch.models.utility import CustomUtility
    from cfmm_routing_tpu_torch.ops import _build
    from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver
    from cfmm_routing_tpu_torch.solver.certify import certify
    from cfmm_routing_tpu_torch.solver.compiler import compile_table
    from cfmm_routing_tpu_torch.solver.precondition import equilibrate, unscale_result
    from cfmm_routing_tpu_torch.solver.refine import to_host
    from cfmm_routing_tpu_torch.solver.refine_device import refine_device
    from cfmm_routing_tpu_torch.utils.synth import random_arbitrage_table

    table, obj = random_arbitrage_table(n_assets, m, seed=7)
    n = n_assets
    eq = equilibrate(table, obj)
    d = eq.d
    compiled = compile_table(eq.table, pad_pools_to=1024)
    compiled_orig = compile_table(table, pad_pools_to=1024)
    Q, c = quad_data(n, curvature), np.asarray(obj.c).astype(np.float32).astype(np.float64)
    Qt = torch.as_tensor(Q, dtype=torch.float32, device="cuda")
    ct = torch.as_tensor(c, dtype=torch.float32, device="cuda")
    dt = torch.as_tensor(d, dtype=torch.float32, device="cuda")
    Qinv = np.linalg.inv(Q)

    def conj(nu):  # sup_psi U(psi) - nu @ psi, box-free: an upper bound
        return 0.5 * float((c - nu) @ Qinv @ (c - nu))

    def fn(p):  # torch ops only, no host read: captured on the card
        return torch.dot(ct.to(p), p) - 0.5 * torch.dot(p, Qt.to(p) @ p)

    def fn_d(p):  # U(d p): d is a power of two per asset, exact
        return fn(dt.to(p) * p)

    lo, hi = np.full(n, -QUAD_BOX), np.full(n, QUAD_BOX)
    util = CustomUtility(fn, lo=lo, hi=hi,
                         smoothness=float(np.linalg.eigvalsh(Q)[-1]) * (1 + 1e-9),
                         prox_iters=80, conjugate=conj)
    util_d = CustomUtility(
        fn_d, lo=lo / d, hi=hi / d,
        smoothness=float(np.linalg.eigvalsh(Q * np.outer(d, d))[-1]) * (1 + 1e-9),
        prox_iters=80, conjugate=lambda nu: conj(nu / d))
    opts = AdmmOptions(max_iters=3000, eps_abs=1e-7, eps_rel=1e-7, check_every=25,
                       projection=cfg_main)
    solver = AdmmSolver(compiled, dtype=torch.float32, options=opts)
    # capture cost: one check block (capture + one replay) against the same
    # block replayed again
    times = []
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_reserved()
    for _ in range(2):
        t0 = time.perf_counter()
        solver.solve(util_d, max_iters=25)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    capture_s = times[0] - times[1]
    capture_mb = (torch.cuda.memory_reserved() - mem0) / 2**20
    te, tr, _ = replay_vs_eager("custom-utility classic base, 50 iterations",
                                lambda: solver.solve(util_d, max_iters=50))
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    res = solver.solve(util_d)
    torch.cuda.synchronize()
    base_s = time.perf_counter() - t0
    base_launches = dict(_build.LAUNCHES)
    unscale = lambda r: unscale_result(r, d, compiled)  # noqa: E731
    r0 = unscale(to_host(res))
    t0 = time.perf_counter()
    entry = certify(compiled_orig, util, r0.deltas, r0.lambdas, r0.prices,
                    psi_claimed=r0.psi)
    entry_s = time.perf_counter() - t0
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = refine_device(compiled, util_d, res, target_gap=1e-6, entry_cert=entry,
                        options=dataclasses.replace(AdmmOptions(), check_every=25),
                        cert_space=(compiled_orig, util, unscale))
    torch.cuda.synchronize()
    refine_s = time.perf_counter() - t0
    refine_launches = dict(_build.LAUNCHES)
    fc = out.certificate
    row = dict(n_pools=m, n_assets=n, curvature=curvature,
               base_iters=int(res.iters), base_s=base_s,
               converged=bool(res.converged), refine_iters=out.iters, refine_s=refine_s,
               entry=dict(gap_rel=entry.gap_rel, feasibility_rel=entry.feasibility_rel),
               entry_s=entry_s,
               wall_s=base_s + entry_s + refine_s, achieved=bool(out.achieved),
               gap_rel=fc.gap_rel,
               feasibility_rel=fc.feasibility_rel, objective=fc.objective,
               capture_s=capture_s, capture_mb=capture_mb, block_s=times,
               replay_check=dict(eager_s=te, replayed_s=tr),
               base_launches=base_launches, refine_launches=refine_launches)
    log(f"# 7e custom utility {m} pools / {n} assets (curvature {curvature:g}, solved "
        f"equilibrated): base {row['base_iters']} "
        f"classic iterations {base_s:.3f} s (converged {row['converged']}; entry "
        f"certificate gap {entry.gap_rel:.2e} feas {entry.feasibility_rel:.2e}, "
        f"{entry_s:.3f} s); refinement "
        f"{out.iters} iterations {refine_s:.3f} s; final gap {fc.gap_rel:.3e} "
        f"feasibility {fc.feasibility_rel:.3e} (objective {fc.objective:.6f}); a check "
        f"block's capture {capture_s:.3f} s and {capture_mb:.1f} MB (memory_reserved), "
        f"replayed {times[1]:.3f} s; 50 iterations replayed {tr:.3f} s vs eager "
        f"{te:.3f} s, bitwise equal")
    log(f"# 7e launches: base {base_launches}; refinement {refine_launches}")
    missing = [k for k, dd in (("project", base_launches), ("segment_sum", base_launches),
                               ("project_delta", refine_launches)) if dd[k] == 0]
    if missing:
        raise AssertionError(f"custom-utility route: kernels never launched: {missing}")
    if not (out.achieved and abs(fc.gap_rel) <= 1e-6 and fc.feasibility_rel <= 1e-6):
        raise AssertionError(f"custom-utility route at {m} pools: no certificate at 1e-6: "
                             f"{fc.summary()} feasibility {fc.feasibility_rel:.3e}")
    return row


def custom_phase(report, card, cfg_main):
    """Phase 7e: the certified custom-utility route (``custom_route``) at
    each of ``CUSTOM_CELLS``.  Returns their launch counts (base and
    refinement)."""
    t_phase = time.perf_counter()
    rows, launches = {}, []
    for n_assets, m, curvature in CUSTOM_CELLS:
        row = custom_route(n_assets, m, cfg_main, curvature=curvature)
        rows[f"{m} pools / {n_assets} assets, curvature {curvature:g}"] = row
        launches += [row["base_launches"], row["refine_launches"]]
    report["custom_utility_route"] = rows
    log(f"# phase 7e (custom utility) done in {time.perf_counter() - t_phase:.1f} s on "
        f"{card}")
    return launches


def sweep_phase(report, rows, card, cfg_main, cfg64):
    """Phase 6, sweeps and batches (module docstring).  Appends the fold
    kernels' rows to ``rows`` and returns the launch counts of its three
    main-path runs (6b, 6c, 6d)."""
    from cfmm_routing_tpu_torch import api
    from cfmm_routing_tpu_torch.models.reference_instances import two_asset_instance
    from cfmm_routing_tpu_torch.ops import _build
    from cfmm_routing_tpu_torch.ops.iteration_cuda import (
        fused_step, fused_step_delta_grouped, fused_step_delta_grouped_plain,
        fused_step_grouped, fused_step_grouped_plain, fused_step_plain,
    )
    from cfmm_routing_tpu_torch.solver import graphs
    from cfmm_routing_tpu_torch.solver.admm import (
        AdmmOptions, AdmmSolver, _reserve_buckets,
    )
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

    def half(d):
        return {k: 0.5 * np.asarray(x, np.float64) for k, x in d.items()}

    def fold_delta_check(slv, bd, vvec, rng, label, timed, f64=True):
        """``fused_step_delta(fold=)`` grouped by K on the folded delta arrays
        ``bd`` of the folded solver ``slv`` from a random state: bitwise
        equal to its plain version (float32, and float64 if ``f64``) and to
        a second launch.  With ``timed``, returns one float32 row per group:
        device time from CUDA graphs, the plain version's, the bound."""
        st = {name: delta_state(a, rng) for name, a in bd.items()}
        n_v = vvec.shape[0]
        out_rows = []
        for g in slv._groups:
            K = g["K"]
            ms = [int(bd[nm]["mask"].shape[1]) for nm in g["names"]]
            kfn = lambda: fused_step_delta_grouped(st, vvec, bd, g, 1.0, cfg=cfg64,  # noqa: E731
                                                   fold=slv._fold)
            pfn = lambda: fused_step_delta_grouped_plain(st, vvec, bd, g, 1.0,  # noqa: E731
                                                         cfg=cfg64, fold=slv._fold)
            got, again, want = kfn(), kfn(), pfn()
            torch.cuda.synchronize()
            bitwise(f"fused_step_delta fold[K={K}, {label}, float32]", grouped_leaves(got),
                    grouped_leaves(want))
            bitwise(f"fused_step_delta fold[K={K}, {label}] second launch",
                    grouped_leaves(again), grouped_leaves(got))
            del got, again, want
            if f64:
                st64 = {nm: tuple(x.double() for x in st[nm]) for nm in g["names"]}
                bd64 = {nm: as64(bd[nm]) for nm in g["names"]}
                got = fused_step_delta_grouped(st64, vvec.double(), bd64, g, 1.0, cfg=cfg64,
                                               fold=slv._fold)
                want = fused_step_delta_grouped_plain(st64, vvec.double(), bd64, g, 1.0,
                                                      cfg=cfg64, fold=slv._fold)
                torch.cuda.synchronize()
                bitwise(f"fused_step_delta fold[K={K}, {label}, float64]",
                        grouped_leaves(got), grouped_leaves(want))
                del st64, bd64, got, want
            if not timed:
                continue
            row = dict(group=K, buckets=g["names"], dtype="float32", K=K, m=sum(ms),
                       fold=list(slv._fold), cfg=list(cfg64), max_abs_err=0.0,
                       ms=graph_ms(kfn), plain_ms=eager_ms(pfn, n=1))
            row["bound_ms"], row["bound_by"] = group_bound([
                bound_ms(fused_fold_bytes(K, m, n_v, 4, True),
                         projection_flops(cfg64, K, m, per_step=80), torch.float32)
                for m in ms])
            out_rows.append(row)
            log(f"# 6a fused_step_delta fold K={K} {g['names']} T*m={sum(ms)} ({label}): "
                f"bitwise equal to plain{' in float32 and float64' if f64 else ''} and "
                f"across launches; kernel {row['ms']:.4f} ms (1 launch + 1 segment sum)  "
                f"plain {row['plain_ms']:.2f} ms  bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']})")
        return out_rows

    def fold_base_check(slv, bd, st, vvec, label, timed, f64=True):
        """``fused_step(fold=)`` grouped by K on the folded arrays ``bd``: bitwise
        equal to its plain version (float32 at (24, 4), and float64 at (48, 6)
        if ``f64``) and to a second launch.  With ``timed``, one float32 row
        per group: device time from CUDA graphs, the plain version's, the
        bound."""
        n_v = vvec.shape[0]
        out_rows = []
        for g in slv._groups:
            K = g["K"]
            ms = [int(bd[nm]["mask"].shape[1]) for nm in g["names"]]
            kfn = lambda: fused_step_grouped(st, vvec, bd, g, 1.0, cfg=cfg_main,  # noqa: E731
                                             fold=slv._fold)
            pfn = lambda: fused_step_grouped_plain(st, vvec, bd, g, 1.0,  # noqa: E731
                                                   cfg=cfg_main, fold=slv._fold)
            got, again, want = kfn(), kfn(), pfn()
            torch.cuda.synchronize()
            bitwise(f"fused_step fold[K={K}, {label}, float32]", grouped_leaves(got),
                    grouped_leaves(want))
            bitwise(f"fused_step fold[K={K}, {label}] second launch", grouped_leaves(again),
                    grouped_leaves(got))
            del got, again, want
            if f64:
                st64 = {nm: tuple(x.double() for x in st[nm]) for nm in g["names"]}
                bd64 = {nm: as64(bd[nm]) for nm in g["names"]}
                got = fused_step_grouped(st64, vvec.double(), bd64, g, 1.0, cfg=cfg64,
                                         fold=slv._fold)
                want = fused_step_grouped_plain(st64, vvec.double(), bd64, g, 1.0,
                                                cfg=cfg64, fold=slv._fold)
                torch.cuda.synchronize()
                bitwise(f"fused_step fold[K={K}, {label}, float64]", grouped_leaves(got),
                        grouped_leaves(want))
                del st64, bd64, got, want
            if not timed:
                continue
            row = dict(group=K, buckets=g["names"], dtype="float32", K=K, m=sum(ms),
                       fold=list(slv._fold), cfg=list(cfg_main), max_abs_err=0.0,
                       ms=graph_ms(kfn), plain_ms=eager_ms(pfn, n=1))
            row["bound_ms"], row["bound_by"] = group_bound([
                bound_ms(fused_fold_bytes(K, m, n_v, 4, False),
                         projection_flops(cfg_main, K, m), torch.float32) for m in ms])
            out_rows.append(row)
            log(f"# 6a fused_step fold K={K} {g['names']} T*m={sum(ms)} ({label}): bitwise "
                f"equal to plain{' in float32 and float64' if f64 else ''} and across "
                f"launches; kernel {row['ms']:.4f} ms (1 launch + 1 segment sum)  plain "
                f"{row['plain_ms']:.2f} ms  bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        return out_rows

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
    for name, arrs in bdict.items():  # the per-bucket wrapper: groups of one
        kind, floor = fs._meta[name]
        sD, sL = s[name]
        got = fused_step(sD, sL, v, arrs, kind, floor, 1.0, cfg=cfg_main, fold=fold)
        want = fused_step_plain(sD, sL, v, arrs, kind, floor, 1.0, cfg=cfg_main, fold=fold)
        torch.cuda.synchronize()
        bitwise(f"fused_step fold[{name}, float32] (a group of one)", got, want)
        del got, want
    rows["fused_step_fold"] += fold_base_check(fs, bdict, s, v, "6b", timed=True)
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
    expect = 749 * len(fs._groups)
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
    secs6b = {"eager": [], "replayed": []}
    for mode in ("replayed", "eager", "eager", "replayed"):  # in turns, after the first
        ctx = graphs.eager() if mode == "eager" else contextlib.nullcontext()
        with ctx:
            t0 = time.perf_counter()
            res_b2 = solve_batch_reserves_folded(compiled, eq.objective, scale_r,
                                                 options=opts6, n_iters=749)
            secs6b[mode].append(time.perf_counter() - t0)
        leaves = [(res_b.objective, res_b2.objective), (res_b.psi, res_b2.psi),
                  (res_b.prices, res_b2.prices)]
        leaves += [(res_b.deltas[k], res_b2.deltas[k]) for k in res_b.deltas]
        leaves += [(res_b.lambdas[k], res_b2.lambdas[k]) for k in res_b.lambdas]
        if not all(np.array_equal(a, b) for a, b in leaves):
            raise AssertionError(f"a {mode} folded reserve batch is not bitwise equal to the "
                                 "first")
    fold2_s, fold_eager_s = min(secs6b["replayed"]), min(secs6b["eager"])
    st = fs.fused_init(bdict)
    iter_dev_ms = graph_ms(lambda: fs._iterate_fused(*st, rho, c_f, lo_f, hi_f, buckets=bdict),
                           n=5, reps=3)
    log(f"# 6b repeat runs bitwise equal: replayed {secs6b['replayed']} s -> "
        f"{750 / fold2_s:.1f} it/s, {B * 750 / fold2_s:.1f} scenario-it/s; eager "
        f"{secs6b['eager']} s -> {750 / fold_eager_s:.1f} it/s, "
        f"{B * 750 / fold_eager_s:.1f} scenario-it/s (in turns, host clock, reserve planes "
        f"included); one folded fused iteration {iter_dev_ms:.4f} ms on the device (CUDA "
        f"graph) vs {1e3 * fold2_s / 750:.4f} ms replayed per iteration on the host clock")
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
        seconds=secs6b, eager_iters_per_s=750 / fold_eager_s,
        classic_s=classic_s, objectives=objs.tolist(), max_rel_vs_classic=float(rel.max()),
        launches=launches6b, repeat_bitwise_equal=True)
    del solver_b, res_c

    # ---- 6a (cont.). fused_step_delta(fold=), grouped, at the 6b shapes ----
    nu0f = np.asarray(res_b.prices, np.float64).astype(np.float32).astype(np.float64)
    bd, min_x0 = _delta_buckets_folded(fs, half(res_b.deltas), half(res_b.lambdas),
                                       np.full(B, 1e-3), nu0f)
    if not (min_x0 > 0).all():
        raise AssertionError(f"delta arrays at the 6b shapes: min x0 {min_x0}")
    rng = np.random.default_rng(5)
    vd = torch.as_tensor(0.3 * rng.normal(size=n_pad), dtype=torch.float32, device="cuda")
    rows["fused_step_delta_fold"] += fold_delta_check(fs, bd, vd, rng, "6b", timed=True)
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
    st1k = {}
    for name, arrs in s1k.buckets.items():
        kind, floor = s1k._meta[name]
        K, m = arrs["mask"].shape
        sD, sL = st1k[name] = delta_state(arrs, rng)
        got = fused_step(sD, sL, v1, arrs, kind, floor, 1.0, cfg=cfg_main, fold=s1k._fold)
        want = fused_step_plain(sD, sL, v1, arrs, kind, floor, 1.0, cfg=cfg_main,
                                fold=s1k._fold)
        torch.cuda.synchronize()
        bitwise(f"fused_step fold[{name}, 1k x {T1}]", got, want)
        big.append(dict(bucket=name, K=K, m=m))
    fold_base_check(s1k, s1k.buckets, st1k, v1, f"1k x {T1}", timed=False, f64=False)
    fold_delta_check(s1k, bd1, v1, rng, f"1k x {T1}", timed=False, f64=False)
    log(f"# 6a 1,000 pools / 64 assets x T={T1} ({sum(b['m'] for b in big)} folded pools; "
        f"{T1 * c_1k.n_assets} prices, {T1 * c_1k.n_assets * 4 // 1024} KB, more than one "
        f"block's 227 KB of shared memory): both fold kernels bitwise equal to plain on "
        f"{[b['bucket'] for b in big]}")
    out["fold_1k_x_1024"] = big
    del s1k, bd1, st1k

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
    def certified_sweep(mode):
        ctx = graphs.eager() if mode == "eager" else contextlib.nullcontext()
        _build.reset_launch_counts()
        plain = {}
        with ctx, count_plain_calls(plain):
            t0 = time.perf_counter()
            o = solve_batch_folded(compiled, c_s, np.maximum(lo_s, -3e38),
                                   np.full((Tc, n), 3e38), options=opts_s, chunk=250)
            solve_s = time.perf_counter() - t0
            ent = certify_batch(compiled, c_s, lo_s, hi_s, o.deltas, o.lambdas,
                                o.prices, psi_claimed=_psi_batch(compiled, o.deltas,
                                                                 o.lambdas))
            t1 = time.perf_counter()
            r = refine_sweep(compiled, c_s, lo_s, hi_s, o, target_gap=1e-6)
            refine_s = time.perf_counter() - t1
        return o, ent, r, solve_s, refine_s, dict(_build.LAUNCHES), plain

    out_s, entry, ref_s, solve_s, refine_s, launches6c, plain6 = certified_sweep("replayed")
    eager6c = certified_sweep("eager")
    n_ok = int(np.sum(ref_s.achieved))
    for mode, (o, _, r, t_s, t_r, _, _) in (("replayed", (out_s, None, ref_s, solve_s,
                                                          refine_s, None, None)),
                                          ("eager", eager6c)):
        log(f"# 6c certified sweep ({mode}), 10k pools x {Tc} objectives: folded fused "
            f"solve {int(o.iters[0])} iterations in {t_s:.3f} s (converged "
            f"{bool(o.converged[0])}; {Tc * int(o.iters[0]) / t_s:.1f} scenario-it/s); "
            f"refine_sweep {r.iters} correction iterations in {t_r:.3f} s; "
            f"{int(np.sum(r.achieved))}/{Tc} points certified at 1e-6")
    log(f"# 6c launches {launches6c}")
    same6c = (np.array_equal(out_s.psi, eager6c[0].psi)
              and np.array_equal(out_s.prices, eager6c[0].prices)
              and np.array_equal(ref_s.prices, eager6c[2].prices)
              and launches6c == eager6c[5])
    if not same6c:
        raise AssertionError("6c: the replayed sweep differs from the eager one")
    if launches6c["fused_step_fold"] == 0 or launches6c["fused_step_delta_fold"] == 0:
        raise AssertionError(f"6c: a fold kernel never launched: {launches6c}")
    if plain6 or eager6c[6]:
        raise AssertionError(f"6c: plain versions ran: {plain6} {eager6c[6]}")
    for t, (ct, ce) in enumerate(zip(ref_s.certificates, entry)):
        vals = (ct.objective, ct.dual_bound, ct.gap_rel, ct.feasibility_rel)
        if not all(math.isfinite(x) for x in vals) or not score(ct) <= score(ce):
            raise AssertionError(f"6c point {t}: {ct.summary()} (entry {score(ce):.3e})")
    # the grouped fold delta step at these shapes, where its launches happen
    fsc, _ = folded_solver(compiled, Tc, opts_s, torch.float32)
    nu0c = np.asarray(out_s.prices, np.float64).astype(np.float32).astype(np.float64)
    bdc, min_x0 = _delta_buckets_folded(fsc, half(out_s.deltas), half(out_s.lambdas),
                                        np.full(Tc, 1e-3), nu0c)
    if not (min_x0 > 0).all():
        raise AssertionError(f"delta arrays at the 6c shapes: min x0 {min_x0}")
    vc = torch.as_tensor(0.3 * rng.normal(size=-(-fsc.n // 128) * 128), dtype=torch.float32,
                         device="cuda")
    rows6c = fold_delta_check(fsc, bdc, vc, rng, f"10k x {Tc}", timed=True, f64=False)
    st6c = {name: delta_state(a, rng) for name, a in fsc.buckets.items()}
    rows6c_base = fold_base_check(fsc, fsc.buckets, st6c, vc, f"10k x {Tc}", timed=True,
                                  f64=False)
    del fsc, bdc, st6c
    out["certified_sweep"] = dict(
        T=Tc, solve_iters=int(out_s.iters[0]), solve_s=solve_s, refine_iters=int(ref_s.iters),
        refine_s=refine_s, certified=n_ok, launches=launches6c,
        eager=dict(solve_s=eager6c[3], refine_s=eager6c[4]),
        fused_step_fold=rows6c_base,
        fused_step_fold_ms=sum(r["ms"] for r in rows6c_base),
        entry_worst=max(score(ce) for ce in entry),
        final_worst=max(score(ct) for ct in ref_s.certificates),
        fused_step_delta_fold=rows6c,
        fused_step_delta_fold_ms=sum(r["ms"] for r in rows6c),
        fused_step_delta_fold_bound_ms=sum(r["bound_ms"] for r in rows6c))
    log(f"# 6c grouped fused_step_delta(fold=) at 10k x {Tc}: "
        f"{sum(r['ms'] for r in rows6c):.4f} ms per iteration (bound "
        f"{sum(r['bound_ms'] for r in rows6c):.4f} ms)")

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

def merged_utility_phase(report, rows, card, cfg_main, cfg64, counting_solver, refine_opts):
    """Phase 7, the merged K-group kernel and separable concave utilities
    (module docstring).  Appends the ``fused_step_merged`` rows to ``rows``
    and returns the launch counts of its main-path runs (7b, 7c, 7d)."""
    from cfmm_routing_tpu_torch import api
    from cfmm_routing_tpu_torch.models.utility import ConcaveUtility
    from cfmm_routing_tpu_torch.ops import _build
    from cfmm_routing_tpu_torch.ops.iteration_cuda import (
        fused_step, fused_step_merged, fused_step_merged_plain,
    )
    from cfmm_routing_tpu_torch.solver import graphs
    from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver
    from cfmm_routing_tpu_torch.solver.certify import certify
    from cfmm_routing_tpu_torch.solver.compiler import compile_spec, compile_table
    from cfmm_routing_tpu_torch.solver.precondition import equilibrate, unscale_result
    from cfmm_routing_tpu_torch.solver.refine import to_host
    from cfmm_routing_tpu_torch.solver.refine_device import refine_device
    from cfmm_routing_tpu_torch.utils.synth import (
        mixed_width_arbitrage, random_arbitrage, random_arbitrage_table,
    )

    out = {}
    t_phase = time.perf_counter()
    table, obj = random_arbitrage_table(256, 100_000, seed=7)
    eq = equilibrate(table, obj)
    compiled = compile_table(eq.table, pad_pools_to=1024)
    cert_compiled = compile_table(table, pad_pools_to=1024)
    opts = AdmmOptions(max_iters=500, eps_abs=0.0, eps_rel=0.0, adapt_rho=False,
                       projection=cfg_main)
    solver = AdmmSolver(compiled, dtype=torch.float32, options=opts)
    groups = solver._merged_groups()
    gshapes = {g["K"]: (g["names"], int(g["arrs"]["mask"].shape[1]),
                        int(g["arrs"]["order"].numel())) for g in groups}
    log(f"# 7: merged K-groups of the 100k network (K: buckets, pools, real slots): {gshapes}")
    if [(g["K"], g["names"]) for g in groups] != [(2, ["cs2f", "gm2", "gm2f"]),
                                                  (4, ["cs4f", "gm4"])]:
        raise AssertionError(f"unexpected merged groups {gshapes}")

    # ---- 7a. fused_step_merged vs its plain version at the two group shapes
    c, lo, hi, _ = solver._pack(eq.objective)
    rho = solver._t(1.0)
    s, wdef, nu = solver.fused_init()
    sm = solver._merge_state(s, groups)
    for _ in range(20):  # a mid-solve state, on the kernels
        sm, wdef, nu, _, _ = solver._iterate_fused_merged(sm, wdef, nu, rho, c, lo, hi, groups)
    v, _ = solver._fold_pack(wdef - nu)
    n_pad = v.shape[0]
    groups64 = AdmmSolver(compiled, dtype=torch.float64)._merged_groups()
    for g, g64, (sD, sL) in zip(groups, groups64, sm):
        K, m = g["arrs"]["mask"].shape
        kfn = lambda: fused_step_merged(sD, sL, v, g["arrs"], 1.0, cfg=cfg_main)  # noqa: E731
        pfn = lambda: fused_step_merged_plain(sD, sL, v, g["arrs"], 1.0, cfg=cfg_main)  # noqa: E731
        got, again, want = kfn(), kfn(), pfn()
        torch.cuda.synchronize()
        bitwise(f"fused_step_merged[K={K}, float32]", got, want)
        bitwise(f"fused_step_merged[K={K}, float32] second launch", again, got)
        a64 = g64["arrs"]
        got = fused_step_merged(sD.double(), sL.double(), v.double(), a64, 1.0, cfg=cfg64)
        again = fused_step_merged(sD.double(), sL.double(), v.double(), a64, 1.0, cfg=cfg64)
        want = fused_step_merged_plain(sD.double(), sL.double(), v.double(), a64, 1.0,
                                       cfg=cfg64)
        torch.cuda.synchronize()
        bitwise(f"fused_step_merged[K={K}, float64]", got, want)
        bitwise(f"fused_step_merged[K={K}, float64] second launch", again, got)
        row = dict(group=K, buckets=g["names"], dtype="float32", K=K, m=m, cfg=list(cfg_main),
                   max_abs_err=0.0, ms=graph_ms(kfn), plain_ms=eager_ms(pfn))
        # the fused step's bytes and operations (row 3's count) on the group
        fbytes = 4 * (11 * K * m + 3 * m + n_pad) + 4 * K * m
        row["bound_ms"], row["bound_by"] = bound_ms(
            fbytes, projection_flops(cfg_main, K, m), torch.float32)
        rows["fused_step_merged"].append(row)
        log(f"# 7a fused_step_merged K={K} {g['names']} m={m}: bitwise equal to plain in "
            f"float32 (24, 4) and float64 (48, 6), and two launches bitwise equal; kernel "
            f"{row['ms']:.4f} ms (incl. segment sum)  plain {row['plain_ms']:.2f} ms  "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        del got, again, want
    del groups64
    # the merged step is the grouped kernel over the group's class spans:
    # its instantiations at 2 and 4 lanes a pool (float and double)
    regs, loops = build_report(str(_build.BUILD_DIR))
    fs_regs = regs.get("fused_step", {})
    fs_loops = [lp for lp in loops if lp["library"] == "fused_step"]
    log(f"# 7a fused_step library (merged and grouped launches alike): registers, spill "
        f"stores, spill loads {fs_regs}; root-find loops at 2 lanes {fs_loops}")
    out["registers"], out["sass_loops"] = fs_regs, fs_loops
    # merged groups at the any-K shapes of phase 2c: K = 3, 5, 12 (4, 8, 16
    # lanes, idle lanes masked), 4, 8, 16 and 40 (one thread per pool), each
    # group three class spans (gm, floored gm, cs)
    any_k = []
    for widths, pad_pow2, want_k in (((3, 5, 12), False, [3, 5, 12]),
                                     ((3, 5, 12), True, [4, 8, 16]),
                                     ((40,), False, [40])):
        spec_w, _ = mixed_width_arbitrage(widths=widths, n_assets=48 if 40 in widths else 16,
                                          seed=2)
        comp_w = compile_spec(spec_w, pad_pow2=pad_pow2, pad_pools_to=128)
        rng = np.random.default_rng(5)
        for dtype in (torch.float32, torch.float64):
            gw = AdmmSolver(comp_w, dtype=dtype)._merged_groups()
            if [g["K"] for g in gw] != want_k:
                raise AssertionError(f"merged any-K groups {[g['K'] for g in gw]} != {want_k}")
            vw = torch.as_tensor(rng.normal(size=128), dtype=dtype, device="cuda")
            for g in gw:
                mask = g["arrs"]["mask"]
                sD, sL = (torch.as_tensor(rng.uniform(-2, 2, tuple(mask.shape)), dtype=dtype,
                                          device="cuda") * mask for _ in range(2))
                got = fused_step_merged(sD, sL, vw, g["arrs"], 1.5, cfg=cfg64)
                again = fused_step_merged(sD, sL, vw, g["arrs"], 1.5, cfg=cfg64)
                want = fused_step_merged_plain(sD, sL, vw, g["arrs"], 1.5, cfg=cfg64)
                torch.cuda.synchronize()
                label = f"any-K fused_step_merged[K={g['K']}, {str(dtype)[6:]}]"
                bitwise(label, got, want)
                bitwise(f"{label} second launch", again, got)
                any_k.append(dict(K=g["K"], dtype=str(dtype)[6:], m=int(mask.shape[1]),
                                  spans=[list(sp) for sp in g["arrs"]["spans"]]))
    log(f"# 7a any K: merged groups {[(r['K'], r['dtype'], r['m'], len(r['spans'])) for r in any_k]}"
        f" (K, dtype, pools, class spans) bitwise equal to plain at (48, 6), and across launches")
    out["any_k"] = any_k
    s = solver._split_state(sm, groups)
    unmerged_ms = 0.0
    for name, arrs in solver.buckets.items():
        kind, floor = solver._meta[name]
        sD, sL = s[name]
        unmerged_ms += graph_ms(
            lambda: fused_step(sD, sL, v, arrs, kind, floor, 1.0, cfg=cfg_main))
    merged_ms = sum(r["ms"] for r in rows["fused_step_merged"])
    st_m = (solver._merge_state(s, groups), wdef, nu)
    it_merged = graph_ms(lambda: solver._iterate_fused_merged(*st_m, rho, c, lo, hi, groups),
                         n=10, reps=5)
    it_unmerged = graph_ms(lambda: solver._iterate_fused(s, wdef, nu, rho, c, lo, hi),
                           n=10, reps=5)
    log(f"# 7a device ms per iteration (CUDA graphs): merged 2 launches + 2 segment sums "
        f"{merged_ms:.4f} ms vs fused_step per bucket (groups of one) 5 + 5 "
        f"{unmerged_ms:.4f} ms; whole fused iteration merged {it_merged:.4f} ms vs unmerged "
        f"(grouped, 2 + 2) {it_unmerged:.4f} ms")
    out["kernel"] = dict(merged_ms=merged_ms, unmerged_ms=unmerged_ms,
                         iteration_merged_ms=it_merged, iteration_unmerged_ms=it_unmerged)
    del sm, s, st_m

    # ---- 7b. path 1: solve_fused(merged=True), linear then a utility -----
    util = ConcaveUtility.linear(obj.c, lo=obj.lo, hi=obj.hi)
    util = util.with_log(1, c=1.0, b=2.0).with_log(3, c=0.5, b=1.0)
    eq_u = equilibrate(table, util)
    compiled_u = compile_table(eq_u.table, pad_pools_to=1024)
    solver_u = AdmmSolver(compiled_u, dtype=torch.float32, options=opts)
    launches = []
    path1 = {}
    for label, slv, objective, eqx, cobj in (
            ("linear", solver, eq.objective, eq, obj),
            ("utility", solver_u, eq_u.objective, eq_u, util)):
        _build.reset_launch_counts()
        plain7 = {}
        with count_plain_calls(plain7):
            t0 = time.perf_counter()
            res_m = slv.solve_fused(objective, iters=499, merged=True)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
        counts = dict(_build.LAUNCHES)
        launches.append(counts)
        if counts["fused_step_merged"] != 2 * 499 or counts["fused_step"] != 0 or plain7:
            raise AssertionError(f"7b {label}: launches {counts}, plain versions {plain7}")
        secs = {True: [], False: []}
        for merged in (False, True, False):  # in turns with the counted run
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            res = slv.solve_fused(objective, iters=499, merged=merged)
            stop.record()
            stop.synchronize()
            secs[merged].append(start.elapsed_time(stop) / 1e3)
            if merged and not all(torch.equal(x, y) for x, y in (
                    (res.psi, res_m.psi), (res.prices, res_m.prices),
                    (res.objective, res_m.objective))):
                raise AssertionError(f"7b {label}: a second merged run is not bitwise equal")
            if not merged:
                res_u = res
        obj_m, obj_u = float(res_m.objective), float(res_u.objective)
        rel = abs(obj_m - obj_u) / max(1.0, abs(obj_u))
        scale = max(1.0, float(res_u.psi.abs().max()))
        dpsi = float((res_m.psi - res_u.psi).abs().max()) / scale
        st = slv.fused_init()
        c_, lo_, hi_, u_ = slv._pack(objective)
        gr = slv._merged_groups()
        st_m = (slv._merge_state(st[0], gr), st[1], st[2])
        dev_m = graph_ms(lambda: slv._iterate_fused_merged(*st_m, rho, c_, lo_, hi_, gr,
                                                           util=u_), n=10, reps=5)
        dev_u = graph_ms(lambda: slv._iterate_fused(*st, rho, c_, lo_, hi_, util=u_),
                         n=10, reps=5)
        wall_m = min(secs[True]) / 500
        wall_u = min(secs[False]) / 500
        r0 = unscale_result(res_m, eqx.d, slv.compiled)
        cert = certify(cert_compiled, cobj, r0.deltas, r0.lambdas, r0.prices,
                       psi_claimed=r0.psi)
        log(f"# 7b {label}: merged vs unmerged objective {obj_m:.6f} vs {obj_u:.6f} (rel "
            f"{rel:.2e}), max|psi diff|/max|psi| {dpsi:.2e} (bars 1e-4 / 1e-3); launches "
            f"{counts}")
        log(f"# 7b {label}: 500 iterations merged {secs[True]} s -> "
            f"{500 / min(secs[True]):.1f} it/s, unmerged {secs[False]} s -> "
            f"{500 / min(secs[False]):.1f} it/s (host clock, first counted run "
            f"{first_s:.3f} s); device ms per iteration merged {dev_m:.4f} / unmerged "
            f"{dev_u:.4f}: the card idles {100 * (1 - 1e-3 * dev_m / wall_m):.1f}% / "
            f"{100 * (1 - 1e-3 * dev_u / wall_u):.1f}%")
        log(f"# 7b {label}: certificate of the merged route in original units {cert.summary()} "
            f"feasibility_rel {cert.feasibility_rel:.3e}")
        if not (rel <= 1e-4 and dpsi <= 1e-3):
            raise AssertionError(f"7b {label}: merged and unmerged disagree: {rel:.2e} {dpsi:.2e}")
        if not all(math.isfinite(x) for x in (cert.objective, cert.dual_bound, cert.gap_rel)):
            raise AssertionError(f"7b {label}: certificate not finite: {cert.summary()}")
        path1[label] = dict(
            objective_merged=obj_m, objective_unmerged=obj_u, rel=rel, psi_rel=dpsi,
            merged_s=secs[True], unmerged_s=secs[False], first_s=first_s,
            merged_it_s=500 / min(secs[True]), unmerged_it_s=500 / min(secs[False]),
            device_ms_merged=dev_m, device_ms_unmerged=dev_u,
            idle_merged=1 - 1e-3 * dev_m / wall_m, idle_unmerged=1 - 1e-3 * dev_u / wall_u,
            launches=counts, gap_rel=cert.gap_rel, feasibility_rel=cert.feasibility_rel)
        del res, res_m, res_u
    out["path1"] = path1
    del solver

    # ---- 7c. path 2: the certified 100k utility route ----------------------
    base_opts = AdmmOptions(max_iters=3000, eps_abs=1e-7, eps_rel=1e-7, check_every=25,
                            projection=cfg_main)

    def unscale(r):
        return unscale_result(r, eq_u.d, compiled_u)

    def utility_route(mode):
        ctx = graphs.eager() if mode == "eager" else contextlib.nullcontext()
        _build.reset_launch_counts()
        plain = {}
        with ctx, count_plain_calls(plain):
            torch.cuda.synchronize()
            t_base0 = time.perf_counter()
            base_solver = AdmmSolver(compiled_u, dtype=torch.float32, options=base_opts)
            res = base_solver.solve(eq_u.objective)
            torch.cuda.synchronize()
            base_s = time.perf_counter() - t_base0
            r0 = unscale(to_host(res))
            entry = certify(cert_compiled, util, r0.deltas, r0.lambdas, r0.prices,
                            psi_claimed=r0.psi)
            dsolver = counting_solver(compiled_u, options=refine_opts)
            t0 = time.perf_counter()
            rout = refine_device(compiled_u, eq_u.objective, res, target_gap=1e-6,
                                 fused=True, cert_space=(cert_compiled, util, unscale),
                                 entry_cert=entry, solver=dsolver)
            torch.cuda.synchronize()
            t_end = time.perf_counter()
        return dict(r0=r0, iters=int(res.iters), base_s=base_s, entry=entry, rout=rout,
                    chunks=dsolver.chunks, n_groups=len(dsolver._groups),
                    refine_s=t_end - t0, wall_s=t_end - t_base0,
                    counts=dict(_build.LAUNCHES), plain=plain)

    ue = utility_route("eager")
    ur = utility_route("replayed")
    for mode, u_ in (("eager", ue), ("replayed", ur)):
        log(f"# 7c refine_device(fused=True), utility ({mode}): base {u_['iters']} classic "
            f"iterations in {u_['base_s']:.3f} s; refinement {u_['rout'].iters} iterations "
            f"({u_['chunks']} chunks) in {u_['refine_s']:.3f} s; {u_['wall_s']:.3f} s from "
            f"the base solve's start (host clock)")
    if not (np.array_equal(np.asarray(ue["r0"].psi), np.asarray(ur["r0"].psi))
            and ue["rout"].certificate.gap_rel == ur["rout"].certificate.gap_rel
            and ue["counts"] == ur["counts"]):
        raise AssertionError("7c: the replayed utility route differs from the eager one")
    res_iters, entry, rout, counts = ur["iters"], ur["entry"], ur["rout"], ur["counts"]
    plain7 = {**ue["plain"], **ur["plain"]}
    launches.append(counts)
    fc = rout.certificate
    fused_iters = rout.iters - ur["chunks"]
    log(f"# 7c replayed and eager runs equal (base bitwise, same certificate and launches); "
        f"entry {entry.summary()}; final gap_rel {fc.gap_rel:.3e} feasibility_rel "
        f"{fc.feasibility_rel:.3e}; {fused_iters} fused delta iterations; launches {counts}")
    n_groups = ur["n_groups"]
    if (plain7 or counts["fused_step_delta"] == 0 or n_groups != 2
            or counts["fused_step_delta"] != n_groups * fused_iters
            or counts["project_delta"] != n_groups * ur["chunks"]):
        raise AssertionError(f"7c: launches {counts} ({n_groups} K-groups, {fused_iters} "
                             f"fused and {ur['chunks']} classic delta iterations), "
                             f"plain versions {plain7}")
    if not (rout.achieved and abs(fc.gap_rel) <= 1e-6 and fc.feasibility_rel <= 1e-6):
        raise AssertionError(f"7c: the utility route did not certify at 1e-6: {fc.summary()}")
    route_c = dict(base_iters=res_iters, base_s=ur["base_s"], refine_iters=int(rout.iters),
                   chunks=ur["chunks"], fused_iters=fused_iters, refine_s=ur["refine_s"],
                   wall_s=ur["wall_s"], gap_rel=fc.gap_rel,
                   feasibility_rel=fc.feasibility_rel, objective=fc.objective,
                   launches=counts, eager=dict(base_s=ue["base_s"], refine_s=ue["refine_s"],
                                               wall_s=ue["wall_s"]))
    del ue, ur, rout
    _build.reset_launch_counts()
    plain7 = {}
    with count_plain_calls(plain7):
        t0 = time.perf_counter()
        route = api.route(table, util, precondition=True, refine_to=1e-6, options=base_opts)
        api_s = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    launches.append(counts)
    ac = route.certificate
    log(f"# 7c api.route(table, utility, precondition=True, refine_to=1e-6): {api_s:.3f} s "
        f"(set-up included), {route.iters} iterations, certified {route.converged}: gap_rel "
        f"{ac.gap_rel:.3e} feasibility_rel {ac.feasibility_rel:.3e}, objective "
        f"{route.objective:.6f} (refine_device: {fc.objective:.6f}); launches {counts}")
    if plain7 or not (route.converged and abs(ac.gap_rel) <= 1e-6
                      and ac.feasibility_rel <= 1e-6):
        raise AssertionError(f"7c api: {ac.summary()} plain versions {plain7}")
    missing = [k for k in ("project", "segment_sum") if counts[k] == 0]
    if missing:
        raise AssertionError(f"7c api: kernels never launched: {missing}")
    out["path2"] = dict(refine_device=route_c, api=dict(
        seconds=api_s, iters=route.iters, gap_rel=ac.gap_rel,
        feasibility_rel=ac.feasibility_rel, objective=route.objective, launches=counts))

    # ---- 7d. the three test_utilities flavours, float64, card vs CPU -------
    spec, lin = random_arbitrage(5, 8, seed=11)
    n = spec.n_assets
    fixed = AdmmOptions(max_iters=300, eps_abs=0.0, eps_rel=0.0, check_every=25)
    flav = {}
    _build.reset_launch_counts()
    for flavour in ("log", "power", "quad"):
        u = ConcaveUtility.linear(lin.c, lo=np.zeros(n))
        for j in range(n):
            if flavour == "log":
                u = u.with_log(j, 1.0 + 0.2 * j, 1.0)
            elif flavour == "power":
                u = u.with_power(j, 1.0 + 0.1 * j, 0.5, 1.0)
            else:
                u = u.with_quadratic(j, 1.0 + 0.3 * j, 0.5)
            u = u.with_box(j, 0.0, 50.0)
        got, want = (api.route(spec, u, certify=True, dtype=torch.float64, options=fixed,
                               device=dev) for dev in (None, "cpu"))
        pairs = [(got.objective, want.objective), (got.certificate.dual_bound,
                                                   want.certificate.dual_bound),
                 (got.certificate.gap_rel, want.certificate.gap_rel)]
        pairs += list(zip(got.psi, want.psi)) + list(zip(got.prices, want.prices))
        worst = max(abs(a - b) / max(1.0, abs(b)) for a, b in pairs)
        log(f"# 7d {flavour}: card {got.objective:.12f} vs CPU {want.objective:.12f}; worst "
            f"difference (objective, dual bound, gap, psi, prices) {worst:.2e} (bar 1e-9); "
            f"gap_rel {got.certificate.gap_rel:.3e}")
        if not worst <= 1e-9:
            raise AssertionError(f"7d {flavour}: card and CPU differ by {worst:.2e}")
        flav[flavour] = dict(card=got.objective, cpu=want.objective, worst=worst,
                             gap_rel=got.certificate.gap_rel)
    launches.append(dict(_build.LAUNCHES))
    if launches[-1]["project"] == 0 or launches[-1]["segment_sum"] == 0:
        raise AssertionError(f"7d: the card runs launched no kernel: {launches[-1]}")
    out["flavours"] = flav
    report["merged_utility"] = out
    log(f"# phase 7 (merged kernel and utilities) done in {time.perf_counter() - t_phase:.1f} s "
        f"on {card}")
    return launches


def result_leaves(res):
    """A RouteResult's arrays in a fixed order, as CPU tensors."""
    out = [res.objective, res.psi, res.prices, res.iters, res.r_norm, res.s_norm,
           res.rho_final]
    out += [res.deltas[k] for k in sorted(res.deltas)]
    out += [res.lambdas[k] for k in sorted(res.lambdas)]
    return [x.cpu() if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
            for x in out]


def replay_vs_eager(label, run):
    """Run ``run`` eagerly (``graphs.eager()``) and replayed: raise unless
    the two results are bitwise equal with equal launch counts.  Returns
    (eager seconds, replayed seconds, launches), host clock with a
    synchronize."""
    from cfmm_routing_tpu_torch.ops import _build
    from cfmm_routing_tpu_torch.solver import graphs

    out = {}
    for mode in ("eager", "replayed"):
        ctx = graphs.eager() if mode == "eager" else contextlib.nullcontext()
        with ctx:
            _build.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            out[mode] = (time.perf_counter() - t0, result_leaves(res),
                         dict(_build.LAUNCHES))
    (te, le, ce), (tr, lr, cr) = out["eager"], out["replayed"]
    if ce != cr:
        raise AssertionError(f"{label}: launches eager {ce} != replayed {cr}")
    for i, (a, b) in enumerate(zip(le, lr)):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: replayed output {i} differs from eager by "
                                 f"{float((a.double() - b.double()).abs().max()):.3e}")
    return te, tr, cr


def device_busy(fn, label):
    """torch.profiler over ``fn``: the CUDA kernels' summed durations over
    the span from the first kernel's start to the last one's end.  Returns
    (busy share, kernels, span ms) or None when the trace has no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = []
    for e in prof.events():
        dev = getattr(e, "device_type", None)
        if dev is not None and "CUDA" in str(dev) and e.time_range.end > e.time_range.start:
            spans.append((e.time_range.start, e.time_range.end))
    if not spans:
        log(f"# profiler ({label}): key_averages() shows no device time; the CUDA-event "
            f"estimate stands")
        return None
    spans.sort()
    busy = 0.0
    cur_s, cur_e = spans[0]
    for s_, e_ in spans[1:]:  # the union of the kernels' intervals
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    return busy / span, len(spans), span / 1e3


def replay_phase(report, card, cfg_main, cfg64):
    """Phase 8, CUDA-graph replays against eager runs (module docstring)."""
    from cfmm_routing_tpu_torch.models.utility import ConcaveUtility
    from cfmm_routing_tpu_torch.solver import graphs
    from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver
    from cfmm_routing_tpu_torch.solver.compiler import compile_table
    from cfmm_routing_tpu_torch.solver.driver import ChunkedDriver
    from cfmm_routing_tpu_torch.solver.fold import solve_batch_reserves_folded
    from cfmm_routing_tpu_torch.solver.precondition import equilibrate
    from cfmm_routing_tpu_torch.solver.refine import to_host
    from cfmm_routing_tpu_torch.solver.refine_device import (
        DeltaAdmmSolver, _delta_objective, _psi_from_trades,
    )
    from cfmm_routing_tpu_torch.utils.synth import random_arbitrage_table

    t_phase = time.perf_counter()
    table, obj = random_arbitrage_table(256, 100_000, seed=7)
    eq = equilibrate(table, obj)
    compiled = compile_table(eq.table, pad_pools_to=1024)
    util = ConcaveUtility.linear(obj.c, lo=obj.lo, hi=obj.hi)
    util = util.with_log(1, c=1.0, b=2.0).with_log(3, c=0.5, b=1.0)
    eq_u = equilibrate(table, util)
    out = {}
    for dtype, depth, T in ((torch.float32, 60, 8), (torch.float64, 30, 2)):
        dname = str(dtype).split(".")[1]
        cfg = cfg_main if dtype == torch.float32 else cfg64
        fixed = AdmmOptions(max_iters=2 * depth, eps_abs=0.0, eps_rel=0.0,
                            check_every=depth // 2, projection=cfg)
        solver = AdmmSolver(compiled, dtype=dtype, options=fixed)
        base = to_host(AdmmSolver(compiled, options=AdmmOptions(
            max_iters=100, check_every=25, projection=cfg_main)).solve(eq.objective))
        base = base._replace(psi=_psi_from_trades(compiled, base))
        dsolver = DeltaAdmmSolver(compiled, dtype=dtype, options=dataclasses.replace(
            fixed, adapt_rho=False))
        nu0 = np.asarray(base.prices, np.float64).astype(np.float32).astype(np.float64)
        bdict, _ = dsolver.delta_buckets(base, 1e-3, nu0=nu0)
        dobj = _delta_objective(eq.objective, base.psi, 1e-3)
        scale = np.random.default_rng(3).uniform(0.7, 1.3, size=(T, compiled.n_pools))
        c_b = np.asarray(eq.objective.c)[None, :] * np.linspace(0.9, 1.1, T)[:, None]
        lo_b = np.tile(np.maximum(eq.objective.lo, -3e38), (T, 1))
        paths = {
            "classic": lambda: solver.solve(eq.objective),
            "classic utility": lambda: AdmmSolver(compile_table(
                eq_u.table, pad_pools_to=1024), dtype=dtype, options=fixed).solve(
                eq_u.objective),
            "fused": lambda: solver.solve_fused(eq.objective, iters=depth),
            "merged": lambda: solver.solve_fused(eq.objective, iters=depth, merged=True),
            "fused delta": lambda: dsolver.solve_delta(dobj, bdict, nu0, 1.0, depth,
                                                       fused=True),
            "classic delta": lambda: dsolver.solve_delta(dobj, bdict, nu0, 1.0, depth),
            f"fold x {T}": lambda: solve_batch_reserves_folded(
                compiled, eq.objective, scale, options=fixed, dtype=dtype,
                n_iters=depth - 1),
            f"batch per point x {T}": lambda: solver.solve_batch(
                c_b, lo_b, np.full_like(c_b, 3e38)),
            "driver classic": lambda: ChunkedDriver(solver, chunk=depth // 2).solve(
                eq.objective, max_iters=depth)[0],
            "driver fused": lambda: ChunkedDriver(solver, chunk=depth // 2,
                                                  fused=True).solve(
                eq.objective, max_iters=depth)[0],
        }
        rows = {}
        for name, run in paths.items():
            te, tr, counts = replay_vs_eager(f"{name} {dname}", run)
            rows[name] = dict(eager_s=te, replayed_s=tr,
                              launches={k: v for k, v in counts.items() if v})
            log(f"# 8 replay vs eager, {name} ({dname}, {depth} iterations at 100k "
                f"pools): bitwise equal, launches equal; {te:.3f} s eager vs {tr:.3f} s "
                f"replayed (host clock, first replayed run includes the capture)")
        out[dname] = rows
        del solver, dsolver, bdict
        torch.cuda.empty_cache()

    # peak device memory of the fused base (100k, 499 + 1 iterations) and of
    # the folded reserve batch (100k x 8, 749 + 1), eager and replayed (the
    # replayed run includes its capture), each on a fresh solver
    from cfmm_routing_tpu_torch.solver.admm import _reserve_buckets
    from cfmm_routing_tpu_torch.solver.fold import fold_compiled

    opts_m = AdmmOptions(max_iters=750, eps_abs=0.0, eps_rel=0.0, adapt_rho=False,
                         projection=cfg_main)
    scale8 = np.random.default_rng(3).uniform(0.7, 1.3, size=(8, compiled.n_pools))
    mem = {}

    def fused_100k():
        slv = AdmmSolver(compiled, dtype=torch.float32, options=opts_m)
        return lambda: slv.solve_fused(eq.objective, iters=499)

    def fold_100k_x_8():
        slv = AdmmSolver(fold_compiled(compiled, 8), dtype=torch.float32, options=opts_m,
                         fold=(8, compiled.n_assets))
        bd = _reserve_buckets(slv, fold_compiled(compiled, 8, scale8))
        k = (slv._t(np.tile(x, 8)) for x in (eq.objective.c,
                                             np.maximum(eq.objective.lo, -3e38),
                                             np.minimum(eq.objective.hi, 3e38)))
        c8, lo8, hi8 = k
        return lambda: slv._solve_fused_impl(c8, lo8, hi8, slv._t(1.0), 749, buckets=bd)

    for label, make in (("100k", fused_100k), ("100k x 8", fold_100k_x_8)):
        for mode in ("eager", "replayed"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            run = make()
            ctx = graphs.eager() if mode == "eager" else contextlib.nullcontext()
            with ctx:
                run()
            torch.cuda.synchronize()
            mem[f"{label}, {mode}"] = dict(
                peak_mb=torch.cuda.max_memory_allocated() / 2**20,
                above_start_mb=(torch.cuda.max_memory_allocated() - before) / 2**20)
            del run
        log(f"# 8 peak device memory, fused solve at {label}: eager "
            f"{mem[f'{label}, eager']['peak_mb']:.1f} MB, replayed "
            f"{mem[f'{label}, replayed']['peak_mb']:.1f} MB (max_memory_allocated; "
            f"{mem[f'{label}, eager']['above_start_mb']:.1f} / "
            f"{mem[f'{label}, replayed']['above_start_mb']:.1f} MB above the start)")
    out["memory"] = mem

    # device busy share from torch.profiler: 50 and 500 fused-base
    # iterations (each ends in one eager classic harvest iteration), then
    # one classic check block (24 stats-free + 1)
    opts = AdmmOptions(max_iters=25, eps_abs=0.0, eps_rel=0.0, adapt_rho=False,
                       check_every=25, projection=cfg_main)
    solver = AdmmSolver(compiled, dtype=torch.float32, options=opts)
    solver.solve_fused(eq.objective, iters=50)  # captured before the window
    solver.solve(eq.objective)
    prof = {}
    solver.solve_fused(eq.objective, iters=500)
    for label, fn in (("fused base, 50 iterations",
                       lambda: solver.solve_fused(eq.objective, iters=50)),
                      ("fused base, 500 iterations",
                       lambda: solver.solve_fused(eq.objective, iters=500)),
                      ("classic check block, 25 iterations",
                       lambda: solver.solve(eq.objective))):
        for mode in ("replayed", "eager"):
            ctx = graphs.eager() if mode == "eager" else contextlib.nullcontext()
            with ctx:
                got = device_busy(fn, f"{label}, {mode}")
            if got is not None:
                prof[f"{label}, {mode}"] = dict(busy=got[0], kernels=got[1],
                                                span_ms=got[2])
                log(f"# 8 profiler, {label}, {mode}: {got[1]} kernels busy "
                    f"{100 * got[0]:.1f}% of their {got[2]:.3f} ms span (idle "
                    f"{100 * (1 - got[0]):.1f}%)")
    out["profiler"] = prof
    report["graphs"] = out
    log(f"# phase 8 (graph replays vs eager) done in {time.perf_counter() - t_phase:.1f} s "
        f"on {card}")


# ---- phase 9: scale-out on torch.distributed -----------------------------------
# 9a runs in this process on a one-rank NCCL group; 9b and 9c spawn ranks that
# share the one card over gloo (NCCL refuses two ranks on one device), eagerly:
# their times are no scale-out times.

SCALEOUT_TIMEOUT_S = 300  # every spawned rank's group timeout; the parent waits a minute more


def same_result(label, got, want):
    """Raise unless two RouteResults are bitwise equal, leaf for leaf."""
    for i, (a, b) in enumerate(zip(result_leaves(got), result_leaves(want))):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: output {i} differs by "
                                 f"{float((a.double() - b.double()).abs().max()):.3e}")


def scaleout_main_net(pad):
    """The 100k / 256 network of phase 4, equilibrated, compiled with
    ``pad_pools_to=pad``; and its original-units twin for the certificates."""
    from cfmm_routing_tpu_torch.solver.compiler import compile_table
    from cfmm_routing_tpu_torch.solver.precondition import equilibrate
    from cfmm_routing_tpu_torch.utils.synth import random_arbitrage_table

    table, obj = random_arbitrage_table(256, 100_000, seed=7)
    eq = equilibrate(table, obj)
    return (obj, eq, compile_table(eq.table, pad_pools_to=pad),
            compile_table(table, pad_pools_to=pad))


def scaleout_route(compiled, cert_compiled, obj, eq, base_solver, delta_solver):
    """Phase 5's certified route: ``base_solver.solve`` (classic base), then
    ``refine_device(target_gap=1e-6)`` with ``delta_solver``, certified in
    original units.  Returns (out, base result, base s, refine s)."""
    from cfmm_routing_tpu_torch.solver.precondition import unscale_result
    from cfmm_routing_tpu_torch.solver.refine_device import refine_device

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    base = base_solver.solve(eq.objective)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = refine_device(compiled, eq.objective, base, target_gap=1e-6,
                        cert_space=(cert_compiled, obj,
                                    lambda r: unscale_result(r, eq.d, compiled)),
                        solver=delta_solver)
    torch.cuda.synchronize()
    return out, base, t1 - t0, time.perf_counter() - t1


def _rank_9b(rank, cfg_main, refine_opts):
    """One of 9b's two ranks: the 100k / 256 network compiled with
    ``pad_pools_to=2048`` (each rank 1024-aligned buckets), every solve
    eager (gloo).  Rank 0 also runs the single-device references, replayed."""
    from cfmm_routing_tpu_torch.ops import _build
    from cfmm_routing_tpu_torch.parallel.mesh import pool_mesh
    from cfmm_routing_tpu_torch.parallel.sharded import (
        ShardedAdmmSolver, ShardedDeltaAdmmSolver,
    )
    from cfmm_routing_tpu_torch.solver import graphs
    from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver
    from cfmm_routing_tpu_torch.solver.refine_device import DeltaAdmmSolver
    from cfmm_routing_tpu_torch.utils.synth import random_arbitrage_table

    out = {}
    mesh = pool_mesh()
    obj, eq, compiled, cert_compiled = scaleout_main_net(2048)
    table, tobj = random_arbitrage_table(256, 100_000, seed=7)
    with graphs.eager():
        out["kernels_checked"] = gated_kernel_checks(f"rank {rank}", table, tobj, pad=2048,
                                                     mesh=mesh, phase="9b")
        opts = AdmmOptions(max_iters=500, eps_abs=0.0, eps_rel=0.0, adapt_rho=False,
                           projection=cfg_main)
        sh = ShardedAdmmSolver(compiled, mesh, options=opts)
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sh.solve_fused(eq.objective, iters=499)
        torch.cuda.synchronize()
        out["fused_s"] = time.perf_counter() - t0
        out["fused_launches"] = dict(_build.LAUNCHES)
        out["fused_objective"] = float(res.objective)
        psi = res.psi.double().cpu().numpy()
        base_opts = AdmmOptions(max_iters=3000, eps_abs=1e-7, eps_rel=1e-7, check_every=25,
                                projection=cfg_main)
        _build.reset_launch_counts()
        route, base, base_s, refine_s = scaleout_route(
            compiled, cert_compiled, obj, eq, ShardedAdmmSolver(compiled, mesh, options=base_opts),
            ShardedDeltaAdmmSolver(compiled, mesh, options=refine_opts))
        out["route_launches"] = dict(_build.LAUNCHES)
        c = route.certificate
        out["route"] = dict(achieved=bool(route.achieved), objective=c.objective,
                            gap_rel=c.gap_rel, feasibility_rel=c.feasibility_rel,
                            base_iters=int(base.iters), base_s=base_s,
                            refine_iters=int(route.iters), refine_s=refine_s)
        o64 = AdmmOptions(max_iters=200, eps_abs=0.0, eps_rel=0.0, projection=cfg_main)
        _build.reset_launch_counts()
        a = ShardedAdmmSolver(compiled, mesh, dtype=torch.float64, options=o64,
                              shard_assets=True).solve(eq.objective)
        b = ShardedAdmmSolver(compiled, mesh, dtype=torch.float64, options=o64).solve(
            eq.objective)
        out["assets_launches"] = dict(_build.LAUNCHES)
        out["assets"] = dict(objective=float(a.objective), replicated=float(b.objective),
                             psi_max_abs=float((a.psi - b.psi).abs().max()))
    if rank == 0:  # the single-device references, replayed (nothing to all-reduce)
        ref = AdmmSolver(compiled, options=opts).solve_fused(eq.objective, iters=499)
        p1 = ref.psi.double().cpu().numpy()
        out["fused_ref_objective"] = float(ref.objective)
        out["fused_psi_drift"] = float(np.max(np.abs(psi - p1))) / max(
            1.0, float(np.max(np.abs(p1))))
        route1, _, _, _ = scaleout_route(
            compiled, cert_compiled, obj, eq, AdmmSolver(compiled, options=base_opts),
            DeltaAdmmSolver(compiled, options=refine_opts))
        out["route_ref"] = dict(achieved=bool(route1.achieved),
                                objective=route1.certificate.objective,
                                gap_rel=route1.certificate.gap_rel)
    return out


def _rank_9c(rank, cfg_main, refine_opts):
    """One of 9c's four ranks on a 2x2 ``pool_batch_mesh``: 4 reserve
    scenarios of the 10k / 64 network, float64 to 1e-7 (checked every 25
    iterations), eager (gloo); rank 0 also solves them unsharded, replayed."""
    from cfmm_routing_tpu_torch.ops import _build
    from cfmm_routing_tpu_torch.parallel.mesh import pool_batch_mesh
    from cfmm_routing_tpu_torch.parallel.sharded import ShardedAdmmSolver
    from cfmm_routing_tpu_torch.solver import graphs
    from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver
    from cfmm_routing_tpu_torch.solver.compiler import compile_table
    from cfmm_routing_tpu_torch.solver.precondition import equilibrate
    from cfmm_routing_tpu_torch.utils.synth import random_arbitrage_table

    table, obj = random_arbitrage_table(64, 10_000, seed=7)
    eq = equilibrate(table, obj)
    compiled = compile_table(eq.table, pad_pools_to=1024)
    scale = np.random.default_rng(5).uniform(0.7, 1.3, size=(4, compiled.n_pools))
    opts = AdmmOptions(max_iters=4000, eps_abs=1e-7, eps_rel=1e-7, check_every=25)
    mesh = pool_batch_mesh(pools=2, batch=2)
    out = {}
    with graphs.eager():
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ShardedAdmmSolver(compiled, mesh, dtype=torch.float64,
                                options=opts).solve_batch_reserves(eq.objective, scale)
        torch.cuda.synchronize()
        out["s"] = time.perf_counter() - t0
        out["launches"] = dict(_build.LAUNCHES)
    out["objective"] = res.objective.cpu().tolist()
    out["iters"] = res.iters.cpu().tolist()
    if rank == 0:
        ref = AdmmSolver(compiled, dtype=torch.float64, options=opts).solve_batch_reserves(
            eq.objective, scale)
        out["ref_objective"] = ref.objective.cpu().tolist()
        out["ref_iters"] = ref.iters.cpu().tolist()
    return out


def _rank_main(part, rank, world, store, out_dir, cfg_main, refine_opts):
    """Entry of a spawned rank of 9b / 9c: joins the gloo group, runs its part,
    writes its JSON; on a failure it writes the traceback and exits at once,
    so that its peers fail at their next collective."""
    try:
        torch.cuda.set_device(0)
        from cfmm_routing_tpu_torch.parallel.mesh import init_distributed

        init_distributed(f"file://{store}", world, rank, backend="gloo",
                         timeout=SCALEOUT_TIMEOUT_S)
        fn = {"9b": _rank_9b, "9c": _rank_9c}[part]
        result = fn(rank, cfg_main, refine_opts)
        with open(os.path.join(out_dir, f"{part}_rank{rank}.json"), "w") as fh:
            json.dump(result, fh)
        torch.distributed.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"{part}_rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def spawn_ranks(part, world, cfg_main, refine_opts):
    """Run ``part`` on ``world`` spawned ranks sharing the card; every rank's
    result, or raise when a rank fails or outlasts the timeout (all killed)."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as out_dir:
        store = os.path.join(out_dir, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(part, r, world, store, out_dir, cfg_main, refine_opts))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + SCALEOUT_TIMEOUT_S + 60
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if late or failed:
            errs = "".join(open(os.path.join(out_dir, f)).read()
                           for f in sorted(os.listdir(out_dir)) if f.endswith(".err"))
            raise AssertionError(f"phase {part}: ranks {failed} failed ({late} timed out):\n"
                                 f"{errs}")
        out = []
        for r in range(world):
            with open(os.path.join(out_dir, f"{part}_rank{r}.json")) as fh:
                out.append(json.load(fh))
        return out


def collective_ms(sharded, unsharded, objective, iters):
    """What a sharded ``solve_fused(iters)`` adds on the device to the
    unsharded one, from ``torch.profiler`` windows over both (replayed):
    the NCCL kernels' device ms per iteration, and the names of every
    kernel or copy that only the sharded window holds."""
    from torch.profiler import ProfilerActivity, profile

    def device_us(solver):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            solver.solve_fused(objective, iters=iters)
            torch.cuda.synchronize()
        out = {}
        for e in prof.events():
            if "CUDA" in str(getattr(e, "device_type", "")):
                out[e.name] = out.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
        return out

    plain, sharded_us = device_us(unsharded), device_us(sharded)
    nccl = sum(v for k, v in sharded_us.items() if "nccl" in k.lower())
    return nccl / 1e3 / (iters + 1), sorted(k for k in sharded_us if k not in plain)


def scaleout_phase(report, card, cfg_main, refine_opts):
    """Phase 9: the sharded solvers (``parallel/``) on the card.  9a: one
    rank, NCCL, in this process, replayed, bitwise against the unsharded
    solvers at 100k / 256, the certified route, and the fused it/s of both
    in turns; 9b: two spawned ranks on gloo, eager (kernels on each rank's
    K-groups, the fused solve, the certified route, the asset-sharded
    consensus); 9c: four spawned ranks on a 2x2 batch x pools mesh, the
    reserve scenarios.  Returns the main-path launch counts of every
    sharded run (9b and 9c: each rank's)."""
    import torch.distributed as dist

    from cfmm_routing_tpu_torch.ops import _build
    from cfmm_routing_tpu_torch.parallel.mesh import pool_mesh
    from cfmm_routing_tpu_torch.parallel.sharded import (
        ShardedAdmmSolver, ShardedDeltaAdmmSolver,
    )
    from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver
    from cfmm_routing_tpu_torch.solver.driver import ChunkedDriver
    from cfmm_routing_tpu_torch.solver.refine import to_host
    from cfmm_routing_tpu_torch.solver.refine_device import (
        DeltaAdmmSolver, _delta_objective, _psi_from_trades,
    )

    t_phase = time.perf_counter()
    log(f"# phase 9 (scale-out): torch {torch.__version__}, NCCL "
        f"{'.'.join(map(str, torch.cuda.nccl.version()))}")
    launches = []

    def counted(fn):
        """``fn()`` with the launch counts set to 0 just before, read just
        after (a sharded main-path run)."""
        _build.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        launches.append(dict(_build.LAUNCHES))
        return out

    # ---- 9a. one rank, NCCL, in this process, replayed ---------------------------
    t9a = time.perf_counter()
    obj, eq, compiled, cert_compiled = scaleout_main_net(1024)
    mesh = pool_mesh()  # no group yet: a one-rank NCCL group over an in-memory store
    if dist.get_backend(mesh.get_group("pools")) != "nccl" or mesh.size() != 1:
        raise AssertionError(f"9a: expected a one-rank NCCL mesh, got {mesh}")
    opts = AdmmOptions(max_iters=500, eps_abs=0.0, eps_rel=0.0, adapt_rho=False,
                       projection=cfg_main)
    base_opts = AdmmOptions(max_iters=3000, eps_abs=1e-7, eps_rel=1e-7, check_every=25,
                            projection=cfg_main)
    sh, single = ShardedAdmmSolver(compiled, mesh, options=opts), AdmmSolver(compiled,
                                                                             options=opts)
    res_s = counted(lambda: sh.solve_fused(eq.objective, iters=499))
    same_result("9a solve_fused(499)", res_s, single.solve_fused(eq.objective, iters=499))
    shc = ShardedAdmmSolver(compiled, mesh, options=base_opts)
    sic = AdmmSolver(compiled, options=base_opts)
    base_s = counted(lambda: shc.solve(eq.objective))
    base_1 = sic.solve(eq.objective)
    same_result("9a classic solve", base_s, base_1)
    drv_s, log_s = counted(lambda: ChunkedDriver(shc, chunk=250, fused=True).solve(
        eq.objective, max_iters=3000))
    drv_1, log_1 = ChunkedDriver(sic, chunk=250, fused=True).solve(eq.objective,
                                                                   max_iters=3000)
    same_result("9a ChunkedDriver(fused=True)", drv_s, drv_1)
    if log_s.status != log_1.status or len(log_s) != len(log_1):
        raise AssertionError(f"9a ChunkedDriver: {log_s.status} after {len(log_s)} chunks "
                             f"!= {log_1.status} after {len(log_1)}")
    host_base = to_host(base_1)
    host_base = host_base._replace(psi=_psi_from_trades(compiled, host_base))
    rho_d = float(np.clip(np.asarray(host_base.rho_final), 0.25, 4.0))
    nu0 = (np.asarray(host_base.prices, np.float64) / rho_d).astype(np.float32).astype(
        np.float64)
    dobj = _delta_objective(eq.objective, host_base.psi, 1e-3)
    dsh = ShardedDeltaAdmmSolver(compiled, mesh, options=refine_opts)
    dsi = DeltaAdmmSolver(compiled, options=refine_opts)
    bd_s, mx_s = dsh.delta_buckets(host_base, 1e-3, nu0=nu0)
    bd_1, mx_1 = dsi.delta_buckets(host_base, 1e-3, nu0=nu0)
    if mx_s != mx_1:
        raise AssertionError(f"9a delta_buckets: min x0 {mx_s} != {mx_1}")
    d_s = counted(lambda: dsh.solve_delta(dobj, bd_s, nu0, rho_d, 250, fused=True))
    same_result("9a solve_delta(fused=True)", d_s,
                dsi.solve_delta(dobj, bd_1, nu0, rho_d, 250, fused=True))
    log("# 9a: one NCCL rank, replayed: solve_fused(499), the classic solve (phase 5's "
        "options), ChunkedDriver(fused=True) and solve_delta(fused=True) bitwise equal to "
        "the unsharded solvers'")
    route = counted(lambda: scaleout_route(
        compiled, cert_compiled, obj, eq, shc, ShardedDeltaAdmmSolver(
            compiled, mesh, options=refine_opts)))
    out9a, _, rb_s, rr_s = route
    c9a = out9a.certificate
    log(f"# 9a certified route (sharded, one rank): base {rb_s:.3f} s, refinement "
        f"{out9a.iters} iterations {rr_s:.3f} s; gap_rel {c9a.gap_rel:.3e} feasibility_rel "
        f"{c9a.feasibility_rel:.3e}; achieved {out9a.achieved}")
    if not (out9a.achieved and abs(c9a.gap_rel) <= 1e-6 and c9a.feasibility_rel <= 1e-6):
        raise AssertionError(f"9a: the sharded certified route missed 1e-6: {c9a.summary()}")
    secs = {"unsharded": [], "sharded": []}
    for who in ("unsharded", "sharded", "sharded", "unsharded"):  # in turns
        solver = single if who == "unsharded" else sh
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        solver.solve_fused(eq.objective, iters=499)
        stop.record()
        stop.synchronize()
        secs[who].append(start.elapsed_time(stop) / 1e3)
    its = {k: 500 / min(v) for k, v in secs.items()}
    ar_ms, ar_names = collective_ms(sh, single, eq.objective, 49)
    log(f"# 9a fused it/s (500 iterations, replayed, in turns): unsharded "
        f"{its['unsharded']:.1f} {secs['unsharded']} s, sharded one rank "
        f"{its['sharded']:.1f} {secs['sharded']} s; NCCL kernels {ar_ms:.5f} device ms "
        f"an iteration (profiler, 50 iterations; device work only the sharded window "
        f"holds: {[n[:60] for n in ar_names]}) on {card}")
    report["scaleout_9a"] = dict(
        fused_iters_per_s=its, fused_s=secs, allreduce_ms_per_iter=ar_ms,
        allreduce_kernels=ar_names,
        route=dict(achieved=bool(out9a.achieved), gap_rel=c9a.gap_rel,
                   feasibility_rel=c9a.feasibility_rel, objective=c9a.objective,
                   base_s=rb_s, refine_s=rr_s, refine_iters=int(out9a.iters)),
        seconds=time.perf_counter() - t9a)
    del sh, single, shc, sic, dsh, dsi, bd_s, bd_1
    dist.destroy_process_group()
    log(f"# 9a done in {time.perf_counter() - t9a:.1f} s")

    # ---- 9b. two ranks on the card, gloo, eager -----------------------------------
    t9b = time.perf_counter()
    r9b = spawn_ranks("9b", 2, cfg_main, refine_opts)
    log(f"# 9b ranks done in {time.perf_counter() - t9b:.1f} s")
    r0 = r9b[0]
    replicated = ("achieved", "objective", "gap_rel", "feasibility_rel", "base_iters",
                  "refine_iters")
    for r, res in enumerate(r9b):
        launches += [res["fused_launches"], res["route_launches"], res["assets_launches"]]
        if ([res["route"][k] for k in replicated] != [r0["route"][k] for k in replicated]
                or res["fused_objective"] != r0["fused_objective"]
                or res["assets"] != r0["assets"]):
            raise AssertionError(f"9b: rank {r}'s replicated results differ from rank "
                                 f"0's: {res} vs {r0}")
    rel_f = abs(r0["fused_objective"] - r0["fused_ref_objective"]) / max(
        1.0, abs(r0["fused_ref_objective"]))
    rt, rf = r0["route"], r0["route_ref"]
    rel_route = abs(rt["objective"] - rf["objective"]) / max(1.0, abs(rf["objective"]))
    a = r0["assets"]
    rel_assets = abs(a["objective"] - a["replicated"]) / max(1.0, abs(a["replicated"]))
    log(f"# 9b (two ranks sharing one card, gloo through the host, eager: no scale-out "
        f"time): kernels bitwise on each rank's K-groups {[x['kernels_checked'] for x in r9b]}; "
        f"solve_fused(499) {r0['fused_s']:.3f} s, objective rel {rel_f:.2e} vs unsharded, psi "
        f"drift {r0['fused_psi_drift']:.2e}; certified route base {rt['base_iters']} "
        f"iterations {rt['base_s']:.3f} s, refinement {rt['refine_iters']} iterations "
        f"{rt['refine_s']:.3f} s, gap_rel {rt['gap_rel']:.3e} feasibility_rel "
        f"{rt['feasibility_rel']:.3e}, objective rel {rel_route:.2e} vs the single-device "
        f"route's (gap_rel {rf['gap_rel']:.3e}); shard_assets objective rel {rel_assets:.2e}, "
        f"psi {a['psi_max_abs']:.2e}; {time.perf_counter() - t9b:.1f} s on {card}")
    if not rel_f <= 1e-4:
        raise AssertionError(f"9b: sharded fused objective rel {rel_f:.2e} > 1e-4")
    if not (rt["achieved"] and rf["achieved"] and abs(rt["gap_rel"]) <= 1e-6
            and rt["feasibility_rel"] <= 1e-6 and rel_route <= 1e-6):
        raise AssertionError(f"9b: certified route {rt} vs single-device {rf}")
    if not rel_assets <= 1e-8:
        raise AssertionError(f"9b: shard_assets objective rel {rel_assets:.2e} > 1e-8")

    # ---- 9c. four ranks on the card, 2x2 batch x pools, gloo, eager ---------------
    t9c = time.perf_counter()
    r9c = spawn_ranks("9c", 4, cfg_main, refine_opts)
    launches += [res["launches"] for res in r9c]
    got, want = np.asarray(r9c[0]["objective"]), np.asarray(r9c[0]["ref_objective"])
    rel_c = float(np.max(np.abs(got - want) / np.abs(want)))
    log(f"# 9c (four ranks sharing one card, gloo, eager): solve_batch_reserves of 4 "
        f"scenarios at 10k / 64, float64 to 1e-7, {r9c[0]['s']:.3f} s, iterations "
        f"{r9c[0]['iters']} (unsharded {r9c[0]['ref_iters']}); objectives rel {rel_c:.2e} "
        f"vs unsharded; {time.perf_counter() - t9c:.1f} s on {card}")
    if not rel_c <= 1e-6:
        raise AssertionError(f"9c: sharded reserve scenarios rel {rel_c:.2e} > 1e-6")
    report["scaleout_9b"] = dict(ranks=r9b, fused_rel=rel_f, route_rel=rel_route,
                                 assets_rel=rel_assets, seconds=time.perf_counter() - t9b)
    report["scaleout_9c"] = dict(ranks=r9c, rel=rel_c, seconds=time.perf_counter() - t9c)
    missing = [k for k in ("project", "fused_step", "segment_sum", "fused_step_delta",
                           "project_delta") if not any(c.get(k) for c in launches)]
    if missing:
        raise AssertionError(f"phase 9: kernels never launched on the sharded paths: {missing}")
    log(f"# phase 9 (scale-out) done in {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches


# ---- phase 10: the native packer, the command line and the host extras ---------
EXAMPLES = ("arbitrage_torch", "liquidation_torch", "two_asset_torch")


def run_cli(argv):
    """``python -m cfmm_routing_tpu_torch`` in this process: (exit code,
    standard output, seconds)."""
    import io

    from cfmm_routing_tpu_torch.__main__ import main as cli_main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    torch.cuda.synchronize()
    return rc, buf.getvalue(), time.perf_counter() - t0


def load_example(name):
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_extras_phase(report, card, cfg_main):
    """Phase 10: this slice's modules on the card at full width.  10a: the
    native packer against the numpy packer at 100k pools, and a fused solve
    on the native compile; 10b: the command line in-process (pins, a 100k
    certified solve from a JSON file, a sweep); 10c: ``time_phases`` and
    ``trace`` on the 100k solvers; 10d: the three example scripts.  Returns
    the launch counts of every main-path run."""
    import io

    from cfmm_routing_tpu_torch import native
    from cfmm_routing_tpu_torch.ops import _build
    from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver
    from cfmm_routing_tpu_torch.solver.compiler import compile_table
    from cfmm_routing_tpu_torch.solver.precondition import equilibrate
    from cfmm_routing_tpu_torch.utils.profiling import time_phases, trace
    from cfmm_routing_tpu_torch.utils.serde import spec_to_json
    from cfmm_routing_tpu_torch.utils.synth import random_arbitrage, random_arbitrage_table

    t_phase = time.perf_counter()
    out, launches = {}, []

    def counted(fn):
        """``fn()`` with the launch counts set to 0 just before and read just
        after (a main-path run); returns (result, counts)."""
        _build.reset_launch_counts()
        res = fn()
        torch.cuda.synchronize()
        launches.append(dict(_build.LAUNCHES))
        return res, launches[-1]

    # ---- 10a. the native packer at 100k pools -------------------------------------
    # the bar of tests/test_native.py: float fields to summation-order roundoff
    PACK_TOL = 1e-12
    table, obj = random_arbitrage_table(256, 100_000, seed=7)
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError(f"10a: the native packer did not build: {native._error}")
    t_build = time.perf_counter() - t0
    secs = {}
    for backend in ("native", "numpy", "native"):  # in turns
        t0 = time.perf_counter()
        comp = compile_table(table, pad_pools_to=1024, backend=backend)
        secs.setdefault(backend, []).append(time.perf_counter() - t0)
        if backend == "native":
            comp_native = comp
        else:
            comp_numpy = comp
    fills = []
    fill = native.fill_bucket
    native.fill_bucket = lambda *a: fills.append(1) or fill(*a)
    try:
        comp_auto = compile_table(table, pad_pools_to=1024)
    finally:
        native.fill_bucket = fill
    if len(fills) != len(comp_native.buckets):
        raise AssertionError(f"10a: backend='auto' filled {len(fills)} buckets natively, "
                             f"not all {len(comp_native.buckets)}")
    diffs = {}
    for comp_b, exact in ((comp_numpy, False), (comp_auto, True)):
        if list(comp_b.buckets) != list(comp_native.buckets) or not (
                np.array_equal(comp_b.degree, comp_native.degree)):
            raise AssertionError("10a: bucket names or degrees differ between packers")
        for name, b in comp_native.buckets.items():
            o = comp_b.buckets[name]
            for field in ("mask", "asset", "pool_ids"):
                if not np.array_equal(getattr(b, field), getattr(o, field)):
                    raise AssertionError(f"10a: {name}.{field} differs between packers")
            for field in ("reserves", "weights", "shift", "gamma", "logk0", "k0"):
                x, y = getattr(b, field), getattr(o, field)
                d = float(np.max(np.abs(x - y))) if x.size else 0.0
                if exact and not np.array_equal(x, y):
                    raise AssertionError(f"10a: 'auto' and 'native' differ in {name}.{field}")
                if not exact:
                    diffs[f"{name}.{field}"] = d
                    if not np.allclose(x, y, rtol=PACK_TOL, atol=PACK_TOL):
                        raise AssertionError(f"10a: {name}.{field} differs by {d:.3e} "
                                             f"(bar {PACK_TOL:g} abs + rel)")
    worst = max(diffs, key=diffs.get)
    log(f"# 10a packer at 100k / 256: native {secs['native'][0]:.3f} / "
        f"{secs['native'][1]:.3f} s, numpy {secs['numpy'][0]:.3f} s (in turns; g++ build "
        f"{t_build:.2f} s); "
        f"'auto' took native ({len(fills)} buckets, bitwise); native vs numpy: integer "
        f"arrays equal, largest float difference {diffs[worst]:.3e} ({worst}; bar "
        f"{PACK_TOL:g}) on {card}")
    opts = AdmmOptions(max_iters=500, eps_abs=0.0, eps_rel=0.0, adapt_rho=False,
                       projection=cfg_main)
    solver_n = AdmmSolver(comp_native, dtype=torch.float32, options=opts)
    res_n, cnt = counted(lambda: solver_n.solve_fused(obj, iters=499))
    n_groups = len(solver_n._groups)
    if cnt["fused_step"] != 499 * n_groups or cnt["project"] != n_groups:
        raise AssertionError(f"10a: solve_fused(499) on the native compile launched {cnt}, "
                             f"expected {499 * n_groups} fused_step and {n_groups} project")
    if not (math.isfinite(float(res_n.objective)) and bool(torch.isfinite(res_n.psi).all())):
        raise AssertionError("10a: solve_fused on the native compile is not finite")
    log(f"# 10a solve_fused(499) on the native compile: objective "
        f"{float(res_n.objective):.6f}, launches {cnt}")
    out["packer"] = dict(native_s=secs["native"], numpy_s=secs["numpy"], build_s=t_build,
                         max_float_diff=diffs[worst], worst=worst, fused_launches=cnt)
    del comp_numpy, comp_auto, solver_n, res_n

    # ---- 10b. the command line, in-process ----------------------------------------
    # removed when the phase ends, or at exit if it fails
    tmpdir = tempfile.TemporaryDirectory(prefix="cfmm_cli_")
    tmp = tmpdir.name
    paths, cli = {}, {}
    for name in ("arbitrage", "liquidation", "two-asset"):
        rc, text, _ = run_cli(["export-reference", name])
        if rc != 0 or json.loads(text)["n_assets"] < 3:
            raise AssertionError(f"10b: export-reference {name} failed ({rc})")
        paths[name] = os.path.join(tmp, f"{name}.json")
        with open(paths[name], "w") as fh:
            fh.write(text)
    # phase 3's float32 route and bar: refined to 1e-7 from bench.py's base
    pins = {"arbitrage": 21.499805, "liquidation": 15.883010, "two-asset": 6.233000}
    for name, pin in pins.items():
        (rc, text, s), cnt = counted(lambda: run_cli(
            ["solve", paths[name], "--certify", "--refine-to", "1e-7", "--max-iters",
             "6000", "--eps", "2e-6", "--json"]))
        res = json.loads(text)
        value = res["psi"][4] if name == "liquidation" else res["objective"]
        rel = abs(value - pin) / pin
        log(f"# 10b solve --certify --refine-to 1e-7 {name}: {value:.9f} vs {pin} (rel "
            f"{rel:.2e}), iters {res['iters']}, gap_rel {res['certificate']['rel_gap']:.3e}, "
            f"{s:.2f} s, launches {cnt}")
        if rc != 0 or not (rel < 2e-6 and res["converged"]):
            raise AssertionError(f"10b: solve {name}: {res['objective']} rel {rel:.2e}, "
                                 f"certificate {res['certificate']}")
        if cnt["project"] == 0 or cnt["segment_sum"] == 0:
            raise AssertionError(f"10b: solve {name} launched {cnt}")
        cli[f"solve {name}"] = dict(value=value, pin=pin, rel=rel, iters=res["iters"],
                                    certificate=res["certificate"], s=s, launches=cnt)
    # the 100k network as a JSON file, objective included
    t0 = time.perf_counter()
    spec100k, obj100k = random_arbitrage(256, 100_000, seed=7)
    doc = json.loads(spec_to_json(spec100k, indent=None))
    doc["objective"] = {"workload": "arbitrage", "market_values": obj100k.c.tolist()}
    paths["100k"] = os.path.join(tmp, "random_arbitrage_100k.json")
    with open(paths["100k"], "w") as fh:
        json.dump(doc, fh)
    t_write = time.perf_counter() - t0
    del spec100k, doc
    (rc, text, s), cnt = counted(lambda: run_cli(
        ["solve", paths["100k"], "--refine-to", "1e-6", "--max-iters", "3000", "--json"]))
    res = json.loads(text)
    cert100k = res["certificate"]
    log(f"# 10b solve --refine-to 1e-6 --max-iters 3000 at 100k / 256 (JSON written in "
        f"{t_write:.1f} s): {s:.2f} s, iters {res['iters']}, objective "
        f"{res['objective']:.6f}, gap_rel {cert100k['rel_gap']:.3e}, feasibility "
        f"{cert100k['feasibility']:.3e}, reached 1e-6: {res['converged']}; launches {cnt} "
        f"on {card}")
    if rc != 0 or not (math.isfinite(res["objective"]) and len(res["psi"]) == obj100k.n_assets
                       and all(math.isfinite(v) for v in cert100k.values())):
        raise AssertionError(f"10b: the 100k solve returned {rc}, {cert100k}")
    missing = [k for k in ("project", "segment_sum", "project_delta") if cnt[k] == 0]
    if missing:
        raise AssertionError(f"10b: the 100k solve never launched {missing}: {cnt}")
    cli["solve 100k"] = dict(s=s, json_write_s=t_write, iters=res["iters"],
                             objective=res["objective"], certificate=cert100k,
                             reached=res["converged"], launches=cnt)
    (rc, text, s), cnt = counted(lambda: run_cli(
        ["sweep", paths["two-asset"], "--give", "0", "--receive", "2", "--points", "51",
         "--t-max", "50", "--max-iters", "8000", "--eps", "2e-6", "--json"]))
    sw = json.loads(text)
    u = np.asarray(sw["utilities"])
    u25 = float(u[25])  # t = 25 on linspace(0, 50, 51)
    log(f"# 10b sweep --points 51 --t-max 50: {s:.2f} s, u(25) {u25:.6f} (rel "
        f"{abs(u25 - 31.005495) / 31.005495:.2e} from the pin, no refinement), "
        f"{int(np.sum(sw['converged']))} of 51 converged; launches {cnt}")
    if rc != 0 or u.shape != (51,) or not np.isfinite(u).all() or np.any(np.diff(u) < -1e-4):
        raise AssertionError(f"10b: sweep returned {rc}, utilities {u}")
    if cnt["project"] == 0 or cnt["segment_sum"] == 0:
        raise AssertionError(f"10b: the sweep launched {cnt}")
    cli["sweep"] = dict(s=s, u25=u25, converged=int(np.sum(sw["converged"])), launches=cnt)
    out["cli"] = cli

    # ---- 10c. observability on the 100k solvers -------------------------------------
    eq = equilibrate(table, obj)
    solver = AdmmSolver(compile_table(eq.table, pad_pools_to=1024), dtype=torch.float32,
                        options=opts)
    phases, cnt = counted(lambda: time_phases(solver, eq.objective, iters=3, inner=20))
    log(f"# 10c time_phases at 100k / 256 (ms an iteration, CUDA events, 3 x 20 calls): "
        + ", ".join(f"{k} {v * 1e3:.4f}" for k, v in phases.items())
        + f"; launches {cnt} on {card}")
    if set(phases) != {"project+bcast", "edge-reduce", "psi-prox", "full-iteration"} or \
            not all(v > 0 for v in phases.values()):
        raise AssertionError(f"10c: time_phases returned {phases}")
    if cnt["project"] == 0 or cnt["segment_sum"] == 0:
        raise AssertionError(f"10c: time_phases launched {cnt}")
    logdir = os.path.join(tmp, "trace")
    solver.solve_fused(eq.objective, iters=25)  # its block captured outside the trace

    def traced():
        with trace(logdir) as prof:
            solver.solve_fused(eq.objective, iters=25)
        return prof

    prof, cnt = counted(traced)
    files = [os.path.join(d, f) for d, _, fs in os.walk(logdir) for f in fs]
    if not files:
        raise AssertionError(f"10c: trace wrote no file into {logdir}")

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(e, attr, None)
            if v is not None:
                return float(v)
        return 0.0

    # the device's own entries (kernels, copies, sets), so that no kernel is
    # counted again in the host operator that launched it
    events = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    total_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:5]
    top = [dict(name=e.key, device_ms=dev_us(e) / 1e3, calls=e.count) for e in top]
    log(f"# 10c trace of solve_fused(25): {len(files)} file(s), "
        f"{sum(os.path.getsize(f) for f in files)} bytes; launches {cnt}; device time "
        f"{total_ms:.3f} ms in all; the five device operations with the most: "
        + "; ".join(f"{t['name'][:60]} {t['device_ms']:.3f} ms x{t['calls']} "
                    f"({t['device_ms'] / max(total_ms, 1e-12):.1%})" for t in top))
    out["observability"] = dict(time_phases_s=phases, trace_files=len(files),
                                trace_device_ms=total_ms, trace_top=top, launches=cnt)
    del solver
    tmpdir.cleanup()

    # ---- 10d. the example scripts, in-process -------------------------------------
    ex = {}
    for name in EXAMPLES:
        mod = load_example(name)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            got, cnt = counted(mod.main)
        s = time.perf_counter() - t0
        printed = buf.getvalue()
        if name == "two_asset_torch":
            rels = {t: abs(got["utilities"][t] - p) / p for t, p in got["pins"].items()
                    if p > 0}
        else:
            rels = {"value": abs(got["objective"] - got["pin"]) / got["pin"]}
        log(f"# 10d examples/{name}.py: {s:.2f} s, rel from the pins "
            + ", ".join(f"{k}: {v:.2e}" for k, v in rels.items())
            + f", certified {got['certified']}; launches {cnt}")
        for line in printed.strip().splitlines()[:3]:
            log(f"#     {line}")
        if not (got["certified"] and max(rels.values()) < 2e-6 and "BASELINE.md" in printed):
            raise AssertionError(f"10d: {name} missed its pins: {rels}")
        if cnt["project"] == 0 or cnt["segment_sum"] == 0:
            raise AssertionError(f"10d: {name} launched {cnt}")
        ex[name] = dict(s=s, rel=rels, launches=cnt)
    out["examples"] = ex
    report["host_extras"] = out
    log(f"# phase 10 (packer, CLI, observability, examples) done in "
        f"{time.perf_counter() - t_phase:.1f} s on {card}")
    return launches


def step_leaves(out):
    """The tensors of a classic step's (h, vals) or a classic_z's z in a
    fixed order."""
    h, vals = out if isinstance(out, tuple) else (out, None)
    return [t for name in sorted(h) for t in h[name]] + ([] if vals is None else [vals])


def classic_kernel_checks(report, rows, solver, solver64, z, nu, objective, cfg_main,
                          cfg64):
    """Phase 2a's classic step kernels (``csrc/classic_step.cu``) on the 100k
    buckets at the mid-solve state (z, nu), float32 at (24, 4) and float64
    at (48, 6): ``classic_step`` on each K-group as a block's first step (z
    given) and as a deferred step (h and dm given), ``consensus`` and
    ``classic_z``, each bitwise equal to its plain version and to a second
    launch; a ``BASE_BLOCK``-step ``_classic_block`` bitwise equal to as many
    stats-free ``_iterate`` calls (the torch ops it replaces, with the
    projection and segment-sum kernels).  Rows of device times (CUDA graphs)
    of each kernel and its plain version with their bounds, and one
    stats-free iteration both ways."""
    from cfmm_routing_tpu_torch.ops.iteration_cuda import (
        classic_step, classic_step_plain, classic_z, classic_z_plain, consensus,
        consensus_plain,
    )
    from cfmm_routing_tpu_torch.ops.segment import segment_sum

    iteration_ms = {}
    for dtype, slv, cfg in ((torch.float32, solver, cfg_main),
                            (torch.float64, solver64, cfg64)):
        dname = str(dtype).split(".")[1]
        es = 4 if dtype == torch.float32 else 8
        if not slv._step_kernels(None):
            raise AssertionError(f"2a classic step [{dname}]: the kernel path is not taken")
        c, lo, hi = slv._objective_arrays(objective)
        rho = slv._t(1.0)
        zz = {nm: tuple(x.to(dtype) for x in z[nm]) for nm in z}
        nn = nu.to(dtype)
        alpha, beta = slv._relax_coeffs
        bk, n = slv.buckets, slv.n

        def checked(label, kfn, pfn, leaves=step_leaves):
            got, again, want = kfn(), kfn(), pfn()
            torch.cuda.synchronize()
            bitwise(f"{label} [{dname}]", leaves(got), leaves(want))
            bitwise(f"{label} [{dname}] second launch", leaves(again), leaves(got))
            return want

        # a block's first step (z given) per K-group, the consensus, then a
        # deferred step (h, dm) per K-group and the block's closing z
        h, ys = {}, []
        for g in slv._groups:
            hg, vals = checked(
                f"classic_step[K={g['K']}] first step",
                lambda: classic_step(zz, nn, None, bk, g, alpha, beta, cfg),
                lambda: classic_step_plain(zz, nn, None, bk, g, alpha, beta, cfg))
            h.update(hg)
            ys.append(segment_sum(vals, g["order"], g["seg"], n))
        cons = (lambda: consensus(ys, slv.degree, nn, c, lo, hi, rho),
                lambda: consensus_plain(ys, slv.degree, nn, c, lo, hi, rho))
        nu2, dm = checked("consensus", *cons, leaves=list)
        row = dict(group=len(ys), dtype=dname, n=n, max_abs_err=0.0,
                   ms=graph_ms(cons[0]), plain_ms=graph_ms(cons[1]))
        # the groups' sums, d nu c lo hi in; mu dm out; ~12 operations an asset
        row["bound_ms"], row["bound_by"] = bound_ms(es * (len(ys) + 7) * n, 12 * n, dtype)
        rows["consensus"].append(row)
        log(f"# consensus {dname} n={n} ({len(ys)} group sums): bitwise equal to plain and "
            f"across launches; kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        for g in slv._groups:
            K = g["K"]
            ms = [int(bk[nm]["mask"].shape[1]) for nm in g["names"]]
            step = (lambda: classic_step(h, nu2, dm, bk, g, alpha, beta, cfg),
                    lambda: classic_step_plain(h, nu2, dm, bk, g, alpha, beta, cfg))
            checked(f"classic_step[K={K}] deferred step", *step)
            row = dict(group=K, buckets=g["names"], dtype=dname, K=K, m=sum(ms),
                       cfg=list(cfg), max_abs_err=0.0, ms=graph_ms(step[0]),
                       plain_ms=graph_ms(step[1], n=2, reps=3))
            # a slot reads aD aL R w (s) mask and its int32 asset id and
            # writes hD hL val; a pool reads gamma (logk0) k0; nu and dm once
            # a launch; the projection's operations
            n_b = sum((9 if kind == "gm" else 8) * K * m * es + 4 * K * m
                      + (3 if kind == "gm" else 2) * m * es
                      for (kind, _), m in zip(g["kinds"], ms)) + 2 * n * es
            row["bound_ms"], row["bound_by"] = bound_ms(
                n_b, sum(projection_flops(cfg, K, m) for m in ms), dtype)
            rows["classic_step"].append(row)
            log(f"# classic_step K={K} {g['names']} {dname} m={sum(ms)}: a first and a "
                f"deferred step bitwise equal to plain and across launches; kernel "
                f"{row['ms']:.4f} ms  plain {row['plain_ms']:.2f} ms  bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
            zfn = (lambda: classic_z(h, dm, bk, g), lambda: classic_z_plain(h, dm, bk, g))
            checked(f"classic_z[K={K}]", *zfn)
            row = dict(group=K, buckets=g["names"], dtype=dname, K=K, m=sum(ms),
                       max_abs_err=0.0, ms=graph_ms(zfn[0]), plain_ms=graph_ms(zfn[1]))
            # hD hL mask and the asset id in, zD zL out, dm once; 3 operations
            row["bound_ms"], row["bound_by"] = bound_ms(
                sum((5 * es + 4) * K * m for m in ms) + n * es, 3 * K * sum(ms), dtype)
            rows["classic_z"].append(row)
            log(f"# classic_z K={K} {dname}: bitwise equal to plain and across launches; "
                f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        # a whole block against the torch ops it replaces
        k = (rho, c, lo, hi)
        got = slv._classic_block((zz, nn), k, BASE_BLOCK, bk)
        want = (zz, nn)
        for _ in range(BASE_BLOCK):
            zw, nw, _, _, _ = slv._iterate(*want, rho, c, lo, hi, with_stats=False)
            want = ({nm: zw[nm] for nm in zz}, nw)
        torch.cuda.synchronize()
        bitwise(f"_classic_block({BASE_BLOCK}) [{dname}] vs {BASE_BLOCK} _iterate calls",
                step_leaves(got[0]) + [got[1]], step_leaves(want[0]) + [want[1]])
        iteration_ms[dname] = dict(
            step_kernels=graph_ms(lambda: slv._classic_block((zz, nn), k, BASE_BLOCK, bk),
                                  n=2, reps=5) / BASE_BLOCK,
            torch_ops=graph_ms(lambda: slv._iterate(zz, nn, rho, c, lo, hi,
                                                    with_stats=False), n=5, reps=5))
        log(f"# 2a a stats-free classic iteration {dname}: {BASE_BLOCK} replayed kernel steps "
            f"bitwise equal to as many _iterate calls; "
            f"{iteration_ms[dname]['step_kernels']:.4f} ms an iteration on the kernels vs "
            f"{iteration_ms[dname]['torch_ops']:.4f} ms on the torch ops (CUDA graphs)")
    report["classic_iteration_ms"] = iteration_ms


def build_report(build_dir):
    """Registers and spills of every kernel in the ``-Xptxas=-v`` logs kept
    beside the built libraries ({library: {kernel: [registers, spill
    stores, spill loads]}}), and the root-find loops of the float32 kernels
    instantiated for 2 (slots or lanes a pool: the 100k network's K = 2) in
    the fused-step and projection libraries, from ``cuobjdump -sass``: each
    backward branch's loop, its instructions and its MUFU and shuffle
    operations."""
    import glob
    import os
    import re

    regs = {}
    for log_path in sorted(glob.glob(os.path.join(build_dir, "lib*_*.log"))):
        lib = re.sub(r"^lib|_[0-9a-f]{16}\.log$", "", os.path.basename(log_path))
        kernels, name = {}, None
        for line in open(log_path):
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                name = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and name:
                kernels.setdefault(name, [0, 0, 0])[1:] = [int(m.group(1)), int(m.group(2))]
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                kernels.setdefault(name, [0, 0, 0])[0] = int(m.group(1))
        regs[lib] = kernels
    loops = []
    for lib in ("fused_step", "projection"):
        libs = sorted(p for p in glob.glob(os.path.join(build_dir, f"lib{lib}_*.so"))
                      if re.search(rf"lib{lib}_[0-9a-f]{{16}}\.so$", p))
        if not libs:
            raise RuntimeError(f"no built {lib} library in {build_dir}")
        text = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", libs[-1]],
                              capture_output=True, text=True, check=True).stdout
        for fn in re.split(r"Function\s*:\s*", text)[1:]:
            name = fn.split("\n", 1)[0].strip()
            if not re.search(r"kernelIfLi2E", name):
                continue
            ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn)
            addr = [int(a, 16) for a, _ in ins]
            for i, (_, op) in enumerate(ins):
                m = re.search(r"\bBRA\b[^;]*?0x([0-9a-f]+)", op)
                if not m or int(m.group(1), 16) >= addr[i]:
                    continue
                body = [o for a, (_, o) in zip(addr, ins)
                        if int(m.group(1), 16) <= a <= addr[i]]
                loops.append(dict(library=lib, kernel=name, instructions=len(body),
                                  mufu=sum("MUFU" in o for o in body),
                                  shfl=sum("SHFL" in o for o in body)))
    return regs, loops


def package_times(root):
    """``--times ROOT``: device times of the port's package found under ROOT
    (a checkout's root), through calls that every version of the package
    has, so two versions can be held side by side (``--turns``).  Float32,
    ProjectionConfig(24, 4), CUDA events around CUDA-graph replays of
    back-to-back calls, from a state of 20 fused iterations:

    * the 100k network of phase 4: ``segment_sum`` on each bucket,
      ``fused_step`` on each bucket, ``project_gm_cuda`` /
      ``project_cs_cuda`` on each bucket at the classic iteration's input,
      one whole fused iteration (``AdmmSolver._iterate_fused``) and one
      stats-free classic iteration (``AdmmSolver._iterate``, and where the
      package has it ``AdmmSolver._classic_block``, the body of the classic
      replayed block), ``fused_step_merged`` on each merged
      K-group and one whole merged fused iteration
      (``AdmmSolver._iterate_fused_merged``); where the package has it,
      ``project_grouped`` on each K-group;
    * ``fused_step(fold=)`` on each bucket and one whole folded iteration at
      100k pools x 8 reserve scenarios (6b), 10k pools x 50 points (6c) and
      1,000 pools x 1,024 points (6a);
    * the build's seconds (0.0 for a library found built), registers and
      spills and SASS loops (:func:`build_report`);
    * the host-side times of phases 4, 6b and 7c's paths
      (:func:`path_times`).
    """
    import os

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import cfmm_routing_tpu_torch as pkg

    where = os.path.dirname(os.path.abspath(pkg.__file__))
    if not where.startswith(root + os.sep):
        raise RuntimeError(f"--times {root}: imported the package from {where}")
    from cfmm_routing_tpu_torch.ops import _build, projection_cuda
    from cfmm_routing_tpu_torch.ops.iteration_cuda import fused_step, fused_step_merged
    from cfmm_routing_tpu_torch.ops.projection import ProjectionConfig
    from cfmm_routing_tpu_torch.ops.segment import segment_sum
    from cfmm_routing_tpu_torch.solver.admm import (
        AdmmOptions, AdmmSolver, _reserve_buckets,
    )
    from cfmm_routing_tpu_torch.solver.compiler import compile_table
    from cfmm_routing_tpu_torch.solver.fold import fold_compiled
    from cfmm_routing_tpu_torch.solver.precondition import equilibrate
    from cfmm_routing_tpu_torch.utils.synth import random_arbitrage_table

    t0 = time.perf_counter()
    build_s = _build.build()
    cfg = ProjectionConfig(24, 4)
    opts = AdmmOptions(projection=cfg)
    out = dict(package=where, build_s=build_s, build_wall_s=time.perf_counter() - t0)
    log(f"# {where}: kernels built in {out['build_wall_s']:.1f} s (per library: {build_s})")

    def case(label, solver, buckets, objective, T=1):
        c, lo, hi = (solver._t(np.tile(x, T)) for x in (
            objective.c, np.maximum(objective.lo, -F32_BIG),
            np.minimum(objective.hi, F32_BIG)))
        rho = solver._t(1.0)
        s, wdef, nu = solver.fused_init(buckets)
        for _ in range(20):
            s, wdef, nu, _, _ = solver._iterate_fused(s, wdef, nu, rho, c, lo, hi,
                                                      buckets=buckets)
        v, _ = solver._fold_pack(wdef - nu)
        row = dict(fused_step_ms={}, segment_sum_ms={})
        for name, arrs in buckets.items():
            kind, floor = solver._meta[name]
            sD, sL = s[name]
            row["fused_step_ms"][name] = graph_ms(lambda: fused_step(
                sD, sL, v, arrs, kind, floor, 1.0, cfg=cfg, fold=solver._fold))
            if T == 1:
                val = ((sL - sD) * arrs["mask"]).contiguous()
                row["segment_sum_ms"][name] = graph_ms(
                    lambda: segment_sum(val, arrs["order"], arrs["seg"], v.shape[0]))
        row["fused_iteration_ms"] = graph_ms(lambda: solver._iterate_fused(
            s, wdef, nu, rho, c, lo, hi, buckets=buckets), n=5, reps=3)
        if T == 1:
            groups = solver._merged_groups()
            sm = solver._merge_state(s, groups)
            row["fused_step_merged_ms"] = {
                str(g["names"]): graph_ms(lambda: fused_step_merged(
                    sD, sL, v, g["arrs"], 1.0, cfg=cfg)) for g, (sD, sL) in zip(groups, sm)}
            row["fused_iteration_merged_ms"] = graph_ms(lambda: solver._iterate_fused_merged(
                sm, wdef, nu, rho, c, lo, hi, groups), n=5, reps=3)
            log(f"# {label}: fused_step_merged per K-group "
                f"{sum(row['fused_step_merged_ms'].values()):.4f} ms "
                f"{row['fused_step_merged_ms']}, a whole merged fused iteration "
                f"{row['fused_iteration_merged_ms']:.4f} ms")
            z = solver.fused_to_z(s, wdef, buckets)
            row["classic_iteration_ms"] = graph_ms(lambda: solver._iterate(
                z, nu, rho, c, lo, hi, with_stats=False, buckets=buckets), n=5, reps=3)
            if hasattr(solver, "_classic_block"):  # the replayed block's form
                row["classic_block_iteration_ms"] = graph_ms(lambda: solver._classic_block(
                    (z, nu), (rho, c, lo, hi), BASE_BLOCK, buckets), n=2, reps=3) / BASE_BLOCK
            pin = {}
            row["project_ms"] = {}
            for name, arrs in buckets.items():
                kind, floor = solver._meta[name]
                nu_e = solver._bcast_nu(nu, name, buckets)
                pin[name] = p, q = z[name][0] - nu_e, z[name][1] + nu_e
                if kind == "gm":
                    pfn = lambda: projection_cuda.project_gm_cuda(  # noqa: E731
                        p, q, arrs["R"], arrs["w"], arrs["s"], arrs["gamma"],
                        arrs["logk0"], arrs["k0"], arrs["mask"], needs_floor=floor,
                        cfg=cfg)
                else:
                    pfn = lambda: projection_cuda.project_cs_cuda(  # noqa: E731
                        p, q, arrs["R"], arrs["gamma"], arrs["w"], arrs["k0"],
                        arrs["mask"], cfg=cfg)
                row["project_ms"][name] = graph_ms(pfn)
            if hasattr(projection_cuda, "project_grouped"):
                row["project_grouped_ms"] = {
                    str(g["names"]): graph_ms(lambda: projection_cuda.project_grouped(
                        pin, buckets, g, cfg=cfg)) for g in solver._groups}
            log(f"# {label}: projection per bucket {sum(row['project_ms'].values()):.4f} "
                f"ms {row['project_ms']}; grouped {row.get('project_grouped_ms')}")
        log(f"# {label}: fused_step per bucket {sum(row['fused_step_ms'].values()):.4f} ms, "
            f"a whole fused iteration {row['fused_iteration_ms']:.4f} ms"
            + (f", segment_sum per bucket {sum(row['segment_sum_ms'].values()):.4f} ms, a "
               f"stats-free classic iteration {row['classic_iteration_ms']:.4f} ms (torch "
               f"ops), {row.get('classic_block_iteration_ms')} ms (step kernels)"
               if T == 1 else ""))
        return row

    table, obj = random_arbitrage_table(256, 100_000, seed=7)
    eq = equilibrate(table, obj)
    compiled = compile_table(eq.table, pad_pools_to=1024)
    solver = AdmmSolver(compiled, dtype=torch.float32, options=opts)
    out["100k"] = case("100k", solver, solver.buckets, eq.objective)
    B = 8
    scale = np.random.default_rng(3).uniform(0.7, 1.3, size=(B, compiled.n_pools))
    del solver
    out["paths"] = path_times(table, obj, compiled, eq.objective, scale, cfg)
    fs = AdmmSolver(fold_compiled(compiled, B), dtype=torch.float32, options=opts,
                    fold=(B, compiled.n_assets))
    bd = _reserve_buckets(fs, fold_compiled(compiled, B, scale))
    out["100k_x_8"] = case("100k x 8", fs, bd, eq.objective, B)
    del fs, bd
    for label, (n_assets, pools, pad, T) in (("10k_x_50", (64, 10_000, 1024, 50)),
                                              ("1k_x_1024", (64, 1000, 128, 1024))):
        tb, ob = random_arbitrage_table(n_assets, pools, seed=7)
        eqb = equilibrate(tb, ob)
        cb = compile_table(eqb.table, pad_pools_to=pad)
        fsb = AdmmSolver(fold_compiled(cb, T), dtype=torch.float32, options=opts,
                         fold=(T, cb.n_assets))
        out[label] = case(label, fsb, fsb.buckets, eqb.objective, T)
        del fsb
        torch.cuda.empty_cache()
    out["registers"], out["sass_loops"] = build_report(str(_build.BUILD_DIR))
    return out


def path_times(table, obj, compiled, objective, scale, cfg, reps=5):
    """Host-side path times for ``--times``, replayed, with phases 4, 6b
    and 7c's options, each the least of ``reps`` runs after a warm-up:
    phase 4's ``solve_fused(iters=499)`` (CUDA events around the call, as
    phase 4 times it); phase 6b's ``solve_batch_reserves_folded(n_iters=749)``
    over the reserve ``scale`` (host clock, reserve planes included, as 6b
    times it); phase 7c's classic utility base (3,000 iterations, check
    every 25) on a new solver, its check block's capture included, as 7c
    times it, and again on the same solver (host clock)."""
    from cfmm_routing_tpu_torch.models.utility import ConcaveUtility
    from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver
    from cfmm_routing_tpu_torch.solver.compiler import compile_table
    from cfmm_routing_tpu_torch.solver.fold import solve_batch_reserves_folded
    from cfmm_routing_tpu_torch.solver.precondition import equilibrate

    solver = AdmmSolver(compiled, dtype=torch.float32, options=AdmmOptions(
        max_iters=500, eps_abs=0.0, eps_rel=0.0, adapt_rho=False, projection=cfg))
    fused = []
    for _ in range(reps + 1):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        solver.solve_fused(objective, iters=499)
        stop.record()
        stop.synchronize()
        fused.append(start.elapsed_time(stop) / 1e3)
    del solver
    opts6 = AdmmOptions(max_iters=750, eps_abs=0.0, eps_rel=0.0, adapt_rho=False,
                        projection=cfg)
    folded = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        solve_batch_reserves_folded(compiled, objective, scale, options=opts6, n_iters=749)
        folded.append(time.perf_counter() - t0)
    util = ConcaveUtility.linear(obj.c, lo=obj.lo, hi=obj.hi)
    util = util.with_log(1, c=1.0, b=2.0).with_log(3, c=0.5, b=1.0)
    eq_u = equilibrate(table, util)
    compiled_u = compile_table(eq_u.table, pad_pools_to=1024)
    base_opts = AdmmOptions(max_iters=3000, eps_abs=1e-7, eps_rel=1e-7, check_every=25,
                            projection=cfg)
    fresh, again = [], []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        base_solver = AdmmSolver(compiled_u, dtype=torch.float32, options=base_opts)
        base_solver.solve(eq_u.objective)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        base_solver.solve(eq_u.objective)
        torch.cuda.synchronize()
        fresh.append(t1 - t0)
        again.append(time.perf_counter() - t1)
    out = dict(fused_s=fused[1:], fused_iters_per_s=500 / min(fused[1:]),
               reserve_s=folded[1:], reserve_iters_per_s=750 / min(folded[1:]),
               utility_base_s=fresh[1:], utility_base_again_s=again[1:])
    log(f"# paths (replayed): phase 4's fused solve {out['fused_iters_per_s']:.1f} it/s "
        f"{[round(x, 5) for x in fused[1:]]} s; phase 6b's folded reserve batch "
        f"{out['reserve_iters_per_s']:.1f} it/s {[round(x, 4) for x in folded[1:]]} s; "
        f"phase 7c's utility base {[round(x, 4) for x in fresh[1:]]} s on a new solver, "
        f"{[round(x, 4) for x in again[1:]]} s again")
    return out


def turns(dirs, out_path):
    """``--turns DIR [DIR ...]``: :func:`package_times` of each DIR and of
    this checkout, each in its own process, in turns on one card: the DIRs,
    this checkout twice, the DIRs in reverse.  Prints the card and one
    JSON object of every run."""
    import os
    import tempfile

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    here = os.path.dirname(os.path.abspath(__file__))
    order = list(dirs) + [here, here] + list(reversed(dirs))
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, root in enumerate(order):
            path = os.path.join(tmp, f"{i}.json")
            log(f"# turn {i}: {root}")
            subprocess.run([sys.executable, os.path.abspath(__file__), "--times", root,
                            "--out", path], check=True, cwd=here)
            with open(path) as fh:
                runs.append(dict(root=root, **json.load(fh)))
    report = dict(card=smi, order=order, runs=runs)
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(report, fh, indent=1)
    print(json.dumps(report), flush=True)
    print(smi, flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every measurement to this JSON file")
    ap.add_argument("--turns", nargs="+", metavar="DIR",
                    help="instead: time the kernels of the package under each DIR "
                         "against this checkout's, in turns (package_times)")
    ap.add_argument("--times", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turns:
        return turns(args.turns, args.out)
    if args.times:
        report = package_times(args.times)
        with open(args.out, "w") as fh:
            json.dump(report, fh)
        return 0

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
        classic_step_plain, classic_z_plain, consensus_plain, fused_step,
        fused_step_delta, fused_step_delta_grouped, fused_step_delta_grouped_plain,
        fused_step_grouped, fused_step_grouped_plain, fused_step_plain,
    )
    from cfmm_routing_tpu_torch.ops.projection_cuda import (
        project_cs_cuda, project_cs_delta_cuda, project_delta_grouped,
        project_delta_grouped_plain, project_gm_cuda, project_gm_delta_cuda,
        project_grouped, project_grouped_plain,
    )
    from cfmm_routing_tpu_torch.ops.projection_delta import (
        project_cs_delta, project_gm_delta,
    )
    from cfmm_routing_tpu_torch.ops.segment import segment_sum, segment_sum_plain
    from cfmm_routing_tpu_torch.solver import admm as admm_mod
    from cfmm_routing_tpu_torch.solver import graphs
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
        swaps = [(admm_mod, "fused_step_grouped", fused_step_grouped_plain),
                 (admm_mod, "project_grouped", project_grouped_plain),
                 (admm_mod, "segment_sum", segment_sum_plain),
                 (admm_mod, "classic_step", classic_step_plain),
                 (admm_mod, "classic_z", classic_z_plain),
                 (admm_mod, "consensus", consensus_plain),
                 (rd_mod, "fused_step_delta_grouped", fused_step_delta_grouped_plain),
                 (rd_mod, "project_delta_grouped", project_delta_grouped_plain)]
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        try:
            with graphs.eager():  # the plain versions read sizes back: no capture
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
    one_bucket_ms, seg_bucket_ms, cterm = {}, {}, {}
    pin, per_bucket = {}, []  # the classic projection's input; its rows per bucket
    for name, arrs in solver.buckets.items():
        kind, floor = solver._meta[name]
        K, m = arrs["mask"].shape
        nu_e = solver._bcast_nu(nu, name)
        pin[name] = p, q = z[name][0] - nu_e, z[name][1] + nu_e
        kname = "project_gm" if kind == "gm" else "project_cs"
        for dtype, slv, cfg in ((torch.float32, solver, cfg_main),
                                (torch.float64, solver64, cfg64)):
            a = slv.buckets[name]
            pp, qq = p.to(dtype), q.to(dtype)
            # the per-bucket wrappers: the grouped kernel on a group of one
            if kind == "gm":
                largs = (pp, qq, a["R"], a["w"], a["s"], a["gamma"], a["logk0"],
                         a["k0"], a["mask"])
                kfn = lambda: project_gm_cuda(*largs, needs_floor=floor, cfg=cfg)  # noqa: E731
                pfn = lambda: plain.project_gm(*largs, needs_floor=floor, cfg=cfg)  # noqa: E731
            else:
                largs = (pp, qq, a["R"], a["gamma"], a["w"], a["k0"], a["mask"])
                kfn = lambda: project_cs_cuda(*largs, cfg=cfg)  # noqa: E731
                pfn = lambda: plain.project_cs(*largs, cfg=cfg)  # noqa: E731
            got, again, want = kfn(), kfn(), pfn()
            torch.cuda.synchronize()
            bitwise(f"{kname}[{name}, {dtype}] (a group of one)", got, want)
            bitwise(f"{kname}[{name}, {dtype}] second launch", again, got)
            row = dict(kernel=kname, bucket=name, dtype=str(dtype).split(".")[1], K=K,
                       m=m, cfg=list(cfg), max_abs_err=0.0,
                       ms=graph_ms(kfn), plain_ms=graph_ms(pfn, n=2, reps=3))
            es = 4 if dtype == torch.float32 else 8
            row["bound_ms"], row["bound_by"] = bound_ms(
                gm_or_cs_bytes(kind, K, m, es), projection_flops(cfg, K, m), dtype)
            per_bucket.append(row)
            log(f"# {kname:10s} {name:5s} {row['dtype']} K={K} m={m} (a group of one): "
                f"bitwise equal to plain; kernel {row['ms']:.4f} ms  plain "
                f"{row['plain_ms']:.2f} ms  bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        sD, sL = s[name]
        # the per-bucket wrapper: the grouped kernel on a group of one
        ffn = lambda: fused_step(sD, sL, v, arrs, kind, floor, 1.0, cfg=cfg_main)  # noqa: E731
        fpl = lambda: fused_step_plain(sD, sL, v, arrs, kind, floor, 1.0, cfg=cfg_main)  # noqa: E731
        got, want = ffn(), fpl()
        torch.cuda.synchronize()
        bitwise(f"fused_step[{name}] (a group of one)", got, want)
        one_bucket_ms[name] = graph_ms(ffn)
        log(f"# fused_step {name:5s} as a group of one: bitwise equal to plain; "
            f"{one_bucket_ms[name]:.4f} ms with its segment sum")
        # the segment sum on this bucket's consensus terms (alpha = 1)
        cterm[name] = val = (want[3] - want[2]).contiguous()
        sfn = lambda: segment_sum(val, arrs["order"], arrs["seg"], n_pad)  # noqa: E731
        got_y, want_y = sfn(), segment_sum_plain(val, arrs["order"], arrs["seg"], n_pad)
        torch.cuda.synchronize()
        if not torch.equal(got_y, want_y):
            raise AssertionError(f"segment_sum[{name}] is not bitwise equal to "
                                 f"its plain version ({max_err([got_y], [want_y]):.3e})")
        seg_bucket_ms[name] = graph_ms(sfn)
    log(f"# segment_sum per bucket: bitwise equal to plain; kernel ms "
        f"{ {k: round(t, 5) for k, t in seg_bucket_ms.items()} } "
        f"({sum(seg_bucket_ms.values()):.4f} ms for the five)")
    report["segment_sum_per_bucket_ms"] = seg_bucket_ms
    # the segment sum of one iteration: one per K-group, over the group's
    # consensus-term planes one after another (classic and fused paths)
    for g in solver._groups:
        val = torch.cat([cterm[nm].reshape(-1) for nm in g["names"]])
        order, seg = g["order"], g["seg"]
        sfn = lambda: segment_sum(val, order, seg, n_pad)  # noqa: E731
        spl = lambda: segment_sum_plain(val, order, seg, n_pad)  # noqa: E731
        got_y, want_y = sfn(), spl()
        torch.cuda.synchronize()
        if not torch.equal(got_y, want_y):
            raise AssertionError(f"segment_sum[K={g['K']}] is not bitwise equal to "
                                 f"its plain version ({max_err([got_y], [want_y]):.3e})")
        # the library call for the same sum: index_add_ over every slot's
        # asset id (padding slots add their zero), in no fixed order
        ids = torch.cat([solver.buckets[nm]["asset"].reshape(-1) for nm in g["names"]]).long()
        y0 = torch.zeros_like(v)
        lfn = lambda: torch.index_add(y0, 0, ids, val)  # noqa: E731
        check_close(f"index_add_[K={g['K']}]", [lfn()], [want_y],
                    1e-4 * float(want_y.abs().max()), rtol=1e-4)
        n_real = int(order.numel())
        row = dict(group=g["K"], buckets=g["names"], dtype="float32", n_real=n_real,
                   max_abs_err=0.0, ms=graph_ms(sfn), plain_ms=eager_ms(spl),
                   library_ms=graph_ms(lfn))
        row["bound_ms"], row["bound_by"] = bound_ms(
            segment_bytes(n_real, solver.n, n_pad, 4), n_real, torch.float32)
        rows["segment_sum"].append(row)
        log(f"# segment_sum K={g['K']} {g['names']} ({n_real} real slots): bitwise equal; "
            f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.2f} ms  index_add_ "
            f"{row['library_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    del cterm
    # the grouped projection (the classic iteration's): one launch per K-group
    for g, g64 in zip(solver._groups, solver64._groups):
        K = g["K"]
        ms = [int(solver.buckets[nm]["mask"].shape[1]) for nm in g["names"]]
        for dtype, slv, grp, cfg in ((torch.float32, solver, g, cfg_main),
                                     (torch.float64, solver64, g64, cfg64)):
            dname = str(dtype).split(".")[1]
            inp = {nm: tuple(x.to(dtype) for x in pin[nm]) for nm in g["names"]}
            kfn = lambda: project_grouped(inp, slv.buckets, grp, cfg=cfg)  # noqa: E731
            pfn = lambda: project_grouped_plain(inp, slv.buckets, grp, cfg=cfg)  # noqa: E731
            got, again, want = kfn(), kfn(), pfn()
            torch.cuda.synchronize()
            bitwise(f"project grouped[K={K}, {dname}]", grouped_leaves(got),
                    grouped_leaves(want))
            bitwise(f"project grouped[K={K}, {dname}] second launch", grouped_leaves(again),
                    grouped_leaves(got))
            es = 4 if dtype == torch.float32 else 8
            row = dict(group=K, buckets=g["names"], dtype=dname, K=K, m=sum(ms),
                       cfg=list(cfg), max_abs_err=0.0, ms=graph_ms(kfn),
                       plain_ms=graph_ms(pfn, n=2, reps=3))
            row["bound_ms"], row["bound_by"] = group_bound([
                bound_ms(gm_or_cs_bytes(kind, K, m, es), projection_flops(cfg, K, m), dtype)
                for (kind, _), m in zip(g["kinds"], ms)])
            rows["project"].append(row)
            log(f"# project K={K} {g['names']} {dname} m={sum(ms)}: bitwise equal to plain "
                f"and across launches; kernel {row['ms']:.4f} ms  plain "
                f"{row['plain_ms']:.2f} ms  bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    del pin
    proj = {d: (sum(r["ms"] for r in rows["project"] if r["dtype"] == d),
                sum(r["ms"] for r in per_bucket if r["dtype"] == d))
            for d in ("float32", "float64")}
    regs, loops = build_report(str(_build.BUILD_DIR))
    proj_regs = regs.get("projection", {})
    log(f"# 2a projection per classic iteration: {len(solver._groups)} grouped launches "
        f"{proj['float32'][0]:.4f} ms vs {len(per_bucket) // 2} groups of one "
        f"{proj['float32'][1]:.4f} ms (float32, (24, 4)); float64 (48, 6) "
        f"{proj['float64'][0]:.4f} vs {proj['float64'][1]:.4f} ms")
    log(f"# 2a projection library: registers, spill stores, spill loads {proj_regs}; "
        f"root-find loops at 2 lanes "
        f"{[lp for lp in loops if lp['library'] == 'projection']}")
    report["projection_grouping"] = dict(
        grouped_ms={d: t[0] for d, t in proj.items()},
        per_bucket_ms={d: t[1] for d, t in proj.items()}, per_bucket=per_bucket,
        registers=proj_regs, sass_loops=[lp for lp in loops if lp["library"] == "projection"])
    # the classic step kernels of the base's replayed blocks, at (z, nu)
    classic_kernel_checks(report, rows, solver, solver64, z, nu, eq.objective, cfg_main,
                          cfg64)
    # the grouped fused step: one launch + one segment sum per K-group
    for g, g64 in zip(solver._groups, solver64._groups):
        K = g["K"]
        ms = [int(solver.buckets[nm]["mask"].shape[1]) for nm in g["names"]]
        kfn = lambda: fused_step_grouped(s, v, solver.buckets, g, 1.0, cfg=cfg_main)  # noqa: E731
        pfn = lambda: fused_step_grouped_plain(s, v, solver.buckets, g, 1.0, cfg=cfg_main)  # noqa: E731
        got, again, want = kfn(), kfn(), pfn()
        torch.cuda.synchronize()
        bitwise(f"fused_step grouped[K={K}, float32]", grouped_leaves(got), grouped_leaves(want))
        bitwise(f"fused_step grouped[K={K}] second launch", grouped_leaves(again),
                grouped_leaves(got))
        s64 = {nm: tuple(x.double() for x in s[nm]) for nm in g["names"]}
        got = fused_step_grouped(s64, v.double(), solver64.buckets, g64, 1.0, cfg=cfg64)
        want = fused_step_grouped_plain(s64, v.double(), solver64.buckets, g64, 1.0, cfg=cfg64)
        torch.cuda.synchronize()
        bitwise(f"fused_step grouped[K={K}, float64]", grouped_leaves(got), grouped_leaves(want))
        row = dict(group=K, buckets=g["names"], dtype="float32", K=K, m=sum(ms),
                   cfg=list(cfg_main), max_abs_err=0.0, ms=graph_ms(kfn), plain_ms=eager_ms(pfn))
        # per bucket: sD sL R w s mask + asset ids + gamma logk0 k0 + v in;
        # sD' sL' D L + the consensus-term plane out
        row["bound_ms"], row["bound_by"] = group_bound([
            bound_ms(4 * (11 * K * m + 3 * m + n_pad) + 4 * K * m,
                     projection_flops(cfg_main, K, m), torch.float32) for m in ms])
        rows["fused_step"].append(row)
        log(f"# fused_step K={K} {g['names']} m={sum(ms)}: bitwise equal to plain in float32 "
            f"(24, 4) and float64 (48, 6), and across launches; kernel {row['ms']:.4f} ms (1 "
            f"launch + 1 segment sum)  plain {row['plain_ms']:.2f} ms  bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        del got, again, want, s64
    grouped_ms = sum(r["ms"] for r in rows["fused_step"])
    log(f"# 2a fused_step per iteration: {len(solver._groups)} grouped launches + segment sums "
        f"{grouped_ms:.4f} ms vs {len(one_bucket_ms)} groups of one "
        f"{sum(one_bucket_ms.values()):.4f} ms")
    report["fused_grouping"] = dict(grouped_ms=grouped_ms, per_bucket_ms=one_bucket_ms)
    del solver64
    log(f"# phase 2a (base kernels vs plain) done in {time.perf_counter() - t_phase:.1f} s")

    # ---- 2b. the grouped delta kernels vs plain on real delta arrays --------
    t_phase = time.perf_counter()
    base = to_host(solver.solve_fused(eq.objective, iters=20))
    base = base._replace(psi=_psi_from_trades(compiled, base))
    rho_d = float(np.clip(np.asarray(base.rho_final), 0.25, 4.0))
    nu0f = (np.asarray(base.prices, np.float64) / rho_d).astype(np.float32).astype(np.float64)
    eps = 1e-3
    dobj = _delta_objective(eq.objective, base.psi, eps)
    delta_opts = AdmmOptions(adapt_rho=False, projection=cfg64)
    for dtype in (torch.float32, torch.float64):
        ds = DeltaAdmmSolver(compiled, dtype=dtype, options=delta_opts)
        bdict, min_x0 = ds.delta_buckets(base, eps, nu0=nu0f)
        if not min_x0 > 0:
            raise AssertionError(f"100k base point has min x0 = {min_x0}")
        dc, dlo, dhi, _, start = _prep_delta_solve(dobj, nu0f, rho_d, ds)
        rho_t = ds._t(rho_d)
        st, wd, dnu = ds.fused_init(bdict)
        dnu = ds._t(start)
        with plain_versions():
            for _ in range(5):
                st, wd, dnu, _, _ = ds._iterate_fused(st, wd, dnu, rho_t, dc, dlo, dhi,
                                                      buckets=bdict)
        dv, _ = ds._fold_pack(wd - dnu)
        groups = ds._groups
        if [g["names"] for g in groups] != [["cs2f", "gm2", "gm2f"], ["cs4f", "gm4"]]:
            raise AssertionError(f"unexpected delta groups {[g['names'] for g in groups]}")
        dname = str(dtype).split(".")[1]
        es = 4 if dtype == torch.float32 else 8
        pin = {}  # the standalone projection's input at this step
        for name, arrs in bdict.items():
            off = ds._bcast_nu(wd - dnu, name, bdict) - arrs["nu0e"]
            pin[name] = (st[name][0] + off, st[name][1] - off)
        for g in groups:
            K = g["K"]
            ms = [int(bdict[nm]["mask"].shape[1]) for nm in g["names"]]
            kfn = lambda: fused_step_delta_grouped(st, dv, bdict, g, 1.0, cfg=cfg64)  # noqa: E731
            pfn = lambda: fused_step_delta_grouped_plain(st, dv, bdict, g, 1.0, cfg=cfg64)  # noqa: E731
            got, again, want = kfn(), kfn(), pfn()
            torch.cuda.synchronize()
            bitwise(f"fused_step_delta[K={K}, {dname}]", grouped_leaves(got),
                    grouped_leaves(want))
            bitwise(f"fused_step_delta[K={K}, {dname}] second launch", grouped_leaves(again),
                    grouped_leaves(got))
            row = dict(group=K, buckets=g["names"], dtype=dname, K=K, m=sum(ms),
                       cfg=list(cfg64), max_abs_err=0.0, ms=graph_ms(kfn),
                       plain_ms=eager_ms(pfn))
            # per bucket: sD sL X0 w sS aD aL mask nu0e + asset ids + gamma nsig
            # + v in; sD' sL' A B + the consensus-term plane out
            row["bound_ms"], row["bound_by"] = group_bound([
                bound_ms(es * (14 * K * m + 2 * m + n_pad) + 4 * K * m,
                         projection_flops(cfg64, K, m, per_step=80), dtype) for m in ms])
            rows["fused_step_delta"].append(row)
            log(f"# fused_step_delta K={K} {g['names']} {dname} m={sum(ms)}: bitwise equal "
                f"to plain and across launches; kernel {row['ms']:.4f} ms (1 launch + 1 "
                f"segment sum)  plain {row['plain_ms']:.2f} ms  bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']})")
            kfn = lambda: project_delta_grouped(pin, bdict, g, cfg=cfg64)  # noqa: E731
            pfn = lambda: project_delta_grouped_plain(pin, bdict, g, cfg=cfg64)  # noqa: E731
            got, again, want = kfn(), kfn(), pfn()
            torch.cuda.synchronize()
            bitwise(f"project_delta[K={K}, {dname}]", grouped_leaves(got), grouped_leaves(want))
            bitwise(f"project_delta[K={K}, {dname}] second launch", grouped_leaves(again),
                    grouped_leaves(got))
            row = dict(group=K, buckets=g["names"], dtype=dname, K=K, m=sum(ms),
                       cfg=list(cfg64), max_abs_err=0.0, ms=graph_ms(kfn),
                       plain_ms=graph_ms(pfn, n=2, reps=3))
            # per bucket: p q X0 w (sS) aD aL mask + gamma nsig in; a b out
            row["bound_ms"], row["bound_by"] = group_bound([
                bound_ms(es * ((10 if ds._meta[nm][0] == "gm" else 9) * K * m + 2 * m),
                         projection_flops(cfg64, K, m, per_step=80), dtype)
                for nm, m in zip(g["names"], ms)])
            rows["project_delta"].append(row)
            log(f"# project_delta K={K} {g['names']} {dname} m={sum(ms)}: bitwise equal to "
                f"plain and across launches; kernel {row['ms']:.4f} ms  plain "
                f"{row['plain_ms']:.2f} ms  bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        if dtype == torch.float32:
            # the same kernels launched once per bucket (five groups of one),
            # and one whole fused delta iteration, in this run
            one_fused = one_proj = 0.0
            for name, arrs in bdict.items():
                kind, floor = ds._meta[name]
                sD, sL = st[name]
                one_fused += graph_ms(lambda: fused_step_delta(
                    sD, sL, dv, arrs, kind, floor, 1.0, cfg=cfg64))
                one_proj += graph_ms(delta_projection_calls(
                    kind, floor, *pin[name], arrs, cfg64,
                    (project_gm_delta_cuda, project_cs_delta_cuda),
                    (project_gm_delta, project_cs_delta))[0])
            it_ms = graph_ms(lambda: ds._iterate_fused(st, wd, dnu, rho_t, dc, dlo, dhi,
                                                       buckets=bdict), n=10, reps=5)
            grouped = {k: sum(r["ms"] for r in rows[k] if r["dtype"] == "float32")
                       for k in ("fused_step_delta", "project_delta")}
            log(f"# 2b device ms per iteration (CUDA graphs, float32, (48, 6)): fused delta "
                f"step 2 grouped launches + 2 segment sums {grouped['fused_step_delta']:.4f} vs "
                f"5 + 5 as groups of one {one_fused:.4f}; delta projection 2 grouped "
                f"launches {grouped['project_delta']:.4f} vs 5 as groups of one "
                f"{one_proj:.4f}; one whole fused delta iteration {it_ms:.4f}")
            report["delta_grouping"] = dict(
                fused_grouped_ms=grouped["fused_step_delta"], fused_per_bucket_ms=one_fused,
                project_grouped_ms=grouped["project_delta"], project_per_bucket_ms=one_proj,
                fused_iteration_ms=it_ms)
        del ds, bdict, st, pin
    log(f"# phase 2b (grouped delta kernels vs plain) done in "
        f"{time.perf_counter() - t_phase:.1f} s")

    # ---- 2c. any K: run-time-K and K = 4, 8, 16 instantiations ---------------
    t_phase = time.perf_counter()
    cfg_w = plain.ProjectionConfig()
    any_k = []
    # K = 40: one thread per delta pool (the form for K > 32)
    for pad_pow2, want_w in ((False, [3, 5, 12]), (True, [4, 8, 16]), (False, [40])):
        spec_w, obj_w = mixed_width_arbitrage(
            widths=(40,) if want_w == [40] else (3, 5, 12),
            n_assets=48 if want_w == [40] else 16, seed=2)
        comp_w = compile_spec(spec_w, pad_pow2=pad_pow2, pad_pools_to=128)
        widths = sorted({b.width for b in comp_w.buckets.values()})
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
        s_w = {}
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
            bitwise(f"any-K projection[{name}, K={K}] (a group of one)", got, want)
            got = fused_step(sD, sL, vw, arrs, kind, floor, 1.5, cfg=cfg_w)
            want = fused_step_plain(sD, sL, vw, arrs, kind, floor, 1.5, cfg=cfg_w)
            torch.cuda.synchronize()
            bitwise(f"any-K fused_step[{name}, K={K}]", got, want)
            s_w[name] = (sD, sL)
            any_k.append(dict(pad_pow2=pad_pow2, bucket=name, K=K, m=m))
        # the grouped kernels, one group per K (4, 8 or 16 lanes a pool, or
        # one thread at K = 40); the projection in float64 too
        sw64 = AdmmSolver(comp_w, dtype=torch.float64, options=sw.options)
        s_w64 = {nm: tuple(x.double() for x in st_) for nm, st_ in s_w.items()}
        for g in sw._groups:
            for slv, inp, dname in ((sw, s_w, "float32"), (sw64, s_w64, "float64")):
                got = project_grouped(inp, slv.buckets, g, cfg=cfg_w)
                want = project_grouped_plain(inp, slv.buckets, g, cfg=cfg_w)
                torch.cuda.synchronize()
                bitwise(f"any-K project grouped[K={g['K']}, {dname}]", grouped_leaves(got),
                        grouped_leaves(want))
        del sw64, s_w64
        for g in sw._groups:
            got = fused_step_grouped(s_w, vw, sw.buckets, g, 1.5, cfg=cfg_w)
            want = fused_step_grouped_plain(s_w, vw, sw.buckets, g, 1.5, cfg=cfg_w)
            torch.cuda.synchronize()
            bitwise(f"any-K fused_step grouped[K={g['K']}]", grouped_leaves(got),
                    grouped_leaves(want))
        for g in dsw._groups:
            for label, kfn, pfn, gargs in (
                    ("fused_step_delta", fused_step_delta_grouped,
                     fused_step_delta_grouped_plain, (s_w, vw, bd_w, g, 1.5)),
                    ("project_delta", project_delta_grouped, project_delta_grouped_plain,
                     (s_w, bd_w, g))):
                got, want = kfn(*gargs, cfg=cfg_w), pfn(*gargs, cfg=cfg_w)
                torch.cuda.synchronize()
                bitwise(f"any-K {label}[K={g['K']}]", grouped_leaves(got),
                        grouped_leaves(want))
        log(f"# any K (pad_pow2={pad_pow2}): buckets "
            f"{[(n, b.width) for n, b in comp_w.buckets.items()]}; the projections (per "
            f"bucket, and grouped in float32 and float64), the fused steps (per bucket "
            f"and grouped) and the grouped delta kernels bitwise equal to plain")
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
        n_groups = len(dsolver._groups)
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
        if launches != n_groups * fused_iters or launches == 0:
            raise AssertionError(f"fused_step_delta launches {launches} != "
                                 f"{n_groups} K-groups x {fused_iters}")
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
    missing = [k for k in ("project", "fused_step", "segment_sum") if launches4[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    if launches4["project"] != len(solver._groups):  # the one classic iteration
        raise AssertionError(f"project launches {launches4['project']} != "
                             f"{len(solver._groups)} K-groups x 1 classic iteration")
    expect_fused = 499 * len(solver._groups)
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

    secs = {"eager": [], "replayed": []}
    turn_counts = []
    for mode in ("eager", "replayed", "replayed", "eager"):  # in turns
        ctx = graphs.eager() if mode == "eager" else contextlib.nullcontext()
        with ctx:
            _build.reset_launch_counts()
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            res2 = solver.solve_fused(eq.objective, iters=499)
            stop.record()
            stop.synchronize()
        secs[mode].append(start.elapsed_time(stop) / 1e3)
        turn_counts.append((mode, dict(_build.LAUNCHES)))
        if not bitwise_equal(res, res2):
            raise AssertionError(f"a {mode} fused kernel run is not bitwise equal to the "
                                 "first (replayed) one")
        if turn_counts[-1][1] != turn_counts[0][1]:
            raise AssertionError(f"launches of a {mode} run {turn_counts[-1][1]} != those "
                                 f"of the first eager run {turn_counts[0][1]}")
        if turn_counts[-1][1]["fused_step"] != expect_fused:
            raise AssertionError(f"{mode} run: fused_step launches "
                                 f"{turn_counts[-1][1]['fused_step']} != {expect_fused}")
    fused_s, eager_s = min(secs["replayed"]), min(secs["eager"])
    log(f"# fused kernel path: 500 iterations replayed {secs['replayed']} s -> "
        f"{500 / fused_s:.1f} it/s, eager {secs['eager']} s -> {500 / eager_s:.1f} it/s "
        f"(in turns) on {smi}; objective {obj_k:.6f}; every run bitwise equal, with "
        f"equal launch counts {turn_counts[0][1]}")
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
    idle_eager = 1.0 - iter_dev_ms / (1e3 * eager_s / 500)
    log(f"# one fused iteration: {iter_dev_ms:.4f} ms on the device (CUDA graph) vs "
        f"{iter_wall_ms:.4f} ms per iteration replayed ({1e3 * eager_s / 500:.4f} eager): "
        f"the card idles {100 * idle:.1f}% of the replayed loop, {100 * idle_eager:.1f}% "
        f"of the eager one")

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
        fused_eager_iters_per_s=500 / eager_s, fused_s=secs, idle_share_eager=idle_eager,
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

    t_start = time.perf_counter()
    table, obj = random_arbitrage_table(256, 100_000, seed=7)
    eq = equilibrate(table, obj)
    compiled = compile_table(eq.table, pad_pools_to=1024)
    cert_compiled = compile_table(table, pad_pools_to=1024)
    setup_s = time.perf_counter() - t_start

    def unscale(r):
        return unscale_result(r, eq.d, compiled)

    def certified_route(mode):
        """The route from the base solve's start to the accepted certificate,
        eager or replayed; launch counts reset just before, read just after."""
        ctx = graphs.eager() if mode == "eager" else contextlib.nullcontext()
        with ctx:
            _build.reset_launch_counts()
            base_solver = AdmmSolver(compiled, dtype=torch.float32, options=AdmmOptions(
                max_iters=3000, eps_abs=1e-7, eps_rel=1e-7, check_every=25,
                projection=cfg_main))
            torch.cuda.synchronize()
            t_base0 = time.perf_counter()
            res = base_solver.solve(eq.objective)
            torch.cuda.synchronize()
            base_s = time.perf_counter() - t_base0
            base_launches = dict(_build.LAUNCHES)
            r0 = unscale(to_host(res))
            entry = certify(cert_compiled, obj, r0.deltas, r0.lambdas, r0.prices,
                            psi_claimed=r0.psi)
            dsolver = CountingDeltaSolver(compiled, options=refine_opts)
            t0 = time.perf_counter()
            out = refine_device(compiled, eq.objective, res, target_gap=1e-6,
                                cert_space=(cert_compiled, obj, unscale), entry_cert=entry,
                                solver=dsolver)
            torch.cuda.synchronize()
            t_end = time.perf_counter()
        return dict(res=r0, base_iters=int(res.iters), converged=bool(res.converged),
                    base_s=base_s, base_launches=base_launches,
                    base_groups=len(base_solver._groups), entry=entry, out=out,
                    chunks=dsolver.chunks, groups=[g["names"] for g in dsolver._groups],
                    refine_s=t_end - t0,
                    wall_s=t_end - t_base0, launches=dict(_build.LAUNCHES))

    route_eager = certified_route("eager")
    rd_log.addHandler(chunk_log)
    rt = certified_route("replayed")
    rd_log.removeHandler(chunk_log)
    for mode, r in (("eager", route_eager), ("replayed", rt)):
        bl = r["base_launches"]
        log(f"# certified route ({mode}): base {r['base_iters']} classic iterations in "
            f"{r['base_s']:.3f} s (converged {r['converged']}; launches: project "
            f"{bl['project']}, classic_step {bl['classic_step']}, consensus "
            f"{bl['consensus']}, classic_z {bl['classic_z']}); refinement {r['out'].iters} "
            f"iterations ({r['chunks']} chunks) in {r['refine_s']:.3f} s; "
            f"{r['wall_s']:.3f} s from the base solve's start to the accepted certificate "
            f"(host clock; network set-up before it {setup_s:.3f} s)")
    same = [np.array_equal(np.asarray(route_eager["res"].psi), np.asarray(rt["res"].psi)),
            np.array_equal(np.asarray(route_eager["res"].prices), np.asarray(rt["res"].prices)),
            route_eager["out"].certificate.gap_rel == rt["out"].certificate.gap_rel,
            route_eager["launches"] == rt["launches"]]
    if not all(same):
        raise AssertionError(f"certified route: the replayed run differs from the eager "
                             f"one (base psi, prices, final gap, launches): {same}")
    log("# certified route: the replayed base is bitwise equal to the eager one, the "
        "refinement ends at the same certificate with the same launches")
    entry, out, launches5 = rt["entry"], rt["out"], rt["launches"]
    log(f"# certified route: entry certificate {entry.summary()} "
        f"feasibility_rel {entry.feasibility_rel:.3e}")
    fc = out.certificate
    fused_iters = out.iters - rt["chunks"]
    log(f"# certified route: final gap_rel {fc.gap_rel:.3e} feasibility_rel "
        f"{fc.feasibility_rel:.3e}; target 1e-6 achieved: {bool(out.achieved)}; "
        f"{fused_iters} fused delta iterations")
    log(f"# certified route: launches {launches5} (K-groups {rt['groups']})")
    n_groups = len(rt["groups"])
    if launches5["fused_step_delta"] == 0:
        raise AssertionError("fused_step_delta was never launched on the certified route")
    if n_groups != 2 or launches5["fused_step_delta"] != n_groups * fused_iters:
        raise AssertionError(f"fused_step_delta launches {launches5['fused_step_delta']} "
                             f"!= {n_groups} K-groups x {fused_iters} fused iterations")
    if launches5["project_delta"] != n_groups * rt["chunks"]:
        raise AssertionError(f"project_delta launches {launches5['project_delta']} != "
                             f"{n_groups} K-groups x {rt['chunks']} classic delta iterations")
    # each block of the base: BASE_BLOCK replayed kernel steps, then one
    # checked iteration (_iterate, the grouped projection)
    blocks, rest = divmod(rt["base_iters"], BASE_BLOCK + 1)
    groups = rt["base_groups"]
    want = dict(project=groups * blocks, classic_step=groups * BASE_BLOCK * blocks,
                consensus=BASE_BLOCK * blocks, classic_z=groups * blocks)
    got = {k: rt["base_launches"][k] for k in want}
    if rest or got != want:
        raise AssertionError(f"the base's {rt['base_iters']} iterations made launches "
                             f"{got}, not {want} ({groups} K-groups, {blocks} blocks of "
                             f"{BASE_BLOCK} kernel steps and one checked iteration)")
    missing = [k for k in ("project", "project_delta", "segment_sum", "classic_step",
                           "consensus", "classic_z") if launches5[k] == 0]
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
        base_iters=rt["base_iters"], base_s=rt["base_s"], refine_iters=int(out.iters),
        refine_chunks=rt["chunks"], fused_iters=fused_iters, refine_s=rt["refine_s"],
        wall_s=rt["wall_s"], achieved=bool(out.achieved), launches=launches5,
        eager=dict(base_s=route_eager["base_s"], refine_s=route_eager["refine_s"],
                   wall_s=route_eager["wall_s"]),
        entry=dict(gap_rel=entry.gap_rel, feasibility_rel=entry.feasibility_rel),
        final=dict(objective=fc.objective, dual_bound=fc.dual_bound,
                   gap_rel=fc.gap_rel, feasibility_rel=fc.feasibility_rel),
    )
    log(f"# phase 5 (certified route) done in {time.perf_counter() - t_phase:.1f} s")
    del route_eager, rt, out

    # ---- 5b. the reference's gated route at 1k, 10k and 100k pools ------------
    phase5b = gated_phase(report, card=smi)

    # ---- 6. sweeps and batches ------------------------------------------------
    phase6 = sweep_phase(report, rows, card=smi, cfg_main=cfg_main, cfg64=cfg64)

    # ---- 7. the merged K-group kernel and concave utilities -------------------
    phase7 = merged_utility_phase(report, rows, card=smi, cfg_main=cfg_main, cfg64=cfg64,
                                  counting_solver=CountingDeltaSolver,
                                  refine_opts=refine_opts)
    # ---- 7e. a certified non-separable (custom) utility route ----------------
    phase7e = custom_phase(report, card=smi, cfg_main=cfg_main)
    main_launches = [launches4, launches5] + phase5b + phase6 + phase7 + phase7e

    # ---- 8. CUDA-graph replays against eager runs -----------------------------
    replay_phase(report, card=smi, cfg_main=cfg_main, cfg64=cfg64)

    # ---- 9. scale-out: the sharded solvers --------------------------------------
    main_launches += scaleout_phase(report, card=smi, cfg_main=cfg_main,
                                    refine_opts=refine_opts)

    # ---- 10. the native packer, the command line and the host extras ------------
    main_launches += host_extras_phase(report, card=smi, cfg_main=cfg_main)

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
