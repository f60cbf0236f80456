"""Tracing and profiling hooks.

Two tools:

* :func:`trace` — context manager around ``torch.profiler.profile`` that
  writes a TensorBoard-loadable trace (``*.pt.trace.json``) into a
  directory: host operators, and on the card the kernels, copies and graph
  launches.
* :func:`time_phases` — per-phase decomposition of one classic ADMM
  iteration (projection + broadcast / edge reduction / psi-prox / the whole
  iteration), each phase run on its own ``inner`` times from the solver's
  own methods, so on the card the phases launch the same kernels as the
  classic iteration (``project``, ``segment_sum``).  Timed with CUDA events
  on the card and the host clock on the CPU.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

__all__ = ["trace", "time_phases"]


@contextlib.contextmanager
def trace(logdir: str):
    """Trace for TensorBoard:  ``with trace('/tmp/tb'): solver.solve(...)``.

    Records CUDA activity when a card is present; writes at least one file
    into ``logdir`` when the block exits.  Yields the profiler, whose
    ``key_averages()`` gives the table of the traced operators."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def _time(fn, state, iters: int, inner: int, cuda: bool) -> float:
    """Seconds per call of ``state = fn(*state)``: one untimed call (the
    kernels' build and first launch), then ``iters`` rounds of ``inner``
    calls."""
    import torch

    state = fn(*state)
    total = 0.0
    for _ in range(max(1, int(iters))):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(inner):
                state = fn(*state)
            stop.record()
            stop.synchronize()
            total += start.elapsed_time(stop) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(inner):
                state = fn(*state)
            total += time.perf_counter() - t0
    return total / (max(1, int(iters)) * inner)


def time_phases(solver, objective, iters: int = 1, inner: int = 20) -> Dict[str, float]:
    """Per-phase seconds per iteration of an :class:`AdmmSolver` on a linear
    :class:`Objective`: ``project+bcast``, ``edge-reduce``, ``psi-prox`` and
    ``full-iteration``, each the mean over ``iters`` rounds of ``inner``
    calls after one untimed call."""
    cuda = solver.device.type == "cuda"
    c, lo, hi = solver._objective_arrays(objective)
    rho = solver._t(solver.options.rho)
    buckets = solver.buckets
    z = {name: (solver._zeros(*arrs["mask"].shape),
                solver._zeros(*arrs["mask"].shape))
         for name, arrs in buckets.items()}
    nu = solver._zeros(solver.n)

    def proj(z, nu):
        inputs = {}
        for name in buckets:
            nu_e = solver._bcast_nu(nu, name)
            zD, zL = z[name]
            inputs[name] = (zD - nu_e, zL + nu_e)
        return solver._project_groups(inputs, buckets), nu

    def reduce_(z, nu):
        planes = {name: zL - zD for name, (zD, zL) in z.items()}
        return z, nu + solver._reduce_edges(planes, buckets)

    def prox(s, nu):
        psi, _mu = solver._prox(s, c, lo, hi, rho)
        return psi, nu

    def full(z, nu):
        z, nu, _, _, _ = solver._iterate(z, nu, rho, c, lo, hi)
        return z, nu

    return {
        "project+bcast": _time(proj, (z, nu), iters, inner, cuda),
        "edge-reduce": _time(reduce_, (z, nu), iters, inner, cuda),
        "psi-prox": _time(prox, (nu, nu), iters, inner, cuda),
        "full-iteration": _time(full, (z, nu), iters, inner, cuda),
    }
