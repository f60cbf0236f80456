"""Tracing and profiling hooks.

Three tools:

* :func:`span`, :func:`spanned` and :func:`count` — the program's own
  spans and counters.  A span records only while a ``torch.profiler``
  session is on (``torch.autograd._profiler_enabled()``: the benchmark's
  traced run, :func:`trace`, an operator's own profiler); otherwise it does
  nothing but that check.  A recorded span enters
  ``torch.profiler.record_function(name)``, so it lands in the profiler's
  timeline beside the kernels, and appends a :class:`SpanRecord` to a
  bounded in-memory list that :func:`spans` returns.  Its timestamps are
  ``time.time_ns()``, the clock of the profiler's events.  A span opened
  while no span is open is a root: it starts a request id that every span
  nested in it carries, and its record holds the change of every counter
  over its interval.  Counters are always on: :data:`COUNTS`, a dict of
  ints like ``ops/_build.LAUNCHES``.  Spans sit on the host at block
  boundaries, never inside a step that ``solver/graphs.py`` captures (a
  captured step runs only at its capture).
* :func:`trace` — context manager around ``torch.profiler.profile`` that
  writes a TensorBoard-loadable trace (``*.pt.trace.json``) into a
  directory: host operators and the program's spans, and on the card the
  kernels, copies and graph launches.
* :func:`time_phases` — per-phase decomposition of one classic ADMM
  iteration (projection + broadcast / edge reduction / psi-prox / the whole
  iteration), each phase run on its own ``inner`` times from the solver's
  own methods, so on the card the phases launch the same kernels as the
  classic iteration (``project``, ``segment_sum``), eagerly: on the card
  it reports the host's eager launch rate, not a replayed iteration's cost.
  Timed with CUDA events on the card and the host clock on the CPU.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

__all__ = ["trace", "time_phases", "span", "spanned", "count", "spans", "reset",
           "COUNTS", "SpanRecord"]

# counter name -> count since the last reset(); always on
COUNTS: Dict[str, int] = {}
_CAP = 65_536  # records kept; the oldest go first
_RECORDS: "collections.deque[SpanRecord]" = collections.deque(maxlen=_CAP)
_OPEN = threading.local()  # .stack: this thread's open spans, innermost last
_IDS = itertools.count(1)
_OFF = contextlib.nullcontext()
_enabled = torch.autograd._profiler_enabled


class SpanRecord(NamedTuple):
    """One closed span.  Times are ``time.time_ns()`` (Unix epoch, ns)."""

    name: str
    span_id: int
    parent_id: Optional[int]  # None for a root
    request_id: int  # the root's span id
    start_ns: int
    end_ns: int
    counts: Optional[Dict[str, int]]  # a root's counter changes, else None


class _Span:
    __slots__ = ("name", "span_id", "parent_id", "request_id", "start", "before",
                 "mark")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.mark = torch.profiler.record_function(self.name)
        self.start = time.time_ns()
        self.mark.__enter__()
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self.span_id = next(_IDS)
        if stack:
            self.parent_id, self.request_id = stack[-1].span_id, stack[-1].request_id
            self.before = None
        else:
            self.parent_id, self.request_id = None, self.span_id
            self.before = dict(COUNTS)
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _OPEN.stack.pop()
        delta = None
        if self.before is not None:
            delta = {k: v - self.before.get(k, 0) for k, v in COUNTS.items()
                     if v != self.before.get(k, 0)}
        self.mark.__exit__(*exc)
        _RECORDS.append(SpanRecord(self.name, self.span_id, self.parent_id,
                                   self.request_id, self.start, time.time_ns(),
                                   delta))
        return False


def span(name: str):
    """``with span("admm.check"): ...`` — a span of the program, recorded
    only while a ``torch.profiler`` session is on (see the module
    docstring)."""
    return _Span(name) if _enabled() else _OFF


def spanned(name: str):
    """Decorator: every call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the counter ``name`` in :data:`COUNTS`."""
    COUNTS[name] = COUNTS.get(name, 0) + k


def spans() -> List[SpanRecord]:
    """The recorded spans, oldest first, as each closed (a child before
    its parent); at most the last 65,536."""
    return list(_RECORDS)


def reset() -> None:
    """Forget every recorded span and every counter."""
    _RECORDS.clear()
    COUNTS.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """Trace for TensorBoard:  ``with trace('/tmp/tb'): solver.solve(...)``.

    Records CUDA activity when a card is present; writes at least one file
    into ``logdir`` when the block exits.  Yields the profiler, whose
    ``key_averages()`` gives the table of the traced operators."""
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
    calls after one untimed call.

    Every phase runs eagerly, its ops launched one at a time, never as the
    CUDA-graph replay a solve runs: on the card ``full-iteration`` is the
    host's eager launch rate (ms per iteration at 100k pools), not what an
    iteration of a solve costs.  For that, trace a solve and read its
    ``admm.check`` spans and graph replays."""
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
