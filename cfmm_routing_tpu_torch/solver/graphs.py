"""CUDA-graph replays of the solvers' iteration blocks.

The JAX package runs every solve and chunk as one device program
(``jax.jit`` around ``lax.while_loop`` / ``fori_loop``).  PyTorch runs
eagerly, and an eager iteration at 100k pools is ~30-60 launches of small
kernels whose host cost exceeds their device time.  This module is the
port's counterpart of the ``jit``: a block of B iterations of one path
(the ``check_every - 1`` stats-free iterations of a classic check, the
``chunk - 1`` of a driver chunk, or a short fixed block of a fixed-length
fused solve) is captured once as one ``torch.cuda.CUDAGraph`` and replayed.

What a captured block holds: the iterations' kernels and torch ops, reading
the state (planes, prices, deferred broadcast) and the per-solve constants
(c, lo, hi, rho, the packed utility) from static buffers that :meth:`GraphCache.run`
copies in before the replays, and writing the block's final state back into
the state buffers at its end, so consecutive replays chain and the caller
gets a clone that no later replay overwrites.  The bucket arrays (and any
other tensor the step closes over) are baked in: an entry keeps its bucket
dict alive, and a new bucket dict for the same path (a refinement pass)
drops the old one's graphs.  What stays on the host between replays, as in
the eager loops: the residual check, the rho adaptation, the stopping test,
the batch path's per-point ``live`` masks, the refinement's gates.

Before a capture one eager warm-up step runs on a side stream, so that
libraries load, lazily built tables are built and kernel attributes are set
outside the capture; the capture then records launches only.  A failed
capture or replay raises: nothing falls back to the eager loop.

A sharded solver's blocks hold its collectives (``AdmmSolver._psum``).  An
NCCL all-reduce is captured like a kernel: the solver's constructor has run
one already, so its communicator exists, and the warm-up step runs the
block's collectives eagerly before the capture.  A gloo group moves CUDA
tensors through the host and cannot be captured: a block of a solver on one
raises unless it runs inside :func:`eager`.

Launch counts (``ops/_build.LAUNCHES``) are added in Python by the kernel
wrappers, which a replay does not run.  A capture records what its block
adds, the warm-up's and the capture's own counts are taken back out, and
every replay adds the block's counts: the counts read as if the block had
run eagerly.  On CPU tensors :func:`run_block` is the eager loop and nothing
else.  :func:`eager` makes every block eager on the card too, for comparing
the two in one process (the card tests and ``chip_smoke.py``).
"""
from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Callable

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from ..models.utility import CustomUtility
from ..ops import _build
from ..ops.prox import DeltaCustomUtility
from ..utils.profiling import spanned

__all__ = ["GraphCache", "run_block", "eager"]

_EAGER = [False]
_CAP = 8  # captured blocks kept per solver


@contextlib.contextmanager
def eager():
    """Inside this context every block runs eagerly, on the card as on the
    CPU (comparisons of replayed and eager blocks only)."""
    prev = _EAGER[0]
    _EAGER[0] = True
    try:
        yield
    finally:
        _EAGER[0] = prev


def _loop(step, n, state, consts):
    for _ in range(n):
        state = step(state, consts)
    return state


class _ById:
    """A key part that compares by identity and holds its object, so the
    object's id is not reused while the key (and its graph) lives."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __hash__(self):
        return id(self.obj)

    def __eq__(self, other):
        return isinstance(other, _ById) and other.obj is self.obj


def _meta(leaf):
    """A leaf's part of a graph's key: shape, dtype and device of a tensor;
    a :class:`CustomUtility` (whose callable the block bakes in) by
    identity; any other leaf (a flag, None) by value, since the block bakes
    it in.  (A :class:`DeltaCustomUtility` is a pytree node, never a leaf:
    its tensors are leaves, its callable part of the tree's structure.)"""
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape), leaf.dtype, leaf.device)
    if isinstance(leaf, CustomUtility):
        return ("id", _ById(leaf))
    return ("static", leaf)


def _holds_custom(leaves, spec):
    """Whether a block's constants hold a custom utility: a leaf, or a
    :class:`DeltaCustomUtility` node of their tree."""
    if any(isinstance(x, CustomUtility) for x in leaves):
        return True
    specs = [spec]
    while specs:
        s = specs.pop()
        if s.type is DeltaCustomUtility:
            return True
        specs.extend(s.children_specs)
    return False


class _Entry:
    __slots__ = ("graph", "state", "consts", "counts", "owner")


class GraphCache:
    """One solver's captured blocks, at most ``_CAP`` of them (the least
    recently run goes first), in one CUDA graph memory pool.  Blocks of one
    solver never run concurrently and every block's result is cloned out of
    its static buffers before another replay, so its graphs can share the
    pool."""

    def __init__(self):
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._pool = None

    def run(self, key, step: Callable, n: int, reps: int, state, consts,
            owner=None):
        """``state`` after ``n * reps`` applications of ``step(state,
        consts) -> state``: the graph of ``n`` steps for ``key`` (captured
        at first use) replayed ``reps`` times.  ``owner``: the bucket dict
        the step reads; a graph for another owner under the same ``key`` is
        dropped."""
        s_leaves, s_spec = pytree.tree_flatten(state)
        c_leaves, c_spec = pytree.tree_flatten(consts)
        full = (key, id(owner), n, s_spec, c_spec,
                tuple(_meta(x) for x in s_leaves),
                tuple(_meta(x) for x in c_leaves))
        entry = self._entries.get(full)
        if entry is None:
            for k in [k for k, e in self._entries.items()
                      if k[0] == key and e.owner is not owner]:
                del self._entries[k]
            while len(self._entries) >= _CAP:
                self._entries.popitem(last=False)
            entry = self._capture(step, n, s_leaves, s_spec, c_leaves, c_spec)
            entry.owner = owner
            self._entries[full] = entry
        else:
            self._entries.move_to_end(full)
        for dst, src in zip(entry.state, s_leaves):
            dst.copy_(src)
        for dst, src in zip(entry.consts, c_leaves):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)
        for _ in range(reps):
            entry.graph.replay()
        for name, k in entry.counts.items():
            _build.LAUNCHES[name] += k * reps
        return pytree.tree_unflatten([x.clone() for x in entry.state], s_spec)

    @spanned("graphs.capture")
    def _capture(self, step, n, s_leaves, s_spec, c_leaves, c_spec) -> _Entry:
        entry = _Entry()
        entry.state = [x.clone() for x in s_leaves]
        entry.consts = [x.clone() if isinstance(x, torch.Tensor) else x
                        for x in c_leaves]
        state = pytree.tree_unflatten(entry.state, s_spec)
        consts = pytree.tree_unflatten(entry.consts, c_spec)
        before = dict(_build.LAUNCHES)
        try:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                step(state, consts)  # warm-up: nothing it returns is kept
            torch.cuda.current_stream().wait_stream(side)
            warm = dict(_build.LAUNCHES)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, pool=self._pool):
                    out = _loop(step, n, state, consts)
                    out_leaves, out_spec = pytree.tree_flatten(out)
                    if out_spec != s_spec:
                        raise ValueError("a captured step must return its "
                                         f"state's structure: {out_spec} != "
                                         f"{s_spec}")
                    for dst, src in zip(entry.state, out_leaves):
                        dst.copy_(src)
                    del out, out_leaves
            except RuntimeError as err:
                if not _holds_custom(c_leaves, c_spec):
                    raise
                raise RuntimeError(
                    "capturing an iteration block with a custom utility as a "
                    "CUDA graph failed; a CustomUtility's fn must be torch "
                    "ops only, with no host read (float(x), .item(), .cpu()) "
                    f"and no host-to-device copy: {err}"
                ) from err
            entry.counts = {k: v - warm[k] for k, v in _build.LAUNCHES.items()
                            if v != warm[k]}
        finally:
            _build.LAUNCHES.update(before)  # only replays count (run adds them)
        entry.graph = graph
        return entry


def run_block(solver, key, step: Callable, n: int, reps: int, state, consts,
              owner=None):
    """``state`` after ``n * reps`` applications of ``step(state, consts)``.

    On the card the block of ``n`` steps is a CUDA graph of the solver's
    :class:`GraphCache` (``solver._graphs``), replayed ``reps`` times; on
    the CPU, or inside :func:`eager`, it is the eager loop.  ``key`` names
    the path and whatever the step bakes in beyond its state and constants
    (a flag, a fold); ``owner`` is the bucket dict it reads."""
    if n <= 0 or reps <= 0:
        return state
    if solver.device.type != "cuda" or _EAGER[0]:
        return _loop(step, n * reps, state, consts)
    group = solver.axis_name
    if group is not None and dist.get_backend(group) != "nccl":
        raise RuntimeError(
            f"a sharded solver on a {dist.get_backend(group)} process group "
            "cannot capture its collectives in a CUDA graph: run its solves "
            "inside graphs.eager(), or on an NCCL group")
    return solver._graphs.run(key, step, n, reps, state, consts, owner)
