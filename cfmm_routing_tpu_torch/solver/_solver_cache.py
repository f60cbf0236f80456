"""The solvers that a route builds for itself, kept across routes of one
network.

A solver bakes its network's structure into its device arrays (asset ids,
masks, slot orders, degree) and, on the card, into the CUDA graphs of its
iteration blocks, which read its bucket tensors in place.  A route on a
network that an earlier route solved takes that route's solver instead of
building one: :meth:`AdmmSolver._refresh` copies the new reserve state's
values into the solver's tensors, and its captured blocks replay.  The
arrays, kernels and order of operations are those of a new solver, so the
answers are bitwise the same.

Only the solvers that the program builds for itself are kept:
``api.route``'s own (no ``solver=``) and the delta solver that
``refine_device`` builds inside such a route, and ``api.route_scenarios``'
folded base solver and the folded delta solver of its ``refine_sweep``.  :func:`lease` is a route's
scope; inside it :func:`own` takes a kept solver whose key matches, else
builds one, and a lease that ends without raising puts what it took back.
An entry serves one route at a time: while a route holds it, it is out of
the cache, so a concurrent route on the same network builds its own; a
route that raises drops what it took.  At most ``_CAP`` solvers are kept,
the least recently used dropped first.  Outside a lease :func:`own` builds
a new solver and keeps nothing.
"""
from __future__ import annotations

import contextlib
import contextvars
import hashlib
import threading
from collections import OrderedDict

import numpy as np

from .._device import resolve_device
from ..utils.profiling import count, span

_CAP = 8  # solvers kept: a route on a network holds two, scenarios three
_KEPT: "OrderedDict[tuple, object]" = OrderedDict()
_LOCK = threading.Lock()
_LEASE: "contextvars.ContextVar[_Lease | None]" = contextvars.ContextVar(
    "cfmm_solver_lease", default=None)


def fingerprint(compiled) -> tuple:
    """What a solver bakes in of a compiled problem: per bucket its name,
    kind, ``needs_floor``, shape, asset ids and mask, and the problem's
    asset count and degree (the ids, masks and degree as one digest)."""
    h = hashlib.blake2b(digest_size=16)
    parts = [compiled.n_assets]
    for name in sorted(compiled.buckets):
        b = compiled.buckets[name]
        parts.append((name, b.kind, bool(b.needs_floor), b.mask.shape))
        for a in (b.asset.astype(np.int32, copy=False), b.mask):
            h.update(np.ascontiguousarray(a).data)
    h.update(np.ascontiguousarray(compiled.degree, np.float64).data)
    return tuple(parts), h.digest()


class _Lease:
    """One route's solvers: [(key, solver)] taken, and the fingerprint of
    each compiled problem it keyed (with the problem, so its id stays
    its own)."""

    __slots__ = ("taken", "prints")

    def __init__(self):
        self.taken = []
        self.prints = {}

    def fingerprint(self, compiled) -> tuple:
        hit = self.prints.get(id(compiled))
        if hit is None:
            hit = self.prints[id(compiled)] = (compiled, fingerprint(compiled))
        return hit[1]


@contextlib.contextmanager
def lease():
    """A route's scope: inside it :func:`own` takes kept solvers; when it
    ends without raising, they go back to the cache."""
    held = _Lease()
    token = _LEASE.set(held)
    try:
        yield
    finally:
        _LEASE.reset(token)
    with _LOCK:
        for key, solver in held.taken:
            _KEPT.pop(key, None)  # one a concurrent route put back: older
            _KEPT[key] = solver
        while len(_KEPT) > _CAP:
            _KEPT.popitem(last=False)


def own(cls, compiled, dtype, options, device, fold=None):
    """A ``cls`` solver of ``compiled`` (a scenario fold of ``fold`` = (T,
    n_pt) points where given): inside a lease, a kept one of the same class,
    dtype, device, options, fold and :func:`fingerprint`, refreshed with
    ``compiled``'s values and counted under ``solvers.reused``, else a new
    one."""
    kw = {} if fold is None else {"fold": fold}
    held = _LEASE.get()
    if held is None:
        return cls(compiled, dtype=dtype, options=options, device=device, **kw)
    with span("solver.build"):  # the key and the refresh; a build has its own
        device = resolve_device(device)
        key = (cls, dtype, device, options, fold, held.fingerprint(compiled))
        with _LOCK:
            solver = _KEPT.pop(key, None)
        if solver is not None:
            solver._refresh(compiled)
            count("solvers.reused")
    if solver is None:
        solver = cls(compiled, dtype=dtype, options=options, device=device, **kw)
    held.taken.append((key, solver))
    return solver


def clear() -> None:
    """Drop every kept solver."""
    with _LOCK:
        _KEPT.clear()
