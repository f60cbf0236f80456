"""Scenario folding: a T-point sweep as ONE problem on the pool axis.

T independent copies of the same network are block-diagonal in the
consensus — point t's pools touch only point t's asset block — so a batch
of T solves is one solve over ``T*m`` pools and ``T*n`` assets.  Folding
keeps the iteration on the fused kernels with one launch per channel
count per iteration whatever T is: each kernel block stages only its own point's
prices (``ops/iteration_cuda.py``, ``fold=``), and the segment sum reduces
the consensus over the folded asset ids, which never mix two points.

Exactness: the projections are per pool and the linear consensus prox is
elementwise, so the folded iterate equals the T per-point iterates, up to
the shared (joint) stopping test and, for base solves, a shared adapted
rho.  The batched classic solves (``AdmmSolver.solve_batch``) run the same
fold with a stopping test and a penalty per point instead.  The delta-dual
refinement iteration is rho-free for linear objectives (rho enters only
the folded constant e0 and the price reconstruction), so per-point
penalties fold exactly there (``refine_device.refine_sweep``).

The folded compiled problem is bit-identical to the JAX package's
``fold_compiled`` for the same input; the solver gives its padding slots
the first asset of their point (``admm._bucket_device_arrays``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .._device import host, resolve_device
from ..models.utility import Objective
from .admm import (_F32_BIG, AdmmOptions, AdmmSolver, RouteResult, _fused_ok,
                   _reserve_buckets)
from .compiler import Bucket, CompiledProblem

__all__ = [
    "fold_compiled",
    "scenario_point",
    "fold_vec",
    "unfold_vec",
    "fold_planes",
    "unfold_planes",
    "folded_solver",
    "unfold_route",
    "solve_batch_folded",
    "solve_batch_reserves_folded",
]


def fold_compiled(
    compiled: CompiledProblem, T: int, reserve_scale=None
) -> CompiledProblem:
    """T copies of the problem, concatenated along the pool axis.

    Point t's pools carry asset ids offset by ``t*n`` (padding slots get id
    ``T*n``), so the folded consensus is block-diagonal.  Bucket pool
    counts multiply by T, so ``pad_pools_to`` multiples stay multiples per
    point.

    ``reserve_scale``: optional (T, n_pools) per-point multiplicative
    reserve factors (per-pool reserve scenarios); each point's bucket block
    carries its own reserves and recomputed invariants.
    """
    n = compiled.n_assets
    if reserve_scale is not None:
        reserve_scale = np.asarray(reserve_scale, np.float64)
        if reserve_scale.shape != (T, compiled.n_pools):
            raise ValueError(
                f"reserve_scale must be (T={T}, n_pools="
                f"{compiled.n_pools}); got {reserve_scale.shape}"
            )
    buckets: Dict[str, Bucket] = {}
    for name, b in compiled.buckets.items():
        m = b.mask.shape[0]
        real = b.mask > 0
        # (T*m, K): per-point row blocks [t*m, (t+1)*m)
        asset_f = np.concatenate(
            [np.where(real, b.asset + t * n, T * n) for t in range(T)]
        ).astype(np.int32)
        if reserve_scale is None:
            R_f = np.tile(b.reserves, (T, 1))
            logk0_f = np.tile(b.logk0, T)
            k0_f = np.tile(b.k0, T)
        else:
            sc = np.ones((T, m))
            sc[:, : len(b.pool_ids)] = reserve_scale[:, b.pool_ids]
            R_f = (b.reserves[None] * sc[:, :, None]).reshape(T * m, -1)
            if b.kind == "gm":
                y = np.where(
                    np.tile(real, (T, 1)), R_f + np.tile(b.shift, (T, 1)), 1.0,
                )
                logk0_f = np.sum(np.tile(b.weights, (T, 1)) * np.log(y), axis=1)
                k0_f = np.exp(logk0_f)
            else:
                k0_f = np.sum(np.tile(b.weights, (T, 1)) * R_f, axis=1)
                logk0_f = np.log(np.maximum(k0_f, 1e-300))
        buckets[name] = Bucket(
            kind=b.kind,
            width=b.width,
            reserves=R_f,
            weights=np.tile(b.weights, (T, 1)),
            shift=np.tile(b.shift, (T, 1)),
            gamma=np.tile(b.gamma, (T, 1)),
            logk0=logk0_f,
            k0=k0_f,
            mask=np.tile(b.mask, (T, 1)),
            asset=asset_f,
            pool_ids=np.concatenate(
                [b.pool_ids + t * compiled.n_pools for t in range(T)]
            ),
            needs_floor=b.needs_floor,
        )
    return CompiledProblem(
        n_assets=T * n,
        buckets=buckets,
        degree=np.tile(compiled.degree, T),
        n_pools=T * compiled.n_pools,
        n_slots=T * compiled.n_slots,
        widths=np.tile(compiled.widths, T),
        spec=None,
    )


def scenario_point(compiled: CompiledProblem, scenarios: CompiledProblem,
                   t: int) -> CompiledProblem:
    """Point ``t`` of ``scenarios``, a reserve-scaled fold
    ``fold_compiled(compiled, T, reserve_scale)``, as a problem of its own:
    ``compiled`` with the point's reserves and invariants."""
    buckets = {}
    for name, b in compiled.buckets.items():
        rows = slice(t * b.m, (t + 1) * b.m)
        sb = scenarios.buckets[name]
        buckets[name] = dataclasses.replace(
            b, reserves=sb.reserves[rows], logk0=sb.logk0[rows], k0=sb.k0[rows])
    return dataclasses.replace(compiled, buckets=buckets)


def fold_vec(x) -> np.ndarray:
    """(T, n) per-point asset vectors -> (T*n,) folded."""
    return np.asarray(x).reshape(-1)


def unfold_vec(x, T: int) -> np.ndarray:
    """(T*n,) folded asset vector -> (T, n)."""
    return np.asarray(x).reshape(T, -1)


def fold_planes(planes: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Per-bucket (T, K, m) trade planes -> (K, T*m) folded layout (row
    blocks along the pool axis, matching :func:`fold_compiled`)."""
    out = {}
    for k, v in planes.items():
        v = np.asarray(v)
        T, K, m = v.shape
        out[k] = v.transpose(1, 0, 2).reshape(K, T * m)
    return out


def unfold_planes(planes: Dict[str, np.ndarray], T: int) -> Dict[str, np.ndarray]:
    """(K, T*m) folded trade planes -> per-point (T, K, m)."""
    out = {}
    for k, v in planes.items():
        v = np.asarray(v)
        K, Tm = v.shape
        out[k] = v.reshape(K, T, Tm // T).transpose(1, 0, 2)
    return out


# (id(compiled), T, class, dtype, options, chunk, device) ->
# (compiled, solver, driver).  Building a folded solver sorts the T*m pools'
# slots for the segment sum and copies every bucket to the device, so
# repeated sweeps on one network reuse it; the entry holds a strong
# reference to ``compiled`` so the id key stays valid.
_SOLVER_CACHE = {}
_CACHE_CAP = 6


def folded_solver(compiled, T, options, dtype, cls=None, chunk=None,
                  device=None):
    """Build-or-reuse a solver over ``fold_compiled(compiled, T)`` (and its
    fused :class:`~.driver.ChunkedDriver` when ``chunk`` is given).
    Returns (solver, driver or None)."""
    cls = cls if cls is not None else AdmmSolver
    dev = resolve_device(device)
    key = (id(compiled), T, cls.__name__, str(dtype), repr(options), chunk,
           str(dev))
    hit = _SOLVER_CACHE.get(key)
    if hit is not None:
        return hit[1], hit[2]
    solver = cls(fold_compiled(compiled, T), dtype=dtype, options=options,
                 device=dev, fold=(T, compiled.n_assets))
    driver = None
    if chunk is not None:
        from .driver import ChunkedDriver

        driver = ChunkedDriver(solver, chunk=chunk, fused=True)
    if len(_SOLVER_CACHE) >= _CACHE_CAP:
        _SOLVER_CACHE.pop(next(iter(_SOLVER_CACHE)))
    _SOLVER_CACHE[key] = (compiled, solver, driver)
    return solver, driver


def unfold_route(res: RouteResult, T: int, c=None) -> RouteResult:
    """Folded RouteResult -> per-point batched RouteResult of numpy arrays.

    Joint quantities (iters, residual norms, converged, rho) broadcast to
    every point — the folded solve ran them jointly.  ``c``: optional
    (T, n) objective rows to recover per-point objective values; without
    it each point gets the joint objective / T."""
    psi = unfold_vec(host(res.psi), T)
    if c is not None:
        obj = np.sum(np.asarray(c, np.float64) * psi, axis=1)
    else:
        obj = np.full(T, float(host(res.objective)) / T)

    def fill(v):
        return np.full(T, host(v))

    return RouteResult(
        objective=obj, psi=psi, prices=unfold_vec(host(res.prices), T),
        deltas=unfold_planes({k: host(v) for k, v in res.deltas.items()}, T),
        lambdas=unfold_planes({k: host(v) for k, v in res.lambdas.items()}, T),
        iters=fill(res.iters), r_norm=fill(res.r_norm), s_norm=fill(res.s_norm),
        converged=fill(res.converged), rho_final=fill(res.rho_final),
    )


def _auto_fused(compiled, dev) -> bool:
    """The reference's rule: fused on the card when every bucket's pool
    count (per point) is a multiple of 128, classic elsewhere."""
    return dev.type == "cuda" and all(
        b.m % 128 == 0 for b in compiled.buckets.values()
    )


def solve_batch_folded(
    compiled: CompiledProblem,
    c,
    lo,
    hi,
    options=None,
    dtype: torch.dtype = torch.float32,
    fused: bool = None,
    chunk: int = 500,
    interpret: bool = False,
    rho: float = None,
    max_iters: int = None,
    device=None,
) -> RouteResult:
    """T per-point linear objectives ((T, n) ``c``/``lo``/``hi``) solved as
    ONE folded problem.

    ``fused`` (default: on the card when every bucket's pool count is a
    multiple of 128) runs a fused :class:`~.driver.ChunkedDriver` on the
    ``fused_step(fold=)`` kernel; otherwise the classic solve.  Semantics
    differ from :meth:`AdmmSolver.solve_batch` only in the JOINT stopping
    test and the shared adapted rho.  Returns a per-point batched
    RouteResult of numpy arrays (:func:`unfold_route`).  ``interpret``: the
    JAX package's Pallas interpret mode, accepted and ignored."""
    c = np.asarray(c, np.float64)
    T = c.shape[0]
    opts = options if options is not None else AdmmOptions()
    dev = resolve_device(device)
    if fused is None:
        fused = _auto_fused(compiled, dev)
    solver, drv = folded_solver(compiled, T, opts, dtype,
                                chunk=chunk if fused else None, device=dev)
    obj_f = Objective(fold_vec(c), lo=fold_vec(np.asarray(lo, np.float64)),
                      hi=fold_vec(np.asarray(hi, np.float64)))
    mi = max_iters if max_iters is not None else opts.max_iters
    if fused:
        res, _log = drv.solve(obj_f, max_iters=mi, rho=rho)
    else:
        res = solver.solve(obj_f, rho=rho, max_iters=mi)
    return unfold_route(res, T, c=c)


def solve_batch_reserves_folded(
    compiled: CompiledProblem,
    objective: Objective,
    reserve_scale,
    options=None,
    dtype: torch.dtype = torch.float32,
    n_iters: int = 750,
    rho: float = None,
    fused: bool = None,
    interpret: bool = False,
    device=None,
) -> RouteResult:
    """T per-pool reserve scenarios ((T, n_pools) ``reserve_scale``) of one
    linear objective as ONE folded solve of fixed length: ``n_iters`` fused
    iterations plus one classic harvest iteration on the
    ``fused_step(fold=)`` kernel (``fused``, default on the card with
    128-aligned buckets), else a classic solve of at most ``n_iters``
    iterations.  The reserve planes are uploaded in the solver's dtype.
    Returns a per-point batched RouteResult of numpy arrays.
    ``interpret``: the JAX package's Pallas interpret mode, accepted and
    ignored."""
    reserve_scale = np.asarray(reserve_scale, np.float64)
    T = reserve_scale.shape[0]
    opts = options if options is not None else AdmmOptions()
    dev = resolve_device(device)
    if fused is None:
        fused = _auto_fused(compiled, dev)
    solver, _ = folded_solver(compiled, T, opts, dtype, device=dev)
    if fused and not _fused_ok(solver):
        raise ValueError("fused=True needs every bucket's pool count to be a "
                         "multiple of 128: compile with pad_pools_to=128")
    bdict = _reserve_buckets(solver, fold_compiled(compiled, T, reserve_scale))
    c = np.tile(np.asarray(objective.c, np.float64), T)
    lo = np.tile(np.clip(np.asarray(objective.lo, np.float64), -_F32_BIG, _F32_BIG), T)
    hi = np.tile(np.clip(np.asarray(objective.hi, np.float64), -_F32_BIG, _F32_BIG), T)
    ct, lot, hit = solver._t(c), solver._t(lo), solver._t(hi)
    rho_t = solver._t(rho if rho is not None else opts.rho)
    if fused:
        res = solver._solve_fused_impl(ct, lot, hit, rho_t, int(n_iters),
                                       buckets=bdict)
    else:
        res = solver._solve_impl(ct, lot, hit, rho_t, max_iters=int(n_iters),
                                 buckets=bdict)
    return unfold_route(res, T, c=c.reshape(T, -1))
