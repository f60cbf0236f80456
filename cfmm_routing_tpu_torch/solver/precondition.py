"""Per-asset diagonal equilibration.

ADMM has no affine invariance: its linear convergence rate degrades with
the spread of the problem's natural scales.  Here the scales are per-asset
— token units are arbitrary, reserves and prices span orders of
magnitude, and the consensus metric couples every pool that touches an
asset.  The cure is a change of units: pick one positive scale ``d_j`` per
asset and rewrite the whole problem in units of ``d_j`` tokens:

    psi'   = psi / d        (elementwise)
    R'_e   = R_e / d_{a(e)}   per pool slot,  shifts likewise
    c'     = c * d,   lo' = lo / d,   hi' = hi / d

Pool invariants transform cleanly:

  * geo-mean:  phi'(x') = phi(x) / prod d^{w_j} — a constant factor, so the
    constraint phi' >= phi'(R') is the same set.  Weights unchanged.
  * constant sum:  sum x_j >= sum R_j  becomes  sum d_j x'_j >= sum d_j R'_j
    — a weighted constant sum with q_j = d_{a(j)}.

The transformation is exact and, with power-of-two scales, even
floating-point-exact.  Prices are dual to psi (nu^T psi = (nu*d)^T (psi/d)),
so the scaled problem's prices are nu' = nu * d and ``unscale_result``
divides them back.

Scale choices (``mode``):

  * ``'reserves'``  d_j = geometric mean of reserves over the slots of
    asset j — normalizes trade magnitudes to O(1).
  * ``'prices'``    d_j = 1 / max(c_j, tiny) — normalizes asset values.
  * ``'blend'``     sqrt of both (default).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .._device import host
from ..models.utility import ConcaveUtility, Objective
from ..utils.profiling import spanned
from .admm import RouteResult
from .compiler import CompiledProblem, PoolTable

__all__ = [
    "asset_scales",
    "scale_table",
    "scale_objective",
    "unscale_result",
    "Equilibration",
    "equilibrate",
]


def _pow2(d: np.ndarray) -> np.ndarray:
    """Round scales to powers of two: scaling becomes exponent arithmetic,
    so scale -> unscale round-trips bit-exactly."""
    return np.exp2(np.round(np.log2(d)))


def asset_scales(
    table: PoolTable,
    objective=None,
    mode: str = "blend",
) -> np.ndarray:
    """One positive unit scale per asset; see module docstring for modes."""
    n = table.n_assets
    logs = np.zeros(n)
    cnt = np.zeros(n)
    r = np.maximum(table.reserves + table.shifts, 1e-30)
    np.add.at(logs, table.assets, np.log(r))
    np.add.at(cnt, table.assets, 1.0)
    d_res = np.exp(logs / np.maximum(cnt, 1.0))
    d_res = np.where(cnt > 0, d_res, 1.0)

    if mode == "reserves" or objective is None:
        d = d_res
    else:
        c = np.asarray(objective.c, np.float64)
        d_price = 1.0 / np.maximum(np.abs(c), 1e-12)
        d_price = np.where(np.abs(c) > 1e-12, d_price, 1.0)
        if mode == "prices":
            d = d_price
        elif mode == "blend":
            d = np.sqrt(d_res * d_price)
        else:
            raise ValueError(f"unknown mode {mode!r}")
    return _pow2(np.clip(d, 1e-18, 1e18))


def scale_table(table: PoolTable, d: np.ndarray) -> PoolTable:
    """The problem in units of ``d_j`` tokens per asset (see module doc)."""
    d = np.asarray(d, np.float64)
    d_slot = d[table.assets]
    weights = table.weights.copy()
    cs_slots = np.repeat(table.kind == 1, table.width)
    weights[cs_slots] = weights[cs_slots] * d_slot[cs_slots]
    return PoolTable(
        n_assets=table.n_assets,
        kind=table.kind,
        floor=table.floor,
        width=table.width,
        offset=table.offset,
        assets=table.assets,
        reserves=table.reserves / d_slot,
        weights=weights,
        shifts=table.shifts / d_slot,
        fees=table.fees,
    )


def scale_objective(objective, d: np.ndarray):
    """Objective in scaled units: c' = c*d, box /= d.

    ConcaveUtility atoms transform exactly (U'(psi') = U(psi) up to an
    additive constant for log atoms): linear c*d; quadratic (c*d, a*d^2);
    log (c, b/d); power (c*d^p, b/d).
    """
    d = np.asarray(d, np.float64)
    if isinstance(objective, ConcaveUtility):
        kind = objective.kind
        c = objective.c.copy()
        a = objective.a.copy()
        b = objective.b.copy()
        p = objective.p
        lin, quad, log_, pow_ = (kind == k for k in range(4))
        c[lin] *= d[lin]
        c[quad] *= d[quad]
        a[quad] *= d[quad] ** 2
        b[log_] /= d[log_]
        c[pow_] *= d[pow_] ** p[pow_]
        b[pow_] /= d[pow_]
        return ConcaveUtility(
            kind=kind.copy(), c=c, a=a, b=b, p=p.copy(),
            lo=objective.lo / d, hi=objective.hi / d,
        )
    if isinstance(objective, Objective):
        return Objective(objective.c * d, objective.lo / d, objective.hi / d)
    raise TypeError(
        "precondition supports Objective / ConcaveUtility (CustomUtility "
        "closures cannot be rescaled automatically — compose the scaling "
        "into the utility's fn by hand)"
    )


def unscale_result(
    result: RouteResult, d: np.ndarray, compiled_scaled: CompiledProblem
) -> RouteResult:
    """Map a scaled-space RouteResult back to original units (host arrays).

    psi *= d; prices /= d; per-slot trades *= d[asset].  The objective
    value is invariant (exact with power-of-two scales, up to the additive
    constant of log atoms).  Residual norms
    stay in scaled space — the space the solve ran in.
    """
    d = np.asarray(d, np.float64)
    d_ext = np.concatenate([d, [1.0]])
    deltas = {}
    lambdas = {}
    for name, b in compiled_scaled.buckets.items():
        ds = d_ext[b.asset].T  # (K, m) slot scale
        deltas[name] = host(result.deltas[name]) * ds
        lambdas[name] = host(result.lambdas[name]) * ds
    return result._replace(
        psi=host(result.psi) * d,
        prices=host(result.prices) / d,
        deltas=deltas,
        lambdas=lambdas,
    )


@dataclasses.dataclass
class Equilibration:
    """A preconditioned problem: scaled table/objective + the scales."""

    table: PoolTable
    objective: object
    d: np.ndarray


@spanned("route.equilibrate")
def equilibrate(
    table: PoolTable,
    objective,
    mode: str = "blend",
    d: Optional[np.ndarray] = None,
) -> Equilibration:
    """Compute scales and return the scaled problem.

    Typical use::

        eq = equilibrate(table, obj)
        compiled = compile_table(eq.table, pad_pools_to=1024)
        res = AdmmSolver(compiled).solve_fused(eq.objective, iters=499)
        res0 = unscale_result(res, eq.d, compiled)   # original units
    """
    if d is None:
        d = asset_scales(table, objective, mode=mode)
    return Equilibration(
        table=scale_table(table, d),
        objective=scale_objective(objective, d),
        d=np.asarray(d, np.float64),
    )
