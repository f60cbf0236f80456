"""High-level workload API: the reference's routing scripts as one-call fns.

    arbitrage(spec, market_values)        ~ arbitrage.py
    liquidate(spec, holdings, numeraire)  ~ liquidation.py
    sweep(spec, give, receive, amounts)   ~ two-asset.py
    route(spec, objective)                ~ any linear objective + box, or a
                                            separable concave utility

Each call returns a :class:`Route` with per-pool trades in spec order, the
net trade vector, dual prices, and solver diagnostics; ``certify=True``
adds a float64 certification report (feasibility residuals + duality gap,
``solver/certify.py``); ``refine_to=`` refines the f32 solve on the device
to that certified relative gap (``solver/refine_device.py``) and returns the
refined route with its certificate.  ``sweep`` solves every grid point of
a trade-size frontier in one batched solve and certifies or refines the
whole grid at once.  The solve runs on the card unless ``device="cpu"`` is
passed (with the other solver keywords: ``dtype=``, ``options=``).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional, Sequence

import numpy as np
import torch

from ._device import host
from .models.utility import ConcaveUtility, Objective
from .solver.admm import AdmmOptions, AdmmSolver, RouteResult
from .solver.compiler import PoolTable, ProblemSpec, compile_table
from .utils.profiling import spanned

__all__ = [
    "Route", "Sweep", "arbitrage", "liquidate", "sweep", "route", "make_solver",
    "make_solver_compiled",
]

_LOG = logging.getLogger("cfmm_routing_tpu_torch.api")


@dataclasses.dataclass
class Route:
    """A solved routing: what to tender/receive at every pool."""

    objective: float
    psi: np.ndarray
    prices: np.ndarray
    deltas: List[np.ndarray]  # per pool, spec order
    lambdas: List[np.ndarray]
    iters: int
    converged: bool
    r_norm: float
    s_norm: float
    certificate: Optional[object] = None


@dataclasses.dataclass
class Sweep:
    """Batched solve over a grid of input amounts (price-impact frontier)."""

    amounts: np.ndarray
    utilities: np.ndarray  # u(t) per grid point
    net_trades: List[np.ndarray]  # per pool: (k, T) array of Lambda - Delta
    iters: np.ndarray
    converged: np.ndarray
    prices: Optional[np.ndarray] = None  # (T, n) dual prices per grid point
    certificates: Optional[List[object]] = None  # per-point Certificate


def _table_and_spec(spec_or_table):
    """(PoolTable, the ProblemSpec or None) of a spec or a flat table."""
    if isinstance(spec_or_table, PoolTable):
        return spec_or_table, None
    return PoolTable.from_spec(spec_or_table), spec_or_table


def make_solver(
    spec: ProblemSpec,
    dtype: torch.dtype = torch.float32,
    options: Optional[AdmmOptions] = None,
    device=None,
) -> AdmmSolver:
    """A solver for a :class:`ProblemSpec` or a flat :class:`PoolTable`."""
    table, spec = _table_and_spec(spec)
    return make_solver_compiled(compile_table(table, spec=spec), dtype=dtype,
                                options=options, device=device)


def make_solver_compiled(compiled, dtype: torch.dtype = torch.float32,
                         options: Optional[AdmmOptions] = None,
                         device=None) -> AdmmSolver:
    return AdmmSolver(compiled, dtype=dtype, options=options or AdmmOptions(),
                      device=device)


@spanned("route.result")
def _route_from(solver: AdmmSolver, res, obj, do_certify: bool,
                cert_compiled=None) -> Route:
    deltas, lambdas = solver.unbucket(res)
    cert = None
    if do_certify:
        from .solver.certify import certify as _certify

        cert = _certify(
            cert_compiled if cert_compiled is not None else solver.compiled,
            obj,
            {k: host(v) for k, v in res.deltas.items()},
            {k: host(v) for k, v in res.lambdas.items()},
            host(res.prices),
            psi_claimed=host(res.psi),
            device=solver.device,
        )
    return Route(
        objective=float(host(res.objective)),
        psi=host(res.psi),
        prices=host(res.prices),
        deltas=deltas,
        lambdas=lambdas,
        iters=int(host(res.iters)),
        converged=bool(host(res.converged)),
        r_norm=float(host(res.r_norm)),
        s_norm=float(host(res.s_norm)),
        certificate=cert,
    )


def _refined_route(solver, compiled, solve_objective, res, refine_to,
                   cert_space=None) -> Route:
    """Refine on the solver's device to ``refine_to`` and build the Route
    from the refined point (it always carries its certificate).
    ``cert_space``: the (cert_compiled, cert_objective, unscale_fn) triple
    of a preconditioned solve."""
    from .solver.refine_device import refine_device

    out = refine_device(compiled, solve_objective, res, target_gap=refine_to,
                        cert_space=cert_space, device=solver.device)
    route = _route_from(solver, out.result, solve_objective, False)
    route.certificate = out.certificate
    route.converged = bool(out.achieved)
    # the certificate recomputes the objective from the trades in f64 in
    # the caller's units: authoritative over the solve-space value
    route.objective = float(out.certificate.objective)
    return route


def _floor_options(solver_kwargs, refine_to):
    """Refinement lifts the f32 noise floor but converges at ADMM's usual
    rate: it needs a base iterate at the floor, not a rough one.  When the
    caller asked for a certified gap without choosing options, run the base
    solve to residual 1e-7 (its f32 floor neighbourhood) and say so."""
    if refine_to is not None and "options" not in solver_kwargs:
        _LOG.info(
            "refine_to=%g with no explicit options: running the base solve "
            "to its f32 floor (max_iters=20000, eps=1e-7); pass "
            "options=AdmmOptions(...) to choose the base budget yourself",
            refine_to,
        )
        solver_kwargs = dict(
            solver_kwargs,
            options=AdmmOptions(max_iters=20_000, eps_abs=1e-7, eps_rel=1e-7),
        )
    return solver_kwargs


def _reject(solver, precondition, refine_to):
    if refine_to is not None and not refine_to > 0:
        raise ValueError(f"refine_to must be a positive gap, got {refine_to}")
    if precondition and solver is not None:
        raise ValueError(
            "solver= and precondition=True are mutually exclusive: the "
            "preconditioned path solves in rescaled units and must build "
            "its own solver.  Pass dtype=/options=/device= as keywords "
            "instead."
        )


def _solve_preconditioned(spec, objective, certify, solver_kwargs,
                          refine_to=None) -> Route:
    """Equilibrated solve in scaled units, results in original units; the
    optional certificate (and a refinement's) is evaluated against the
    original problem."""
    from .solver.precondition import equilibrate, unscale_result

    table, spec = _table_and_spec(spec)
    eq = equilibrate(table, objective)
    compiled_eq = compile_table(eq.table, spec=spec)
    solver = make_solver_compiled(compiled_eq, **solver_kwargs)
    res = solver.solve(eq.objective)
    if refine_to is not None:
        return _refined_route(
            solver, compiled_eq, eq.objective, res, refine_to,
            cert_space=(compile_table(table, spec=spec), objective,
                        lambda r: unscale_result(r, eq.d, compiled_eq)),
        )
    res_host = RouteResult(
        *[
            {k: host(v) for k, v in f.items()} if isinstance(f, dict) else host(f)
            for f in res
        ]
    )
    res0 = unscale_result(res_host, eq.d, compiled_eq)
    # the objective in original units (a log atom's scaled value differs by
    # an additive constant)
    if isinstance(objective, ConcaveUtility):
        obj_val = objective.value(res0.psi)
    else:
        obj_val = float(np.asarray(objective.c) @ np.asarray(res0.psi))
    res0 = res0._replace(objective=np.float64(obj_val))
    cert_compiled = compile_table(table, spec=spec) if certify else None
    return _route_from(solver, res0, objective, certify, cert_compiled)


@spanned("route")
def route(
    spec: ProblemSpec,
    objective,
    solver: Optional[AdmmSolver] = None,
    certify: bool = False,
    precondition: bool = False,
    refine_to: Optional[float] = None,
    **solver_kwargs,
) -> Route:
    """Generic routing: maximize an :class:`Objective` (linear + box) or a
    :class:`ConcaveUtility` (separable concave atoms) over the network, a
    :class:`ProblemSpec` or a flat :class:`PoolTable`.
    ``precondition=True`` solves in equilibrated per-asset units
    (``solver/precondition.py``) and returns results (and the optional
    certificate) in the original units.  ``refine_to``: refine on the
    device to that certified relative gap (``solver/refine_device.py``);
    the returned Route carries the certificate."""
    if not isinstance(objective, (Objective, ConcaveUtility)):
        raise TypeError("objective must be an Objective or ConcaveUtility")
    _reject(solver, precondition, refine_to)
    if solver is None:
        solver_kwargs = _floor_options(solver_kwargs, refine_to)
    if precondition:
        return _solve_preconditioned(spec, objective, certify, solver_kwargs,
                                     refine_to=refine_to)
    solver = solver or make_solver(spec, **solver_kwargs)
    res = solver.solve(objective)
    if refine_to is not None:
        return _refined_route(solver, solver.compiled, objective, res, refine_to)
    return _route_from(solver, res, objective, certify)


def arbitrage(
    spec: ProblemSpec,
    market_values: Sequence[float],
    solver: Optional[AdmmSolver] = None,
    certify: bool = False,
    precondition: bool = False,
    refine_to: Optional[float] = None,
    **solver_kwargs,
) -> Route:
    """max market_value @ psi s.t. psi >= 0."""
    return route(spec, Objective.arbitrage(market_values), solver=solver,
                 certify=certify, precondition=precondition,
                 refine_to=refine_to, **solver_kwargs)


def liquidate(
    spec: ProblemSpec,
    holdings: Sequence[float],
    numeraire: int,
    solver: Optional[AdmmSolver] = None,
    certify: bool = False,
    precondition: bool = False,
    refine_to: Optional[float] = None,
    **solver_kwargs,
) -> Route:
    """Liquidate ``holdings`` entirely into asset ``numeraire``."""
    obj = Objective.liquidation(spec.n_assets, numeraire, holdings)
    return route(spec, obj, solver=solver, certify=certify,
                 precondition=precondition, refine_to=refine_to,
                 **solver_kwargs)


def _net_trades(compiled, deltas, lambdas):
    """Per-pool (k, T) net trades Lambda - Delta from batched (T, K, m)
    bucket planes (the reference's ``all_values``, two-asset.py:93-94)."""
    per_pool = [None] * compiled.n_pools
    for name, b in compiled.buckets.items():
        D, L = deltas[name], lambdas[name]
        for r, pid in enumerate(b.pool_ids):
            k = int(compiled.widths[pid])
            per_pool[pid] = (L[:, :k, r] - D[:, :k, r]).T
    return per_pool


@spanned("sweep")
def sweep(
    spec: ProblemSpec,
    give: int,
    receive: int,
    amounts: Sequence[float],
    solver: Optional[AdmmSolver] = None,
    certify: bool = False,
    refine_to: Optional[float] = None,
    **solver_kwargs,
) -> Sweep:
    """Trade-size sweep: u(t) = max psi[receive] s.t. psi >= -t e_give.

    One batched solve over the whole grid (``AdmmSolver.solve_batch``: each
    point with its own stopping test).  ``certify=True`` certifies every
    point in float64 with one :func:`~.solver.certify.certify_batch` call.
    ``refine_to``: refine every point to that certified relative gap with
    :func:`~.solver.refine_device.refine_sweep` (one correction solve per
    pass for the whole grid), then each point the sweep leaves short with
    :func:`~.solver.refine_device.refine_device`; every point then carries
    its certificate."""
    _reject(solver, False, refine_to)
    if solver is None:
        solver_kwargs = _floor_options(solver_kwargs, refine_to)
    solver = solver or make_solver(spec, **solver_kwargs)
    compiled = solver.compiled
    n = spec.n_assets
    amounts = np.asarray(amounts, np.float64)
    T = len(amounts)
    c = np.zeros((T, n))
    c[:, receive] = 1.0
    lo = np.zeros((T, n))
    lo[:, give] = -amounts
    hi = np.full((T, n), np.finfo(np.float32).max / 4)

    res = solver.solve_batch(c, lo, hi)
    dbat = {k: host(v) for k, v in res.deltas.items()}
    lbat = {k: host(v) for k, v in res.lambdas.items()}
    prices = np.array(host(res.prices))
    utilities = np.asarray(host(res.objective), np.float64).copy()
    iters_arr = np.array(host(res.iters))
    conv_arr = np.array(host(res.converged))
    hi_cert = np.full((T, n), np.inf)
    certs = None
    if refine_to is not None:
        from .solver.refine_device import refine_device, refine_sweep

        out = refine_sweep(compiled, c, lo, hi_cert, res, target_gap=refine_to,
                           device=solver.device)
        certs = list(out.certificates)
        utilities[:] = out.objectives
        prices[:] = out.prices
        iters_arr = iters_arr + out.iters
        conv_arr[:] = out.achieved
        # the points the batched refinement left short go one by one
        rho_f = np.broadcast_to(np.asarray(host(res.rho_final)), (T,))
        for t in np.flatnonzero(~out.achieved):
            obj_t = Objective(c[t], lo=lo[t], hi=hi_cert[t])
            point = RouteResult(
                objective=utilities[t],
                psi=np.zeros(n),  # refine_device recomputes it from the trades
                prices=prices[t],
                deltas={k: v[t] for k, v in out.deltas.items()},
                lambdas={k: v[t] for k, v in out.lambdas.items()},
                iters=iters_arr[t], r_norm=np.zeros(()), s_norm=np.zeros(()),
                converged=np.asarray(False), rho_final=rho_f[t],
            )
            out_t = refine_device(compiled, obj_t, point, target_gap=refine_to,
                                  device=solver.device)
            certs[t] = out_t.certificate
            utilities[t] = float(out_t.certificate.objective)
            prices[t] = host(out_t.result.prices)
            conv_arr[t] = bool(out_t.achieved)
            for k in out.deltas:
                out.deltas[k][t] = host(out_t.result.deltas[k])
                out.lambdas[k][t] = host(out_t.result.lambdas[k])
        dbat, lbat = out.deltas, out.lambdas
    elif certify:
        from .solver.certify import certify_batch

        certs = certify_batch(compiled, c, lo, hi_cert, dbat, lbat, prices,
                              psi_claimed=host(res.psi), device=solver.device)
    return Sweep(amounts=amounts, utilities=utilities,
                 net_trades=_net_trades(compiled, dbat, lbat),
                 iters=iters_arr, converged=conv_arr, prices=prices,
                 certificates=certs)
