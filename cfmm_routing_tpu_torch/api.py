"""High-level workload API: the reference's routing scripts as one-call fns.

    arbitrage(spec, market_values)        ~ arbitrage.py
    liquidate(spec, holdings, numeraire)  ~ liquidation.py
    route(spec, objective)                ~ any linear objective + box

Each call returns a :class:`Route` with per-pool trades in spec order, the
net trade vector, dual prices, and solver diagnostics; ``certify=True``
adds a float64 certification report (feasibility residuals + duality gap,
``solver/certify.py``).  The solve runs on the card unless ``device="cpu"``
is passed (with the other solver keywords: ``dtype=``, ``options=``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ._device import host
from .models.utility import Objective
from .solver.admm import AdmmOptions, AdmmSolver, RouteResult
from .solver.compiler import PoolTable, ProblemSpec, compile_spec, compile_table

__all__ = [
    "Route", "arbitrage", "liquidate", "route", "make_solver",
    "make_solver_compiled",
]


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


def make_solver(
    spec: ProblemSpec,
    dtype: torch.dtype = torch.float32,
    options: Optional[AdmmOptions] = None,
    device=None,
) -> AdmmSolver:
    return make_solver_compiled(compile_spec(spec), dtype=dtype,
                                options=options, device=device)


def make_solver_compiled(compiled, dtype: torch.dtype = torch.float32,
                         options: Optional[AdmmOptions] = None,
                         device=None) -> AdmmSolver:
    return AdmmSolver(compiled, dtype=dtype, options=options or AdmmOptions(),
                      device=device)


def _route_from(solver: AdmmSolver, res, obj: Objective, do_certify: bool,
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


def _reject(refine_to, solver, precondition):
    if refine_to is not None:
        raise NotImplementedError(
            "refine_to= (device refinement) is slice 2 of the port "
            "(queue 1, item 8 in ROADMAP.md)"
        )
    if precondition and solver is not None:
        raise ValueError(
            "solver= and precondition=True are mutually exclusive: the "
            "preconditioned path solves in rescaled units and must build "
            "its own solver.  Pass dtype=/options=/device= as keywords "
            "instead."
        )


def _solve_preconditioned(spec, objective, certify, solver_kwargs) -> Route:
    """Equilibrated solve in scaled units, results in original units; the
    optional certificate is evaluated against the original problem."""
    from .solver.precondition import equilibrate, unscale_result

    table = PoolTable.from_spec(spec)
    eq = equilibrate(table, objective)
    compiled_eq = compile_table(eq.table, spec=spec)
    solver = make_solver_compiled(compiled_eq, **solver_kwargs)
    res = solver.solve(eq.objective)
    res_host = RouteResult(
        *[
            {k: host(v) for k, v in f.items()} if isinstance(f, dict) else host(f)
            for f in res
        ]
    )
    res0 = unscale_result(res_host, eq.d, compiled_eq)
    obj_val = float(np.asarray(objective.c) @ np.asarray(res0.psi))
    res0 = res0._replace(objective=np.float64(obj_val))
    cert_compiled = compile_table(table, spec=spec) if certify else None
    return _route_from(solver, res0, objective, certify, cert_compiled)


def route(
    spec: ProblemSpec,
    objective: Objective,
    solver: Optional[AdmmSolver] = None,
    certify: bool = False,
    precondition: bool = False,
    refine_to: Optional[float] = None,
    **solver_kwargs,
) -> Route:
    """Generic routing: maximize an :class:`Objective` (linear + box) over
    the network.  ``precondition=True`` solves in equilibrated per-asset
    units (``solver/precondition.py``) and returns results (and the
    optional certificate) in the original units."""
    if not isinstance(objective, Objective):
        raise NotImplementedError(
            f"{type(objective).__name__} objectives are not ported yet "
            "(queue 1, item 12 in ROADMAP.md)"
        )
    _reject(refine_to, solver, precondition)
    if precondition:
        return _solve_preconditioned(spec, objective, certify, solver_kwargs)
    solver = solver or make_solver(spec, **solver_kwargs)
    res = solver.solve(objective)
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
