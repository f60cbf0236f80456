"""CPU float64 reference oracle (scipy) for correctness certification.

Re-solves the routing program with scipy (SLSQP from several starts, then
trust-constr from the best feasible one and cold), geo-mean constraints in
log form.  It is deliberately slow and simple: its only jobs are
unit-test ground truth for the solver, and high-precision certification of
small instances.  The same algorithm as the JAX package's oracle, on this
package's models.

Problem:

    maximize   c^T psi
    s.t.       lo <= psi <= hi
               psi = sum_i A_i (L_i - D_i)
               (D_i, L_i) >= 0
               phi_i(R_i + gamma_i D_i - L_i) >= phi_i(R_i)   per pool
               [R_i + gamma_i D_i - L_i >= 0 for 'cs'/shifted pools]
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.optimize as sopt

from .models.utility import ConcaveUtility, CustomUtility, Objective
from .solver.compiler import ProblemSpec

__all__ = ["oracle_solve", "OracleResult"]


class OracleResult:
    def __init__(self, objective, psi, deltas, lambdas, status):
        self.objective = objective
        self.psi = psi
        self.deltas = deltas
        self.lambdas = lambdas
        self.status = status


def _unpack(spec: ProblemSpec, x: np.ndarray):
    """Split the flat variable vector into per-pool (D, L)."""
    deltas, lambdas = [], []
    off = 0
    for pool in spec.pools:
        k = pool.width
        deltas.append(x[off : off + k])
        lambdas.append(x[off + k : off + 2 * k])
        off += 2 * k
    return deltas, lambdas


def _psi(spec: ProblemSpec, x: np.ndarray) -> np.ndarray:
    psi = np.zeros(spec.n_assets)
    deltas, lambdas = _unpack(spec, x)
    for pool, D, L in zip(spec.pools, deltas, lambdas):
        for j, a in enumerate(pool.assets):
            psi[a] += L[j] - D[j]
    return psi


def oracle_solve(
    spec: ProblemSpec,
    obj: Objective,
    x0: Optional[np.ndarray] = None,
    maxiter: int = 3000,
    tol: float = 1e-12,
    method: str = "trust-constr",
) -> OracleResult:
    nvar = sum(2 * p.width for p in spec.pools)
    n = spec.n_assets

    # psi(x) is linear: build its matrix  psi = P x
    P = np.zeros((n, nvar))
    off = 0
    for pool in spec.pools:
        k = pool.width
        for j, a in enumerate(pool.assets):
            P[a, off + j] = -1.0  # delta
            P[a, off + k + j] = 1.0  # lambda
        off += 2 * k

    if isinstance(obj, (ConcaveUtility, CustomUtility)):
        # general (separable or custom non-separable) concave utility
        # (models/utility.py) — both expose host value/grad
        def fun(x):
            return -obj.value(P @ x)

        def grad(x):
            return -(P.T @ obj.grad(P @ x))

    else:
        c = obj.c

        def fun(x):
            return -c @ (P @ x)

        def grad(x):
            return -(P.T @ c)

    constraints = [sopt.LinearConstraint(P, obj.lo, obj.hi)]

    off = 0
    for pool in spec.pools:
        k = pool.width
        R, g, w, s = pool.reserves, pool.fee, pool.weights, pool.shift
        sl = slice(off, off + 2 * k)

        if pool.kind == "gm":
            logk0 = float(np.sum(w * np.log(R + s)))

            def phi_con(x, sl=sl, R=R, g=g, w=w, s=s, k=k, logk0=logk0):
                v = x[sl]
                newR = R + g * v[:k] - v[k:] + s
                return np.sum(w * np.log(np.maximum(newR, 1e-300))) - logk0

            def phi_jac(x, sl=sl, R=R, g=g, w=w, s=s, k=k):
                v = x[sl]
                newR = np.maximum(R + g * v[:k] - v[k:] + s, 1e-300)
                J = np.zeros(nvar)
                J[sl.start : sl.start + k] = g * w / newR
                J[sl.start + k : sl.start + 2 * k] = -w / newR
                return J

            constraints.append(
                sopt.NonlinearConstraint(phi_con, 0.0, np.inf, jac=phi_jac)
            )
        else:  # 'cs' (weighted: phi = sum_j q_j x_j, q = pool.weights)
            row = np.zeros(nvar)
            row[sl.start : sl.start + k] = g * w
            row[sl.start + k : sl.start + 2 * k] = -w
            constraints.append(sopt.LinearConstraint(row, 0.0, np.inf))

        if pool.needs_reserve_floor:
            A = np.zeros((k, nvar))
            for j in range(k):
                A[j, sl.start + j] = g
                A[j, sl.start + k + j] = -1.0
            constraints.append(sopt.LinearConstraint(A, -R, np.inf))
        off += 2 * k

    bounds = sopt.Bounds(np.zeros(nvar), np.full(nvar, np.inf))

    def _violation(x) -> float:
        """Max constraint violation (for picking the best run)."""
        v = 0.0
        for con in constraints:
            if isinstance(con, sopt.LinearConstraint):
                val = np.atleast_1d(np.asarray(con.A) @ x)
                v = max(v, float(np.max(np.maximum(con.lb - val, 0.0), initial=0)))
                v = max(v, float(np.max(np.maximum(val - con.ub, 0.0), initial=0)))
            else:
                val = np.atleast_1d(con.fun(x))
                v = max(v, float(np.max(np.maximum(con.lb - val, 0.0), initial=0)))
        v = max(v, float(np.max(np.maximum(-x, 0.0), initial=0)))
        return v

    def _run(x0, meth, it):
        try:
            if meth == "trust-constr":
                return sopt.minimize(
                    fun, x0, jac=grad, bounds=bounds, constraints=constraints,
                    method="trust-constr",
                    options={"maxiter": it, "gtol": 1e-10, "xtol": 1e-14},
                )
            return sopt.minimize(
                fun, x0, jac=grad, bounds=bounds, constraints=constraints,
                method="SLSQP", options={"maxiter": it, "ftol": 1e-14},
            )
        except Exception:
            return None

    starts = [np.full(nvar, 1e-3), np.full(nvar, 0.1), np.full(nvar, 1.0)]
    if x0 is not None:
        starts.insert(0, np.asarray(x0, np.float64))

    best, best_obj = None, -np.inf
    runs = []
    for s in starts:
        runs.append(_run(s, "SLSQP", maxiter))
    # polish the best SLSQP result with trust-constr, and also try
    # trust-constr cold — take the best feasible of everything.
    feas = [r for r in runs if r is not None and _violation(r.x) < 1e-7]
    if feas:
        pivot = max(feas, key=lambda r: -r.fun)
        runs.append(_run(pivot.x, "trust-constr", maxiter))
    runs.append(_run(starts[0], "trust-constr", maxiter))

    for r in runs:
        if r is None:
            continue
        if _violation(r.x) < 1e-7 and -r.fun > best_obj:
            best, best_obj = r, -r.fun
    if best is None:  # fall back to least-infeasible
        cands = [r for r in runs if r is not None]
        if not cands:
            raise RuntimeError("oracle: every solver run crashed")
        best = min(cands, key=lambda r: _violation(r.x))
        best_obj = -best.fun

    deltas, lambdas = _unpack(spec, best.x)
    return OracleResult(
        objective=best_obj,
        psi=_psi(spec, best.x),
        deltas=deltas,
        lambdas=lambdas,
        status=best.status,
    )
