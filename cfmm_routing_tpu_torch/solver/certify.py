"""Float64 optimality certification: feasibility + rigorous dual bound.

The ADMM solver produces an (approximately) feasible primal point AND
per-asset dual prices ``nu``; this module turns them into a rigorous
optimality certificate without trusting the solver:

Primal side (float64 on the host):
  * per-pool trading-set residuals  phi(R + g*D - L) >= phi(R)  and
    D, L >= 0;
  * net-trade consistency  psi_hat = sum_i A_i (L_i - D_i)  recomputed
    exactly and compared against the solver's psi;
  * box residuals  lo <= psi_hat <= hi.

Dual side: for ANY price vector nu >= 0 the Lagrangian bound

    OPT <= sup_{lo<=psi<=hi} (c - nu)^T psi  +  sum_i sup_{(D,L) in T_i} nu^T A_i (L - D)

holds.  The per-pool support term is the pool's best arbitrage profit at
prices nu:

  * constant-sum pools: closed form  sum_j R_j (nu_j - q_j min_k nu_k/(g q_k))_+
  * geo-mean pools: inner-dualize the phi constraint with multiplier
    eta >= 0.  The coordinatewise maximizer is closed-form, and the bound
    is valid for EVERY eta >= 0 — so the search for the best eta (float64
    tensors on the solver's device) can never invalidate the certificate,
    only loosen it;
  * both are capped by the drain bound  sum_j nu_j R_j.

``nu`` is repaired before use so the box sup is finite: nu_j := max(nu_j, c_j)
where hi_j = +inf, nu_j := c_j where the asset is unconstrained, nu_j >= 0
everywhere.  The reported gap is therefore a TRUE bound on suboptimality
regardless of how converged the ADMM iterate is.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .._device import host, resolve_device
from ..models.utility import Objective
from .compiler import CompiledProblem

__all__ = ["Certificate", "certify", "dual_bound"]

_TINY = 1e-300
# eta search inside the gm support bound: log-space bisection to isolate a
# linear piece of the piecewise-linear h(log eta), then safeguarded Newton
# (exact within a piece).  The bound is valid for every eta >= 0; the
# search only controls tightness.
_GM_BISECT = 18
_GM_NEWTON = 8


@dataclasses.dataclass
class Certificate:
    """Rigorous optimality certificate for a candidate routing."""

    objective: float  # primal value c^T psi_hat (psi_hat recomputed in f64)
    dual_bound: float  # valid upper bound on the true optimum
    gap_abs: float  # dual_bound - objective  (>= true suboptimality)
    gap_rel: float  # gap_abs / max(1, |objective|, |dual_bound|)
    phi_violation: float  # max_i relative phi shortfall (log-domain for gm)
    nonneg_violation: float  # max_i max(-D, -L)
    floor_violation: float  # max_i (-(R + gD - L))_+ on floor-constrained pools
    box_violation: float  # max_j distance of psi_hat from [lo, hi]
    psi_consistency: float  # max_j |psi_solver - psi_hat|
    prices: np.ndarray  # the repaired price vector the bound was evaluated at
    psi_scale: float = 1.0  # max_j |psi_hat| — global trade scale
    feasibility_rel_value: Optional[float] = None  # per-asset normalized

    @property
    def feasibility(self) -> float:
        return max(
            self.phi_violation,
            self.nonneg_violation,
            self.floor_violation,
            self.box_violation,
        )

    @property
    def feasibility_rel(self) -> float:
        """Feasibility relative to the trade magnitudes: the absolute
        components (nonneg / floor / box, in token units) are normalized per
        asset by that asset's own magnitude max(1, |psi_j|, gross volume_j);
        ``phi_violation`` is already relative."""
        if self.feasibility_rel_value is not None:
            return self.feasibility_rel_value
        abs_part = max(
            self.nonneg_violation, self.floor_violation, self.box_violation
        )
        return max(self.phi_violation, abs_part / max(1.0, self.psi_scale))

    def summary(self) -> str:
        return (
            f"objective={self.objective:.9g}  dual_bound={self.dual_bound:.9g}  "
            f"rel_gap={self.gap_rel:.3e}  feas={self.feasibility:.3e}"
        )


def _box_support(c: np.ndarray, nu: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """sup_{lo<=psi<=hi} (c-nu)^T psi, with nu pre-repaired for finiteness."""
    d = c - nu
    lo_f = np.where(np.isfinite(lo), lo, 0.0)
    hi_f = np.where(np.isfinite(hi), hi, 0.0)
    # d <= 0 wherever hi = +inf and d >= 0 wherever lo = -inf (by repair),
    # so the sup picks the finite endpoint there.
    val = np.maximum(
        np.where(np.isfinite(lo), d * lo_f, -np.inf),
        np.where(np.isfinite(hi), d * hi_f, -np.inf),
    )
    # unconstrained assets have d == 0 exactly after repair
    val = np.where(np.isfinite(val), val, 0.0)
    return float(np.sum(val))


def _repair_prices(
    nu: np.ndarray, c: np.ndarray, lo: np.ndarray, hi: np.ndarray
) -> np.ndarray:
    nu = np.array(nu, dtype=np.float64, copy=True)
    free = ~np.isfinite(lo) & ~np.isfinite(hi)
    nu[free] = c[free]
    up = ~np.isfinite(hi) & ~free
    nu[up] = np.maximum(nu[up], c[up])
    dn = ~np.isfinite(lo) & ~free
    nu[dn] = np.minimum(nu[dn], c[dn])
    return np.maximum(nu, 0.0)


def _gm_bound(nu_s, R, w, s, gamma, logk0, mask, evals=None, device=None):
    """Per-pool arbitrage support bound for geo-mean pools.

    nu_s, R, w, s, mask: (m, K);  gamma, logk0: (m,).  Returns (m,) numpy.

    The bound is valid for EVERY inner multiplier eta >= 0; the float64
    search (log-bisection + safeguarded Newton on the piecewise linear
    h(log eta)) runs as tensors on ``device`` and only controls tightness.
    """
    dev = resolve_device(device)
    nb, nn = evals if evals is not None else (_GM_BISECT, _GM_NEWTON)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                               device=dev)

    nu_s, R, w, s, gamma, logk0, mask = map(t, (nu_s, R, w, s, gamma, logk0, mask))
    valid = mask > 0
    yR = R + s
    nu_safe = torch.where(valid, torch.clamp_min(nu_s, _TINY), 1.0)
    g = gamma[:, None]
    floor_y = s  # x >= 0  <=>  y >= s  (s == 0 for pure gm pools)

    def eval_bound(eta):
        e = eta[:, None]
        y_w = e * w / nu_safe  # withdrawing-regime stationary point
        y_d = g * y_w  # deposit-regime stationary point
        y = torch.where(
            y_w < yR, torch.maximum(y_w, floor_y), torch.where(y_d > yR, y_d, yR)
        )
        y = torch.where(valid, torch.clamp(y, _TINY, 1e300), 1.0)
        h = torch.sum(w * torch.log(y), dim=1)
        dy = yR - y
        profit = torch.where(dy > 0, nu_safe * dy, (nu_safe / g) * dy)
        profit = torch.sum(torch.where(valid, profit, 0.0), dim=1)
        # h is piecewise linear in log(eta): coords on either eta-scaling
        # branch contribute w, clamped (yR / floor) coords contribute 0
        on_eta = ((y_w < yR) & (y_w > floor_y)) | ((y_w >= yR) & (y_d > yR))
        slope = torch.sum(torch.where(on_eta & valid, w, 0.0), dim=1)
        return profit + eta * (h - logk0), h, slope

    hi = torch.amax(
        torch.where(valid, nu_safe * yR / torch.clamp_min(w, 1e-12), 0.0), dim=1
    ) / torch.clamp_max(gamma, 1.0) + 1.0
    lo = hi * 1e-30  # 30-decade bracket for the log-space search

    for _ in range(nb):
        mid = torch.sqrt(lo) * torch.sqrt(hi)  # geometric midpoint
        _, h, _ = eval_bound(mid)
        up = h < logk0
        lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)

    eta = torch.sqrt(lo) * torch.sqrt(hi)
    for _ in range(nn):
        _, h, slope = eval_bound(eta)
        up = h < logk0
        lo = torch.where(up, eta, lo)
        hi = torch.where(up, hi, eta)
        step = (logk0 - h) / torch.clamp_min(slope, 1e-12)
        eta_n = eta * torch.exp(torch.clamp(step, -40.0, 40.0))
        eta_n = torch.minimum(torch.maximum(eta_n, lo), hi)
        # flat piece (slope 0): fall back to the geometric midpoint
        eta = torch.where(slope > 1e-12, eta_n, torch.sqrt(lo) * torch.sqrt(hi))

    b_lo, _, _ = eval_bound(torch.clamp_min(lo, 1e-12))
    b_hi, _, _ = eval_bound(hi)
    drain = torch.sum(torch.where(valid, nu_safe * R, 0.0), dim=1)
    cand = torch.minimum(torch.minimum(b_lo, b_hi), drain)
    cand = torch.where(torch.isfinite(cand), cand, drain)
    return host(cand)


def _cs_bound(nu_s, R, gamma, q, mask):
    """Closed-form (weighted) constant-sum support.

    phi = sum_j q_j x_j: withdrawing L_j and re-depositing through the
    cheapest asset per weighted unit, cstar = min_k nu_k / (g q_k), gives

        bound = sum_j R_j (nu_j - q_j cstar)_+

    (q = 1 recovers the uniform formula).  x >= 0 caps L_j at R_j."""
    q_safe = np.where(mask > 0, q, 1.0)
    ratio = np.where(mask > 0, nu_s / q_safe, np.inf)
    cstar = np.min(ratio, axis=1) / gamma
    gain = np.maximum(nu_s - q_safe * cstar[:, None], 0.0)
    return np.sum(np.where(mask > 0, R * gain, 0.0), axis=1)


def _linear(objective):
    if not isinstance(objective, Objective):
        raise NotImplementedError(
            f"certifying {type(objective).__name__} objectives is not ported "
            "yet (queue 1, item 12 in ROADMAP.md)"
        )
    c = np.asarray(objective.c, np.float64)
    lo = np.asarray(objective.lo, np.float64)
    hi = np.asarray(objective.hi, np.float64)
    return c, lo, hi


def _pool_supports(compiled, nu, evals=None, device=None) -> float:
    nu_ext = np.concatenate([nu, [0.0]])
    total = 0.0
    for _, b in compiled.buckets.items():
        nu_s = nu_ext[b.asset]
        g = b.gamma[:, 0]
        if b.kind == "gm":
            bound = _gm_bound(nu_s, b.reserves, b.weights, b.shift, g, b.logk0,
                              b.mask, evals=evals, device=device)
        else:
            bound = _cs_bound(nu_s, b.reserves, g, b.weights, b.mask)
        total += float(np.sum(bound))
    return total


def dual_bound(
    compiled: CompiledProblem,
    objective: Objective,
    prices: np.ndarray,
    evals=None,
    device=None,
) -> float:
    """Rigorous f64 dual upper bound on the optimum from a price vector
    alone (no trades needed): repaired-nu box support + per-pool arbitrage
    supports.  ``evals``: optional (n_bisect, n_newton) override for the gm
    eta-search — fewer evaluations only loosen the (always valid) bound."""
    c, lo, hi = _linear(objective)
    nu = _repair_prices(np.asarray(host(prices), np.float64), c, lo, hi)
    return _box_support(c, nu, lo, hi) + _pool_supports(
        compiled, nu, evals=evals, device=device
    )


def certify(
    compiled: CompiledProblem,
    objective: Objective,
    deltas: Dict[str, np.ndarray],
    lambdas: Dict[str, np.ndarray],
    prices: np.ndarray,
    psi_claimed: Optional[np.ndarray] = None,
    device=None,
) -> Certificate:
    """Certify a candidate routing.

    deltas/lambdas: bucket name -> slot-major (K, m) arrays or tensors
    (RouteResult layout).  prices: (n,) dual prices (RouteResult.prices).
    ``device``: where the geo-mean support search runs (the card unless
    ``"cpu"`` is given); everything else is float64 numpy on the host.
    """
    n = compiled.n_assets
    c, lo, hi = _linear(objective)

    psi_hat = np.zeros(n + 1)
    gross = np.zeros(n + 1)  # per-asset |D|+|L| volume (row scales)
    nneg_a = np.zeros(n + 1)  # per-asset max absolute violations
    floor_a = np.zeros(n + 1)
    phi_viol = 0.0
    nneg_viol = 0.0
    floor_viol = 0.0
    nu = _repair_prices(np.asarray(host(prices), np.float64), c, lo, hi)

    for name, b in compiled.buckets.items():
        D = np.asarray(host(deltas[name]), np.float64).T  # (m, K)
        L = np.asarray(host(lambdas[name]), np.float64).T
        mask = b.mask
        g = b.gamma[:, 0]
        x = b.reserves + g[:, None] * D - L
        ids = b.asset.reshape(-1)
        nneg_slot = (np.maximum(-D, -L).clip(min=0.0) * mask).reshape(-1)
        nneg_viol = max(nneg_viol, float(np.max(nneg_slot, initial=0.0)))
        np.maximum.at(nneg_a, ids, nneg_slot)
        if b.kind == "gm":
            y = np.where(mask > 0, np.maximum(x + b.shift, _TINY), 1.0)
            h = np.sum(b.weights * np.log(y), axis=1)
            phi_viol = max(phi_viol, float(np.max(b.logk0 - h, initial=0.0)))
        else:
            tot = np.sum(b.weights * np.maximum(x, 0.0), axis=1)
            phi_viol = max(
                phi_viol,
                float(
                    np.max(
                        (b.k0 - tot) / np.maximum(b.k0, 1.0), initial=0.0
                    )
                ),
            )
        if b.needs_floor:
            floor_slot = ((-x).clip(min=0.0) * mask).reshape(-1)
            floor_viol = max(floor_viol, float(np.max(floor_slot, initial=0.0)))
            np.maximum.at(floor_a, ids, floor_slot)
        np.add.at(psi_hat, ids, ((L - D) * mask).reshape(-1))
        np.add.at(gross, ids, ((np.abs(D) + np.abs(L)) * mask).reshape(-1))

    dual_pools = _pool_supports(compiled, nu, device=device)

    psi_hat = psi_hat[:n]
    box_a = np.maximum(lo - psi_hat, psi_hat - hi).clip(min=0.0)
    box_viol = float(np.max(box_a, initial=0.0))
    # per-asset row scales: an asset's violations are judged against ITS
    # OWN magnitude, not the global max net trade
    row_scale = np.maximum(
        1.0, np.maximum(np.abs(psi_hat), gross[:n])
    )
    feas_rel = max(
        phi_viol,
        float(
            np.max(
                np.maximum(nneg_a[:n], np.maximum(floor_a[:n], box_a))
                / row_scale,
                initial=0.0,
            )
        ),
    )
    consistency = (
        float(np.max(np.abs(np.asarray(host(psi_claimed), np.float64) - psi_hat)))
        if psi_claimed is not None
        else 0.0
    )

    primal = float(c @ psi_hat)
    dual = _box_support(c, nu, lo, hi) + dual_pools
    gap = dual - primal
    return Certificate(
        objective=primal,
        dual_bound=dual,
        gap_abs=gap,
        gap_rel=gap / max(1.0, abs(primal), abs(dual)),
        phi_violation=phi_viol,
        nonneg_violation=nneg_viol,
        floor_violation=floor_viol,
        box_violation=box_viol,
        psi_consistency=consistency,
        prices=nu,
        psi_scale=float(np.max(np.abs(psi_hat), initial=0.0)),
        feasibility_rel_value=feas_rel,
    )
