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

A separable :class:`ConcaveUtility` replaces the box support by the sum of
its per-asset concave conjugates  sup_{lo<=psi<=hi} U_j(psi) - nu_j psi
(closed form per atom, :func:`_util_support_grad`), with its own repair of
nu; the pool side is unchanged.  A non-separable :class:`CustomUtility`
brings its own conjugate (a host callable giving an upper bound on
sup_psi U(psi) - nu @ psi over the box); its certificate needs one.

:func:`polish_prices` tightens the bound by minimizing it over nu (L-BFGS-B
with the bound's Danskin subgradient); any nu it returns still gives a
valid bound.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .._device import host, resolve_device
from ..models.utility import ConcaveUtility, CustomUtility, Objective
from .compiler import CompiledProblem

__all__ = ["Certificate", "InfeasibilityCertificate", "certify",
           "certify_batch", "certify_infeasible", "dual_bound", "polish_prices"]

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


def _util_repair_prices(util: ConcaveUtility, nu: np.ndarray) -> np.ndarray:
    """Repair nu so the per-asset concave conjugate is finite.

    Where hi = +inf the sup of U_j(psi) - nu*psi diverges unless
    nu >= lim U'_j: c for linear atoms, 0+ for log/power (U' -> 0), any
    value for strictly quadratic atoms (U' -> -inf).  Mirrors
    :func:`_repair_prices` for the linear case."""
    nu = np.array(nu, dtype=np.float64, copy=True)
    is_lin = (util.kind == 0) | ((util.kind == 1) & (util.a <= 0))
    lo, hi, c = util.lo, util.hi, util.c
    free = is_lin & ~np.isfinite(lo) & ~np.isfinite(hi)
    nu[free] = c[free]
    up = is_lin & ~np.isfinite(hi) & ~free
    nu[up] = np.maximum(nu[up], c[up])
    dn = is_lin & ~np.isfinite(lo) & ~free
    nu[dn] = np.minimum(nu[dn], c[dn])
    curved_up = ((util.kind == 2) | (util.kind == 3)) & ~np.isfinite(hi)
    nu[curved_up] = np.maximum(nu[curved_up], 1e-12)
    return np.maximum(nu, 0.0)


def _util_support_grad(util: ConcaveUtility, nu: np.ndarray):
    """(sup_{lo<=psi<=hi} U(psi) - nu^T psi,  its maximizer psi*) with nu
    pre-repaired.  1-D concavity per asset: the constrained maximizer is
    the clipped stationary point (closed form for every atom); by
    Danskin, d(sup)/d(nu_j) = -psi*_j, the gradient the price polish uses."""
    kind, c, a, b, p = util.kind, util.c, util.a, util.b, util.p
    lo, hi = util.lo, util.hi
    is_lin = (kind == 0) | ((kind == 1) & (a <= 0))

    # linear atoms: endpoint selection (as _box_support)
    d = c - nu
    lo_f = np.where(np.isfinite(lo), lo, 0.0)
    hi_f = np.where(np.isfinite(hi), hi, 0.0)
    take_lo = np.where(np.isfinite(lo), d * lo_f, -np.inf)
    take_hi = np.where(np.isfinite(hi), d * hi_f, -np.inf)
    lin_val = np.maximum(take_lo, take_hi)
    lin_psi = np.where(take_lo >= take_hi, lo_f, hi_f)
    lin_psi = np.where(np.isfinite(lin_val), lin_psi, 0.0)
    lin_val = np.where(np.isfinite(lin_val), lin_val, 0.0)

    # curved atoms: stationary point, then clip into the box
    a_safe = np.maximum(a, 1e-300)
    nu_safe = np.maximum(nu, 1e-300)
    c_safe = np.maximum(c, 1e-300)
    p_safe = np.where(kind == 3, np.clip(p, 0.01, 0.99), 0.5)
    with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
        psi_star = np.where(
            kind == 1, (c - nu) / a_safe,
            np.where(
                kind == 2, c_safe / nu_safe - b,
                (nu_safe / c_safe) ** (1.0 / (p_safe - 1.0)) - b,
            ),
        )
    psi_star = np.clip(psi_star, lo, np.where(np.isfinite(hi), hi, np.inf))
    psi_eval = np.where(is_lin, 0.0, psi_star)  # keep linear assets off the eval
    curved_val = util.value_vec(psi_eval) - nu * psi_eval

    val = float(np.sum(np.where(is_lin, lin_val, curved_val)))
    psi_at = np.where(is_lin, lin_psi, psi_eval)
    return val, psi_at


def _util_support(util: ConcaveUtility, nu: np.ndarray) -> float:
    return _util_support_grad(util, nu)[0]


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


def _gm_bound(nu_s, R, w, s, gamma, logk0, mask, evals=None, device=None,
              want_grad=False):
    """Per-pool arbitrage support bound for geo-mean pools.

    nu_s, R, w, s, mask: (m, K);  gamma, logk0: (m,).  ``nu_s`` may carry
    leading batch axes (T, m, K), the pool data shared across them: one
    batched evaluation then bounds every point.  Returns (m,) numpy,
    or ((m,), (m, K) d(bound)/d(nu_s)) when ``want_grad`` (Danskin
    envelope: the pool's net-trade response at the evaluated multiplier and
    regime, or R where the drain cap binds).

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
        e = eta[..., None]
        y_w = e * w / nu_safe  # withdrawing-regime stationary point
        y_d = g * y_w  # deposit-regime stationary point
        y = torch.where(
            y_w < yR, torch.maximum(y_w, floor_y), torch.where(y_d > yR, y_d, yR)
        )
        y = torch.where(valid, torch.clamp(y, _TINY, 1e300), 1.0)
        h = torch.sum(w * torch.log(y), dim=-1)
        dy = yR - y
        # response = d(profit)/d(nu): dy when withdrawing, dy/g depositing
        resp = torch.where(valid, torch.where(dy > 0, dy, dy / g), 0.0)
        profit = torch.where(dy > 0, nu_safe * dy, (nu_safe / g) * dy)
        profit = torch.sum(torch.where(valid, profit, 0.0), dim=-1)
        # h is piecewise linear in log(eta): coords on either eta-scaling
        # branch contribute w, clamped (yR / floor) coords contribute 0
        on_eta = ((y_w < yR) & (y_w > floor_y)) | ((y_w >= yR) & (y_d > yR))
        slope = torch.sum(torch.where(on_eta & valid, w, 0.0), dim=-1)
        return profit + eta * (h - logk0), h, slope, resp

    hi = torch.amax(
        torch.where(valid, nu_safe * yR / torch.clamp_min(w, 1e-12), 0.0), dim=-1
    ) / torch.clamp_max(gamma, 1.0) + 1.0
    lo = hi * 1e-30  # 30-decade bracket for the log-space search

    for _ in range(nb):
        mid = torch.sqrt(lo) * torch.sqrt(hi)  # geometric midpoint
        _, h, _, _ = eval_bound(mid)
        up = h < logk0
        lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)

    eta = torch.sqrt(lo) * torch.sqrt(hi)
    for _ in range(nn):
        _, h, slope, _ = eval_bound(eta)
        up = h < logk0
        lo = torch.where(up, eta, lo)
        hi = torch.where(up, hi, eta)
        step = (logk0 - h) / torch.clamp_min(slope, 1e-12)
        eta_n = eta * torch.exp(torch.clamp(step, -40.0, 40.0))
        eta_n = torch.minimum(torch.maximum(eta_n, lo), hi)
        # flat piece (slope 0): fall back to the geometric midpoint
        eta = torch.where(slope > 1e-12, eta_n, torch.sqrt(lo) * torch.sqrt(hi))

    b_lo, _, _, r_lo = eval_bound(torch.clamp_min(lo, 1e-12))
    b_hi, _, _, r_hi = eval_bound(hi)
    drain = torch.sum(torch.where(valid, nu_safe * R, 0.0), dim=-1)
    cand = torch.minimum(torch.minimum(b_lo, b_hi), drain)
    cand = torch.where(torch.isfinite(cand), cand, drain)
    if not want_grad:
        return host(cand)
    r_best = torch.where((b_lo <= b_hi)[..., None], r_lo, r_hi)
    R_v = torch.where(valid, R, 0.0)
    grad = torch.where(
        (cand >= drain - 1e-300)[..., None], R_v,
        torch.where(torch.isfinite(r_best), r_best, R_v),
    )
    return host(cand), host(grad)


def _cs_bound(nu_s, R, gamma, q, mask, want_grad=False):
    """Closed-form (weighted) constant-sum support.

    phi = sum_j q_j x_j: withdrawing L_j and re-depositing through the
    cheapest asset per weighted unit, cstar = min_k nu_k / (g q_k), gives

        bound = sum_j R_j (nu_j - q_j cstar)_+

    (q = 1 recovers the uniform formula).  x >= 0 caps L_j at R_j."""
    q_safe = np.where(mask > 0, q, 1.0)
    ratio = np.where(mask > 0, nu_s / q_safe, np.inf)
    cstar = np.min(ratio, axis=1) / gamma
    gain = np.maximum(nu_s - q_safe * cstar[:, None], 0.0)
    bound = np.sum(np.where(mask > 0, R * gain, 0.0), axis=1)
    if not want_grad:
        return bound
    active = (gain > 0.0) & (mask > 0)
    grad = np.where(active, R, 0.0)
    # the argmin (deposited) asset absorbs -sum(active q R)/(g q_kmin)
    kmin = np.argmin(ratio, axis=1)
    qmin = np.take_along_axis(q_safe, kmin[:, None], axis=1)[:, 0]
    dep = -np.sum(np.where(active, q * R, 0.0), axis=1) / (gamma * qmin)
    np.put_along_axis(grad, kmin[:, None], dep[:, None], axis=1)
    return bound, grad


def _linear(objective):
    if not isinstance(objective, Objective):
        raise TypeError("expected an Objective or a ConcaveUtility, got "
                        f"{type(objective).__name__}")
    c = np.asarray(objective.c, np.float64)
    lo = np.asarray(objective.lo, np.float64)
    hi = np.asarray(objective.hi, np.float64)
    return c, lo, hi


def _repaired_support(objective, prices, what="certify"):
    """(repaired nu, the objective's support at nu): the box support of a
    linear Objective, the conjugate sum of a ConcaveUtility, the user
    conjugate of a CustomUtility at nu >= 0."""
    p = np.asarray(host(prices), np.float64)
    if isinstance(objective, CustomUtility):
        if objective.conjugate is None:
            raise ValueError(
                f"{what}(CustomUtility) needs the utility's concave conjugate: "
                "pass conjugate=lambda nu: <rigorous UPPER bound on "
                "sup_psi U(psi) - nu @ psi over the box> — without it only "
                "residual-based stopping is available for custom utilities"
            )
        nu = np.maximum(p, 0.0)
        return nu, float(objective.conjugate(nu))
    if isinstance(objective, ConcaveUtility):
        nu = _util_repair_prices(objective, p)
        return nu, _util_support(objective, nu)
    c, lo, hi = _linear(objective)
    nu = _repair_prices(p, c, lo, hi)
    return nu, _box_support(c, nu, lo, hi)


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
    objective,
    prices: np.ndarray,
    evals=None,
    device=None,
) -> float:
    """Rigorous f64 dual upper bound on the optimum from a price vector
    alone (no trades needed): repaired-nu box (or utility) support +
    per-pool arbitrage supports.  ``evals``: optional (n_bisect, n_newton)
    override for the gm eta-search — fewer evaluations only loosen the
    (always valid) bound.  A :class:`CustomUtility` needs its conjugate."""
    nu, support = _repaired_support(objective, prices, "dual_bound")
    return support + _pool_supports(compiled, nu, evals=evals, device=device)


def certify(
    compiled: CompiledProblem,
    objective,
    deltas: Dict[str, np.ndarray],
    lambdas: Dict[str, np.ndarray],
    prices: np.ndarray,
    psi_claimed: Optional[np.ndarray] = None,
    device=None,
) -> Certificate:
    """Certify a candidate routing.

    ``objective``: an :class:`Objective`, a :class:`ConcaveUtility` or a
    :class:`CustomUtility` with its conjugate (``ValueError`` without one).
    deltas/lambdas: bucket name -> slot-major (K, m) arrays or tensors
    (RouteResult layout).  prices: (n,) dual prices (RouteResult.prices).
    ``device``: where the geo-mean support search runs (the card unless
    ``"cpu"`` is given); everything else is float64 numpy on the host.
    """
    n = compiled.n_assets
    nu, support = _repaired_support(objective, prices)
    lo = np.asarray(objective.lo, np.float64)
    hi = np.asarray(objective.hi, np.float64)

    psi_hat = np.zeros(n + 1)
    gross = np.zeros(n + 1)  # per-asset |D|+|L| volume (row scales)
    nneg_a = np.zeros(n + 1)  # per-asset max absolute violations
    floor_a = np.zeros(n + 1)
    phi_viol = 0.0
    nneg_viol = 0.0
    floor_viol = 0.0

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

    if isinstance(objective, (ConcaveUtility, CustomUtility)):
        primal = objective.value(psi_hat)
    else:
        primal = float(np.asarray(objective.c, np.float64) @ psi_hat)
    dual = support + dual_pools
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


def _dual_value_and_grad(compiled, c, lo, hi, nu, device=None, util=None,
                         custom=None):
    """g(nu) = box (or ``util``'s conjugate) support + sum of pool supports,
    with its subgradient.

    grad g = -psi*(nu) + sum_i (pool i's net-trade response at nu): the
    market's excess supply at prices nu.  g is convex and minimized where
    the market clears; any nu in the repair box gives a VALID bound, so a
    minimizer only ever tightens the certificate.

    ``custom``: a CustomUtility, whose conjugate value is the user's; its
    gradient is taken by central finite differences (the pool-side
    gradients stay analytic), accurate enough to drive the L-BFGS search —
    rigor never depends on it, every evaluated nu gives a valid bound."""
    if custom is not None:
        n = compiled.n_assets
        g_val = float(custom.conjugate(nu))
        grad = np.zeros(n)
        h = 1e-6 * np.maximum(1.0, np.abs(nu))
        for j in range(n):
            nu_p = nu.copy()
            nu_m = nu.copy()
            nu_p[j] += h[j]
            nu_m[j] = max(nu_m[j] - h[j], 0.0)
            step = nu_p[j] - nu_m[j]
            if step > 0:
                grad[j] = (float(custom.conjugate(nu_p))
                           - float(custom.conjugate(nu_m))) / step
        return _add_pool_terms(compiled, nu, g_val, grad, device)
    if util is not None:
        g_val, psi_at = _util_support_grad(util, nu)
        return _add_pool_terms(compiled, nu, g_val, -psi_at, device)
    d = c - nu
    lo_f = np.where(np.isfinite(lo), lo, 0.0)
    hi_f = np.where(np.isfinite(hi), hi, 0.0)
    take_lo = np.where(np.isfinite(lo), d * lo_f, -np.inf)
    take_hi = np.where(np.isfinite(hi), d * hi_f, -np.inf)
    psi_box = np.where(take_lo >= take_hi, lo_f, hi_f)
    val = np.maximum(take_lo, take_hi)
    psi_box = np.where(np.isfinite(val), psi_box, 0.0)
    g_val = float(np.sum(np.where(np.isfinite(val), val, 0.0)))
    return _add_pool_terms(compiled, nu, g_val, -psi_box, device)


def _add_pool_terms(compiled, nu, g_val, grad, device):
    """Add every pool's support bound and its Danskin gradient to
    (g_val, grad)."""
    n = compiled.n_assets
    grad = np.array(grad, np.float64)
    nu_ext = np.concatenate([nu, [0.0]])
    acc = np.zeros(n + 1)
    for _, b in compiled.buckets.items():
        nu_s = nu_ext[b.asset]
        gam = b.gamma[:, 0]
        if b.kind == "gm":
            bound, gb = _gm_bound(nu_s, b.reserves, b.weights, b.shift, gam,
                                  b.logk0, b.mask, device=device, want_grad=True)
        else:
            bound, gb = _cs_bound(nu_s, b.reserves, gam, b.weights, b.mask,
                                  want_grad=True)
        g_val += float(np.sum(bound))
        np.add.at(acc, b.asset.reshape(-1), gb.reshape(-1))
    grad += acc[:n]
    return g_val, grad


def polish_prices(
    compiled: CompiledProblem,
    objective,
    nu0: np.ndarray,
    max_evals: int = 200,
    device=None,
) -> np.ndarray:
    """Tighten the dual bound by minimizing g(nu) from ``nu0`` (L-BFGS-B).

    Returns whichever prices give the LOWER bound; rigor is free because
    every repaired nu >= 0 yields a valid bound.  Linear ``Objective``s,
    separable ``ConcaveUtility``s (their conjugate and its Danskin gradient
    are closed-form, :func:`_util_support_grad`) and ``CustomUtility``s
    with a conjugate (a finite-difference conjugate gradient; without a
    conjugate ``nu0`` comes back as it is).  ``device``: where the geo-mean
    support search runs (the card unless ``"cpu"`` is given)."""
    from scipy.optimize import minimize

    if isinstance(objective, CustomUtility):
        if objective.conjugate is None:
            return np.asarray(host(nu0), np.float64)
        n = compiled.n_assets

        def fun_c(x):  # the custom branch reads no c / lo / hi
            return _dual_value_and_grad(compiled, None, None, None,
                                        np.maximum(x, 0.0), device=device,
                                        custom=objective)

        x0 = np.maximum(np.asarray(host(nu0), np.float64), 0.0)
        g0, _ = fun_c(x0)
        res = minimize(fun_c, x0, jac=True, method="L-BFGS-B",
                       bounds=[(0.0, None)] * n,
                       options=dict(maxfun=max_evals, maxiter=max_evals))
        if np.all(np.isfinite(res.x)):
            xr = np.maximum(res.x, 0.0)
            g1, _ = fun_c(xr)
            if g1 < g0:
                return xr
        return x0

    util = objective if isinstance(objective, ConcaveUtility) else None
    if util is not None:
        # finiteness box of the separable conjugate: linear-behaving atoms
        # anchor to c (as below); curved atoms with hi=inf need nu > 0 only
        c = np.asarray(util.c, np.float64)
        lo = np.asarray(util.lo, np.float64)
        hi = np.asarray(util.hi, np.float64)
        is_lin = (util.kind == 0) | ((util.kind == 1) & (util.a <= 0))
        lb = np.where(is_lin & ~np.isfinite(hi), c, 0.0)
        ub = np.where(is_lin & ~np.isfinite(lo), c, np.inf)
        lb = np.where(~is_lin & ~np.isfinite(hi), 1e-12, lb)
        x0 = _util_repair_prices(util, np.asarray(host(nu0), np.float64))
    else:
        c, lo, hi = _linear(objective)
        # the repair box keeps the box support finite: nu >= c where
        # hi=inf, nu <= c where lo=-inf, nu == c where both, nu >= 0
        lb = np.where(np.isfinite(hi), 0.0, c)
        ub = np.where(np.isfinite(lo), np.inf, c)
        x0 = _repair_prices(np.asarray(host(nu0), np.float64), c, lo, hi)
    lb = np.maximum(lb, 0.0)
    ub = np.maximum(ub, lb)
    x0 = np.clip(x0, lb, ub)

    def fun(x):
        return _dual_value_and_grad(compiled, c, lo, hi, x, device=device,
                                    util=util)

    g0, _ = fun(x0)
    res = minimize(
        fun, x0, jac=True, method="L-BFGS-B",
        bounds=list(zip(lb, np.where(np.isfinite(ub), ub, None))),
        options=dict(maxfun=max_evals, maxiter=max_evals),
    )
    if np.all(np.isfinite(res.x)):
        xr = np.clip(res.x, lb, ub)
        g1, _ = fun(xr)
        if g1 < g0:
            return xr
    return x0


@dataclasses.dataclass
class InfeasibilityCertificate:
    """Rigorous primal-infeasibility certificate (separating prices).

    The primal is feasible iff the Minkowski sum of the pools' net-trade
    sets meets the psi box.  For ANY price direction u >= 0 (zero where
    lo = -inf),

        margin(u) = sum_i sigma_i(u) - sum_j u_j lo_j
                  = [most value the pools can emit at prices u]
                    - [value the box demands at prices u]

    and ``margin < 0`` PROVES that no feasible point exists; the separating
    direction itself is returned as evidence."""

    margin: float  # < 0 proves infeasibility
    infeasible: bool
    prices: np.ndarray  # the separating direction u (||u||_inf = 1)

    def summary(self) -> str:
        verdict = "INFEASIBLE" if self.infeasible else "inconclusive"
        return f"{verdict}: margin={self.margin:.6g} at ||u||_inf=1"


def certify_infeasible(
    compiled: CompiledProblem,
    objective,
    prices: np.ndarray,
    device=None,
) -> InfeasibilityCertificate:
    """Attempt an infeasibility certificate from a candidate direction.

    ``prices`` is typically the (diverging) ADMM dual iterate: for an
    infeasible program the scaled dual grows along a separating direction.
    The candidate is sanitized so both sides of the margin are finite:
    clipped to u >= 0 (a pool's support is +inf at a negative price) and
    zeroed where lo_j = -inf.  The margin is rigorous for the sanitized u;
    ``infeasible=False`` only ever means "inconclusive".  ``device``: where
    the geo-mean support search runs (the card unless ``"cpu"``)."""
    lo = np.asarray(objective.lo, np.float64)
    u = np.maximum(np.asarray(host(prices), np.float64), 0.0)
    u = np.where(np.isfinite(lo), u, 0.0)
    scale = float(np.max(u, initial=0.0))
    if not np.isfinite(scale) or scale <= 0.0:
        return InfeasibilityCertificate(margin=np.inf, infeasible=False, prices=u)
    u = u / scale
    support = _pool_supports(compiled, u, device=device)
    demand = float(np.sum(np.where(u > 0, u * lo, 0.0)))
    margin = support - demand
    return InfeasibilityCertificate(margin=margin, infeasible=bool(margin < 0.0),
                                    prices=u)


def certify_batch(
    compiled: CompiledProblem,
    c,
    lo,
    hi,
    deltas: Dict[str, np.ndarray],
    lambdas: Dict[str, np.ndarray],
    prices: np.ndarray,
    psi_claimed: Optional[np.ndarray] = None,
    device=None,
):
    """Certify T candidate routings at once (linear objectives).

    ``c``/``lo``/``hi``/``prices``: (T, n); ``deltas``/``lambdas``: bucket
    name -> (T, K, m); ``psi_claimed``: optional (T, n).  Returns a list of
    T :class:`Certificate`, each as rigorous as :func:`certify`'s: the same
    math, float64 numpy feasibility broadcast over T, and the geo-mean dual
    bound as one batched float64 torch evaluation on ``device`` (the card
    unless ``"cpu"``)."""
    n = compiled.n_assets
    c = np.asarray(c, np.float64)
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    T = c.shape[0]

    nu = np.array(host(prices), dtype=np.float64, copy=True)  # (T, n)
    free = ~np.isfinite(lo) & ~np.isfinite(hi)
    nu[free] = c[free]
    up = ~np.isfinite(hi) & ~free
    nu[up] = np.maximum(nu[up], c[up])
    dn = ~np.isfinite(lo) & ~free
    nu[dn] = np.minimum(nu[dn], c[dn])
    nu = np.maximum(nu, 0.0)
    nu_ext = np.concatenate([nu, np.zeros((T, 1))], axis=1)

    psi_hat = np.zeros((T, n + 1))
    gross = np.zeros((T, n + 1))
    nneg_a = np.zeros((T, n + 1))
    floor_a = np.zeros((T, n + 1))
    phi_viol = np.zeros(T)
    nneg_viol = np.zeros(T)
    floor_viol = np.zeros(T)
    dual_pools = np.zeros(T)
    for name, b in compiled.buckets.items():
        D = np.swapaxes(np.asarray(host(deltas[name]), np.float64), 1, 2)  # (T,m,K)
        L = np.swapaxes(np.asarray(host(lambdas[name]), np.float64), 1, 2)
        mask = b.mask[None]
        g = b.gamma[:, 0][None, :, None]
        x = b.reserves[None] + g * D - L
        nneg_slot = (np.maximum(-D, -L).clip(min=0.0) * mask).reshape(T, -1)
        nneg_viol = np.maximum(nneg_viol, np.max(nneg_slot, axis=1, initial=0.0))
        if b.kind == "gm":
            y = np.where(mask > 0, np.maximum(x + b.shift[None], _TINY), 1.0)
            h = np.sum(b.weights[None] * np.log(y), axis=2)  # (T, m)
            phi_viol = np.maximum(
                phi_viol, np.max(b.logk0[None] - h, axis=1, initial=0.0))
        else:
            tot = np.sum(b.weights[None] * np.maximum(x, 0.0), axis=2)
            phi_viol = np.maximum(phi_viol, np.max(
                (b.k0[None] - tot) / np.maximum(b.k0[None], 1.0),
                axis=1, initial=0.0))
        flat_ids = b.asset.reshape(-1)
        idx = (flat_ids[None, :] + (n + 1) * np.arange(T)[:, None]).reshape(-1)
        np.maximum.at(nneg_a.reshape(-1), idx, nneg_slot.reshape(-1))
        if b.needs_floor:
            floor_slot = ((-x).clip(min=0.0) * mask).reshape(T, -1)
            floor_viol = np.maximum(floor_viol,
                                    np.max(floor_slot, axis=1, initial=0.0))
            np.maximum.at(floor_a.reshape(-1), idx, floor_slot.reshape(-1))
        vals = ((L - D) * mask).reshape(-1)
        psi_hat += np.bincount(idx, weights=vals,
                               minlength=T * (n + 1)).reshape(T, n + 1)
        gross += np.bincount(
            idx, weights=((np.abs(D) + np.abs(L)) * mask).reshape(-1),
            minlength=T * (n + 1),
        ).reshape(T, n + 1)

        nu_s = nu_ext[:, b.asset]  # (T, m, K)
        gam = b.gamma[:, 0]
        if b.kind == "gm":
            dual_pools += np.sum(_gm_bound(
                nu_s, b.reserves, b.weights, b.shift, gam, b.logk0, b.mask,
                device=device), axis=1)
        else:
            q_safe = np.where(b.mask[None] > 0, b.weights[None], 1.0)
            ratio = np.where(b.mask[None] > 0, nu_s / q_safe, np.inf)
            cstar = np.min(ratio, axis=2) / gam[None]
            gain = np.maximum(nu_s - q_safe * cstar[..., None], 0.0)
            dual_pools += np.sum(
                np.where(b.mask[None] > 0, b.reserves[None] * gain, 0.0),
                axis=(1, 2),
            )

    psi_hat = psi_hat[:, :n]
    box_a = np.maximum(lo - psi_hat, psi_hat - hi).clip(min=0.0)
    box_viol = np.max(box_a, axis=1, initial=0.0)
    row_scale = np.maximum(1.0, np.maximum(np.abs(psi_hat), gross[:, :n]))
    feas_rel = np.maximum(phi_viol, np.max(
        np.maximum(nneg_a[:, :n], np.maximum(floor_a[:, :n], box_a)) / row_scale,
        axis=1, initial=0.0))
    cons = (np.max(np.abs(np.asarray(host(psi_claimed), np.float64) - psi_hat),
                   axis=1)
            if psi_claimed is not None else np.zeros(T))

    d = c - nu
    lo_f = np.where(np.isfinite(lo), lo, 0.0)
    hi_f = np.where(np.isfinite(hi), hi, 0.0)
    val = np.maximum(
        np.where(np.isfinite(lo), d * lo_f, -np.inf),
        np.where(np.isfinite(hi), d * hi_f, -np.inf),
    )
    box_support = np.sum(np.where(np.isfinite(val), val, 0.0), axis=1)

    primal = np.sum(c * psi_hat, axis=1)
    dual = box_support + dual_pools
    gap = dual - primal
    return [
        Certificate(
            objective=float(primal[t]),
            dual_bound=float(dual[t]),
            gap_abs=float(gap[t]),
            gap_rel=float(gap[t] / max(1.0, abs(primal[t]), abs(dual[t]))),
            phi_violation=float(phi_viol[t]),
            nonneg_violation=float(nneg_viol[t]),
            floor_violation=float(floor_viol[t]),
            box_violation=float(box_viol[t]),
            psi_consistency=float(cons[t]),
            prices=nu[t],
            psi_scale=float(np.max(np.abs(psi_hat[t]), initial=0.0)),
            feasibility_rel_value=float(feas_rel[t]),
        )
        for t in range(T)
    ]
