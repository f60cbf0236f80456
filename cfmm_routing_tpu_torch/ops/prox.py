"""Closed-form psi-prox: the consensus z-update of the ADMM.

The z-update  argmin_z G(psi(z)) + (rho/2)||z - v||^2  over all edge copies
reduces exactly (see solver/admm.py) to an n-vector problem

    psi* = argmax_psi  U(psi) - I_box(psi) - (rho/4) sum_j (psi_j - s_j)^2 / d_j

with s = scatter-added edge values and d = per-asset degree.  Because the
quadratic is diagonal and U separable, the solution decouples per asset.
For linear U (``psi_prox``) it is "shift then clip":

    psi_j = clip(s_j + (2/rho) d_j c_j, lo_j, hi_j)

``utility_prox`` generalizes to any separable concave utility built from
the atom library below.  1-D concavity means the box-constrained maximizer
is the clipped unconstrained stationary point, so every atom is closed-form
except power (a fixed-trip bracketed bisection plus safeguarded Newton).
Assets touched by no pool (d_j = 0) are pinned to psi_j = 0.

Atom table (per asset j, kind code -> U_j(psi)):

    0  linear      c * psi
    1  quadratic   c * psi - (a/2) * psi^2            (a >= 0)
    2  log         c * log(b + psi)                   (c >= 0, psi > -b)
    3  power       (c/p) * (b + psi)^p                (c >= 0, 0 < p < 1)

``delta_utility_prox`` is the same prox re-centred at a base point for the
refinement stage (``solver/refine_device.py``).

A non-separable :class:`~cfmm_routing_tpu_torch.models.utility.CustomUtility`
has no closed form: ``custom_prox`` runs a fixed-trip strongly-convex FISTA
on its autograd gradient, and ``delta_custom_prox`` does the same re-centred.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils import _pytree as pytree

from ..models.utility import autograd_grad

__all__ = ["psi_prox", "PackedUtility", "utility_prox", "utility_value",
           "DeltaUtility", "delta_utility_prox", "custom_prox",
           "DeltaCustomUtility", "delta_custom_prox"]

# fixed trip counts of the power-atom root-finds
_POWER_BISECT_ITERS = 42
_POWER_NEWTON_ITERS = 6


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def psi_prox(s, degree, c, lo, hi, rho):
    """Linear-utility prox.  All args (n,) except the scalar rho.

    Returns (psi, mu) where mu_j = (psi_j - s_j) / (2 d_j) is the per-asset
    consensus multiplier (the scaled dual price update).
    """
    d_safe = torch.clamp_min(degree, 1.0)
    psi = s + (2.0 / rho) * d_safe * c
    psi = torch.minimum(torch.maximum(psi, lo), hi)
    touched = degree > 0
    zero = torch.zeros_like(psi)
    psi = torch.where(touched, psi, zero)
    mu = (psi - s) / (2.0 * d_safe)
    mu = torch.where(touched, mu, zero)
    return psi, mu


class PackedUtility(NamedTuple):
    """Tensor encoding of a separable concave utility (all (n,)).

    ``kind`` selects the atom per asset (codes above); unused params are 0.
    ``lo``/``hi`` are the box, already clamped to finite float32-safe values
    and to the atom domain ``psi >= -b`` for log/power.  ``has_power``:
    whether any atom is a power atom, known when the utility is packed;
    without one the prox skips the power root-find, whose fixed 48 trips of
    small vector operations would otherwise dominate an iteration's host
    time (the result is the same: the power branch is never selected).
    """

    kind: torch.Tensor  # int32
    c: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    p: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    has_power: bool = True


def _power_root(w, t, cf, p, tiny):
    """Root of  g(y) = w*(y - t) - cf * y^(p-1)  over y > 0  (0 < p < 1).

    Bracketed geometric bisection + safeguarded Newton polish, with fixed
    trip counts.  A plain Newton is not safe: g is concave, so a tangent
    step from the right of the root lands below it, possibly at <= 0 where
    y^(p-1) overflows.  Every extreme power is evaluated in log space with a
    clipped exponent so the bracket stays finite in float32 too.

    Bracket: y* <= HI := max(2t, (2 cf/w)^{1/(2-p)}) and
    y* >= LO := (cf / (w (HI - t)))^{1/(1-p)}.
    """
    cf_s = torch.clamp_min(cf, 1e-30)
    lim = 76.0  # exp(+-76) ~ 1e33 stays finite in float32

    def _pow(base, expo):
        return torch.exp(torch.clamp(expo * torch.log(base), -lim, lim))

    hi = torch.maximum(2.0 * torch.clamp_min(t, 0.0),
                       _pow(2.0 * cf_s / w, 1.0 / (2.0 - p)))
    hi = torch.clamp_min(hi, tiny)
    lo = _pow(cf_s / (w * torch.clamp_min(hi - t, tiny)), 1.0 / (1.0 - p))
    lo = torch.minimum(torch.clamp_min(lo, tiny), hi)

    def g_of(y):
        return w * (y - t) - cf_s * _pow(y, p - 1.0)

    for _ in range(_POWER_BISECT_ITERS):
        mid = torch.sqrt(lo) * torch.sqrt(hi)  # geometric midpoint
        up = g_of(mid) < 0
        lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)

    y = hi
    for _ in range(_POWER_NEWTON_ITERS):
        yp = cf_s * _pow(y, p - 1.0)
        g = w * (y - t) - yp
        gp = w + (1.0 - p) * yp / y
        y = _clip(y - g / gp, lo, hi)
    return y


def utility_prox(s, degree, util: PackedUtility, rho):
    """Separable-concave prox: per asset
    argmax_psi U_j(psi) - (rho / (4 d_j)) (psi - s_j)^2  clipped to the box.

    Branch-free over atom kinds (all four stationary points are evaluated
    and selected); same return contract as :func:`psi_prox`.
    """
    tiny = torch.finfo(s.dtype).tiny
    d_safe = torch.clamp_min(degree, 1.0)
    w = rho / (2.0 * d_safe)  # prox weight: U'(psi) = w * (psi - s)

    kind, c, a, b, p = util.kind, util.c, util.a, util.b, util.p
    # 0: linear      psi = s + c / w
    psi_lin = s + c / w
    # 1: quadratic   c - a*psi = w*(psi - s)
    psi_quad = (c + w * s) / (a + w)
    # 2: log         c/(b+psi) = w*(psi - s): y = b + psi is the positive
    #                root of w*y^2 - w*(s+b)*y - c = 0
    t = s + b
    psi_log = 0.5 * (t + torch.sqrt(t * t + 4.0 * c / w)) - b
    # 3: power       c*y^(p-1) = w*(y - t)
    if util.has_power:
        p_safe = torch.clamp(p, 0.01, 0.99)
        psi_pow = _power_root(w, t, torch.clamp_min(c, 0.0), p_safe, tiny) - b
    else:
        psi_pow = psi_log  # never selected

    psi = torch.where(
        kind == 0, psi_lin,
        torch.where(kind == 1, psi_quad,
                    torch.where(kind == 2, psi_log, psi_pow)),
    )
    psi = _clip(psi, util.lo, util.hi)
    touched = degree > 0
    zero = torch.zeros_like(psi)
    psi = torch.where(touched, psi, zero)
    mu = (psi - s) / (2.0 * d_safe)
    mu = torch.where(touched, mu, zero)
    return psi, mu


def utility_value(util, psi):
    """U(psi) = sum_j U_j(psi_j) (same atom table as :func:`utility_prox`);
    ``util`` a :class:`PackedUtility` or a :class:`DeltaUtility`."""
    tiny = torch.finfo(psi.dtype).tiny
    kind, c, a, b, p = util.kind, util.c, util.a, util.b, util.p
    y = torch.clamp_min(b + psi, tiny)
    p_safe = torch.where(kind == 3, torch.clamp(p, 0.01, 0.99),
                         torch.ones_like(p))
    v = torch.where(
        kind == 0, c * psi,
        torch.where(
            kind == 1, c * psi - 0.5 * a * psi * psi,
            torch.where(kind == 2, c * torch.log(y), (c / p_safe) * y ** p_safe),
        ),
    )
    return torch.sum(v)


class DeltaUtility(NamedTuple):
    """Delta-space separable utility for the re-centred consensus prox
    (``solver/refine_device.py``): the shift+scale-transformed atoms of
    ``_delta_objective`` plus the per-asset fold constant

        e0u := U'_delta(0) - p0      (float64-computed)

    with p0 = rho * nu0 the float32-exact base prices.  ``A`` carries the
    float64 U'_delta(0) itself, which the power atom's stationary solve
    factors out so its marginal-change term

        U'_delta(d) - U'_delta(0) = A * expm1((p-1) * log1p(d / b'))

    is evaluated through expm1/log1p of small arguments, with no
    cancellation.
    """

    kind: torch.Tensor  # int32 transformed atom codes
    c: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    p: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    e0u: torch.Tensor
    A: torch.Tensor  # U'_delta(0), float64-computed (power atoms read it)
    has_power: bool = True  # as in PackedUtility


def _delta_power(du: DeltaUtility, w, t, b_safe, tiny):
    """The power atoms' root of  g(d) = A*expm1((p-1)*log1p(d/b')) - w*d + t
    (g' < 0): fixed-trip bisection on [min(d0, 0), max(d0, 0)], d0 = t/w,
    then safeguarded Newton."""
    p_safe = torch.where(du.kind == 3, torch.clamp(du.p, 0.01, 0.99),
                         torch.full_like(du.p, 0.5))
    A = torch.clamp_min(du.A, 0.0)
    dom_lo = -b_safe * (1.0 - 1e-6)  # domain d > -b'

    def g_of(d):
        em = torch.expm1((p_safe - 1.0) * torch.log1p(d / b_safe))
        return A * em - w * d + t

    d0 = t / w
    plo = torch.maximum(torch.clamp_max(d0, 0.0), dom_lo)
    phi_ = torch.clamp_min(d0, 0.0)
    for _ in range(_POWER_BISECT_ITERS):
        mid = 0.5 * (plo + phi_)
        up = g_of(mid) > 0  # g decreasing: positive -> root above mid
        plo, phi_ = torch.where(up, mid, plo), torch.where(up, phi_, mid)

    d_pow = 0.5 * (plo + phi_)
    for _ in range(_POWER_NEWTON_ITERS):
        em = torch.expm1((p_safe - 1.0) * torch.log1p(d_pow / b_safe))
        g = A * em - w * d_pow + t
        gp = A * (p_safe - 1.0) * (1.0 + em) / torch.clamp_min(
            b_safe + d_pow, tiny) - w
        d_pow = _clip(d_pow - g / gp, plo, phi_)
    return d_pow


def delta_utility_prox(dnu, yhat, degree, du: DeltaUtility, rho):
    """Re-centred separable-concave consensus prox: solve per asset

        U'_delta(d) - U'_delta(0) = w (d - yhat) + q0,
        q0 := rho * dnu - e0u,   w := rho / (2 deg),

    entirely in small quantities (no degree-amplified deg*|nu| product).
    Atom solves:

        linear  U' const:          d = yhat - q0 / w
        quad    U' = c' - a' d:    d = (w yhat - q0) / (w + a')
        log     U' = c'/(b' + d):  the in-domain root of
                w d^2 + [w b' + c'/b' + (q0 - w yhat)] d + b'(q0 - w yhat) = 0,
                taken with the cancellation-safe branch
        power   A * expm1((p-1) * log1p(d/b')) = w (d - yhat) + q0: the left
                side decreases, the right increases, and
                [min(d0, 0), max(d0, 0)] with d0 = t/w brackets the root;
                fixed-trip bisection + safeguarded Newton.

    Returns (d_clipped, dmu) with dmu = dnu + (d - yhat) / (2 deg), the next
    delta dual.
    """
    tiny = torch.finfo(yhat.dtype).tiny
    d_safe = torch.clamp_min(degree, 1.0)
    w = rho / (2.0 * d_safe)
    q0 = rho * dnu - du.e0u
    t = w * yhat - q0  # the common pivot

    kind, c, a, b = du.kind, du.c, du.a, du.b
    d_lin = t / w
    d_quad = t / (w + a)
    b_safe = torch.clamp_min(b, tiny)
    B = w * b_safe + c / b_safe - t
    C = -b_safe * t
    disc = torch.sqrt(torch.clamp_min(B * B - 4.0 * w * C, 0.0))
    d_log = torch.where(
        B > 0.0,
        -2.0 * C / (B + disc),  # larger root, cancellation-safe when B > 0
        (-B + disc) / (2.0 * w),
    )

    d_pow = _delta_power(du, w, t, b_safe, tiny) if du.has_power else d_log

    d_out = torch.where(
        kind == 0, d_lin,
        torch.where(kind == 1, d_quad, torch.where(kind == 2, d_log, d_pow)),
    )
    d_out = _clip(d_out, du.lo, du.hi)
    touched = degree > 0
    zero = torch.zeros_like(d_out)
    d_out = torch.where(touched, d_out, zero)
    dmu = dnu + (d_out - yhat) / (2.0 * d_safe)
    dmu = torch.where(touched, dmu, zero)
    return d_out, dmu


def _fista_consts(degree, rho, L0):
    """(d_safe, w, L, beta) of the strongly-convex FISTA prox: w the prox
    weights rho/(2 d), L = L0 + max w the gradient's Lipschitz bound (L0 a
    Python float or a tensor: no host-to-device copy, which a CUDA-graph
    capture refuses), mu the smallest weight of a touched asset, beta =
    (sqrt L - sqrt mu) / (sqrt L + sqrt mu) the constant momentum."""
    d_safe = torch.clamp_min(degree, 1.0)
    w = rho / (2.0 * d_safe)
    L = torch.max(w) + L0
    mu = torch.min(torch.where(degree > 0, w, torch.full_like(w, float("inf"))))
    mu = torch.where(torch.isfinite(mu), mu, torch.max(w))
    beta = (torch.sqrt(L) - torch.sqrt(mu)) / (torch.sqrt(L) + torch.sqrt(mu))
    return d_safe, w, L, beta


def custom_prox(s, degree, custom, lo, hi, rho):
    """Non-separable consensus prox:
    argmax_psi  U(psi) - sum_j (w_j/2)(psi_j - s_j)^2  over the box,
    with w_j = rho/(2 d_j); only the U term differs from :func:`utility_prox`.

    The objective is a concave U (with -Hessian <= custom.smoothness * I on
    the box) plus a diagonal strongly concave quadratic, so strongly-convex
    FISTA with constant momentum converges linearly at rate 1 - sqrt(mu/L);
    ``custom.prox_iters`` fixed trips, each one gradient of ``custom.fn``
    through ``torch.autograd``.

    Same return contract as :func:`psi_prox`.
    """
    d_safe, w, L, beta = _fista_consts(degree, rho, custom.smoothness)
    y = p_prev = torch.minimum(torch.maximum(s, lo), hi)
    for _ in range(int(custom.prox_iters)):
        g = autograd_grad(custom.fn, y) - w * (y - s)
        p_new = _clip(y + g / L, lo, hi)
        y = p_new + beta * (p_new - p_prev)
        p_prev = p_new
    touched = degree > 0
    zero = torch.zeros_like(p_prev)
    psi = torch.where(touched, p_prev, zero)
    mu = torch.where(touched, (psi - s) / (2.0 * d_safe), zero)
    return psi, mu


class DeltaCustomUtility:
    """Re-centred non-separable utility for the delta-dual iteration
    (``solver/refine_device.py``).

    Wraps a :class:`~cfmm_routing_tpu_torch.models.utility.CustomUtility`
    at a base point:  U_delta(d) = U(psi0 + eps d) / eps,  so
    U'_delta(d) = U'(psi0 + eps d) and the delta duals stay on the original
    price scale.  ``psi0``, ``eps``, ``e0u``, ``lo`` and ``hi`` are the
    pass-varying tensors (a registered pytree's leaves, so a captured block
    takes a new pass's values without a new capture); ``base_fn``,
    ``smoothness`` and ``prox_iters`` are its fixed part.

    ``e0u`` = U'(psi0) [float64] - rho*nu0, the fold constant.  Inside the
    prox the marginal gradient is the difference of two nearby gradient
    calls, grad(psi0 + eps d) - grad(psi0), so the base gradient's rounding
    cancels and only the small change remains, plus the float64 e0u.
    """

    def __init__(self, base_fn, smoothness, prox_iters, psi0, eps, e0u, lo, hi):
        self.base_fn = base_fn
        self.smoothness = float(smoothness)
        self.prox_iters = int(prox_iters)
        self.psi0 = psi0
        self.eps = eps
        self.e0u = e0u
        self.lo = lo
        self.hi = hi

    def fn(self, d):
        """Delta-space objective value (reporting only: certificates
        evaluate the composed point in float64 on the host)."""
        return self.base_fn(self.psi0 + self.eps * d) / self.eps


pytree.register_pytree_node(
    DeltaCustomUtility,
    lambda u: ((u.psi0, u.eps, u.e0u, u.lo, u.hi),
               (u.base_fn, u.smoothness, u.prox_iters)),
    lambda leaves, ctx: DeltaCustomUtility(*ctx, *leaves),
)


def delta_custom_prox(dnu, yhat, degree, dc: DeltaCustomUtility, rho):
    """Re-centred non-separable consensus prox: maximize over the box

        U_delta(d) - (p0 + rho dnu)^T d - sum_j w_j/2 (d_j - yhat_j)^2,
        w_j = rho / (2 deg_j),

    by strongly-convex FISTA (as :func:`custom_prox`) with the gradient
    assembled from small quantities only:

        g(d) = [gradU(psi0 + eps d) - gradU(psi0)] + e0u - rho dnu
               - w (d - yhat).

    Returns (d_clipped, dmu) in delta coordinates (the contract of
    :func:`delta_utility_prox`)."""
    d_safe, w, L, beta = _fista_consts(degree, rho, dc.eps * dc.smoothness)
    g0 = autograd_grad(dc.base_fn, dc.psi0)
    q0 = rho * dnu - dc.e0u
    y = p_prev = _clip(yhat, dc.lo, dc.hi)
    for _ in range(int(dc.prox_iters)):
        dgrad = autograd_grad(dc.base_fn, dc.psi0 + dc.eps * y) - g0
        g = dgrad - q0 - w * (y - yhat)
        p_new = _clip(y + g / L, dc.lo, dc.hi)
        y = p_new + beta * (p_new - p_prev)
        p_prev = p_new
    touched = degree > 0
    zero = torch.zeros_like(p_prev)
    d_out = torch.where(touched, p_prev, zero)
    dmu = torch.where(touched, dnu + (d_out - yhat) / (2.0 * d_safe), zero)
    return d_out, dmu
