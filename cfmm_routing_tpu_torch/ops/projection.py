"""Batched Euclidean projection onto CFMM trading sets (plain PyTorch).

Projection problem (per pool, batched over a slot-major (K, m) bucket):

    minimize_{D, L}  ||D - p||^2 + ||L - q||^2
    s.t.             D >= 0,  L >= 0,
                     phi(R + gamma*D - L) >= phi(R)
                     [x := R + gamma*D - L >= 0   if the pool needs a floor]

KKT structure (mu >= 0 the phi-constraint multiplier, g = grad phi >= 0):

    D_j = relu(p_j + gamma * theta_j)
    L_j = relu(q_j - theta_j)            with  theta_j = mu * g_j (+ floor sigma_j)

For phi = weighted geo-mean, on the active manifold g_j = w_j k0/(x_j+s_j),
so for fixed mu each coordinate solves a scalar hyperbolic fixed point with
a closed-form solution (a 4-region piecewise quadratic — `_inner_gm`).  For
phi = sum, g = 1 and the coordinate maps are piecewise linear.  The only
iteration is a 1-D monotone root-find in mu, done as fixed-trip bisection +
regula-falsi polish with the same trip count across the whole bucket.

These functions are the plain versions of the CUDA kernels in
``csrc/projection.cuh``: the kernels' wrappers (``ops/projection_cuda.py``)
run them on CPU tensors, and the card's results are held against them.
Everything that does not depend on mu (the clip breakpoints of
``_inner_gm``, each clip region's quadratic coefficients, the reserve-floor
multiplier) is computed once before the root-find; the values are the same
as recomputing them at every step.

Shapes: p, q, R, w, s, mask: (K, m);  gamma, logk0, k0: (m,);  out: (K, m).
Works in float32 and float64; the tiny constants follow the dtype.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "ProjectionConfig", "project_gm", "project_cs", "gm_mu_bracket",
    "cs_mu_bracket",
]


class ProjectionConfig(NamedTuple):
    n_bisect: int = 48
    n_polish: int = 6


def _tiny(x: torch.Tensor) -> float:
    return torch.finfo(x.dtype).tiny


def _log_floor(x: torch.Tensor) -> float:
    return 1e-300 if x.dtype == torch.float64 else 1e-30


def _xi_of_theta(p, q, Rp, gamma, theta):
    """xi(theta) = Rp + gamma*relu(p + gamma*theta) - relu(q - theta).

    The (shifted) post-trade reserve as a function of the per-coordinate
    multiplier theta.  Piecewise linear and nondecreasing in theta.
    """
    return Rp + gamma * torch.relu(p + gamma * theta) - torch.relu(q - theta)


def _clip_coeffs(p, q, Rp, gamma, rep):
    """Quadratic coefficients (a, bb) of the clip region containing rep:
      A: both active   xi = Rp + gamma*p - q + (1+g^2) t/xi
      B: L clipped     xi = Rp + gamma*p     + g^2     t/xi
      C: D clipped     xi = Rp - q           +         t/xi
      D: both clipped  xi = Rp
    """
    dclip = (p + gamma * rep) < 0
    lclip = (q - rep) < 0
    a = torch.where(
        dclip,
        torch.where(lclip, Rp, Rp - q),
        torch.where(lclip, Rp + gamma * p, Rp + gamma * p - q),
    )
    zero = torch.zeros_like(p)
    g2 = gamma * gamma * torch.ones_like(p)
    bb = torch.where(
        dclip,
        torch.where(lclip, zero, zero + 1.0),
        torch.where(lclip, g2, 1.0 + g2),
    )
    return a, bb


def _solve_theta_linear(p, q, Rp, gamma, target):
    """Smallest theta with xi_of_theta(theta) == target (piecewise linear).

    Used for reserve-floor clamps: drive the post-trade reserve to the
    floor.  Assumes a root exists (xi(+inf) = +inf).
    """
    g2 = gamma * gamma
    th1 = torch.relu(-p / gamma)
    th2 = torch.relu(q)
    b1 = torch.minimum(th1, th2)
    b2 = torch.maximum(th1, th2)
    in_r1 = _xi_of_theta(p, q, Rp, gamma, b1) >= target
    in_r2 = (~in_r1) & (_xi_of_theta(p, q, Rp, gamma, b2) >= target)
    rep = torch.where(in_r1, 0.5 * b1, torch.where(in_r2, 0.5 * (b1 + b2), b2 + 1.0))
    dclip = (p + gamma * rep) < 0
    lclip = (q - rep) < 0
    thA = (target - Rp - gamma * p + q) / (1.0 + g2)
    thB = (target - Rp - gamma * p) / g2
    thC = target - Rp + q
    thD = 0.5 * (th1 + th2)  # flat region: D = L = 0 regardless of theta
    th = torch.where(dclip, torch.where(lclip, thD, thC), torch.where(lclip, thB, thA))
    return torch.relu(th)


class _GmPrep(NamedTuple):
    """The mu-independent part of the geo-mean coordinate solve."""

    G1: torch.Tensor  # b1 * xi(b1), b1 the lower clip breakpoint
    G2: torch.Tensor  # b2 * xi(b2)
    a: tuple  # quadratic coefficient per clip region (3 tensors)
    bb: tuple
    xi0: torch.Tensor  # xi(theta = 0)
    thf: torch.Tensor  # reserve-floor multiplier (None without a floor)


def _gm_prep(p, q, Rp, gamma, s, needs_floor):
    th1 = torch.relu(-p / gamma)  # D clips below this theta
    th2 = torch.relu(q)  # L clips above this theta
    b1 = torch.minimum(th1, th2)
    b2 = torch.maximum(th1, th2)
    G1 = b1 * _xi_of_theta(p, q, Rp, gamma, b1)
    G2 = b2 * _xi_of_theta(p, q, Rp, gamma, b2)
    regions = [_clip_coeffs(p, q, Rp, gamma, rep)
               for rep in (0.5 * b1, 0.5 * (b1 + b2), b2 + 1.0)]
    xi0 = _xi_of_theta(p, q, Rp, gamma, torch.zeros_like(p))
    thf = _solve_theta_linear(p, q, Rp, gamma, s) if needs_floor else None
    return _GmPrep(
        G1, G2, tuple(r[0] for r in regions), tuple(r[1] for r in regions),
        xi0, thf,
    )


def _stable_quad_root(a, c):
    """Positive root of xi^2 - a*xi - c = 0 (c >= 0), cancellation-safe."""
    sq = torch.sqrt(a * a + 4.0 * c)
    pos = 0.5 * (a + sq)
    neg = (2.0 * c) / torch.clamp_min(sq - a, _tiny(a))
    return torch.where(a > 0, pos, neg)


def _inner_gm(pre: _GmPrep, t):
    """Solve xi = xi_of_theta(theta), theta = t / xi  (t >= 0) in closed form.

    Exactly one clip region is consistent; it is found by bracketing the
    root of G(theta) = theta*xi(theta) - t at the clip breakpoints, then
    that region's quadratic formula applies.  Returns xi > 0 (for t > 0).
    """
    in_r1 = (pre.G1 - t) >= 0
    in_r2 = (~in_r1) & ((pre.G2 - t) >= 0)
    a = torch.where(in_r1, pre.a[0], torch.where(in_r2, pre.a[1], pre.a[2]))
    bb = torch.where(in_r1, pre.bb[0], torch.where(in_r2, pre.bb[1], pre.bb[2]))
    xi = _stable_quad_root(a, bb * t)
    # t == 0: theta = 0 exactly -> direct evaluation (the quadratic form is
    # wrong there for a < 0)
    return torch.where(t > _tiny(t), xi, pre.xi0)


def _eval_gm(mu, p, q, gamma, w, k0, mask, s, pre: _GmPrep, needs_floor,
             want_dl=False):
    """Coordinate solve at multiplier mu (m,): h(mu) = sum_slots w * log xi,
    monotone nondecreasing in mu; with ``want_dl`` also (D, L)."""
    t = mu[None, :] * w * k0[None, :]
    xi = _inner_gm(pre, t)
    theta = None
    if want_dl:
        theta = t / torch.clamp_min(xi, _tiny(xi))
    if needs_floor:
        clamped = xi < s
        if want_dl:
            theta = torch.where(clamped, torch.maximum(pre.thf, theta), theta)
        xi = torch.where(clamped, s, xi)
    h = torch.sum(w * torch.log(torch.clamp_min(xi, _log_floor(xi))), dim=0)
    if not want_dl:
        return h
    D = torch.relu(p + gamma * theta) * mask
    L = torch.relu(q - theta) * mask
    return h, D, L


def _eval_cs(mu, p, q, R, gamma, w, mask, thf, want_dl=False):
    """Weighted constant-sum coordinate solve: theta_j = mu * q_j.

    phi(x) = sum_j q_j x_j (the ``w`` plane holds the raw coefficients q_j;
    1.0 on uniform pools, 0 on padding), so the KKT multiplier enters each
    coordinate as theta_j = mu q_j.  h(mu) = sum_slots q_j x_j, monotone
    nondecreasing in mu.  The reserve floor x >= 0 is clamped in closed
    form through ``thf`` (the multiplier that drives x to 0).
    """
    theta = mu[None, :] * w
    D = torch.relu(p + gamma * theta)
    L = torch.relu(q - theta)
    x = R + gamma * D - L
    theta = torch.where(x < 0, torch.maximum(thf, theta), theta)
    D = torch.relu(p + gamma * theta) * mask
    L = torch.relu(q - theta) * mask
    x = torch.clamp_min(R + gamma * D - L, 0.0) * mask
    h = torch.sum(w * x, dim=0)
    if not want_dl:
        return h
    return h, D, L


def _root_find(h_of_mu, mu_hi, h_target, cfg: ProjectionConfig):
    """Bisection + regula-falsi phases on monotone h(mu) = h_target.

    Returns mu on the feasible side (h >= target).  mu_hi must bracket.
    A fixed trip count: ``cfg.n_bisect`` halvings, then ``cfg.n_polish``
    safeguarded regula-falsi steps.
    """
    tiny = _tiny(mu_hi)
    zero = torch.zeros_like(mu_hi)
    h0 = h_of_mu(zero)
    feasible0 = h0 >= h_target
    lo = zero
    hi = torch.where(feasible0, zero, mu_hi)
    hlo = h0
    hhi = h_of_mu(hi)
    for i in range(cfg.n_bisect + cfg.n_polish):
        if i < cfg.n_bisect:
            frac = 0.5
        else:
            denom = hhi - hlo
            falsi = torch.where(
                torch.abs(denom) > tiny,
                (h_target - hlo) / denom,
                torch.full_like(denom, 0.5),
            )
            frac = torch.clamp(falsi, 0.05, 0.95)
        mid = lo + frac * (hi - lo)
        hm = h_of_mu(mid)
        up = hm < h_target
        lo = torch.where(up, mid, lo)
        hi = torch.where(up, hi, mid)
        hlo = torch.where(up, hm, hlo)
        hhi = torch.where(up, hhi, hm)
    return torch.where(feasible0, zero, hi)


def gm_mu_bracket(p, q, R, w, s, gamma, k0, mask):
    """Upper bracket for the gm multiplier: big enough that every L clips
    to 0, hence xi >= Rp and h >= log k0.  Sufficient per slot:
    t >= max(2 q+ (Rp + gamma p+), 4 q+^2 gamma^2)."""
    Rp = R + s
    qp = torch.relu(q) + 1e-3
    need_t = torch.maximum(
        2.0 * qp * (Rp + gamma * torch.relu(p)), 4.0 * qp * qp * gamma * gamma
    )
    valid = mask > 0
    w_safe = torch.where(valid, w, torch.ones_like(w))
    cand = need_t / (w_safe * torch.clamp_min(k0, _tiny(k0))[None, :])
    cand = torch.where(valid, cand, torch.zeros_like(cand))
    return 4.0 * torch.amax(cand, dim=0) + 1.0


def cs_mu_bracket(q, w, mask):
    """theta_j = mu q_j >= max(q) clips every L to 0 -> x >= R slotwise ->
    sum q x >= sum q R = k0."""
    w_safe = torch.where(mask > 0, w, torch.ones_like(w))
    return torch.amax(torch.relu(q) * mask / w_safe, dim=0) + 1.0


def project_gm(
    p, q, R, w, s, gamma, logk0, k0, mask,
    needs_floor: bool = False,
    cfg: ProjectionConfig = ProjectionConfig(),
):
    """Project (p, q) onto geo-mean trading sets.  Slot-major shapes:
    p/q/R/w/s/mask (K, m); gamma/logk0/k0 (m,).  Returns (D, L) (K, m)."""
    Rp = R + s
    pre = _gm_prep(p, q, Rp, gamma, s, needs_floor)

    def h_of_mu(mu):
        return _eval_gm(mu, p, q, gamma, w, k0, mask, s, pre, needs_floor)

    mu_hi = gm_mu_bracket(p, q, R, w, s, gamma, k0, mask)
    mu = _root_find(h_of_mu, mu_hi, logk0, cfg)
    _, D, L = _eval_gm(mu, p, q, gamma, w, k0, mask, s, pre, needs_floor,
                       want_dl=True)
    return D, L


def project_cs(
    p, q, R, gamma, w, k0, mask,
    cfg: ProjectionConfig = ProjectionConfig(),
):
    """Project (p, q) onto (weighted) constant-sum trading sets (with
    reserve floor).  ``w`` holds the linear coefficients q_j (1.0 uniform).
    Slot-major shapes as in :func:`project_gm`.  Returns (D, L) (K, m)."""
    thf = _solve_theta_linear(p, q, R, gamma, torch.zeros_like(R))

    def h_of_mu(mu):
        return _eval_cs(mu, p, q, R, gamma, w, mask, thf)

    mu_hi = cs_mu_bracket(q, w, mask)
    mu = _root_find(h_of_mu, mu_hi, k0, cfg)
    _, D, L = _eval_cs(mu, p, q, R, gamma, w, mask, thf, want_dl=True)
    return D, L
