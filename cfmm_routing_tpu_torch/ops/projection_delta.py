"""Batched Euclidean projection onto SHIFTED trading sets (plain PyTorch):
the projection of the refinement stage (``solver/refine_device.py``).

An f32 solve floors at a ~1e-5 relative gap because every iteration
evaluates the pool invariant ``phi(R + gamma*D - L) >= phi(R)`` at O(1)-sized
reserves: f32 rounding of the post-trade reserve caps the constraint
residual at ~1e-7 absolute.  This module projects onto the SAME trading set
re-parametrized around a base point (D0, L0) of a completed solve:

    D = D0 + eps * a,   L = L0 + eps * b        (a, b the scaled deltas)

    S = { (a, b) :  a >= aD := -D0/eps,  b >= aL := -L0/eps,
          sum_j w_j log1p(v_j / X0_j) >= nsig },
    v := gamma*a - b,   X0 := (R + s + gamma*D0 - L0)/eps,
    nsig := log k0 - sum_j w_j log(x0_j)      (computed in f64 on the host).

The constraint residual is built from ``log1p`` of O(eps)-relative
quantities with no cancellation, so f32 carries ~eps * 1e-7 absolute
precision on the correction.  v is always rebuilt from theta, never as
``xi - X0`` (that difference would bring the cancellation back).

The math is ``ops/projection.py``'s (the four-region closed-form coordinate
solve, the monotone 1-D root-find in the constraint multiplier) with
per-slot lower bounds (aD, aL) in place of the orthant and the constraint
level nsig in place of log k0.  Constant-sum pools keep the linear
constraint sum_j w_j v_j >= nsig (the scaled linear slack) and the reserve
floor X0 + v >= 0.

These functions are the plain versions of the CUDA delta projection in
``csrc/projection_delta.cuh``: every mu-free term (clip breakpoints,
per-region quadratic coefficients, the reserve-floor multiplier) is computed
once before the root-find as the kernel does, and the per-pool sum over
slots runs slot by slot in the kernel's order, so the two can agree bitwise.

Shapes (slot-major): p, q, X0, w, sS, aD, aL, mask: (K, m); gamma, nsig:
(m,).  Outputs (K, m).  float32 and float64.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .projection import (
    ProjectionConfig, _Consts, _consts, _root_find, _slot_sum, _stable_quad_root,
)

__all__ = ["project_gm_delta", "project_cs_delta"]

_U_FLOOR = -0.999999  # log1p argument clamp
_MARGIN = 1e-3  # bracket headroom


def _ab_from_theta(p, q, gamma, theta, aD, aL):
    """Coordinate maps with general lower bounds: a = max(p + gamma*theta,
    aD), b = max(q - theta, aL)."""
    return torch.maximum(p + gamma * theta, aD), torch.maximum(q - theta, aL)


def _v_of_theta(p, q, gamma, theta, aD, aL):
    """v(theta) = gamma*a(theta) - b(theta): piecewise linear and
    nondecreasing in theta (gamma > 0)."""
    a, b = _ab_from_theta(p, q, gamma, theta, aD, aL)
    return gamma * a - b


def _breakpoints(p, q, gamma, aD, aL):
    th1 = torch.relu((aD - p) / gamma)  # a clips below this theta
    th2 = torch.relu(q - aL)  # b clips above this theta
    return th1, th2, torch.minimum(th1, th2), torch.maximum(th1, th2)


def _solve_theta_linear_delta(p, q, X0, gamma, target, aD, aL):
    """Smallest theta with X0 + v(theta) == target (piecewise linear): the
    reserve-floor clamp."""
    g2 = gamma * gamma
    th1, th2, b1, b2 = _breakpoints(p, q, gamma, aD, aL)
    in_r1 = X0 + _v_of_theta(p, q, gamma, b1, aD, aL) >= target
    in_r2 = (~in_r1) & (X0 + _v_of_theta(p, q, gamma, b2, aD, aL) >= target)
    rep = torch.where(in_r1, 0.5 * b1, torch.where(in_r2, 0.5 * (b1 + b2), b2 + 1.0))
    aclip = (p + gamma * rep) < aD
    bclip = (q - rep) < aL
    thA = (target - X0 - gamma * p + q) / (1.0 + g2)
    thB = (target - X0 - gamma * p + aL) / g2
    thC = target - X0 - gamma * aD + q
    thD = 0.5 * (th1 + th2)  # flat region: both clamped, xi constant
    th = torch.where(aclip, torch.where(bclip, thD, thC), torch.where(bclip, thB, thA))
    return torch.relu(th)


class _GmDeltaPrep(NamedTuple):
    """The mu-independent part of the delta geo-mean coordinate solve."""

    G1: torch.Tensor  # b1 * (X0 + v(b1)), b1 the lower clip breakpoint
    G2: torch.Tensor
    coef: tuple  # quadratic coefficient per clip region (3 tensors)
    bb: tuple
    xi0: torch.Tensor  # X0 + v(0)
    thf: Optional[torch.Tensor]  # reserve-floor multiplier (None without one)
    real: torch.Tensor  # mask > 0
    k: _Consts


def _gm_delta_prep(p, q, X0, gamma, aD, aL, sS, mask, needs_floor):
    _, _, b1, b2 = _breakpoints(p, q, gamma, aD, aL)
    G1 = b1 * (X0 + _v_of_theta(p, q, gamma, b1, aD, aL))
    G2 = b2 * (X0 + _v_of_theta(p, q, gamma, b2, aD, aL))
    coefs, bbs = [], []
    zero = torch.zeros_like(p)
    for rep in (0.5 * b1, 0.5 * (b1 + b2), b2 + 1.0):
        # A: both free     xi = X0 + gamma*p - q   + (1+g^2) t/xi
        # B: b clamped     xi = X0 + gamma*p - aL  + g^2     t/xi
        # C: a clamped     xi = X0 + gamma*aD - q  +         t/xi
        # D: both clamped  xi = X0 + gamma*aD - aL
        aclip = (p + gamma * rep) < aD
        bclip = (q - rep) < aL
        coefs.append(torch.where(
            aclip,
            torch.where(bclip, X0 + gamma * aD - aL, X0 + gamma * aD - q),
            torch.where(bclip, X0 + gamma * p - aL, X0 + gamma * p - q),
        ))
        g2 = gamma * gamma + zero
        bbs.append(torch.where(
            aclip,
            torch.where(bclip, zero, zero + 1.0),
            torch.where(bclip, g2, 1.0 + g2),
        ))
    xi0 = X0 + _v_of_theta(p, q, gamma, zero, aD, aL)
    thf = (_solve_theta_linear_delta(p, q, X0, gamma, sS, aD, aL)
           if needs_floor else None)
    return _GmDeltaPrep(G1, G2, tuple(coefs), tuple(bbs), xi0, thf, mask > 0,
                        _consts(p))


def _inner_gm_delta(pre: _GmDeltaPrep, t):
    """Solve xi = X0 + v(t / xi) in closed form (t >= 0): the clip region
    is 1 if G1 >= t, else 2 if G2 >= t, else 3.  Returns (xi, theta); t <=
    tiny gives theta = 0 exactly and xi = X0 + v(0) (the quadratic form is
    wrong there for coef < 0)."""
    k = pre.k
    in_r1 = (pre.G1 - t) >= k.zero
    in_r2 = (pre.G2 - t) >= k.zero
    coef = torch.where(in_r1, pre.coef[0], torch.where(in_r2, pre.coef[1], pre.coef[2]))
    bb = torch.where(in_r1, pre.bb[0], torch.where(in_r2, pre.bb[1], pre.bb[2]))
    xi = _stable_quad_root(coef, bb * t, k)
    theta = t / torch.clamp_min(xi, k.tiny)
    live = t > k.tiny
    return torch.where(live, xi, pre.xi0), torch.where(live, theta, k.zero)


def _eval_gm_delta(mu, p, q, X0, gamma, w, aD, aL, sS, pre, needs_floor,
                   want_ab=False):
    """Coordinate solve at multiplier mu (m,): h(mu) = sum_slots w *
    log1p(v / X0), monotone nondecreasing in mu; with ``want_ab`` also the
    masked (a, b).  ``sS`` = shift/eps: the reserve floor reads xi >= sS.
    Padding slots (mask 0) contribute exactly 0.  v is rebuilt from theta."""
    t = w * mu
    xi, theta = _inner_gm_delta(pre, t)
    if needs_floor:
        theta = torch.where(xi < sS, torch.maximum(pre.thf, theta), theta)
    a, b = _ab_from_theta(p, q, gamma, theta, aD, aL)
    u = (gamma * a - b) / X0
    h_slot = w * torch.log1p(torch.clamp_min(u, _U_FLOOR))
    h = _slot_sum(torch.where(pre.real, h_slot, pre.k.zero))
    if not want_ab:
        return h
    return h, torch.where(pre.real, a, pre.k.zero), torch.where(pre.real, b, pre.k.zero)


def _gm_delta_bracket(p, q, X0, gamma, w, aD, aL, mask, nsig):
    """Upper bracket for the multiplier: a mu_hi with h(mu_hi) >= nsig.

    Per slot, theta >= theta_req clamps b to aL and lifts v to
    X0 * expm1(max(nsig, 0)) + margin, so every slot has
    w * log1p(v / X0) >= w * max(nsig, 0) (weights sum to 1 per pool).
    t = 2 * theta_req * M with M >= xi(theta_req) puts the root above
    theta_req; mu_hi = max over slots of t / w."""
    vreq = X0 * torch.expm1(torch.relu(nsig))[None, :] + _MARGIN
    th_v = (vreq + aL - gamma * p) / (gamma * gamma)
    th_req = torch.relu(torch.maximum(q - aL, th_v)) + _MARGIN
    a_at = torch.maximum(p + gamma * th_req, aD)
    M = X0 + gamma * torch.abs(a_at) + torch.abs(aL) + 1.0
    t_req = 2.0 * th_req * M
    real = mask > 0
    w_safe = torch.where(real, w, torch.ones_like(w))
    cand = torch.where(real, t_req / w_safe, torch.zeros_like(t_req))
    return torch.amax(cand, dim=0) + 1.0


def project_gm_delta(
    p, q, X0, w, sS, gamma, nsig, aD, aL, mask,
    needs_floor: bool = False,
    cfg: ProjectionConfig = ProjectionConfig(),
):
    """Project (p, q) onto shifted-scaled geo-mean trading sets.

    ``nsig`` = log k0 - sum w log x0: the log-domain slack the delta trades
    must recover (negative when the base point has slack).  Returns the
    scaled delta trades (a, b), (K, m)."""
    gamma_b = gamma[None, :]
    pre = _gm_delta_prep(p, q, X0, gamma_b, aD, aL, sS, mask, needs_floor)

    def h_of_mu(mu):
        return _eval_gm_delta(mu, p, q, X0, gamma_b, w, aD, aL, sS, pre,
                              needs_floor)

    mu_hi = _gm_delta_bracket(p, q, X0, gamma_b, w, aD, aL, mask, nsig)
    mu = _root_find(h_of_mu, mu_hi, nsig, cfg)
    _, a, b = _eval_gm_delta(mu, p, q, X0, gamma_b, w, aD, aL, sS, pre,
                             needs_floor, want_ab=True)
    return a, b


def _cs_delta_theta(mu, p, q, X0, gamma, w, aD, aL, thf, zero):
    theta = w * mu
    if thf is None:
        return theta
    a, b = _ab_from_theta(p, q, gamma, theta, aD, aL)
    return torch.where(X0 + gamma * a - b < zero, torch.maximum(thf, theta), theta)


def _eval_cs_delta(mu, p, q, X0, gamma, w, aD, aL, real, thf, zero,
                   want_ab=False):
    """(Weighted) constant-sum coordinate solve: theta_j = mu * q_j, the
    reserve floor X0 + v >= 0 clamped in closed form through ``thf`` (None:
    no floor).  h(mu) = sum_slots q_j * v_j, monotone nondecreasing; with
    ``want_ab`` also the masked (a, b)."""
    theta = _cs_delta_theta(mu, p, q, X0, gamma, w, aD, aL, thf, zero)
    a, b = _ab_from_theta(p, q, gamma, theta, aD, aL)
    h = _slot_sum(torch.where(real, w * (gamma * a - b), zero))
    if not want_ab:
        return h
    return h, torch.where(real, a, zero), torch.where(real, b, zero)


def project_cs_delta(
    p, q, X0, gamma, w, tgt, aD, aL, mask,
    needs_floor: bool = True,
    cfg: ProjectionConfig = ProjectionConfig(),
):
    """Project (p, q) onto shifted-scaled (weighted) constant-sum sets.

    Constraint: sum_j q_j v_j >= tgt (the scaled linear slack), v = gamma*a
    - b, the reserve floor X0 + v >= 0 (``needs_floor``; the solver and the
    fused kernel always apply it) and the per-slot lower bounds.  ``w``
    holds the linear coefficients q_j.  Returns (a, b), (K, m)."""
    gamma_b = gamma[None, :]
    thf = (_solve_theta_linear_delta(p, q, X0, gamma_b, torch.zeros_like(X0), aD, aL)
           if needs_floor else None)

    real = mask > 0
    zero = _consts(p).zero

    def h_of_mu(mu):
        return _eval_cs_delta(mu, p, q, X0, gamma_b, w, aD, aL, real, thf, zero)

    w_safe = torch.where(real, w, torch.ones_like(w))
    vreq = torch.relu(tgt)[None, :] / w_safe + _MARGIN
    th_v = (vreq + aL - gamma_b * p) / (gamma_b * gamma_b)
    th_req = torch.relu(torch.maximum(q - aL, th_v)) + _MARGIN
    mu_hi = torch.amax(torch.where(real, th_req / w_safe,
                                   torch.zeros_like(th_req)), dim=0) + 1.0
    mu = _root_find(h_of_mu, mu_hi, tgt, cfg)
    _, a, b = _eval_cs_delta(mu, p, q, X0, gamma_b, w, aD, aL, real, thf, zero,
                             want_ab=True)
    return a, b
