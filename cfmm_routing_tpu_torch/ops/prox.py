"""Closed-form psi-prox: the consensus z-update of the ADMM.

The z-update  argmin_z G(psi(z)) + (rho/2)||z - v||^2  over all edge copies
reduces exactly (see solver/admm.py) to an n-vector problem

    psi* = argmax_psi  c^T psi - I_box(psi) - (rho/4) sum_j (psi_j - s_j)^2 / d_j

with s = scatter-added edge values and d = per-asset degree.  Because the
quadratic is diagonal and the objective linear, the solution decouples per
asset into "shift then clip":

    psi_j = clip(s_j + (2/rho) d_j c_j, lo_j, hi_j)

Assets touched by no pool (d_j = 0) are pinned to psi_j = 0.
"""
from __future__ import annotations

import torch

__all__ = ["psi_prox"]


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
