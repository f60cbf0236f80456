"""Plain reference of the routing problem: feasibility and a duality bound.

The benchmark judges what the program returns with this file alone.  It
imports neither the program nor JAX: it reads the network as the
generator made it (``gen/synth.py``'s arrays, the request's reserves)
and the program's answer (trades, net trade, objective, prices), and works
out again whatever it needs, in float64 torch on the device it is given.

The problem.  Pool i holds reserves R over its assets.  A trade tenders
D >= 0 and receives L >= 0 per slot; the post-trade reserves are
x = R + gamma D - L.  A geometric-mean pool (kind 0) stays on or above its
curve, sum_j w_j log(x_j + s_j) >= sum_j w_j log(R_j + s_j), with the
weights w normalised to sum 1 and s the virtual-reserve shift; a
constant-sum pool (kind 1) keeps sum_j q_j x_j >= sum_j q_j R_j.  A pool
with ``floor`` set keeps x >= 0 (constant-sum pools always do).  The net
trade is psi = sum_i A_i (L_i - D_i); an objective (c, lo, hi) asks for the
largest c @ psi with lo <= psi <= hi.

The bound.  For any prices nu >= 0 (nu_j >= c_j where hi_j = +inf),

    OPT <= sum_j sup_{lo_j <= psi_j <= hi_j} (c_j - nu_j) psi_j
           + sum_i sup_{trades of pool i} nu @ A_i (L_i - D_i),

and each pool's term is its best arbitrage at prices nu: in closed form
for a constant-sum pool; for a geometric-mean pool the minimum over eta >=
0 of the Lagrangian of its curve constraint, each eta giving a valid
bound (the search below only makes it tight).  The relative gap between
that bound and c @ psi, with psi recomputed from the trades, bounds how far
the answer lies from the optimum.
"""
from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64
_BISECT = 90  # log-space bisection steps on eta (bracket ratio < 1e12)


class Pools:
    """The network laid out as (P, W) slot rows, W the widest pool, in
    float64 on ``device``; padding slots carry mask 0."""

    def __init__(self, net: dict, reserves: np.ndarray, device):
        width = np.asarray(net["width"], np.int64)
        offset = np.asarray(net["offset"], np.int64)
        P, W = len(width), int(width.max())
        rows = np.repeat(np.arange(P), width)
        cols = np.arange(int(width.sum())) - np.repeat(offset, width)
        self.P, self.W, self.n = P, W, int(net["n_assets"])
        self.device = device
        self.rows = torch.as_tensor(rows, device=device)
        self.cols = torch.as_tensor(cols, device=device)

        def plane(v, fill=0.0):
            out = torch.full((P, W), fill, dtype=F64, device=device)
            out[self.rows, self.cols] = torch.as_tensor(
                np.asarray(v, np.float64), device=device)
            return out

        self.mask = plane(np.ones(len(rows)))
        self.R = plane(reserves)
        raw_w = plane(net["weights"])
        self.s = plane(net["shifts"])
        asset = torch.zeros((P, W), dtype=torch.int64, device=device)
        asset[self.rows, self.cols] = torch.as_tensor(
            np.asarray(net["assets"], np.int64), device=device)
        self.asset = asset
        self.gamma = torch.as_tensor(np.asarray(net["fees"], np.float64),
                                     device=device)[:, None]
        self.cs = torch.as_tensor(np.asarray(net["kind"]) == 1, device=device)
        self.floor = torch.as_tensor(
            (np.asarray(net["floor"]) == 1) | (np.asarray(net["kind"]) == 1),
            device=device)
        wsum = raw_w.sum(dim=1, keepdim=True)
        # geometric-mean weights normalised; constant-sum weights raw
        self.w = torch.where(self.cs[:, None], raw_w, raw_w / wsum)
        yR = torch.where(self.mask > 0, self.R + self.s, 1.0)
        self.logk0 = (self.w * torch.log(yR) * self.mask).sum(dim=1)
        self.k0 = (raw_w * self.R).sum(dim=1)

    def slots(self, flat: np.ndarray) -> torch.Tensor:
        """A per-slot array (E,) or (E, T) as (P, W) or (T, P, W) rows."""
        v = torch.as_tensor(np.asarray(flat, np.float64), device=self.device)
        if v.dim() == 1:
            out = torch.zeros((self.P, self.W), dtype=F64, device=self.device)
            out[self.rows, self.cols] = v
            return out
        out = torch.zeros((v.shape[1], self.P, self.W), dtype=F64,
                          device=self.device)
        out[:, self.rows, self.cols] = v.T
        return out

    def net_trade(self, net_slots: torch.Tensor) -> torch.Tensor:
        """psi = sum over slots of (L - D) per asset; (..., P, W) -> (..., n)."""
        lead = net_slots.shape[:-2]
        flat = (net_slots * self.mask).reshape(*lead, -1)
        idx = self.asset.reshape(-1).expand(*lead, -1)
        out = torch.zeros((*lead, self.n), dtype=F64, device=self.device)
        return out.scatter_add_(-1, idx, flat)


def repair_prices(nu, c, lo, hi):
    """Prices at which the box term is finite, as close to ``nu`` as that
    allows: nu_j >= c_j where hi_j = +inf, <= c_j where lo_j = -inf."""
    nu = torch.as_tensor(nu, dtype=F64).clone()
    c, lo, hi = (torch.as_tensor(a, dtype=F64, device=nu.device) for a in (c, lo, hi))
    up = ~torch.isfinite(hi)
    dn = ~torch.isfinite(lo)
    nu = torch.where(up & ~dn, torch.maximum(nu, c), nu)
    nu = torch.where(dn & ~up, torch.minimum(nu, c), nu)
    nu = torch.where(up & dn, c, nu)
    return torch.clamp_min(nu, 0.0)


def box_support(c, lo, hi, nu):
    """sup over lo <= psi <= hi of (c - nu) @ psi, nu repaired."""
    d = c - nu
    finite_lo, finite_hi = torch.isfinite(lo), torch.isfinite(hi)
    take_lo = torch.where(finite_lo, d * torch.where(finite_lo, lo, 0.0), -torch.inf)
    take_hi = torch.where(finite_hi, d * torch.where(finite_hi, hi, 0.0), -torch.inf)
    best = torch.maximum(take_lo, take_hi)
    return torch.where(torch.isfinite(best), best, torch.zeros_like(best)).sum(dim=-1)


def cs_support(pools: Pools, nu_s):
    """Best arbitrage of each constant-sum pool at slot prices ``nu_s``:
    withdraw every asset worth more than its invariant units cost through
    the cheapest deposit, down to x = 0."""
    m = pools.mask > 0
    q = torch.where(m, pools.w, 1.0)
    cheapest = torch.where(m, nu_s / q, torch.inf).amin(dim=-1) / pools.gamma[:, 0]
    gain = torch.clamp_min(nu_s - q * cheapest[..., None], 0.0)
    return torch.where(m, pools.R * gain, 0.0).sum(dim=-1)


def gm_support(pools: Pools, nu_s):
    """Best arbitrage of each geometric-mean pool at slot prices ``nu_s``:
    min over eta >= 0 of the Lagrangian of its curve constraint, each
    coordinate maximised in closed form.  The bisection finds the eta at
    which the maximisers reach the curve; the bound is read at both ends
    of the final bracket and at eta = 0 (the drain), all valid."""
    m = pools.mask > 0
    w = torch.where(m, pools.w, 0.0)
    yR = torch.where(m, pools.R + pools.s, 1.0)
    fl = torch.where(pools.floor[:, None], pools.s, 0.0)
    g = pools.gamma
    positive = torch.where(m, nu_s > 0, True).all(dim=-1)
    nu = torch.where(m & (nu_s > 0), nu_s, 1.0)
    w_safe = torch.where(m, w, 1.0)

    def lagrangian(eta):
        e = eta[..., None]
        y_w = e * w_safe / nu
        y_d = g * y_w
        y = torch.where(y_w < yR, torch.maximum(y_w, fl),
                        torch.where(y_d > yR, y_d, yR))
        y = torch.where(m, y, 1.0)
        profit = torch.where(y <= yR, nu * (yR - y), -(nu / g) * (y - yR))
        h = (w * torch.log(y)).sum(dim=-1)
        value = torch.where(m, profit, 0.0).sum(dim=-1) + eta * (h - pools.logk0)
        return value, h

    ratio = nu * yR / w_safe
    lo = 0.5 * torch.where(m, ratio, torch.inf).amin(dim=-1)
    hi = 2.0 * torch.where(m, ratio, 0.0).amax(dim=-1) / g[:, 0]
    lo, hi = torch.log(lo), torch.log(hi)
    for _ in range(_BISECT):
        mid = 0.5 * (lo + hi)
        _, h = lagrangian(torch.exp(mid))
        below = h < pools.logk0
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    v_lo, _ = lagrangian(torch.exp(lo))
    v_hi, _ = lagrangian(torch.exp(hi))
    drain = torch.where(m, nu_s * (yR - fl), 0.0).sum(dim=-1)
    best = torch.minimum(torch.minimum(v_lo, v_hi), drain)
    best = torch.where(torch.isfinite(best), best, drain)
    return torch.where(positive, best, drain)


def dual_bound(pools: Pools, c, lo, hi, nu):
    """The bound above at prices ``nu`` (repaired); c, lo, hi, nu are (n,)
    or (T, n) tensors, the result () or (T,)."""
    nu = repair_prices(nu, c, lo, hi)
    nu_s = nu[..., pools.asset]
    arb = torch.where(pools.cs, cs_support(pools, nu_s), gm_support(pools, nu_s))
    return box_support(c, lo, hi, nu) + arb.sum(dim=-1)


def curve_shortfall(pools: Pools, x):
    """Per pool, how far post-trade reserves ``x`` (..., P, W) fall short of
    the pool's curve: log-domain for geometric-mean pools, relative to the
    invariant for constant-sum pools; inf where a logarithm's argument is
    not positive."""
    m = pools.mask > 0
    y = x + pools.s
    bad = (m & (y <= 0)).any(dim=-1)
    h = (pools.w * torch.log(torch.where(m & (y > 0), y, 1.0))).sum(dim=-1)
    gm = torch.clamp_min(pools.logk0 - h, 0.0)
    gm = torch.where(bad, torch.inf, gm)
    phi = (torch.where(m, pools.w * x, 0.0)).sum(dim=-1)
    cs = torch.clamp_min(pools.k0 - phi, 0.0) / pools.k0
    return torch.where(pools.cs, cs, gm)


def floor_shortfall(pools: Pools, x):
    """Per slot, (-x)_+ where the pool's floor applies, else 0."""
    m = (pools.mask > 0) & pools.floor[:, None]
    return torch.where(m, torch.clamp_min(-x, 0.0), 0.0)


def asset_scale(pools: Pools, gross_slots, psi):
    """Per asset the scale its token amounts are judged against:
    max(1, |psi_j|, the gross volume traded in asset j), with
    ``gross_slots`` (..., P, W) the volume per slot."""
    return torch.clamp_min(torch.maximum(psi.abs(), pools.net_trade(gross_slots)), 1.0)


def per_slot(pools: Pools, per_asset):
    """A per-asset array (..., n) read at every slot: (..., P, W)."""
    return per_asset[..., pools.asset]


def favourable_post_trade(pools: Pools, net):
    """Post-trade reserves of a net trade (L - D) split the way that leaves
    the pool the most: withdraw where the net is positive, tender where it
    is negative (a split with both D and L > 0 leaves less)."""
    return pools.R - torch.where(net > 0, net, pools.gamma * net)
