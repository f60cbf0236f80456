"""Judge of a price-impact frontier (``api.sweep``) against the plain
reference.  A frontier returns, per grid point t, the net trade of every
pool, the utility u(t) = psi_t[receive] and the prices; psi_t is recomputed
from the net trades.  Two numbers, each the worst over the points of the
judged frontiers:

* ``gap``: the larger of |bound_t - psi_t[receive]| and |u(t) -
  psi_t[receive]|, over max(1, |psi_t[receive]|, |bound_t|), the bound the
  reference's at the point's prices with lo = -t e_give.
* ``feas``: each pool's curve shortfall at the post-trade reserves that the
  net trade leaves at best (see ``reference.favourable_post_trade``), and
  the token amounts by which floors or the box are crossed, each over its
  asset's scale max(1, |psi_t,j|, gross volume traded in j).
"""
from __future__ import annotations

import torch

from .. import reference as ref

NUMBERS = ("gap", "feas")


def judge(net: dict, req: dict, ans: dict, device) -> dict:
    pools = ref.Pools(net, req["reserves"], device)
    trades = pools.slots(ans["net"])  # (T, P, W) of L - D
    psi = pools.net_trade(trades)  # (T, n)
    c = torch.as_tensor(req["c"], dtype=ref.F64, device=device)
    lo = torch.as_tensor(req["lo"], dtype=ref.F64, device=device)
    hi = torch.as_tensor(req["hi"], dtype=ref.F64, device=device)
    value = (c * psi).sum(dim=-1)
    bound = ref.dual_bound(pools, c, lo, hi,
                           torch.as_tensor(ans["prices"], dtype=ref.F64,
                                           device=device))
    util = torch.as_tensor(ans["utilities"], dtype=ref.F64, device=device)
    scale = torch.clamp_min(torch.maximum(value.abs(), bound.abs()), 1.0)
    gap = torch.maximum((bound - value).abs(), (util - value).abs()) / scale

    x = ref.favourable_post_trade(pools, trades)
    scale = ref.asset_scale(pools, trades.abs(), psi)  # (T, n)
    box = torch.maximum(torch.clamp_min(lo - psi, 0.0),
                        torch.clamp_min(psi - hi, 0.0)) / scale
    floors = ref.floor_shortfall(pools, x) / ref.per_slot(pools, scale)
    feas = torch.maximum(ref.curve_shortfall(pools, x).amax(dim=-1),
                         torch.maximum(floors.amax(dim=(-2, -1)), box.amax(dim=-1)))
    return {"gap": float(gap.max()), "feas": float(feas.max())}
