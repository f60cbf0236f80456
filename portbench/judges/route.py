"""Judge of a route (``api.route``) against the plain reference.

Two numbers, each the worst over the judged routes:

* ``gap``: the larger of |bound - c @ psi| and |objective - c @ psi|, over
  max(1, |c @ psi|, |bound|), where psi is recomputed from the returned
  trades and the bound the reference's at the returned prices or at those
  of the route's certificate, whichever bound is lower (any prices give a
  valid bound).  It judges the prices, the trades' value and the objective
  reported.
* ``feas``: the largest of the pools' curve shortfall (log-domain or
  relative) and of the token amounts by which trades go negative, floors
  or the box are crossed, or the reported net trade departs from psi, each
  over its asset's scale max(1, |psi_j|, gross volume traded in j).  It
  judges the trades and the net trade.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import reference as ref

NUMBERS = ("gap", "feas")


def judge(net: dict, req: dict, ans: dict, device) -> dict:
    pools = ref.Pools(net, req["reserves"], device)
    D, L = pools.slots(ans["D"]), pools.slots(ans["L"])
    c = torch.as_tensor(req["c"], dtype=ref.F64, device=device)
    lo = torch.as_tensor(req["lo"], dtype=ref.F64, device=device)
    hi = torch.as_tensor(req["hi"], dtype=ref.F64, device=device)
    psi = pools.net_trade(L - D)
    value = float(c @ psi)
    bound = min(float(ref.dual_bound(pools, c, lo, hi, torch.as_tensor(
        nu, dtype=ref.F64, device=device)))
        for nu in (ans["prices"], ans.get("cert_prices")) if nu is not None)
    scale = max(1.0, abs(value), abs(bound))
    gap = max(abs(bound - value), abs(float(ans["objective"]) - value)) / scale

    x = pools.R + pools.gamma * D - L
    scale = ref.asset_scale(pools, D.abs() + L.abs(), psi)
    slot_scale = ref.per_slot(pools, scale)
    m = pools.mask > 0
    negative = torch.where(m, torch.clamp_min(-torch.minimum(D, L), 0.0), 0.0)
    reported = torch.as_tensor(np.asarray(ans["psi"], np.float64), device=device)
    box = torch.maximum(torch.clamp_min(lo - psi, 0.0), torch.clamp_min(psi - hi, 0.0))
    feas = max(float(ref.curve_shortfall(pools, x).max()),
               float(((negative + ref.floor_shortfall(pools, x)) / slot_scale).max()),
               float((box / scale).max()),
               float(((reported - psi).abs() / scale).max()))
    return {"gap": gap, "feas": feas}
