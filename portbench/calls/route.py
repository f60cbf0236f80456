"""``api.route`` on a new block state: the arbitrage route at the drifted
prices, equilibrated and refined to the mix's certified gap."""
from __future__ import annotations

import numpy as np

from . import common


def call(net: dict, req: dict, traffic: dict, device=None, control=False):
    """One request through the program's public entry.  ``control`` drops
    the float64 refinement: the float32 base route alone."""
    from cfmm_routing_tpu_torch import api
    from cfmm_routing_tpu_torch.models.utility import Objective

    return api.route(common.table(net, req["reserves"]),
                     Objective.arbitrage(req["prices"]),
                     precondition=bool(traffic["precondition"]),
                     refine_to=None if control else traffic["refine_to"],
                     options=common.options(traffic), **common.device_kw(device))


def certified(out) -> bool:
    """Whether the program reports the route as certified."""
    return bool(out.converged)


def answer(out) -> dict:
    """The route as plain arrays in slot order (the table's order), with
    the prices of the route and, where it carries a certificate, the prices
    its certificate was evaluated at."""
    cert = out.certificate
    return dict(D=np.concatenate(out.deltas), L=np.concatenate(out.lambdas),
                psi=np.asarray(out.psi, np.float64),
                prices=np.asarray(out.prices, np.float64),
                cert_prices=None if cert is None else np.asarray(cert.prices, np.float64),
                objective=float(out.objective), iters=int(out.iters))
