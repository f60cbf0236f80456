"""``api.route_scenarios`` on a new block state: the arbitrage route at the
drifted prices in each of the request's reserve states, equilibrated once,
solved as one fold and refined to the mix's certified gap."""
from __future__ import annotations

from . import common
from . import route


def call(net: dict, req: dict, traffic: dict, device=None, control=False):
    """One request through the program's public entry.  ``control`` drops
    the float64 refinement: the float32 folded base routes alone."""
    from cfmm_routing_tpu_torch import api
    from cfmm_routing_tpu_torch.models.utility import Objective

    return api.route_scenarios(common.table(net, req["reserves"]),
                               Objective.arbitrage(req["prices"]), req["scale"],
                               precondition=bool(traffic["precondition"]),
                               refine_to=None if control else traffic["refine_to"],
                               pad_pools_to=int(traffic["pad_pools_to"]),
                               options=common.options(traffic),
                               **common.device_kw(device))


def certified(out) -> bool:
    """Whether the program certified every state's route."""
    return len(out) > 0 and all(bool(r.converged) for r in out)


def answer(out) -> dict:
    """Per state the route's answer (``calls/route.py``), in state order."""
    return dict(states=[route.answer(r) for r in out])
