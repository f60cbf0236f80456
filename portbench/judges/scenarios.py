"""Judge of a reserve-scenario request (``api.route_scenarios``) against
the plain reference: each state's route is judged as a route
(``judges/route.py``: ``gap``, ``feas``) on that state's own reserves, built
from the request (``gen/scenarios.py``), and each number is the worst over
the states.  A request that answers another count of states than it asked
for reads NaN, which fails every limit."""
from __future__ import annotations

from ..gen import scenarios as gen
from . import route

NUMBERS = route.NUMBERS


def judge(net: dict, req: dict, ans: dict, device) -> dict:
    states = ans["states"]
    worst = {k: 0.0 for k in NUMBERS}
    if len(states) != len(req["scale"]):
        return {k: float("nan") for k in NUMBERS}
    for s, got in enumerate(states):
        one = route.judge(net, dict(req, reserves=gen.state_reserves(net, req, s)),
                          got, device)
        for k in NUMBERS:
            worst[k] = one[k] if not one[k] <= worst[k] else worst[k]  # NaN sticks
    return worst
