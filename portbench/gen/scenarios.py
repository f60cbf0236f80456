"""A reserve-scenario request: the arbitrage route at the drifted prices
(c = prices, lo = 0, hi = +inf) in each of ``scenarios`` reserve states of
the block, state s the block's reserves with every slot of pool p scaled by
``scale[s, p]``, drawn uniform in [``scale_low``, ``scale_high``) from the
request's own generator."""
import numpy as np


def draw(traffic: dict, net: dict, rng, req: dict) -> None:
    n = net["n_assets"]
    scale = rng.uniform(float(traffic["scale_low"]), float(traffic["scale_high"]),
                        size=(int(traffic["scenarios"]), len(net["width"])))
    req.update(c=req["prices"], lo=np.zeros(n), hi=np.full(n, np.inf), scale=scale)


def state_reserves(net: dict, req: dict, s: int) -> np.ndarray:
    """The slot reserves of state ``s`` of the request."""
    return req["reserves"] * np.repeat(req["scale"][s], net["width"])
