"""A route request: the arbitrage route at the drifted prices, c = prices,
lo = 0, hi = +inf."""
import numpy as np


def draw(traffic: dict, net: dict, rng, req: dict) -> None:
    n = net["n_assets"]
    req.update(c=req["prices"], lo=np.zeros(n), hi=np.full(n, np.inf))
