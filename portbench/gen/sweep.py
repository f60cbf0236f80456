"""A price-impact frontier: two distinct assets, ``give`` and ``receive``,
among the ``pair_among_top`` most popular ones (the lowest indices, by the
generator's Zipf ranking), and ``points`` amounts
``linspace(0, t_max, points)`` with ``t_max`` the share ``t_max_share`` of
the network's reserve of ``give``; u(t) = max psi[receive] subject to
psi >= -t e_give."""
import numpy as np


def draw(traffic: dict, net: dict, rng, req: dict) -> None:
    n = net["n_assets"]
    give, receive = (int(a) for a in rng.choice(
        min(int(traffic["pair_among_top"]), n), size=2, replace=False))
    t_max = traffic["t_max_share"] * float(req["reserves"][net["assets"] == give].sum())
    amounts = np.linspace(0.0, t_max, int(traffic["points"]))
    T = len(amounts)
    c = np.zeros((T, n))
    c[:, receive] = 1.0
    lo = np.zeros((T, n))
    lo[:, give] = -amounts
    req.update(give=give, receive=receive, amounts=amounts, c=c, lo=lo,
               hi=np.full((T, n), np.inf))
