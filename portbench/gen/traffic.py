"""The one generator of requests: reads a traffic mix (``traffic/<mix>.json``)
and draws request ``index`` of a run from ``(seed, index)`` alone, so that a
request does not depend on the ones before it and the same seed gives the
same requests.

Every request is a new block state of the configuration's network:

* ``block.reserve_share`` of the pools (the same count in every request),
  drawn without replacement, have each slot's reserve scaled by
  ``exp(N(0, block.reserve_sigma))``;
* the market prices drift by ``exp(N(0, block.price_sigma))`` per asset.

What a request asks for beyond the block is drawn, from the same
generator, by ``gen/<call>.py`` for the mix's ``call``.
"""
from __future__ import annotations

import importlib

import numpy as np

from . import synth

WINDOW = 0  # the stream of the measured requests
WARMUP = 1  # the stream of the warm-up request


def network(config: dict) -> dict:
    """The configuration's network and base prices, from its own seed."""
    g = config["generator"]
    net = synth.random_network_table(
        g["n_assets"], g["n_pools"], seed=g["network_seed"],
        p_product=g["p_product"], p_weighted=g["p_weighted"],
        p_bounded=g["p_bounded"], p_sum=g["p_sum"],
        max_width=g["max_width"], reserve_scale=g["reserve_scale"])
    net["prices"] = synth.market_prices(g["n_assets"], g["network_seed"])
    return net


def rng_for(seed: int, index: int, stream: int = WINDOW) -> np.random.Generator:
    """The request's own generator: any whole seed (negative or above 64
    bits too) maps onto the seed sequence's non-negative entropy."""
    return np.random.default_rng([int(seed) % (1 << 64), int(stream), int(index)])


def draw(traffic: dict, net: dict, seed: int, index: int,
         stream: int = WINDOW) -> dict:
    rng = rng_for(seed, index, stream)
    blk = traffic["block"]
    P = len(net["width"])
    reserves = np.array(net["reserves"], np.float64)
    hit = rng.choice(P, size=int(round(blk["reserve_share"] * P)), replace=False)
    slots = np.concatenate([np.arange(net["offset"][p], net["offset"][p] + net["width"][p])
                            for p in np.sort(hit)]) if len(hit) else np.zeros(0, np.int64)
    reserves[slots] *= np.exp(rng.normal(0.0, blk["reserve_sigma"], size=len(slots)))
    n = net["n_assets"]
    prices = net["prices"] * np.exp(rng.normal(0.0, blk["price_sigma"], size=n))
    req = dict(index=int(index), reserves=reserves, prices=prices)
    importlib.import_module(f"portbench.gen.{traffic['call']}").draw(
        traffic, net, rng, req)
    return req
