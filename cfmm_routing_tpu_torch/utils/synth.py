"""Synthetic CFMM network generators for benchmarks and scale tests.

Deterministic given a seed: numpy's ``default_rng`` draws the same
streams as the JAX package's generators, so both packages build the
same networks from the same seed.
"""
from __future__ import annotations

import numpy as np

from ..models.pools import (
    BoundedProductPool,
    ConstantSumPool,
    GeoMeanPool,
    ProductPool,
)
from ..models.utility import Objective
from ..solver.compiler import PoolTable, ProblemSpec

__all__ = [
    "random_network",
    "random_arbitrage",
    "random_network_table",
    "random_arbitrage_table",
    "mixed_width_arbitrage",
]


def random_network(
    n_assets: int,
    n_pools: int,
    seed: int = 0,
    p_product: float = 0.7,
    p_weighted: float = 0.1,
    p_bounded: float = 0.1,
    p_sum: float = 0.1,
    max_width: int = 4,
    reserve_scale: float = 100.0,
) -> ProblemSpec:
    """A connected-ish random pool network with a realistic type mix.

    ~70% two-asset constant-product, plus weighted multi-asset,
    bounded-liquidity (v3-style) and constant-sum pools.  Asset pairs are
    drawn with a popularity bias (Zipf-like) so a few hub assets appear in
    many pools, as on real networks.
    """
    rng = np.random.default_rng(seed)
    probs = np.array([p_product, p_weighted, p_bounded, p_sum], np.float64)
    probs = probs / probs.sum()
    pop = 1.0 / np.arange(1, n_assets + 1) ** 0.8
    pop = pop / pop.sum()

    pools = []
    for i in range(n_pools):
        kind = rng.choice(4, p=probs)
        if kind in (0, 2):
            k = 2
        else:
            k = int(rng.integers(2, max(3, min(max_width, n_assets)) + 1))
        assets = rng.choice(n_assets, size=k, replace=False, p=pop)
        # guarantee a spanning backbone so every asset is reachable
        if i < n_assets - 1:
            assets = np.array([i % n_assets, (i + 1) % n_assets] + list(assets[2:]))[:k]
            assets = np.unique(assets)[:k]
            if len(assets) < 2:
                assets = np.array([i % n_assets, (i + 1) % n_assets])
        reserves = rng.uniform(0.1, 1.0, size=len(assets)) * reserve_scale
        fee = float(rng.choice([0.997, 0.997, 0.995, 0.999, 1.0]))
        if kind == 0:
            pools.append(ProductPool(assets, reserves, fee=fee))
        elif kind == 1:
            w = rng.uniform(1.0, 8.0, size=len(assets))
            pools.append(GeoMeanPool(assets, reserves, w, fee=fee))
        elif kind == 2:
            shifts = rng.uniform(0.5, 5.0, size=len(assets)) * reserve_scale
            pools.append(BoundedProductPool(assets, reserves, shifts, fee=fee))
        else:
            pools.append(ConstantSumPool(assets, reserves, fee=fee))
    return ProblemSpec(n_assets=n_assets, pools=pools)


def random_arbitrage(n_assets: int, n_pools: int, seed: int = 0, **kw):
    """Network + a market-value arbitrage objective (prices ~ lognormal)."""
    spec = random_network(n_assets, n_pools, seed=seed, **kw)
    rng = np.random.default_rng(seed + 1)
    prices = np.exp(rng.normal(0.0, 1.0, size=n_assets))
    return spec, Objective.arbitrage(prices)


def random_network_table(
    n_assets: int,
    n_pools: int,
    seed: int = 0,
    p_product: float = 0.7,
    p_weighted: float = 0.1,
    p_bounded: float = 0.1,
    p_sum: float = 0.1,
    max_width: int = 4,
    reserve_scale: float = 100.0,
) -> PoolTable:
    """Fully vectorized :class:`PoolTable` generator (no Pool objects).

    Same statistical family as :func:`random_network` built directly in
    flat arrays — the ingestion path for 100k-pool networks.
    """
    rng = np.random.default_rng(seed)
    probs = np.array([p_product, p_weighted, p_bounded, p_sum], np.float64)
    probs = probs / probs.sum()
    family = rng.choice(4, size=n_pools, p=probs)  # 0=prod 1=geo 2=bnd 3=sum

    width = np.full(n_pools, 2, np.int32)
    wide = (family == 1) | (family == 3)
    kmax = max(3, min(max_width, n_assets))
    width[wide] = rng.integers(2, kmax + 1, size=int(wide.sum()))

    offset = np.zeros(n_pools, np.int64)
    np.cumsum(width[:-1], out=offset[1:])
    E = int(width.sum())

    # Zipf-weighted sampling WITHOUT replacement per pool via the Gumbel
    # top-k trick: per-row argpartition of log(pop) + Gumbel noise.
    pop = 1.0 / np.arange(1, n_assets + 1) ** 0.8
    keys = np.log(pop)[None, :] + rng.gumbel(size=(n_pools, n_assets))
    kmax_all = int(width.max())
    top = np.argpartition(-keys, kmax_all - 1, axis=1)[:, :kmax_all]
    slot_idx = np.arange(kmax_all)[None, :]
    sel = slot_idx < width[:, None]
    assets = top[sel].astype(np.int32)  # row-major => pool-contiguous runs

    reserves = rng.uniform(0.1, 1.0, size=E) * reserve_scale
    weights = np.ones(E)
    wslots = np.repeat(family == 1, width)
    weights[wslots] = rng.uniform(1.0, 8.0, size=int(wslots.sum()))
    shifts = np.zeros(E)
    bslots = np.repeat(family == 2, width)
    shifts[bslots] = rng.uniform(0.5, 5.0, size=int(bslots.sum())) * reserve_scale

    kind = np.where(family == 3, 1, 0).astype(np.uint8)
    floor = ((family == 3) | (family == 2)).astype(np.uint8)
    fees = rng.choice([0.997, 0.997, 0.995, 0.999, 1.0], size=n_pools)

    return PoolTable(
        n_assets, kind, floor, width, offset, assets, reserves, weights,
        shifts, fees,
    )


def random_arbitrage_table(n_assets: int, n_pools: int, seed: int = 0, **kw):
    """Flat-table network + lognormal market-value arbitrage objective."""
    table = random_network_table(n_assets, n_pools, seed=seed, **kw)
    rng = np.random.default_rng(seed + 1)
    prices = np.exp(rng.normal(0.0, 1.0, size=n_assets))
    return table, Objective.arbitrage(prices)


def mixed_width_arbitrage(widths=(3, 5, 12), n_assets: int = 16,
                          pools_per_width: int = 48, seed: int = 0):
    """A network of wide pools + an arbitrage objective: for each width in
    ``widths``, geo-mean, bounded-liquidity (reserve floor) and
    constant-sum pools in turn, each over that many distinct assets.
    Compiled with ``pad_pow2=False`` its buckets keep those widths; with
    ``pad_pow2=True`` they round up to powers of two."""
    rng = np.random.default_rng(seed)
    value = np.exp(rng.normal(0.0, 0.5, size=n_assets))
    pools = []
    for k in widths:
        for i in range(pools_per_width):
            assets = rng.choice(n_assets, size=k, replace=False)
            R = rng.uniform(50.0, 150.0) / value[assets] * rng.lognormal(0.0, 0.1, k)
            if i % 3 == 0:
                pools.append(GeoMeanPool(assets, R, rng.uniform(0.5, 2.0, k),
                                         fee=0.997))
            elif i % 3 == 1:
                pools.append(BoundedProductPool(
                    assets, R, R * rng.uniform(0.5, 2.0, k), fee=0.997))
            else:
                pools.append(ConstantSumPool(assets, R, fee=0.999))
    market = value * rng.lognormal(0.0, 0.05, size=n_assets)
    return ProblemSpec(n_assets, pools), Objective.arbitrage(market)
