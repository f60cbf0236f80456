"""Frozen copy of the port's flat-table network generator, in numpy only.

A copy of ``random_network_table`` (and the price draw of
``random_arbitrage_table``) from ``cfmm_routing_tpu_torch/utils/synth.py``,
kept here so that the benchmark's traffic cannot move with the program.
It returns plain arrays, not the program's ``PoolTable``:

  kind      (P,)  uint8   0 = geometric-mean family, 1 = constant sum
  floor     (P,)  uint8   1 = post-trade reserves must stay >= 0
  width     (P,)  int32   slots per pool
  offset    (P,)  int64   start of each pool's slot run
  assets    (E,)  int32   global asset index per slot
  reserves  (E,)  f64
  weights   (E,)  f64     raw trading-function weights
  shifts    (E,)  f64     virtual-reserve offsets
  fees      (P,)  f64     fee multipliers gamma
"""
from __future__ import annotations

import numpy as np

FIELDS = ("kind", "floor", "width", "offset", "assets", "reserves", "weights",
          "shifts", "fees")


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
) -> dict:
    """70% two-asset constant product, 10% weighted geometric mean (width 2
    to ``max_width``), 10% bounded liquidity, 10% constant sum; assets drawn
    with Zipf-0.8 popularity, without replacement within a pool."""
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

    # Zipf-weighted sampling without replacement per pool: Gumbel top-k
    pop = 1.0 / np.arange(1, n_assets + 1) ** 0.8
    keys = np.log(pop)[None, :] + rng.gumbel(size=(n_pools, n_assets))
    kmax_all = int(width.max())
    top = np.argpartition(-keys, kmax_all - 1, axis=1)[:, :kmax_all]
    slot_idx = np.arange(kmax_all)[None, :]
    sel = slot_idx < width[:, None]
    assets = top[sel].astype(np.int32)  # row-major: pool-contiguous runs

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
    return dict(n_assets=int(n_assets), kind=kind, floor=floor, width=width,
                offset=offset, assets=assets, reserves=reserves,
                weights=weights, shifts=shifts, fees=fees)


def market_prices(n_assets: int, seed: int) -> np.ndarray:
    """Lognormal market values, drawn as ``random_arbitrage_table`` draws
    them for a network made with ``seed``."""
    rng = np.random.default_rng(seed + 1)
    return np.exp(rng.normal(0.0, 1.0, size=n_assets))
