"""The three reference problem instances, as framework specs.

Pool tables, fees, market values and holdings of the reference
``arbitrage.py``, ``liquidation.py`` and ``two-asset.py`` scripts.  These
are the parity fixtures: the solver must reproduce the pinned objective
values in BASELINE.md on them.
"""
from __future__ import annotations

import numpy as np

from .pools import ConstantSumPool, GeoMeanPool, ProductPool
from .utility import Objective
from ..solver.compiler import ProblemSpec

__all__ = [
    "arbitrage_instance",
    "liquidation_instance",
    "two_asset_instance",
]


def arbitrage_instance():
    """``arbitrage.py``: 4 assets, 5 pools, max market value, psi >= 0."""
    spec = ProblemSpec(
        n_assets=4,
        pools=[
            GeoMeanPool((0, 1, 2, 3), [4, 4, 4, 4], [4, 3, 2, 1], fee=0.998),
            ProductPool((0, 1), [10, 1], fee=0.997),
            ProductPool((1, 2), [1, 5], fee=0.997),
            ProductPool((2, 3), [40, 50], fee=0.997),
            ConstantSumPool((2, 3), [10, 10], fee=0.999),
        ],
    )
    obj = Objective.arbitrage([1.5, 10, 2, 3])
    return spec, obj


def liquidation_instance():
    """``liquidation.py``: 5 assets, 5 pools, liquidate basket into token 4."""
    spec = ProblemSpec(
        n_assets=5,
        pools=[
            GeoMeanPool((0, 1, 2, 3, 4), [4, 4, 4, 4, 4], [5, 4, 3, 2, 1], fee=0.998),
            ProductPool((0, 1), [10, 1], fee=0.997),
            ProductPool((2, 3), [1, 5], fee=0.997),
            ProductPool((3, 4), [40, 50], fee=0.997),
            ConstantSumPool((3, 4), [10, 10], fee=0.999),
        ],
    )
    obj = Objective.liquidation(5, numeraire=4, holdings=[2, 1, 3, 5, 10])
    return spec, obj


def two_asset_instance(t: float = 0.0):
    """``two-asset.py``: 3 assets, 5 pools, trade t of asset 0 into asset 2."""
    spec = ProblemSpec(
        n_assets=3,
        pools=[
            GeoMeanPool((0, 1, 2), [3, 0.2, 1], [3, 2, 1], fee=0.98),
            ProductPool((0, 1), [10, 1], fee=0.99),
            ProductPool((1, 2), [1, 10], fee=0.96),
            ProductPool((0, 2), [20, 50], fee=0.97),
            ConstantSumPool((0, 2), [10, 10], fee=0.99),
        ],
    )
    obj = Objective.trade(3, receive=2, holdings=np.array([t, 0.0, 0.0]))
    return spec, obj
