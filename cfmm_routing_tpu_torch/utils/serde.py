"""Declarative JSON problem I/O.

A routing problem is a plain JSON document:

    {
      "n_assets": 4,
      "pools": [
        {"type": "product",      "assets": [0, 1], "reserves": [10, 1], "fee": 0.997},
        {"type": "geomean",      "assets": [0, 1, 2], "reserves": [4, 4, 4],
         "weights": [3, 2, 1], "fee": 0.998},
        {"type": "constant_sum", "assets": [2, 3], "reserves": [10, 10], "fee": 0.999},
        {"type": "bounded_product", "assets": [0, 2], "reserves": [1, 1],
         "shifts": [5, 5], "fee": 0.997}
      ]
    }

and an objective is one of the three workload forms:

    {"workload": "arbitrage",   "market_values": [...]}
    {"workload": "liquidation", "holdings": [...], "numeraire": k}
    {"workload": "trade",       "holdings": [...], "receive": k}

The schema is the JAX package's (``cfmm_routing_tpu.utils.serde``): both
packages read and write the same documents.
"""
from __future__ import annotations

import json
from typing import Union

import numpy as np

from ..models.pools import (
    BoundedProductPool,
    ConstantSumPool,
    GeoMeanPool,
    Pool,
    ProductPool,
)
from ..models.utility import Objective
from ..solver.compiler import ProblemSpec

__all__ = [
    "spec_from_json",
    "spec_to_json",
    "objective_from_json",
    "load_problem",
]

_POOL_TYPES = {
    "product": ProductPool,
    "geomean": GeoMeanPool,
    "constant_sum": ConstantSumPool,
    "bounded_product": BoundedProductPool,
}


def _pool_from_dict(d: dict) -> Pool:
    t = d.get("type")
    if t not in _POOL_TYPES:
        raise ValueError(
            f"unknown pool type {t!r}; expected one of {sorted(_POOL_TYPES)}"
        )
    kw = dict(assets=d["assets"], reserves=d["reserves"])
    if "fee" in d:
        kw["fee"] = d["fee"]
    if t == "geomean":
        kw["weights"] = d["weights"]
    elif t == "bounded_product":
        kw["shifts"] = d["shifts"]
    elif t == "constant_sum" and "weights" in d:
        kw["weights"] = d["weights"]  # weighted linear invariant q_j
    return _POOL_TYPES[t](**kw)


def _pool_to_dict(p: Pool) -> dict:
    d = {
        "assets": list(p.assets),
        "reserves": [float(x) for x in p.reserves],
        "fee": p.fee,
    }
    if isinstance(p, GeoMeanPool):
        d["type"] = "geomean"
        d["weights"] = [float(x) for x in p.weights]
    elif isinstance(p, BoundedProductPool):
        d["type"] = "bounded_product"
        d["shifts"] = [float(x) for x in p.shift]
    elif isinstance(p, ConstantSumPool):
        d["type"] = "constant_sum"
        if not np.all(p.weights == 1.0):
            d["weights"] = [float(x) for x in p.weights]
    else:
        d["type"] = "product"
    return d


def spec_from_json(doc: Union[str, dict]) -> ProblemSpec:
    if isinstance(doc, str):
        doc = json.loads(doc)
    return ProblemSpec(
        n_assets=doc["n_assets"],
        pools=[_pool_from_dict(p) for p in doc["pools"]],
    )


def spec_to_json(spec: ProblemSpec, indent: int = 2) -> str:
    return json.dumps(
        {
            "n_assets": spec.n_assets,
            "pools": [_pool_to_dict(p) for p in spec.pools],
        },
        indent=indent,
    )


def objective_from_json(doc: Union[str, dict], n_assets: int) -> Objective:
    if isinstance(doc, str):
        doc = json.loads(doc)
    w = doc.get("workload")
    if w == "arbitrage":
        return Objective.arbitrage(doc["market_values"])
    if w == "liquidation":
        return Objective.liquidation(n_assets, doc["numeraire"], doc["holdings"])
    if w == "trade":
        return Objective.trade(n_assets, doc["receive"], doc["holdings"])
    raise ValueError(
        f"unknown workload {w!r}; expected arbitrage | liquidation | trade"
    )


def load_problem(path: str):
    """Load ``{spec..., "objective": {...}}`` (objective optional)."""
    with open(path) as f:
        doc = json.load(f)
    spec = spec_from_json(doc)
    obj = (
        objective_from_json(doc["objective"], spec.n_assets)
        if "objective" in doc
        else None
    )
    return spec, obj
