"""Objective specification over the net trade vector psi.

The three reference workloads are all "linear utility + box side
constraints on psi":

- arbitrage:   max  m^T psi          s.t. psi >= 0
- liquidation: max  psi[k]           s.t. psi[j] == -a[j]  for j != k
- sweep:       max  psi[k]           s.t. psi >= -h

All three are instances of

    maximize  c^T psi    s.t.  lo <= psi <= hi

with +/-inf entries allowed in the box (an equality is ``lo == hi``).
:class:`Objective` captures exactly this; the ADMM psi-prox
(``ops/prox.py``) solves its diagonally-weighted prox in closed form.
Separable concave and custom utilities are not part of this package yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Objective"]

_INF = np.inf


@dataclasses.dataclass(frozen=True)
class Objective:
    """maximize c^T psi  subject to  lo <= psi <= hi (entrywise)."""

    c: np.ndarray
    lo: np.ndarray
    hi: np.ndarray

    def __init__(self, c, lo=None, hi=None):
        c = np.asarray(c, dtype=np.float64)
        n = c.shape[-1]
        lo = np.full(n, -_INF) if lo is None else np.asarray(lo, np.float64)
        hi = np.full(n, _INF) if hi is None else np.asarray(hi, np.float64)
        if lo.shape != c.shape or hi.shape != c.shape:
            raise ValueError("c, lo, hi must have identical shapes")
        if np.any(lo > hi):
            raise ValueError("box is empty: lo > hi somewhere")
        object.__setattr__(self, "c", c)
        object.__setattr__(self, "lo", lo)
        object.__setattr__(self, "hi", hi)

    @property
    def n_assets(self) -> int:
        return self.c.shape[-1]

    @staticmethod
    def arbitrage(market_values) -> "Objective":
        """max market_value @ psi s.t. psi >= 0."""
        c = np.asarray(market_values, np.float64)
        return Objective(c, lo=np.zeros_like(c))

    @staticmethod
    def liquidation(n: int, numeraire: int, holdings) -> "Objective":
        """max psi[numeraire] s.t. psi[j] == -holdings[j] for the rest."""
        holdings = np.asarray(holdings, np.float64)
        c = np.zeros(n)
        c[numeraire] = 1.0
        lo = -holdings.copy()
        hi = -holdings.copy()
        lo[numeraire], hi[numeraire] = -_INF, _INF
        return Objective(c, lo, hi)

    @staticmethod
    def trade(n: int, receive: int, holdings) -> "Objective":
        """max psi[receive] s.t. psi >= -holdings."""
        holdings = np.asarray(holdings, np.float64)
        c = np.zeros(n)
        c[receive] = 1.0
        return Objective(c, lo=-holdings)
