"""Pool (CFMM) model family definitions.

The reference expresses three pool families through cvxpy atoms
(``cp.geo_mean`` / ``cp.sum``; see the reference ``arbitrage.py:63-74``,
``liquidation.py:63-74``, ``two-asset.py:72-83``).  Here each family is a
declarative dataclass that the problem compiler (``solver/compiler.py``)
lowers to padded device arrays.  All families are unified under two trading
functions:

* ``gm``:  phi(x) = prod_j (x_j + shift_j)^{w_j}   with  sum_j w_j = 1
* ``cs``:  phi(x) = sum_j q_j x_j                  with  x >= 0, q_j > 0
           (q = 1 recovers the plain constant sum)

which covers:

- :class:`GeoMeanPool`     — Balancer-style weighted geometric mean
  (reference ``arbitrage.py:65``).
- :class:`ProductPool`     — Uniswap-v2 constant product = uniform geo-mean
  (reference ``arbitrage.py:68-70``).
- :class:`ConstantSumPool` — mStable-style constant sum with explicit
  reserve nonnegativity (reference ``arbitrage.py:73-74``).
- :class:`BoundedProductPool` — Uniswap-v3-style bounded liquidity: a
  constant-product curve on *virtual* reserves ``x + shift``, drainable to
  ``x = 0`` (the BASELINE.json "bounded-liquidity (Uniswap v3)" config).

The trading set of every pool is

    T = { (D, L) >= 0 : phi(R + gamma*D - L) >= phi(R) [, R + gamma*D - L >= 0] }

with the fee ``gamma`` discounting only the tendered basket ``D``
(reference ``arbitrage.py:60``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

__all__ = [
    "Pool",
    "GeoMeanPool",
    "ProductPool",
    "ConstantSumPool",
    "BoundedProductPool",
]


def _as_f64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class Pool:
    """Base pool: a CFMM trading ``len(assets)`` global assets.

    Attributes:
      assets:   tuple of global asset indices this pool trades
                (the reference's ``local_indices`` row, ``arbitrage.py:6-12``).
      reserves: current reserves, one per local asset (``arbitrage.py:14-20``).
      fee:      input-discount multiplier ``gamma`` in (0, 1]
                (``arbitrage.py:22-28``; e.g. 0.997 = 30bps fee).
    """

    assets: Tuple[int, ...]
    reserves: np.ndarray
    fee: float = 1.0

    def __init__(self, assets: Sequence[int], reserves, fee: float = 1.0):
        object.__setattr__(self, "assets", tuple(int(a) for a in assets))
        object.__setattr__(self, "reserves", _as_f64(reserves))
        object.__setattr__(self, "fee", float(fee))
        self._validate()

    # -- lowering interface (overridden per family) --------------------------
    kind: str = "gm"

    @property
    def width(self) -> int:
        return len(self.assets)

    @property
    def weights(self) -> np.ndarray:
        """Normalized trading-function weights (sum to 1)."""
        k = self.width
        return np.full(k, 1.0 / k)

    @property
    def shift(self) -> np.ndarray:
        """Virtual-reserve offset; phi acts on ``x + shift``."""
        return np.zeros(self.width)

    @property
    def needs_reserve_floor(self) -> bool:
        """Whether ``R+ >= 0`` must be enforced explicitly.

        Geo-mean pools with zero shift get it for free from phi's domain
        (phi -> 0 at the boundary); constant-sum and shifted pools do not
        (reference adds it explicitly for the sum pool, ``arbitrage.py:74``).
        """
        return self.kind == "cs" or bool(np.any(self.shift > 0))

    def _validate(self):
        if len(self.assets) != len(self.reserves):
            raise ValueError(
                f"pool touches {len(self.assets)} assets but has "
                f"{len(self.reserves)} reserves"
            )
        if len(set(self.assets)) != len(self.assets):
            raise ValueError(f"duplicate asset index in pool: {self.assets}")
        if not (0.0 < self.fee <= 1.0):
            raise ValueError(f"fee multiplier must be in (0, 1], got {self.fee}")
        if np.any(self.reserves < 0):
            raise ValueError("reserves must be nonnegative")


class GeoMeanPool(Pool):
    """Balancer-style weighted geometric-mean pool.

    phi(x) = prod_j x_j^{w_j / sum(w)}.  Matches ``cp.geo_mean(x, p=w)``
    (cvxpy normalizes ``p`` the same way); reference ``arbitrage.py:65``.

    Note the reference compares a *weighted* LHS against an *unweighted*
    ``cp.geo_mean(reserves)`` RHS in ``arbitrage.py:65``/``liquidation.py:65``
    — benign there because those reserves are uniform.  We implement the
    correct general form: the same weighted phi on both sides (as
    ``two-asset.py:74`` does).
    """

    kind = "gm"

    def __init__(self, assets, reserves, weights, fee: float = 1.0):
        self._w = _as_f64(weights)
        super().__init__(assets, reserves, fee)
        if len(self._w) != len(self.assets):
            raise ValueError("weights length must match assets")
        if np.any(self._w <= 0):
            raise ValueError("weights must be positive")

    @property
    def weights(self) -> np.ndarray:
        return self._w / self._w.sum()


class ProductPool(Pool):
    """Uniswap-v2 constant-product pool: uniform geo-mean over its assets.

    ``cp.geo_mean(new_reserves) >= cp.geo_mean(reserves)`` with 2 assets
    (reference ``arbitrage.py:68-70``) — but any width is allowed here.
    """

    kind = "gm"


class ConstantSumPool(Pool):
    """mStable-style constant-sum pool: phi(x) = sum_j q_j x_j, x >= 0.

    Reference ``arbitrage.py:73-74`` (the explicit ``new_reserves >= 0``)
    is the uniform case q = 1 (the default).  Per-asset coefficients
    ``weights`` express weighted linear invariants — pegged baskets with
    mixed token decimals, and the image of a plain constant-sum pool
    under the per-asset diagonal rescaling the preconditioner applies
    (``solver/precondition.py``).  Unlike gm weights these are NOT
    normalized: phi is homogeneous degree 1 in q, so only ratios matter,
    but k0 = q @ R is reported in the caller's units.
    """

    kind = "cs"

    def __init__(self, assets, reserves, fee: float = 1.0, weights=None):
        assets = tuple(assets)  # materialize once: a generator would be
        #                         exhausted before super().__init__ sees it
        if weights is None:
            self._q = np.ones(len(assets))
        else:
            self._q = _as_f64(weights)
        super().__init__(assets, reserves, fee)
        if len(self._q) != len(self.assets):
            raise ValueError("weights length must match assets")
        if np.any(self._q <= 0):
            raise ValueError("constant-sum weights must be positive")

    @property
    def weights(self) -> np.ndarray:
        return self._q


class BoundedProductPool(Pool):
    """Uniswap-v3-style bounded-liquidity pool.

    Constant product on virtual reserves: phi(x) = prod_j (x_j + shift_j)^{1/k},
    with real reserves x kept >= 0 (liquidity is exhausted when a real
    reserve hits zero).  ``shift = 0`` recovers :class:`ProductPool`.
    Not present in the reference scripts; required by the BASELINE.json
    "bounded-liquidity (Uniswap v3)" benchmark config.
    """

    kind = "gm"

    def __init__(self, assets, reserves, shifts, fee: float = 1.0):
        self._shift = _as_f64(shifts)
        super().__init__(assets, reserves, fee)
        if len(self._shift) != len(self.assets):
            raise ValueError("shifts length must match assets")
        if np.any(self._shift < 0):
            raise ValueError("shifts must be nonnegative")

    @property
    def shift(self) -> np.ndarray:
        return self._shift
