"""Problem compiler: declarative pool specs -> padded device-ready buckets.

Each pool's slots become rows of flat int32 scatter indices and dense
padded arrays instead of one-hot matrices:

  * pools are grouped by (kind, padded width K) so every bucket is one
    rectangular ``(m, K)`` array family — static shapes, no ragged
    structure anywhere on the device;
  * padding slots carry zero weight and a zero mask, so they are exact
    no-ops;
  * the per-asset *degree* d_j (# pool slots touching asset j) is
    precomputed — it is the diagonal metric of the closed-form consensus
    z-update in the ADMM (see ``solver/admm.py``).

Everything here runs once per problem on the host (numpy); the solver
copies the arrays to the device.  Bucket arrays are bit-identical to the
JAX package's compiler with the same backend (numpy, or the C++ packer of
``native/``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..models.pools import Pool
from ..utils.profiling import spanned

__all__ = [
    "ProblemSpec",
    "PoolTable",
    "Bucket",
    "CompiledProblem",
    "compile_spec",
    "compile_table",
]


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """A routing problem: ``n_assets`` global tokens + a list of pools."""

    n_assets: int
    pools: Tuple[Pool, ...]

    def __init__(self, n_assets: int, pools: Sequence[Pool]):
        object.__setattr__(self, "n_assets", int(n_assets))
        object.__setattr__(self, "pools", tuple(pools))
        for p in self.pools:
            if max(p.assets) >= self.n_assets:
                raise ValueError(
                    f"pool references asset {max(p.assets)} but n_assets={n_assets}"
                )


@dataclasses.dataclass
class PoolTable:
    """Flat array-of-slots pool representation for bulk ingestion.

      kind      (P,)  uint8   0 = gm (geo-mean family), 1 = cs (constant sum)
      floor     (P,)  uint8   1 = enforce post-trade reserves >= 0
      width     (P,)  int32   slots per pool
      offset    (P,)  int64   start of each pool's slot run
      assets    (E,)  int32   global asset index per slot
      reserves  (E,)  f64
      weights   (E,)  f64     raw phi weights (normalized during packing)
      shifts    (E,)  f64     virtual-reserve offsets
      fees      (P,)  f64     gamma multipliers
    """

    n_assets: int
    kind: np.ndarray
    floor: np.ndarray
    width: np.ndarray
    offset: np.ndarray
    assets: np.ndarray
    reserves: np.ndarray
    weights: np.ndarray
    shifts: np.ndarray
    fees: np.ndarray

    @property
    def n_pools(self) -> int:
        return len(self.width)

    @staticmethod
    def from_spec(spec: "ProblemSpec") -> "PoolTable":
        P = len(spec.pools)
        width = np.fromiter((p.width for p in spec.pools), np.int32, P)
        offset = np.zeros(P, np.int64)
        np.cumsum(width[:-1], out=offset[1:])
        E = int(width.sum())
        assets = np.empty(E, np.int32)
        reserves = np.empty(E, np.float64)
        weights = np.empty(E, np.float64)
        shifts = np.empty(E, np.float64)
        kind = np.empty(P, np.uint8)
        floor = np.empty(P, np.uint8)
        fees = np.empty(P, np.float64)
        for i, p in enumerate(spec.pools):
            o, k = offset[i], width[i]
            assets[o : o + k] = p.assets
            reserves[o : o + k] = p.reserves
            weights[o : o + k] = p.weights
            shifts[o : o + k] = p.shift
            kind[i] = 0 if p.kind == "gm" else 1
            floor[i] = 1 if p.needs_reserve_floor else 0
            fees[i] = p.fee
        return PoolTable(
            spec.n_assets, kind, floor, width, offset, assets, reserves,
            weights, shifts, fees,
        )


@dataclasses.dataclass
class Bucket:
    """All pools of one (kind, padded-width) class, padded to (m, K).

    Arrays (numpy, float64 master copies; cast to the solve dtype when moved
    to the device):

      reserves  (m, K)  current reserves R (0 in padding)
      weights   (m, K)  'gm': normalized phi weights, sum_j w = 1 per pool
                        'cs': raw linear coefficients q_j > 0 (uniform
                        pools carry 1.0);  0 in padding for both
      shift     (m, K)  virtual-reserve offsets (0 unless bounded pools)
      gamma     (m, 1)  fee multipliers
      logk0     (m,)    'gm': sum_j w_j*log(R_j+s_j)   'cs': unused
      k0        (m,)    'cs': sum_j q_j R_j            'gm': exp(logk0)
      mask      (m, K)  1.0 on real slots, 0.0 on padding
      asset     (m, K)  int32 global asset index
    """

    kind: str  # 'gm' | 'cs'
    width: int  # K (padded)
    reserves: np.ndarray
    weights: np.ndarray
    shift: np.ndarray
    gamma: np.ndarray
    logk0: np.ndarray
    k0: np.ndarray
    mask: np.ndarray
    asset: np.ndarray
    pool_ids: np.ndarray  # (m_real,) index into the pool list
    needs_floor: bool  # enforce R+ >= 0 inside the projection

    @property
    def m(self) -> int:
        return self.reserves.shape[0]


@dataclasses.dataclass
class CompiledProblem:
    """Device-ready problem: buckets + per-asset degree + bookkeeping."""

    n_assets: int
    buckets: Dict[str, Bucket]
    degree: np.ndarray  # (n,) float — # real slots touching each asset
    n_pools: int
    n_slots: int  # total real (pool, asset) slots = sum of widths
    widths: np.ndarray  # (n_pools,) int32 — real slots per pool
    spec: Optional[ProblemSpec] = None  # absent for table-built problems

    def bucket_names(self) -> List[str]:
        return sorted(self.buckets.keys())


def _fill_bucket_numpy(table: PoolTable, rows, m, K, is_gm,
                       R, W, S, G, mask, asset, degree, logk0, k0):
    """Fill one bucket's padded arrays from the flat table."""
    m_real = len(rows)
    G[:m_real] = table.fees[rows]
    w_rows = table.width[rows]
    o_rows = table.offset[rows]
    for j in range(K):
        sel = w_rows > j
        src = o_rows[sel] + j
        rr = np.nonzero(sel)[0]
        R[rr, j] = table.reserves[src]
        W[rr, j] = table.weights[src]
        S[rr, j] = table.shifts[src]
        mask[rr, j] = 1.0
        asset[rr, j] = table.assets[src]
        np.add.at(degree, table.assets[src], 1.0)
    if is_gm:
        wsum = np.maximum(W[:m_real].sum(axis=1, keepdims=True), 1e-300)
        W[:m_real] /= wsum
        safe = np.where(mask > 0, R + S, 1.0)
        np.sum(W * np.log(safe), axis=1, out=logk0)
        np.exp(logk0, out=k0)
    else:
        # 'cs' weights stay RAW (phi = sum q_j x_j; normalizing would
        # rescale k0 out of the caller's units)
        logk0[:] = 0.0
        np.sum(R * W, axis=1, out=k0)


@spanned("route.compile")
def compile_table(
    table: PoolTable,
    pad_pow2: bool = True,
    pad_pools_to: int = 1,
    spec: Optional[ProblemSpec] = None,
    backend: str = "auto",
) -> CompiledProblem:
    """Lower a flat :class:`PoolTable` into bucketed padded arrays.

    ``pad_pools_to``: round each bucket's pool count up to a multiple.
    Padding pools are inert: fully masked, zero weights, asset 0 — their
    projection is the identity at the origin and every consensus access is
    masked (solver/admm.py).

    ``backend``: 'native' (the C++ packer, ``native/``), 'numpy', or
    'auto' (native when ``g++`` builds it, else numpy).  'native' raises
    if the packer does not build.  The two agree bit for bit on every
    integer array and to summation-order roundoff on the float ones
    (tests/test_torch_native.py).
    """
    from .. import native

    use_native = backend == "native" or (backend == "auto" and native.available())
    n = table.n_assets
    P = table.n_pools

    if pad_pow2 and use_native:
        # the (kind, next_pow2(K), floor) key per pool from the packer
        # (packer.cpp bucket_keys), bit-identical to the numpy expression
        keys = native.bucket_keys(
            np.ascontiguousarray(table.width, np.int32),
            np.ascontiguousarray(table.kind, np.uint8),
            np.ascontiguousarray(table.floor, np.uint8),
        )
    else:
        if pad_pow2:
            Ks = np.maximum(
                2,
                (1 << np.ceil(np.log2(np.maximum(table.width, 2))).astype(np.int64)),
            ).astype(np.int32)
        else:
            Ks = np.maximum(2, table.width).astype(np.int32)
        keys = (
            (table.kind.astype(np.int32) << 24)
            | (Ks.astype(np.int32) << 1)
            | table.floor.astype(np.int32)
        )

    buckets: Dict[str, Bucket] = {}
    degree = np.zeros(n, dtype=np.float64)
    for key in np.unique(keys):
        rows = np.nonzero(keys == key)[0].astype(np.int32)
        kind = "gm" if (key >> 24) == 0 else "cs"
        floor = bool(key & 1)
        K = int((key & 0xFFFFFF) >> 1)
        is_gm = 1 if kind == "gm" else 0
        m_real = len(rows)
        m = -(-m_real // pad_pools_to) * pad_pools_to
        R = np.zeros((m, K))
        W = np.zeros((m, K))
        S = np.zeros((m, K))
        Gf = np.ones(m)
        mask = np.zeros((m, K))
        asset = np.zeros((m, K), dtype=np.int32)
        logk0 = np.zeros(m)
        k0 = np.zeros(m)
        if use_native:
            native.fill_bucket(
                m, m_real, K, is_gm, rows,
                np.ascontiguousarray(table.width, np.int32),
                np.ascontiguousarray(table.offset, np.int64),
                np.ascontiguousarray(table.assets, np.int32),
                np.ascontiguousarray(table.reserves, np.float64),
                np.ascontiguousarray(table.weights, np.float64),
                np.ascontiguousarray(table.shifts, np.float64),
                np.ascontiguousarray(table.fees, np.float64),
                R, W, S, Gf, mask, asset, degree, logk0, k0,
            )
        else:
            _fill_bucket_numpy(
                table, rows, m, K, is_gm, R, W, S, Gf, mask, asset,
                degree, logk0, k0,
            )
        if kind == "gm":
            k0[m_real:] = 1.0
        name = f"{kind}{K}{'f' if floor else ''}"
        buckets[name] = Bucket(
            kind=kind,
            width=K,
            reserves=R,
            weights=W,
            shift=S,
            gamma=Gf[:, None],
            logk0=logk0,
            k0=k0,
            mask=mask,
            asset=asset,
            pool_ids=rows,
            needs_floor=floor,
        )

    return CompiledProblem(
        n_assets=n,
        buckets=buckets,
        degree=degree,
        n_pools=P,
        n_slots=int(table.width.sum()),
        widths=np.asarray(table.width, np.int32),
        spec=spec,
    )


def compile_spec(
    spec: ProblemSpec, pad_pow2: bool = True, pad_pools_to: int = 1,
    backend: str = "auto",
) -> CompiledProblem:
    """Lower a :class:`ProblemSpec` into bucketed padded arrays."""
    return compile_table(
        PoolTable.from_spec(spec),
        pad_pow2=pad_pow2,
        pad_pools_to=pad_pools_to,
        spec=spec,
        backend=backend,
    )
