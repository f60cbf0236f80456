"""Consensus-ADMM driver.

An operator-splitting method whose per-iteration work is exactly: one
batched trading-set projection per bucket (``ops/projection.py``; on the
card one launch per group of buckets with the same channel count), one
scatter-add over edges, and O(n) vector arithmetic — no factorizations and
no sparse matrices.

Derivation (all steps exact):

Split variables: per pool  w_i = (D_i, L_i)  with  F(w) = sum_i I_{T_i}(w_i),
and edge copies  z  with  G~(z) = -c^T psi(z) + I_box(psi(z)),  where
psi_j(z) = sum_{edges e into j} (zL_e - zD_e).  ADMM on  w = z:

    w^{k+1} = Proj_T(z^k - u^k)                       (bucketed projection)
    w_hat   = alpha w^{k+1} + (1-alpha) z^k           (over-relaxation)
    z^{k+1} = argmin_z G~(z) + rho/2 ||z - (w_hat + u^k)||^2
    u^{k+1} = u^k + w_hat - z^{k+1}

The z-step decomposes per asset j: with v = w_hat + u and
s_j = sum_e (vL_e - vD_e), minimizing over the fiber {psi(z) = psi} gives
zL_e = vL_e + mu_j, zD_e = vD_e - mu_j with mu_j = (psi_j - s_j)/(2 d_j)
(d_j = #edges at j), which collapses the z-step to the n-dim prox in
``ops/prox.py``.  Consequently u is always of the form
(u_D, u_L)_e = (+nu_j, -nu_j): the entire edge-space dual lives in one
per-asset price vector nu (and rho*nu converges to the optimal asset
prices).

The solver runs on the card unless it is given ``device="cpu"``.  The
iteration loops never read a device value back, except the residual check
once every ``check_every`` iterations; on the card their stats-free blocks
are CUDA-graph replays (``solver/graphs.py``), on the CPU Python loops.  On
the card every consensus reduction is a fixed-order segment sum
(``ops/segment.py``), one per group of buckets with the same channel count
(:attr:`AdmmSolver._groups`), so two runs give bitwise-equal iterates; on
the CPU it is ``index_add_``, which is sequential there.

The methods that touch bucket arrays take an optional ``buckets=`` override
(the refinement stage's delta arrays ride it; see
``solver/refine_device.py``).

The objective is a linear :class:`Objective`, a separable
:class:`ConcaveUtility` or a non-separable :class:`CustomUtility`; a utility
changes only the consensus prox (``ops/prox.py``), the bucket-side work is
the same.  A :class:`CustomUtility` runs on the classic path only
(:meth:`AdmmSolver.solve`), as in the JAX package: its prox is a fixed-trip
FISTA on the autograd gradient of its ``fn``, captured with the rest of a
check block on the card.

The fused path runs one grouped ``fused_step`` launch per channel count K
(:attr:`AdmmSolver._groups`, one lane per slot).  ``solve_fused(merged=True)``
runs the reference's merged entry point instead, one ``fused_step_merged``
launch per K with one thread per pool: same-K buckets share a concatenated
pool axis with a per-128-pool-block class table
(:meth:`AdmmSolver._merged_groups`).

A solver built with ``fold=(T, n_pt)`` runs a scenario fold
(``solver/fold.py``): T copies of a problem one after another on the pool
axis, point t's assets at t*n_pt..(t+1)*n_pt-1.  Its residual sums come out
per point, (T,) vectors; the joint solves (``solve``, ``solve_fused``,
``ChunkedDriver``) add them up, and ``_solve_batch_impl`` runs every point
with its own penalty and its own stopping test, freezing a point's state
once it has converged while the others go on — what ``AdmmSolver.solve_batch``
and ``solve_batch_reserves`` return.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .._device import host, resolve_device
from ..models.utility import ConcaveUtility, CustomUtility, Objective
from ..ops.iteration_cuda import (
    class_spans, fused_step_grouped, fused_step_merged,
)
from ..ops.projection import ProjectionConfig
from ..ops.projection_cuda import _KIND, MAX_GROUP, project_grouped
from ..ops.prox import (
    DeltaCustomUtility, custom_prox, psi_prox, utility_prox, utility_value,
)
from ..ops.segment import segment_sum, slot_order
from .compiler import CompiledProblem
from .graphs import GraphCache, run_block

__all__ = ["AdmmOptions", "AdmmSolver", "RouteResult"]

_CONSENSUS_MODES = ("auto", "onehot", "radix", "scatter")
# iterations per captured block of the fixed-length fused solves (the
# routes' check_every): replayed n // 25 times, the rest eager
_FUSED_BLOCK = 25
_F32_BIG = float(np.finfo(np.float32).max / 4)


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet ({item} in ROADMAP.md)")


@dataclasses.dataclass(frozen=True)
class AdmmOptions:
    rho: float = 1.0
    # over-relaxation in [1.0, 1.8].  Default 1.0: alpha=1.0 with the rho
    # adaptation below converges faster than 1.7 on smooth (geo-mean)
    # networks and does not stall on polyhedral (constant-sum-heavy) ones.
    alpha: float = 1.0
    max_iters: int = 2000
    # residual-check cadence: check_every - 1 stats-free iterations between
    # full checks.  The iteration counter advances in strides of
    # check_every, so max_iters may be overshot by at most check_every - 1.
    check_every: int = 1
    eps_abs: float = 1e-9
    eps_rel: float = 1e-9
    adapt_rho: bool = True
    adapt_every: int = 25
    adapt_factor: float = 2.0
    adapt_ratio: float = 3.0
    projection: ProjectionConfig = ProjectionConfig()
    # consensus-exchange strategy.  Every mode gathers with index_select
    # and reduces with index_add_ here; the one-hot and radix layouts
    # exist for the TPU's matrix unit and are accepted for compatibility.
    consensus: str = "auto"
    # the one-hot layout's chunk width on the TPU: accepted for
    # compatibility and ignored, as consensus="onehot" is
    onehot_chunk: int = 512


class RouteResult(NamedTuple):
    """Solver output (tensors on the solver's device; see
    AdmmSolver.unbucket for the host view)."""

    objective: torch.Tensor  # c^T psi at the prox point
    psi: torch.Tensor  # (n,) net trade vector
    prices: torch.Tensor  # (n,) dual asset prices rho*nu
    deltas: Dict[str, torch.Tensor]  # bucket -> (K, m) tendered
    lambdas: Dict[str, torch.Tensor]  # bucket -> (K, m) received
    iters: torch.Tensor
    r_norm: torch.Tensor  # final primal residual norm
    s_norm: torch.Tensor  # final dual residual norm
    converged: torch.Tensor
    rho_final: torch.Tensor  # penalty at exit (prices == rho_final * nu)


def _bucket_device_arrays(compiled: CompiledProblem, dtype, device, fold=None):
    """Slot-major (K, m) device copies, plus the fixed slot order of the
    deterministic reduction (``order``, ``seg``: ``ops/segment.py``).

    Padding slots carry the first asset index of their scenario point (0
    unfolded): every consensus read/write is masked instead, which keeps
    the asset vectors at exactly n entries, and a folded kernel block reads
    only ids of its own point."""
    out = {}
    for name, b in compiled.buckets.items():
        pad_id = 0
        if fold is not None:
            pad_id = (np.arange(b.m) // (b.m // fold[0]) * fold[1])[:, None]
        asset = np.where(b.mask > 0, b.asset, pad_id).astype(np.int32)
        if asset.size and (asset.min() < 0 or asset.max() >= compiled.n_assets):
            raise ValueError(f"bucket {name!r} has asset ids outside [0, n)")

        def dev(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

        order, seg = slot_order(asset.T, b.mask.T, compiled.n_assets)

        out[name] = dict(
            R=dev(b.reserves.T),
            w=dev(b.weights.T),
            s=dev(b.shift.T),
            gamma=dev(b.gamma[:, 0]),
            logk0=dev(b.logk0),
            k0=dev(b.k0),
            mask=dev(b.mask.T),
            asset=dev(asset.T, torch.int32),
            order=dev(order, torch.int32),
            seg=dev(seg, torch.int32),
        )
    return out


def _fused_ok(solver) -> bool:
    """Whether the fused kernels can run a solver's buckets: every bucket's
    pool count per scenario point (all of it unfolded) is a multiple of 128,
    the kernels' block of pools.  (The JAX package tests the folded count,
    which lets a fold of unaligned points through to a kernel that cannot
    tile them.)"""
    T = 1 if solver._fold is None else solver._fold[0]
    return all(
        a["mask"].shape[1] % T == 0 and (a["mask"].shape[1] // T) % 128 == 0
        for a in solver.buckets.values()
    )


def _reserve_buckets(solver, compiled_scaled):
    """The solver's bucket arrays with R, k0 and logk0 taken from a compiled
    problem of the same topology (scaled reserves)."""
    out = {}
    for name, b in compiled_scaled.buckets.items():
        arrs = dict(solver.buckets[name])
        arrs.update(R=solver._t(np.ascontiguousarray(b.reserves.T)),
                    k0=solver._t(b.k0), logk0=solver._t(b.logk0))
        out[name] = arrs
    return out


def bucket_groups(solver):
    """A solver's buckets grouped by channel count K for the grouped kernels
    (``project_grouped``, ``fused_step_grouped``,
    ``fused_step_delta_grouped``, ``project_delta_grouped``): groups in
    ascending K, buckets in sorted-name order inside a group, at most
    ``MAX_GROUP`` buckets each.  A group holds its ``K``, its ``names``,
    their ``kinds`` ((kind, needs_floor)) and its own fixed slot order
    (``order``/``seg``) over the buckets' consensus-term planes flattened
    one after another."""
    by_k = {}
    for name in sorted(solver.buckets):
        by_k.setdefault(solver.buckets[name]["mask"].shape[0], []).append(name)
    groups = []
    for K, names in sorted(by_k.items()):
        for i in range(0, len(names), MAX_GROUP):
            part = names[i:i + MAX_GROUP]
            flat = [np.concatenate([host(solver.buckets[nm][key]).reshape(-1)
                                    for nm in part])
                    for key in ("asset", "mask")]
            order, seg = slot_order(*flat, solver.n)
            groups.append(dict(
                K=K, names=part, kinds=[solver._meta[nm] for nm in part],
                order=torch.as_tensor(order, device=solver.device),
                seg=torch.as_tensor(seg, device=solver.device)))
    return groups


class AdmmSolver:
    """ADMM solver bound to one problem structure and one device.

    ``device=None`` runs on the current CUDA device and raises without
    one; ``device="cpu"`` runs the plain PyTorch versions of the kernels.
    ``fold=(T, n_pt)``: ``compiled`` is a scenario fold of T points of n_pt
    assets each (``solver/fold.py``; see the module docstring).
    """

    def __init__(
        self,
        compiled: CompiledProblem,
        dtype: torch.dtype = torch.float32,
        options: AdmmOptions = AdmmOptions(),
        device=None,
        axis_name: Optional[str] = None,
        fold=None,
    ):
        if axis_name is not None:
            raise _not_ported("sharded consensus (axis_name)", "queue 1, item 14")
        if options.consensus not in _CONSENSUS_MODES:
            raise ValueError(f"unknown consensus mode {options.consensus!r}")
        if fold is not None:
            fold = (int(fold[0]), int(fold[1]))
            if fold[0] * fold[1] != compiled.n_assets:
                raise ValueError(f"fold={fold} does not cover the problem's "
                                 f"{compiled.n_assets} assets")
        self._fold = fold
        self.compiled = compiled
        self.dtype = dtype
        self.device = resolve_device(device)
        self.options = options
        self.n = compiled.n_assets
        self.buckets = _bucket_device_arrays(compiled, dtype, self.device, fold)
        self._meta = {
            name: (b.kind, b.needs_floor) for name, b in compiled.buckets.items()
        }
        self.degree = self._t(compiled.degree)
        mode = options.consensus
        if mode == "auto":
            mode = "onehot" if self.n <= 512 else "radix"
        self.consensus = mode
        self._alpha = self._t(options.alpha)
        self._merged = None  # the merged K-groups, built at first use
        self._graphs = GraphCache()  # captured iteration blocks (card only)

    @functools.cached_property
    def _groups(self):
        """This solver's :func:`bucket_groups`, built once: only the topology
        enters, which every ``buckets=`` override (reserve scenarios, delta
        arrays) shares."""
        return bucket_groups(self)

    def _t(self, x) -> torch.Tensor:
        """A tensor of the solve dtype on the solver's device."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=self.dtype)
        return torch.as_tensor(np.asarray(x, np.float64), dtype=self.dtype,
                               device=self.device)

    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    # ---- scenario folds: per-point sums and broadcasts -----------------------

    def _plane_sum(self, x):
        """Sum of a (K, m) plane: a scalar, or (T,) per point on a fold."""
        if self._fold is None:
            return torch.sum(x)
        K, m = x.shape
        T = self._fold[0]
        return x.reshape(K, T, m // T).sum(dim=(0, 2))

    def _asset_sum(self, x):
        """Sum of an (n,) vector: a scalar, or (T,) per point on a fold."""
        if self._fold is None:
            return torch.sum(x)
        return x.reshape(self._fold[0], -1).sum(dim=1)

    def _per_asset(self, x):
        """A scalar unchanged; a (T,) per-point vector repeated to (n,)."""
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            return x
        return x.repeat_interleave(self._fold[1])

    @staticmethod
    def _joint(stats):
        """Residual sums over all points of a fold (scalars pass through)."""
        return {k: v.sum() for k, v in stats.items()}

    def _residuals(self, stats, sqn):
        """(r, s, eps_pri, eps_dua) from one iteration's residual sums."""
        opts = self.options
        r = torch.sqrt(stats["r2"])
        sd = torch.sqrt(stats["s2"])
        eps_pri = opts.eps_abs * sqn + opts.eps_rel * torch.sqrt(
            torch.maximum(stats["w_norm2"], stats["z_norm2"])
        )
        eps_dua = opts.eps_abs * sqn + opts.eps_rel * torch.sqrt(stats["u_norm2"])
        return r, sd, eps_pri, eps_dua

    # ---- consensus exchange -------------------------------------------------
    # Broadcast the n-vector nu to every (pool, slot) edge, and reduce
    # per-edge values back to the n-vector.

    def _bcast_nu(self, nu, name, buckets=None):
        arrs = (self.buckets if buckets is None else buckets)[name]
        K, m = arrs["mask"].shape
        return nu.index_select(0, arrs["asset"].reshape(-1)).reshape(K, m) * arrs["mask"]

    def _reduce_edges(self, planes, buckets):
        """sum_{slots with asset j} of every bucket's pre-masked (K, m)
        plane -> (n,).  On the card: one fixed-order segment-sum kernel per
        K-group (:attr:`_groups`) over its buckets' planes one after
        another, the groups' sums added in group order.  On the CPU:
        ``index_add_`` bucket by bucket."""
        if next(iter(planes.values())).device.type == "cuda":
            y = None
            for g in self._groups:
                vals = [planes[nm].reshape(-1) for nm in g["names"]]
                vals = vals[0].contiguous() if len(vals) == 1 else torch.cat(vals)
                yg = segment_sum(vals, g["order"], g["seg"], self.n)
                y = yg if y is None else y + yg
            return y
        y = self._zeros(self.n)
        for name, vals in planes.items():
            y = y + self._zeros(self.n).index_add_(
                0, buckets[name]["asset"].reshape(-1), vals.reshape(-1))
        return y

    # ---- single iteration ---------------------------------------------------

    def _project_groups(self, inputs, buckets):
        """Project every bucket's (p, q) = ``inputs[name]`` onto its trading
        sets, one :func:`project_grouped` launch per K-group
        (:attr:`_groups`) on the card, each bucket's plain projection on
        the CPU.  ``buckets``: the arrays to project with (the solver's own,
        or an override with the same names).  Returns name -> (D, L)."""
        out = {}
        for g in self._groups:
            missing = [nm for nm in g["names"] if nm not in buckets]
            if missing:
                raise KeyError(f"the bucket arrays lack {missing}, which the "
                               f"solver's K = {g['K']} group projects")
            out.update(project_grouped(inputs, buckets, g,
                                       cfg=self.options.projection))
        return out

    def _prox(self, s, c, lo, hi, rho, util=None):
        """The consensus prox: linear (``util=None``), separable concave (a
        PackedUtility) or non-separable (a :class:`CustomUtility`)."""
        rho = self._per_asset(rho)
        if util is None:
            return psi_prox(s, self.degree, c, lo, hi, rho)
        if isinstance(util, CustomUtility):
            return custom_prox(s, self.degree, util, lo, hi, rho)
        return utility_prox(s, self.degree, util, rho)

    @staticmethod
    def _objective_value(c, psi, util=None):
        if util is None:
            return torch.sum(c * psi)
        if isinstance(util, (CustomUtility, DeltaCustomUtility)):
            with torch.no_grad():
                return util.fn(psi)
        return utility_value(util, psi)

    def _iterate(self, z, nu, rho, c, lo, hi, with_stats=True, buckets=None,
                 util=None):
        """One ADMM iteration. Returns (z_new, nu_new, psi, w, stats).

        ``with_stats=False`` skips the residual accumulations (the
        ``check_every`` fast path).  z / w are dicts name -> (D, L) pairs of
        (K, m) planes.  ``util``: a PackedUtility switches the consensus
        prox from the linear closed form to the separable-concave one."""
        buckets = self.buckets if buckets is None else buckets
        alpha = self._alpha
        inputs = {}
        for name in buckets:
            nu_e = self._bcast_nu(nu, name, buckets)
            zD, zL = z[name]
            inputs[name] = (zD - nu_e, zL + nu_e)
        proj = self._project_groups(inputs, buckets)
        w_hat = {}
        cterm = {}
        w_norm2 = self._zeros()
        for name in buckets:
            zD, zL = z[name]
            D, L = proj[name]
            if with_stats:
                w_norm2 = w_norm2 + (self._plane_sum(D * D) + self._plane_sum(L * L))
            hD = alpha * D + (1.0 - alpha) * zD
            hL = alpha * L + (1.0 - alpha) * zL
            w_hat[name] = (D, L, hD, hL)
            cterm[name] = hL - hD
        yhat = self._reduce_edges(cterm, buckets)

        s = yhat - 2.0 * self.degree * nu
        psi, mu = self._prox(s, c, lo, hi, rho, util)

        z_new = {}
        w_out = {}
        r2 = self._zeros()
        s2 = self._zeros()
        z_norm2 = self._zeros()
        for name in buckets:
            D, L, hD, hL = w_hat[name]
            dmu = self._bcast_nu(nu - mu, name, buckets)
            znD = hD + dmu
            znL = hL - dmu
            if with_stats:
                zD, zL = z[name]
                s2 = s2 + (self._plane_sum((znD - zD) ** 2)
                           + self._plane_sum((znL - zL) ** 2))
                rD = D - znD
                rL = L - znL
                r2 = r2 + (self._plane_sum(rD * rD) + self._plane_sum(rL * rL))
                z_norm2 = z_norm2 + (self._plane_sum(znD * znD)
                                     + self._plane_sum(znL * znL))
            z_new[name] = (znD, znL)
            w_out[name] = (D, L)

        u_norm2 = self._asset_sum(2.0 * self.degree * mu * mu)
        stats = dict(
            r2=r2, s2=s2 * rho * rho, w_norm2=w_norm2, z_norm2=z_norm2,
            u_norm2=u_norm2 * rho * rho,
        )
        return z_new, mu, psi, w_out, stats

    # ---- fused-kernel iteration path ---------------------------------------
    # State representation:  z(t) = s(t) +/- wdef(t)_e  with s the array
    # planes and wdef an O(n) deferred-broadcast vector (see
    # ops/iteration_cuda.py for the derivation).  One kernel launch per
    # bucket per iteration; all consensus algebra outside is O(n).

    def fused_init(self, buckets=None):
        buckets = self.buckets if buckets is None else buckets
        s0 = {
            name: (self._zeros(*arrs["mask"].shape), self._zeros(*arrs["mask"].shape))
            for name, arrs in buckets.items()
        }
        return s0, self._zeros(self.n), self._zeros(self.n)

    def _fold_pack(self, w):
        """(n,)-consensus vector -> the fused kernel's padded price layout
        (zero-padded to a multiple of 128), plus the inverse for the
        reduced y.

        A fold keeps this layout: point t's prices sit at t*n_pt ..
        (t+1)*n_pt - 1, a per-point stride of n_pt with no padding between
        points (the TPU's 1024-value per-point blocks were a Mosaic tiling
        rule), so a folded asset id is its index in v and y, and a kernel
        block stages n_pt prices from t*n_pt."""
        n = self.n
        n_pad = -(-n // 128) * 128
        v = torch.cat([w, self._zeros(n_pad - n)])
        return v, lambda y: y[:n]

    def _iterate_fused(self, s, wdef, nu, rho, c, lo, hi, buckets=None,
                       util=None):
        """One fused iteration: one ``fused_step_grouped`` launch and one
        segment sum per group of buckets with the same channel count
        (:attr:`_groups`), the groups' y added in group order."""
        buckets = self.buckets if buckets is None else buckets
        alpha = float(self.options.alpha)
        v, unpack = self._fold_pack(wdef - nu)
        y = None
        s_new = {}
        w_out = {}
        for g in self._groups:
            sg, wg, yg = fused_step_grouped(
                s, v, buckets, g, alpha, cfg=self.options.projection,
                fold=self._fold,
            )
            s_new.update(sg)
            w_out.update(wg)
            y = yg if y is None else y + yg
        yhat = unpack(y) - 2.0 * (1.0 - alpha) * self.degree * wdef
        svec = yhat - 2.0 * self.degree * nu
        psi, mu = self._prox(svec, c, lo, hi, rho, util)
        wdef_new = (1.0 - alpha) * wdef + nu - mu
        return s_new, wdef_new, mu, psi, w_out

    # ---- merged K-group fused path (one launch per channel count) ----------

    def _merged_groups(self):
        """The solver's buckets grouped by channel count K, each group on
        one concatenated pool axis: K-groups in ascending K, buckets in
        sorted-name order inside a group (the JAX package's order, so the
        merged state is the same concatenation).  A group holds its
        concatenated planes (R w s mask asset gamma logk0 k0), ``cls``: the
        int32 class of every 128-pool block (0 gm, 1 floored gm, 2 cs), on
        the host; ``spans``: its runs of one class as a host list of
        (start, stop, kind, needs_floor), one descriptor each of
        ``fused_step_merged``'s launch (at most ``MAX_GROUP``, else
        ``ValueError``); and its own fixed slot order (``order``/``seg``)
        over the concatenated planes.  Built once and cached; every bucket's
        pool count must be a multiple of 128."""
        if self._merged is not None:
            return self._merged
        by_k = {}
        for name in sorted(self.buckets):
            by_k.setdefault(self.buckets[name]["mask"].shape[0], []).append(name)
        groups = []
        for K, names in sorted(by_k.items()):
            parts = [self.buckets[nm] for nm in names]
            arrs = {key: torch.cat([a[key] for a in parts], dim=-1)
                    for key in ("R", "w", "s", "mask", "asset", "gamma",
                                "logk0", "k0")}
            cls = np.concatenate([
                np.full(a["mask"].shape[1] // 128, _KIND[self._meta[nm]], np.int32)
                for nm, a in zip(names, parts)
            ])
            spans = class_spans(cls)
            if len(spans) > MAX_GROUP:
                raise ValueError(
                    f"merged K-group K={K} ({names}): {len(spans)} runs of one "
                    f"pool kind, more than the merged kernel's table of "
                    f"{MAX_GROUP}")
            order, seg = slot_order(host(arrs["asset"]), host(arrs["mask"]), self.n)
            arrs.update(
                cls=torch.as_tensor(cls),
                spans=spans,
                order=torch.as_tensor(order, device=self.device),
                seg=torch.as_tensor(seg, device=self.device),
            )
            groups.append(dict(K=K, names=names,
                               ms=[a["mask"].shape[1] for a in parts], arrs=arrs))
        self._merged = groups
        return groups

    @staticmethod
    def _merge_state(s, groups):
        return [tuple(torch.cat([s[nm][i] for nm in g["names"]], dim=1)
                      for i in (0, 1)) for g in groups]

    @staticmethod
    def _split_state(sm, groups):
        out = {}
        for g, (sDm, sLm) in zip(groups, sm):
            off = 0
            for nm, m_b in zip(g["names"], g["ms"]):
                out[nm] = (sDm[:, off:off + m_b].contiguous(),
                           sLm[:, off:off + m_b].contiguous())
                off += m_b
        return out

    def _iterate_fused_merged(self, sm, wdef, nu, rho, c, lo, hi, groups,
                              util=None):
        """:meth:`_iterate_fused` on merged K-group state: one
        ``fused_step_merged`` launch (and one segment sum) per channel
        count."""
        alpha = float(self.options.alpha)
        v, unpack = self._fold_pack(wdef - nu)
        y = torch.zeros_like(v)
        sm_new = []
        w_out = []
        for g, (sDm, sLm) in zip(groups, sm):
            sDn, sLn, D, L, yp = fused_step_merged(
                sDm, sLm, v, g["arrs"], alpha, cfg=self.options.projection)
            sm_new.append((sDn, sLn))
            w_out.append((D, L))
            y = y + yp
        yhat = unpack(y) - 2.0 * (1.0 - alpha) * self.degree * wdef
        svec = yhat - 2.0 * self.degree * nu
        psi, mu = self._prox(svec, c, lo, hi, rho, util)
        wdef_new = (1.0 - alpha) * wdef + nu - mu
        return sm_new, wdef_new, mu, psi, w_out

    def fused_to_z(self, s, wdef, buckets=None):
        """Materialize the classic edge state z from the fused state."""
        buckets = self.buckets if buckets is None else buckets
        z = {}
        for name in buckets:
            we = self._bcast_nu(wdef, name, buckets)
            sD, sL = s[name]
            z[name] = (sD + we, sL - we)
        return z

    def _sqrt_edges(self, per_point=False):
        """sqrt of the edge count (of one point's, ``per_point`` on a fold):
        the absolute-tolerance scale."""
        edges = sum(2 * a["mask"].numel() for a in self.buckets.values())
        return math.sqrt(edges / (self._fold[0] if per_point else 1))

    def _solve_fused_impl(self, c, lo, hi, rho, n_iters, buckets=None,
                          z0=None, nu0=None, util=None, merged=False):
        """Fixed-iteration solve on the fused-kernel path.

        Runs ``n_iters`` fused iterations (one kernel launch per K-group per
        iteration, no residual bookkeeping in the loop; on the card in
        blocks of ``_FUSED_BLOCK`` replayed as a CUDA graph, the rest
        eager), then materializes the classic edge state and runs ONE
        classic iteration to harvest exact residual norms and
        exactly-feasible primal trades.

        ``z0``/``nu0`` warm-start the fused state: z = s + wdef_e with
        wdef = 0 reproduces any classic edge state exactly, so chunked
        callers (the refinement stage) chain fused chunks through
        :meth:`warm_state` with no conversion.

        ``merged=True`` (the solver's own buckets only) runs the iterations
        on the merged K-groups (:meth:`_iterate_fused_merged`)."""
        s, wdef, nu = self.fused_init(buckets)
        if z0 is not None:
            s = dict(z0)
        if nu0 is not None:
            nu = nu0
        consts = (rho, c, lo, hi, util)
        reps, rest = divmod(n_iters, _FUSED_BLOCK)
        if merged:
            if buckets is not None:
                raise ValueError("the merged path runs the solver's own buckets")
            groups = self._merged_groups()

            def step(st, k):
                return self._iterate_fused_merged(*st, *k[:4], groups,
                                                  util=k[4])[:3]

            st = (self._merge_state(s, groups), wdef, nu)
            st = run_block(self, "fused_merged", step, _FUSED_BLOCK, reps, st,
                           consts, owner=self.buckets)
            for _ in range(rest):
                st = step(st, consts)
            sm, wdef, nu = st
            s = self._split_state(sm, groups)
        else:
            def step(st, k):
                s_new, wdef_new, nu_new, _, _ = self._iterate_fused(
                    *st, *k[:4], buckets=buckets, util=k[4])
                return {nm: s_new[nm] for nm in st[0]}, wdef_new, nu_new

            st = run_block(self, "fused", step, _FUSED_BLOCK, reps,
                           (s, wdef, nu), consts,
                           owner=self.buckets if buckets is None else buckets)
            for _ in range(rest):
                st = step(st, consts)
            s, wdef, nu = st
        z = self.fused_to_z(s, wdef, buckets)
        z, nu, psi, w, st = self._iterate(z, nu, rho, c, lo, hi, buckets=buckets,
                                          util=util)
        r, sd, eps_pri, eps_dua = self._residuals(self._joint(st), self._sqrt_edges())
        return RouteResult(
            objective=self._objective_value(c, psi, util),
            psi=psi,
            prices=rho * nu,
            deltas={name: w[name][0] for name in w},
            lambdas={name: w[name][1] for name in w},
            iters=torch.tensor(n_iters + 1, device=self.device),
            r_norm=r,
            s_norm=sd,  # st["s2"] is already rho-scaled inside _iterate
            converged=(r <= eps_pri) & (sd <= eps_dua),
            rho_final=rho,
        )

    def _objective_arrays(self, objective):
        """(c, lo, hi) tensors of a linear :class:`Objective`, the box
        clipped to the float32 range."""
        if not isinstance(objective, Objective):
            raise TypeError(f"expected an Objective, got {type(objective).__name__}")
        c = self._t(objective.c)
        lo = self._t(np.maximum(objective.lo, -_F32_BIG))
        hi = self._t(np.minimum(objective.hi, _F32_BIG))
        return c, lo, hi

    def _pack(self, objective, custom=False):
        """(c, lo, hi, util) for an :class:`Objective` (util None) or a
        :class:`ConcaveUtility` (util its PackedUtility, c/lo/hi its
        packed fields); with ``custom=True`` (the classic path) also a
        :class:`CustomUtility` (util the instance itself, c zero, its box
        clipped to the float32 range)."""
        if isinstance(objective, ConcaveUtility):
            util = objective.pack(self.dtype, self.device)
            return util.c, util.lo, util.hi, util
        if isinstance(objective, Objective):
            return (*self._objective_arrays(objective), None)
        if isinstance(objective, CustomUtility):
            if not custom:
                raise TypeError(
                    "a CustomUtility runs on the classic path only "
                    "(AdmmSolver.solve): the fused kernels and ChunkedDriver "
                    "take an Objective or a ConcaveUtility")
            return (self._zeros(self.n),
                    self._t(np.maximum(objective.lo, -_F32_BIG)),
                    self._t(np.minimum(objective.hi, _F32_BIG)), objective)
        raise TypeError(
            "the objective must be an Objective, a ConcaveUtility or a "
            f"CustomUtility, not {type(objective).__name__}"
        )

    def solve_fused(
        self,
        objective,
        iters: int,
        rho: Optional[float] = None,
        merged: bool = False,
    ) -> RouteResult:
        """Fixed-iteration solve on the fused-kernel path, for an
        :class:`Objective` or a :class:`ConcaveUtility`.

        Requires every bucket's pool count to be a multiple of 128 (compile
        with ``pad_pools_to=128``), as the JAX package's fused path does.
        ``merged=True``: one ``fused_step_merged`` launch per channel count
        per iteration (the reference's merged kernel); not on a
        scenario fold, whose kernels stage one point's prices per block where
        the merged kernel would stage all T points'."""
        if merged and self._fold is not None:
            raise ValueError(
                "merged=True does not run on a scenario fold: the merged "
                "kernel stages the whole price vector (all T points) in each "
                "block's shared memory; the fold kernels (merged=False) stage "
                "one point's"
            )
        if not _fused_ok(self):
            raise ValueError(
                "every bucket's pool count (per scenario point) must be a "
                "multiple of 128 for the fused kernel — "
                "compile_spec/compile_table with pad_pools_to=128"
            )
        c, lo, hi, util = self._pack(objective)
        rho_v = self._t(rho if rho is not None else self.options.rho)
        return self._solve_fused_impl(c, lo, hi, rho_v, int(iters), util=util,
                                      merged=bool(merged))

    # ---- full solve ---------------------------------------------------------

    def _solve_impl(self, c, lo, hi, rho0, z0=None, nu0=None, max_iters=None,
                    buckets=None, util=None):
        """Residual-checked solve.  The loop reads one boolean back from the
        device per check (every ``check_every`` iterations)."""
        opts = self.options
        buckets = self.buckets if buckets is None else buckets
        budget = int(opts.max_iters if max_iters is None else max_iters)
        sqn = self._sqrt_edges()
        if z0 is None:
            z0 = {
                name: (self._zeros(*arrs["mask"].shape),
                       self._zeros(*arrs["mask"].shape))
                for name, arrs in buckets.items()
            }
        z = z0
        nu = self._zeros(self.n) if nu0 is None else nu0
        rho = self._t(rho0)
        check_every = max(1, int(opts.check_every))
        inf = self._t(math.inf)
        r = sd = inf
        eps_pri = eps_dua = self._zeros()
        psi = self._zeros(self.n)
        w = {name: (torch.zeros_like(zD), torch.zeros_like(zL))
             for name, (zD, zL) in z.items()}
        def step(state, k):  # one stats-free iteration
            z_new, nu_new, _, _, _ = self._iterate(
                *state, *k[:4], with_stats=False, buckets=buckets, util=k[4])
            return {nm: z_new[nm] for nm in state[0]}, nu_new

        k = 0
        while k < budget:
            z, nu = run_block(self, "classic", step, check_every - 1, 1,
                              (z, nu), (rho, c, lo, hi, util), owner=buckets)
            z, nu, psi, w, st = self._iterate(z, nu, rho, c, lo, hi,
                                              buckets=buckets, util=util)
            r, sd, eps_pri, eps_dua = self._residuals(self._joint(st), sqn)
            k += check_every
            if (opts.adapt_rho and (k % opts.adapt_every) < check_every
                    and k < budget // 2):
                # with check_every > 1 the counter advances in strides; fire
                # whenever a stride crosses an adapt_every boundary
                up = r > opts.adapt_ratio * sd
                dn = sd > opts.adapt_ratio * r
                one = torch.ones_like(rho)
                fac = torch.where(
                    up, one * opts.adapt_factor,
                    torch.where(dn, one / opts.adapt_factor, one),
                )
                rho = rho * fac
                nu = nu / fac
            if not bool((r > eps_pri) | (sd > eps_dua)):
                break

        return RouteResult(
            objective=self._objective_value(c, psi, util),
            psi=psi,
            prices=rho * nu,
            deltas={name: w[name][0] for name in self.buckets},
            lambdas={name: w[name][1] for name in self.buckets},
            iters=torch.tensor(k, device=self.device),
            r_norm=r,
            s_norm=sd,
            converged=(r <= eps_pri) & (sd <= eps_dua),
            rho_final=rho,
        )

    def warm_state(self, result: RouteResult, rho: Optional[float] = None):
        """Reconstruct an ADMM starting state (z0, nu0) from a prior solve.

        ``rho`` must be the penalty the next solve will run at.  The
        unscaled dual is penalty-free — prices == rho_final * nu — so the
        scaled dual for the new penalty is prices / rho_new."""
        rho = float(rho if rho is not None else self.options.rho)
        nu0 = self._t(result.prices) / rho
        # at the ADMM fixed point z == w exactly, so the edge state is just
        # the trades; the entire dual lives in nu
        z0 = {
            name: (self._t(result.deltas[name]).contiguous(),
                   self._t(result.lambdas[name]).contiguous())
            for name in self.buckets
        }
        return z0, nu0

    def solve(
        self,
        objective,
        rho: Optional[float] = None,
        warm: Optional[RouteResult] = None,
        max_iters: Optional[int] = None,
    ) -> RouteResult:
        """Solve for an :class:`Objective` (linear), a separable
        :class:`ConcaveUtility` or a non-separable :class:`CustomUtility`.
        ``warm`` continues from a prior result at the penalty it adapted
        to; ``max_iters`` overrides ``options.max_iters`` for this call.

        On the card a :class:`CustomUtility`'s check blocks are captured once
        per instance (``solver/graphs.py`` keys them by its identity); a
        ``fn`` that reads the host makes the capture raise."""
        c, lo, hi, util = self._pack(objective, custom=True)
        if rho is not None:
            rho_v = rho
        elif warm is not None:
            rho_v = float(host(warm.rho_final))
        else:
            rho_v = self.options.rho
        z0 = nu0 = None
        if warm is not None:
            z0, nu0 = self.warm_state(warm, rho_v)
        return self._solve_impl(c, lo, hi, rho_v, z0, nu0, max_iters=max_iters,
                                util=util)

    # ---- batched solves: one fold, a stopping test per point ----------------

    def _solve_batch_impl(self, c, lo, hi, rho0, z0=None, nu0=None,
                          max_iters=None, buckets=None):
        """:meth:`_solve_impl` on a fold with every point on its own: its
        own penalty (``rho0`` a scalar or (T,)), residuals, stopping test,
        rho adaptation and iteration count.  Each check runs the iterations
        for all points and keeps the new state only for the points still
        running, so a converged point stays frozen — point t ends as a
        solve of point t alone would.  Returns a folded RouteResult whose
        per-point fields (objective, iters, norms, converged, rho_final)
        are (T,) vectors."""
        opts = self.options
        buckets = self.buckets if buckets is None else buckets
        T = self._fold[0]
        budget = int(opts.max_iters if max_iters is None else max_iters)
        sqn = self._sqrt_edges(per_point=True)
        if z0 is None:
            z0 = {
                name: (self._zeros(*arrs["mask"].shape),
                       self._zeros(*arrs["mask"].shape))
                for name, arrs in buckets.items()
            }
        z = dict(z0)
        nu = self._zeros(self.n) if nu0 is None else nu0
        rho = self._t(rho0).expand(T).clone()
        check_every = max(1, int(opts.check_every))
        r = sd = torch.full((T,), math.inf, dtype=self.dtype, device=self.device)
        eps_pri = eps_dua = self._zeros(T)
        iters = torch.zeros(T, dtype=torch.int64, device=self.device)
        psi = self._zeros(self.n)
        w = {name: (torch.zeros_like(zD), torch.zeros_like(zL))
             for name, (zD, zL) in z.items()}
        def step(state, k):  # one stats-free iteration of every point
            z_new, nu_new, _, _, _ = self._iterate(
                *state, *k, with_stats=False, buckets=buckets)
            return {nm: z_new[nm] for nm in state[0]}, nu_new

        k = 0  # the iteration count of every point still running
        while True:
            live = (iters < budget) & ((r > eps_pri) | (sd > eps_dua))
            if not bool(live.any()):
                break
            z_n, nu_n = run_block(self, "batch", step, check_every - 1, 1,
                                  (z, nu), (rho, c, lo, hi), owner=buckets)
            z_n, nu_n, psi_n, w_n, st = self._iterate(z_n, nu_n, rho, c, lo, hi,
                                                      buckets=buckets)
            r_n, sd_n, ep_n, ed_n = self._residuals(st, sqn)
            k += check_every
            rho_n = rho
            if (opts.adapt_rho and (k % opts.adapt_every) < check_every
                    and k < budget // 2):
                one = torch.ones_like(rho)
                fac = torch.where(
                    r_n > opts.adapt_ratio * sd_n, one * opts.adapt_factor,
                    torch.where(sd_n > opts.adapt_ratio * r_n,
                                one / opts.adapt_factor, one),
                )
                rho_n = rho * fac
                nu_n = nu_n / self._per_asset(fac)
            live_a = self._per_asset(live)
            nu = torch.where(live_a, nu_n, nu)
            psi = torch.where(live_a, psi_n, psi)
            rho, r, sd, eps_pri, eps_dua = (
                torch.where(live, new, old) for new, old in
                ((rho_n, rho), (r_n, r), (sd_n, sd), (ep_n, eps_pri),
                 (ed_n, eps_dua)))
            iters = torch.where(live, iters + check_every, iters)
            for name, (zD, zL) in z.items():
                live_p = live.repeat_interleave(zD.shape[1] // T)
                z[name] = (torch.where(live_p, z_n[name][0], zD),
                           torch.where(live_p, z_n[name][1], zL))
                w[name] = (torch.where(live_p, w_n[name][0], w[name][0]),
                           torch.where(live_p, w_n[name][1], w[name][1]))

        return RouteResult(
            objective=self._asset_sum(c * psi),
            psi=psi,
            prices=self._per_asset(rho) * nu,
            deltas={name: w[name][0] for name in self.buckets},
            lambdas={name: w[name][1] for name in self.buckets},
            iters=iters,
            r_norm=r,
            s_norm=sd,
            converged=(r <= eps_pri) & (sd <= eps_dua),
            rho_final=rho,
        )

    def _unfold_batch(self, res: RouteResult) -> RouteResult:
        """A folded result -> leading-axis-T tensors: psi/prices (T, n_pt),
        deltas/lambdas (T, K, m_pt)."""
        T = self._fold[0]

        def planes(d):
            return {k: v.reshape(v.shape[0], T, -1).permute(1, 0, 2).contiguous()
                    for k, v in d.items()}

        return res._replace(psi=res.psi.reshape(T, -1),
                            prices=res.prices.reshape(T, -1),
                            deltas=planes(res.deltas), lambdas=planes(res.lambdas))

    def _batch_solver(self, T: int) -> "AdmmSolver":
        """This solver's problem folded T times (cached: ``solver/fold.py``)."""
        if self._fold is not None:
            raise ValueError("batched solves run on an unfolded solver")
        from .fold import folded_solver

        return folded_solver(self.compiled, T, self.options, self.dtype,
                             cls=type(self), device=self.device)[0]

    def solve_batch(self, c, lo, hi, rho: Optional[float] = None) -> RouteResult:
        """T linear objectives, (T, n) rows of ``c``/``lo``/``hi``, solved as
        T independent solves (per-point penalty, stopping test and
        iteration count; point t equals ``solve`` of point t alone).  They
        run as one fold on the pool axis (:meth:`_solve_batch_impl`), the
        kernels' explicit batch.  Returns a RouteResult with leading axis T."""
        c = np.asarray(c, np.float64)
        T = c.shape[0]
        fs = self._batch_solver(T)
        res = fs._solve_batch_impl(
            fs._t(c.reshape(-1)), fs._t(np.asarray(lo, np.float64).reshape(-1)),
            fs._t(np.asarray(hi, np.float64).reshape(-1)),
            rho if rho is not None else self.options.rho,
        )
        return fs._unfold_batch(res)

    def batch_reserve_arrays(self, reserve_scale):
        """Bucket arrays for B per-pool reserve scenarios on this problem
        folded B times: ``reserve_scale`` (B, n_pools) multiplies each
        pool's reserves per scenario (padding pools by 1); R, k0 and logk0
        are each point's own, the rest is the fold's topology."""
        from .fold import fold_compiled

        scale = np.asarray(reserve_scale, np.float64)
        if scale.ndim != 2 or scale.shape[1] != self.compiled.n_pools:
            raise ValueError(
                f"reserve_scale must be (B, n_pools={self.compiled.n_pools}); "
                f"got {scale.shape}"
            )
        fs = self._batch_solver(scale.shape[0])
        return _reserve_buckets(fs, fold_compiled(self.compiled, scale.shape[0],
                                                  scale))

    def solve_batch_reserves(self, objective, reserve_scale,
                             rho: Optional[float] = None) -> RouteResult:
        """One linear objective over B per-pool reserve scenarios (post-shock
        reserve states), each solved on its own as in :meth:`solve_batch`.
        Returns a RouteResult with leading axis B."""
        B = np.asarray(reserve_scale).shape[0]
        bdict = self.batch_reserve_arrays(reserve_scale)
        fs = self._batch_solver(B)
        c, lo, hi = (fs._t(np.tile(x, B)) for x in
                     (objective.c, np.maximum(objective.lo, -_F32_BIG),
                      np.minimum(objective.hi, _F32_BIG)))
        res = fs._solve_batch_impl(
            c, lo, hi, rho if rho is not None else self.options.rho,
            buckets=bdict,
        )
        return fs._unfold_batch(res)

    # ---- host-side unbucketing ---------------------------------------------

    def unbucket(self, result: RouteResult):
        """Return per-pool (delta, lambda) numpy arrays in spec order."""
        deltas = [None] * self.compiled.n_pools
        lambdas = [None] * self.compiled.n_pools
        for name, b in self.compiled.buckets.items():
            D = host(result.deltas[name])  # (K, m) slot-major
            L = host(result.lambdas[name])
            for r, pid in enumerate(b.pool_ids):
                k = int(self.compiled.widths[pid])
                deltas[pid] = D[:k, r]
                lambdas[pid] = L[:k, r]
        return deltas, lambdas
