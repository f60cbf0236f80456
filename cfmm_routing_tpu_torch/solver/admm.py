"""Consensus-ADMM driver.

An operator-splitting method whose per-iteration work is exactly: one
batched trading-set projection per bucket (``ops/projection.py``), one
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
iteration loops are Python loops that never read a device value back,
except the residual check once every ``check_every`` iterations.  On the
card every consensus reduction is a fixed-order segment sum
(``ops/segment.py``), so two runs give bitwise-equal iterates; on the CPU it
is ``index_add_``, which is sequential there.

The methods that touch bucket arrays take an optional ``buckets=`` override
(the refinement stage's delta arrays ride it; see
``solver/refine_device.py``).

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
import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .._device import host, resolve_device
from ..models.utility import Objective
from ..ops.iteration_cuda import fused_step
from ..ops.projection import ProjectionConfig
from ..ops.projection_cuda import project_cs_cuda, project_gm_cuda
from ..ops.prox import psi_prox
from ..ops.segment import segment_sum, slot_order
from .compiler import CompiledProblem

__all__ = ["AdmmOptions", "AdmmSolver", "RouteResult"]

_CONSENSUS_MODES = ("auto", "onehot", "radix", "scatter")
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

    def _reduce_edges(self, vals, name, buckets=None):
        """sum_{slots with asset j} vals -> (n,).  vals must be pre-masked.
        On the card: the fixed-order segment-sum kernel."""
        arrs = (self.buckets if buckets is None else buckets)[name]
        if vals.device.type == "cuda":
            return segment_sum(vals.contiguous(), arrs["order"], arrs["seg"],
                               self.n)
        return self._zeros(self.n).index_add_(
            0, arrs["asset"].reshape(-1), vals.reshape(-1)
        )

    # ---- single iteration ---------------------------------------------------

    def _project(self, name, arrs, pD, pL):
        kind, floor = self._meta[name]
        cfg = self.options.projection
        if kind == "gm":
            return project_gm_cuda(
                pD, pL, arrs["R"], arrs["w"], arrs["s"], arrs["gamma"],
                arrs["logk0"], arrs["k0"], arrs["mask"],
                needs_floor=floor, cfg=cfg,
            )
        return project_cs_cuda(
            pD, pL, arrs["R"], arrs["gamma"], arrs["w"], arrs["k0"],
            arrs["mask"], cfg=cfg,
        )

    def _iterate(self, z, nu, rho, c, lo, hi, with_stats=True, buckets=None):
        """One ADMM iteration. Returns (z_new, nu_new, psi, w, stats).

        ``with_stats=False`` skips the residual accumulations (the
        ``check_every`` fast path).  z / w are dicts name -> (D, L) pairs of
        (K, m) planes."""
        buckets = self.buckets if buckets is None else buckets
        alpha = self._alpha
        w_hat = {}
        w_norm2 = self._zeros()
        yhat = self._zeros(self.n)
        for name, arrs in buckets.items():
            nu_e = self._bcast_nu(nu, name, buckets)
            zD, zL = z[name]
            D, L = self._project(name, arrs, zD - nu_e, zL + nu_e)
            if with_stats:
                w_norm2 = w_norm2 + (self._plane_sum(D * D) + self._plane_sum(L * L))
            hD = alpha * D + (1.0 - alpha) * zD
            hL = alpha * L + (1.0 - alpha) * zL
            w_hat[name] = (D, L, hD, hL)
            yhat = yhat + self._reduce_edges(hL - hD, name, buckets)

        s = yhat - 2.0 * self.degree * nu
        psi, mu = psi_prox(s, self.degree, c, lo, hi, self._per_asset(rho))

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

    def _iterate_fused(self, s, wdef, nu, rho, c, lo, hi, buckets=None):
        buckets = self.buckets if buckets is None else buckets
        alpha = float(self.options.alpha)
        v, unpack = self._fold_pack(wdef - nu)
        y = torch.zeros_like(v)
        s_new = {}
        w_out = {}
        for name, arrs in buckets.items():
            kind, floor = self._meta[name]
            sD, sL = s[name]
            sDn, sLn, D, L, yp = fused_step(
                sD, sL, v, arrs, kind, floor, alpha, cfg=self.options.projection,
                fold=self._fold,
            )
            s_new[name] = (sDn, sLn)
            w_out[name] = (D, L)
            y = y + yp
        yhat = unpack(y) - 2.0 * (1.0 - alpha) * self.degree * wdef
        svec = yhat - 2.0 * self.degree * nu
        psi, mu = psi_prox(svec, self.degree, c, lo, hi, self._per_asset(rho))
        wdef_new = (1.0 - alpha) * wdef + nu - mu
        return s_new, wdef_new, mu, psi, w_out

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
                          z0=None, nu0=None):
        """Fixed-iteration solve on the fused-kernel path.

        Runs ``n_iters`` fused iterations (one kernel launch per bucket per
        iteration, no residual bookkeeping in the loop), then materializes
        the classic edge state and runs ONE classic iteration to harvest
        exact residual norms and exactly-feasible primal trades.

        ``z0``/``nu0`` warm-start the fused state: z = s + wdef_e with
        wdef = 0 reproduces any classic edge state exactly, so chunked
        callers (the refinement stage) chain fused chunks through
        :meth:`warm_state` with no conversion."""
        s, wdef, nu = self.fused_init(buckets)
        if z0 is not None:
            s = dict(z0)
        if nu0 is not None:
            nu = nu0
        for _ in range(n_iters):
            s, wdef, nu, _, _ = self._iterate_fused(s, wdef, nu, rho, c, lo, hi,
                                                    buckets=buckets)
        z = self.fused_to_z(s, wdef, buckets)
        z, nu, psi, w, st = self._iterate(z, nu, rho, c, lo, hi, buckets=buckets)
        r, sd, eps_pri, eps_dua = self._residuals(self._joint(st), self._sqrt_edges())
        return RouteResult(
            objective=torch.sum(c * psi),
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
        if not isinstance(objective, Objective):
            raise _not_ported(
                f"objective type {type(objective).__name__} (nonlinear "
                "utilities)", "queue 1, item 12",
            )
        c = self._t(objective.c)
        lo = self._t(np.maximum(objective.lo, -_F32_BIG))
        hi = self._t(np.minimum(objective.hi, _F32_BIG))
        return c, lo, hi

    def solve_fused(
        self,
        objective,
        iters: int,
        rho: Optional[float] = None,
        merged: bool = False,
    ) -> RouteResult:
        """Fixed-iteration solve on the fused-kernel path.

        Requires every bucket's pool count to be a multiple of 128 (compile
        with ``pad_pools_to=128``), as the JAX package's fused path does."""
        if merged:
            raise _not_ported("the merged K-group kernel (merged=True)",
                              "queue 2, item 5")
        if not _fused_ok(self):
            raise ValueError(
                "every bucket's pool count (per scenario point) must be a "
                "multiple of 128 for the fused kernel — "
                "compile_spec/compile_table with pad_pools_to=128"
            )
        c, lo, hi = self._objective_arrays(objective)
        rho_v = self._t(rho if rho is not None else self.options.rho)
        return self._solve_fused_impl(c, lo, hi, rho_v, int(iters))

    # ---- full solve ---------------------------------------------------------

    def _solve_impl(self, c, lo, hi, rho0, z0=None, nu0=None, max_iters=None,
                    buckets=None):
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
        k = 0
        while k < budget:
            for _ in range(check_every - 1):
                z, nu, _, _, _ = self._iterate(z, nu, rho, c, lo, hi,
                                               with_stats=False, buckets=buckets)
            z, nu, psi, w, st = self._iterate(z, nu, rho, c, lo, hi,
                                              buckets=buckets)
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
            objective=torch.sum(c * psi),
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
        """Solve for an :class:`Objective`.  ``warm`` continues from a prior
        result at the penalty it adapted to; ``max_iters`` overrides
        ``options.max_iters`` for this call."""
        c, lo, hi = self._objective_arrays(objective)
        if rho is not None:
            rho_v = rho
        elif warm is not None:
            rho_v = float(host(warm.rho_final))
        else:
            rho_v = self.options.rho
        z0 = nu0 = None
        if warm is not None:
            z0, nu0 = self.warm_state(warm, rho_v)
        return self._solve_impl(c, lo, hi, rho_v, z0, nu0, max_iters=max_iters)

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
        k = 0  # the iteration count of every point still running
        while True:
            live = (iters < budget) & ((r > eps_pri) | (sd > eps_dua))
            if not bool(live.any()):
                break
            z_n, nu_n = z, nu
            for _ in range(check_every - 1):
                z_n, nu_n, _, _, _ = self._iterate(z_n, nu_n, rho, c, lo, hi,
                                                   with_stats=False,
                                                   buckets=buckets)
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
