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
except the residual check once every ``check_every`` iterations.
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


def _bucket_device_arrays(compiled: CompiledProblem, dtype, device):
    """Slot-major (K, m) device copies.

    Padding slots carry asset index 0: every consensus read/write is masked
    instead, which keeps the asset vectors at exactly n entries."""
    out = {}
    for name, b in compiled.buckets.items():
        asset = np.where(b.mask > 0, b.asset, 0).astype(np.int32)
        if asset.size and (asset.min() < 0 or asset.max() >= compiled.n_assets):
            raise ValueError(f"bucket {name!r} has asset ids outside [0, n)")

        def dev(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

        out[name] = dict(
            R=dev(b.reserves.T),
            w=dev(b.weights.T),
            s=dev(b.shift.T),
            gamma=dev(b.gamma[:, 0]),
            logk0=dev(b.logk0),
            k0=dev(b.k0),
            mask=dev(b.mask.T),
            asset=dev(asset.T, torch.int32),
        )
    return out


class AdmmSolver:
    """ADMM solver bound to one problem structure and one device.

    ``device=None`` runs on the current CUDA device and raises without
    one; ``device="cpu"`` runs the plain PyTorch versions of the kernels.
    """

    def __init__(
        self,
        compiled: CompiledProblem,
        dtype: torch.dtype = torch.float32,
        options: AdmmOptions = AdmmOptions(),
        device=None,
        axis_name: Optional[str] = None,
    ):
        if axis_name is not None:
            raise _not_ported("sharded consensus (axis_name)", "queue 1, item 14")
        if options.consensus not in _CONSENSUS_MODES:
            raise ValueError(f"unknown consensus mode {options.consensus!r}")
        self.compiled = compiled
        self.dtype = dtype
        self.device = resolve_device(device)
        self.options = options
        self.n = compiled.n_assets
        self.buckets = _bucket_device_arrays(compiled, dtype, self.device)
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

    # ---- consensus exchange -------------------------------------------------
    # Broadcast the n-vector nu to every (pool, slot) edge, and reduce
    # per-edge values back to the n-vector.

    def _bcast_nu(self, nu, name):
        arrs = self.buckets[name]
        K, m = arrs["mask"].shape
        return nu.index_select(0, arrs["asset"].reshape(-1)).reshape(K, m) * arrs["mask"]

    def _reduce_edges(self, vals, name):
        """sum_{slots with asset j} vals -> (n,).  vals must be pre-masked."""
        arrs = self.buckets[name]
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

    def _iterate(self, z, nu, rho, c, lo, hi, with_stats=True):
        """One ADMM iteration. Returns (z_new, nu_new, psi, w, stats).

        ``with_stats=False`` skips the residual accumulations (the
        ``check_every`` fast path).  z / w are dicts name -> (D, L) pairs of
        (K, m) planes."""
        alpha = self._alpha
        w_hat = {}
        w_norm2 = self._zeros()
        yhat = self._zeros(self.n)
        for name, arrs in self.buckets.items():
            nu_e = self._bcast_nu(nu, name)
            zD, zL = z[name]
            D, L = self._project(name, arrs, zD - nu_e, zL + nu_e)
            if with_stats:
                w_norm2 = w_norm2 + (torch.sum(D * D) + torch.sum(L * L))
            hD = alpha * D + (1.0 - alpha) * zD
            hL = alpha * L + (1.0 - alpha) * zL
            w_hat[name] = (D, L, hD, hL)
            yhat = yhat + self._reduce_edges(hL - hD, name)

        s = yhat - 2.0 * self.degree * nu
        psi, mu = psi_prox(s, self.degree, c, lo, hi, rho)

        z_new = {}
        w_out = {}
        r2 = self._zeros()
        s2 = self._zeros()
        z_norm2 = self._zeros()
        for name in self.buckets:
            D, L, hD, hL = w_hat[name]
            dmu = self._bcast_nu(nu - mu, name)
            znD = hD + dmu
            znL = hL - dmu
            if with_stats:
                zD, zL = z[name]
                s2 = s2 + (torch.sum((znD - zD) ** 2) + torch.sum((znL - zL) ** 2))
                rD = D - znD
                rL = L - znL
                r2 = r2 + (torch.sum(rD * rD) + torch.sum(rL * rL))
                z_norm2 = z_norm2 + (torch.sum(znD * znD) + torch.sum(znL * znL))
            z_new[name] = (znD, znL)
            w_out[name] = (D, L)

        u_norm2 = torch.sum(2.0 * self.degree * mu * mu)
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

    def fused_init(self):
        s0 = {
            name: (self._zeros(*arrs["mask"].shape), self._zeros(*arrs["mask"].shape))
            for name, arrs in self.buckets.items()
        }
        return s0, self._zeros(self.n), self._zeros(self.n)

    def _fold_pack(self, w, fold=None):
        """(n,)-consensus vector -> the fused kernel's padded price layout
        (zero-padded to a multiple of 128), plus the inverse for the
        reduced y."""
        if fold is not None:
            raise _not_ported("scenario folding (fold=)", "queue 1, item 13")
        n = self.n
        n_pad = -(-n // 128) * 128
        v = torch.cat([w, self._zeros(n_pad - n)])
        return v, lambda y: y[:n]

    def _iterate_fused(self, s, wdef, nu, rho, c, lo, hi):
        alpha = float(self.options.alpha)
        v, unpack = self._fold_pack(wdef - nu)
        y = torch.zeros_like(v)
        s_new = {}
        w_out = {}
        for name, arrs in self.buckets.items():
            kind, floor = self._meta[name]
            sD, sL = s[name]
            sDn, sLn, D, L, yp = fused_step(
                sD, sL, v, arrs, kind, floor, alpha, cfg=self.options.projection,
            )
            s_new[name] = (sDn, sLn)
            w_out[name] = (D, L)
            y = y + yp
        yhat = unpack(y) - 2.0 * (1.0 - alpha) * self.degree * wdef
        svec = yhat - 2.0 * self.degree * nu
        psi, mu = psi_prox(svec, self.degree, c, lo, hi, rho)
        wdef_new = (1.0 - alpha) * wdef + nu - mu
        return s_new, wdef_new, mu, psi, w_out

    def fused_to_z(self, s, wdef):
        """Materialize the classic edge state z from the fused state."""
        z = {}
        for name in self.buckets:
            we = self._bcast_nu(wdef, name)
            sD, sL = s[name]
            z[name] = (sD + we, sL - we)
        return z

    def _sqrt_edges(self):
        """sqrt of the edge count: the absolute-tolerance scale."""
        return math.sqrt(sum(2 * a["mask"].numel() for a in self.buckets.values()))

    def _solve_fused_impl(self, c, lo, hi, rho, n_iters):
        """Fixed-iteration solve on the fused-kernel path.

        Runs ``n_iters`` fused iterations (one kernel launch per bucket per
        iteration, no residual bookkeeping in the loop), then materializes
        the classic edge state and runs ONE classic iteration to harvest
        exact residual norms and exactly-feasible primal trades."""
        opts = self.options
        s, wdef, nu = self.fused_init()
        for _ in range(n_iters):
            s, wdef, nu, _, _ = self._iterate_fused(s, wdef, nu, rho, c, lo, hi)
        z = self.fused_to_z(s, wdef)
        z, nu, psi, w, st = self._iterate(z, nu, rho, c, lo, hi)
        r = torch.sqrt(st["r2"])
        sd = torch.sqrt(st["s2"])
        sqn = self._sqrt_edges()
        eps_pri = opts.eps_abs * sqn + opts.eps_rel * torch.sqrt(
            torch.maximum(st["w_norm2"], st["z_norm2"])
        )
        eps_dua = opts.eps_abs * sqn + opts.eps_rel * torch.sqrt(st["u_norm2"])
        return RouteResult(
            objective=torch.sum(c * psi),
            psi=psi,
            prices=rho * nu,
            deltas={name: w[name][0] for name in self.buckets},
            lambdas={name: w[name][1] for name in self.buckets},
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
        for name, arrs in self.buckets.items():
            m = arrs["mask"].shape[1]
            if m % 128 != 0:
                raise ValueError(
                    f"bucket {name!r} has {m} pools; the fused kernel needs "
                    "a multiple of 128 (1024 for big buckets) — "
                    "compile_spec/compile_table with pad_pools_to=128"
                )
        c, lo, hi = self._objective_arrays(objective)
        rho_v = self._t(rho if rho is not None else self.options.rho)
        return self._solve_fused_impl(c, lo, hi, rho_v, int(iters))

    # ---- full solve ---------------------------------------------------------

    def _solve_impl(self, c, lo, hi, rho0, z0=None, nu0=None, max_iters=None):
        """Residual-checked solve.  The loop reads one boolean back from the
        device per check (every ``check_every`` iterations)."""
        opts = self.options
        budget = int(opts.max_iters if max_iters is None else max_iters)
        sqn = self._sqrt_edges()
        if z0 is None:
            z0 = {
                name: (self._zeros(*arrs["mask"].shape),
                       self._zeros(*arrs["mask"].shape))
                for name, arrs in self.buckets.items()
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
                                               with_stats=False)
            z, nu, psi, w, st = self._iterate(z, nu, rho, c, lo, hi)
            r = torch.sqrt(st["r2"])
            sd = torch.sqrt(st["s2"])
            eps_pri = opts.eps_abs * sqn + opts.eps_rel * torch.sqrt(
                torch.maximum(st["w_norm2"], st["z_norm2"])
            )
            eps_dua = opts.eps_abs * sqn + opts.eps_rel * torch.sqrt(st["u_norm2"])
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

    def solve_batch(self, *args, **kwargs):
        raise _not_ported("batched solves (solve_batch)", "queue 1, item 13")

    def solve_batch_reserves(self, *args, **kwargs):
        raise _not_ported("reserve-scenario batches (solve_batch_reserves)",
                          "queue 1, item 13")

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
