"""Device-resident mixed-precision refinement: an f32 solve polished to a
certified gap by f32 correction solves on the card, certified in f64.

1.  From the f32 base solve (D0, L0, psi0, nu0), compute in f64 on the host
    the residual data: post-trade reserves x0 = R + s + gamma*D0 - L0, the
    log-domain constraint slack, the box residuals, and a correction scale
    eps from the certificate.
2.  Re-parametrize exactly: D = D0 + eps*a, L = L0 + eps*b.  The trading
    sets become the SHIFTED sets of ``ops/projection_delta.py``: same
    geometry, but the constraint residual is evaluated through ``log1p`` of
    O(eps)-relative quantities, so f32 carries ~eps * 1e-7 absolute
    precision on the correction.
3.  Run the same consensus ADMM on the correction problem with the dual
    RE-CENTRED at the base prices (:class:`DeltaAdmmSolver`: the
    state dual is dnu = nu - nu0, so no degree-amplified O(d*|nu|) f32
    products enter the consensus).  On the card the iteration is the fused
    ``fused_step_delta`` kernel, one launch per group of buckets with the
    same channel count K (``AdmmSolver._groups``).
4.  Compose D = D0 + eps*a in f64 on the host and certify rigorously
    (``solver/certify.py``).  Passes re-centre at the refined point.

:func:`refine_sweep` refines every point of a batched sweep at once: one
correction solve per pass over all T points, folded on the pool axis
(``solver/fold.py``; on the card the ``fused_step_delta(fold=)`` kernel)
or batched point by point, and one :func:`~.certify.certify_batch` per
pass.

:func:`refine_device` takes a linear :class:`Objective`, a separable
:class:`ConcaveUtility` or a :class:`CustomUtility` with its conjugate: every
atom maps exactly under the shift and scale (:func:`_delta_objective`), and
the re-centred consensus prox of a utility is
``ops/prox.py::delta_utility_prox`` (``delta_custom_prox`` for a custom one,
which runs on the classic delta path only).  :func:`refine_sweep` is
linear.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from .._device import host, resolve_device
from ..models.utility import (
    ConcaveUtility, CustomUtility, Objective, autograd_grad,
)
from ..ops.iteration_cuda import fused_step_delta_grouped
from ..ops.projection_cuda import project_delta_grouped
from ..ops.prox import (
    DeltaCustomUtility, DeltaUtility, delta_custom_prox, delta_utility_prox,
)
from ..utils.profiling import count, spanned
from . import _solver_cache
from .admm import (
    AdmmOptions, AdmmSolver, RouteResult, _F32_BIG, _FUSED_BLOCK, _fused_ok,
)
from .certify import certify, certify_batch, dual_bound, polish_prices
from .compiler import CompiledProblem
from .refine import RefineResult, to_host

__all__ = ["DeltaAdmmSolver", "refine_device", "refine_sweep",
           "SweepRefineResult"]

_LOG = logging.getLogger("cfmm_routing_tpu_torch.refine_device")


class DeltaAdmmSolver(AdmmSolver):
    """The consensus-ADMM solver re-targeted at shifted-scaled trading sets.
    Topology (asset ids, masks, slot order, degree) and the iteration are
    the base problem's but for three hooks: the projection input adds the
    pre-broadcast base-dual plane ``nu0e``, the projection is onto the
    shifted sets, and the consensus step is the re-centred prox (never a
    ``consensus_prox``: a sharded correction solve all-reduces and runs it
    on every rank).  The pass-varying delta arrays (X0, aD, aL, sS, nsig,
    nu0e) ride the ``buckets=`` override.

    The state dual is the DELTA dual dnu := nu_full - nu0 and ``c`` carries
    e0 := c_true/rho - nu0 (a utility: its :class:`DeltaUtility`), so the
    base dual enters only through ``nu0e``, with no degree amplification."""

    # its iterations count as "iters.refine" and its checked ones as
    # "checks.refine", in refine_device / refine_sweep
    _ITERS = None
    _planes = None  # the arrays of _pass_buckets, made at its first call

    def _edge_dual(self, nu, name, buckets):
        return buckets[name]["nu0e"] + self._bcast_nu(nu, name, buckets)

    def _project_group(self, inputs, buckets, g):
        return project_delta_grouped(inputs, buckets, g,
                                     cfg=self.options.projection)

    def _fused_group(self, s, v, buckets, g, alpha):
        return fused_step_delta_grouped(s, v, buckets, g, alpha,
                                        cfg=self.options.projection,
                                        fold=self._fold)

    def _consensus(self, yhat, nu, c, lo, hi, rho, util=None):
        """The re-centred prox.  Linear: ``c`` carries e0 = c_true/rho - nu0
        and ``nu`` the delta dual dnu, both small, so no O(d*|nu0|) product
        is formed:  psi = clip(yhat + 2 d (e0 - dnu)),  dmu = dnu + (psi -
        yhat) / (2 d).  A :class:`DeltaUtility` ``util`` runs
        :func:`delta_utility_prox`, a :class:`DeltaCustomUtility`
        :func:`delta_custom_prox`, in the same small quantities."""
        if isinstance(util, DeltaCustomUtility):
            return delta_custom_prox(nu, yhat, self.degree, util, rho)
        if util is not None:
            return delta_utility_prox(nu, yhat, self.degree, util,
                                      self._per_asset(rho))
        d_safe = torch.clamp_min(self.degree, 1.0)
        live = self.degree > 0
        psi = torch.clamp(yhat + 2.0 * d_safe * (c - nu), lo, hi)
        psi = torch.where(live, psi, torch.zeros_like(psi))
        dmu = nu + (psi - yhat) / (2.0 * d_safe)
        return psi, torch.where(live, dmu, torch.zeros_like(dmu))

    def solve_fused(self, *a, **k):
        raise ValueError(
            "DeltaAdmmSolver's fused path needs the per-pass delta bucket "
            "arrays: use solve_delta(..., fused=True)"
        )

    def delta_buckets(self, base: RouteResult, eps: float, nu0=None):
        """Pass-varying device arrays for the correction problem: the one
        point of :func:`_delta_buckets_folded`.

        ``base``: a host RouteResult in the units of the solver's
        CompiledProblem.  ``nu0``: the f32-exact base scaled dual; when
        given, every bucket gains the pre-broadcast ``nu0e`` plane the
        delta-dual iteration reads.  Returns (buckets, min_x0) with min_x0
        the smallest real-slot post-trade reserve."""
        trades = [{k: np.asarray(v)[None] for k, v in planes.items()}
                  for planes in (base.deltas, base.lambdas)]  # (1, K, m)
        out, min_x0 = _delta_buckets_folded(
            self, *trades, [eps], None if nu0 is None else np.asarray(nu0)[None])
        return out, float(min_x0[0])

    def _pass_buckets(self, base: RouteResult, eps: float, nu0):
        """:meth:`delta_buckets` with ``nu0``, written into arrays this
        solver keeps (:meth:`_keep`)."""
        out, min_x0 = self.delta_buckets(base, eps, nu0=nu0)
        return self._keep(out), min_x0

    def _keep(self, out):
        """A pass's delta arrays ``out``, written into arrays this solver
        keeps: every call returns the same dict of the same tensors, so the
        blocks captured on them replay in every pass (the arrays of the
        solvers :func:`refine_device` and :func:`refine_sweep` build for
        themselves, which no caller sees)."""
        if self._planes is None:
            self._planes = out
        else:
            for name, arrs in out.items():
                for key, x in arrs.items():
                    kept = self._planes[name][key]
                    if kept is not x:  # the pass's planes; not the topology's
                        kept.copy_(x)
        return self._planes

    def solve_delta(
        self,
        objective,
        bdict,
        nu0: np.ndarray,
        rho: float,
        max_iters: int,
        warm: Optional[RouteResult] = None,
        fused: bool = False,
        interpret: bool = False,
    ) -> RouteResult:
        """One correction solve on the delta bucket arrays.

        The delta-dual iteration: the state dual is dnu = nu - nu0 (starts
        at 0), ``c`` carries e0 = c/rho - nu0 (a utility: its
        :class:`DeltaUtility` carries e0u), and the returned ``prices`` are
        rho*dnu (add rho*nu0 for the true prices; :func:`refine_device`
        does).  ``warm`` chains chunks within a pass (a same-space
        RouteResult).

        ``fused=True`` runs ``max_iters`` fused delta iterations (the
        ``fused_step_delta`` kernel on the card, its plain version on the
        CPU) plus one classic residual-harvest iteration; every bucket's
        pool count must be a multiple of 128.  ``interpret``: the JAX
        package's Pallas interpret mode, accepted and ignored."""
        c, lo, hi, util, start_nu = _prep_delta_solve(objective, nu0, rho, self)
        if fused and isinstance(util, DeltaCustomUtility):
            raise ValueError(
                "the fused delta kernel does not take CustomUtility "
                "objectives yet — use fused=False (the classic delta path is "
                "equally precise)"
            )
        if warm is not None:
            z0, nu_start = self.warm_state(warm, rho)
        else:
            z0, nu_start = None, self._t(start_nu)
        rho_t = self._t(rho)
        if fused:
            if not _fused_ok(self):
                raise ValueError(
                    "fused=True needs every bucket's pool count to be a "
                    "multiple of 128: compile with pad_pools_to=128"
                )
            return self._solve_fused_impl(c, lo, hi, rho_t, int(max_iters),
                                          buckets=bdict, z0=z0, nu0=nu_start,
                                          util=util)
        return self._solve_impl(c, lo, hi, rho_t, z0, nu_start,
                                max_iters=int(max_iters), buckets=bdict,
                                util=util)

    # ---- batched correction solves: a fold with a stopping test per point --

    def delta_buckets_batch(self, deltas, lambdas, eps, nu0):
        """Delta arrays for T grid points in one shot, on this problem
        folded T times (:meth:`solve_delta_batch` runs on them).

        ``deltas``/``lambdas``: bucket name -> (T, K, m) base trades;
        ``eps``: (T,) per-point correction scales; ``nu0``: (T, n)
        float32-exact base scaled duals.  Returns (buckets, in_axes,
        min_x0 (T,)), the JAX package's triple.  ``in_axes`` maps every
        array of ``buckets`` to None: the fold lays the T points out along
        the pool axis, so no array carries a leading grid axis."""
        fs = self._batch_solver(len(np.asarray(eps)))
        out, min_x0 = _delta_buckets_folded(fs, deltas, lambdas, eps, nu0)
        axes = {name: dict.fromkeys(arrs) for name, arrs in out.items()}
        return out, axes, min_x0

    def solve_delta_batch(self, c, lo, hi, nu0, rho, bdict, axes, max_iters,
                          warm=None):
        """T correction solves (linear objectives, delta-dual iteration),
        each with its own penalty ``rho`` (T,) and its own stopping test:
        ``c`` (T, n) carries e0 = c_true/rho - nu0 per point, ``nu0`` the
        delta dual to start from, ``bdict`` the arrays of
        :meth:`delta_buckets_batch` (``axes``, its in_axes, is accepted at
        the JAX package's place and not needed).  ``warm``: a previous batched delta
        result (same centre) to chain chunks from: z0 = its trades, dnu0 =
        its prices / rho.  Returns a RouteResult with leading axis T."""
        rho = np.asarray(rho, np.float64)
        T = rho.shape[0]
        fs = self._batch_solver(T)
        rho_t = fs._t(rho)
        if warm is None:
            z0, dnu0 = None, fs._t(np.asarray(nu0, np.float64).reshape(-1))
        else:
            z0 = {name: tuple(fs._t(x[name]).permute(1, 0, 2).reshape(
                      x[name].shape[1], -1).contiguous()
                      for x in (warm.deltas, warm.lambdas))
                  for name in fs.buckets}
            dnu0 = (fs._t(warm.prices) / rho_t[:, None]).reshape(-1)
        res = fs._solve_batch_impl(
            fs._t(np.asarray(c, np.float64).reshape(-1)),
            fs._t(np.maximum(np.asarray(lo, np.float64), -_F32_BIG).reshape(-1)),
            fs._t(np.minimum(np.asarray(hi, np.float64), _F32_BIG).reshape(-1)),
            rho_t, z0=z0, nu0=dnu0, max_iters=int(max_iters), buckets=bdict,
        )
        return fs._unfold_batch(res)


def _np_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def _prep_delta_solve(objective, nu0, rho: float, solver):
    """(c, lo, hi, util, start_nu) for one correction solve; the delta dual
    starts at 0.

    Linear: c = e0 = c/rho - nu0 (f64, then the working dtype), the box
    clipped to the f32 range, util None.  A (delta-space) ConcaveUtility:
    util is its :class:`DeltaUtility`, whose fold constant
    e0u = U'_delta(0) - rho*nu0 and A = U'_delta(0) are computed in f64
    (linear/quad c, log c/b, power c*b^{p-1}); c is 0.  A
    :class:`DeltaCustomUtility`: its e0u = U'(psi0) - rho*nu0 with the
    gradient taken in float64 on the CPU; c is 0."""
    nu0 = np.asarray(nu0, np.float64)
    if isinstance(objective, DeltaCustomUtility):
        psi0_64 = np.asarray(objective.psi0, np.float64)
        up0 = autograd_grad(objective.base_fn,
                            torch.as_tensor(psi0_64, dtype=torch.float64)).numpy()
        util = DeltaCustomUtility(
            objective.base_fn, objective.smoothness, objective.prox_iters,
            *(solver._t(np.asarray(x, np.float64)) for x in
              (psi0_64, objective.eps, up0 - float(rho) * nu0, objective.lo,
               objective.hi)))
        return solver._zeros(solver.n), util.lo, util.hi, util, np.zeros_like(nu0)
    if isinstance(objective, ConcaveUtility):
        pack = objective.pack(solver.dtype, solver.device)
        k = np.asarray(objective.kind)
        c64 = np.asarray(objective.c, np.float64)
        b64 = np.maximum(np.asarray(objective.b, np.float64), 1e-300)
        p64 = np.asarray(objective.p, np.float64)
        up0 = np.where(k == 2, c64 / b64,
                       np.where(k == 3, c64 * b64 ** (np.clip(p64, 0.01, 0.99) - 1.0),
                                c64))
        util = DeltaUtility(*pack[:7], e0u=solver._t(up0 - float(rho) * nu0),
                            A=solver._t(up0), has_power=pack.has_power)
        return torch.zeros_like(pack.c), pack.lo, pack.hi, util, np.zeros_like(nu0)
    e0 = np.asarray(objective.c, np.float64) / float(rho) - nu0
    lo = solver._t(np.maximum(objective.lo, -_F32_BIG))
    hi = solver._t(np.minimum(objective.hi, _F32_BIG))
    return solver._t(e0), lo, hi, None, np.zeros_like(nu0)


def _check_objective(objective):
    if not isinstance(objective, (Objective, ConcaveUtility, CustomUtility)):
        raise TypeError("refine_device supports Objective / ConcaveUtility / "
                        "CustomUtility (with a conjugate), not "
                        f"{type(objective).__name__}")


def _curvature_scale(objective, psi0: np.ndarray) -> float:
    """max_j |U''_j(psi0_j)| of the objective: 0 for a linear one, the
    declared smoothness of a :class:`CustomUtility`.  The delta objective's
    curvature is eps times this, which sets the eps-regime penalty of
    :func:`refine_device`."""
    if isinstance(objective, CustomUtility):
        return float(objective.smoothness)
    if not isinstance(objective, ConcaveUtility):
        return 0.0
    k = np.asarray(objective.kind)
    c = np.asarray(objective.c, np.float64)
    a = np.asarray(objective.a, np.float64)
    b = np.asarray(objective.b, np.float64)
    p = np.clip(np.asarray(objective.p, np.float64), 0.01, 0.99)
    y = np.maximum(b + np.asarray(psi0, np.float64), 1e-12)
    curv = np.where(
        k == 1, a,
        np.where(k == 2, c / (y * y),
                 np.where(k == 3, np.abs(c * (1.0 - p)) * y ** (p - 2.0), 0.0)),
    )
    return float(np.max(curv, initial=0.0))


def _delta_objective(objective, psi0: np.ndarray, eps: float):
    """The correction problem's objective  U_delta(d) = U(psi0 + eps d)/eps.

    The 1/eps scaling keeps the correction's dual prices on the original
    price scale (d/dd [U/eps] = U'(psi0 + eps d)), so the base dual
    warm-starts it and the refined prices feed the certificate unchanged.
    Every atom maps exactly:

        linear   c psi                 ->  linear   c d            (+const)
        quad     c psi - a/2 psi^2     ->  quad     (c - a psi0) d - (a eps)/2 d^2
        log      c log(b + psi)        ->  log      (c/eps) log((b+psi0)/eps + d)
        power    (c/p)(b + psi)^p      ->  power    (c eps^{p-1}/p)((b+psi0)/eps + d)^p
        custom   U(psi)                ->  U(psi0 + eps d)/eps  (DeltaCustomUtility)

    A custom utility's psi0, eps and box are rounded to float32, as the JAX
    package's are; its fold constant e0u is filled in at solve preparation
    (:func:`_prep_delta_solve`).
    """
    _check_objective(objective)
    if isinstance(objective, CustomUtility):
        f32 = [np.float32(x) for x in (
            psi0, eps,
            np.clip((objective.lo - psi0) / eps, -_F32_BIG, _F32_BIG),
            np.clip((objective.hi - psi0) / eps, -_F32_BIG, _F32_BIG))]
        return DeltaCustomUtility(
            objective.fn, objective.smoothness, objective.prox_iters,
            f32[0], f32[1], np.zeros(np.shape(psi0), np.float32), f32[2], f32[3])
    lo = (objective.lo - psi0) / eps
    hi = (objective.hi - psi0) / eps
    if not isinstance(objective, ConcaveUtility):
        return Objective(objective.c, lo, hi)
    kind = objective.kind
    c = objective.c.copy()
    a = objective.a.copy()
    b = objective.b.copy()
    p = objective.p
    quad, log_, pow_ = (kind == k for k in (1, 2, 3))
    c[quad] = c[quad] - a[quad] * psi0[quad]
    a[quad] = a[quad] * eps
    c[log_] = c[log_] / eps
    b[log_] = (b[log_] + psi0[log_]) / eps
    c[pow_] = c[pow_] * eps ** (p[pow_] - 1.0)
    b[pow_] = (b[pow_] + psi0[pow_]) / eps
    return ConcaveUtility(kind=kind.copy(), c=c, a=a, b=b, p=p.copy(), lo=lo, hi=hi)


def _objective_value(objective, psi: np.ndarray) -> float:
    """The objective at psi in float64 on the host."""
    if isinstance(objective, (ConcaveUtility, CustomUtility)):
        return objective.value(psi)
    return float(np.asarray(objective.c, np.float64) @ psi)


def _compose(compiled, base, delta: RouteResult, eps: float, objective,
             prices):
    """f64 host composition of the refined point: D = D0 + eps*a, clamped
    to the orthant (the scaled bound is exact to f32, so the clamp moves a
    coordinate by at most ~1e-7*eps*|D0|, toward feasibility).  psi is
    recomputed from the composed trades; ``prices`` are the true prices."""
    deltas = {}
    lambdas = {}
    for name in compiled.buckets:
        D0 = np.asarray(base.deltas[name], np.float64)
        L0 = np.asarray(base.lambdas[name], np.float64)
        deltas[name] = np.maximum(
            D0 + eps * np.asarray(delta.deltas[name], np.float64), 0.0)
        lambdas[name] = np.maximum(
            L0 + eps * np.asarray(delta.lambdas[name], np.float64), 0.0)
    composed = base._replace(deltas=deltas, lambdas=lambdas)
    psi = _psi_from_trades(compiled, composed)
    return composed._replace(
        objective=np.float64(_objective_value(objective, psi)),
        psi=psi,
        prices=prices,
        iters=np.asarray(base.iters) + np.asarray(delta.iters),
        r_norm=np.asarray(delta.r_norm),
        s_norm=np.asarray(delta.s_norm),
        converged=np.asarray(delta.converged),
        rho_final=np.asarray(delta.rho_final),
    )


def _psi_from_trades(compiled, point: RouteResult) -> np.ndarray:
    """Exact f64 net trade of the point's TRADES (the consensus iterate
    ``point.psi`` lags them by the primal residual)."""
    psi = np.zeros(compiled.n_assets + 1)
    for name, b in compiled.buckets.items():
        D = np.asarray(point.deltas[name], np.float64)
        L = np.asarray(point.lambdas[name], np.float64)
        np.add.at(psi, b.asset.reshape(-1), ((L.T - D.T) * b.mask).reshape(-1))
    return psi[: compiled.n_assets]


def _check_cadence(objective, chunk_iters: int, options: AdmmOptions) -> int:
    """``check_every`` of :func:`refine_device`'s own delta solver.

    The largest divisor of ``chunk_iters`` that is at most ``_FUSED_BLOCK``:
    on the card the stats-free iterations between two checks replay as one
    captured block, and a chunk that does not converge stops at exactly
    ``chunk_iters``.  With ``adapt_rho=False`` a check changes no iterate,
    so a chunk run to its budget ends where a check every iteration would.
    A :class:`CustomUtility` keeps ``options.check_every`` (by default 1,
    eager): a block whose callable reads the host cannot be captured."""
    if isinstance(objective, CustomUtility):
        return options.check_every
    n = max(1, int(chunk_iters))
    return max(d for d in range(1, min(n, _FUSED_BLOCK) + 1) if n % d == 0)


def _count_chunk(solver, dres, fused: bool) -> int:
    """A correction chunk's iterations (the most of any point's), counted
    under ``iters.refine``, and its checked ones under ``checks.refine``:
    the fused path's one residual harvest, else one every ``check_every``
    (the classic loops advance in strides of it)."""
    it = int(host(dres.iters).max())
    count("iters.refine", it)
    count("checks.refine", 1 if fused else it // max(
        1, int(solver.options.check_every)))
    return it


class SweepRefineResult:
    """Batched refinement output (see :func:`refine_sweep`)."""

    def __init__(self, deltas, lambdas, prices, objectives, certificates,
                 achieved, iters):
        self.deltas = deltas  # bucket -> (T, K, m)
        self.lambdas = lambdas
        self.prices = prices  # (T, n)
        self.objectives = objectives  # (T,) float64 certificate objectives
        self.certificates = certificates  # list of T Certificate
        self.achieved = achieved  # (T,) bool
        self.iters = iters  # correction iterations dispatched for the grid


def _psi_batch(compiled, deltas, lambdas):
    """(T, n) exact float64 net trades of T candidate points."""
    n = compiled.n_assets
    T = next(iter(deltas.values())).shape[0]
    psi = np.zeros((T, n + 1))
    for name, b in compiled.buckets.items():
        D = np.asarray(deltas[name], np.float64)
        L = np.asarray(lambdas[name], np.float64)
        vals = ((L - D) * b.mask.T[None]).reshape(T, -1)
        idx = b.asset.T.reshape(-1)[None, :] + (n + 1) * np.arange(T)[:, None]
        psi += np.bincount(idx.reshape(-1), weights=vals.reshape(-1),
                           minlength=T * (n + 1)).reshape(T, n + 1)
    return psi[:, :n]


def _delta_buckets_folded(fsolver, deltas, lambdas, eps, nu0f):
    """The delta bucket arrays of T points: per-point (T, K, m) trades ->
    (K, T*m) planes on a FOLDED solver (``solver/fold.py``), or T = 1 on an
    unfolded one (:meth:`DeltaAdmmSolver.delta_buckets`).

    ``eps``: (T,) per-point correction scales, broadcast to each point's
    pool block; ``nu0f``: (T, n) float32-exact scaled base duals (their
    fold feeds the pre-broadcast nu0e plane through the folded asset ids),
    or None for no nu0e plane.  Returns (buckets, min_x0 (T,)): min_x0 is
    the smallest real-slot post-trade reserve per POINT, so one degenerate
    re-centre only sidelines its own grid point; callers fall back unless
    it is positive (the log-domain constraint needs x0 > 0)."""
    from .fold import fold_planes, fold_vec

    np_dt = _np_dtype(fsolver.dtype)
    eps = np.asarray(eps, np.float64)
    T = eps.shape[0]
    D0f = fold_planes(deltas)
    L0f = fold_planes(lambdas)
    nu0_ext = (None if nu0f is None else
               np.concatenate([np.asarray(fold_vec(nu0f), np.float64), [0.0]]))
    out = {}
    min_x0 = np.full(T, np.inf)
    for name, b in fsolver.compiled.buckets.items():
        kind, _ = fsolver._meta[name]
        D0 = np.asarray(D0f[name], np.float64)  # (K, m_f)
        L0 = np.asarray(L0f[name], np.float64)
        maskT = b.mask.T
        gamma = b.gamma[:, 0][None, :]
        m_f = maskT.shape[1]
        eps_col = np.repeat(eps, m_f // T)[None, :]  # (1, m_f)
        if kind == "gm":
            x0 = (b.reserves + b.shift).T + gamma * D0 - L0
            x0 = np.where(maskT > 0, x0, 1.0)
            logx0 = np.log(np.maximum(x0, 1e-300))
            nsig = -(np.sum(b.weights.T * logx0, axis=0) - b.logk0)
            real = np.where(maskT > 0, x0, np.inf)
            min_x0 = np.minimum(min_x0, np.min(real.reshape(-1, T, m_f // T),
                                               axis=(0, 2), initial=np.inf))
        else:
            x0 = b.reserves.T + gamma * D0 - L0
            x0 = np.where(maskT > 0, x0, 1.0)
            s0 = np.sum(b.weights.T * np.where(maskT > 0, x0, 0.0), axis=0)
            nsig = -(s0 - b.k0) / eps_col[0]  # scaled linear slack target
        planes = dict(
            w=b.weights.T,
            # lower-bounded: an extreme eps must not underflow X0 to 0
            # (it divides the constraint argument u = v / X0)
            X0=np.where(maskT > 0, np.maximum(x0 / eps_col, 1e-30), 1.0),
            aD=-D0 / eps_col,
            aL=-L0 / eps_col,
            sS=b.shift.T / eps_col,
            nsig=nsig,
        )
        if nu0_ext is not None:
            planes["nu0e"] = nu0_ext[b.asset].T * maskT
        arrs = dict(fsolver.buckets[name])  # asset/mask/gamma/order reused
        for key, val in planes.items():
            # f64 -> working dtype on the host, then one upload
            arrs[key] = torch.as_tensor(
                np.ascontiguousarray(val).astype(np_dt), device=fsolver.device)
        out[name] = arrs
    return out, min_x0


def _correction_eps(eps_factor: float, err, deltas, lambdas, T: int):
    """(T,) per-point correction scales eps: ``eps_factor`` x the point's
    certificate error (at least 1e-12) x its trade scale, at least 1e-10 x
    that scale.  The trade scale is the largest |D| or |L| of any of the
    point's slots ((T, K, m) planes, or (K, m) with T = 1), at least 1:
    eps is in solve-space PER-SLOT trade units (a per-asset psi scale
    oversizes it by the fan-in and the fixed-penalty solve crawls)."""
    scale = np.ones(T)
    for k in deltas:
        scale = np.maximum(scale, np.maximum(
            np.abs(np.asarray(deltas[k])).reshape(T, -1).max(axis=1),
            np.abs(np.asarray(lambdas[k])).reshape(T, -1).max(axis=1)))
    return np.clip(eps_factor * np.maximum(err, 1e-12) * scale, 1e-10 * scale,
                   np.inf)


def _penalty(use_eps, eps, rho_base, curv: float = 0.0):
    """A correction solve's penalty: 'eps' (``use_eps``), eps * max(curv,
    1) in [1e-6, 4] (curv is 0 for a linear objective), else 'base', the
    base solve's penalty in [0.25, 4] (a collapsed base rho blows nu0 =
    prices/rho up and the delta-dual design's f32 noise with it)."""
    return np.where(use_eps, np.clip(eps * max(curv, 1.0), 1e-6, 4.0),
                    np.clip(rho_base, 0.25, 4.0))


def _nu0_f32(prices, rho):
    """nu0 = prices / rho rounded to float32 ONCE: the same values go into
    the nu0e planes, e0 and the price reconstruction, which makes the
    re-centring exact."""
    return ((np.asarray(prices, np.float64) / rho)
            .astype(np.float32).astype(np.float64))


@spanned("refine")
def refine_sweep(
    compiled: CompiledProblem,
    c,
    lo,
    hi,
    result: RouteResult,
    target_gap: float = 1e-6,
    options: Optional[AdmmOptions] = None,
    solver: Optional[DeltaAdmmSolver] = None,
    max_passes: int = 4,
    iters_per_pass: int = 1000,
    eps_factor: float = 10.0,
    fold: Optional[bool] = None,
    device=None,
    scenarios: Optional[CompiledProblem] = None,
    cert_space=None,
) -> SweepRefineResult:
    """Refine EVERY point of a batched sweep to a certified gap with ONE
    correction solve per pass (linear objectives).

    ``c``/``lo``/``hi``: (T, n) per-point objectives; ``result``: a batched
    RouteResult (``AdmmSolver.solve_batch``, ``fold.solve_batch_folded``).
    Each pass re-centres all T points, runs one batched delta-dual solve,
    composes in float64 and certifies the whole grid with one
    :func:`~.certify.certify_batch` call.  A point takes a candidate only
    when it improves that point's certificate score, so a degenerate
    re-centre never regresses; points that miss the target are reported
    ``achieved=False`` (callers may fall back to :func:`refine_device`).
    Near-miss points whose blocker is dual looseness get the L-BFGS price
    polish at the end.

    ``fold`` (default: True unless a ``solver`` is passed) runs the grid's
    correction solves folded on the pool axis — one joint solve at rho=1
    with e0 built per point (the delta-dual iteration is rho-free for
    linear objectives) — on the ``fused_step_delta(fold=)`` kernel when the
    folded solver runs on the card and every point's bucket pool counts are
    multiples of 128, else classic.  ``fold=False`` runs each point with
    its own penalty and stopping test (:meth:`DeltaAdmmSolver.solve_delta_batch`).
    The delta dual starts at 0: the base dual enters only through e0 and
    the nu0e planes.  ``device``: where the solves and the certificates'
    eta search run (the card unless ``"cpu"``; a passed solver brings its
    own).

    ``scenarios``: T reserve states of one network instead of one network
    (``api.route_scenarios``), as the reserve-scaled fold
    ``fold.fold_compiled(compiled, T, reserve_scale)``: the folded delta
    solver is built on it, so each point's delta arrays read its own
    reserves, and each point is certified against them.  Its solver is
    kept across calls on the network (``solver/_solver_cache.py``, inside
    a lease).  ``cert_space``: optional ``(cert_compiled, cert_scenarios,
    (c, lo, hi), unscale_fn)``: refine in this (typically equilibrated)
    space but certify every point in the space ``unscale_fn`` maps a
    batched host RouteResult to, against ``cert_compiled`` (and the fold
    ``cert_scenarios`` of its reserve states, or None) and the (T, n)
    objectives given there.  The returned trades and prices stay in this
    space; the certificates and objectives are in ``cert_space``'s."""
    c = np.asarray(c, np.float64)
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    T = c.shape[0]
    res = to_host(result)
    deltas = {k: np.array(v, np.float64) for k, v in res.deltas.items()}
    lambdas = {k: np.array(v, np.float64) for k, v in res.lambdas.items()}
    prices = np.array(res.prices, np.float64)
    rho_f = np.broadcast_to(np.asarray(res.rho_final, np.float64), (T,))
    dev = solver.device if solver is not None else resolve_device(device)

    if fold is None:
        fold = solver is None  # a caller-built solver keeps the batched path
    if scenarios is not None and not (fold and solver is None):
        raise ValueError("refine_sweep(scenarios=) runs folded on its own "
                         "solver: drop solver= and fold=False")
    fsolver = None
    fused_fold = False
    if solver is None:
        base = options if options is not None else AdmmOptions()
        opts = dataclasses.replace(
            base, max_iters=int(iters_per_pass), eps_abs=1e-8, eps_rel=1e-8,
            adapt_rho=False,
        )
        if scenarios is not None:
            # checks as refine_device's own solver makes them: the classic
            # chunks replay their stats-free blocks on the card
            opts = dataclasses.replace(opts, check_every=_check_cadence(
                Objective(c[0], lo[0], hi[0]), iters_per_pass, base))
            fsolver = _solver_cache.own(DeltaAdmmSolver, scenarios, torch.float32,
                                        opts, dev, fold=(T, compiled.n_assets))
        elif fold:
            from .fold import folded_solver

            fsolver, _ = folded_solver(compiled, T, opts, torch.float32,
                                       cls=DeltaAdmmSolver, device=dev)
        if fsolver is not None:
            fused_fold = _fused_ok(fsolver) and fsolver.device.type == "cuda"
        else:
            solver = DeltaAdmmSolver(compiled, dtype=torch.float32, options=opts,
                                     device=dev)
    elif fold:
        raise ValueError(
            "refine_sweep(fold=True) builds its own folded solver — drop the "
            "solver argument or pass fold=False"
        )

    def _score(cert):
        return max(abs(cert.gap_rel), cert.feasibility_rel)

    if cert_space is None:
        cert_compiled, cert_scen, (cc, clo, chi) = compiled, scenarios, (c, lo, hi)
        unscale_fn = None
    else:
        cert_compiled, cert_scen, (cc, clo, chi), unscale_fn = cert_space
        cc, clo, chi = (np.asarray(x, np.float64) for x in (cc, clo, chi))

    def _in_cert(D, L, P, psi):
        """(deltas, lambdas, prices, psi) of T points in cert_space's units."""
        if unscale_fn is None:
            return D, L, P, psi
        pt = unscale_fn(RouteResult(
            objective=None, psi=psi, prices=P, deltas=D, lambdas=L, iters=None,
            r_norm=None, s_norm=None, converged=None, rho_final=None))
        return pt.deltas, pt.lambdas, pt.prices, pt.psi

    def _certify(D, L, P, psi):
        D, L, P, psi = _in_cert(D, L, P, psi)
        return certify_batch(cert_compiled, cc, clo, chi, D, L, P,
                             psi_claimed=psi, device=dev, scenarios=cert_scen)

    psi0 = _psi_batch(compiled, deltas, lambdas)
    certs = _certify(deltas, lambdas, prices, psi0)
    total = 0
    # per-point penalty regime (refine_device's two-mode ladder): points
    # start on the base penalty; a live point whose score fails to halve in
    # a pass switches to the eps-scaled regime (and back)
    use_eps = np.zeros(T, bool)
    prev_scores = np.full(T, np.inf)
    pass_fails = 0
    for _ in range(int(max_passes)):
        scores = np.array([_score(ct) for ct in certs])
        live = scores > target_gap
        if not live.any():
            break
        flip = live & (scores > 0.5 * prev_scores)
        use_eps[flip] = ~use_eps[flip]
        prev_scores = scores.copy()
        eps = _correction_eps(eps_factor, scores, deltas, lambdas, T)
        rho = _penalty(use_eps, eps, rho_f)
        nu0f = _nu0_f32(prices, rho[:, None])
        lo_d = np.clip((lo - psi0) / eps[:, None], -_F32_BIG, _F32_BIG)
        hi_d = np.clip((hi - psi0) / eps[:, None], -_F32_BIG, _F32_BIG)
        # warm-chained chunks against THIS pass's centre until the grid's
        # delta duals converge (composing a half-converged delta dual leaves
        # the certified gap at the entry level)
        if fold:
            from .fold import fold_vec, unfold_planes, unfold_vec

            bdict_f, min_x0 = _delta_buckets_folded(fsolver, deltas, lambdas,
                                                    eps, nu0f)
            bdict_f = fsolver._keep(bdict_f)
            dobj_f = Objective(fold_vec(c / rho[:, None]), lo=fold_vec(lo_d),
                               hi=fold_vec(hi_d))
            nu0_fold = fold_vec(nu0f)
            dres = None
            for _ck in range(4):
                dres = fsolver.solve_delta(dobj_f, bdict_f, nu0_fold, 1.0,
                                           iters_per_pass, warm=dres,
                                           fused=fused_fold)
                it_ck = _count_chunk(fsolver, dres, fused_fold)
                total += it_ck
                if it_ck < int(iters_per_pass) or bool(host(dres.converged)):
                    break
            dresh = to_host(dres)
            d_deltas = unfold_planes(dresh.deltas, T)
            d_lambdas = unfold_planes(dresh.lambdas, T)
            # the folded solve ran at rho=1: prices == dnu per point
            d_prices = rho[:, None] * unfold_vec(dresh.prices, T)
        else:
            bdict, axes, min_x0 = solver.delta_buckets_batch(deltas, lambdas, eps,
                                                             nu0f)
            e0 = c / rho[:, None] - nu0f
            dnu_start = np.zeros_like(nu0f)
            dres = None
            for _ck in range(4):
                dres = solver.solve_delta_batch(e0, lo_d, hi_d, dnu_start, rho,
                                                bdict, axes, iters_per_pass,
                                                warm=dres)
                it_ck = _count_chunk(solver, dres, False)
                total += it_ck
                if it_ck < int(iters_per_pass) or bool(host(dres.converged).all()):
                    break
            dresh = to_host(dres)
            d_deltas, d_lambdas = dresh.deltas, dresh.lambdas
            d_prices = np.asarray(dresh.prices, np.float64)
        # float64 composition of all T candidates
        e = eps[:, None, None]
        cand_D = {k: np.maximum(deltas[k] + e * d_deltas[k], 0.0) for k in deltas}
        cand_L = {k: np.maximum(lambdas[k] + e * d_lambdas[k], 0.0) for k in deltas}
        cand_prices = rho[:, None] * nu0f + d_prices
        cand_psi = _psi_batch(compiled, cand_D, cand_L)
        cand_certs = _certify(cand_D, cand_L, cand_prices, cand_psi)
        improved = False
        for t in np.flatnonzero(live):
            if min_x0[t] <= 0 or not np.isfinite(min_x0[t]):
                continue  # degenerate re-centre; keep the entry point
            if _score(cand_certs[t]) < scores[t]:
                improved = True
                certs[t] = cand_certs[t]
                prices[t] = cand_prices[t]
                psi0[t] = cand_psi[t]
                for k in deltas:
                    deltas[k][t] = cand_D[k][t]
                    lambdas[k][t] = cand_L[k][t]
        if not improved:
            # a failed pass flips every live point's regime; two failed
            # passes in a row end the loop
            if pass_fails:
                break
            pass_fails = 1
            use_eps[live] = ~use_eps[live]
            prev_scores = np.full(T, np.inf)  # don't double-flip next pass
        else:
            pass_fails = 0
    # near-miss stragglers whose blocker is pure dual looseness get the
    # per-point L-BFGS price polish, on the point's own problem in
    # cert_space's units
    polish = [t for t in range(T) if _score(certs[t]) > target_gap and (
        0.0 < certs[t].gap_rel <= max(20.0 * target_gap, 1e-5)
        and certs[t].feasibility_rel <= target_gap)]
    if polish:
        from .fold import scenario_point

        pD, pL, pP, ppsi = _in_cert(deltas, lambdas, prices, psi0)
    for t in polish:
        ct = certs[t]
        comp_t = (cert_compiled if cert_scen is None else
                  scenario_point(cert_compiled, cert_scen, t))
        obj_t = Objective(cc[t], lo=clo[t], hi=chi[t])
        nu_p = polish_prices(comp_t, obj_t, pP[t], max_evals=60, device=dev)
        cert_p = certify(comp_t, obj_t, {k: v[t] for k, v in pD.items()},
                         {k: v[t] for k, v in pL.items()}, nu_p,
                         psi_claimed=ppsi[t], device=dev)
        if cert_p.gap_abs < ct.gap_abs:
            certs[t] = cert_p
            if unscale_fn is None:
                prices[t] = cert_p.prices
    achieved = np.array([_score(ct) <= target_gap for ct in certs])
    return SweepRefineResult(
        deltas=deltas, lambdas=lambdas, prices=prices,
        objectives=np.array([ct.objective for ct in certs]),
        certificates=certs, achieved=achieved, iters=total,
    )


@spanned("refine")
def refine_device(
    compiled: CompiledProblem,
    objective,
    result: RouteResult,
    target_gap: float = 1e-6,
    options: Optional[AdmmOptions] = None,
    max_passes: int = 4,
    chunk_iters: int = 250,
    chunks_per_pass: int = 8,
    solver: Optional[DeltaAdmmSolver] = None,
    polish: bool = True,
    cert_space=None,
    rho0: Optional[float] = None,
    eps_factor: float = 10.0,
    fused: Optional[bool] = None,
    interpret: bool = False,
    entry_cert=None,
    device=None,
) -> RefineResult:
    """Polish an f32 solve to a certified gap with f32 correction solves on
    the device (see the module docstring); the certificate stays a rigorous
    f64 pass.  ``objective``: an :class:`Objective`, a
    :class:`ConcaveUtility` or a :class:`CustomUtility` with its conjugate
    (which the certificates need).  Returns host-side numpy arrays only.

    ``solver``: a pre-built :class:`DeltaAdmmSolver` (with
    ``adapt_rho=False``) to reuse across calls; it keeps its own
    ``check_every``.  Without one, the solver built here checks its
    residuals every :func:`_check_cadence` iterations (25 for the default
    ``chunk_iters``; a :class:`CustomUtility` keeps ``options``'), and on
    the card replays the iterations between checks as captured blocks; it
    writes every pass's delta arrays into the same tensors, so a block is
    captured once for all passes.  Inside ``api.route`` it is the solver of
    an earlier route on the same network where there is one
    (``solver/_solver_cache.py``).
    ``device``: where the correction solves and the certificates' eta
    search run; the card unless ``"cpu"`` is given (a passed solver brings
    its own).

    ``cert_space``: optional ``(cert_compiled, cert_objective, unscale_fn)``:
    refine in this (typically equilibrated) space but evaluate every
    certificate, and return the result, in the space ``unscale_fn`` maps to.

    ``fused``: run the correction solves on the fused delta path.  Default
    ``None`` = auto: fused when every bucket's pool count is a multiple of
    128 AND the solver runs on the card AND the objective is not a
    :class:`CustomUtility` (whose correction solves are classic).
    ``fused=True`` on a CPU solver runs the plain fused delta version.
    ``interpret``: the JAX package's Pallas interpret mode, accepted and
    ignored.

    ``entry_cert``: a certificate of ``result`` the caller already has, in
    cert_space units (skips the entry certificate)."""
    _check_objective(objective)
    is_custom = isinstance(objective, CustomUtility)
    if is_custom and objective.conjugate is None:
        raise ValueError(
            "refine_device(CustomUtility) needs the utility's concave "
            "conjugate for its rigorous certificates — pass "
            "conjugate=lambda nu: <upper bound on sup U(psi) - nu@psi>"
        )
    dev = solver.device if solver is not None else resolve_device(device)
    base_opts = options if options is not None else AdmmOptions()
    cur = to_host(result)
    if cert_space is None:
        cert_compiled, cert_objective = compiled, objective
        unscale_fn = lambda r: r  # noqa: E731
    else:
        cert_compiled, cert_objective, unscale_fn = cert_space

    def _hit(c):
        return abs(c.gap_rel) <= target_gap and c.feasibility_rel <= target_gap

    # at most 2 polish attempts per call: the L-BFGS dual search costs ~n
    # dual-bound evaluations, and repeated attempts from near-identical
    # prices rediscover the same point
    polish_budget = [2]

    def _cert(point):
        point = unscale_fn(point)
        cert = certify(cert_compiled, cert_objective, point.deltas,
                       point.lambdas, point.prices, psi_claimed=point.psi,
                       device=dev)
        # the price polish closes NEAR-MISS dual looseness only: it cannot
        # repair primal feasibility
        near_miss = (
            cert.gap_rel < max(20.0 * target_gap, 1e-5)
            and cert.feasibility_rel <= target_gap
            and polish_budget[0] > 0
        )
        if polish and not _hit(cert) and cert.gap_abs > 0 and near_miss:
            polish_budget[0] -= 1
            nu_p = polish_prices(cert_compiled, cert_objective,
                                 np.asarray(point.prices), max_evals=60,
                                 device=dev)
            cert_p = certify(cert_compiled, cert_objective, point.deltas,
                             point.lambdas, nu_p, psi_claimed=point.psi,
                             device=dev)
            if cert_p.gap_abs < cert.gap_abs:
                cert = cert_p
        return cert

    cert = entry_cert if entry_cert is not None else _cert(cur)
    if _hit(cert):
        return RefineResult(result=unscale_fn(cur), certificate=cert, iters=0,
                            achieved=True)

    own = solver is None
    if own:
        opts = dataclasses.replace(
            base_opts,
            max_iters=max(base_opts.max_iters, chunk_iters),
            # residual tolerances on the SCALED correction (its f32 floor);
            # rho adaptation off: the delta-dual iteration folds c/rho - nu0
            # into a per-solve constant that a penalty rescale would break
            eps_abs=1e-8, eps_rel=1e-8, adapt_rho=False,
            check_every=_check_cadence(objective, chunk_iters, base_opts),
        )
        # inside api.route, the delta solver of an earlier route on this
        # network (solver/_solver_cache.py)
        solver = _solver_cache.own(DeltaAdmmSolver, compiled, torch.float32,
                                   opts, dev)
    elif solver.options.adapt_rho:
        raise ValueError(
            "refine_device needs a solver with adapt_rho=False: the "
            "delta-dual iteration folds c/rho - nu0 into a per-solve "
            "constant that an in-solve penalty rescale invalidates (build "
            "the solver with AdmmOptions(adapt_rho=False, eps_abs=1e-8, "
            "eps_rel=1e-8))"
        )
    if fused is None:
        fused = (_fused_ok(solver) and solver.device.type == "cuda"
                 and not is_custom)
    elif fused and not _fused_ok(solver):
        raise ValueError(
            "fused=True needs every bucket's pool count to be a multiple of "
            "128: compile with pad_pools_to=128"
        )

    total = 0
    # Two penalty regimes, tried as a ladder: 'base' (the base solve's
    # penalty, clamped) suits feasibility repair and near-converged entry
    # duals; 'eps' (curvature-matched, eps-scaled) grinds a positive gap.
    # A pass that fails to improve switches regime; two in a row end it.
    mode = "base"
    pass_fails = 0
    for _ in range(int(max_passes)):
        score_entry = max(abs(cert.gap_rel), cert.feasibility_rel)
        psi0 = _psi_from_trades(compiled, cur)
        cur = cur._replace(psi=psi0)
        eps = float(_correction_eps(
            eps_factor, max(cert.feasibility_rel, abs(cert.gap_rel)),
            cur.deltas, cur.lambdas, 1)[0])
        curv = _curvature_scale(objective, psi0)
        rho = float(rho0 if rho0 is not None else
                    _penalty(mode == "eps", eps, cur.rho_final, curv))
        nu0f = _nu0_f32(cur.prices, rho)
        bdict, min_x0 = (solver._pass_buckets(cur, eps, nu0f) if own else
                         solver.delta_buckets(cur, eps, nu0=nu0f))
        if not (min_x0 > 0.0) or not np.isfinite(min_x0):
            _LOG.warning(
                "refine_device: base point has a non-positive post-trade "
                "reserve (min x0 = %g); falling back to the float64 refine "
                "path", min_x0,
            )
            from .refine import refine as _f64_refine

            out = _f64_refine(cert_compiled, cert_objective, unscale_fn(cur),
                              target_gap=target_gap, options=base_opts,
                              device=dev)
            return RefineResult(result=out.result, certificate=out.certificate,
                                iters=total + out.iters, achieved=out.achieved)
        dobj = _delta_objective(objective, psi0, eps)
        dwarm = None
        improved = False
        # the chunked delta trajectory is relative to THIS pass's centre
        center = cur
        prev_gate = None
        full_misses = 0
        for _c in range(int(chunks_per_pass)):
            dres = solver.solve_delta(dobj, bdict, nu0f, rho, chunk_iters,
                                      warm=dwarm, fused=fused)
            # cheap solve-space gate on the small (n,) leaves; the trade
            # planes stay on the device until a candidate is certified
            it = _count_chunk(solver, dres, fused)
            total += it
            done = it < chunk_iters or bool(host(dres.converged))
            psi_cand = psi0 + eps * np.asarray(host(dres.psi), np.float64)
            prices_solve = rho * nu0f + np.asarray(host(dres.prices), np.float64)
            dualb = dual_bound(compiled, objective, prices_solve, evals=(8, 4),
                               device=dev)
            obj_cand = _objective_value(objective, psi_cand)
            gap_est = (dualb - obj_cand) / max(1.0, abs(obj_cand), abs(dualb))
            lo_o = np.asarray(objective.lo, np.float64)
            hi_o = np.asarray(objective.hi, np.float64)
            box_est = float(np.max(
                np.maximum(lo_o - psi_cand, psi_cand - hi_o).clip(min=0.0),
                initial=0.0,
            )) / max(1.0, float(np.max(np.abs(psi_cand), initial=0.0)))
            gate_score = max(abs(gap_est), box_est)
            # the gate reads the consensus psi, which lags the trades: fire
            # the full certificate with slack (5x target) and whenever the
            # gate stops improving quickly
            gate_hit = gate_score <= 5.0 * target_gap
            stalled = prev_gate is not None and gate_score > 0.7 * prev_gate
            prev_gate = gate_score
            _LOG.debug("refine chunk gate: gap_est=%.2e box_est=%.2e done=%s",
                       gap_est, box_est, done)
            if not (gate_hit or done or stalled or _c == int(chunks_per_pass) - 1):
                dwarm = dres  # chain chunks on the device
                continue
            dwarm = dres
            dhost = to_host(dres)
            cand = _compose(compiled, center, dhost, eps, objective,
                            rho * nu0f + np.asarray(dhost.prices, np.float64))
            cand_cert = _cert(cand)
            _LOG.debug(
                "refine chunk: r=%.2e s=%.2e gap=%.2e feas=%.2e (eps=%.3g rho=%.3g)",
                float(dhost.r_norm), float(dhost.s_norm), cand_cert.gap_rel,
                cand_cert.feasibility_rel, eps, rho,
            )
            if (max(cand_cert.feasibility_rel, abs(cand_cert.gap_rel))
                    < max(cert.feasibility_rel, abs(cert.gap_rel))):
                improved = True
                full_misses = 0
                cur, cert = cand, cand_cert
            else:
                full_misses += 1
            if _hit(cert):
                return RefineResult(result=unscale_fn(cur), certificate=cert,
                                    iters=total, achieved=True)
            if done:
                break  # delta solve residual-converged; re-centre
            if full_misses >= 2 and max(abs(cert.gap_rel),
                                        cert.feasibility_rel) > 10.0 * target_gap:
                break  # two certified misses in a row, far from target
        if not improved:
            pass_fails += 1
            if pass_fails >= 2:
                break  # both penalty regimes stalled
            mode = "eps" if mode == "base" else "base"
        else:
            pass_fails = 0
            score_now = max(abs(cert.gap_rel), cert.feasibility_rel)
            if score_now > 0.5 * score_entry:
                # progress is slowing in this regime: the other one attacks
                # the orthogonal mode (dual vs primal)
                mode = "eps" if mode == "base" else "base"
    return RefineResult(result=unscale_fn(cur), certificate=cert, iters=total,
                        achieved=False)
