"""Pool-sharded ADMM over ``torch.distributed``: one process per rank.

Partitioning: every bucket's pool axis is split across the mesh's ``pools``
dim, rank p holding the contiguous pools ``[p*m/D, (p+1)*m/D)`` of every
bucket (the JAX package's ``P(None, "pools")``).  Each rank runs the port's
own solver (:class:`AdmmSolver`, or :class:`DeltaAdmmSolver` for the
refinement's correction solves) on its shard, built with ``axis_name=<the
pools group>``: problem data, edge state and projections stay on the rank,
and the only traffic per iteration is

    all-reduce of the (n,)-vector consensus sum  (+ the 4 residual sums on a
    checked iteration)

The degree, the objective and the prox stay global and replicated, so every
rank holds the same psi, prices and scalars and takes the same host
decisions (stopping test, rho adaptation, the driver's status, the
refinement's gates).  A solve returns psi, prices and the scalars as every
rank computed them, and the trade planes gathered along the pools axis into
the global (K, m) layout: every rank's RouteResult has the single-device
layout, from which ``refine_device`` and ``certify`` compose on the host
(the JAX package's ``_gather_if_multiprocess``).

On the card each rank's iteration blocks are CUDA-graph replays with the
NCCL collectives inside (``solver/graphs.py``).  On a gloo group over CUDA
tensors (ranks that share one card) every collective goes through the host
and cannot be captured: the solves run inside an explicit ``graphs.eager()``.

Scenario batches (:meth:`ShardedAdmmSolver.solve_batch`,
:meth:`~ShardedAdmmSolver.solve_batch_reserves`) split B across the mesh's
``batch`` dim: each batch row solves its B/D_batch points on the classic
path with a stopping test per point, as one fold of its pool shard
(``solver/fold.py``, ``AdmmSolver._solve_batch_impl``), pools sharded
across the row.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops.prox import psi_prox
from ..solver.admm import (
    _F32_BIG, AdmmOptions, AdmmSolver, RouteResult, _reserve_buckets,
)
from ..solver.compiler import CompiledProblem, compile_spec
from ..solver.fold import fold_compiled
from ..solver.refine_device import DeltaAdmmSolver

__all__ = ["ShardedAdmmSolver", "ShardedDeltaAdmmSolver"]

_LOG = logging.getLogger("cfmm_routing_tpu_torch.parallel")


def shard_compiled(compiled: CompiledProblem, shard: int, n_shards: int) -> CompiledProblem:
    """Rank ``shard``'s share of a compiled problem: the contiguous pools
    ``[shard*m/D, (shard+1)*m/D)`` of every bucket.  The degree, the asset
    count and the pool bookkeeping stay global: they are the consensus's,
    which every rank completes."""
    buckets = {}
    for name, b in compiled.buckets.items():
        m_loc = b.m // n_shards
        rows = slice(shard * m_loc, (shard + 1) * m_loc)
        buckets[name] = dataclasses.replace(
            b, reserves=b.reserves[rows], weights=b.weights[rows], shift=b.shift[rows],
            gamma=b.gamma[rows], logk0=b.logk0[rows], k0=b.k0[rows], mask=b.mask[rows],
            asset=b.asset[rows], pool_ids=b.pool_ids[rows])
    return dataclasses.replace(compiled, buckets=buckets)


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` of ``group``, concatenated along ``dim`` in rank
    order."""
    if x.dtype == torch.bool:
        return _gather(x.to(torch.uint8), group, dim).bool()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class ShardedAdmmSolver:
    """ADMM with pools partitioned across the ``pools`` dim of a mesh
    (``parallel/mesh.py``).

    ``_inner_cls`` is the per-rank solver class: :class:`AdmmSolver`, or
    :class:`DeltaAdmmSolver` in :class:`ShardedDeltaAdmmSolver`.

    ``pad_pools_to`` defaults to the shard count (the least padding).  The
    fused kernels need each rank's LOCAL pool count to be a multiple of
    128: pass ``pad_pools_to=128 * n_shards`` (or ``1024 * n_shards``, the
    main path's padding per rank).
    """

    _inner_cls = AdmmSolver
    _fold = None  # sharded solves run unfolded

    def __init__(
        self,
        spec,
        mesh,
        dtype=torch.float32,
        options: AdmmOptions = AdmmOptions(),
        shard_assets: bool = False,
        pad_pools_to: Optional[int] = None,
    ):
        """``spec`` is a :class:`ProblemSpec` (compiled here with
        ``pad_pools_to``) or an already :class:`CompiledProblem` whose
        bucket pool counts the pool-mesh extent divides."""
        if mesh.get_coordinate() is None:
            raise ValueError("this rank holds no coordinate of the mesh")
        names = mesh.mesh_dim_names
        self.mesh = mesh
        self.group = mesh.get_group("pools")
        self.n_shards = mesh.size(names.index("pools"))
        self.shard = mesh.get_local_rank("pools")
        self.batch_axis = "batch" if "batch" in names else None
        if isinstance(spec, CompiledProblem):
            compiled = spec
            for name, b in compiled.buckets.items():
                if b.m % self.n_shards != 0:
                    raise ValueError(
                        f"bucket {name!r}: {b.m} pools do not divide the "
                        f"pool-mesh extent {self.n_shards} — recompile with "
                        f"pad_pools_to={self.n_shards}"
                    )
        else:
            pad = self.n_shards if pad_pools_to is None else int(pad_pools_to)
            if pad % self.n_shards != 0:
                raise ValueError(
                    f"pad_pools_to={pad} must be a multiple of the pool-mesh "
                    f"extent {self.n_shards}"
                )
            compiled = compile_spec(spec, pad_pools_to=pad)
        self.compiled = compiled
        device = (torch.device("cuda", torch.cuda.current_device())
                  if mesh.device_type == "cuda" else torch.device("cpu"))
        consensus_prox = (self._make_asset_sharded_prox(compiled, dtype, device)
                          if shard_assets else None)
        self.inner = self._inner_cls(
            shard_compiled(compiled, self.shard, self.n_shards), dtype=dtype,
            options=options, device=device, axis_name=self.group,
            consensus_prox=consensus_prox,
        )
        self.dtype = self.inner.dtype
        self.n = compiled.n_assets
        self._folds = {}  # T -> this rank's shard folded T times
        backend = dist.get_backend(self.group)
        if device.type == "cuda" and backend != "nccl":
            _LOG.warning(
                "ShardedAdmmSolver on a %s group over CUDA tensors: every "
                "collective goes through the host and cannot be captured in a "
                "CUDA graph; the solves run only inside graphs.eager()", backend)

    # ---- the per-rank solver's surface that callers read ---------------------

    @property
    def device(self) -> torch.device:
        return self.inner.device

    @property
    def options(self) -> AdmmOptions:
        return self.inner.options

    @property
    def buckets(self):
        """This rank's bucket arrays."""
        return self.inner.buckets

    # ---- global <-> local layouts ---------------------------------------------

    def _local(self, result):
        """A global-layout result's trade planes cut to this rank's pools
        (None passes through)."""
        if result is None:
            return None

        def cut(planes):
            out = {}
            for name, x in planes.items():
                m_loc = self.inner.buckets[name]["mask"].shape[1]
                out[name] = x[..., self.shard * m_loc:(self.shard + 1) * m_loc]
            return out

        return result._replace(deltas=cut(result.deltas), lambdas=cut(result.lambdas))

    def _gather(self, result: RouteResult) -> RouteResult:
        """The shard's trade planes gathered along the pools axis into the
        global (K, m) layout; the replicated leaves as they are."""
        return result._replace(
            deltas={k: _gather(v, self.group, -1) for k, v in result.deltas.items()},
            lambdas={k: _gather(v, self.group, -1) for k, v in result.lambdas.items()},
        )

    def _check_fused_alignment(self, lanes: int = 128):
        for name, b in self.compiled.buckets.items():
            m_local = b.m // self.n_shards
            if m_local % lanes != 0:
                raise ValueError(
                    f"bucket {name!r}: {b.m} pools over {self.n_shards} "
                    f"shards leaves {m_local} per device; the fused kernel "
                    f"needs a multiple of {lanes} — construct the solver "
                    f"with pad_pools_to={lanes}*n_shards (or 1024*n_shards "
                    "for the main path's padding)"
                )

    # ---- the asset-sharded consensus ---------------------------------------------

    def _make_asset_sharded_prox(self, compiled, dtype, device):
        """Asset-sharded consensus: reduce-scatter + block prox + all-gather.

        Replaces the replicated  all-reduce(n-vector) -> prox(n)  with

            reduce-scatter of the zero-padded n-vector  ->  the prox on this
            rank's ceil(n/D) asset block  ->  all-gather of (psi, mu)

        (SURVEY.md §5).  The prox's vector work per rank drops from O(n) to
        O(n/D).  Padding assets have degree 0, so their psi and mu are 0.
        Linear objectives only: a utility takes the replicated path
        (``AdmmSolver._iterate``)."""
        D = self.n_shards
        n = compiled.n_assets
        blk = -(-n // D)
        n_pad = blk * D
        blocks = slice(self.shard * blk, (self.shard + 1) * blk)
        deg_p = np.zeros(n_pad)
        deg_p[:n] = compiled.degree
        deg_b = torch.as_tensor(deg_p[blocks], dtype=dtype, device=device)
        group = self.group

        def padded(v):
            return torch.cat([v, v.new_zeros(n_pad - n)])

        def block(v):
            return padded(v)[blocks]

        def rs_prox(y_local, nu, c, lo, hi, rho):
            y_blk = y_local.new_empty(blk)
            dist.reduce_scatter_tensor(y_blk, padded(y_local), group=group)
            s_b = y_blk - 2.0 * deg_b * block(nu)
            psi_b, mu_b = psi_prox(s_b, deg_b, block(c), block(lo), block(hi), rho)
            return _gather(psi_b, group, 0)[:n], _gather(mu_b, group, 0)[:n]

        return rs_prox

    # ---- public solves ---------------------------------------------------------

    def solve(
        self,
        objective,
        rho: Optional[float] = None,
        warm: Optional[RouteResult] = None,
        max_iters: Optional[int] = None,
    ) -> RouteResult:
        """Sharded solve for a linear :class:`Objective`, a separable
        :class:`ConcaveUtility` or a non-separable :class:`CustomUtility`
        (whose prox runs replicated on every rank after the all-reduce), with
        ``AdmmSolver.solve``'s surface; ``warm`` is a global-layout result."""
        return self._gather(self.inner.solve(objective, rho=rho, warm=self._local(warm),
                                             max_iters=max_iters))

    def solve_fused(self, objective, iters: int, rho: Optional[float] = None) -> RouteResult:
        """Fixed-iteration fused-kernel solve, pools sharded over the mesh:
        each rank runs the fused kernels on its shard, one all-reduce of the
        consensus n-vector per iteration completes it.  Each rank's pool
        counts must be multiples of 128 (see the class docstring)."""
        self._check_fused_alignment()
        return self._gather(self.inner.solve_fused(objective, iters, rho=rho))

    def make_chunk_fn(self, chunk: int, fused: bool = False):
        """A sharded chunk function with the JAX package's ChunkedDriver
        contract, on this rank's shard of the state:

            (z, nu, rho, c, lo, hi, util=None) ->
                (z, nu, r2, s2, w2, z2, u2, psi, obj)

        ``chunk`` iterations (``fused=True``: ``chunk - 1`` fused iterations
        and one classic residual harvest), with global residual sums."""
        from ..solver.driver import ChunkedDriver

        drv = ChunkedDriver(self, chunk=chunk, fused=fused)
        run = drv._run_chunk_fused if fused else drv._run_chunk
        sol = self.inner

        def chunk_fn(z, nu, rho, c, lo, hi, util=None):
            z, nu, psi, st = run(z, nu, rho, c, lo, hi, util)
            return (z, nu, st["r2"], st["s2"], st["w_norm2"], st["z_norm2"],
                    st["u_norm2"], psi, sol._objective_value(c, psi, util))

        return chunk_fn

    # ---- scenario batches over the ('batch', 'pools') mesh -------------------------

    def _batch_rows(self, B: int):
        """The scenarios of this rank's batch row."""
        if not self.batch_axis:
            raise ValueError("mesh has no 'batch' axis; use pool_batch_mesh")
        names = self.mesh.mesh_dim_names
        rows = self.mesh.size(names.index("batch"))
        if B % rows != 0:
            raise ValueError(f"{B} scenarios do not divide the mesh's batch "
                             f"extent {rows}")
        per = B // rows
        first = self.mesh.get_local_rank("batch") * per
        return range(first, first + per)

    def _batch_solver(self, T: int) -> AdmmSolver:
        """This rank's shard folded T times (``solver/fold.py``), on the
        pools group; cached."""
        fs = self._folds.get(T)
        if fs is None:
            fs = self._inner_cls(fold_compiled(self.inner.compiled, T), dtype=self.dtype,
                                 options=self.options, device=self.device,
                                 axis_name=self.group, fold=(T, self.n))
            self._folds[T] = fs
        return fs

    def _gather_batch(self, fs, res: RouteResult) -> RouteResult:
        """A batch row's folded result -> the RouteResult of all B points,
        leading axis B: unfolded, the planes gathered along the pools axis,
        then every leaf along the batch axis."""
        res = self._gather(fs._unfold_batch(res))
        bgroup = self.mesh.get_group("batch")
        return RouteResult(*[
            {k: _gather(v, bgroup, 0) for k, v in f.items()} if isinstance(f, dict)
            else _gather(f, bgroup, 0) for f in res
        ])

    def solve_batch(self, c, lo, hi, rho: Optional[float] = None) -> RouteResult:
        """B linear objectives, (B, n) rows of ``c``/``lo``/``hi``, over the
        2-D mesh: each batch row solves its B/D_batch points as one fold of
        its pool shard, every point with its own penalty, stopping test and
        iteration count (``AdmmSolver.solve_batch``'s semantics).  Returns a
        RouteResult with leading axis B."""
        c = np.asarray(c, np.float64)
        rows = self._batch_rows(c.shape[0])
        fs = self._batch_solver(len(rows))
        mine = slice(rows.start, rows.stop)
        c = c[mine]
        lo = np.maximum(np.asarray(lo, np.float64)[mine], -_F32_BIG)
        hi = np.minimum(np.asarray(hi, np.float64)[mine], _F32_BIG)
        res = fs._solve_batch_impl(
            fs._t(c.reshape(-1)), fs._t(lo.reshape(-1)), fs._t(hi.reshape(-1)),
            rho if rho is not None else self.options.rho)
        return self._gather_batch(fs, res)

    def solve_batch_reserves(self, objective, reserve_scale,
                             rho: Optional[float] = None) -> RouteResult:
        """One linear :class:`Objective` over B per-pool reserve scenarios
        (``reserve_scale`` (B, n_pools)) on the 2-D mesh, each point solved
        on its own as in :meth:`solve_batch`: a batch row folds its points'
        pool shards, each with its own scaled reserves.  Returns a
        RouteResult with leading axis B."""
        scale = np.asarray(reserve_scale, np.float64)
        if scale.ndim != 2 or scale.shape[1] != self.compiled.n_pools:
            raise ValueError(
                f"reserve_scale must be (B, n_pools={self.compiled.n_pools}); "
                f"got {scale.shape}"
            )
        rows = self._batch_rows(scale.shape[0])
        fs = self._batch_solver(len(rows))
        # every point's scaled reserves (a fold of all B), cut to this row's
        # points and, within each, to this rank's pools
        full = fold_compiled(self.compiled, scale.shape[0], scale)
        scaled = {}
        for name, b in full.buckets.items():
            m = self.compiled.buckets[name].m
            m_loc = m // self.n_shards
            idx = np.concatenate([np.arange(t * m + self.shard * m_loc,
                                            t * m + (self.shard + 1) * m_loc)
                                  for t in rows])
            scaled[name] = dataclasses.replace(b, reserves=b.reserves[idx],
                                               k0=b.k0[idx], logk0=b.logk0[idx])
        bdict = _reserve_buckets(fs, dataclasses.replace(full, buckets=scaled))
        c, lo, hi = (fs._t(np.tile(x, len(rows))) for x in
                     (objective.c, np.maximum(objective.lo, -_F32_BIG),
                      np.minimum(objective.hi, _F32_BIG)))
        res = fs._solve_batch_impl(c, lo, hi, rho if rho is not None else self.options.rho,
                                   buckets=bdict)
        return self._gather_batch(fs, res)

    def unbucket(self, result: RouteResult):
        """Per-pool (delta, lambda) numpy arrays in spec order, from a
        global-layout result (``AdmmSolver.unbucket`` reads only the
        compiled problem, here the global one)."""
        return AdmmSolver.unbucket(self, result)


class ShardedDeltaAdmmSolver(ShardedAdmmSolver):
    """Pool-sharded correction solves: multi-rank mixed-precision
    refinement.

    Duck-types :class:`DeltaAdmmSolver`'s ``delta_buckets`` / ``solve_delta``
    surface, so ``refine_device(..., solver=ShardedDeltaAdmmSolver(compiled,
    mesh, ...))`` runs its correction solves across the pools mesh
    unchanged.  Each rank projects its shard onto the shifted trading sets;
    the delta-dual consensus is the usual all-reduce per iteration.
    Configure options like the single-device delta solver (eps ~1e-8,
    ``adapt_rho=False``).
    """

    _inner_cls = DeltaAdmmSolver

    def delta_buckets(self, base: RouteResult, eps: float, nu0=None):
        """This rank's delta arrays from a global-layout ``base``, and the
        smallest real-slot post-trade reserve over every rank (the caller's
        hand-off to the host path must be the same on every rank)."""
        bdict, min_x0 = self.inner.delta_buckets(self._local(base), eps, nu0=nu0)
        t = torch.tensor([min_x0], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.group)
        return bdict, float(t[0])

    def solve_delta(
        self,
        objective,
        bdict,
        nu0,
        rho: float,
        max_iters: int,
        warm: Optional[RouteResult] = None,
        fused: bool = False,
    ) -> RouteResult:
        """One sharded correction solve, with ``DeltaAdmmSolver.solve_delta``'s
        semantics (its preparation, ``_prep_delta_solve``, is the one the
        single-device solver runs); ``warm`` is a global-layout result.
        ``fused=True`` runs the fused delta kernel on each rank's shard; each
        rank's pool counts must be multiples of 128."""
        if fused:
            self._check_fused_alignment()
        return self._gather(self.inner.solve_delta(
            objective, bdict, nu0, rho, max_iters, warm=self._local(warm), fused=fused))
