"""Chunked solve driver: observability and checkpoint/resume for long solves.

``ChunkedDriver`` runs the ADMM in fixed-size chunks (``chunk`` iterations
on the device with no read-back inside a chunk) and, between chunks, on the
host:

  * appends a structured residual record (iteration, primal/dual residual,
    tolerances, rho, objective);
  * optionally calls a user callback (live monitoring);
  * optionally checkpoints the solver state to a numpy ``.npz`` file, so a
    preempted run resumes exactly where it stopped;
  * stops on convergence, divergence (NaN), a stall, or the iteration
    budget, and tries a rigorous infeasibility certificate when the run
    does not converge.

``fused=True`` runs each chunk's first ``chunk - 1`` iterations on the
fused kernel path (``AdmmSolver._iterate_fused``) and harvests the
residuals with one classic iteration, as ``solve_fused`` does; on a folded
solver that is the ``fused_step(fold=)`` kernel.  The residuals of a folded
solver are joint over its points.

Handed a :class:`~..parallel.sharded.ShardedAdmmSolver`, the driver runs
the same loop on each rank around the rank's shard (``solver.inner``, whose
iterations all-reduce over the pools group): every host decision reads
all-reduced residuals, so every rank takes the same branch, and the result's
trade planes are gathered into the global layout at the end.  Each rank
checkpoints its own shard, to ``checkpoint_path + ".rank<r>.npz"``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .admm import RouteResult, _fused_ok
from .graphs import run_block

__all__ = ["ChunkRecord", "ChunkedDriver", "SolveLog"]


@dataclasses.dataclass
class ChunkRecord:
    """One structured log record per chunk."""

    iteration: int
    r_norm: float
    s_norm: float
    eps_pri: float
    eps_dua: float
    rho: float
    objective: float

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


class SolveLog:
    """Append-only residual history with CSV export.

    ``status`` after a solve is one of 'converged' | 'max_iters' |
    'stalled' | 'diverged' | 'infeasible'.  When status is 'infeasible',
    ``infeasibility`` holds the rigorous separating-price certificate
    (``solver/certify.py``)."""

    def __init__(self):
        self.records: List[ChunkRecord] = []
        self.status: str = "pending"
        self.infeasibility = None  # InfeasibilityCertificate when proven

    def append(self, rec: ChunkRecord) -> None:
        self.records.append(rec)

    def to_csv(self, path: str) -> None:
        import csv

        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=[
                "iteration", "r_norm", "s_norm", "eps_pri", "eps_dua", "rho",
                "objective",
            ])
            w.writeheader()
            for r in self.records:
                w.writerow(r.as_dict())

    def __len__(self):
        return len(self.records)


def _save_state(path: str, z, nu, rho, it: int) -> None:
    """The chunked solve's state as plain numpy arrays in ``path + ".npz"``."""
    arrays = {"nu": nu.cpu().numpy(), "rho": rho.cpu().numpy(),
              "it": np.asarray(it, np.int64)}
    for name, (zD, zL) in z.items():
        arrays[f"zD/{name}"] = zD.cpu().numpy()
        arrays[f"zL/{name}"] = zL.cpu().numpy()
    np.savez(path + ".npz", **arrays)


def _load_state(path: str, solver):
    with np.load(path + ".npz", allow_pickle=False) as data:
        z = {name: (solver._t(data[f"zD/{name}"]), solver._t(data[f"zL/{name}"]))
             for name in solver.buckets}
        return z, solver._t(data["nu"]), solver._t(data["rho"]), int(data["it"])


class ChunkedDriver:
    """Host-side orchestration around an :class:`AdmmSolver`.

    ``fused=True`` needs every bucket's pool count (per scenario point on
    a fold) to be a multiple of 128 (``pad_pools_to=128``/1024)."""

    def __init__(self, solver, chunk: int = 200, fused: bool = False):
        from ..parallel.sharded import ShardedAdmmSolver

        self.sharded = None
        if isinstance(solver, ShardedAdmmSolver):
            if fused:
                solver._check_fused_alignment()
            self.sharded, solver = solver, solver.inner
        self.solver = solver
        self.chunk = int(chunk)
        self.fused = bool(fused)
        if self.fused and not _fused_ok(solver):
            raise ValueError(
                "fused chunks need every bucket's pool count (per scenario "
                "point) to be a multiple of 128 (pad_pools_to=128/1024)"
            )

    def _run_chunk(self, z, nu, rho, c, lo, hi, util=None):
        """``chunk`` classic iterations (the first ``chunk - 1`` one
        replayed block on the card); residual sums of the last one."""
        sol = self.solver

        def step(state, k):
            z_new, nu_new, _, _, _ = sol._iterate(*state, *k[:4],
                                                  with_stats=False, util=k[4])
            return {nm: z_new[nm] for nm in state[0]}, nu_new

        z, nu = run_block(sol, "chunk", step, self.chunk - 1, 1, (z, nu),
                          (rho, c, lo, hi, util), owner=sol.buckets)
        z, nu, psi, _, st = sol._iterate(z, nu, rho, c, lo, hi, util=util)
        return z, nu, psi, st

    def _run_chunk_fused(self, z, nu, rho, c, lo, hi, util=None):
        """``chunk - 1`` fused iterations (one replayed block on the card)
        from the fused state re-seeded at the chunk boundary (z = s + 0_e),
        then one classic iteration."""
        sol = self.solver

        def step(state, k):
            s_new, wdef_new, nu_new, _, _ = sol._iterate_fused(*state, *k[:4],
                                                               util=k[4])
            return {nm: s_new[nm] for nm in state[0]}, wdef_new, nu_new

        s, wdef, nu = run_block(sol, "chunk_fused", step, self.chunk - 1, 1,
                                (dict(z), sol._zeros(sol.n), nu),
                                (rho, c, lo, hi, util), owner=sol.buckets)
        z = sol.fused_to_z(s, wdef)
        z, nu, psi, _, st = sol._iterate(z, nu, rho, c, lo, hi, util=util)
        return z, nu, psi, st

    def solve(
        self,
        objective,
        max_iters: int = 20000,
        rho: Optional[float] = None,
        log: Optional[SolveLog] = None,
        callback: Optional[Callable[[ChunkRecord], None]] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 1,
        resume: bool = False,
    ):
        """Run until convergence / budget.  Returns (RouteResult, SolveLog).

        ``objective``: a linear :class:`Objective` or a separable
        :class:`ConcaveUtility`.  ``checkpoint_path``: write the state every
        ``checkpoint_every`` chunks to ``checkpoint_path + ".npz"``;
        ``resume=True`` starts from that file."""
        sol = self.solver
        opts = sol.options
        c, lo, hi, util = sol._pack(objective)
        z = {name: (sol._zeros(*a["mask"].shape), sol._zeros(*a["mask"].shape))
             for name, a in sol.buckets.items()}
        nu = sol._zeros(sol.n)
        rho_v = sol._t(rho if rho is not None else opts.rho)
        it = 0
        compiled = sol.compiled
        if self.sharded is not None:
            compiled = self.sharded.compiled
            if checkpoint_path is not None:
                checkpoint_path = f"{checkpoint_path}.rank{self.sharded.shard}"
        if resume and checkpoint_path is not None:
            z, nu, rho_v, it = _load_state(checkpoint_path, sol)

        sqn = sol._sqrt_edges()
        log = log if log is not None else SolveLog()
        run = self._run_chunk_fused if self.fused else self._run_chunk
        converged = False
        status = "max_iters"
        r = s = eps_pri = eps_dua = math.nan
        psi = sol._zeros(sol.n)
        obj = 0.0
        best_score = math.inf
        best_chunk = 0
        best_state = None  # (score, z, nu, rho, psi, obj, r, s)
        stall_chunks = 12  # no 30% residual progress in this many chunks
        last_good_prices = None  # last finite dual, for the infeasibility cert
        while it < max_iters:
            z, nu, psi, st = run(z, nu, rho_v, c, lo, hi, util)
            it += self.chunk
            # one read-back per chunk: the four norms and the objective
            r_t, s_t, ep_t, ed_t = sol._residuals(sol._joint(st), sqn)
            r, s, eps_pri, eps_dua, obj = (
                float(x) for x in torch.stack(
                    [r_t, s_t, ep_t, ed_t, sol._objective_value(c, psi, util)]).cpu())
            rec = ChunkRecord(iteration=it, r_norm=r, s_norm=s, eps_pri=eps_pri,
                              eps_dua=eps_dua, rho=float(rho_v), objective=obj)
            log.append(rec)
            if callback is not None:
                callback(rec)
            if checkpoint_path is not None and len(log) % checkpoint_every == 0:
                _save_state(checkpoint_path, z, nu, rho_v, it)
            if not math.isfinite(r):
                status = "diverged"
                break
            last_good_prices = (rho_v * nu).cpu().numpy().astype(np.float64)
            if r <= eps_pri and s <= eps_dua:
                converged = True
                status = "converged"
                break
            # stall detection: an f32 run asked for f64-grade tolerances
            # cycles at its noise floor forever — stop and report instead
            score = max(r / max(eps_pri, 1e-300), s / max(eps_dua, 1e-300))
            if best_state is None or score < best_state[0]:
                best_state = (score, z, nu, rho_v, psi, obj, r, s)
            if score < 0.7 * best_score:
                best_score = score
                best_chunk = len(log)
            elif len(log) - best_chunk >= stall_chunks:
                status = "stalled"
                break
            # residual-balancing rho adaptation between chunks (the host
            # twin of the in-loop rule in AdmmSolver._solve_impl)
            if opts.adapt_rho:
                if r > opts.adapt_ratio * s:
                    rho_v = rho_v * opts.adapt_factor
                    nu = nu / opts.adapt_factor
                elif s > opts.adapt_ratio * r:
                    rho_v = rho_v / opts.adapt_factor
                    nu = nu * opts.adapt_factor

        # a stalled run cycles at its noise floor; the LAST iterate is then
        # an arbitrary point of the cycle — return the best-residual iterate
        if status == "stalled" and best_state is not None:
            _, z, nu, rho_v, psi, obj, r, s = best_state

        # a non-converging run may be a genuinely infeasible program: the
        # dual then grows along a separating direction — try to turn the
        # last finite dual into a rigorous infeasibility certificate
        if not converged and last_good_prices is not None:
            from .certify import certify_infeasible

            cert = certify_infeasible(compiled, objective, last_good_prices,
                                      device=sol.device)
            if cert.infeasible:
                status = "infeasible"
                log.infeasibility = cert

        # final projection pass for exactly-feasible primal variables, one
        # launch per K-group on the card
        inputs = {}
        for name in sol.buckets:
            nu_e = sol._bcast_nu(nu, name)
            zD, zL = z[name]
            inputs[name] = (zD - nu_e, zL + nu_e)
        w_out = sol._project_groups(inputs, sol.buckets)

        result = RouteResult(
            objective=sol._t(obj),
            psi=psi,
            prices=rho_v * nu,
            deltas={name: w_out[name][0] for name in sol.buckets},
            lambdas={name: w_out[name][1] for name in sol.buckets},
            iters=torch.tensor(it, device=sol.device),
            r_norm=sol._t(r),
            s_norm=sol._t(s),
            converged=torch.tensor(converged, device=sol.device),
            rho_final=rho_v,
        )
        if self.sharded is not None:
            result = self.sharded._gather(result)
        log.status = status
        return result, log
