"""Float64 refinement: polish an f32 solve to a certified gap with the same
consensus ADMM in float64.

The reference gets ~1e-8 certified optimality from ECOS's interior-point
method.  An f32 solve bottoms out at a ~1e-4..1e-3 relative gap; this
module warm-starts the SAME consensus ADMM in float64 from it and runs until
the rigorous dual certificate (:mod:`.certify`) reports the target.  The
H100 has native float64, so the polish runs on the device it is given (the
card by default); the JAX package ran it on the host CPU because its TPU
has none.

It is the fallback of :func:`~.refine_device.refine_device` when a base
point has a non-positive post-trade reserve (the log-domain correction
needs x0 > 0).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .._device import host, resolve_device
from ..models.utility import CustomUtility
from .admm import AdmmOptions, AdmmSolver, RouteResult
from .certify import Certificate, certify, polish_prices
from .compiler import CompiledProblem

__all__ = ["RefineResult", "refine"]


@dataclasses.dataclass
class RefineResult:
    """Certified f64 polish of a candidate routing."""

    result: RouteResult  # numpy leaves (host)
    certificate: Certificate
    iters: int  # total refinement iterations
    achieved: bool  # |gap_rel| and feasibility_rel <= target


# tightening schedule: each stage warm-starts from the previous one's
# iterate, so later stages only run if the certificate is still loose
_EPS_SCHEDULE = (1e-9, 1e-11, 5e-13)

# certify every chunk of f64 iterations and stop at the first certified
# hit; the chunk grows geometrically from _CHUNK0 to _CHUNK_MAX
_CHUNK0 = 125
_CHUNK_MAX = 1000


def to_host(res: RouteResult) -> RouteResult:
    """A RouteResult with every leaf copied to numpy."""
    return RouteResult(*[
        {k: host(v) for k, v in f.items()} if isinstance(f, dict) else host(f)
        for f in res
    ])


def _make_solver(compiled, opts, cpu_shards, strict, dev):
    """The float64 polish solver: sharded over the ranks of a CPU (gloo)
    process group when ``cpu_shards`` asks for it and the group has enough
    ranks, else single-device.

    A fallback to the single-device path is loud: a run that asked for N
    host cores should not silently run on one (``strict=True`` turns the
    fallback into an error)."""
    if cpu_shards and int(cpu_shards) > 1:
        n = int(cpu_shards)
        reason = None
        try:
            from ..parallel.mesh import pool_mesh
            from ..parallel.sharded import ShardedAdmmSolver

            ranks = (dist.get_world_size()
                     if dist.is_initialized() and dist.get_backend() == "gloo" else 0)
            if ranks >= n:
                mesh = pool_mesh(n_devices=n, platform="cpu")
                return ShardedAdmmSolver(compiled, mesh, dtype=torch.float64,
                                         options=opts)
            reason = (
                f"{ranks} rank(s) in an initialised CPU (gloo) process group — "
                f"start {n} processes and call init_distributed() in each "
                "before refine"
            )
        except (ValueError, RuntimeError, NotImplementedError) as e:
            reason = f"{type(e).__name__}: {e}"
        msg = (
            f"refine(cpu_shards={n}) falling back to the SINGLE-DEVICE "
            f"f64 path ({reason})"
        )
        if strict:
            raise RuntimeError(msg)
        logging.getLogger("cfmm_routing_tpu_torch.refine").warning(msg)
    return AdmmSolver(compiled, dtype=torch.float64, options=opts, device=dev)


def refine(
    compiled: CompiledProblem,
    objective,
    result: RouteResult,
    target_gap: float = 1e-6,
    max_iters: int = 200_000,
    options: Optional[AdmmOptions] = None,
    cpu_shards: Optional[int] = None,
    strict: bool = False,
    device=None,
) -> RefineResult:
    """Polish ``result`` (typically an f32 solve) to a certified gap.

    ``objective`` is the :class:`Objective`, :class:`ConcaveUtility` or
    :class:`CustomUtility` (with its conjugate) the original solve used.
    Returns host-side (numpy) arrays only.  ``device``: where the float64
    ADMM and the certificate's eta search run (the card unless ``"cpu"`` is
    given).

    ``cpu_shards``: shard the float64 polish over N host cores, the port's
    counterpart of the JAX package's N virtual CPU devices: the ranks of an
    initialised CPU (gloo) process group of at least N ranks
    (``parallel/mesh.py``), every rank calling ``refine`` alike, through
    ``ShardedAdmmSolver``.  Without such a group it falls back to the
    single-device path with a WARNING log line, or raises a RuntimeError
    when ``strict=True``.  A custom utility drops ``cpu_shards``, as in the
    JAX package."""
    if isinstance(objective, CustomUtility):
        cpu_shards = None
    dev = resolve_device(device)
    base = options if options is not None else AdmmOptions()
    cur = to_host(result)
    polish_evals = 200 if compiled.n_pools <= 20_000 else 50

    def _hit(c):
        # feasibility is judged relative to the trade magnitudes; OPT -
        # objective <= max(gap, 0) is rigorous, and a negative gap (a
        # residually infeasible point above the dual bound) is held by the
        # feasibility gate, so both must reach the target
        return abs(c.gap_rel) <= target_gap and c.feasibility_rel <= target_gap

    def _cert(point):
        """Certify at the ADMM duals and, when that misses the target with a
        positive gap, at L-BFGS-polished prices; keep the tighter bound."""
        cert = certify(compiled, objective, point.deltas, point.lambdas,
                       point.prices, psi_claimed=point.psi, device=dev)
        if _hit(cert) or cert.gap_abs <= 0:
            # polishing prices only lowers the dual bound: it cannot shrink
            # a negative gap
            return cert
        nu_p = polish_prices(compiled, objective, np.asarray(point.prices),
                             max_evals=polish_evals, device=dev)
        cert_p = certify(compiled, objective, point.deltas, point.lambdas,
                         nu_p, psi_claimed=point.psi, device=dev)
        return cert_p if cert_p.gap_abs < cert.gap_abs else cert

    cert = _cert(cur)
    if _hit(cert):
        return RefineResult(result=cur, certificate=cert, iters=0, achieved=True)

    total = 0
    stage = 0
    chunk = _CHUNK0
    solver = None
    while total < int(max_iters):
        if solver is None:
            opts = dataclasses.replace(
                base, eps_abs=_EPS_SCHEDULE[stage], eps_rel=_EPS_SCHEDULE[stage],
                max_iters=_CHUNK_MAX,
            )
            solver = _make_solver(compiled, opts, cpu_shards, strict, dev)
        res = solver.solve(objective, warm=cur, max_iters=chunk)
        took = int(host(res.iters))
        total += took
        cur = to_host(res)
        cert = _cert(cur)
        if _hit(cert):
            return RefineResult(result=cur, certificate=cert, iters=total,
                                achieved=True)
        if took < chunk:
            # residual-converged at this eps but the certificate is still
            # loose: tighten, or stop when the schedule is exhausted
            stage += 1
            if stage >= len(_EPS_SCHEDULE):
                break
            solver = None
        elif chunk < _CHUNK_MAX:
            chunk = min(2 * chunk, _CHUNK_MAX)
    return RefineResult(result=cur, certificate=cert, iters=total, achieved=False)
