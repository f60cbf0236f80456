"""Carry compiled problems and solver state across from plain numpy arrays.

A caller that already holds a compiled problem or a solver result as numpy
arrays (from a file, another process, or another implementation of the
same compiler) rebuilds the package's own objects from them here, so both
sides compute on exactly the same arrays.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ._device import resolve_device
from .solver.admm import RouteResult
from .solver.compiler import Bucket, CompiledProblem

__all__ = ["compiled_from_numpy", "route_result_from_numpy", "state_from_numpy"]


def compiled_from_numpy(
    n_assets: int,
    degree,
    buckets: Mapping[str, Mapping[str, object]],
    n_pools: int,
    widths,
) -> CompiledProblem:
    """A :class:`CompiledProblem` from its arrays.

    ``buckets``: name -> dict(kind, width, reserves, weights, shift, gamma,
    logk0, k0, mask, asset, pool_ids, needs_floor) with the (m, K) / (m, 1)
    / (m,) layouts of :class:`~.solver.compiler.Bucket`.
    """
    out: Dict[str, Bucket] = {}
    for name, b in buckets.items():
        f64 = {k: np.array(b[k], np.float64)
               for k in ("reserves", "weights", "shift", "gamma", "logk0",
                         "k0", "mask")}
        out[name] = Bucket(
            kind=str(b["kind"]),
            width=int(b["width"]),
            asset=np.array(b["asset"], np.int32),
            pool_ids=np.array(b["pool_ids"], np.int32),
            needs_floor=bool(b["needs_floor"]),
            **f64,
        )
    widths = np.array(widths, np.int32)
    return CompiledProblem(
        n_assets=int(n_assets),
        buckets=out,
        degree=np.array(degree, np.float64),
        n_pools=int(n_pools),
        n_slots=int(widths.sum()),
        widths=widths,
    )


def route_result_from_numpy(
    objective, psi, prices, deltas, lambdas, iters, r_norm, s_norm,
    converged, rho_final, dtype: torch.dtype = torch.float32, device=None,
) -> RouteResult:
    """A :class:`RouteResult` of tensors on ``device`` (the card unless
    ``"cpu"`` is given) — e.g. to warm-start ``AdmmSolver.solve``."""
    dev = resolve_device(device)

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

    return RouteResult(
        objective=t(objective),
        psi=t(psi),
        prices=t(prices),
        deltas={k: t(v) for k, v in deltas.items()},
        lambdas={k: t(v) for k, v in lambdas.items()},
        iters=t(iters, torch.int64),
        r_norm=t(r_norm),
        s_norm=t(s_norm),
        converged=t(converged, torch.bool),
        rho_final=t(rho_final),
    )


def state_from_numpy(z, nu, dtype: torch.dtype = torch.float32, device=None):
    """An ADMM iterate (z, nu) as tensors on ``device`` (the card unless
    ``"cpu"`` is given): ``z`` maps bucket name -> (zD, zL) slot-major (K, m)
    planes, ``nu`` is the (n,) scaled dual — the state a solver's
    ``_iterate`` and ``DeviceGate.evaluate`` take."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    return {k: (t(zD), t(zL)) for k, (zD, zL) in z.items()}, t(nu)
