"""The primal side of the certificate on the solver's device: a gate.

A gated solve loop asks, every few chunks, whether its iterate is close
enough to optimal to pay for the rigorous float64 certificate
(``solver/certify.py``), which reads every (K, m) trade plane back to the
host.  :class:`DeviceGate` answers without that read: on the device, in the
solve dtype, it projects once for exactly feasible trades and computes the
net trade, the objective and every feasibility residual; only a handful of
scalars and the (n,) price vector cross to the host, in one copy, where
the prices-only float64 dual bound (``certify.dual_bound``) estimates the
gap.  When the solve runs equilibrated, the per-asset power-of-two scales
are exact in floating point, so the gate evaluates everything in ORIGINAL
units; its only inexactness is the solve dtype's arithmetic (~1e-7
relative in float32), orders of magnitude below the 1e-3..1e-4 thresholds
it gates on.  The accepting certificate is always the float64 host pass;
the gate only decides when to pay for it.

On the card :meth:`DeviceGate.evaluate` queues the device pass and a
non-blocking copy of its packed result into pinned host memory, and records
an event, so the caller can queue the next solve chunk before
:meth:`DeviceGate.finish` waits for that event alone and evaluates the dual
bound (its eta search on a side stream): the gate's host half overlaps the
next chunk.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from ..models.utility import Objective
from .certify import dual_bound

__all__ = ["GateEstimate", "DeviceGate"]

# scalars ahead of the prices in the packed output: phi, feas_abs_rel, obj
_N_SCALARS = 3


class GateEstimate(NamedTuple):
    """Host-side view of one gate evaluation (estimates, NOT a
    certificate: see the module docstring)."""

    gap_rel: float
    feasibility_rel: float
    objective: float
    dual: float

    @property
    def score(self) -> float:
        return max(abs(self.gap_rel), self.feasibility_rel)


class DeviceGate:
    """The primal-side residual pass bound to one :class:`AdmmSolver`.

    ``objective`` is the ORIGINAL-units linear :class:`Objective`;
    ``compiled_orig`` the original-units compiled problem (the dual bound's
    pools); ``d`` the equilibration scales (None: the solve space is the
    original space).  ``evaluate(z, nu, rho)`` queues the pass on the
    solver's device and returns at once; ``finish`` turns its output into a
    :class:`GateEstimate` with the float64 dual bound.

    The pass projects through the solver's grouped projection (one
    ``project`` launch per K-group on the card) and sums through its
    ``_reduce_edges`` (one ``segment_sum`` per K-group), so any solver of
    the problem works, whichever path produced its per-bucket state (a
    merged fused run hands its state back per bucket).  On a shard of a
    sharded solve (``ShardedAdmmSolver.inner``) the net trade and the gross
    volume are summed, and the residual maxima taken, over the pools group.
    """

    def __init__(self, solver, compiled_orig, objective, d=None):
        if not isinstance(objective, Objective):
            raise TypeError("DeviceGate takes the linear Objective in original "
                            f"units, not {type(objective).__name__}")
        self.solver = solver
        self.compiled_orig = compiled_orig
        self.objective = objective
        d_host = np.ones(solver.n) if d is None else np.asarray(d, np.float64)
        d_ext = np.concatenate([d_host, [1.0]])
        self._dvec = solver._t(d_host)
        self._dplanes = {
            name: solver._t(np.ascontiguousarray(d_ext[b.asset].T))
            for name, b in solver.compiled.buckets.items()
        }
        # clamp the box to the float32 range: an infinite bound would turn
        # the residual into inf - inf
        fmax = np.finfo(np.float32).max / 4
        self._c = solver._t(np.asarray(objective.c, np.float64))
        self._lo = solver._t(np.maximum(objective.lo, -fmax))
        self._hi = solver._t(np.minimum(objective.hi, fmax))
        on_card = solver.device.type == "cuda"
        self._side = torch.cuda.Stream(solver.device) if on_card else None

    def _impl(self, z, nu, rho):
        """The device pass: a tensor [phi, feas_abs_rel, obj, prices (n)]."""
        solver = self.solver
        buckets = solver.buckets
        inputs = {}
        for name in buckets:
            nu_e = solver._bcast_nu(nu, name)
            zD, zL = z[name]
            inputs[name] = (zD - nu_e, zL + nu_e)
        proj = solver._project_groups(inputs, buckets)
        phi = solver._zeros()
        net, vol, per_bucket = {}, {}, []
        for name, arrs in buckets.items():
            kind, needs_floor = solver._meta[name]
            D, L = proj[name]
            ds = self._dplanes[name]
            mask = arrs["mask"]
            x = arrs["R"] + arrs["gamma"][None, :] * D - L
            live = mask > 0
            if kind == "gm":
                y = torch.where(live, torch.clamp_min(x + arrs["s"], 1e-30),
                                torch.ones_like(x))
                h = torch.sum(arrs["w"] * torch.log(y), dim=0)
                phi = torch.maximum(phi, torch.max(arrs["logk0"] - h))
            else:
                tot = torch.sum(torch.where(live, arrs["w"] * torch.clamp_min(x, 0.0),
                                            torch.zeros_like(x)), dim=0)
                phi = torch.maximum(phi, torch.max(
                    (arrs["k0"] - tot) / torch.clamp_min(arrs["k0"], 1.0)))
            net[name] = (L - D) * mask
            vol[name] = (torch.abs(D) + torch.abs(L)) * ds * mask
            per_bucket.append((name, D, L, x, ds, mask, needs_floor))
        psi_orig = solver._psum(solver._reduce_edges(net, buckets)) * self._dvec
        gross = solver._psum(solver._reduce_edges(vol, buckets))
        # per-asset row scales, as certify's: violations judged against the
        # asset's own magnitude (|psi_j| or its gross volume)
        scale = torch.clamp_min(torch.maximum(torch.abs(psi_orig), gross), 1.0)
        box_a = torch.maximum(torch.relu(self._lo - psi_orig),
                              torch.relu(psi_orig - self._hi))
        feas = torch.max(box_a / scale)
        for name, D, L, x, ds, mask, needs_floor in per_bucket:
            se = solver._bcast_nu(scale, name)
            se = torch.where(mask > 0, torch.clamp_min(se, 1.0), torch.ones_like(se))
            nneg_slot = torch.relu(torch.maximum(-D, -L)) * ds * mask
            feas = torch.maximum(feas, torch.max(nneg_slot / se))
            if needs_floor:
                floor_slot = torch.relu(-x) * ds * mask
                feas = torch.maximum(feas, torch.max(floor_slot / se))
        if solver.axis_name is not None:
            # the residuals' maxima over every rank's pools, so that every
            # rank reads the same gate and takes the same hand-off
            phi, feas = solver._pmax(torch.stack([phi, feas])).unbind(0)
        obj = torch.sum(self._c * psi_orig)
        prices = rho * nu / self._dvec
        return torch.cat([torch.stack([phi, feas, obj]), prices])

    def evaluate(self, z, nu, rho):
        """Queue the device pass and the copy of its packed result to the
        host; returns without waiting (on the card the copy lands in pinned
        memory, and an event marks its end)."""
        packed = self._impl(z, nu, self.solver._t(rho))
        if self._side is None:
            return dict(host=packed, event=None)
        buf = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        buf.copy_(packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return dict(host=buf, event=event)

    def finish(self, out) -> GateEstimate:
        """Wait for the pass's copy, then evaluate the float64 prices-only
        dual bound -> a :class:`GateEstimate`."""
        if out["event"] is not None:
            out["event"].synchronize()  # this gate's copy, not later work
        vals = out["host"].numpy().astype(np.float64)
        phi, feas_abs, obj = (float(v) for v in vals[:_N_SCALARS])
        prices = vals[_N_SCALARS:]
        # cheap eta-search depth: the gate only steers; a looser (still
        # rigorous) bound keeps the host half shorter than a device chunk.
        # On the card the search runs on a side stream, beside the chunk
        ctx = (torch.cuda.stream(self._side) if self._side is not None
               else contextlib.nullcontext())
        with ctx:
            dual = dual_bound(self.compiled_orig, self.objective, prices,
                              evals=(8, 4), device=self.solver.device)
        gap = dual - obj
        return GateEstimate(
            gap_rel=gap / max(1.0, abs(obj), abs(dual)),
            feasibility_rel=max(phi, feas_abs),
            objective=obj,
            dual=dual,
        )
