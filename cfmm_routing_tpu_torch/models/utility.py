"""Objective specification over the net trade vector psi.

The three reference workloads are all "linear utility + box side
constraints on psi":

- arbitrage:   max  m^T psi          s.t. psi >= 0
- liquidation: max  psi[k]           s.t. psi[j] == -a[j]  for j != k
- sweep:       max  psi[k]           s.t. psi >= -h

All three are instances of

    maximize  c^T psi    s.t.  lo <= psi <= hi

with +/-inf entries allowed in the box (an equality is ``lo == hi``).
:class:`Objective` captures exactly this; the ADMM psi-prox
(``ops/prox.py``) solves its diagonally-weighted prox in closed form.

Beyond the linear case, :class:`ConcaveUtility` expresses any separable
concave utility over psi from an atom library (linear / quadratic / log /
power).  The ADMM consensus prox stays closed-form per asset
(``ops/prox.py::utility_prox``), so nonlinear utilities cost the same per
iteration as linear ones.

:class:`CustomUtility` takes any concave, differentiable U(psi) given as a
callable on tensors (non-separable: ``log(1 + c @ psi)``, a full quadratic
form); its consensus prox is a fixed-trip FISTA (``ops/prox.py::custom_prox``)
on the gradient from ``torch.autograd``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Objective", "ConcaveUtility", "CustomUtility"]

_INF = np.inf


@dataclasses.dataclass(frozen=True)
class Objective:
    """maximize c^T psi  subject to  lo <= psi <= hi (entrywise)."""

    c: np.ndarray
    lo: np.ndarray
    hi: np.ndarray

    def __init__(self, c, lo=None, hi=None):
        c = np.asarray(c, dtype=np.float64)
        n = c.shape[-1]
        lo = np.full(n, -_INF) if lo is None else np.asarray(lo, np.float64)
        hi = np.full(n, _INF) if hi is None else np.asarray(hi, np.float64)
        if lo.shape != c.shape or hi.shape != c.shape:
            raise ValueError("c, lo, hi must have identical shapes")
        if np.any(lo > hi):
            raise ValueError("box is empty: lo > hi somewhere")
        object.__setattr__(self, "c", c)
        object.__setattr__(self, "lo", lo)
        object.__setattr__(self, "hi", hi)

    @property
    def n_assets(self) -> int:
        return self.c.shape[-1]

    @staticmethod
    def arbitrage(market_values) -> "Objective":
        """max market_value @ psi s.t. psi >= 0."""
        c = np.asarray(market_values, np.float64)
        return Objective(c, lo=np.zeros_like(c))

    @staticmethod
    def liquidation(n: int, numeraire: int, holdings) -> "Objective":
        """max psi[numeraire] s.t. psi[j] == -holdings[j] for the rest."""
        holdings = np.asarray(holdings, np.float64)
        c = np.zeros(n)
        c[numeraire] = 1.0
        lo = -holdings.copy()
        hi = -holdings.copy()
        lo[numeraire], hi[numeraire] = -_INF, _INF
        return Objective(c, lo, hi)

    @staticmethod
    def trade(n: int, receive: int, holdings) -> "Objective":
        """max psi[receive] s.t. psi >= -holdings."""
        holdings = np.asarray(holdings, np.float64)
        c = np.zeros(n)
        c[receive] = 1.0
        return Objective(c, lo=-holdings)


# atom kind codes (must match ops/prox.py)
_LINEAR, _QUAD, _LOG, _POWER = 0, 1, 2, 3
_DOMAIN_EPS = 1e-9  # keep log/power strictly inside their domain


@dataclasses.dataclass(frozen=True)
class ConcaveUtility:
    """Separable concave utility  U(psi) = sum_j U_j(psi_j)  with a box.

    Per-asset atoms (see ``ops/prox.py`` for the prox math):

        linear      U = c * psi
        quadratic   U = c * psi - (a/2) psi^2          (a >= 0)
        log         U = c * log(b + psi)               (c >= 0, psi > -b)
        power       U = (c/p) * (b + psi)^p            (c >= 0, 0 < p < 1)

    Construct with :meth:`linear` / :meth:`from_objective`, then refine
    individual assets with the ``with_*`` methods (each returns a new
    instance).  ``value``/``grad`` give float64 host evaluations (the
    certificate uses them); ``pack`` produces the tensor encoding.
    """

    kind: np.ndarray  # (n,) int32 atom codes
    c: np.ndarray
    a: np.ndarray
    b: np.ndarray
    p: np.ndarray
    lo: np.ndarray
    hi: np.ndarray

    @property
    def n_assets(self) -> int:
        return self.kind.shape[0]

    @staticmethod
    def linear(c, lo=None, hi=None) -> "ConcaveUtility":
        obj = Objective(c, lo, hi)
        n = obj.n_assets
        z = np.zeros(n)
        return ConcaveUtility(
            kind=np.zeros(n, np.int32), c=obj.c.copy(), a=z.copy(),
            b=z.copy(), p=z.copy(), lo=obj.lo.copy(), hi=obj.hi.copy(),
        )

    @staticmethod
    def from_objective(obj: Objective) -> "ConcaveUtility":
        return ConcaveUtility.linear(obj.c, obj.lo, obj.hi)

    # ---- per-asset refinement (functional setters) --------------------------

    def _replace_at(self, j: int, **fields) -> "ConcaveUtility":
        arrays = {
            name: getattr(self, name).copy()
            for name in ("kind", "c", "a", "b", "p", "lo", "hi")
        }
        for name, v in fields.items():
            arrays[name][j] = v
        out = ConcaveUtility(**arrays)
        out._validate_at(j)
        return out

    def _validate_at(self, j: int):
        k = int(self.kind[j])
        if k in (_LOG, _POWER):
            if self.c[j] < 0:
                raise ValueError("log/power atoms need c >= 0 for concavity")
            # clamp the box into the domain psi >= -b
            dom = -self.b[j] + _DOMAIN_EPS * max(1.0, abs(self.b[j]))
            if self.hi[j] <= dom:
                raise ValueError("box lies outside the log/power domain")
            self.lo[j] = max(self.lo[j], dom)
        if k == _QUAD and self.a[j] < 0:
            raise ValueError("quadratic atom needs a >= 0 for concavity")
        if k == _POWER and not (0.0 < self.p[j] < 1.0):
            raise ValueError("power atom needs 0 < p < 1")

    def with_linear(self, j: int, c: float) -> "ConcaveUtility":
        return self._replace_at(j, kind=_LINEAR, c=c, a=0.0, b=0.0, p=0.0)

    def with_quadratic(self, j: int, c: float, a: float) -> "ConcaveUtility":
        """U_j = c*psi - (a/2)*psi^2 (risk-penalized value)."""
        return self._replace_at(j, kind=_QUAD, c=c, a=a, b=0.0, p=0.0)

    def with_log(self, j: int, c: float, b: float) -> "ConcaveUtility":
        """U_j = c*log(b + psi) (Cobb-Douglas term around holdings b)."""
        return self._replace_at(j, kind=_LOG, c=c, a=0.0, b=b, p=0.0)

    def with_power(self, j: int, c: float, p: float, b: float = 0.0):
        """U_j = (c/p)*(b + psi)^p (CRRA/CES term)."""
        return self._replace_at(j, kind=_POWER, c=c, a=0.0, b=b, p=p)

    def with_box(self, j: int, lo: float, hi: float) -> "ConcaveUtility":
        if lo > hi:
            raise ValueError("empty box")
        return self._replace_at(j, lo=lo, hi=hi)

    # ---- host evaluation (float64; certification) ---------------------------

    def value_vec(self, psi: np.ndarray) -> np.ndarray:
        """Per-asset utility terms U_j(psi_j) (float64)."""
        psi = np.asarray(psi, np.float64)
        y = np.maximum(self.b + psi, 1e-300)
        p_safe = np.where(self.kind == _POWER, np.clip(self.p, 0.01, 0.99), 1.0)
        return np.where(
            self.kind == _LINEAR, self.c * psi,
            np.where(
                self.kind == _QUAD, self.c * psi - 0.5 * self.a * psi * psi,
                np.where(
                    self.kind == _LOG, self.c * np.log(y),
                    (self.c / p_safe) * y**p_safe,
                ),
            ),
        )

    def value(self, psi: np.ndarray) -> float:
        return float(np.sum(self.value_vec(psi)))

    def grad(self, psi: np.ndarray) -> np.ndarray:
        psi = np.asarray(psi, np.float64)
        y = np.maximum(self.b + psi, 1e-300)
        p_safe = np.where(self.kind == _POWER, np.clip(self.p, 0.01, 0.99), 1.0)
        return np.where(
            self.kind == _LINEAR, self.c,
            np.where(
                self.kind == _QUAD, self.c - self.a * psi,
                np.where(
                    self.kind == _LOG, self.c / y,
                    self.c * y ** (p_safe - 1.0),
                ),
            ),
        )

    # ---- tensor packing ------------------------------------------------------

    def pack(self, dtype, device=None):
        """Encode as a :class:`~cfmm_routing_tpu_torch.ops.prox.PackedUtility`
        of tensors on ``device`` (box clamped to float32-safe finite values
        and to the atom domains).  ``device=None``: the card, as every entry
        point of the package (raises without one)."""
        import torch

        from .._device import resolve_device
        from ..ops.prox import PackedUtility

        device = resolve_device(device)

        big = np.finfo(np.float32).max / 4
        dom = np.where(
            (self.kind == _LOG) | (self.kind == _POWER),
            -self.b + _DOMAIN_EPS * np.maximum(1.0, np.abs(self.b)),
            -big,
        )
        lo = np.maximum(np.maximum(self.lo, dom), -big)
        hi = np.minimum(self.hi, big)

        def t(x, dt=dtype):
            return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

        return PackedUtility(
            kind=t(self.kind, torch.int32), c=t(self.c), a=t(self.a),
            b=t(self.b), p=t(self.p), lo=t(lo), hi=t(np.maximum(hi, lo)),
            has_power=bool(np.any(self.kind == _POWER)),
        )


@dataclasses.dataclass(frozen=True)
class CustomUtility:
    """Non-separable concave utility U(psi) given as a callable on tensors.

    The consensus prox of a non-separable U has no closed form: the solver
    runs a fixed-trip strongly-convex FISTA inside each ADMM iteration
    (``ops/prox.py::custom_prox``), whose gradient comes from
    ``torch.autograd``.

    Parameters
    ----------
    fn : callable(tensor (n,)) -> scalar tensor, concave and differentiable
        on the box.  Torch ops only, on the device and in the dtype of its
        argument (close over tensors and move them with ``t.to(psi)``); it
        must not read a value back to the host (``float(x)``, ``.item()``,
        ``.cpu()``), because on the card the solver captures it into a CUDA
        graph, and such a capture raises.
    lo, hi : the box on psi (finite or +-inf per entry).
    smoothness : upper bound on the largest eigenvalue of -Hessian(U) over
        the box (the gradient step is 1/(smoothness + max_j w_j)).
    prox_iters : inner FISTA trips per ADMM iteration.
    conjugate : optional host callable nu -> an UPPER bound on
        sup_psi U(psi) - nu @ psi over the box.  ``certify`` needs it;
        without it only residual-based stopping is available.

    ``value``/``grad`` evaluate fn in float64 on the CPU.
    """

    fn: object
    lo: np.ndarray
    hi: np.ndarray
    smoothness: float
    prox_iters: int = 60
    conjugate: object = None

    def __init__(self, fn, lo, hi, smoothness, prox_iters=60, conjugate=None):
        lo = np.asarray(lo, np.float64)
        hi = np.asarray(hi, np.float64)
        if lo.shape != hi.shape:
            raise ValueError("lo and hi must have identical shapes")
        if np.any(lo > hi):
            raise ValueError("box is empty: lo > hi somewhere")
        if not np.isfinite(smoothness) or smoothness < 0:
            raise ValueError("smoothness must be a finite nonneg bound")
        object.__setattr__(self, "fn", fn)
        object.__setattr__(self, "lo", lo)
        object.__setattr__(self, "hi", hi)
        object.__setattr__(self, "smoothness", float(smoothness))
        object.__setattr__(self, "prox_iters", int(prox_iters))
        object.__setattr__(self, "conjugate", conjugate)

    @property
    def n_assets(self) -> int:
        return self.lo.shape[0]

    def value(self, psi) -> float:
        import torch

        x = torch.as_tensor(np.asarray(psi, np.float64), dtype=torch.float64)
        with torch.no_grad():
            return float(self.fn(x))

    def grad(self, psi) -> np.ndarray:
        import torch

        x = torch.as_tensor(np.array(psi, np.float64), dtype=torch.float64)
        return autograd_grad(self.fn, x).numpy()


def autograd_grad(fn, x):
    """d fn / d x at ``x`` through ``torch.autograd`` (a detached tensor of
    x's shape; zero where fn does not depend on x)."""
    import torch

    with torch.enable_grad():
        y = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(y), y, allow_unused=True)
    return torch.zeros_like(x) if g is None else g.detach()
