"""Fused ADMM iteration kernel: projection + consensus exchange in one pass
per bucket.

Counterpart of the JAX package's Pallas ``fused_step``
(``cfmm_routing_tpu/ops/iteration_pallas.py``), unfolded.  The classic
iteration (solver/admm.py ``_iterate``) spends most of its time on the two
consensus maps (broadcast nu to edges, reduce edges to assets) and on
re-reading edge arrays between them.  The fused form restructures the
same update:

State per bucket:  s = (sD, sL), evolving as  s' = alpha*w + (1-alpha)*s
  (w = projected trades).  s carries no broadcast term: the identity

      z(t) = s(t) + wdef(t)_e        (z the classic ADMM edge state)

  holds with an O(n) deferred-broadcast vector recursion
  wdef(t+1) = (1-alpha)*wdef(t) + (nu(t) - mu(t)) kept outside the kernel
  (solver/admm.py ``_iterate_fused``).  The projection input needs only
  v = wdef - nu broadcast once:

      p = sD + v_e,   q = sL - v_e,      (D, L) = Proj_T(p, q)

  and the consensus reduction needs only array terms
      y = reduce(alpha*(L-D) + (1-alpha)*(sL-sD))
  (the deferred part contributes -2*(1-alpha)*degree*wdef in O(n)).

The refinement stage runs the same iteration on the shifted trading sets
of ``ops/projection_delta.py`` (:func:`fused_step_delta`): the projection
input is further offset by the pre-broadcast base dual ``nu0e``, and the
projection is the delta one; the deferred-broadcast algebra is unchanged.

The CUDA kernels are ``csrc/fused_step.cu`` and ``csrc/fused_step_delta.cu``.
Each writes its slots' consensus terms to a (K, m) plane that the
segment-sum kernel (``ops/segment.py``) reduces per asset in a fixed order,
so y is bitwise repeatable on the card.  On a CPU tensor the wrappers run
the plain versions (gather -> plain projection -> update -> the segment
sum's plain version, in the kernel's order); on a CUDA tensor they launch
the kernels or raise.

Shapes: s/D/L (K, m) slot-major; v/y are (n_pad,) with n_pad a multiple of
128 (``AdmmSolver._fold_pack``).

``fold=(T, n_pt)``: the bucket is a scenario fold (``solver/fold.py``), T
points one after another on the pool axis with m / T pools each (a
multiple of 128, else ``ValueError``) and point t's asset ids offset by
t * n_pt, so v and y keep the unfolded layout.  Each block of the kernel
stages only its own point's n_pt prices; a slot whose id lies outside its
point's block (a padding slot) reads 0 before the mask, in the kernel and
in the plain version alike.
"""
from __future__ import annotations

import torch

from . import _build
from .projection import ProjectionConfig, project_cs, project_gm
from .projection_cuda import _KIND, check_cuda_args, dtype_code
from .projection_delta import project_cs_delta, project_gm_delta
from .segment import segment_sum, segment_sum_plain

__all__ = ["fused_step", "fused_step_plain", "fused_step_delta",
           "fused_step_delta_plain"]


def _gather(v, arrs, K, m, fold=None):
    ids = arrs["asset"]
    if fold is None:
        return v.index_select(0, ids.reshape(-1)).reshape(K, m) * arrs["mask"]
    T, n_pt = fold
    base = torch.arange(m, device=ids.device) // (m // T) * n_pt  # (m,)
    ok = (ids >= base) & (ids < base + n_pt)
    ve = v.index_select(0, torch.where(ok, ids, base).reshape(-1)).reshape(K, m)
    return torch.where(ok, ve, torch.zeros_like(ve)) * arrs["mask"]


def _check_fold(m, v, fold, what):
    """(T, n_pt) of a fold call, or raise: every block of 128 pools must lie
    inside one point, and the T price blocks inside v."""
    T, n_pt = int(fold[0]), int(fold[1])
    if T < 1 or m % T != 0 or (m // T) % 128 != 0:
        raise ValueError(
            f"{what}(fold={fold}): {m} pools do not split into {T} points of "
            "a multiple of 128 pools each; compile with pad_pools_to=128"
        )
    if T * n_pt > v.shape[0]:
        raise ValueError(f"{what}(fold={fold}): v has {v.shape[0]} entries, "
                         f"fewer than {T} x {n_pt}")
    return T, n_pt


def _update(sD, sL, A, B, v, arrs, alpha):
    """Relaxation and the consensus reduction, in the segment-sum kernel's
    fixed order (``segment_sum_plain``)."""
    a = float(alpha)
    b = 1.0 - a
    sDn = a * A + b * sD
    sLn = a * B + b * sL
    val = a * (B - A) + b * (sL - sD)
    y = segment_sum_plain(val, arrs["order"], arrs["seg"], v.shape[0])
    return sDn, sLn, A, B, y


def _check_ids_and_v(sD, v, arrs, what):
    K, m = sD.shape
    asset = arrs["asset"]
    if (asset.dtype != torch.int32 or asset.shape != (K, m)
            or not asset.is_contiguous() or asset.device != sD.device):
        raise ValueError(f"{what}: asset ids must be a contiguous int32 "
                         f"(K, m) tensor on {sD.device}")
    if (v.dim() != 1 or v.dtype != sD.dtype or v.device != sD.device
            or not v.is_contiguous() or v.shape[0] % 128 != 0):
        raise ValueError(f"{what}: v must be a contiguous (n_pad,) vector "
                         "of the planes' dtype, n_pad a multiple of 128")
    if arrs["seg"].numel() - 1 > v.shape[0]:
        raise ValueError(f"{what}: the bucket's asset count exceeds n_pad")


def fused_step_plain(sD, sL, v, arrs, kind, needs_floor, alpha: float,
                     cfg: ProjectionConfig = ProjectionConfig(), fold=None):
    """The fused half-iteration in plain PyTorch, on any device.

    Returns (sD', sL', D, L, y(n_pad,))."""
    K, m = sD.shape
    mask = arrs["mask"]
    if fold is not None:
        fold = _check_fold(m, v, fold, "fused_step")
    ve = _gather(v, arrs, K, m, fold)
    p = sD + ve
    q = sL - ve
    if kind == "gm":
        D, L = project_gm(
            p, q, arrs["R"], arrs["w"], arrs["s"], arrs["gamma"],
            arrs["logk0"], arrs["k0"], mask, needs_floor=needs_floor, cfg=cfg,
        )
    else:
        D, L = project_cs(
            p, q, arrs["R"], arrs["gamma"], arrs["w"], arrs["k0"], mask,
            cfg=cfg,
        )
    return _update(sD, sL, D, L, v, arrs, alpha)


def fused_step(sD, sL, v, arrs, kind, needs_floor, alpha: float,
               cfg: ProjectionConfig = ProjectionConfig(), fold=None):
    """One fused half-iteration for one bucket.

    sD/sL: (K, m) state planes;  v: (n_pad,) combined broadcast vector
    (wdef - nu, zero-padded);  arrs: the solver's device bucket dict
    (asset ids int32 in [0, n_pad), slot order and offsets for the
    reduction);  fold: (T, n_pt) of a scenario fold (module docstring).
    Returns (sD', sL', D, L, y(n_pad,)).
    """
    if fold is not None:
        fold = _check_fold(sD.shape[1], v, fold, "fused_step")
    if sD.device.type == "cpu":
        return fused_step_plain(sD, sL, v, arrs, kind, needs_floor, alpha, cfg,
                                fold)
    planes = (sD, sL, arrs["R"], arrs["w"], arrs["s"], arrs["mask"])
    vectors = (arrs["gamma"], arrs["logk0"], arrs["k0"])
    K, m = check_cuda_args(planes, vectors, "fused_step")
    _check_ids_and_v(sD, v, arrs, "fused_step")
    asset = arrs["asset"]
    n_pad = v.shape[0]
    sDn = torch.empty_like(sD)
    sLn = torch.empty_like(sD)
    D = torch.empty_like(sD)
    L = torch.empty_like(sD)
    val = torch.empty_like(sD)
    a = float(alpha)
    lib = _build.library("fused_step")
    fm, fn = _fold_args(m, fold)
    with torch.cuda.device(sD.device):
        stream = torch.cuda.current_stream(sD.device).cuda_stream
        rc = lib.cfmm_fused_step(
            dtype_code(sD.dtype), _KIND[(kind, bool(needs_floor))], K, m,
            n_pad, fm, fn, a, 1.0 - a,
            sD.data_ptr(), sL.data_ptr(), asset.data_ptr(),
            arrs["R"].data_ptr(), arrs["w"].data_ptr(), arrs["s"].data_ptr(),
            arrs["mask"].data_ptr(), arrs["gamma"].data_ptr(),
            arrs["logk0"].data_ptr(), arrs["k0"].data_ptr(), v.data_ptr(),
            sDn.data_ptr(), sLn.data_ptr(), D.data_ptr(), L.data_ptr(),
            val.data_ptr(), int(cfg.n_bisect), int(cfg.n_polish), stream,
        )
    _build.check_launch(rc, "fused_step")
    _build.LAUNCHES["fused_step" if fold is None else "fused_step_fold"] += 1
    y = segment_sum(val, arrs["order"], arrs["seg"], n_pad)
    return sDn, sLn, D, L, y


def _fold_args(m, fold):
    """The C launchers' (fold_m, fold_n): pools and prices per point, or
    (0, 0) unfolded."""
    return (0, 0) if fold is None else (m // fold[0], fold[1])


def _nu0e(arrs):
    nu0e = arrs.get("nu0e")
    return torch.zeros_like(arrs["mask"]) if nu0e is None else nu0e


def fused_step_delta_plain(sD, sL, v, arrs, kind, needs_floor, alpha: float,
                           cfg: ProjectionConfig = ProjectionConfig(), fold=None):
    """The fused delta half-iteration in plain PyTorch, on any device.

    Returns (sD', sL', a, b, y(n_pad,))."""
    K, m = sD.shape
    mask = arrs["mask"]
    if fold is not None:
        fold = _check_fold(m, v, fold, "fused_step_delta")
    off = _gather(v, arrs, K, m, fold) - _nu0e(arrs)
    p = sD + off
    q = sL - off
    if kind == "gm":
        A, B = project_gm_delta(
            p, q, arrs["X0"], arrs["w"], arrs["sS"], arrs["gamma"],
            arrs["nsig"], arrs["aD"], arrs["aL"], mask,
            needs_floor=needs_floor, cfg=cfg,
        )
    else:
        A, B = project_cs_delta(
            p, q, arrs["X0"], arrs["gamma"], arrs["w"], arrs["nsig"],
            arrs["aD"], arrs["aL"], mask, cfg=cfg,
        )
    return _update(sD, sL, A, B, v, arrs, alpha)


def fused_step_delta(sD, sL, v, arrs, kind, needs_floor, alpha: float,
                     cfg: ProjectionConfig = ProjectionConfig(), fold=None):
    """One fused half-iteration for one DELTA bucket (refinement stage).

    sD/sL: (K, m) delta state planes;  v: (n_pad,) combined broadcast vector
    (wdef - dnu, zero-padded);  arrs: a delta bucket dict from
    ``DeltaAdmmSolver.delta_buckets`` (X0/w/sS/aD/aL/mask/gamma/nsig and, on
    the re-centred path, the pre-broadcast base-dual plane nu0e).  The
    constant-sum reserve floor always applies;  fold: (T, n_pt) of a
    scenario fold (module docstring).  Returns (sD', sL', a, b, y(n_pad,)).
    """
    if fold is not None:
        fold = _check_fold(sD.shape[1], v, fold, "fused_step_delta")
    if sD.device.type == "cpu":
        return fused_step_delta_plain(sD, sL, v, arrs, kind, needs_floor,
                                      alpha, cfg, fold)
    nu0e = arrs.get("nu0e")
    planes = (sD, sL, arrs["X0"], arrs["w"], arrs["sS"], arrs["aD"],
              arrs["aL"], arrs["mask"]) + (() if nu0e is None else (nu0e,))
    K, m = check_cuda_args(planes, (arrs["gamma"], arrs["nsig"]),
                           "fused_step_delta")
    _check_ids_and_v(sD, v, arrs, "fused_step_delta")
    n_pad = v.shape[0]
    sDn = torch.empty_like(sD)
    sLn = torch.empty_like(sD)
    A = torch.empty_like(sD)
    B = torch.empty_like(sD)
    val = torch.empty_like(sD)
    a = float(alpha)
    lib = _build.library("fused_step_delta")
    fm, fn = _fold_args(m, fold)
    with torch.cuda.device(sD.device):
        stream = torch.cuda.current_stream(sD.device).cuda_stream
        rc = lib.cfmm_fused_step_delta(
            dtype_code(sD.dtype), _KIND[(kind, bool(needs_floor))], K, m,
            n_pad, fm, fn, a, 1.0 - a,
            sD.data_ptr(), sL.data_ptr(), arrs["asset"].data_ptr(),
            arrs["X0"].data_ptr(), arrs["w"].data_ptr(), arrs["sS"].data_ptr(),
            arrs["aD"].data_ptr(), arrs["aL"].data_ptr(),
            arrs["mask"].data_ptr(), None if nu0e is None else nu0e.data_ptr(),
            arrs["gamma"].data_ptr(), arrs["nsig"].data_ptr(), v.data_ptr(),
            sDn.data_ptr(), sLn.data_ptr(), A.data_ptr(), B.data_ptr(),
            val.data_ptr(), int(cfg.n_bisect), int(cfg.n_polish), stream,
        )
    _build.check_launch(rc, "fused_step_delta")
    _build.LAUNCHES["fused_step_delta" if fold is None
                    else "fused_step_delta_fold"] += 1
    y = segment_sum(val, arrs["order"], arrs["seg"], n_pad)
    return sDn, sLn, A, B, y
