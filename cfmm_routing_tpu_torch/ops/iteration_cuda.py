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

The CUDA kernel is ``csrc/fused_step.cu``.  On a CPU tensor the wrapper runs
:func:`fused_step_plain` (gather -> plain projection -> update ->
``index_add_``); on a CUDA tensor it launches the kernel or raises.

Shapes: s/D/L (K, m) slot-major; v/y are (n_pad,) with n_pad a multiple of
128 (``AdmmSolver._fold_pack``).
"""
from __future__ import annotations

import torch

from . import _build
from .projection import ProjectionConfig, project_cs, project_gm
from .projection_cuda import _KIND, check_cuda_args, dtype_code

__all__ = ["fused_step", "fused_step_plain"]


def fused_step_plain(sD, sL, v, arrs, kind, needs_floor, alpha: float,
                     cfg: ProjectionConfig = ProjectionConfig()):
    """The fused half-iteration in plain PyTorch, on any device.

    Returns (sD', sL', D, L, y(n_pad,))."""
    K, m = sD.shape
    mask = arrs["mask"]
    asset = arrs["asset"]
    ve = v.index_select(0, asset.reshape(-1)).reshape(K, m) * mask
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
    a = float(alpha)
    b = 1.0 - a
    sDn = a * D + b * sD
    sLn = a * L + b * sL
    val = a * (L - D) + b * (sL - sD)
    y = torch.zeros_like(v).index_add_(0, asset.reshape(-1), val.reshape(-1))
    return sDn, sLn, D, L, y


def fused_step(sD, sL, v, arrs, kind, needs_floor, alpha: float,
               cfg: ProjectionConfig = ProjectionConfig()):
    """One fused half-iteration for one bucket.

    sD/sL: (K, m) state planes;  v: (n_pad,) combined broadcast vector
    (wdef - nu, zero-padded);  arrs: the solver's device bucket dict
    (asset ids int32 in [0, n_pad)).  Returns (sD', sL', D, L, y(n_pad,)).
    """
    if sD.device.type == "cpu":
        return fused_step_plain(sD, sL, v, arrs, kind, needs_floor, alpha, cfg)
    planes = (sD, sL, arrs["R"], arrs["w"], arrs["s"], arrs["mask"])
    vectors = (arrs["gamma"], arrs["logk0"], arrs["k0"])
    K, m = check_cuda_args(planes, vectors, "fused_step")
    asset = arrs["asset"]
    if (asset.dtype != torch.int32 or asset.shape != (K, m)
            or not asset.is_contiguous() or asset.device != sD.device):
        raise ValueError("fused_step: asset ids must be a contiguous int32 "
                         f"(K, m) tensor on {sD.device}")
    if (v.dim() != 1 or v.dtype != sD.dtype or v.device != sD.device
            or not v.is_contiguous() or v.shape[0] % 128 != 0):
        raise ValueError("fused_step: v must be a contiguous (n_pad,) vector "
                         "of the planes' dtype, n_pad a multiple of 128")
    n_pad = v.shape[0]
    sDn = torch.empty_like(sD)
    sLn = torch.empty_like(sD)
    D = torch.empty_like(sD)
    L = torch.empty_like(sD)
    y = torch.zeros_like(v)
    a = float(alpha)
    lib = _build.library("fused_step")
    with torch.cuda.device(sD.device):
        stream = torch.cuda.current_stream(sD.device).cuda_stream
        rc = lib.cfmm_fused_step(
            dtype_code(sD.dtype), _KIND[(kind, bool(needs_floor))], K, m,
            n_pad, a, 1.0 - a,
            sD.data_ptr(), sL.data_ptr(), asset.data_ptr(),
            arrs["R"].data_ptr(), arrs["w"].data_ptr(), arrs["s"].data_ptr(),
            arrs["mask"].data_ptr(), arrs["gamma"].data_ptr(),
            arrs["logk0"].data_ptr(), arrs["k0"].data_ptr(), v.data_ptr(),
            sDn.data_ptr(), sLn.data_ptr(), D.data_ptr(), L.data_ptr(),
            y.data_ptr(), int(cfg.n_bisect), int(cfg.n_polish), stream,
        )
    _build.check_launch(rc, "fused_step")
    _build.LAUNCHES["fused_step"] += 1
    return sDn, sLn, D, L, y
