"""Batched projection kernels for Hopper: ``project_gm`` and ``project_cs``,
and their delta (refinement) forms ``project_gm_delta`` /
``project_cs_delta``.

``project_gm``/``project_cs`` are the counterparts of the JAX package's
Pallas kernels ``project_gm_pallas`` / ``project_cs_pallas``
(``cfmm_routing_tpu/ops/projection_pallas.py``); their CUDA source is
``csrc/projection.cu`` over the shared device projection in
``csrc/projection.cuh``.  The delta forms run the refinement stage's
classic iteration, which the JAX package leaves to XLA
(``ops/projection_delta.py`` there); their source is
``csrc/projection_delta.cu`` over ``csrc/projection_delta.cuh``.  One
thread per pool, the root-find in registers, bound by arithmetic (see the
headers).

On a CPU tensor the wrappers run the plain PyTorch version
(``ops/projection.py``); on a CUDA tensor they launch the kernel or raise.
The kernels take float32 or float64 and any K: K in {2, 4, 8, 16} runs a
register instantiation, any other K one that reads its slots from memory
inside the root-find (``csrc/projection.cuh``).
"""
from __future__ import annotations

import torch

from . import _build
from .projection import ProjectionConfig, project_cs, project_gm
from .projection_delta import project_cs_delta, project_gm_delta

__all__ = ["project_gm_cuda", "project_cs_cuda", "project_gm_delta_cuda",
           "project_cs_delta_cuda", "dtype_code"]

_KIND = {("gm", False): 0, ("gm", True): 1, ("cs", True): 2, ("cs", False): 2}


def dtype_code(dtype: torch.dtype) -> int:
    if dtype == torch.float32:
        return 0
    if dtype == torch.float64:
        return 1
    raise TypeError(f"the CUDA kernels take float32 or float64, not {dtype}")


def check_cuda_args(planes, vectors, what: str):
    """Validate the (K, m) planes and (m,) vectors a kernel takes; returns
    (K, m).  Raises on a non-CUDA device, mixed devices or dtypes, a
    non-contiguous tensor or a wrong shape."""
    ref = planes[0]
    if ref.device.type != "cuda":
        raise RuntimeError(
            f"{what}: tensors on {ref.device} — the kernel runs on CUDA "
            "tensors and the plain version on CPU tensors"
        )
    if ref.dim() != 2:
        raise ValueError(f"{what}: slot planes must be (K, m), got {tuple(ref.shape)}")
    K, m = ref.shape
    dtype_code(ref.dtype)
    for t in planes:
        if t.shape != (K, m):
            raise ValueError(f"{what}: plane of shape {tuple(t.shape)}, expected {(K, m)}")
    for t in vectors:
        if t.shape != (m,):
            raise ValueError(f"{what}: vector of shape {tuple(t.shape)}, expected {(m,)}")
    for t in list(planes) + list(vectors):
        if t.device != ref.device:
            raise ValueError(f"{what}: tensors on {t.device} and {ref.device}")
        if t.dtype != ref.dtype:
            raise TypeError(f"{what}: mixed dtypes {t.dtype} and {ref.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: the kernel takes contiguous tensors")
    return K, m


def _launch(kind_code, p, q, R, w, s, mask, gamma, logk0, k0, cfg, what):
    D = torch.empty_like(p)
    L = torch.empty_like(p)
    K, m = p.shape
    lib = _build.library("projection")
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = lib.cfmm_project(
            dtype_code(p.dtype), kind_code, K, m,
            p.data_ptr(), q.data_ptr(), R.data_ptr(), w.data_ptr(),
            None if s is None else s.data_ptr(), mask.data_ptr(),
            gamma.data_ptr(), None if logk0 is None else logk0.data_ptr(),
            k0.data_ptr(), D.data_ptr(), L.data_ptr(),
            int(cfg.n_bisect), int(cfg.n_polish), stream,
        )
    _build.check_launch(rc, what)
    _build.LAUNCHES[what] += 1
    return D, L


def project_gm_cuda(
    p, q, R, w, s, gamma, logk0, k0, mask,
    needs_floor: bool = False,
    cfg: ProjectionConfig = ProjectionConfig(),
):
    """Project (p, q) onto geo-mean trading sets (``ops/projection.py``'s
    :func:`~.projection.project_gm`).  Returns (D, L) (K, m)."""
    if p.device.type == "cpu":
        return project_gm(p, q, R, w, s, gamma, logk0, k0, mask,
                          needs_floor=needs_floor, cfg=cfg)
    check_cuda_args((p, q, R, w, s, mask), (gamma, logk0, k0), "project_gm")
    return _launch(_KIND[("gm", bool(needs_floor))], p, q, R, w, s, mask,
                   gamma, logk0, k0, cfg, "project_gm")


def project_cs_cuda(
    p, q, R, gamma, w, k0, mask,
    cfg: ProjectionConfig = ProjectionConfig(),
):
    """Project (p, q) onto (weighted) constant-sum trading sets with the
    reserve floor (:func:`~.projection.project_cs`).  Returns (D, L)."""
    if p.device.type == "cpu":
        return project_cs(p, q, R, gamma, w, k0, mask, cfg=cfg)
    check_cuda_args((p, q, R, w, mask), (gamma, k0), "project_cs")
    return _launch(_KIND[("cs", True)], p, q, R, w, None, mask, gamma, None,
                   k0, cfg, "project_cs")


def _launch_delta(kind_code, p, q, X0, w, sS, aD, aL, mask, gamma, nsig, cfg,
                  what):
    A = torch.empty_like(p)
    B = torch.empty_like(p)
    K, m = p.shape
    lib = _build.library("projection_delta")
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = lib.cfmm_project_delta(
            dtype_code(p.dtype), kind_code, K, m,
            p.data_ptr(), q.data_ptr(), X0.data_ptr(), w.data_ptr(),
            None if sS is None else sS.data_ptr(), aD.data_ptr(),
            aL.data_ptr(), mask.data_ptr(), gamma.data_ptr(), nsig.data_ptr(),
            A.data_ptr(), B.data_ptr(), int(cfg.n_bisect), int(cfg.n_polish),
            stream,
        )
    _build.check_launch(rc, what)
    _build.LAUNCHES[what] += 1
    return A, B


def project_gm_delta_cuda(
    p, q, X0, w, sS, gamma, nsig, aD, aL, mask,
    needs_floor: bool = False,
    cfg: ProjectionConfig = ProjectionConfig(),
):
    """Project (p, q) onto shifted-scaled geo-mean trading sets
    (``ops/projection_delta.py``'s :func:`~.projection_delta.project_gm_delta`).
    Returns the scaled delta trades (a, b), (K, m)."""
    if p.device.type == "cpu":
        return project_gm_delta(p, q, X0, w, sS, gamma, nsig, aD, aL, mask,
                                needs_floor=needs_floor, cfg=cfg)
    check_cuda_args((p, q, X0, w, sS, aD, aL, mask), (gamma, nsig),
                    "project_gm_delta")
    return _launch_delta(_KIND[("gm", bool(needs_floor))], p, q, X0, w, sS, aD,
                         aL, mask, gamma, nsig, cfg, "project_gm_delta")


def project_cs_delta_cuda(
    p, q, X0, gamma, w, tgt, aD, aL, mask,
    cfg: ProjectionConfig = ProjectionConfig(),
):
    """Project (p, q) onto shifted-scaled (weighted) constant-sum sets with
    the reserve floor (:func:`~.projection_delta.project_cs_delta`).
    Returns (a, b), (K, m)."""
    if p.device.type == "cpu":
        return project_cs_delta(p, q, X0, gamma, w, tgt, aD, aL, mask, cfg=cfg)
    check_cuda_args((p, q, X0, w, aD, aL, mask), (gamma, tgt), "project_cs_delta")
    return _launch_delta(_KIND[("cs", True)], p, q, X0, w, None, aD, aL, mask,
                         gamma, tgt, cfg, "project_cs_delta")
