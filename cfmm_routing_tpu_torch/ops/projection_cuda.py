"""Batched projection kernels for Hopper: ``project_gm`` and ``project_cs``.

Counterparts of the JAX package's Pallas kernels ``project_gm_pallas`` /
``project_cs_pallas`` (``cfmm_routing_tpu/ops/projection_pallas.py``).  The
CUDA source is ``csrc/projection.cu`` over the shared device projection in
``csrc/projection.cuh``: one thread per pool, the whole root-find in
registers, bound by arithmetic (see the header).

On a CPU tensor the wrappers run the plain PyTorch version
(``ops/projection.py``); on a CUDA tensor they launch the kernel or raise.
The kernels take float32 or float64 and K in (2, 4, 8) (``pad_pow2``).
"""
from __future__ import annotations

import torch

from . import _build
from .projection import ProjectionConfig, project_cs, project_gm

__all__ = ["project_gm_cuda", "project_cs_cuda", "KERNEL_WIDTHS", "dtype_code"]

KERNEL_WIDTHS = (2, 4, 8)
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
    non-contiguous tensor, a wrong shape or an unsupported K."""
    ref = planes[0]
    if ref.device.type != "cuda":
        raise RuntimeError(
            f"{what}: tensors on {ref.device} — the kernel runs on CUDA "
            "tensors and the plain version on CPU tensors"
        )
    if ref.dim() != 2:
        raise ValueError(f"{what}: slot planes must be (K, m), got {tuple(ref.shape)}")
    K, m = ref.shape
    if K not in KERNEL_WIDTHS:
        raise ValueError(
            f"{what}: the kernels take K in {KERNEL_WIDTHS} slots per pool, "
            f"got K={K} (compile with pad_pow2=True)"
        )
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
