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
``csrc/projection_delta.cu`` over ``csrc/projection_delta.cuh``.  Bound
by arithmetic and latency (see the headers).

Both kernels run one lane per slot (K <= 32; one thread per pool above)
and one launch per group of buckets with the same K, geo-mean and
constant-sum alike (:func:`project_grouped`, :func:`project_delta_grouped`);
``project_gm_cuda`` / ``project_cs_cuda`` and ``project_gm_delta_cuda`` /
``project_cs_delta_cuda`` launch them on one bucket.

On a CPU tensor the wrappers run the plain PyTorch version
(``ops/projection.py``, ``ops/projection_delta.py``); on a CUDA tensor
they launch the kernel or raise.  The kernels take float32 or float64.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .projection import ProjectionConfig, project_cs, project_gm
from .projection_delta import project_cs_delta, project_gm_delta

__all__ = ["project_gm_cuda", "project_cs_cuda", "project_grouped",
           "project_grouped_plain", "project_gm_delta_cuda",
           "project_cs_delta_cuda", "project_delta_grouped",
           "project_delta_grouped_plain", "dtype_code", "MAX_GROUP"]

_KIND = {("gm", False): 0, ("gm", True): 1, ("cs", True): 2, ("cs", False): 2}
MAX_GROUP = 8  # buckets per grouped launch (the kernels' table size)


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


def _check_group(group, what):
    if not 1 <= len(group["names"]) <= MAX_GROUP:
        raise ValueError(
            f"{what}: a grouped launch takes 1 to {MAX_GROUP} buckets (the "
            f"kernel's descriptor table), not {len(group['names'])}"
        )


def _check_like(t, ref, what):
    """Every bucket of a group has the first bucket's slot count, dtype and
    device."""
    if t.shape[0] != ref.shape[0] or t.dtype != ref.dtype or t.device != ref.device:
        raise ValueError(f"{what}: every bucket of a group must have K = "
                         f"{ref.shape[0]} slots, dtype {ref.dtype} and device "
                         f"{ref.device}")


def group_outputs(ref, sizes, n_out):
    """One (n_out, sum K*m) allocation for a grouped launch's outputs, and
    its per-bucket (K, m) views: output j of bucket b is views[b][j]."""
    total = sum(K * m for K, m in sizes)
    out = torch.empty((n_out, total), dtype=ref.dtype, device=ref.device)
    views = []
    off = 0
    for K, m in sizes:
        views.append([out[j, off:off + K * m].view(K, m) for j in range(n_out)])
        off += K * m
    return out, views


def launch_table(dims, ptrs):
    """The ctypes arrays a grouped C launcher reads its descriptor table
    from: int dims and device pointers (None for a null pointer)."""
    return (ctypes.c_int * len(dims))(*dims), (ctypes.c_void_p * len(ptrs))(*ptrs)


def _launch_grouped(lib, entry, what, ref, names, dims, sizes, args, cfg=None,
                    n_out=2, extra=()):
    """One grouped launch of the C entry ``entry`` of library ``lib`` from
    the validated per-bucket ``dims``, ``sizes`` and input tensors ``args``
    (None for a null pointer), called as ``entry(dtype, K, n_buckets, dims,
    ptrs, *extra, [cfg's n_bisect, n_polish,] stream)`` with each bucket's
    inputs then its ``n_out`` outputs in ``ptrs``.  Returns the (n_out, sum
    K*m) output allocation and name -> its ``n_out`` per-bucket (K, m)
    views, and counts the launch under ``what``."""
    out, views = group_outputs(ref, sizes, n_out)
    ptrs = []
    for ins, outs in zip(args, views):
        ptrs += [None if t is None else t.data_ptr() for t in ins]
        ptrs += [t.data_ptr() for t in outs]
    c_dims, c_ptrs = launch_table(dims, ptrs)
    steps = () if cfg is None else (int(cfg.n_bisect), int(cfg.n_polish))
    fn = getattr(_build.library(lib), entry)
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        rc = fn(dtype_code(ref.dtype), ref.shape[0], len(names), c_dims, c_ptrs,
                *extra, *steps, stream)
    _build.check_launch(rc, what)
    _build.LAUNCHES[what] += 1
    return out, {name: tuple(outs) for name, outs in zip(names, views)}


def project_grouped_plain(inputs, buckets, group,
                          cfg: ProjectionConfig = ProjectionConfig()):
    """The plain version of :func:`project_grouped`: each bucket's plain
    projection, on any device."""
    out = {}
    for name, (kind, floor) in zip(group["names"], group["kinds"]):
        p, q = inputs[name]
        a = buckets[name]
        if kind == "gm":
            out[name] = project_gm(p, q, a["R"], a["w"], a["s"], a["gamma"],
                                   a["logk0"], a["k0"], a["mask"],
                                   needs_floor=floor, cfg=cfg)
        else:
            out[name] = project_cs(p, q, a["R"], a["gamma"], a["w"], a["k0"],
                                   a["mask"], cfg=cfg)
    return out


def project_grouped(inputs, buckets, group,
                    cfg: ProjectionConfig = ProjectionConfig()):
    """The projection of a group of buckets with the same slot count K, in
    one launch (``csrc/projection.cu``).

    ``inputs``: bucket name -> (p, q) (K, m) planes;  ``buckets``: name ->
    bucket dict (R w s mask gamma logk0 k0; s and logk0 may be absent for
    a constant-sum bucket);  ``group``: ``names`` (at most
    :data:`MAX_GROUP`) and ``kinds`` ((kind, needs_floor) per name).
    Returns name -> (D, L).  CPU tensors run :func:`project_grouped_plain`."""
    names = group["names"]
    ref = inputs[names[0]][0]
    if ref.device.type == "cpu":
        return project_grouped_plain(inputs, buckets, group, cfg)
    _check_group(group, "project")
    dims, sizes, args = [], [], []
    for name, (kind, floor) in zip(names, group["kinds"]):
        p, q = inputs[name]
        a = buckets[name]
        gm = kind == "gm"
        s, logk0 = (a["s"], a["logk0"]) if gm else (None, None)
        K, m = check_cuda_args(
            (p, q, a["R"], a["w"], a["mask"]) + ((s,) if gm else ()),
            (a["gamma"], a["k0"]) + ((logk0,) if gm else ()), "project")
        _check_like(p, ref, "project")
        dims += [m, _KIND[(kind, bool(floor))]]
        sizes.append((K, m))
        args.append((p, q, a["R"], a["w"], s, a["mask"], a["gamma"], logk0,
                     a["k0"]))
    return _launch_grouped("projection", "cfmm_project", "project", ref, names,
                           dims, sizes, args, cfg)[1]


def project_gm_cuda(
    p, q, R, w, s, gamma, logk0, k0, mask,
    needs_floor: bool = False,
    cfg: ProjectionConfig = ProjectionConfig(),
):
    """Project (p, q) onto geo-mean trading sets (``ops/projection.py``'s
    :func:`~.projection.project_gm`) through :func:`project_grouped` on a
    group of one.  Returns (D, L) (K, m)."""
    arrs = dict(R=R, w=w, s=s, gamma=gamma, logk0=logk0, k0=k0, mask=mask)
    return _one(project_grouped, ("gm", bool(needs_floor)), p, q, arrs, cfg)


def project_cs_cuda(
    p, q, R, gamma, w, k0, mask,
    cfg: ProjectionConfig = ProjectionConfig(),
):
    """Project (p, q) onto (weighted) constant-sum trading sets with the
    reserve floor (:func:`~.projection.project_cs`) through
    :func:`project_grouped` on a group of one.  Returns (D, L)."""
    arrs = dict(R=R, w=w, gamma=gamma, k0=k0, mask=mask)
    return _one(project_grouped, ("cs", True), p, q, arrs, cfg)


def project_delta_grouped_plain(inputs, buckets, group,
                                cfg: ProjectionConfig = ProjectionConfig()):
    """The plain version of :func:`project_delta_grouped`: each bucket's
    plain delta projection, on any device."""
    out = {}
    for name, (kind, floor) in zip(group["names"], group["kinds"]):
        p, q = inputs[name]
        a = buckets[name]
        if kind == "gm":
            out[name] = project_gm_delta(
                p, q, a["X0"], a["w"], a["sS"], a["gamma"], a["nsig"], a["aD"],
                a["aL"], a["mask"], needs_floor=floor, cfg=cfg)
        else:
            out[name] = project_cs_delta(
                p, q, a["X0"], a["gamma"], a["w"], a["nsig"], a["aD"], a["aL"],
                a["mask"], cfg=cfg)
    return out


def project_delta_grouped(inputs, buckets, group,
                          cfg: ProjectionConfig = ProjectionConfig()):
    """The delta projection of a group of buckets with the same slot count
    K, in one launch (``csrc/projection_delta.cu``).

    ``inputs``: bucket name -> (p, q) (K, m) planes;  ``buckets``: name ->
    delta bucket dict (X0 w sS aD aL mask gamma nsig; sS may be absent for
    a constant-sum bucket);  ``group``: ``names`` (at most
    :data:`MAX_GROUP`) and ``kinds`` ((kind, needs_floor) per name).
    Returns name -> (a, b).  CPU tensors run
    :func:`project_delta_grouped_plain`."""
    names = group["names"]
    ref = inputs[names[0]][0]
    if ref.device.type == "cpu":
        return project_delta_grouped_plain(inputs, buckets, group, cfg)
    _check_group(group, "project_delta")
    dims, sizes, args = [], [], []
    for name, (kind, floor) in zip(names, group["kinds"]):
        p, q = inputs[name]
        a = buckets[name]
        sS = a["sS"] if kind == "gm" else None
        planes = (p, q, a["X0"], a["w"], a["aD"], a["aL"], a["mask"])
        K, m = check_cuda_args(planes + (() if sS is None else (sS,)),
                               (a["gamma"], a["nsig"]), "project_delta")
        _check_like(p, ref, "project_delta")
        dims += [m, _KIND[(kind, bool(floor))]]
        sizes.append((K, m))
        args.append((p, q, a["X0"], a["w"], sS, a["aD"], a["aL"], a["mask"],
                     a["gamma"], a["nsig"]))
    return _launch_grouped("projection_delta", "cfmm_project_delta",
                           "project_delta", ref, names, dims, sizes, args, cfg)[1]


def _one(grouped, kind, p, q, arrs, cfg):
    """One bucket through a grouped projection (a group of one)."""
    group = dict(names=["bucket"], kinds=[kind])
    return grouped({"bucket": (p, q)}, {"bucket": arrs}, group, cfg)["bucket"]


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
    arrs = dict(X0=X0, w=w, sS=sS, gamma=gamma, nsig=nsig, aD=aD, aL=aL, mask=mask)
    return _one(project_delta_grouped, ("gm", bool(needs_floor)), p, q, arrs, cfg)


def project_cs_delta_cuda(
    p, q, X0, gamma, w, tgt, aD, aL, mask,
    cfg: ProjectionConfig = ProjectionConfig(),
):
    """Project (p, q) onto shifted-scaled (weighted) constant-sum sets with
    the reserve floor (:func:`~.projection_delta.project_cs_delta`).
    Returns (a, b), (K, m)."""
    if p.device.type == "cpu":
        return project_cs_delta(p, q, X0, gamma, w, tgt, aD, aL, mask, cfg=cfg)
    arrs = dict(X0=X0, w=w, gamma=gamma, nsig=tgt, aD=aD, aL=aL, mask=mask)
    return _one(project_delta_grouped, ("cs", True), p, q, arrs, cfg)
