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
of ``ops/projection_delta.py``: the projection input is further offset by
the pre-broadcast base dual ``nu0e``, and the projection is the delta one;
the deferred-broadcast algebra is unchanged.  :func:`fused_step_delta_grouped`
runs it on a group of buckets with the same channel count K in one launch
(one lane per slot, a per-bucket descriptor table) and one segment sum over
the group's own slot order; :func:`fused_step_delta` is a group of one.

:func:`fused_step_merged` runs the base step on one merged K-group
(``AdmmSolver._merged_groups``): every bucket with the same channel count
K on one concatenated pool axis, (K, M) planes.  It is the grouped kernel
over one descriptor per class span of the group (a run of pools of one
kind, computed once on the host when the group is built): the span's
planes are the merged planes from its first pool on, with plane stride M.
One launch per K-group; the group carries its own fixed slot order for the
segment sum.

:func:`fused_step_grouped` runs the base step on a group of buckets with the
same channel count K in one launch (one lane per slot) and one segment sum
over the group's slot order; :func:`fused_step` is a group of one.

:func:`classic_step`, :func:`consensus` and :func:`classic_z` run the
classic iteration itself (``AdmmSolver._iterate`` without residual sums,
linear objective) in the replayed stats-free blocks of
``AdmmSolver._solve_impl``: one step launch per K-group (the previous
iteration's z update, the gather of nu, the grouped projection, the
relaxation and the consensus terms), the group's segment sum, and one
consensus launch (the linear prox and dm = nu - mu), rounding every value
as the torch ops they replace; ``classic_z`` materialises z at the end of a
block.  Their plain versions are those torch ops.

The CUDA kernels are ``csrc/fused_step.cu`` (``fused_step`` and
``fused_step_merged``), ``csrc/fused_step_delta.cu`` and
``csrc/classic_step.cu``.
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
from .projection_cuda import (
    _KIND, MAX_GROUP, _check_group, _check_like, _launch_grouped,
    check_cuda_args, dtype_code, group_outputs, launch_table,
    project_grouped_plain,
)
from .projection_delta import project_cs_delta, project_gm_delta
from .prox import psi_prox
from .segment import segment_sum, segment_sum_plain

__all__ = ["fused_step", "fused_step_plain", "fused_step_grouped",
           "fused_step_grouped_plain", "fused_step_delta",
           "fused_step_delta_plain", "fused_step_delta_grouped",
           "fused_step_delta_grouped_plain", "fused_step_merged",
           "fused_step_merged_plain", "class_spans", "classic_step",
           "classic_step_plain", "classic_z", "classic_z_plain", "consensus",
           "consensus_plain", "MAX_CONSENSUS_GROUPS"]

_CLASS_KIND = {code: kind for kind, code in _KIND.items()}  # 2 -> ("cs", False)


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


def _relax(sD, sL, A, B, alpha):
    """The relaxed state and the consensus-term plane, as the kernels form
    them: (sD', sL', val)."""
    a = float(alpha)
    b = 1.0 - a
    return a * A + b * sD, a * B + b * sL, a * (B - A) + b * (sL - sD)


def _update(sD, sL, A, B, v, arrs, alpha):
    """Relaxation and the consensus reduction, in the segment-sum kernel's
    fixed order (``segment_sum_plain``)."""
    sDn, sLn, val = _relax(sD, sL, A, B, alpha)
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


def _project_plain(sD, sL, v, arrs, kind, needs_floor, cfg, fold):
    """The plain gather and projection of one bucket: (D, L)."""
    K, m = sD.shape
    ve = _gather(v, arrs, K, m, fold)
    p = sD + ve
    q = sL - ve
    if kind == "gm":
        return project_gm(
            p, q, arrs["R"], arrs["w"], arrs["s"], arrs["gamma"],
            arrs["logk0"], arrs["k0"], arrs["mask"], needs_floor=needs_floor,
            cfg=cfg,
        )
    return project_cs(
        p, q, arrs["R"], arrs["gamma"], arrs["w"], arrs["k0"], arrs["mask"],
        cfg=cfg,
    )


def fused_step_plain(sD, sL, v, arrs, kind, needs_floor, alpha: float,
                     cfg: ProjectionConfig = ProjectionConfig(), fold=None):
    """The fused half-iteration of one bucket in plain PyTorch, on any
    device, with the bucket's own segment sum.

    Returns (sD', sL', D, L, y(n_pad,))."""
    if fold is not None:
        fold = _check_fold(sD.shape[1], v, fold, "fused_step")
    D, L = _project_plain(sD, sL, v, arrs, kind, needs_floor, cfg, fold)
    return _update(sD, sL, D, L, v, arrs, alpha)


def fused_step_grouped_plain(s, v, buckets, group, alpha: float,
                             cfg: ProjectionConfig = ProjectionConfig(),
                             fold=None):
    """The plain version of :func:`fused_step_grouped`, on any device: each
    bucket's plain gather, projection and relaxation (the planes equal
    :func:`fused_step_plain`'s bit for bit), then one segment sum over the
    group's consensus terms (the buckets' planes flattened one after
    another) in the group's slot order."""
    s_new, w_out, vals = {}, {}, []
    for name, (kind, floor) in zip(group["names"], group["kinds"]):
        sD, sL = s[name]
        f = None if fold is None else _check_fold(sD.shape[1], v, fold,
                                                  "fused_step")
        D, L = _project_plain(sD, sL, v, buckets[name], kind, floor, cfg, f)
        sDn, sLn, val = _relax(sD, sL, D, L, alpha)
        s_new[name] = (sDn, sLn)
        w_out[name] = (D, L)
        vals.append(val.reshape(-1))
    y = segment_sum_plain(torch.cat(vals), group["order"], group["seg"],
                          v.shape[0])
    return s_new, w_out, y


def _launch_group(kernel, ref, group, dims, sizes, args, v, alpha, cfg, fold):
    """The grouped launch of ``kernel`` ("fused_step" or "fused_step_delta":
    the library and its C entry ``cfmm_<kernel>``) from the validated
    per-bucket ``dims`` and input tensors ``args`` (None for a null
    pointer), then the group's segment sum.  Returns (s', w, y) as the
    grouped wrappers do."""
    names = group["names"]
    out, views = group_outputs(ref, sizes, 5)  # sD' sL' (D, L | a, b) val
    ptrs = []
    for ins, outs in zip(args, views):
        ptrs += [None if t is None else t.data_ptr() for t in ins]
        ptrs += [t.data_ptr() for t in outs]
    c_dims, c_ptrs = launch_table(dims, ptrs)
    a = float(alpha)
    n_pad = v.shape[0]
    entry = getattr(_build.library(kernel), f"cfmm_{kernel}")
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        rc = entry(dtype_code(ref.dtype), ref.shape[0], len(names), n_pad, a,
                   1.0 - a, c_dims, c_ptrs, v.data_ptr(), int(cfg.n_bisect),
                   int(cfg.n_polish), stream)
    _build.check_launch(rc, kernel)
    _build.LAUNCHES[kernel if fold is None else f"{kernel}_fold"] += 1
    y = segment_sum(out[4], group["order"], group["seg"], n_pad)
    return ({name: (o[0], o[1]) for name, o in zip(names, views)},
            {name: (o[2], o[3]) for name, o in zip(names, views)}, y)


def fused_step_grouped(s, v, buckets, group, alpha: float,
                       cfg: ProjectionConfig = ProjectionConfig(), fold=None):
    """One fused half-iteration for a group of buckets with the same slot
    count K, in one launch (``csrc/fused_step.cu``, one lane per slot up to
    K = 32), and one segment sum over the group's slot order.

    s: bucket name -> (sD, sL) (K, m) state planes;  v: (n_pad,) combined
    broadcast vector (wdef - nu, zero-padded);  buckets: name -> the
    solver's device bucket dict (R w s mask asset gamma logk0 k0);  group:
    ``names`` (at most ``MAX_GROUP``), ``kinds`` ((kind, needs_floor) per
    name) and the group's slot order ``order``/``seg`` over the buckets'
    planes flattened one after another (``AdmmSolver._groups``);  fold:
    (T, n_pt) of a scenario fold (module docstring).  Returns (s', w, y):
    name -> (sD', sL'), name -> (D, L), and y (n_pad,).  CPU tensors run
    :func:`fused_step_grouped_plain`."""
    names = group["names"]
    ref = s[names[0]][0]
    if fold is not None:
        for name in names:
            fold = _check_fold(s[name][0].shape[1], v, fold, "fused_step")
    if ref.device.type == "cpu":
        return fused_step_grouped_plain(s, v, buckets, group, alpha, cfg, fold)
    _check_group(group, "fused_step")
    dims, sizes, args = [], [], []
    for name, (kind, floor) in zip(names, group["kinds"]):
        sD, sL = s[name]
        arrs = buckets[name]
        planes = (sD, sL, arrs["R"], arrs["w"], arrs["s"], arrs["mask"])
        K, m = check_cuda_args(planes, (arrs["gamma"], arrs["logk0"],
                                        arrs["k0"]), "fused_step")
        _check_like(sD, ref, "fused_step")
        _check_ids_and_v(sD, v, arrs, "fused_step")
        dims += [m, _KIND[(kind, bool(floor))], *_fold_args(m, fold), m]
        sizes.append((K, m))
        args.append((sD, sL, arrs["asset"], arrs["R"], arrs["w"], arrs["s"],
                     arrs["mask"], arrs["gamma"], arrs["logk0"], arrs["k0"]))
    return _launch_group("fused_step", ref, group, dims, sizes, args, v, alpha,
                         cfg, fold)


def fused_step(sD, sL, v, arrs, kind, needs_floor, alpha: float,
               cfg: ProjectionConfig = ProjectionConfig(), fold=None):
    """One fused half-iteration for one bucket: :func:`fused_step_grouped`
    on a group of one, whose slot order is the bucket's own
    (``arrs["order"]``/``arrs["seg"]``).

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
    group = dict(names=["bucket"], kinds=[(kind, needs_floor)],
                 order=arrs["order"], seg=arrs["seg"])
    s_new, w, y = fused_step_grouped({"bucket": (sD, sL)}, v, {"bucket": arrs},
                                     group, alpha, cfg, fold)
    return (*s_new["bucket"], *w["bucket"], y)


def class_spans(cls):
    """[(start_pool, stop_pool, kind, needs_floor)] of the runs of equal
    class in a merged group's per-128-pool-block class table ``cls`` (a
    host sequence of ints: 0 gm, 1 floored gm, 2 cs)."""
    codes = [int(x) for x in cls]
    spans = []
    start = 0
    for i in range(1, len(codes) + 1):
        if i == len(codes) or codes[i] != codes[start]:
            spans.append((128 * start, 128 * i) + _CLASS_KIND[codes[start]])
            start = i
    return spans


def _check_spans(g, m, what):
    """The merged group's class spans, or raise unless they tile [0, m) in
    order, each starting at a multiple of 128 pools."""
    spans = g["spans"]
    stops = [0] + [b for _, b, _, _ in spans]
    if (not spans or stops[-1] != m
            or any(a != prev or a % 128 != 0 or b <= a
                   for (a, b, _, _), prev in zip(spans, stops))):
        raise ValueError(f"{what}: the class spans {spans} do not tile the "
                         f"group's {m} pools from multiples of 128")
    return spans


def fused_step_merged_plain(sD, sL, v, g, alpha: float,
                            cfg: ProjectionConfig = ProjectionConfig()):
    """The merged fused half-iteration in plain PyTorch, on any device: the
    gather, the plain projection of each class span, and the update with the
    group's fixed-order segment sum.  Returns (sD', sL', D, L,
    y(n_pad,))."""
    K, m = sD.shape
    ve = _gather(v, g, K, m)
    p = sD + ve
    q = sL - ve
    Ds, Ls = [], []
    for a, b, kind, floor in _check_spans(g, m, "fused_step_merged"):
        sl = {k: g[k][..., a:b] for k in ("R", "w", "s", "mask", "gamma",
                                           "logk0", "k0")}
        if kind == "gm":
            D, L = project_gm(
                p[:, a:b], q[:, a:b], sl["R"], sl["w"], sl["s"], sl["gamma"],
                sl["logk0"], sl["k0"], sl["mask"], needs_floor=floor, cfg=cfg,
            )
        else:
            D, L = project_cs(p[:, a:b], q[:, a:b], sl["R"], sl["gamma"],
                              sl["w"], sl["k0"], sl["mask"], cfg=cfg)
        Ds.append(D)
        Ls.append(L)
    return _update(sD, sL, torch.cat(Ds, dim=1), torch.cat(Ls, dim=1), v, g, alpha)


def fused_step_merged(sD, sL, v, g, alpha: float,
                      cfg: ProjectionConfig = ProjectionConfig()):
    """One fused half-iteration for one merged K-group: one launch of the
    grouped kernel over the group's class spans (module docstring), and one
    segment sum.

    sD/sL: (K, M) merged state planes;  v: (n_pad,) combined broadcast
    vector;  g: the group's arrays from ``AdmmSolver._merged_groups``
    (concatenated planes, the class spans ``spans``, at most
    ``MAX_GROUP``, the group's slot order).  Returns (sD', sL', D, L,
    y(n_pad,))."""
    if sD.device.type == "cpu":
        return fused_step_merged_plain(sD, sL, v, g, alpha, cfg)
    planes = (sD, sL, g["R"], g["w"], g["s"], g["mask"])
    K, m = check_cuda_args(planes, (g["gamma"], g["logk0"], g["k0"]),
                           "fused_step_merged")
    _check_ids_and_v(sD, v, g, "fused_step_merged")
    spans = _check_spans(g, m, "fused_step_merged")
    if len(spans) > MAX_GROUP:
        raise ValueError(f"fused_step_merged: {len(spans)} class spans, more "
                         f"than the kernel's table of {MAX_GROUP}")
    n_pad = v.shape[0]
    out = torch.empty((5, K, m), dtype=sD.dtype, device=sD.device)
    ins = (sD, sL, g["asset"], g["R"], g["w"], g["s"], g["mask"], g["gamma"],
           g["logk0"], g["k0"])
    c_spans, c_ptrs = launch_table(
        [x for a, b, kind, floor in spans for x in (a, b, _KIND[(kind, floor)])],
        [t.data_ptr() for t in ins] + [o.data_ptr() for o in out])
    a = float(alpha)
    entry = _build.library("fused_step").cfmm_fused_step_merged
    with torch.cuda.device(sD.device):
        stream = torch.cuda.current_stream(sD.device).cuda_stream
        rc = entry(dtype_code(sD.dtype), K, m, len(spans), n_pad, a, 1.0 - a,
                   c_spans, c_ptrs, v.data_ptr(), int(cfg.n_bisect),
                   int(cfg.n_polish), stream)
    _build.check_launch(rc, "fused_step_merged")
    _build.LAUNCHES["fused_step_merged"] += 1
    y = segment_sum(out[4], g["order"], g["seg"], n_pad)
    return out[0], out[1], out[2], out[3], y


def _fold_args(m, fold):
    """The C launchers' (fold_m, fold_n): pools and prices per point, or
    (0, 0) unfolded."""
    return (0, 0) if fold is None else (m // fold[0], fold[1])


def _nu0e(arrs):
    nu0e = arrs.get("nu0e")
    return torch.zeros_like(arrs["mask"]) if nu0e is None else nu0e


def _delta_project_plain(sD, sL, v, arrs, kind, needs_floor, cfg, fold):
    """The plain gather and delta projection of one bucket: (a, b)."""
    K, m = sD.shape
    off = _gather(v, arrs, K, m, fold) - _nu0e(arrs)
    p = sD + off
    q = sL - off
    if kind == "gm":
        return project_gm_delta(
            p, q, arrs["X0"], arrs["w"], arrs["sS"], arrs["gamma"],
            arrs["nsig"], arrs["aD"], arrs["aL"], arrs["mask"],
            needs_floor=needs_floor, cfg=cfg,
        )
    return project_cs_delta(
        p, q, arrs["X0"], arrs["gamma"], arrs["w"], arrs["nsig"],
        arrs["aD"], arrs["aL"], arrs["mask"], cfg=cfg,
    )


def fused_step_delta_plain(sD, sL, v, arrs, kind, needs_floor, alpha: float,
                           cfg: ProjectionConfig = ProjectionConfig(), fold=None):
    """The fused delta half-iteration in plain PyTorch, on any device.

    Returns (sD', sL', a, b, y(n_pad,))."""
    if fold is not None:
        fold = _check_fold(sD.shape[1], v, fold, "fused_step_delta")
    A, B = _delta_project_plain(sD, sL, v, arrs, kind, needs_floor, cfg, fold)
    return _update(sD, sL, A, B, v, arrs, alpha)


def fused_step_delta_grouped_plain(s, v, buckets, group, alpha: float,
                                   cfg: ProjectionConfig = ProjectionConfig(),
                                   fold=None):
    """The plain version of :func:`fused_step_delta_grouped`, on any device:
    each bucket's plain gather, delta projection and relaxation, then one
    segment sum over the group's consensus terms (the buckets' planes
    flattened one after another) in the group's slot order."""
    s_new, w_out, vals = {}, {}, []
    for name, (kind, floor) in zip(group["names"], group["kinds"]):
        sD, sL = s[name]
        f = None if fold is None else _check_fold(sD.shape[1], v, fold,
                                                  "fused_step_delta")
        A, B = _delta_project_plain(sD, sL, v, buckets[name], kind, floor, cfg, f)
        sDn, sLn, val = _relax(sD, sL, A, B, alpha)
        s_new[name] = (sDn, sLn)
        w_out[name] = (A, B)
        vals.append(val.reshape(-1))
    y = segment_sum_plain(torch.cat(vals), group["order"], group["seg"],
                          v.shape[0])
    return s_new, w_out, y


def fused_step_delta_grouped(s, v, buckets, group, alpha: float,
                             cfg: ProjectionConfig = ProjectionConfig(),
                             fold=None):
    """One fused half-iteration for a group of DELTA buckets with the same
    slot count K, in one launch (``csrc/fused_step_delta.cu``), and one
    segment sum.

    s: bucket name -> (sD, sL) (K, m) delta state planes;  v: (n_pad,)
    combined broadcast vector (wdef - dnu, zero-padded);  buckets: name ->
    delta bucket dict from ``DeltaAdmmSolver.delta_buckets``
    (X0/w/sS/aD/aL/mask/gamma/nsig and, on the re-centred path, the
    pre-broadcast base-dual plane nu0e);  group: ``names`` (at most
    ``MAX_GROUP``), ``kinds`` ((kind, needs_floor) per name; the
    constant-sum reserve floor always applies) and the group's slot order
    ``order``/``seg`` over the buckets' planes flattened one after another
    (``DeltaAdmmSolver._delta_groups``);  fold: (T, n_pt) of a scenario
    fold (module docstring).  Returns (s', w, y): name -> (sD', sL'),
    name -> (a, b), and y (n_pad,).  CPU tensors run
    :func:`fused_step_delta_grouped_plain`."""
    names = group["names"]
    ref = s[names[0]][0]
    if fold is not None:
        for name in names:
            fold = _check_fold(s[name][0].shape[1], v, fold, "fused_step_delta")
    if ref.device.type == "cpu":
        return fused_step_delta_grouped_plain(s, v, buckets, group, alpha, cfg,
                                              fold)
    _check_group(group, "fused_step_delta")
    dims, sizes, args = [], [], []
    for name, (kind, floor) in zip(names, group["kinds"]):
        sD, sL = s[name]
        arrs = buckets[name]
        nu0e = arrs.get("nu0e")
        planes = (sD, sL, arrs["X0"], arrs["w"], arrs["sS"], arrs["aD"],
                  arrs["aL"], arrs["mask"]) + (() if nu0e is None else (nu0e,))
        K, m = check_cuda_args(planes, (arrs["gamma"], arrs["nsig"]),
                               "fused_step_delta")
        _check_like(sD, ref, "fused_step_delta")
        _check_ids_and_v(sD, v, arrs, "fused_step_delta")
        dims += [m, _KIND[(kind, bool(floor))], *_fold_args(m, fold)]
        sizes.append((K, m))
        args.append((sD, sL, arrs["asset"], arrs["X0"], arrs["w"], arrs["sS"],
                     arrs["aD"], arrs["aL"], arrs["mask"], nu0e, arrs["gamma"],
                     arrs["nsig"]))
    return _launch_group("fused_step_delta", ref, group, dims, sizes, args, v,
                         alpha, cfg, fold)


def fused_step_delta(sD, sL, v, arrs, kind, needs_floor, alpha: float,
                     cfg: ProjectionConfig = ProjectionConfig(), fold=None):
    """One fused half-iteration for one DELTA bucket (refinement stage):
    :func:`fused_step_delta_grouped` on a group of one, whose slot order is
    the bucket's own (``arrs["order"]``/``arrs["seg"]``).

    sD/sL: (K, m) delta state planes;  v: (n_pad,) combined broadcast vector
    (wdef - dnu, zero-padded);  arrs: a delta bucket dict from
    ``DeltaAdmmSolver.delta_buckets``;  fold: (T, n_pt) of a scenario fold
    (module docstring).  Returns (sD', sL', a, b, y(n_pad,)).
    """
    if fold is not None:
        fold = _check_fold(sD.shape[1], v, fold, "fused_step_delta")
    if sD.device.type == "cpu":
        return fused_step_delta_plain(sD, sL, v, arrs, kind, needs_floor,
                                      alpha, cfg, fold)
    group = dict(names=["bucket"], kinds=[(kind, needs_floor)],
                 order=arrs["order"], seg=arrs["seg"])
    s_new, w, y = fused_step_delta_grouped({"bucket": (sD, sL)}, v,
                                           {"bucket": arrs}, group, alpha,
                                           cfg, fold)
    return (*s_new["bucket"], *w["bucket"], y)


# ---- the classic iteration's stats-free step (csrc/classic_step.cu) --------

MAX_CONSENSUS_GROUPS = 32  # K-groups per consensus launch (the kernel's table)


def classic_step_plain(src, nu, dm, buckets, group, alpha: float, beta: float,
                       cfg: ProjectionConfig = ProjectionConfig()):
    """The plain version of :func:`classic_step`, on any device: the torch
    ops of a stats-free ``AdmmSolver._iterate`` for one K-group, in its
    order, with the previous iteration's z update (``dm`` given) in front.
    Returns (h, vals) as :func:`classic_step` does."""
    inputs, zs = {}, {}
    for name in group["names"]:
        aD, aL = src[name]
        arrs = buckets[name]
        if dm is None:
            zD, zL = aD, aL
        else:
            dme = _gather(dm, arrs, *aD.shape)
            zD, zL = aD + dme, aL - dme
        nue = _gather(nu, arrs, *aD.shape)
        zs[name] = (zD, zL)
        inputs[name] = (zD - nue, zL + nue)
    proj = project_grouped_plain(inputs, buckets, group, cfg)
    h, vals = {}, []
    for name in group["names"]:
        (zD, zL), (D, L) = zs[name], proj[name]
        hD = alpha * D + beta * zD
        hL = alpha * L + beta * zL
        h[name] = (hD, hL)
        vals.append((hL - hD).reshape(-1))
    return h, torch.cat(vals)


def _check_vector(t, ref, n, what):
    if (t.dim() != 1 or t.shape[0] != n or t.dtype != ref.dtype
            or t.device != ref.device or not t.is_contiguous()):
        raise ValueError(f"{what}: asset vectors must be contiguous ({n},) "
                         f"tensors of dtype {ref.dtype} on {ref.device}")


def _check_asset(arrs, K, m, device, what):
    asset = arrs["asset"]
    if (asset.dtype != torch.int32 or asset.shape != (K, m)
            or not asset.is_contiguous() or asset.device != device):
        raise ValueError(f"{what}: asset ids must be a contiguous int32 "
                         f"(K, m) tensor on {device}")


def classic_step(src, nu, dm, buckets, group, alpha: float, beta: float,
                 cfg: ProjectionConfig = ProjectionConfig()):
    """One stats-free classic step for a group of buckets with the same slot
    count K, in one launch (``csrc/classic_step.cu``): the z update of the
    previous step, the gather of nu, the grouped projection, the relaxation
    and the consensus terms.

    src: bucket name -> (K, m) planes, z itself when ``dm`` is None (a
    block's first step), else the previous step's relaxed planes h, with
    z = h +- dm_e;  nu, dm: (n,) vectors;  buckets: name -> the solver's
    device bucket dict;  group: an ``AdmmSolver._groups`` entry;  alpha and
    beta = 1 - alpha: the relaxation's coefficients, each exact in the
    planes' dtype.  Returns (h, vals): name -> (hD, hL), and the group's
    consensus terms hL - hD, the buckets' planes flattened one after
    another (the group's segment-sum input).  CPU tensors run
    :func:`classic_step_plain`."""
    names = group["names"]
    ref = src[names[0]][0]
    if ref.device.type == "cpu":
        return classic_step_plain(src, nu, dm, buckets, group, alpha, beta, cfg)
    _check_group(group, "classic_step")
    n = nu.shape[0]
    for t in (nu,) if dm is None else (nu, dm):
        _check_vector(t, ref, n, "classic_step")
    dims, sizes, ins = [], [], []
    for name, (kind, floor) in zip(names, group["kinds"]):
        aD, aL = src[name]
        a = buckets[name]
        gm = kind == "gm"
        s, logk0 = (a["s"], a["logk0"]) if gm else (None, None)
        K, m = check_cuda_args(
            (aD, aL, a["R"], a["w"], a["mask"]) + ((s,) if gm else ()),
            (a["gamma"], a["k0"]) + ((logk0,) if gm else ()), "classic_step")
        _check_like(aD, ref, "classic_step")
        _check_asset(a, K, m, ref.device, "classic_step")
        dims += [m, _KIND[(kind, bool(floor))]]
        sizes.append((K, m))
        ins.append((aD, aL, a["asset"], a["R"], a["w"], s, a["mask"],
                    a["gamma"], logk0, a["k0"]))
    out, views = _launch_grouped(
        "classic_step", "cfmm_classic_step", "classic_step", ref, names, dims,
        sizes, ins, cfg, n_out=3,  # hD hL val
        extra=(n, int(dm is not None), float(alpha), float(beta), nu.data_ptr(),
               None if dm is None else dm.data_ptr()))
    return {name: o[:2] for name, o in views.items()}, out[2]


def classic_z_plain(h, dm, buckets, group):
    """The plain version of :func:`classic_z`, on any device."""
    out = {}
    for name in group["names"]:
        hD, hL = h[name]
        dme = _gather(dm, buckets[name], *hD.shape)
        out[name] = (hD + dme, hL - dme)
    return out


def classic_z(h, dm, buckets, group):
    """The z update that ends a block of :func:`classic_step` calls, for one
    K-group in one launch: name -> (hD + dm_e, hL - dm_e).  CPU tensors run
    :func:`classic_z_plain`."""
    names = group["names"]
    ref = h[names[0]][0]
    if ref.device.type == "cpu":
        return classic_z_plain(h, dm, buckets, group)
    _check_group(group, "classic_z")
    _check_vector(dm, ref, dm.shape[0], "classic_z")
    dims, sizes, ins = [], [], []
    for name in names:
        hD, hL = h[name]
        a = buckets[name]
        K, m = check_cuda_args((hD, hL, a["mask"]), (), "classic_z")
        _check_like(hD, ref, "classic_z")
        _check_asset(a, K, m, ref.device, "classic_z")
        dims.append(m)
        sizes.append((K, m))
        ins.append((hD, hL, a["asset"], a["mask"]))
    return _launch_grouped("classic_step", "cfmm_classic_z", "classic_z", ref,
                           names, dims, sizes, ins, extra=(dm.data_ptr(),))[1]


def consensus_plain(ys, degree, nu, c, lo, hi, rho):
    """The plain version of :func:`consensus`, on any device: the groups'
    sums added in group order, then the linear prox of ``AdmmSolver``'s
    classic iteration (``ops/prox.py``'s ``psi_prox``)."""
    y = ys[0]
    for yg in ys[1:]:
        y = y + yg
    _, mu = psi_prox(y - 2.0 * degree * nu, degree, c, lo, hi, rho)
    return mu, nu - mu


def consensus(ys, degree, nu, c, lo, hi, rho):
    """The consensus of one stats-free classic step with a linear objective,
    in one launch (``csrc/classic_step.cu``): y = the K-groups' segment
    sums ``ys`` added in group order, s = y - 2 d nu, the linear prox's mu
    (``psi_prox``), and dm = nu - mu.

    ys: at most :data:`MAX_CONSENSUS_GROUPS` (n,) vectors;  degree, nu, c,
    lo, hi: (n,);  rho: the penalty, a one-element tensor.  Returns (mu,
    dm).  CPU tensors run :func:`consensus_plain`."""
    if nu.device.type == "cpu":
        return consensus_plain(ys, degree, nu, c, lo, hi, rho)
    if not 1 <= len(ys) <= MAX_CONSENSUS_GROUPS:
        raise ValueError(f"consensus: 1 to {MAX_CONSENSUS_GROUPS} group sums, "
                         f"not {len(ys)}")
    n = nu.shape[0]
    for t in (*ys, degree, nu, c, lo, hi):
        _check_vector(t, nu, n, "consensus")
    if (rho.numel() != 1 or rho.dtype != nu.dtype or rho.device != nu.device
            or not rho.is_contiguous()):
        raise ValueError("consensus: rho must be a one-element tensor of the "
                         "vectors' dtype and device")
    out = torch.empty((2, n), dtype=nu.dtype, device=nu.device)
    _, c_ys = launch_table([], [y.data_ptr() for y in ys])
    _, c_vecs = launch_table([], [t.data_ptr() for t in (
        degree, nu, c, lo, hi, rho, out[0], out[1])])
    entry = _build.library("classic_step").cfmm_consensus
    with torch.cuda.device(nu.device):
        stream = torch.cuda.current_stream(nu.device).cuda_stream
        rc = entry(dtype_code(nu.dtype), len(ys), n, c_ys, c_vecs, stream)
    _build.check_launch(rc, "consensus")
    _build.LAUNCHES["consensus"] += 1
    return out[0], out[1]
