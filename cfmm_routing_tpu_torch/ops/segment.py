"""Deterministic consensus reduction: per-asset sums of a bucket's slot plane
in a fixed order.

The CUDA kernel is ``csrc/segment_sum.cu`` (one warp per asset, lanes walk
the asset's sorted slots in stride order, a fixed shuffle tree combines
them); it replaces the atomics the card would otherwise use, so two runs
give bitwise-equal iterates.  :func:`slot_order` builds its inputs once per
bucket; :func:`segment_sum_plain` repeats its order of additions in plain
PyTorch, and the wrapper :func:`segment_sum` runs that plain version on a
CPU tensor and the kernel on a CUDA tensor (or raises).
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from .projection_cuda import dtype_code

__all__ = ["slot_order", "segment_sum", "segment_sum_plain"]

_LANES = 32


def slot_order(asset: np.ndarray, mask: np.ndarray, n: int):
    """(order, seg) for a slot-major (K, m) bucket: the flat indices of the
    real slots (mask > 0) stably sorted by asset id, and the (n + 1,) CSR
    offsets of each asset's run in that order.  Both int32 numpy arrays."""
    flat_asset = np.asarray(asset).reshape(-1)
    real = np.flatnonzero(np.asarray(mask).reshape(-1) > 0)
    order = real[np.argsort(flat_asset[real], kind="stable")]
    counts = np.bincount(flat_asset[order], minlength=n)[:n]
    seg = np.concatenate([[0], np.cumsum(counts)])
    return order.astype(np.int32), seg.astype(np.int32)


def segment_sum_plain(vals, order, seg, n_out: int):
    """y[j] = sum of vals.reshape(-1)[order[seg[j]:seg[j+1]]], added as the
    kernel adds: per lane l the slots l, l + 32, ... in order from zero,
    then lanes combined by halves (16, 8, 4, 2, 1).  Entries j >= n are 0."""
    n = seg.numel() - 1
    flat = vals.reshape(-1).index_select(0, order.long())
    counts = (seg[1:] - seg[:-1]).long()
    out = torch.zeros(n_out, dtype=vals.dtype, device=vals.device)
    if flat.numel() == 0:
        return out
    owner = torch.repeat_interleave(torch.arange(n, device=vals.device), counts)
    local = torch.arange(flat.numel(), device=vals.device) - seg.long()[owner]
    steps = int(-(-int(counts.max()) // _LANES))
    dense = torch.zeros(n, steps, _LANES, dtype=vals.dtype, device=vals.device)
    dense[owner, local // _LANES, local % _LANES] = flat
    acc = torch.zeros(n, _LANES, dtype=vals.dtype, device=vals.device)
    for t in range(steps):
        acc = acc + dense[:, t]
    half = _LANES // 2
    while half >= 1:
        acc = acc[:, :half] + acc[:, half:2 * half]
        half //= 2
    out[:n] = acc[:, 0]
    return out


def segment_sum(vals, order, seg, n_out: int):
    """Per-asset fixed-order sums of a (K, m) plane -> (n_out,) vector.

    ``order``/``seg``: int32 tensors from :func:`slot_order`, on the
    plane's device.  A CPU tensor runs :func:`segment_sum_plain`; a CUDA
    tensor launches the kernel or raises."""
    if vals.device.type == "cpu":
        return segment_sum_plain(vals, order, seg, n_out)
    n = seg.numel() - 1
    for t, label in ((order, "order"), (seg, "seg")):
        if (t.dtype != torch.int32 or t.device != vals.device
                or not t.is_contiguous() or t.dim() != 1):
            raise ValueError(f"segment_sum: {label} must be a contiguous int32 "
                             f"vector on {vals.device}")
    if not vals.is_contiguous() or n_out < n:
        raise ValueError("segment_sum: vals must be contiguous and n_out >= n")
    y = torch.empty(n_out, dtype=vals.dtype, device=vals.device)
    lib = _build.library("segment_sum")
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        rc = lib.cfmm_segment_sum(
            dtype_code(vals.dtype), n, int(n_out), vals.data_ptr(),
            order.data_ptr(), seg.data_ptr(), y.data_ptr(), stream,
        )
    _build.check_launch(rc, "segment_sum")
    _build.LAUNCHES["segment_sum"] += 1
    return y
