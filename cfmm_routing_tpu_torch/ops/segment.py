"""Deterministic consensus reduction: per-asset sums of the slot planes of a
bucket or a K-group of buckets, in a fixed order.

The CUDA kernel is ``csrc/segment_sum.cu``: the sorted slot order is cut into
fixed chunks of :data:`CHUNK` positions, one warp sums each asset's piece of
a chunk (lanes in stride order, then a fixed shuffle tree), and an asset
that spans chunks adds its pieces in chunk order.  It replaces the atomics
the card would otherwise use, so two runs give bitwise-equal iterates.
:func:`slot_order` builds its inputs once per bucket or K-group;
:func:`segment_sum_plain` repeats its order of additions in plain PyTorch,
and the wrapper :func:`segment_sum` runs that plain version on a CPU tensor
and the kernel on a CUDA tensor (or raises).
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from .projection_cuda import dtype_code

__all__ = ["slot_order", "segment_sum", "segment_sum_plain", "CHUNK"]

_LANES = 32
# positions of the sorted order per chunk: the kernel's compile-time C
# (kChunk in csrc/segment_sum.cu)
CHUNK = 64


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


def _strided_sums(flat, starts, counts):
    """The sum of each run flat[starts[i] : starts[i] + counts[i]] as a warp
    adds it: lane l adds the run's entries l, l + 32, ... in order from
    zero, then the lanes combine by halves (16, 8, 4, 2, 1)."""
    runs = starts.numel()
    owner = torch.repeat_interleave(torch.arange(runs, device=flat.device), counts)
    local = torch.arange(flat.numel(), device=flat.device) - starts[owner]
    steps = int(-(-int(counts.max()) // _LANES))
    dense = torch.zeros(runs, steps, _LANES, dtype=flat.dtype, device=flat.device)
    dense[owner, local // _LANES, local % _LANES] = flat
    acc = torch.zeros(runs, _LANES, dtype=flat.dtype, device=flat.device)
    for t in range(steps):
        acc = acc + dense[:, t]
    half = _LANES // 2
    while half >= 1:
        acc = acc[:, :half] + acc[:, half:2 * half]
        half //= 2
    return acc[:, 0]


def segment_sum_plain(vals, order, seg, n_out: int):
    """y[j] = sum of vals.reshape(-1)[order[seg[j]:seg[j+1]]], added as the
    kernel adds: asset j's run is cut at the multiples of :data:`CHUNK` into
    pieces, each piece summed as one warp sums it (:func:`_strided_sums`),
    and the pieces added in order, from the first.  Entries j >= n are 0."""
    n = seg.numel() - 1
    flat = vals.reshape(-1).index_select(0, order.long())
    out = torch.zeros(n_out, dtype=vals.dtype, device=vals.device)
    n_real = flat.numel()
    if n_real == 0:
        return out
    seg_l = seg.long()
    cuts = torch.arange(0, n_real, CHUNK, device=vals.device)
    bounds = torch.unique(torch.cat([seg_l, cuts]))  # sorted, ends at n_real
    starts, ends = bounds[:-1], bounds[1:]
    piece = _strided_sums(flat, starts, ends - starts)
    # the (non-empty) asset of every piece, and each piece's rank in its asset
    owner = torch.searchsorted(seg_l, starts, right=True) - 1
    per_asset = torch.bincount(owner, minlength=n)
    first = torch.cumsum(per_asset, 0) - per_asset
    rank = torch.arange(piece.numel(), device=vals.device) - first[owner]
    cols = int(per_asset.max())
    table = torch.zeros(n, cols, dtype=vals.dtype, device=vals.device)
    table[owner, rank] = piece
    acc = table[:, 0]
    for c in range(1, cols):
        acc = torch.where(per_asset > c, acc + table[:, c], acc)
    out[:n] = acc
    return out


def segment_sum(vals, order, seg, n_out: int):
    """Per-asset fixed-order sums of a (K, m) plane -> (n_out,) vector.

    ``order``/``seg``: int32 tensors from :func:`slot_order`, on the
    plane's device.  A CPU tensor runs :func:`segment_sum_plain`; a CUDA
    tensor launches the kernel (two passes on the current stream) or
    raises."""
    if vals.device.type == "cpu":
        return segment_sum_plain(vals, order, seg, n_out)
    n = seg.numel() - 1
    for t, label in ((order, "order"), (seg, "seg")):
        if (t.dtype != torch.int32 or t.device != vals.device
                or not t.is_contiguous() or t.dim() != 1):
            raise ValueError(f"segment_sum: {label} must be a contiguous int32 "
                             f"vector on {vals.device}")
    if not vals.is_contiguous() or n_out < n or n < 1:
        raise ValueError("segment_sum: vals must be contiguous and n_out >= n >= 1")
    n_real = order.numel()
    y = torch.empty(n_out, dtype=vals.dtype, device=vals.device)
    scratch = torch.empty(2 * (-(-n_real // CHUNK)), dtype=vals.dtype,
                          device=vals.device)
    lib = _build.library("segment_sum")
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        rc = lib.cfmm_segment_sum(
            dtype_code(vals.dtype), n, int(n_out), n_real,
            vals.data_ptr(), order.data_ptr(), seg.data_ptr(), y.data_ptr(),
            scratch.data_ptr(), stream,
        )
    _build.check_launch(rc, "segment_sum")
    _build.LAUNCHES["segment_sum"] += 1
    return y
