"""The yardstick of the kernels: peaks of the card and the least work a
kernel launch has to do, counted over the real slots of the network.

Peaks: NVIDIA's data sheet for the H100 SXM (dense, at its 700 W limit):
67 TFLOP/s in float32 and 34 TFLOP/s in float64 on the CUDA cores, 3.35 TB/s
of HBM.  A launch's bound is the larger of its operations over the peak
rate and its bytes over the bandwidth; its roofline share is the bound over
the time the trace measured for it.

Work is counted as the repository's kernel table counts it (each input
read once, each output written once; 60 flops per slot per root-find step
of the base projection), but over the real
slots of the generated table, never over the padded shapes a compile
chooses.  A grouped kernel's name carries its lanes per pool (a power of
two >= the slot count K of its group); a pool of width w belongs to the
launch variant with the fewest lanes >= w among those the trace saw.
"""
from __future__ import annotations

import re

import numpy as np

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float": 67e12, "double": 34e12}
ELEMENT_BYTES = {"float": 4, "double": 8}
# the root-find steps (n_bisect + n_polish) the yardstick assumes: the
# caller's ProjectionConfig(24, 4) of the route traffic
BASE_STEPS = 24 + 4


def variant(name: str, kernel: str):
    """(dtype, lanes) of a ``kernel<dtype, lanes>`` device operation, or
    None when ``name`` is another operation."""
    m = re.search(kernel + r"<(float|double), (\d+)>", name)
    return (m.group(1), int(m.group(2))) if m else None


def pools_by_lanes(net: dict, lanes_seen) -> dict:
    """lanes -> (widths of its geometric-mean pools, of its constant-sum
    pools), each pool in the variant with the fewest lanes >= its width."""
    lanes = sorted(set(lanes_seen))
    width = np.asarray(net["width"])
    cs = np.asarray(net["kind"]) == 1
    out = {}
    for i, L in enumerate(lanes):
        lo = lanes[i - 1] if i else 0
        sel = (width > lo) & (width <= L) if L > 0 else width > lo
        out[L] = (width[sel & ~cs], width[sel & cs])
    return out


def bound_s(bytes_: float, flops: float, dtype: str) -> float:
    return max(bytes_ / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def project_bound_s(gm_widths, cs_widths, dtype: str, steps: int = BASE_STEPS) -> float:
    """One launch of the grouped base projection over these pools: per
    geometric-mean pool p q R w s mask and gamma logk0 k0 in, D L out; per
    constant-sum pool p q R w mask and gamma k0 in, D L out."""
    es = ELEMENT_BYTES[dtype]
    bytes_ = es * (8 * gm_widths.sum() + 3 * len(gm_widths)
                   + 7 * cs_widths.sum() + 2 * len(cs_widths))
    flops = 60 * steps * (gm_widths.sum() + cs_widths.sum())
    return bound_s(float(bytes_), float(flops), dtype)


def share(trace, net: dict, kernel: str, launch_bound) -> float | None:
    """Percent of the measured time of ``kernel``'s launches that their
    bounds account for; None when the trace holds no such launch.
    ``launch_bound(gm_widths, cs_widths, dtype)`` is one launch's bound."""
    found = {}
    for name, (count, ns) in trace.kernels.items():
        v = variant(name, kernel)
        if v is not None:
            c, t = found.get(v, (0, 0))
            found[v] = (c + count, t + ns)
    if not found:
        return None
    groups = pools_by_lanes(net, [lanes for _, lanes in found])
    bound = measured = 0.0
    for (dtype, lanes), (count, ns) in found.items():
        gm, cs = groups[lanes]
        bound += count * launch_bound(gm, cs, dtype)
        measured += ns / 1e9
    return 100.0 * bound / measured if measured > 0 else None
