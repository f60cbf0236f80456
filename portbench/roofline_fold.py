"""The yardstick of the fused kernels on a scenario fold: the least work a
launch of ``fused_step(fold=)`` (``csrc/fused_step.cu``, ``grouped_kernel``)
or ``fused_step_delta(fold=)`` (``csrc/fused_step_delta.cu``,
``fused_delta_kernel``) has to do, over the real slots of the network times
the fold's points, against the peaks of ``roofline.py``.

Counted as the repository's kernel table counts the fold rows: each input
read once and each output written once (per slot the state planes, the
bucket's planes and, for the delta step, its delta planes; the new state,
the trades and the consensus term written; the int32 asset id; per pool
the fee and the invariants; the fold's price vector once a launch), and 60
flops per slot per root-find step of the base step, 80 of the delta step.
A launch covers one K-group of every point; a pool belongs to the launch
variant with the fewest lanes >= its width (``roofline.pools_by_lanes``).
"""
from __future__ import annotations

from portbench import roofline

KERNELS = {False: "grouped_kernel", True: "fused_delta_kernel"}


def fold_bound_s(gm_widths, cs_widths, dtype: str, points: int, n_assets: int,
                 steps: int, delta: bool) -> float:
    """One launch over these pools in each of ``points`` points."""
    es = roofline.ELEMENT_BYTES[dtype]
    planes = (9 if delta else 6) + 5  # sD sL + (X0 w sS aD aL mask nu0e | R w s mask); 5 out
    vectors = 2 if delta else 3  # gamma nsig | gamma logk0 k0
    slots = float(gm_widths.sum() + cs_widths.sum())
    pools = float(len(gm_widths) + len(cs_widths))
    bytes_ = points * (es * (planes * slots + vectors * pools) + 4 * slots) \
        + es * points * n_assets
    flops = points * (80 if delta else 60) * steps * slots
    return roofline.bound_s(bytes_, flops, dtype)


def share(run, delta: bool) -> float | None:
    """Percent of the measured time of the traced fold launches of the base
    (``delta`` false) or the delta step that their bounds account for; None
    when the trace holds none.  The points and the root-find steps are the
    traffic mix's (``scenarios``, ``options.projection``: the refinement
    runs the caller's projection too)."""
    if run.trace is None:
        return None
    points = int(run.traffic["scenarios"])
    steps = int(sum(run.traffic["options"]["projection"]))
    n = int(run.net["n_assets"])
    return roofline.share(
        run.trace, run.net, KERNELS[delta],
        lambda gm, cs, dtype: fold_bound_s(gm, cs, dtype, points, n, steps, delta))
