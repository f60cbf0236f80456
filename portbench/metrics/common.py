"""What the per-layer readers share."""
from __future__ import annotations

import statistics


def span_median_ms(run, lead: bool) -> float | None:
    """Median over the traced requests of the host time before the first
    device activity (``lead``) or after the last one, in ms."""
    vals = []
    for sp in run.trace.spans:
        if sp["first_device"] is None:
            continue
        if lead:
            vals.append(sp["first_device"] - sp["start"])
        else:
            vals.append(sp["end"] - sp["last_device"])
    return statistics.median(vals) / 1e6 if vals else None


def idle_percent(run) -> float | None:
    """100 x (1 - device busy / traced window)."""
    tr = run.trace
    if tr.window_ns <= 0 or tr.busy_ns <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_ns / tr.window_ns)
