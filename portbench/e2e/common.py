"""What the end-to-end readers share."""
from __future__ import annotations


def per_certified(run) -> float | None:
    """The window's seconds over the requests completed and certified: a
    request that starts inside the window counts, and the window runs to
    its end."""
    n = sum(1 for r in run.requests if r["certified"])
    return run.window_s / n if n else None
