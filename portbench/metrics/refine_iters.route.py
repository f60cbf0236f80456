"""Refinement iterations per route: the median over the traced routes of
the program's ``iters.refine`` counter over the route (every correction
chunk, where ``Route.iters`` adds only the last)."""
from portbench.metrics.program import counter


def read(run):
    return counter(run, "iters.refine")
