"""Base-solve iterations per route: the median over the traced routes of
the program's ``iters.base`` counter over the route."""
from portbench.metrics.program import counter


def read(run):
    return counter(run, "iters.base")
