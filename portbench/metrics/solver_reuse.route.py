"""Solvers a route took from the program's own cache instead of building
them: the median over the traced routes of the program's
``solvers.reused`` counter.  A route after one on the same network takes
its base and its correction solver, so it reads 2; a program that keeps
no solvers reads 0."""
from portbench.metrics.program import counter


def read(run):
    return counter(run, "solvers.reused")
