"""Host set-up inside a route: the median over the traced routes of the
program's ``route.equilibrate``, ``route.compile`` (both compiles of a
preconditioned route) and ``solver.build`` spans (the base solver and the
refinement's), summed, in ms."""
from portbench.metrics.program import total_ms


def read(run):
    return total_ms(run, "route.equilibrate", "route.compile", "solver.build")
