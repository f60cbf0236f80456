"""The residual checks of a route's solves: the median over the traced
routes of the self time of the program's ``admm.check`` spans (the eager
checked iteration, the residuals, the rho update, the stopping test; the
host's waits on the card, ``host.sync``, taken out), summed, in ms."""
from portbench.metrics.program import self_ms


def read(run):
    return self_ms(run, "admm.check")
