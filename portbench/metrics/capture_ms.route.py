"""CUDA-graph captures inside a route: the median over the traced routes
of the program's ``graphs.capture`` spans (each with its eager warm-up
step), summed, in ms.  A route builds new solvers, so each captures anew."""
from portbench.metrics.program import total_ms


def read(run):
    return total_ms(run, "graphs.capture")
