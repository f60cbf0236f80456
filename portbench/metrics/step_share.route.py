"""Share of a route's base-solve iterations that ran as the classic step
kernels: 100 x the program's ``iters.step`` counter over its ``iters.base``
counter, each the median over the traced routes.  ``iters.step`` counts the
stats-free iterations of a replayed block (24 of every 25 at a check every
25); a program without the kernels reads 0.  None where no traced route ran
a base iteration."""
from portbench.metrics.program import counter


def read(run):
    base = counter(run, "iters.base")
    if not base:
        return None
    return 100.0 * counter(run, "iters.step") / base
