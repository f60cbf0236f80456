"""Host set-up of the reserve states: the median over the traced requests
of the program's ``scenarios.reserves`` span (the states' folds built, the
folded base solver built or its kept arrays refreshed), in ms.  Nothing to
read from a program without the span."""
from portbench.metrics.program import routes, total_ms


def read(run):
    if not any(r.name == "scenarios.reserves" for _, tree in routes(run)
               for r in tree.values()):
        return None
    return total_ms(run, "scenarios.reserves")
