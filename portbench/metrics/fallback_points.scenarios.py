"""Reserve states that the folded refinement left short and the program
finished one by one: the median over the traced requests of the
program's ``scenarios.fallback`` counter.  Nothing to read from a program
that does not count its states (no ``scenarios.points``)."""
import statistics

from portbench.metrics.program import routes


def read(run):
    vals = [root.counts.get("scenarios.fallback", 0) for root, _ in routes(run)
            if root.counts and "scenarios.points" in root.counts]
    return statistics.median(vals) if vals else None
