"""The host blocked on the card inside a route: the median over the
traced routes of the program's ``host.sync`` spans (every device-to-host
read, and the stopping tests' reads), summed, in ms."""
from portbench.metrics.program import total_ms


def read(run):
    return total_ms(run, "host.sync")
