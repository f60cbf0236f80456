"""The device's idle share over the traced routes, in percent."""
from portbench.metrics.common import idle_percent


def read(run):
    return idle_percent(run)
