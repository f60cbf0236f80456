"""The route's host tail: the median over the traced routes of the time
from its last device activity to ``api.route``'s return (the last float64
certificate on the host, the route's arrays), in ms."""
from portbench.metrics.common import span_median_ms


def read(run):
    return span_median_ms(run, lead=False)
