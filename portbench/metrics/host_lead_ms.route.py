"""Host set-up of a route: the median over the traced routes of the time
from ``api.route``'s call to the route's first device activity
(equilibration, compiles, the packer, the solver's arrays), in ms."""
from portbench.metrics.common import span_median_ms


def read(run):
    return span_median_ms(run, lead=True)
