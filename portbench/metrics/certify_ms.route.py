"""The certificates of a route: the median over the traced routes of the
program's ``certify`` spans (the float64 certificates with their eta
search on the card, and the price polish), summed, in ms."""
from portbench.metrics.program import total_ms


def read(run):
    return total_ms(run, "certify")
