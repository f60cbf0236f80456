"""Seconds per certified route over the window."""
from portbench.e2e.common import per_certified


def read(run):
    return per_certified(run)
