"""Frozen generators of the benchmark: networks and requests."""
