"""Session-wide settings for every test directory of the repo.

numpy and scipy's OpenBLAS starts one thread per core by default.  The
matrices in these tests are small (the scipy oracle's trust-constr and
SLSQP runs work on a few hundred variables), so extra threads only spin,
and under ``pytest -n 6`` every worker's threads contend for the same
cores.  One thread per process solves the same problems faster: the
oracle on ``random_arbitrage(10, 28, seed=31)`` with power atoms took
35 s on one thread against 255 s on eight, on an 8-core x86 CPU, with
the same objective to 1e-14.  An explicit ``OPENBLAS_NUM_THREADS`` in
the environment wins.

This file is loaded before ``tests/conftest.py`` imports numpy, and the
xdist workers inherit the variable.
"""
import os

os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")
