"""Benchmark of the PyTorch and CUDA port ``cfmm_routing_tpu_torch``.

Run one cell with ``python3 -m portbench.run --workload NAME --seed N
--seconds S --trace 0|1`` from the root of a checkout; see README.md.
"""
