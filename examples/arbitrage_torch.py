"""Arbitrage workload on the PyTorch/CUDA port: the counterpart of the
reference's ``python arbitrage.py``.

Finds the profit-maximal zero-capital route through the 5-pool / 4-asset
demo network on the card, in float32 refined to a certified gap of 1e-7,
and prints the total output value beside its pin (21.499805, BASELINE.md).
Pass ``--cpu`` to run on the CPU.
"""
try:  # prefer the installed package (pip install -e .)
    import cfmm_routing_tpu_torch  # noqa: F401
except ImportError:  # running straight from a source checkout
    import os
    import sys

    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )

import sys

from cfmm_routing_tpu_torch import api
from cfmm_routing_tpu_torch.models.reference_instances import arbitrage_instance
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions

PIN = 21.499805


def main(device=None):
    spec, obj = arbitrage_instance()
    route = api.arbitrage(
        spec,
        obj.c,
        refine_to=1e-7,
        options=AdmmOptions(max_iters=6000, eps_abs=2e-6, eps_rel=2e-6),
        device=device,
    )
    print(f"Total output value: {route.objective}  (BASELINE.md: {PIN})")
    print(f"Net trade psi:      {route.psi}")
    print(f"Certificate:        {route.certificate.summary()}")
    return {"objective": route.objective, "pin": PIN,
            "certified": route.converged}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
