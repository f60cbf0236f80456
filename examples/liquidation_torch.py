"""Liquidation workload on the PyTorch/CUDA port: the counterpart of the
reference's ``python liquidation.py``.

Liquidates the basket [2, 1, 3, 5, 10] entirely into token 4 through the
5-pool / 5-asset demo network on the card, in float32 refined to a
certified gap of 1e-7, and prints the proceeds beside their pin (15.883010,
BASELINE.md).  Pass ``--cpu`` to run on the CPU.
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
from cfmm_routing_tpu_torch.models.reference_instances import liquidation_instance
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions

PIN = 15.883010


def main(device=None):
    spec, _ = liquidation_instance()
    route = api.liquidate(
        spec,
        holdings=[2, 1, 3, 5, 10],
        numeraire=4,
        refine_to=1e-7,
        options=AdmmOptions(max_iters=6000, eps_abs=2e-6, eps_rel=2e-6),
        device=device,
    )
    print(f"Liquidation proceeds (token 4): {route.psi[4]}  (BASELINE.md: {PIN})")
    print(f"Certificate:                    {route.certificate.summary()}")
    return {"objective": float(route.psi[4]), "pin": PIN,
            "certified": route.converged}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
