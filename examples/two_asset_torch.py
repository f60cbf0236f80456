"""Trade-size sweep on the PyTorch/CUDA port: the counterpart of the
reference's ``python two-asset.py``.

Solves the price-impact frontier u(t) of the two-asset network at 11
input amounts t = 0, 5, ..., 50 as one batched solve on the card, in
float32, each point refined to a certified gap of 1e-6, and prints u(t)
with the pins of BASELINE.md at t = 0, 10, 25 and 50.  The network is
compiled with its buckets padded to 128 pools, so that on the card the
whole grid's refinement runs folded on the fused delta kernel.

    python examples/two_asset_torch.py [--cpu] [--plots DIR]

``--plots DIR`` also writes the reference's two figures (per-pool net
flows, the utility frontier) there; it needs matplotlib.
"""
try:  # prefer the installed package (pip install -e .)
    import cfmm_routing_tpu_torch  # noqa: F401
except ImportError:  # running straight from a source checkout
    import os
    import sys

    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )

import argparse
import os

import numpy as np

from cfmm_routing_tpu_torch import api
from cfmm_routing_tpu_torch.models.reference_instances import two_asset_instance
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions
from cfmm_routing_tpu_torch.solver.compiler import compile_spec

PINS = {0.0: 6.233000, 10.0: 16.388196, 25.0: 31.005495, 50.0: 44.182020}


def main(device=None, plots=None):
    spec, _ = two_asset_instance()
    amounts = np.linspace(0.0, 50.0, 11)
    solver = api.make_solver_compiled(
        compile_spec(spec, pad_pools_to=128),
        options=AdmmOptions(max_iters=8000, eps_abs=2e-6, eps_rel=2e-6),
        device=device,
    )
    sw = api.sweep(spec, give=0, receive=2, amounts=amounts, solver=solver,
                   refine_to=1e-6)
    for t, u in zip(sw.amounts, sw.utilities):
        pin = PINS.get(float(t))
        note = f"  (BASELINE.md: {pin})" if pin is not None else ""
        print(f"t={t:8.3f}  u(t)={u:.6f}{note}")
    if plots:
        from cfmm_routing_tpu_torch.utils.plotting import save_sweep_figures

        os.makedirs(plots, exist_ok=True)
        f1, f2 = os.path.join(plots, "all_plot.pdf"), os.path.join(plots, "u_plot.pdf")
        save_sweep_figures(sw, f1, f2)
        print(f"wrote {f1} and {f2}")
    got = {float(t): float(u) for t, u in zip(sw.amounts, sw.utilities)}
    return {"utilities": {t: got[t] for t in PINS}, "pins": PINS,
            "certified": bool(np.all(sw.converged))}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--plots", help="directory for all_plot.pdf / u_plot.pdf")
    args = ap.parse_args()
    main("cpu" if args.cpu else None, args.plots)
