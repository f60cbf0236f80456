"""Command-line driver:  python -m cfmm_routing_tpu_torch <command> ...

Any problem expressed as a JSON document (``utils/serde.py``, the JAX
package's schema) can be solved, certified, swept and plotted from the
shell, with the JAX package's commands, flags and output:

    python -m cfmm_routing_tpu_torch solve problem.json --certify
    python -m cfmm_routing_tpu_torch sweep problem.json --give 0 --receive 2 \\
        --t-max 50 --points 50 --plots output/
    python -m cfmm_routing_tpu_torch export-reference arbitrage > arb.json

Every command runs on the card in float32, and raises without one.
``--f64`` runs in float64 on the CPU, and the environment variable
``CFMM_FORCE_CPU`` (any non-empty value) runs on the CPU in the solve's
dtype.  :func:`main` returns the exit code, so it can be called in-process.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _device(args):
    """The CPU for ``--f64`` or ``CFMM_FORCE_CPU``, else the card."""
    if args.f64 or os.environ.get("CFMM_FORCE_CPU"):
        return "cpu"
    return None


def _make_solver(spec, args):
    import torch

    from .api import make_solver
    from .solver.admm import AdmmOptions

    opts = AdmmOptions(
        max_iters=args.max_iters, eps_abs=args.eps, eps_rel=args.eps
    )
    return make_solver(
        spec, dtype=torch.float64 if args.f64 else torch.float32,
        options=opts, device=_device(args),
    )


def _cmd_solve(args) -> int:
    from .api import _refined_route, _route_from
    from .utils.serde import load_problem

    spec, obj = load_problem(args.problem)
    if obj is None:
        print("error: problem file has no 'objective' section", file=sys.stderr)
        return 2
    solver = _make_solver(spec, args)
    if args.refine_to:
        route = _refined_route(
            solver, solver.compiled, obj, solver.solve(obj), args.refine_to
        )
    else:
        route = _route_from(solver, solver.solve(obj), obj, args.certify)
    out = {
        "objective": route.objective,
        "psi": route.psi.tolist(),
        "prices": route.prices.tolist(),
        "iters": route.iters,
        "converged": route.converged,
    }
    if route.certificate is not None:
        out["certificate"] = {
            "dual_bound": route.certificate.dual_bound,
            "rel_gap": route.certificate.gap_rel,
            "feasibility": route.certificate.feasibility,
        }
    if args.json:
        print(json.dumps(out))
    else:
        print(f"objective      {route.objective:.9g}")
        print(f"net trade psi  {np.array2string(route.psi, precision=6)}")
        print(f"iterations     {route.iters}  converged={route.converged}")
        if route.certificate is not None:
            print(f"certificate    {route.certificate.summary()}")
        if args.trades:
            for i, (D, L) in enumerate(zip(route.deltas, route.lambdas)):
                print(
                    f"pool {i:4d}  delta={np.array2string(D, precision=5)} "
                    f"lambda={np.array2string(L, precision=5)}"
                )
    return 0


def _cmd_sweep(args) -> int:
    from .api import sweep as run_sweep
    from .utils.serde import load_problem

    spec, _ = load_problem(args.problem)
    solver = _make_solver(spec, args)
    amounts = np.linspace(0.0, args.t_max, args.points)
    sw = run_sweep(spec, args.give, args.receive, amounts, solver=solver)
    if args.json:
        print(
            json.dumps(
                {
                    "amounts": sw.amounts.tolist(),
                    "utilities": sw.utilities.tolist(),
                    "converged": sw.converged.tolist(),
                }
            )
        )
    else:
        for t, u in zip(sw.amounts, sw.utilities):
            print(f"t={t:10.4f}  u(t)={u:.6f}")
    if args.plots:
        from .utils.plotting import save_sweep_figures

        os.makedirs(args.plots, exist_ok=True)
        f1 = os.path.join(args.plots, "all_plot.pdf")
        f2 = os.path.join(args.plots, "u_plot.pdf")
        save_sweep_figures(sw, f1, f2)
        print(f"wrote {f1} and {f2}", file=sys.stderr)
    return 0


def _cmd_export_reference(args) -> int:
    from .models import reference_instances as ri
    from .utils.serde import spec_to_json

    spec, obj = {
        "arbitrage": ri.arbitrage_instance,
        "liquidation": ri.liquidation_instance,
        "two-asset": ri.two_asset_instance,
    }[args.name]()
    doc = json.loads(spec_to_json(spec))
    if args.name == "arbitrage":
        doc["objective"] = {
            "workload": "arbitrage",
            "market_values": obj.c.tolist(),
        }
    elif args.name == "liquidation":
        doc["objective"] = {
            "workload": "liquidation",
            "numeraire": int(np.argmax(obj.c)),
            "holdings": [float(-l) if np.isfinite(l) else 0.0 for l in obj.lo],
        }
    else:  # two-asset: trade workload, holdings [t, 0, 0] at t=0
        doc["objective"] = {
            "workload": "trade",
            "receive": int(np.argmax(obj.c)),
            "holdings": [float(-l) if np.isfinite(l) else 0.0 for l in obj.lo],
        }
    print(json.dumps(doc, indent=2))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cfmm_routing_tpu_torch")
    sub = ap.add_subparsers(dest="command", required=True)

    def common(p):
        p.add_argument("problem", help="JSON problem file (utils/serde.py schema)")
        p.add_argument("--f64", action="store_true", help="certification-grade f64 on CPU")
        p.add_argument("--max-iters", type=int, default=20000)
        p.add_argument("--eps", type=float, default=1e-7)
        p.add_argument("--json", action="store_true", help="machine-readable output")

    ps = sub.add_parser("solve", help="solve the problem file's objective")
    common(ps)
    ps.add_argument("--certify", action="store_true", help="f64 optimality certificate")
    ps.add_argument(
        "--refine-to", type=float, default=None, dest="refine_to",
        help="device-resident refinement to this certified relative gap "
        "(e.g. 1e-6); implies a certificate",
    )
    ps.add_argument("--trades", action="store_true", help="print per-pool trades")
    ps.set_defaults(fn=_cmd_solve)

    pw = sub.add_parser("sweep", help="trade-size sweep (price-impact frontier)")
    common(pw)
    pw.add_argument("--give", type=int, required=True, help="asset tendered")
    pw.add_argument("--receive", type=int, required=True, help="asset received")
    pw.add_argument("--t-max", type=float, default=50.0)
    pw.add_argument("--points", type=int, default=50)
    pw.add_argument("--plots", help="directory for all_plot.pdf / u_plot.pdf")
    pw.set_defaults(fn=_cmd_sweep)

    pe = sub.add_parser(
        "export-reference", help="print a reference instance as JSON"
    )
    pe.add_argument("name", choices=["arbitrage", "liquidation", "two-asset"])
    pe.set_defaults(fn=_cmd_export_reference)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
