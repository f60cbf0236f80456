"""Host-side cross-checks of the port's card routes against the JAX package.

A script, not a test (too slow for the test suite), run on the CPU where
both packages are installed:

* ``gates [--pools 1000] [--assets 64]``: the reference's gated loop
  (``bench_grid.py:run_config``, classic chunks, ``fused=False``) beside
  the port's (``chip_smoke.gated_route``, fused chunks of the plain
  kernels) on ``random_arbitrage_table(assets, pools, seed=7)``: every
  gate reading, chunk by chunk, and where each hands off.
* ``dual-bound REPORT``: at the prices of each confirmed hand-off that
  ``chip_smoke.py --out REPORT`` saved (phase 5b), the reference's and the
  port's ``dual_bound`` with the gate's cheap eta search ``evals=(8, 4)``
  and with the certificate's full search, beside the card's gate and
  certificate duals.
* ``custom [--pools 10000] [--assets 64] [--curvature 1e-3]``: phase 7e's
  quadratic ``CustomUtility`` (``chip_smoke.quad_data``, solved
  equilibrated) on the same network in both packages: the reference's
  float32 classic base (phase 7e's options), then each package's
  ``refine_device(target_gap=1e-6)`` from that same base, certified in
  original units (``--base-only``: the base and its certificate alone;
  ``--reference-only``: the reference's refinement alone, for sizes where
  the port's plain delta projections are too slow on the CPU).

Each prints its numbers and, with ``--out``, writes them as JSON.
"""
import argparse
import dataclasses
import json
import logging
import os
import re
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import bench_grid  # noqa: E402  (sets the JAX flags before jax loads)
import chip_smoke  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(4)

GATE = re.compile(r"it=(\d+): gate gap=(\S+) feas=(\S+)")
CONFIRM = re.compile(r"it=(\d+): CONFIRM gap=(\S+) feas=(\S+)")


def _readings(lines):
    gates = [dict(iters=int(i), gap_rel=float(g), feasibility_rel=float(f))
             for ln in lines for i, g, f in GATE.findall(ln)]
    confirms = [dict(iters=int(i), gap_rel=float(g), feasibility_rel=float(f))
                for ln in lines for i, g, f in CONFIRM.findall(ln)]
    return gates, confirms


def gates(pools, assets):
    from cfmm_routing_tpu_torch.utils.synth import random_arbitrage_table

    ref_lines = []
    bench_grid._log = ref_lines.append
    t0 = time.perf_counter()
    bench_grid.run_config(pools, assets, 1, fused=False)
    ref_s = time.perf_counter() - t0
    port_lines = []
    table, obj = random_arbitrage_table(assets, pools, seed=7)
    t0 = time.perf_counter()
    out = chip_smoke.gated_route(table, obj, device="cpu", say=port_lines.append)
    port_s = time.perf_counter() - t0
    ref_g, ref_c = _readings(ref_lines)
    port_g, port_c = _readings(port_lines)
    print(f"# {pools} pools / {assets} assets: gate readings, reference (classic "
          f"chunks) | port (fused chunks of the plain kernels)")
    print(f"# {'iters':>6} {'ref gap':>10} {'ref feas':>10} {'port gap':>10} "
          f"{'port feas':>10}")
    by_it = {g["iters"]: g for g in port_g}
    for g in ref_g:
        p = by_it.get(g["iters"])
        print(f"  {g['iters']:6d} {g['gap_rel']:10.2e} {g['feasibility_rel']:10.2e} "
              + (f"{p['gap_rel']:10.2e} {p['feasibility_rel']:10.2e}" if p else "-"))
    for g in port_g[len(ref_g):]:
        print(f"  {g['iters']:6d} {'-':>10} {'-':>10} {g['gap_rel']:10.2e} "
              f"{g['feasibility_rel']:10.2e}")
    print(f"# confirms: reference {ref_c}; port {port_c}")
    print(f"# port hand-off at {out['device_iters']} iterations, final gap "
          f"{out['gap_rel']:.3e} feasibility {out['feasibility_rel']:.3e} "
          f"({port_s:.1f} s on the CPU; the reference's loop {ref_s:.1f} s)")
    return dict(pools=pools, assets=assets, reference=dict(gates=ref_g, confirms=ref_c),
                port=dict(gates=port_g, confirms=port_c, handoff_iters=out["device_iters"],
                          gap_rel=out["gap_rel"],
                          feasibility_rel=out["feasibility_rel"]))


def dual_bounds(report_path):
    from cfmm_routing_tpu.solver.certify import dual_bound as ref_dual_bound
    from cfmm_routing_tpu.solver.compiler import compile_table as ref_compile_table
    from cfmm_routing_tpu.utils.synth import random_arbitrage_table as ref_table
    from cfmm_routing_tpu_torch.solver.certify import dual_bound
    from cfmm_routing_tpu_torch.solver.compiler import compile_table
    from cfmm_routing_tpu_torch.utils.synth import random_arbitrage_table

    with open(report_path) as fh:
        rows = json.load(fh)["gated_route"]
    out = []
    for key, row in rows.items():
        if not key.endswith("replayed"):
            continue
        n, m = row["n_assets"], row["n_pools"]
        table, obj = random_arbitrage_table(n, m, seed=7)
        r_table, r_obj = ref_table(n, m, seed=7)
        compiled = compile_table(table, pad_pools_to=1024)
        r_compiled = ref_compile_table(r_table, pad_pools_to=1024)
        for conf in row["confirmed"]:
            prices = np.asarray(conf["prices"], np.float64)
            vals = dict(
                ref_cheap=ref_dual_bound(r_compiled, r_obj, prices, evals=(8, 4)),
                ref_full=ref_dual_bound(r_compiled, r_obj, prices),
                port_cheap=dual_bound(compiled, obj, prices, evals=(8, 4), device="cpu"),
                port_full=dual_bound(compiled, obj, prices, device="cpu"))
            scale = max(1.0, abs(conf["cert_dual"]))
            rel = {k: (float(v) - conf["cert_dual"]) / scale for k, v in vals.items()}
            print(f"# {m} pools / {n} assets, hand-off at {conf['iters']} iterations: "
                  f"card gate dual {conf['gate_dual']:.12g} (above the card certificate's "
                  f"{conf['cert_dual']:.12g} by "
                  f"{(conf['gate_dual'] - conf['cert_dual']) / scale:.3e}); on the host, "
                  "above the card certificate's: "
                  + ", ".join(f"{k} {r:.3e}" for k, r in rel.items()))
            out.append(dict(n_pools=m, n_assets=n, iters=conf["iters"],
                            card_gate_dual=conf["gate_dual"], card_cert_dual=conf["cert_dual"],
                            host={k: float(v) for k, v in vals.items()}, above_cert=rel))
    return out


def custom(pools, assets, curvature, base_only=False, reference_only=False):
    from cfmm_routing_tpu.models.utility import CustomUtility as RefCustom
    from cfmm_routing_tpu.ops.projection import ProjectionConfig as RefConfig
    from cfmm_routing_tpu.solver.admm import AdmmOptions as RefOptions
    from cfmm_routing_tpu.solver.admm import AdmmSolver as RefSolver
    from cfmm_routing_tpu.solver.certify import certify as ref_certify
    from cfmm_routing_tpu.solver.compiler import compile_table as ref_compile_table
    from cfmm_routing_tpu.solver.precondition import equilibrate as ref_equilibrate
    from cfmm_routing_tpu.solver.precondition import unscale_result as ref_unscale
    from cfmm_routing_tpu.solver.refine_device import refine_device as ref_refine_device
    from cfmm_routing_tpu.utils.synth import random_arbitrage_table as ref_table
    from cfmm_routing_tpu_torch.convert import route_result_from_numpy
    from cfmm_routing_tpu_torch.models.utility import CustomUtility
    from cfmm_routing_tpu_torch.solver.admm import AdmmOptions
    from cfmm_routing_tpu_torch.solver.compiler import compile_table
    from cfmm_routing_tpu_torch.solver.precondition import equilibrate, unscale_result
    from cfmm_routing_tpu_torch.solver.refine_device import refine_device
    from cfmm_routing_tpu_torch.utils.synth import random_arbitrage_table

    # both packages' refinement logs: every chunk's gate and certificate
    logging.basicConfig(stream=sys.stdout, format="%(name)s: %(message)s")
    for name in ("cfmm_routing_tpu.refine_device", "cfmm_routing_tpu_torch.refine_device"):
        logging.getLogger(name).setLevel(logging.DEBUG)
    n = assets
    table, obj = random_arbitrage_table(n, pools, seed=7)
    r_table, r_obj = ref_table(n, pools, seed=7)
    eq, r_eq = equilibrate(table, obj), ref_equilibrate(r_table, r_obj)
    d = np.asarray(eq.d, np.float64)
    if not np.array_equal(d, np.asarray(r_eq.d)):
        raise AssertionError("the two packages' equilibration scales differ")
    compiled, compiled_orig = compile_table(eq.table), compile_table(table)
    r_compiled, r_compiled_orig = ref_compile_table(r_eq.table), ref_compile_table(r_table)
    Q = chip_smoke.quad_data(n, curvature)
    c = np.asarray(obj.c).astype(np.float32).astype(np.float64)
    Qinv = np.linalg.inv(Q)
    Qd = Q * np.outer(d, d)
    conj = lambda nu: 0.5 * float((c - nu) @ Qinv @ (c - nu))  # noqa: E731
    box = dict(lo=np.full(n, -chip_smoke.QUAD_BOX), hi=np.full(n, chip_smoke.QUAD_BOX))
    box_d = dict(lo=box["lo"] / d, hi=box["hi"] / d)
    L = float(np.linalg.eigvalsh(Q)[-1]) * (1 + 1e-9)
    L_d = float(np.linalg.eigvalsh(Qd)[-1]) * (1 + 1e-9)
    Qt, ct, dt = (torch.as_tensor(x) for x in (Q, c, d))

    def fn(p):
        return torch.dot(ct.to(p), p) - 0.5 * torch.dot(p, Qt.to(p) @ p)

    def r_fn(p):
        return jnp.dot(jnp.asarray(c, p.dtype), p) - 0.5 * jnp.dot(p, jnp.asarray(Q, p.dtype) @ p)

    util = CustomUtility(fn, smoothness=L, prox_iters=80, conjugate=conj, **box)
    util_d = CustomUtility(lambda p: fn(dt.to(p) * p), smoothness=L_d, prox_iters=80,
                           conjugate=lambda nu: conj(nu / d), **box_d)
    r_util = RefCustom(r_fn, smoothness=L, prox_iters=80, conjugate=conj, **box)
    r_util_d = RefCustom(lambda p: r_fn(jnp.asarray(d, p.dtype) * p), smoothness=L_d,
                         prox_iters=80, conjugate=lambda nu: conj(nu / d), **box_d)

    t0 = time.perf_counter()
    base = RefSolver(r_compiled, dtype=jnp.float32, options=RefOptions(
        max_iters=3000, eps_abs=1e-7, eps_rel=1e-7, check_every=25,
        projection=RefConfig(n_bisect=24, n_polish=4))).solve(r_util_d)
    base = jax.tree_util.tree_map(np.asarray, base)
    base_s = time.perf_counter() - t0
    r0 = ref_unscale(base, d, r_compiled)
    entry = ref_certify(r_compiled_orig, r_util, r0.deltas, r0.lambdas, r0.prices,
                        psi_claimed=r0.psi)
    print(f"# reference float32 base: {int(base.iters)} iterations, converged "
          f"{bool(base.converged)} ({base_s:.1f} s); its certificate in original units: "
          f"gap {entry.gap_rel:.3e} feasibility {entry.feasibility_rel:.3e}")
    out = dict(pools=pools, assets=n, curvature=curvature, base_iters=int(base.iters),
               base_converged=bool(base.converged),
               base_certificate=dict(gap_rel=float(entry.gap_rel),
                                     feasibility_rel=float(entry.feasibility_rel)))
    if base_only:
        return out
    rows = {}
    t0 = time.perf_counter()
    ref = ref_refine_device(
        r_compiled, r_util_d, base, target_gap=1e-6,
        options=dataclasses.replace(RefOptions(), check_every=25),
        cert_space=(r_compiled_orig, r_util, lambda r: ref_unscale(r, d, r_compiled)))
    rows["reference"] = (ref, time.perf_counter() - t0)
    if not reference_only:
        res = route_result_from_numpy(base.objective, base.psi, base.prices, base.deltas,
                                      base.lambdas, base.iters, base.r_norm, base.s_norm,
                                      base.converged, base.rho_final, device="cpu")
        t0 = time.perf_counter()
        got = refine_device(compiled, util_d, res, target_gap=1e-6,
                            options=dataclasses.replace(AdmmOptions(), check_every=25),
                            cert_space=(compiled_orig, util,
                                        lambda r: unscale_result(r, d, compiled)),
                            device="cpu")
        rows["port"] = (got, time.perf_counter() - t0)
    for k, (r, secs) in rows.items():
        cert = r.certificate
        out[k] = dict(achieved=bool(r.achieved), iters=int(r.iters),
                      gap_rel=float(cert.gap_rel),
                      feasibility_rel=float(cert.feasibility_rel),
                      objective=float(cert.objective), seconds=secs)
        print(f"# {k} refine_device: achieved {bool(r.achieved)} after {int(r.iters)} "
              f"iterations, gap {cert.gap_rel:.3e} feasibility {cert.feasibility_rel:.3e} "
              f"objective {cert.objective:.9g} ({secs:.1f} s)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="what", required=True)
    g = sub.add_parser("gates")
    g.add_argument("--pools", type=int, default=1000)
    g.add_argument("--assets", type=int, default=64)
    b = sub.add_parser("dual-bound")
    b.add_argument("report")
    c = sub.add_parser("custom")
    c.add_argument("--pools", type=int, default=10_000)
    c.add_argument("--assets", type=int, default=64)
    c.add_argument("--curvature", type=float, default=1e-3)
    c.add_argument("--base-only", action="store_true",
                   help="stop after the reference's base and its certificate")
    c.add_argument("--reference-only", action="store_true",
                   help="refine with the reference alone")
    for p in (g, b, c):
        p.add_argument("--out")
    args = ap.parse_args(argv)
    if args.what == "gates":
        out = gates(args.pools, args.assets)
    elif args.what == "dual-bound":
        out = dual_bounds(args.report)
    else:
        out = custom(args.pools, args.assets, args.curvature, args.base_only,
                     args.reference_only)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
