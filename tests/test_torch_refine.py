"""The port's device refinement vs the JAX package, on the CPU.

* ``refine_device`` on the arbitrage instance, both packages from the same
  float32 base solve at ``target_gap=1e-7``: both certify, and their
  certificate objectives agree to 1e-6 relative.
* ``api.liquidate`` / ``api.route(refine_to=1e-7)``: certified, with the
  reference pins to 1e-6; with ``precondition=True`` the certificate is the
  one of the original problem, in original units.
* ``polish_prices`` from the same perturbed prices: the two packages' dual
  bounds agree to 1e-9 relative.
* ``refine`` (the float64 fallback) certifies the arbitrage instance at 1e-6.
* The entry points left out of the port so far raise
  ``NotImplementedError`` naming their ROADMAP.md queue item
  (``refine(cpu_shards=)``: 14; the native packer), ``refine_device``
  refuses an objective that is neither an ``Objective``, a
  ``ConcaveUtility`` nor a ``CustomUtility``, and a ``CustomUtility``
  (item 12b, ported) without its conjugate.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfmm_routing_tpu.models.reference_instances import arbitrage_instance as ref_arb
from cfmm_routing_tpu.solver import admm as ref_admm
from cfmm_routing_tpu.solver import certify as ref_certify
from cfmm_routing_tpu.solver.compiler import compile_spec as ref_compile_spec
from cfmm_routing_tpu.solver.refine_device import refine_device as ref_refine_device
from cfmm_routing_tpu_torch import api, convert
from cfmm_routing_tpu_torch.models.reference_instances import (
    arbitrage_instance, liquidation_instance, two_asset_instance,
)
from cfmm_routing_tpu_torch.models.utility import CustomUtility
from cfmm_routing_tpu_torch.solver import refine_device as rd
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions
from cfmm_routing_tpu_torch.solver.certify import certify, dual_bound, polish_prices
from cfmm_routing_tpu_torch.solver.compiler import compile_spec, compile_table
from cfmm_routing_tpu_torch.solver.refine import refine
from cfmm_routing_tpu_torch.utils.synth import random_arbitrage_table

torch.set_num_threads(1)

# the base solve of bench.py's sanity gate at a looser residual, from which
# refinement takes over (the CPU's plain kernels are slow per step).  The
# reference's refine_device certifies the arbitrage instance from 1e-5 but
# not from 2e-5; the api calls take 2e-5, which halves their base solves.
BASE = dict(max_iters=6000, eps_abs=1e-5, eps_rel=1e-5, check_every=25)
API_BASE = dict(BASE, eps_abs=2e-5, eps_rel=2e-5)


@pytest.fixture(scope="module")
def arb():
    """The reference's float32 base solve of the arbitrage instance, as
    numpy arrays and as a port RouteResult on the CPU."""
    spec_r, obj_r = ref_arb()
    ref_compiled = ref_compile_spec(spec_r)
    base = jax.tree_util.tree_map(np.asarray, ref_admm.AdmmSolver(
        ref_compiled, dtype=jnp.float32,
        options=ref_admm.AdmmOptions(**BASE)).solve(obj_r))
    spec, obj = arbitrage_instance()
    port_base = convert.route_result_from_numpy(*base, device="cpu")
    return dict(ref_compiled=ref_compiled, obj_r=obj_r, base=base,
                compiled=compile_spec(spec), obj=obj, port_base=port_base)


def test_refine_device_arbitrage_matches_reference(arb):
    want = ref_refine_device(arb["ref_compiled"], arb["obj_r"], arb["base"],
                             target_gap=1e-7)
    got = rd.refine_device(arb["compiled"], arb["obj"], arb["port_base"],
                           target_gap=1e-7, device="cpu")
    assert want.achieved and got.achieved, got.certificate.summary()
    cg, cw = got.certificate, want.certificate
    assert abs(cg.gap_rel) <= 1e-7 and cg.feasibility_rel <= 1e-7
    assert abs(cg.objective - cw.objective) <= 1e-6 * abs(cw.objective)
    assert abs(cg.objective - 21.499805) / 21.499805 < 1e-6


def _bucketed(compiled, per_pool):
    """Per-pool trades in spec order -> slot-major (K, m) bucket planes."""
    out = {}
    for name, b in compiled.buckets.items():
        plane = np.zeros((b.width, b.m))
        for r, pid in enumerate(b.pool_ids):
            plane[: len(per_pool[pid]), r] = per_pool[pid]
        out[name] = plane
    return out


@pytest.mark.parametrize("label", ["liquidation", "two-asset t=25, preconditioned"])
def test_api_refine_to_certifies_reference_pins(label):
    opts = AdmmOptions(**API_BASE)
    if label == "liquidation":
        spec, obj = liquidation_instance()
        route = api.liquidate(spec, [2, 1, 3, 5, 10], numeraire=4,
                              refine_to=1e-7, options=opts, device="cpu")
        value, pin = float(route.psi[4]), 15.883010
    else:
        spec, obj = two_asset_instance(25.0)
        route = api.route(spec, obj, refine_to=1e-7, precondition=True,
                          options=opts, device="cpu")
        value, pin = route.objective, 31.005495
        # the certificate speaks the caller's units: certifying the
        # returned trades and prices against the ORIGINAL problem agrees
        compiled = compile_spec(spec)
        again = certify(compiled, obj, _bucketed(compiled, route.deltas),
                        _bucketed(compiled, route.lambdas), route.prices,
                        psi_claimed=route.psi, device="cpu")
        assert abs(again.objective - route.certificate.objective) <= 1e-12 * pin
        assert abs(again.gap_rel - route.certificate.gap_rel) <= 1e-9
    cert = route.certificate
    assert route.converged, cert.summary()
    assert abs(cert.gap_rel) <= 1e-7 and cert.feasibility_rel <= 1e-7
    assert abs(value - pin) / pin < 1e-6


def test_polish_prices_matches_reference(arb):
    rng = np.random.default_rng(5)
    nu0 = arb["base"].prices * (1.0 + 1e-3 * rng.normal(size=arb["base"].prices.shape))
    got = polish_prices(arb["compiled"], arb["obj"], nu0, device="cpu")
    want = ref_certify.polish_prices(arb["ref_compiled"], arb["obj_r"], nu0)
    b_got = dual_bound(arb["compiled"], arb["obj"], got, device="cpu")
    b_want = ref_certify.dual_bound(arb["ref_compiled"], arb["obj_r"], want)
    assert abs(b_got - b_want) <= 1e-9 * abs(b_want)
    assert b_got < dual_bound(arb["compiled"], arb["obj"], nu0, device="cpu")


def test_refine_float64_fallback_certifies_arbitrage(arb):
    out = refine(arb["compiled"], arb["obj"], arb["port_base"], target_gap=1e-6,
                 device="cpu")
    assert out.achieved, out.certificate.summary()
    assert abs(out.certificate.objective - 21.499805) / 21.499805 < 1e-6


def test_left_out_entry_points_name_their_queue_item(arb):
    compiled, obj, base = arb["compiled"], arb["obj"], arb["port_base"]

    # CustomUtility is ported (item 12b); without a conjugate it cannot be
    # certified, so refine_device names what is missing
    custom = CustomUtility(lambda psi: psi.sum(), obj.lo, obj.hi, smoothness=0.0)
    with pytest.raises(ValueError, match="conjugate"):
        rd.refine_device(compiled, custom, base, device="cpu")

    class Other:  # neither an Objective nor a ConcaveUtility
        c, lo, hi = obj.c, obj.lo, obj.hi

    with pytest.raises(TypeError, match="ConcaveUtility"):
        rd.refine_device(compiled, Other(), base, device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        refine(compiled, obj, base, cpu_shards=4, device="cpu")
    table, _ = random_arbitrage_table(8, 20, seed=1)
    with pytest.raises(NotImplementedError, match="native packer"):
        compile_table(table, backend="native")
