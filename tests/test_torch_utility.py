"""Port separable concave utilities vs the JAX package (CPU, float64).

* ``utility_prox`` (and skipping the power root-find for a utility without
  power atoms changes nothing), ``_power_root`` (at the extreme parameters
  of ``tests/test_utilities.py``, also held against scipy's brentq),
  ``delta_utility_prox`` (on the delta utility both packages prepare from
  the same mixed utility) and ``utility_value`` equal the reference's:
  1e-12.
* Classic solves of the three ``test_utilities`` flavours (log, power,
  quad on ``random_arbitrage(5, 8, seed=11)``, boxed) equal the reference's
  solves to 1e-9 after the same 300 iterations (rho adaptation on).
* ``certify``, ``dual_bound`` and ``polish_prices`` with a log utility give
  the reference's fields on the same candidate: 1e-9.
* ``api.route(util, precondition=True, certify=True)`` equals the
  reference's call: 1e-8.
* A ``ChunkedDriver`` run with a utility equals ``solve``.

The plain root-find costs ~10 ms per iteration on the CPU, so solves run a
fixed budget of a few hundred iterations (``FIXED``: tolerances 0, the
residual check every 25 iterations) on both sides rather than to
convergence.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cfmm_routing_tpu import api as ref_api
from cfmm_routing_tpu.models.utility import ConcaveUtility as RefUtility
from cfmm_routing_tpu.ops import prox as ref_prox
from cfmm_routing_tpu.solver import certify as ref_certify
from cfmm_routing_tpu.solver.admm import AdmmOptions as RefOptions
from cfmm_routing_tpu.solver.admm import AdmmSolver as RefSolver
from cfmm_routing_tpu.solver.compiler import compile_spec as ref_compile_spec
from cfmm_routing_tpu.solver.refine_device import _prep_delta_solve as ref_prep
from cfmm_routing_tpu.utils.synth import random_arbitrage as ref_random_arbitrage
from cfmm_routing_tpu_torch import api
from cfmm_routing_tpu_torch.models.utility import ConcaveUtility
from cfmm_routing_tpu_torch.ops import prox
from cfmm_routing_tpu_torch.solver import certify as port_certify
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver
from cfmm_routing_tpu_torch.solver.compiler import compile_spec
from cfmm_routing_tpu_torch.solver.driver import ChunkedDriver
from cfmm_routing_tpu_torch.solver.refine_device import _prep_delta_solve
from cfmm_routing_tpu_torch.utils.synth import random_arbitrage

torch.set_num_threads(1)

FIXED = dict(max_iters=300, eps_abs=0.0, eps_rel=0.0, check_every=25)


def _mixed(cls, n: int, seed: int):
    """Every atom kind, boxed (``tests/test_utilities.py:_mixed_utility``)."""
    rng = np.random.default_rng(seed)
    u = cls.linear(rng.uniform(0.5, 2.0, n), lo=np.zeros(n))
    for j in range(n):
        kind = j % 4
        if kind == 1:
            u = u.with_quadratic(j, rng.uniform(0.5, 2.0), rng.uniform(0.1, 1.0))
        elif kind == 2:
            u = u.with_log(j, rng.uniform(0.5, 2.0), rng.uniform(0.5, 3.0))
        elif kind == 3:
            u = u.with_power(j, rng.uniform(0.5, 2.0), rng.uniform(0.2, 0.8),
                             rng.uniform(0.5, 2.0))
        u = u.with_box(j, rng.uniform(-0.5, 0.0), rng.uniform(1.0, 8.0))
    return u


def _flavour(cls, lin, n, flavour):
    util = cls.linear(lin.c, lo=np.zeros(n))
    for j in range(n):
        if flavour == "log":
            util = util.with_log(j, 1.0 + 0.2 * j, 1.0)
        elif flavour == "power":
            util = util.with_power(j, 1.0 + 0.1 * j, 0.5, 1.0)
        else:
            util = util.with_quadratic(j, 1.0 + 0.3 * j, 0.5)
        util = util.with_box(j, 0.0, 50.0)
    return util


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def _close(got, want, tol, label=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol, err_msg=label)


def test_utility_prox_and_value_match_reference():
    n = 16
    rng = np.random.default_rng(0)
    s = rng.normal(0.0, 2.0, n)
    degree = rng.integers(0, 6, n).astype(np.float64)  # one untouched asset
    for rho in (0.7, 1e-3):
        want = ref_prox.utility_prox(jnp.asarray(s), jnp.asarray(degree),
                                     _mixed(RefUtility, n, 1).pack(jnp.float64),
                                     jnp.float64(rho))
        got = prox.utility_prox(_t(s), _t(degree),
                                _mixed(ConcaveUtility, n, 1).pack(torch.float64, "cpu"),
                                rho)
        for g, w, label in zip(got, want, ("psi", "mu")):
            _close(g, w, 1e-12, f"{label} rho={rho}")
    # without power atoms the prox skips the power root-find: same result
    no_pow = _flavour(ConcaveUtility, random_arbitrage(n, 40, seed=2)[1], n, "log")
    packed = no_pow.pack(torch.float64, "cpu")
    assert not packed.has_power
    for a, b in zip(prox.utility_prox(_t(s), _t(degree), packed, 0.7),
                    prox.utility_prox(_t(s), _t(degree),
                                      packed._replace(has_power=True), 0.7)):
        assert torch.equal(a, b)
    psi = rng.uniform(0.0, 1.5, n)
    want = ref_prox.utility_value(_mixed(RefUtility, n, 9).pack(jnp.float64),
                                  jnp.asarray(psi))
    got = prox.utility_value(_mixed(ConcaveUtility, n, 9).pack(torch.float64, "cpu"),
                             _t(psi))
    _close(got, want, 1e-12)
    assert abs(float(got) - _mixed(ConcaveUtility, n, 9).value(psi)) < 1e-10


def test_power_root_matches_reference_at_extreme_parameters():
    """The draws of ``tests/test_utilities.py``'s brentq regression: prox
    weights over six decades, t of either sign, p in (0.02, 0.98)."""
    from scipy.optimize import brentq

    rng = np.random.default_rng(12)
    draws = []
    for _ in range(80):
        draws.append((10.0 ** rng.uniform(-4, 2), rng.uniform(-80, 80),
                      10.0 ** rng.uniform(-3, 2), rng.uniform(0.02, 0.98)))
    w, t, cf, p = (np.array(x) for x in zip(*draws))
    want = np.asarray(ref_prox._power_root(jnp.asarray(w), jnp.asarray(t),
                                           jnp.asarray(cf), jnp.asarray(p),
                                           jnp.float64(2.2e-308)))
    got = prox._power_root(_t(w), _t(t), _t(cf), _t(p), 2.2e-308).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    for k in (0, 17, 41, 79):
        hi = max(2 * t[k], 1.0) + (2 * cf[k] / w[k]) ** (1.0 / (2.0 - p[k])) + 1e8
        root = brentq(lambda y: w[k] * (y - t[k]) - cf[k] * y ** (p[k] - 1.0),
                      1e-300, hi, xtol=1e-300, rtol=8.9e-16, maxiter=600)
        assert abs(got[k] - root) <= 1e-9 * max(abs(root), 1e-12)


def test_delta_utility_prox_matches_reference():
    """The delta utility of a mixed utility re-centred at psi0 with a small
    correction scale, prepared by each package's ``_prep_delta_solve``."""
    from cfmm_routing_tpu.solver.refine_device import _delta_objective as ref_dobj
    from cfmm_routing_tpu_torch.solver.refine_device import _delta_objective

    n = 16
    rng = np.random.default_rng(3)
    psi0 = rng.uniform(0.2, 1.0, n)
    nu0 = rng.uniform(0.1, 1.0, n)
    eps, rho = 1e-3, 0.8
    ref_c, ref_lo, ref_hi, ref_du, _ = ref_prep(
        ref_dobj(_mixed(RefUtility, n, 5), psi0, eps), nu0, rho, jnp.float64)
    table_solver = AdmmSolver(compile_spec(random_arbitrage(n, 40, seed=1)[0]),
                              dtype=torch.float64, device="cpu")
    c, lo, hi, du, start = _prep_delta_solve(
        _delta_objective(_mixed(ConcaveUtility, n, 5), psi0, eps), nu0, rho,
        table_solver)
    assert not start.any() and not c.any()
    for g, w, label in zip(du, ref_du, ref_du._fields):
        _close(g, w, 1e-12, label)
    dnu = 1e-3 * rng.normal(size=n)
    yhat = 0.5 * rng.normal(size=n)
    degree = rng.integers(0, 5, n).astype(np.float64)
    want = ref_prox.delta_utility_prox(jnp.asarray(dnu), jnp.asarray(yhat),
                                       jnp.asarray(degree), ref_du, jnp.float64(rho))
    got = prox.delta_utility_prox(_t(dnu), _t(yhat), _t(degree), du, rho)
    for g, w, label in zip(got, want, ("d", "dmu")):
        _close(g, w, 1e-12, label)


@pytest.mark.parametrize("flavour", ["log", "power", "quad"])
def test_classic_solves_match_reference(flavour):
    spec, lin = random_arbitrage(5, 8, seed=11)
    ref_spec, ref_lin = ref_random_arbitrage(5, 8, seed=11)
    n = spec.n_assets
    ref = RefSolver(ref_compile_spec(ref_spec), dtype=jnp.float64,
                    options=RefOptions(**FIXED))
    want = ref.solve(_flavour(RefUtility, ref_lin, n, flavour))
    port = AdmmSolver(compile_spec(spec), dtype=torch.float64,
                      options=AdmmOptions(**FIXED), device="cpu")
    got = port.solve(_flavour(ConcaveUtility, lin, n, flavour))
    assert int(got.iters) == int(want.iters) == 300
    _close(got.objective, want.objective, 1e-9, "objective")
    _close(got.psi, want.psi, 1e-9, "psi")
    _close(got.prices, want.prices, 1e-9, "prices")


def test_certify_dual_bound_and_polish_match_reference():
    """Both packages' certificates of the reference's own log-utility
    solve (``tests/test_utilities.py:test_certificate_nonlinear``)."""
    ref_spec, ref_lin = ref_random_arbitrage(5, 8, seed=13)
    spec, lin = random_arbitrage(5, 8, seed=13)
    n = spec.n_assets

    def logs(cls, lin_):
        u = cls.linear(lin_.c, lo=np.zeros(n))
        for j in range(n):
            u = u.with_log(j, 1.0, 1.0).with_box(j, 0.0, 50.0)
        return u

    ref_u, util = logs(RefUtility, ref_lin), logs(ConcaveUtility, lin)
    ref = RefSolver(ref_compile_spec(ref_spec), dtype=jnp.float64,
                    options=RefOptions(max_iters=400, eps_abs=0.0, eps_rel=0.0))
    res = ref.solve(ref_u)
    D = {k: np.asarray(v) for k, v in res.deltas.items()}
    L = {k: np.asarray(v) for k, v in res.lambdas.items()}
    prices, psi = np.asarray(res.prices), np.asarray(res.psi)
    compiled = compile_spec(spec)
    want = ref_certify.certify(ref.compiled, ref_u, D, L, prices, psi_claimed=psi)
    got = port_certify.certify(compiled, util, D, L, prices, psi_claimed=psi,
                               device="cpu")
    for field in ("objective", "dual_bound", "gap_abs", "gap_rel", "phi_violation",
                  "nonneg_violation", "floor_violation", "box_violation",
                  "psi_consistency", "feasibility_rel"):
        _close(getattr(got, field), getattr(want, field), 1e-9, field)
    _close(got.prices, want.prices, 1e-9, "prices")
    shifted = 1.1 * prices + 0.01
    _close(port_certify.dual_bound(compiled, util, shifted, device="cpu"),
           ref_certify.dual_bound(ref.compiled, ref_u, shifted), 1e-9, "dual_bound")
    nu_w = ref_certify.polish_prices(ref.compiled, ref_u, shifted, max_evals=60)
    nu_g = port_certify.polish_prices(compiled, util, shifted, max_evals=60,
                                      device="cpu")
    b_w = ref_certify.dual_bound(ref.compiled, ref_u, nu_w)
    b_g = port_certify.dual_bound(compiled, util, nu_g, device="cpu")
    _close(b_g, b_w, 1e-9, "polished bound")
    assert b_g < port_certify.dual_bound(compiled, util, shifted, device="cpu")


def test_api_route_preconditioned_certified_matches_reference():
    spec, lin = random_arbitrage(4, 6, seed=17)
    ref_spec, ref_lin = ref_random_arbitrage(4, 6, seed=17)
    n = spec.n_assets

    def util_of(cls, lin_):
        u = cls.linear(lin_.c, lo=np.zeros(n))
        return u.with_log(0, 1.0, 1.0).with_box(0, 0.0, 20.0)

    want = ref_api.route(ref_spec, util_of(RefUtility, ref_lin), dtype=jnp.float64,
                         options=RefOptions(**FIXED), precondition=True, certify=True)
    got = api.route(spec, util_of(ConcaveUtility, lin), dtype=torch.float64,
                    options=AdmmOptions(**FIXED), precondition=True, certify=True,
                    device="cpu")
    assert got.iters == want.iters == 300
    _close(got.objective, want.objective, 1e-8, "objective")
    _close(got.psi, want.psi, 1e-8, "psi")
    for field in ("objective", "dual_bound", "gap_rel", "feasibility_rel"):
        _close(getattr(got.certificate, field), getattr(want.certificate, field),
               1e-8, field)
    assert got.certificate.gap_abs >= 0.0  # a rigorous bound on a feasible point
    with pytest.raises(TypeError):
        api.route(spec, np.ones(n), device="cpu")


def test_chunked_driver_utility_run_equals_solve():
    spec, lin = random_arbitrage(5, 8, seed=11)
    util = _flavour(ConcaveUtility, lin, spec.n_assets, "power")
    solver = AdmmSolver(compile_spec(spec), dtype=torch.float64, device="cpu",
                        options=AdmmOptions(max_iters=75, eps_abs=0.0, eps_rel=0.0,
                                            adapt_rho=False, check_every=25))
    want = solver.solve(util)
    got, log = ChunkedDriver(solver, chunk=25).solve(util, max_iters=75)
    assert log.status == "max_iters" and len(log) == 3
    assert torch.equal(got.psi, want.psi)
    assert torch.equal(got.prices, want.prices)
    assert float(got.objective) == float(want.objective)
    assert abs(log.records[-1].objective - util.value(want.psi.numpy())) < 1e-12
