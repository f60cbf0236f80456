"""Port non-separable concave utilities (``CustomUtility``) vs the JAX
package (CPU, float64 unless stated).

* Construction errors are the reference's; ``value`` / ``grad`` (float64 on
  the CPU through torch) equal the reference's (jax.grad): 1e-12.
* ``custom_prox`` and ``delta_custom_prox`` equal the reference's for the
  log of a linear form and for a dense quadratic form: 1e-12.
* ``AdmmSolver.solve(CustomUtility)`` equals the reference's solve after
  the same fixed iterations (tolerances 0) on ``random_arbitrage(5, 8,
  seed=11)`` (log) and ``seed=13`` (quadratic): 1e-9.
* ``certify``, ``dual_bound`` and ``polish_prices`` with the user conjugate
  give the reference's values on the same candidate (1e-9); without a
  conjugate certify, dual_bound and refine_device raise a ValueError
  naming it.
* ``refine_device(CustomUtility)`` from the reference's float32 base
  certifies at 1e-6 (``tests/test_refine_device.py``'s case), with the
  certified value within 1e-5 of the reference's refinement.  Both run one
  250-iteration chunk per pass (``chunks_per_pass=1``): with the default 8
  both take the same 2,250 iterations, ~100 s of plain delta projections
  here; with 1 both take 500.
* A warm start from the reference's converged solve converges at once;
  the fused path, ``ChunkedDriver`` and ``precondition`` refuse a custom
  utility; the graph cache keys one by identity.

Every ``fn`` is torch-only and moves the tensors it closes over with
``t.to(p)``, as a ``fn`` that runs on the card must.  Solves use
``prox_iters=80`` quadratics (60 trips for the log form) to keep the file
inside its time budget: a FISTA trip costs ~0.15 ms of autograd here.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfmm_routing_tpu.models.utility import CustomUtility as RefCustom
from cfmm_routing_tpu.ops import prox as ref_prox
from cfmm_routing_tpu.solver import certify as ref_certify
from cfmm_routing_tpu.solver import refine_device as ref_rd
from cfmm_routing_tpu.solver.admm import AdmmOptions as RefOptions
from cfmm_routing_tpu.solver.admm import AdmmSolver as RefSolver
from cfmm_routing_tpu.solver.compiler import compile_spec as ref_compile_spec
from cfmm_routing_tpu.utils.synth import random_arbitrage as ref_random_arbitrage
from cfmm_routing_tpu_torch.convert import route_result_from_numpy
from cfmm_routing_tpu_torch.models.utility import CustomUtility
from cfmm_routing_tpu_torch.ops import prox
from cfmm_routing_tpu_torch.solver import certify as port_certify
from cfmm_routing_tpu_torch.solver import graphs
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver
from cfmm_routing_tpu_torch.solver.compiler import compile_spec
from cfmm_routing_tpu_torch.solver.driver import ChunkedDriver
from cfmm_routing_tpu_torch.solver.precondition import equilibrate, scale_objective
from cfmm_routing_tpu_torch.solver.refine_device import refine_device
from cfmm_routing_tpu_torch.utils.synth import random_arbitrage, random_arbitrage_table

torch.set_num_threads(1)

F64 = torch.float64


def _quad_data(n):
    rng = np.random.default_rng(5)
    A = rng.normal(size=(n, n)) / np.sqrt(n)
    return A @ A.T + 0.1 * np.eye(n)


def _pair(kind, seed, prox_iters=80, conjugate=True):
    """(ref spec, port spec, ref utility, port utility) of one case of
    ``tests/test_custom_utility.py``: ``log`` = log(1 + c@psi) on [0, 50],
    ``quad`` = c@psi - psi^T Q psi / 2 on [-5, 50] with its box-free
    conjugate."""
    r_spec, r_lin = ref_random_arbitrage(5, 8, seed=seed)
    spec, lin = random_arbitrage(5, 8, seed=seed)
    c = np.asarray(lin.c)
    n = spec.n_assets
    ct = torch.as_tensor(c)
    if kind == "log":
        r_fn = lambda p: jnp.log(1.0 + jnp.dot(jnp.asarray(c, p.dtype), p))  # noqa: E731
        fn = lambda p: torch.log(1.0 + torch.dot(ct.to(p), p))  # noqa: E731
        box = dict(lo=np.zeros(n), hi=np.full(n, 50.0), smoothness=float(c @ c))
        conj = None
    else:
        Q = _quad_data(n)
        Qt = torch.as_tensor(Q)
        Qinv = np.linalg.inv(Q)
        r_fn = lambda p: (jnp.dot(jnp.asarray(c, p.dtype), p)  # noqa: E731
                          - 0.5 * jnp.dot(p, jnp.asarray(Q, p.dtype) @ p))
        fn = lambda p: torch.dot(ct.to(p), p) - 0.5 * torch.dot(p, Qt.to(p) @ p)  # noqa: E731
        box = dict(lo=np.full(n, -5.0), hi=np.full(n, 50.0),
                   smoothness=float(np.linalg.eigvalsh(Q)[-1]))
        conj = lambda nu: 0.5 * float((c - nu) @ Qinv @ (c - nu))  # noqa: E731
    if not conjugate:
        conj = None
    return (r_spec, spec, RefCustom(fn=r_fn, prox_iters=prox_iters, conjugate=conj, **box),
            CustomUtility(fn=fn, prox_iters=prox_iters, conjugate=conj, **box))


def test_construction_errors_match_reference():
    fn = lambda p: p.sum()  # noqa: E731
    for cls in (RefCustom, CustomUtility):
        with pytest.raises(ValueError, match="identical shapes"):
            cls(fn, np.zeros(3), np.ones(4), 1.0)
        with pytest.raises(ValueError, match="box is empty"):
            cls(fn, np.ones(3), np.zeros(3), 1.0)
        for bad in (-1.0, np.inf, np.nan):
            with pytest.raises(ValueError, match="smoothness"):
                cls(fn, np.zeros(3), np.ones(3), bad)
    u = CustomUtility(fn, np.zeros(3), np.ones(3), 2)
    assert (u.prox_iters, u.conjugate, u.n_assets, u.smoothness) == (60, None, 3, 2.0)


@pytest.mark.parametrize("kind", ["log", "quad"])
def test_value_and_grad_match_reference(kind):
    _, _, ref_u, u = _pair(kind, 13)
    psi = np.random.default_rng(1).uniform(0.0, 3.0, ref_u.n_assets)
    assert abs(u.value(psi) - ref_u.value(psi)) <= 1e-12 * max(1.0, abs(ref_u.value(psi)))
    np.testing.assert_allclose(u.grad(psi), ref_u.grad(psi), rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", ["log", "quad"])
def test_custom_prox_and_delta_prox_match_reference(kind):
    _, _, ref_u, u = _pair(kind, 13, prox_iters=40)
    n = ref_u.n_assets
    rng = np.random.default_rng(7)
    s = rng.uniform(-2.0, 6.0, n)
    degree = rng.integers(0, 4, n).astype(np.float64)  # an untouched asset too
    degree[0] = 0.0
    lo, hi = np.maximum(ref_u.lo, -1e30), np.minimum(ref_u.hi, 1e30)
    rho = 0.7
    want = ref_prox.custom_prox(jnp.asarray(s), jnp.asarray(degree), ref_u,
                                jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(rho))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64))  # noqa: E731
    got = prox.custom_prox(t(s), t(degree), u, t(lo), t(hi), t(rho))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)

    psi0 = rng.uniform(0.5, 3.0, n)
    eps = 1e-3
    e0u = rng.normal(size=n) * 1e-2
    dlo, dhi = (lo - psi0) / eps, (hi - psi0) / eps
    dnu, yhat = rng.normal(size=n) * 1e-2, rng.normal(size=n)
    r_dc = ref_prox.DeltaCustomUtility(ref_u.fn, ref_u.smoothness, ref_u.prox_iters,
                                       *map(jnp.asarray, (psi0, eps, e0u, dlo, dhi)))
    dc = prox.DeltaCustomUtility(u.fn, u.smoothness, u.prox_iters,
                                 *map(t, (psi0, eps, e0u, dlo, dhi)))
    want = ref_prox.delta_custom_prox(jnp.asarray(dnu), jnp.asarray(yhat),
                                      jnp.asarray(degree), r_dc, jnp.asarray(rho))
    got = prox.delta_custom_prox(t(dnu), t(yhat), t(degree), dc, t(rho))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)
    assert abs(float(dc.fn(t(yhat))) - float(r_dc.fn(jnp.asarray(yhat)))) <= 1e-9


def _fixed(cls, k):
    return cls(max_iters=k, eps_abs=0.0, eps_rel=0.0, check_every=5)


@pytest.mark.parametrize("kind,seed,prox_iters,iters",
                         [("log", 11, 60, 40), ("quad", 13, 80, 40)])
def test_classic_solve_matches_reference(kind, seed, prox_iters, iters):
    r_spec, spec, ref_u, u = _pair(kind, seed, prox_iters=prox_iters)
    want = RefSolver(ref_compile_spec(r_spec), dtype=jnp.float64,
                     options=_fixed(RefOptions, iters)).solve(ref_u)
    got = AdmmSolver(compile_spec(spec), dtype=F64, options=_fixed(AdmmOptions, iters),
                     device="cpu").solve(u)
    assert int(got.iters) == int(want.iters) == iters
    for field in ("objective", "psi", "prices", "r_norm", "s_norm", "rho_final"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)), rtol=0, atol=1e-9,
                                   err_msg=field)
    for name in want.deltas:
        np.testing.assert_allclose(got.deltas[name].numpy(), np.asarray(want.deltas[name]),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(got.lambdas[name].numpy(),
                                   np.asarray(want.lambdas[name]), rtol=0, atol=1e-9)


@pytest.fixture(scope="module")
def quad_solved():
    """The reference's converged float64 solve of the quadratic case
    (``tests/test_custom_utility.py``'s options), as numpy."""
    r_spec, spec, ref_u, u = _pair("quad", 13)
    tight = RefOptions(max_iters=40000, eps_abs=1e-10, eps_rel=1e-10)
    res = RefSolver(ref_compile_spec(r_spec), dtype=jnp.float64, options=tight).solve(ref_u)
    assert bool(res.converged)
    return r_spec, spec, ref_u, u, jax.tree_util.tree_map(np.asarray, res)


def test_certificates_match_reference(quad_solved):
    r_spec, spec, ref_u, u, res = quad_solved
    r_comp, comp = ref_compile_spec(r_spec), compile_spec(spec)
    want = ref_certify.certify(r_comp, ref_u, res.deltas, res.lambdas, res.prices,
                               psi_claimed=res.psi)
    got = port_certify.certify(comp, u, res.deltas, res.lambdas, res.prices,
                               psi_claimed=res.psi, device="cpu")
    for field in ("objective", "dual_bound", "gap_rel", "feasibility_rel"):
        a, b = getattr(got, field), getattr(want, field)
        assert abs(a - b) <= 1e-9 * max(1.0, abs(b)), (field, a, b)
    assert got.gap_abs > -1e-8 and got.gap_rel < 1e-5 and got.feasibility < 1e-8
    prices = res.prices * 1.01  # a looser dual for the polish to tighten
    assert abs(port_certify.dual_bound(comp, u, prices, device="cpu")
               - ref_certify.dual_bound(r_comp, ref_u, prices)) <= 1e-9 * abs(got.dual_bound)
    nu_w = ref_certify.polish_prices(r_comp, ref_u, prices, max_evals=30)
    nu_g = port_certify.polish_prices(comp, u, prices, max_evals=30, device="cpu")
    b_w = ref_certify.dual_bound(r_comp, ref_u, nu_w)
    b_g = port_certify.dual_bound(comp, u, nu_g, device="cpu")
    assert b_g < port_certify.dual_bound(comp, u, prices, device="cpu")
    assert abs(b_g - b_w) <= 1e-9 * abs(b_w), (b_g, b_w)


def test_certify_refine_need_a_conjugate():
    _, spec, _, u = _pair("log", 11)
    n = spec.n_assets
    comp = compile_spec(spec)
    with pytest.raises(ValueError, match="conjugate"):
        port_certify.certify(comp, u, {}, {}, np.zeros(n), device="cpu")
    with pytest.raises(ValueError, match="conjugate"):
        port_certify.dual_bound(comp, u, np.zeros(n), device="cpu")
    solver = AdmmSolver(comp, options=AdmmOptions(max_iters=5), device="cpu")
    with pytest.raises(ValueError, match="conjugate"):
        refine_device(comp, u, solver.solve(u), target_gap=1e-6, device="cpu")
    assert np.array_equal(port_certify.polish_prices(comp, u, np.ones(n), device="cpu"),
                          np.ones(n))


def test_refine_device_certifies_from_reference_base():
    """``tests/test_refine_device.py``'s custom case: the reference's float32
    base, then each package's refine_device to 1e-6."""
    r_spec, spec, ref_u, u = _pair("quad", 13)
    r_comp, comp = ref_compile_spec(r_spec), compile_spec(spec)
    base = RefSolver(r_comp, dtype=jnp.float32,
                     options=RefOptions(max_iters=8000, eps_abs=1e-7, eps_rel=1e-7)
                     ).solve(ref_u)
    want = ref_rd.refine_device(r_comp, ref_u, base, target_gap=1e-6, chunks_per_pass=1)
    assert want.achieved
    b = jax.tree_util.tree_map(np.asarray, base)
    res = route_result_from_numpy(b.objective, b.psi, b.prices, b.deltas, b.lambdas,
                                  b.iters, b.r_norm, b.s_norm, b.converged,
                                  b.rho_final, device="cpu")
    got = refine_device(comp, u, res, target_gap=1e-6, chunks_per_pass=1, device="cpu")
    assert got.achieved, (got.certificate.gap_rel, got.certificate.feasibility_rel)
    assert got.iters == want.iters
    want_obj = want.certificate.objective
    assert abs(got.certificate.objective - want_obj) <= 1e-5 * max(1.0, abs(want_obj))


def test_warm_start_from_converged_reference(quad_solved):
    r_spec, spec, ref_u, u, res = quad_solved
    tight = AdmmOptions(max_iters=40000, eps_abs=1e-10, eps_rel=1e-10)
    warm = route_result_from_numpy(res.objective, res.psi, res.prices, res.deltas,
                                   res.lambdas, res.iters, res.r_norm, res.s_norm,
                                   res.converged, res.rho_final, dtype=F64, device="cpu")
    again = AdmmSolver(compile_spec(spec), dtype=F64, options=tight, device="cpu").solve(
        u, warm=warm)
    assert bool(again.converged)
    assert int(again.iters) <= max(10, int(res.iters) // 5)
    assert abs(float(again.objective) - float(res.objective)) <= 1e-8


def test_fused_driver_and_precondition_refuse_custom():
    _, spec, _, u = _pair("quad", 13)
    table, obj = random_arbitrage_table(6, 100, seed=1)
    with pytest.raises(TypeError, match="classic path"):
        AdmmSolver(compile_spec(spec, pad_pools_to=128), device="cpu").solve_fused(u, 5)
    with pytest.raises(TypeError, match="classic path"):
        ChunkedDriver(AdmmSolver(compile_spec(spec), device="cpu"), chunk=5).solve(u)
    n = table.n_assets
    cu = CustomUtility(lambda p: p.sum(), np.zeros(n), np.ones(n), 0.0)
    with pytest.raises(TypeError, match="CustomUtility closures"):
        scale_objective(cu, np.ones(n))
    with pytest.raises(TypeError, match="CustomUtility closures"):
        equilibrate(table, cu, d=np.ones(n))


def test_graph_key_holds_a_custom_utility_by_identity():
    _, _, _, u = _pair("quad", 13)
    _, _, _, v = _pair("quad", 13)
    assert graphs._meta(u) == graphs._meta(u)
    assert graphs._meta(u) != graphs._meta(v)
    assert hash(graphs._meta(u)) == hash(graphs._meta(u))
    assert graphs._meta(u)[1].obj is u


def test_graph_key_by_identity_only_for_custom_utilities():
    """Only a custom utility is keyed by identity: any other leaf that cannot
    be hashed makes the key raise, as before; a block's constants hold a
    custom utility as a leaf or as a ``DeltaCustomUtility`` node."""
    from torch.utils import _pytree as pytree

    _, _, _, u = _pair("quad", 13)
    with pytest.raises(TypeError):
        hash(graphs._meta(np.zeros(3)))
    dc = prox.DeltaCustomUtility(u.fn, 1.0, 80, *(torch.zeros(5) for _ in range(5)))
    assert all(isinstance(x, torch.Tensor) for x in pytree.tree_leaves(dc))
    for consts, want in (((torch.zeros(2), u), True), ((torch.zeros(2), dc), True),
                         ((torch.zeros(2), None, 1.0), False)):
        leaves, spec = pytree.tree_flatten(consts)
        assert graphs._holds_custom(leaves, spec) is want
