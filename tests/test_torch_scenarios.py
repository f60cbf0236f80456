"""Certified routes over reserve states of one network in one folded solve
(``api.route_scenarios``), on the CPU: the unpadded classic fold path
(``pad_pools_to=None``; the padded fused path is the card test's, in
``tests/test_torch_gpu.py``).

* on a 12-pool / 4-asset network in 3 reserve states, every state's route
  is certified to 1e-6 and its objective is within 2e-6 relative of
  ``api.route`` on that state's own scaled table;
* a second call on the network takes the kept folded solvers and answers
  bit for bit as new solvers do; a state that the folded refinement
  leaves short is finished on its own problem and still certified;
* utilities raise ``TypeError``, a bad ``reserve_scale`` ``ValueError``;
* the counters count ``scenarios.points`` = S a call.

The file imports no JAX."""
import dataclasses

import numpy as np
import pytest
import torch

from cfmm_routing_tpu_torch import api
from cfmm_routing_tpu_torch.models.utility import ConcaveUtility
from cfmm_routing_tpu_torch.ops.projection import ProjectionConfig
from cfmm_routing_tpu_torch.solver import _solver_cache, refine_device
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions
from cfmm_routing_tpu_torch.solver.fold import fold_compiled, scenario_point
from cfmm_routing_tpu_torch.solver.compiler import compile_table
from cfmm_routing_tpu_torch.utils import profiling
from cfmm_routing_tpu_torch.utils.synth import random_arbitrage_table

# the smallest options that certify here: a base that converges at its
# float32 floor in a few hundred iterations, the route cell's projection
OPTS = AdmmOptions(max_iters=400, eps_abs=1e-7, eps_rel=1e-7, check_every=25,
                   projection=ProjectionConfig(24, 4))
TABLE, OBJ = random_arbitrage_table(4, 12, seed=3)
S = 3
GAP = 1e-6


def _scale(seed, states=S):
    return np.random.default_rng(seed).uniform(0.7, 1.3, size=(states, TABLE.n_pools))


def _state(scale, s):
    return dataclasses.replace(TABLE, reserves=TABLE.reserves
                               * np.repeat(scale[s], TABLE.width))


def _scenarios(scale):
    return api.route_scenarios(TABLE, OBJ, scale, precondition=True,
                               refine_to=GAP, pad_pools_to=None, options=OPTS,
                               device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def first():
    """The routes of reserve states ``_scale(5)`` on new solvers, with the
    counters of the call."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    _solver_cache.clear()
    profiling.reset()
    routes = _scenarios(_scale(5))
    counts = dict(profiling.COUNTS)
    torch.set_num_threads(n)
    yield routes, counts
    _solver_cache.clear()


def _leaves(route):
    leaves = [route.objective, route.psi, route.prices, route.iters, route.converged,
              route.r_norm, route.s_norm, *route.deltas, *route.lambdas]
    cert = route.certificate
    leaves += [getattr(cert, f.name) for f in dataclasses.fields(cert)]
    return [np.asarray(x) for x in leaves]


def _same(a, b) -> bool:
    return all(np.array_equal(x, y) for ra, rb in zip(a, b, strict=True)
               for x, y in zip(_leaves(ra), _leaves(rb), strict=True))


def test_every_state_is_certified_and_counted(first):
    routes, counts = first
    assert len(routes) == S
    for r in routes:
        cert = r.certificate
        assert r.converged and cert is not None
        assert abs(cert.gap_rel) <= GAP and cert.feasibility_rel <= GAP
        assert r.objective == cert.objective
        assert len(r.deltas) == TABLE.n_pools
        assert [len(d) for d in r.deltas] == list(TABLE.width)
    assert counts["scenarios.points"] == S
    assert counts.get("scenarios.fallback", 0) == 0
    assert counts["iters.base"] > 0 and counts["iters.refine"] > 0


@pytest.mark.parametrize("s", range(S))
def test_each_state_matches_a_route_on_its_own_table(first, s):
    """Both certified to 1e-6, so the objectives agree to 2e-6 relative;
    the state's trades are feasible on its own reserves (the certificate's
    net trade is the route's psi)."""
    routes, _ = first
    one = api.route(_state(_scale(5), s), OBJ, precondition=True, refine_to=GAP,
                    options=OPTS, device="cpu")
    assert one.converged
    got = routes[s]
    assert abs(got.objective - one.objective) <= 2e-6 * max(1.0, abs(one.objective))
    np.testing.assert_allclose(
        got.psi, np.bincount(TABLE.assets, weights=np.concatenate(got.lambdas)
                             - np.concatenate(got.deltas), minlength=TABLE.n_assets),
        rtol=0, atol=1e-9 * max(1.0, float(np.abs(got.psi).max())))


def test_second_call_takes_kept_solvers_bitwise_and_finishes_short_states(
        first, monkeypatch):
    """Reserve states B after A: the call takes the kept folded base and
    delta solvers and equals, bit for bit, B's call on new solvers.  In
    both calls state 1 is reported short by the folded refinement: it goes
    through ``refine_device`` on its own problem (counted under
    ``scenarios.fallback``) and comes back certified."""
    sweep = refine_device.refine_sweep

    def one_short(*a, **k):
        out = sweep(*a, **k)
        out.achieved[1] = False
        return out

    monkeypatch.setattr(refine_device, "refine_sweep", one_short)
    calls = []
    single = refine_device.refine_device
    monkeypatch.setattr(refine_device, "refine_device",
                        lambda *a, **k: calls.append(1) or single(*a, **k))
    a, _ = first
    profiling.reset()
    b = _scenarios(_scale(6))
    assert profiling.COUNTS.get("solvers.reused", 0) >= 2
    assert calls == [1] and profiling.COUNTS["scenarios.fallback"] == 1
    for r in b:
        assert r.converged and abs(r.certificate.gap_rel) <= GAP
        assert r.certificate.feasibility_rel <= GAP
    _solver_cache.clear()
    profiling.reset()
    want = _scenarios(_scale(6))
    assert profiling.COUNTS.get("solvers.reused", 0) == 0
    assert _same(b, want)
    assert not _same(a, b)


def test_scenario_point_is_the_state_compiled_on_its_own():
    compiled = compile_table(TABLE)
    scale = _scale(8)
    folded = fold_compiled(compiled, S, scale)
    for s in range(S):
        got = scenario_point(compiled, folded, s)
        want = compile_table(_state(scale, s))
        for name, b in want.buckets.items():
            g = got.buckets[name]
            np.testing.assert_allclose(g.reserves, b.reserves, rtol=1e-15)
            np.testing.assert_allclose(g.logk0, b.logk0, rtol=1e-13, atol=1e-13)
            np.testing.assert_array_equal(g.asset, b.asset)


def test_rejects_utilities_and_bad_scales():
    util = ConcaveUtility.from_objective(OBJ).with_log(0, 1.0, 1.0)
    with pytest.raises(TypeError):
        api.route_scenarios(TABLE, util, _scale(5), device="cpu")
    for bad in (_scale(5)[0], _scale(5)[:, :-1], -_scale(5),
                np.full((S, TABLE.n_pools), np.nan), np.ones((0, TABLE.n_pools))):
        with pytest.raises(ValueError):
            api.route_scenarios(TABLE, OBJ, bad, device="cpu")
