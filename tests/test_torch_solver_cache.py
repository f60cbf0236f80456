"""The solvers a route builds for itself, kept across routes of one network
(``solver/_solver_cache.py``), on the CPU: a second route on a network
takes both of the first's solvers and answers bitwise as new solvers do; a
network with one more pool misses; two networks routed in turns each hit
their own entries; a caller's ``solver=``, a route that raises and the
cache's bound; several threads never share a solver.  The card case (the
second route captures nothing) is in ``tests/test_torch_gpu.py``.  The
file imports no JAX."""
import dataclasses
import sys
import threading
import time

import numpy as np
import pytest
import torch

from cfmm_routing_tpu_torch import api
from cfmm_routing_tpu_torch.models.reference_instances import arbitrage_instance
from cfmm_routing_tpu_torch.models.pools import ProductPool
from cfmm_routing_tpu_torch.ops.projection import ProjectionConfig
from cfmm_routing_tpu_torch.solver import _solver_cache
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver
from cfmm_routing_tpu_torch.solver.compiler import PoolTable, ProblemSpec, compile_table
from cfmm_routing_tpu_torch.utils import profiling
from cfmm_routing_tpu_torch.utils.synth import random_network_table

# a short base solve, so that the refinement has a chunk of work left
OPTS = AdmmOptions(max_iters=25, eps_abs=1e-7, eps_rel=1e-7, check_every=25,
                   projection=ProjectionConfig(8, 2))
SPEC, OBJ = arbitrage_instance()


@pytest.fixture(autouse=True)
def _empty_cache():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    _solver_cache.clear()
    profiling.reset()
    try:
        yield
    finally:
        _solver_cache.clear()
        torch.set_num_threads(n)


def _block(k, spec=SPEC):
    """The network at block ``k``: every reserve scaled by exp(N(0, 0.2))."""
    table = PoolTable.from_spec(spec)
    rng = np.random.default_rng(k)
    return dataclasses.replace(
        table, reserves=table.reserves * np.exp(rng.normal(0.0, 0.2, table.reserves.shape)))


def _reused():
    return profiling.COUNTS.get("solvers.reused", 0)


def _kept():
    return [(key, id(s)) for key, s in _solver_cache._KEPT.items()]


def _leaves(route):
    """Every number a Route carries, certificate fields included."""
    leaves = [route.objective, route.psi, route.prices, route.iters, route.converged,
              route.r_norm, route.s_norm, *route.deltas, *route.lambdas]
    if route.certificate is not None:
        cert = route.certificate
        leaves += [getattr(cert, f.name) for f in dataclasses.fields(cert)]
    return [np.asarray(x) for x in leaves]


def _assert_bitwise(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        np.testing.assert_array_equal(x, y)


def test_second_route_takes_both_solvers_and_answers_bitwise():
    """Block A then block B: B's route takes the kept base and correction
    solvers (``solvers.reused`` + 2) and equals, bit for bit, B's route on
    new solvers; A's and B's answers differ, so stale arrays would show."""
    kw = dict(precondition=True, refine_to=1e-3, options=OPTS, device="cpu")
    a = api.route(_block(1), OBJ, **kw)
    assert _reused() == 0 and len(_solver_cache._KEPT) == 2
    assert profiling.COUNTS["iters.refine"] > 0  # the correction solver ran
    b = api.route(_block(2), OBJ, **kw)
    assert _reused() == 2
    _solver_cache.clear()
    fresh = api.route(_block(2), OBJ, **kw)
    assert _reused() == 2
    assert a.converged and b.converged
    assert a.objective != b.objective
    assert not np.array_equal(np.concatenate(a.deltas), np.concatenate(b.deltas))
    _assert_bitwise(b, fresh)


def test_one_more_pool_misses():
    kw = dict(precondition=True, options=OPTS, device="cpu")
    api.route(_block(1), OBJ, **kw)
    grown = ProblemSpec(SPEC.n_assets, [*SPEC.pools, ProductPool((0, 3), (5.0, 7.0))])
    api.route(_block(1, grown), OBJ, **kw)
    assert _reused() == 0 and len(_solver_cache._KEPT) == 2


def test_two_networks_in_turns_hit_their_own_entries():
    """Routes without ``precondition`` on two networks in turns: the third
    and fourth take the first's and the second's solver, bitwise as new."""
    other = ProblemSpec(SPEC.n_assets, SPEC.pools[:4])
    kw = dict(options=OPTS, device="cpu", certify=True)
    api.route(_block(1), OBJ, **kw)
    api.route(_block(1, other), OBJ, **kw)
    assert _reused() == 0 and len(_solver_cache._KEPT) == 2
    got = [api.route(_block(k, spec), OBJ, **kw)
           for k, spec in ((2, SPEC), (3, other))]
    assert _reused() == 2 and len(_solver_cache._KEPT) == 2
    _solver_cache.clear()
    for route, (k, spec) in zip(got, ((2, SPEC), (3, other))):
        _assert_bitwise(route, api.route(_block(k, spec), OBJ, **kw))


def test_a_callers_solver_leaves_the_cache_alone():
    kw = dict(options=OPTS, device="cpu")
    api.route(_block(1), OBJ, **kw)
    before = _kept()
    solver = api.make_solver(_block(2), **kw)
    got = api.route(_block(2), OBJ, solver=solver, certify=True)
    assert _kept() == before and _reused() == 0
    _assert_bitwise(got, api.route(_block(2), OBJ, certify=True, **kw))


def test_a_route_that_raises_puts_nothing_back(monkeypatch):
    kw = dict(precondition=True, options=OPTS, device="cpu")
    api.route(_block(1), OBJ, **kw)
    assert len(_solver_cache._KEPT) == 1

    def fails(self, *a, **k):
        raise RuntimeError("solve failed")

    monkeypatch.setattr(AdmmSolver, "solve", fails)
    with pytest.raises(RuntimeError, match="solve failed"):
        api.route(_block(2), OBJ, **kw)
    assert _reused() == 1 and len(_solver_cache._KEPT) == 0


class _Stub:
    """A solver class for the cache alone: records its builds."""

    built = 0

    def __init__(self, compiled, dtype, options, device):
        type(self).built += 1
        self.compiled = compiled
        self.holder = None

    def _refresh(self, compiled):
        self.compiled = compiled


def _networks(count):
    return [compile_table(random_network_table(4, 3 + i, seed=i)) for i in range(count)]


def test_cache_keeps_the_most_recent_and_nothing_outside_a_lease():
    nets = _networks(_solver_cache._CAP + 2)
    _Stub.built = 0
    first = _solver_cache.own(_Stub, nets[0], torch.float32, OPTS, "cpu")
    assert _solver_cache.own(_Stub, nets[0], torch.float32, OPTS, "cpu") is not first
    assert len(_solver_cache._KEPT) == 0 and _Stub.built == 2
    for c in nets:
        with _solver_cache.lease():
            _solver_cache.own(_Stub, c, torch.float32, OPTS, "cpu")
    assert len(_solver_cache._KEPT) == _solver_cache._CAP
    for c in (nets[0], nets[1], nets[-1]):  # the two oldest went
        with _solver_cache.lease():
            _solver_cache.own(_Stub, c, torch.float32, OPTS, "cpu")
    assert _reused() == 1 and _Stub.built == 2 + len(nets) + 2


def test_concurrent_leases_never_share_a_solver():
    """Sixteen threads route one network 40 times each: a solver is held by
    one lease at a time, and each lease that finds one kept takes it."""
    net = _networks(1)[0]
    errors = []

    def worker(me):
        try:
            for _ in range(40):
                with _solver_cache.lease():
                    s = _solver_cache.own(_Stub, net, torch.float32, OPTS, "cpu")
                    if s.holder is not None:
                        errors.append(f"{me} took {s.holder}'s solver")
                    s.holder = me
                    time.sleep(0)  # let another thread run while it is held
                    s.holder = None
        except Exception as exc:  # noqa: BLE001  reported below
            errors.append(repr(exc))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert len(_solver_cache._KEPT) == 1
    assert _reused() > 0
