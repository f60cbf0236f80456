"""The port's spans and counters (``utils/profiling.py``) on the CPU: a
certified route records nothing with the profiler off and its tree of
spans with it on, on the profiler's clock; the iteration counters equal
the solvers' own counts; the record is bounded.  The card case (graph
captures once per solver) is marked ``gpu``; the file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_tracing.py -m gpu
"""
import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cfmm_routing_tpu_torch import api
from cfmm_routing_tpu_torch.models.reference_instances import arbitrage_instance
from cfmm_routing_tpu_torch.models.utility import CustomUtility
from cfmm_routing_tpu_torch.ops.projection import ProjectionConfig
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver
from cfmm_routing_tpu_torch.solver.compiler import compile_spec
from cfmm_routing_tpu_torch.solver.refine_device import refine_device, refine_sweep
from cfmm_routing_tpu_torch.utils import profiling

# the benchmark cell's options (portbench/traffic/block-route.json)
OPTIONS = AdmmOptions(max_iters=3000, eps_abs=1e-7, eps_rel=1e-7, check_every=25,
                      projection=ProjectionConfig(24, 4))
# a short base solve for the counter cases
SHORT = AdmmOptions(max_iters=60, eps_abs=1e-12, eps_rel=1e-12, check_every=10,
                    projection=ProjectionConfig(24, 4))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _route():
    spec, obj = arbitrage_instance()
    return api.route(spec, obj, precondition=True, refine_to=1e-6, options=OPTIONS,
                     device="cpu")


@pytest.fixture(scope="module")
def traced():
    """One route under ``torch.profiler``: (its records, the counters, the
    Route, the profiler's user annotations as (name, start_ns, end_ns))."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        profiling.reset()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            route = _route()
        marks = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
                 for ev in prof.profiler.kineto_results.events()
                 if ev.activity_type() == "user_annotation"]
        return profiling.spans(), dict(profiling.COUNTS), route, marks
    finally:
        torch.set_num_threads(n)


def test_route_records_nothing_without_the_profiler():
    """(a) Profiler off: no span recorded, the counters advance."""
    assert not torch.autograd._profiler_enabled()
    profiling.reset()
    route = _route()
    assert profiling.spans() == []
    base = profiling.COUNTS["iters.base"]
    # Route.iters: the base's iterations plus the last refinement chunk's
    assert base <= route.iters <= base + profiling.COUNTS.get("iters.refine", 0)


def test_traced_route_records_its_tree(traced):
    """(b) One root ``route``; every span carries its request id and lies
    inside its parent; the set-up, the solve's checks and the certificate
    are there; the root holds the counters' changes."""
    records, counts, route, _ = traced
    roots = [r for r in records if r.parent_id is None]
    assert [r.name for r in roots] == ["route"]
    root = roots[0]
    assert all(r.request_id == root.span_id for r in records)
    by_id = {r.span_id: r for r in records}
    for r in records:
        assert r.start_ns <= r.end_ns
        if r.parent_id is not None:
            parent = by_id[r.parent_id]
            assert parent.start_ns <= r.start_ns and r.end_ns <= parent.end_ns
    names = collections.Counter(r.name for r in records)
    assert names["route.compile"] == 2 and names["route.equilibrate"] == 1
    assert names["admm.check"] >= 1 and names["certify"] >= 1
    assert names["refine"] == 1 and names["solver.build"] >= 1
    assert {by_id[r.parent_id].name for r in records if r.name == "admm.check"} == {
        "admm.solve"}
    assert {by_id[r.parent_id].name for r in records if r.name == "route.compile"} == {
        "route"}
    assert root.counts == counts and counts["iters.base"] > 0
    assert route.converged


def test_records_share_the_profilers_clock(traced):
    """(c) Each record starts and ends within 1 ms of the profiler's
    annotation of the same span."""
    records, _, _, marks = traced
    ours = collections.defaultdict(list)
    theirs = collections.defaultdict(list)
    for r in records:
        ours[r.name].append((r.start_ns, r.end_ns))
    for name, s, e in marks:
        theirs[name].append((s, e))
    assert set(ours) == set(theirs)
    for name in ours:
        assert len(ours[name]) == len(theirs[name]), name
        for (s, e), (ps, pe) in zip(sorted(ours[name]), sorted(theirs[name])):
            assert abs(s - ps) <= 1_000_000 and abs(e - pe) <= 1_000_000, name


@pytest.mark.parametrize("path", ["classic", "fused", "batch"])
def test_base_counter_is_the_solves_iterations(path):
    """(d) ``iters.base`` adds what the base solve reports."""
    spec, obj = arbitrage_instance()
    if path == "fused":
        solver = AdmmSolver(compile_spec(spec, pad_pools_to=128), options=SHORT,
                            device="cpu")
        profiling.reset()
        want = int(solver.solve_fused(obj, iters=30).iters)
    elif path == "batch":
        solver = AdmmSolver(compile_spec(spec), options=SHORT, device="cpu")
        c = np.stack([obj.c, 2 * np.asarray(obj.c)])
        lo, hi = np.zeros_like(c), np.full_like(c, 1e6)
        profiling.reset()
        want = int(solver.solve_batch(c, lo, hi).iters.max())
    else:
        solver = AdmmSolver(compile_spec(spec), options=SHORT, device="cpu")
        profiling.reset()
        want = int(solver.solve(obj).iters)
    assert want > 0 and profiling.COUNTS == {"iters.base": want}


def _custom_quadratic(obj, curvature=0.1):
    """U(psi) = c @ psi - curvature |psi|^2 / 2 on [0, 50], with its box-free
    conjugate |c - nu|^2 / (2 curvature)."""
    c = np.asarray(obj.c, np.float64)
    ct = torch.as_tensor(c)
    return CustomUtility(
        lambda p: torch.dot(ct.to(p), p) - 0.5 * curvature * torch.dot(p, p),
        np.zeros_like(c), np.full_like(c, 50.0), smoothness=curvature,
        prox_iters=10,
        conjugate=lambda nu: float((c - nu) @ (c - nu)) / (2.0 * curvature))


@pytest.mark.parametrize("entry", ["refine_device", "refine_sweep", "custom"])
def test_refine_counter_is_the_refinements_iterations(entry):
    """(d) ``iters.refine`` adds every correction chunk's iterations, what
    the refinement reports, and ``checks.refine`` the checked ones among
    them: one a cadence of 10 for ``refine_device(chunk_iters=10)``, every
    one for ``refine_sweep``'s classic fold and for a ``CustomUtility``
    (check_every 1); its delta solver adds nothing to ``iters.base``."""
    spec, obj = arbitrage_instance()
    compiled = compile_spec(spec)
    solver = AdmmSolver(compiled, options=SHORT, device="cpu")
    if entry == "refine_sweep":
        c = np.stack([obj.c, 2 * np.asarray(obj.c)])
        lo, hi = np.zeros_like(c), np.full_like(c, np.inf)
        res = solver.solve_batch(c, lo, np.full_like(c, 1e6))
        profiling.reset()
        got = refine_sweep(compiled, c, lo, hi, res, target_gap=1e-12, max_passes=1,
                           iters_per_pass=10, device="cpu").iters
        checks = got
    else:
        if entry == "custom":
            obj = _custom_quadratic(obj)
        res = solver.solve(obj)
        profiling.reset()
        got = refine_device(compiled, obj, res, target_gap=1e-12, max_passes=1,
                            chunk_iters=10, chunks_per_pass=3, device="cpu").iters
        checks = got if entry == "custom" else got // 10
    assert got > 0 and profiling.COUNTS == {"iters.refine": got, "checks.refine": checks}


def test_spans_nest_by_request_and_roots_carry_counter_changes():
    profiling.reset()
    profiling.count("before", 5)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("a"):
            profiling.count("k", 2)
            with profiling.span("b"):
                profiling.count("k")
        with pytest.raises(ValueError), profiling.span("c"):
            raise ValueError("closes the span all the same")
        with profiling.span("d"):
            pass
    b, a, c, d = profiling.spans()
    assert (a.parent_id, b.parent_id, c.parent_id) == (None, a.span_id, None)
    assert b.request_id == a.request_id != c.request_id != d.request_id
    assert a.counts == {"k": 3} and b.counts is None and c.counts == d.counts == {}
    assert profiling.COUNTS == {"before": 5, "k": 3}


def test_record_is_bounded_and_reset_clears_it(monkeypatch):
    """(e) The oldest records go first; ``reset`` forgets records and counters."""
    assert profiling._RECORDS.maxlen == 65_536
    monkeypatch.setattr(profiling, "_RECORDS", collections.deque(maxlen=8))
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(20):
            with profiling.span("x"):
                pass
    kept = profiling.spans()
    assert len(kept) == 8
    assert [r.span_id for r in kept] == list(range(kept[0].span_id, kept[0].span_id + 8))
    profiling.count("c")
    profiling.reset()
    assert profiling.spans() == [] and profiling.COUNTS == {}


@pytest.mark.gpu
def test_graph_capture_once_per_solver():
    """(f) On the card a solver's second solve replays what its first
    captured; a new solver's first solve captures anew."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graphs are captured on the card only")
    spec, obj = arbitrage_instance()
    compiled = compile_spec(spec)
    opts = AdmmOptions(max_iters=100, eps_abs=1e-12, eps_rel=1e-12, check_every=25)
    solver = AdmmSolver(compiled, options=opts, device="cuda")
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        solver.solve(obj)
        solver.solve(obj)
        AdmmSolver(compiled, options=opts, device="cuda").solve(obj)
    records = profiling.spans()
    solves = [r for r in records if r.name == "admm.solve"]
    assert len(solves) == 3 and all(r.parent_id is None for r in solves)
    captures = collections.Counter(r.request_id for r in records
                                   if r.name == "graphs.capture")
    assert [captures[r.request_id] for r in solves] == [1, 0, 1]
    assert any(r.name == "host.sync" for r in records)
