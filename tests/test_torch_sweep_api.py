"""``api.sweep``: the port against the JAX package on the CPU, on the
reference's two-asset frontier (``two-asset.py``).

* ``api.sweep(certify=True)`` at 3 trade sizes: the batched float32 solve
  and its float64 certificates follow the reference's (same iteration
  counts, utilities to 1e-5).
* ``api.sweep(refine_to=1e-6)``: every point certified, u(25) = 31.005495
  to 2e-6, the utilities within 2e-6 of the reference's, and a point the
  batched refinement leaves short goes through ``refine_device`` alone.
  The plain root-find costs ~20-30 ms per iteration here, so the sweep
  refinement runs 40 iterations per chunk instead of 1000.
"""
import numpy as np
import torch

from cfmm_routing_tpu import api as ref_api
from cfmm_routing_tpu.models.reference_instances import two_asset_instance as ref_two
from cfmm_routing_tpu.solver import admm as ref_admm
from cfmm_routing_tpu_torch import api
from cfmm_routing_tpu_torch.models.reference_instances import two_asset_instance
from cfmm_routing_tpu_torch.solver import refine_device as rd
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions

torch.set_num_threads(1)

AMOUNTS = np.array([2.0, 25.0, 40.0])  # they stop at 3 different counts
BASE = dict(max_iters=3000, eps_abs=1e-5, eps_rel=1e-5, check_every=25)


def _score(ct):
    return max(abs(ct.gap_rel), ct.feasibility_rel)


def test_sweep_certify_follows_reference():
    spec, _ = two_asset_instance()
    got = api.sweep(spec, 0, 2, AMOUNTS, certify=True, options=AdmmOptions(**BASE),
                    device="cpu")
    want = ref_api.sweep(ref_two()[0], 0, 2, AMOUNTS, certify=True,
                         options=ref_admm.AdmmOptions(**BASE))
    np.testing.assert_array_equal(got.iters, np.asarray(want.iters))
    np.testing.assert_allclose(got.utilities, np.asarray(want.utilities), rtol=1e-5)
    np.testing.assert_allclose(got.prices, np.asarray(want.prices), rtol=1e-4, atol=1e-4)
    for t, (p, r) in enumerate(zip(got.certificates, want.certificates)):
        np.testing.assert_allclose(p.objective, r.objective, rtol=1e-5)
        np.testing.assert_allclose(p.dual_bound, r.dual_bound, rtol=1e-5)
        assert np.isfinite([p.gap_rel, p.feasibility_rel]).all()
    assert len(got.net_trades) == len(want.net_trades) == len(spec.pools)
    for g, w in zip(got.net_trades, want.net_trades):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4)


def test_sweep_refine_to_certifies_every_point(monkeypatch):
    """The batched refinement, then the per-point ``refine_device`` for a
    point it leaves short (here: point 0, marked so by the test)."""
    refine_sweep, refine_device = rd.refine_sweep, rd.refine_device
    stragglers = []

    def sweep_leaving_point_0(*a, **k):
        out = refine_sweep(*a, iters_per_pass=40, **k)
        out.achieved[0] = False
        return out

    def refine_point(compiled, obj, point, **k):
        stragglers.append(float(obj.lo[0]))
        return refine_device(compiled, obj, point, **k)

    monkeypatch.setattr(rd, "refine_sweep", sweep_leaving_point_0)
    monkeypatch.setattr(rd, "refine_device", refine_point)
    spec, _ = two_asset_instance()
    amounts = [25.0, 40.0]
    got = api.sweep(spec, 0, 2, amounts, refine_to=1e-6, options=AdmmOptions(**BASE),
                    device="cpu")
    want = ref_api.sweep(ref_two()[0], 0, 2, amounts, refine_to=1e-6,
                         options=ref_admm.AdmmOptions(**BASE))
    assert stragglers == [-25.0]
    assert bool(np.all(got.converged))
    assert all(_score(ct) <= 1e-6 for ct in got.certificates)
    u25 = got.utilities[0]
    assert abs(u25 - 31.005495) / 31.005495 < 2e-6, u25
    np.testing.assert_allclose(got.utilities, np.asarray(want.utilities), rtol=2e-6)
    assert np.isfinite(got.net_trades[0]).all()
