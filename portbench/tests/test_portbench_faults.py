"""The harness drives a run with the timed path broken underneath and sees
``correct`` come out false, once for each fault the route cell can have:
a step that returns its state unchanged, half of the batch (the pools)
left out, and an answer altered where it is produced.  The cell runs on one
chip, so it has no exchange between chips to leave out.  The look for a
chip is skipped: the program runs its plain paths on the CPU."""
import dataclasses

import numpy as np

from cfmm_routing_tpu_torch import api
from cfmm_routing_tpu_torch.solver.admm import AdmmSolver
from cfmm_routing_tpu_torch.solver.refine_device import DeltaAdmmSolver
from portbench.tests.conftest import run_cell


def test_sound_run_is_correct(tiny, capsys):
    rc, res, _ = run_cell(capsys, "route-100k-block")
    assert rc == 0 and res["correct"] is True


def test_step_returning_its_state_unchanged(tiny, capsys, monkeypatch):
    """Every ADMM step, of the base solve and of the refinement, hands back
    the state it was given."""
    for cls in (AdmmSolver, DeltaAdmmSolver):
        orig = cls._iterate

        def unchanged(self, z, nu, *a, _orig=orig, **k):
            _, _, psi, w, stats = _orig(self, z, nu, *a, **k)
            return z, nu, psi, w, stats

        monkeypatch.setattr(cls, "_iterate", unchanged)
    rc, res, _ = run_cell(capsys, "route-100k-block")
    assert rc == 0 and res["correct"] is False and res["failed"] >= 1


def test_half_the_pools_left_out(tiny, capsys, monkeypatch):
    """The trades of every second pool never reach the answer."""
    orig = AdmmSolver.unbucket

    def half(self, result):
        deltas, lambdas = orig(self, result)
        for i in range(0, len(deltas), 2):
            deltas[i] = np.zeros_like(deltas[i])
            lambdas[i] = np.zeros_like(lambdas[i])
        return deltas, lambdas

    monkeypatch.setattr(AdmmSolver, "unbucket", half)
    rc, res, _ = run_cell(capsys, "route-100k-block")
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["feas"]["value"] > res["checks"]["feas"]["limit"]


def test_answer_altered_where_produced(tiny, capsys, monkeypatch):
    """One pool's received amounts grow by half as the route is built."""
    orig = api._route_from

    def altered(*a, **k):
        route = orig(*a, **k)
        lambdas = list(route.lambdas)
        lambdas[0] = lambdas[0] * 1.5 + 1e-3
        return dataclasses.replace(route, lambdas=lambdas)

    monkeypatch.setattr(api, "_route_from", altered)
    rc, res, _ = run_cell(capsys, "route-100k-block")
    assert rc == 0 and res["correct"] is False
