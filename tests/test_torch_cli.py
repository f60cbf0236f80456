"""The port's JSON problem I/O, command line and figures against the JAX
package's, on the CPU and in-process (``main(argv)``, no subprocess).

* serde: the round trips of ``tests/test_workload_surface.py``, and the
  port's JSON of a spec is the reference's, character for character;
* ``export-reference``: the same document as the reference's, for all
  three instances;
* ``solve --f64 --certify --json`` on the arbitrage instance: the
  reference's objective to 1e-6 (in float64 on the CPU both run the same
  iterations), the BASELINE.md pin to 1e-6, a certified gap below 1e-6;
* ``solve --refine-to 1e-6`` (``CFMM_FORCE_CPU``, float32) certifies;
* a problem file with no objective exits 2; without a card and without
  ``--f64`` or ``CFMM_FORCE_CPU`` the command raises;
* ``save_sweep_figures`` writes both figures with the Agg backend.
"""
import json

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from cfmm_routing_tpu.__main__ import main as ref_main  # noqa: E402
from cfmm_routing_tpu.models import pools as ref_pools  # noqa: E402
from cfmm_routing_tpu.solver.compiler import ProblemSpec as RefSpec  # noqa: E402
from cfmm_routing_tpu.utils import serde as ref_serde  # noqa: E402
from cfmm_routing_tpu_torch import api  # noqa: E402
from cfmm_routing_tpu_torch.__main__ import main  # noqa: E402
from cfmm_routing_tpu_torch.models.pools import (  # noqa: E402
    BoundedProductPool,
    ConstantSumPool,
    GeoMeanPool,
    ProductPool,
)
from cfmm_routing_tpu_torch.models.reference_instances import (  # noqa: E402
    arbitrage_instance,
    two_asset_instance,
)
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions  # noqa: E402
from cfmm_routing_tpu_torch.solver.compiler import ProblemSpec  # noqa: E402
from cfmm_routing_tpu_torch.utils.serde import (  # noqa: E402
    load_problem,
    objective_from_json,
    spec_from_json,
    spec_to_json,
)

torch.set_num_threads(1)

ARBITRAGE_PIN = 21.499805


def _pools(mod):
    return [
        mod.GeoMeanPool((0, 1, 2), [4, 4, 4], [3, 2, 1], fee=0.998),
        mod.ProductPool((0, 1), [10, 1], fee=0.997),
        mod.ConstantSumPool((2, 3), [10, 10], fee=0.999),
        mod.ConstantSumPool((0, 3), [5, 6], weights=[1.0, 2.0], fee=0.999),
        mod.BoundedProductPool((1, 3), [1, 2], [5, 5], fee=0.997),
    ]


def test_spec_json_roundtrip_and_reference_schema():
    class Port:
        GeoMeanPool, ProductPool = GeoMeanPool, ProductPool
        ConstantSumPool, BoundedProductPool = ConstantSumPool, BoundedProductPool

    spec = ProblemSpec(n_assets=4, pools=_pools(Port))
    text = spec_to_json(spec)
    assert text == ref_serde.spec_to_json(RefSpec(4, _pools(ref_pools)))
    spec2 = spec_from_json(text)
    assert spec2.n_assets == spec.n_assets
    for a, b in zip(spec.pools, spec2.pools):
        assert type(a) is type(b)
        assert a.assets == b.assets
        np.testing.assert_allclose(a.reserves, b.reserves)
        np.testing.assert_allclose(a.weights, b.weights)
        np.testing.assert_allclose(a.shift, b.shift)
        assert a.fee == b.fee


def test_objective_json_forms():
    o = objective_from_json({"workload": "arbitrage", "market_values": [1, 2]}, 2)
    np.testing.assert_allclose(o.c, [1, 2])
    o = objective_from_json(
        {"workload": "liquidation", "numeraire": 1, "holdings": [3, 0]}, 2
    )
    assert o.lo[0] == o.hi[0] == -3.0
    o = objective_from_json({"workload": "trade", "receive": 1, "holdings": [5, 0]}, 2)
    assert o.lo[0] == -5.0 and not np.isfinite(o.hi[0])
    with pytest.raises(ValueError, match="unknown workload"):
        objective_from_json({"workload": "nope"}, 2)
    with pytest.raises(ValueError, match="unknown pool type"):
        spec_from_json({"n_assets": 1, "pools": [{"type": "weird"}]})


def test_load_problem_roundtrip(tmp_path):
    spec, obj = arbitrage_instance()
    doc = json.loads(spec_to_json(spec))
    doc["objective"] = {"workload": "arbitrage", "market_values": obj.c.tolist()}
    path = tmp_path / "p.json"
    path.write_text(json.dumps(doc))
    spec2, obj2 = load_problem(str(path))
    assert spec2.n_assets == spec.n_assets
    np.testing.assert_allclose(obj2.c, obj.c)
    ref_spec, ref_obj = ref_serde.load_problem(str(path))
    assert spec_to_json(spec2) == ref_serde.spec_to_json(ref_spec)
    np.testing.assert_array_equal(obj2.lo, ref_obj.lo)


@pytest.mark.parametrize("name", ["arbitrage", "liquidation", "two-asset"])
def test_export_reference_is_the_references(name, capsys):
    assert main(["export-reference", name]) == 0
    ours = capsys.readouterr().out
    assert ref_main(["export-reference", name]) == 0
    assert ours == capsys.readouterr().out
    assert json.loads(ours)["objective"]["workload"] in ("arbitrage", "liquidation",
                                                         "trade")


def _export(tmp_path, capsys, name="arbitrage"):
    assert main(["export-reference", name]) == 0
    path = tmp_path / f"{name}.json"
    path.write_text(capsys.readouterr().out)
    return str(path)


def test_solve_f64_certify_matches_reference(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("CFMM_FORCE_CPU", raising=False)
    path = _export(tmp_path, capsys)
    assert main(["solve", path, "--f64", "--certify", "--json"]) == 0
    ours = json.loads(capsys.readouterr().out)
    assert ref_main(["solve", path, "--f64", "--certify", "--json"]) == 0
    theirs = json.loads(capsys.readouterr().out)
    assert abs(ours["objective"] - theirs["objective"]) <= 1e-6 * abs(theirs["objective"])
    assert abs(ours["objective"] - ARBITRAGE_PIN) <= 1e-6 * ARBITRAGE_PIN
    assert abs(ours["certificate"]["rel_gap"]) < 1e-6
    assert ours["certificate"]["feasibility"] < 1e-9
    assert set(ours) == set(theirs) and set(ours["certificate"]) == set(
        theirs["certificate"])


def test_cli_refine_to_certifies(tmp_path, capsys, monkeypatch):
    path = _export(tmp_path, capsys)
    monkeypatch.setenv("CFMM_FORCE_CPU", "1")
    assert main(["solve", path, "--refine-to", "1e-6", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert abs(out["objective"] - ARBITRAGE_PIN) < 1e-4
    assert abs(out["certificate"]["rel_gap"]) <= 1e-6
    assert out["converged"] is True


def test_cli_missing_objective_and_no_card(tmp_path, capsys, monkeypatch):
    spec, _ = arbitrage_instance()
    path = tmp_path / "noobj.json"
    path.write_text(spec_to_json(spec))
    assert main(["solve", str(path)]) == 2
    assert "no 'objective'" in capsys.readouterr().err
    # the card by default: without one (and without --f64 or CFMM_FORCE_CPU)
    # the command raises instead of running on the CPU
    monkeypatch.delenv("CFMM_FORCE_CPU", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    full = _export(tmp_path, capsys)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["solve", full, "--json"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["sweep", full, "--give", "0", "--receive", "2", "--points", "3"])


def test_sweep_figures(tmp_path):
    from cfmm_routing_tpu_torch.utils.plotting import save_sweep_figures

    spec, _ = two_asset_instance()
    sw = api.sweep(spec, 0, 2, np.linspace(0.0, 10.0, 3), device="cpu",
                   options=AdmmOptions(max_iters=20))
    f1, f2 = tmp_path / "flows.png", tmp_path / "u.png"
    save_sweep_figures(sw, str(f1), str(f2))
    assert f1.stat().st_size > 1000
    assert f2.stat().st_size > 1000
