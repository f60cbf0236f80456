"""The PyTorch port stands alone: no JAX, no reference package, no silent CPU.

* No module of ``cfmm_routing_tpu_torch/`` (nor ``chip_smoke.py``, the
  sharded tests' rank script ``tests/torch_ranks.py`` or the port's
  examples ``examples/*_torch.py``) imports ``jax`` or
  ``cfmm_routing_tpu`` — checked on the source, so a lazy import inside a
  function is caught too.
* The package, its command line and its host extras import in a fresh
  interpreter where ``jax`` cannot load; ``utils.plotting`` imports where
  ``matplotlib`` cannot.
* Entry points default to the card: with no CUDA device and no
  ``device=`` they raise instead of running on the CPU.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cfmm_routing_tpu_torch import api
from cfmm_routing_tpu_torch.models.reference_instances import arbitrage_instance
from cfmm_routing_tpu_torch.parallel.mesh import pool_mesh
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions, AdmmSolver
from cfmm_routing_tpu_torch.solver.compiler import compile_spec
from cfmm_routing_tpu_torch.solver.fold import solve_batch_folded
from cfmm_routing_tpu_torch.solver.refine_device import refine_device

REPO = Path(__file__).resolve().parent.parent
_FORBIDDEN = ("jax", "jaxlib", "cfmm_routing_tpu")


def _sources():
    files = sorted((REPO / "cfmm_routing_tpu_torch").rglob("*.py"))
    examples = sorted((REPO / "examples").glob("*_torch.py"))
    assert len(examples) == 3
    return files + examples + [REPO / "chip_smoke.py", REPO / "tests" / "torch_ranks.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_reference_package():
    files = _sources()
    assert len(files) > 10 and all(f.exists() for f in files)
    bad = [
        (str(f.relative_to(REPO)), root)
        for f in files
        for root in _imported_roots(f)
        if root in _FORBIDDEN
    ]
    assert bad == []


def test_package_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['cfmm_routing_tpu'] = None\n"
        "import cfmm_routing_tpu_torch, cfmm_routing_tpu_torch.convert\n"
        "import cfmm_routing_tpu_torch.utils.synth\n"
        "import cfmm_routing_tpu_torch.models.reference_instances\n"
        "import cfmm_routing_tpu_torch.solver.refine_device\n"
        "import cfmm_routing_tpu_torch.solver.fold, cfmm_routing_tpu_torch.solver.driver\n"
        "import cfmm_routing_tpu_torch.solver.residuals\n"
        "import cfmm_routing_tpu_torch.parallel.mesh, cfmm_routing_tpu_torch.parallel.sharded\n"
        "import cfmm_routing_tpu_torch.native, cfmm_routing_tpu_torch.__main__\n"
        "import cfmm_routing_tpu_torch.oracle, cfmm_routing_tpu_torch.utils.serde\n"
        "import cfmm_routing_tpu_torch.utils.plotting, cfmm_routing_tpu_torch.utils.profiling\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_plotting_imports_with_matplotlib_blocked():
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        "import cfmm_routing_tpu_torch.utils.plotting as p\n"
        "assert callable(p.save_sweep_figures)\n"
        "try:\n"
        "    p.plot_sweep_utility(None)\n"
        "except ImportError:\n"
        "    print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec, obj = arbitrage_instance()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AdmmSolver(compile_spec(spec))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.arbitrage(spec, obj.c)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.arbitrage(spec, obj.c, refine_to=1e-6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.sweep(spec, 0, 2, [1.0, 2.0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_batch_folded(compile_spec(spec), np.tile(obj.c, (2, 1)),
                           np.tile(obj.lo, (2, 1)), np.tile(obj.hi, (2, 1)))
    with pytest.raises(RuntimeError, match="platform='cpu'"):
        pool_mesh()
    # asked for explicitly, the CPU works
    on_cpu = AdmmSolver(compile_spec(spec), device="cpu",
                        options=AdmmOptions(max_iters=1))
    assert on_cpu.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        refine_device(on_cpu.compiled, obj, on_cpu.solve(obj))
