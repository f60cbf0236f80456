"""The port's public surface is the JAX package's, sharded names and all.

* ``__all__`` and ``AdmmOptions(onehot_chunk=)``;
* every module of the JAX package but its two Pallas modules has a
  counterpart, and the six host modules define the reference's public
  names;
* the signature walker: for every public function and method that both
  packages define, the reference's parameter names are a subsequence of
  the port's (the port may add ``device=``, ``fold=``, ... between them);
* the two places where the reference's positions or return shapes matter:
  ``solve_fused``'s fifth positional parameter is ``merged``, and
  ``delta_buckets_batch`` returns a triple.
"""
import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import cfmm_routing_tpu
import cfmm_routing_tpu_torch
from cfmm_routing_tpu_torch import (  # noqa: F401
    ChunkedDriver,
    __version__,
    fold_compiled,
    refine_device,
)
from cfmm_routing_tpu_torch.solver.admm import AdmmOptions


def test_all_is_the_reference_all_less_the_sharded_names():
    assert cfmm_routing_tpu_torch.__all__ == cfmm_routing_tpu.__all__
    mod = importlib.import_module("cfmm_routing_tpu_torch")
    missing = [n for n in cfmm_routing_tpu_torch.__all__ if not hasattr(mod, n)]
    assert not missing
    assert cfmm_routing_tpu_torch.__version__ == cfmm_routing_tpu.__version__


def test_admm_options_accepts_onehot_chunk():
    opts = AdmmOptions(onehot_chunk=256)
    assert opts.onehot_chunk == 256
    assert AdmmOptions().onehot_chunk == 512


# ---- the signature walker -----------------------------------------------------

# the JAX package's Pallas modules: the port's kernels sit behind its own
# ops/*_cuda.py wrappers instead
_REFERENCE_ONLY = {"ops.iteration_pallas", "ops.projection_pallas"}
_NEW_MODULES = ("native", "__main__", "oracle", "utils.serde",
                "utils.plotting", "utils.profiling")
# JAX pytree protocol methods: no counterpart in torch
_EXEMPT = {"tree_flatten", "tree_unflatten"}


def _modules(pkg):
    out = {}
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        rel = info.name.split(".", 1)[1]
        if rel.rsplit(".", 1)[-1].startswith("_") and rel != "__main__":
            continue  # private modules (and the reference's built _packer.so)
        out[rel] = info.name
    return out


def _public(mod):
    """name -> function, for the functions and the methods (``__init__``
    included) of the classes that ``mod`` defines."""
    out = {}
    for name, obj in vars(mod).items():
        if name.startswith("_") or getattr(obj, "__module__", None) != mod.__name__:
            continue
        if inspect.isfunction(obj):
            out[name] = obj
        elif inspect.isclass(obj):
            out[name] = obj
            for mname, meth in vars(obj).items():
                if (mname.startswith("_") and mname != "__init__") or mname in _EXEMPT:
                    continue
                if isinstance(meth, (staticmethod, classmethod)):
                    meth = meth.__func__
                if inspect.isfunction(meth):
                    out[f"{name}.{mname}"] = meth
    return out


def _is_subsequence(names, of):
    it = iter(of)
    return all(n in it for n in names)


def test_every_reference_module_has_its_port():
    ref, port = _modules(cfmm_routing_tpu), _modules(cfmm_routing_tpu_torch)
    assert set(ref) - set(port) == _REFERENCE_ONLY
    for rel in _NEW_MODULES:
        want = {n for n in _public(importlib.import_module(ref[rel]))}
        got = set(_public(importlib.import_module(port[rel])))
        assert want - got == set(), rel


def test_reference_parameters_are_a_subsequence_of_the_ports():
    """Every public function and method both packages define takes the
    reference's parameters in the reference's order; port-only parameters
    (``device=``, ``fold=``) may sit between them."""
    ref, port = _modules(cfmm_routing_tpu), _modules(cfmm_routing_tpu_torch)
    checked, bad = 0, []
    for rel in sorted(set(ref) & set(port)):
        pub = _public(importlib.import_module(port[rel]))
        for name, fn in _public(importlib.import_module(ref[rel])).items():
            if name not in pub or inspect.isclass(fn):
                continue
            want = list(inspect.signature(fn).parameters)
            got = list(inspect.signature(pub[name]).parameters)
            checked += 1
            if not _is_subsequence(want, got):
                bad.append(f"{rel}:{name} {want} vs {got}")
    assert checked > 120
    assert bad == []


def test_solve_fused_fifth_positional_is_merged(monkeypatch):
    """``solve_fused(obj, n, rho, False, True)`` binds ``interpret=False,
    merged=True`` in both packages, and the port runs its merged path."""
    from cfmm_routing_tpu.solver.admm import AdmmSolver as RefSolver
    from cfmm_routing_tpu_torch.models.reference_instances import arbitrage_instance
    from cfmm_routing_tpu_torch.solver.admm import AdmmSolver
    from cfmm_routing_tpu_torch.solver.compiler import compile_spec

    for cls in (RefSolver, AdmmSolver):
        bound = inspect.signature(cls.solve_fused).bind(None, "obj", 2, None, False, True)
        assert (bound.arguments["interpret"], bound.arguments["merged"]) == (False, True)
    spec, obj = arbitrage_instance()
    solver = AdmmSolver(compile_spec(spec, pad_pools_to=128), device="cpu")
    calls = []
    merged_step = AdmmSolver._iterate_fused_merged
    monkeypatch.setattr(AdmmSolver, "_iterate_fused_merged",
                        lambda self, *a, **k: calls.append(1) or merged_step(self, *a, **k))
    positional = solver.solve_fused(obj, 2, None, False, True)
    assert len(calls) == 2
    keyword = solver.solve_fused(obj, iters=2, merged=True)
    assert torch.equal(positional.psi, keyword.psi)


def test_delta_batch_return_shape_and_axes():
    """``delta_buckets_batch`` returns the reference's (buckets, in_axes,
    min_x0) and ``solve_delta_batch`` takes ``axes`` seventh."""
    from cfmm_routing_tpu_torch.models.reference_instances import arbitrage_instance
    from cfmm_routing_tpu_torch.solver.compiler import compile_spec
    from cfmm_routing_tpu_torch.solver.refine_device import DeltaAdmmSolver

    spec, _ = arbitrage_instance()
    ds = DeltaAdmmSolver(compile_spec(spec), dtype=torch.float64, device="cpu")
    T = 2
    trades = {name: np.zeros((T, b.width, b.m)) for name, b in ds.compiled.buckets.items()}
    out = ds.delta_buckets_batch(trades, trades, np.full(T, 1e-3), np.zeros((T, ds.n)))
    assert len(out) == 3
    bdict, axes, min_x0 = out
    assert set(axes) == set(bdict) and all(set(axes[k]) == set(bdict[k]) for k in bdict)
    assert min_x0.shape == (T,)
    params = list(inspect.signature(DeltaAdmmSolver.solve_delta_batch).parameters)
    assert params[7:9] == ["axes", "max_iters"]


def test_gm_mu_bracket_and_pack_take_the_reference_defaults(monkeypatch):
    from cfmm_routing_tpu_torch.models.utility import ConcaveUtility
    from cfmm_routing_tpu_torch.ops.projection import gm_mu_bracket

    args = [torch.ones(2, 3, dtype=torch.float64) for _ in range(5)]
    k0 = torch.ones(3, dtype=torch.float64)
    mask = torch.ones(2, 3, dtype=torch.float64)
    gamma = torch.ones(1, 3, dtype=torch.float64)
    a = gm_mu_bracket(*args[:2], args[2], args[3], args[4], gamma, k0, mask)
    b = gm_mu_bracket(*args[:2], args[2], args[3], args[4], gamma, k0, mask,
                      torch.float64)
    assert torch.equal(a, b)
    util = ConcaveUtility.linear(np.ones(3))
    assert util.pack(torch.float64, "cpu").c.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        util.pack(torch.float64)  # the card by default, and none is present
