"""The port's native (C++) packer against the JAX package's and its own
numpy packer, on the CPU.

* ``compile_table(backend="native")`` is bit for bit the reference's
  native output on the tables of ``tests/test_native.py`` (seeds 0 and 1 at
  32 assets / 500 pools, ``pad_pools_to=8``), and through the object path
  (``random_network``, seeds 0 and 3);
* against the port's numpy packer: integer arrays equal, float arrays to
  summation-order roundoff (1e-12), as ``tests/test_native.py`` holds the
  reference's two packers;
* ``bucket_keys`` equals the reference's and the numpy key expression;
* ``backend="auto"`` takes the native packer where it builds; the packer
  is built into the port's own build directory and never writes beside the
  reference's sources; a failed build makes ``"native"`` raise and
  ``"auto"`` take numpy.
"""
import hashlib
import os

import numpy as np
import pytest

from cfmm_routing_tpu import native as ref_native
from cfmm_routing_tpu.solver import compiler as ref_compiler
from cfmm_routing_tpu.utils import synth as ref_synth
from cfmm_routing_tpu_torch import native
from cfmm_routing_tpu_torch.ops._build import BUILD_DIR
from cfmm_routing_tpu_torch.solver.compiler import PoolTable, compile_spec, compile_table
from cfmm_routing_tpu_torch.utils import synth

_INT_FIELDS = ("mask", "asset", "pool_ids")
_FLOAT_FIELDS = ("reserves", "weights", "shift", "gamma", "logk0", "k0")


def _assert_compiled(a, b, exact):
    assert (a.n_assets, a.n_pools, a.n_slots) == (b.n_assets, b.n_pools, b.n_slots)
    np.testing.assert_array_equal(a.degree, b.degree)
    np.testing.assert_array_equal(a.widths, b.widths)
    assert list(a.buckets) == list(b.buckets)
    for name, ba in a.buckets.items():
        bb = b.buckets[name]
        assert (ba.kind, ba.width, ba.needs_floor) == (bb.kind, bb.width, bb.needs_floor)
        for field in _INT_FIELDS + _FLOAT_FIELDS:
            x, y = getattr(ba, field), getattr(bb, field)
            assert x.dtype == y.dtype, (name, field)
            if exact or field in _INT_FIELDS:
                np.testing.assert_array_equal(x, y, err_msg=f"{name}.{field}")
            else:
                np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-12,
                                           err_msg=f"{name}.{field}")


def _packer_files():
    """sha256 of every file of the reference's native directory."""
    d = ref_native._DIR
    return {f: hashlib.sha256(open(os.path.join(d, f), "rb").read()).hexdigest()
            for f in sorted(os.listdir(d)) if os.path.isfile(os.path.join(d, f))}


def test_native_builds_in_the_ports_build_directory():
    before = _packer_files()
    assert native.available()
    assert native._SO.parent == BUILD_DIR and native._SO.exists()
    table, _ = synth.random_arbitrage_table(8, 40, seed=2)
    compile_table(table, backend="native")
    assert _packer_files() == before  # nothing written beside the reference


@pytest.mark.parametrize("seed", [0, 1])
def test_native_matches_reference_native_and_numpy(seed):
    table = synth.random_network_table(32, 500, seed=seed)
    got = compile_table(table, backend="native", pad_pools_to=8)
    want = ref_compiler.compile_table(ref_synth.random_network_table(32, 500, seed=seed),
                                      backend="native", pad_pools_to=8)
    _assert_compiled(got, want, exact=True)
    _assert_compiled(got, compile_table(table, backend="numpy", pad_pools_to=8),
                     exact=False)
    # the default takes the native packer where it builds, as the reference's
    _assert_compiled(compile_table(table, pad_pools_to=8), got, exact=True)


def test_native_bucket_keys_match_reference_and_numpy():
    table = synth.random_network_table(32, 300, seed=2)
    args = (np.ascontiguousarray(table.width, np.int32),
            np.ascontiguousarray(table.kind, np.uint8),
            np.ascontiguousarray(table.floor, np.uint8))
    keys = native.bucket_keys(*args)
    np.testing.assert_array_equal(keys, ref_native.bucket_keys(*args))
    Ks = np.maximum(
        2, (1 << np.ceil(np.log2(np.maximum(table.width, 2))).astype(np.int64))
    ).astype(np.int32)
    expect = ((table.kind.astype(np.int32) << 24) | (Ks << 1)
              | table.floor.astype(np.int32))
    np.testing.assert_array_equal(keys, expect)


@pytest.mark.parametrize("seed", [0, 3])
def test_table_path_matches_object_path(seed):
    spec = synth.random_network(16, 120, seed=seed)
    via_table = compile_table(PoolTable.from_spec(spec), backend="native")
    _assert_compiled(compile_spec(spec, backend="numpy"), via_table, exact=False)
    ref_spec = ref_synth.random_network(16, 120, seed=seed)
    want = ref_compiler.compile_table(ref_compiler.PoolTable.from_spec(ref_spec),
                                      backend="native")
    _assert_compiled(via_table, want, exact=True)


def test_failed_build_native_raises_auto_takes_numpy(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "g++ not found (simulated)")
    table, _ = synth.random_arbitrage_table(8, 40, seed=2)
    assert not native.available()
    with pytest.raises(RuntimeError, match="did not build"):
        compile_table(table, backend="native")
    _assert_compiled(compile_table(table), compile_table(table, backend="numpy"),
                     exact=True)
