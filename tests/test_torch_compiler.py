"""Port compiler vs the JAX package's compiler: bucket arrays bit-identical.

Both packages build their problems from the same seeds; the port's
``compile_spec`` / ``compile_table`` must reproduce every bucket array,
the per-asset degree and the bookkeeping of the reference's numpy packer
exactly, and its native packer's with ``backend="native"``.  (A package's
native packer agrees with its numpy packer to summation-order roundoff,
``tests/test_native.py``, ``tests/test_torch_native.py``.)
"""
import numpy as np
import pytest
import torch

from cfmm_routing_tpu.models import reference_instances as ref_instances
from cfmm_routing_tpu.solver import compiler as ref_compiler
from cfmm_routing_tpu.utils import synth as ref_synth
from cfmm_routing_tpu_torch.models import reference_instances as port_instances
from cfmm_routing_tpu_torch.solver import compiler as port_compiler
from cfmm_routing_tpu_torch.utils import synth as port_synth

torch.set_num_threads(1)

_BUCKET_ARRAYS = ("reserves", "weights", "shift", "gamma", "logk0", "k0",
                  "mask", "asset", "pool_ids")
_TABLE_ARRAYS = ("kind", "floor", "width", "offset", "assets", "reserves",
                 "weights", "shifts", "fees")


def _assert_bit_identical(ref, port):
    assert port.n_assets == ref.n_assets
    assert port.n_pools == ref.n_pools
    assert port.n_slots == ref.n_slots
    np.testing.assert_array_equal(port.widths, ref.widths)
    np.testing.assert_array_equal(port.degree, ref.degree)
    assert list(port.buckets) == list(ref.buckets)
    for name, rb in ref.buckets.items():
        pb = port.buckets[name]
        assert (pb.kind, pb.width, pb.needs_floor) == (rb.kind, rb.width, rb.needs_floor)
        for field in _BUCKET_ARRAYS:
            a, b = getattr(rb, field), getattr(pb, field)
            assert a.dtype == b.dtype, (name, field)
            np.testing.assert_array_equal(b, a, err_msg=f"{name}.{field}")


def _assert_same_objective(ref_obj, port_obj):
    for field in ("c", "lo", "hi"):
        np.testing.assert_array_equal(getattr(port_obj, field), getattr(ref_obj, field))


@pytest.mark.parametrize(
    "instance", ["arbitrage_instance", "liquidation_instance", "two_asset_instance"]
)
def test_reference_instances_bit_identical(instance):
    ref_spec, ref_obj = getattr(ref_instances, instance)()
    port_spec, port_obj = getattr(port_instances, instance)()
    _assert_same_objective(ref_obj, port_obj)
    _assert_bit_identical(
        ref_compiler.compile_spec(ref_spec, backend="numpy"),
        port_compiler.compile_spec(port_spec, backend="numpy"),
    )


@pytest.mark.parametrize("pad_pools_to", [1, 128])
def test_random_table_bit_identical(pad_pools_to):
    ref_table, ref_obj = ref_synth.random_arbitrage_table(64, 1000, seed=3)
    port_table, port_obj = port_synth.random_arbitrage_table(64, 1000, seed=3)
    for field in _TABLE_ARRAYS:
        np.testing.assert_array_equal(
            getattr(port_table, field), getattr(ref_table, field)
        )
    _assert_same_objective(ref_obj, port_obj)
    _assert_bit_identical(
        ref_compiler.compile_table(ref_table, pad_pools_to=pad_pools_to,
                                   backend="numpy"),
        port_compiler.compile_table(port_table, pad_pools_to=pad_pools_to,
                                    backend="numpy"),
    )


def test_random_spec_bit_identical_unpadded_widths():
    """Object-built networks, with pad_pow2=False (K = the real width)."""
    ref_spec, ref_obj = ref_synth.random_arbitrage(12, 80, seed=5)
    port_spec, port_obj = port_synth.random_arbitrage(12, 80, seed=5)
    _assert_same_objective(ref_obj, port_obj)
    _assert_bit_identical(
        ref_compiler.compile_spec(ref_spec, pad_pow2=False, backend="numpy"),
        port_compiler.compile_spec(port_spec, pad_pow2=False, backend="numpy"),
    )


def test_native_packer_not_ported():
    """The native packer is ported: the port's is bit-identical to the
    reference's on the same table."""
    ref_table, _ = ref_synth.random_arbitrage_table(8, 20, seed=1)
    table, _ = port_synth.random_arbitrage_table(8, 20, seed=1)
    _assert_bit_identical(
        ref_compiler.compile_table(ref_table, backend="native"),
        port_compiler.compile_table(table, backend="native"),
    )
