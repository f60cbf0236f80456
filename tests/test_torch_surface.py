"""The port's public surface is the JAX package's, sharded names and all."""
import importlib

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
