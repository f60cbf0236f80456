"""The port's public surface is the JAX package's, less the sharded names
that are not ported yet (``ROADMAP.md`` item 14)."""
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

NOT_PORTED = {"ShardedAdmmSolver", "ShardedDeltaAdmmSolver", "pool_mesh",
              "pool_batch_mesh"}


def test_all_is_the_reference_all_less_the_sharded_names():
    want = [n for n in cfmm_routing_tpu.__all__ if n not in NOT_PORTED]
    assert cfmm_routing_tpu_torch.__all__ == want
    assert set(cfmm_routing_tpu.__all__) - NOT_PORTED == set(
        cfmm_routing_tpu_torch.__all__)
    mod = importlib.import_module("cfmm_routing_tpu_torch")
    missing = [n for n in cfmm_routing_tpu_torch.__all__ if not hasattr(mod, n)]
    assert not missing
    assert cfmm_routing_tpu_torch.__version__ == cfmm_routing_tpu.__version__


def test_admm_options_accepts_onehot_chunk():
    opts = AdmmOptions(onehot_chunk=256)
    assert opts.onehot_chunk == 256
    assert AdmmOptions().onehot_chunk == 512
