"""``api.sweep`` on a new block state: a certified price-impact frontier,
with the caller's solver compiled as ``examples/two_asset_torch.py`` does
(pools padded to a multiple of ``pad_pools_to``)."""
from __future__ import annotations

import numpy as np

from . import common


def call(net: dict, req: dict, traffic: dict, device=None, control=False):
    """One request through the program's public entry.  ``control`` drops
    the float64 refinement: the float32 batched base alone."""
    from cfmm_routing_tpu_torch import api
    from cfmm_routing_tpu_torch.solver.compiler import compile_table

    table = common.table(net, req["reserves"])
    solver = api.make_solver_compiled(
        compile_table(table, pad_pools_to=int(traffic["pad_pools_to"])),
        options=common.options(traffic), **common.device_kw(device))
    return api.sweep(table, req["give"], req["receive"], req["amounts"],
                     solver=solver,
                     refine_to=None if control else traffic["refine_to"])


def certified(out) -> bool:
    return bool(np.all(out.converged))


def answer(out) -> dict:
    """Per slot and point the net trade (E, T); per point the utility and
    the prices."""
    return dict(net=np.concatenate(out.net_trades, axis=0),
                utilities=np.asarray(out.utilities, np.float64),
                prices=np.asarray(out.prices, np.float64),
                iters=np.asarray(out.iters))
