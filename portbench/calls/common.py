"""What the calls share: the program's table and options from plain data."""
from __future__ import annotations


def table(net: dict, reserves):
    """The program's ``PoolTable`` of the network at these reserves."""
    from cfmm_routing_tpu_torch.solver.compiler import PoolTable

    return PoolTable(net["n_assets"], net["kind"], net["floor"], net["width"],
                     net["offset"], net["assets"], reserves, net["weights"],
                     net["shifts"], net["fees"])


def options(traffic: dict):
    """The caller's ``AdmmOptions`` as the traffic mix states them."""
    from cfmm_routing_tpu_torch.ops.projection import ProjectionConfig
    from cfmm_routing_tpu_torch.solver.admm import AdmmOptions

    kw = dict(traffic["options"])
    kw["projection"] = ProjectionConfig(*kw.get("projection", (48, 6)))
    return AdmmOptions(**kw)


def device_kw(device) -> dict:
    """The program's ``device=`` keyword: its default (the card) unless the
    run is on the CPU."""
    return {} if device is None else {"device": device}
