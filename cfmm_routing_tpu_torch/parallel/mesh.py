"""Process groups and device meshes for the sharded solvers.

The solver's parallel axes (SURVEY.md §2): ``pools`` (every bucket's pools
split across ranks; the coupling is one all-reduce of the (n,)-vector per
iteration) and ``batch`` (independent scenarios).  The JAX package drives a
mesh of devices from one program; here each rank of the mesh is one process
(``torchrun``, or processes started by the caller), and a mesh is a
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`
whose dims carry the JAX package's axis names.

A mesh carries its device type: ``"cuda"`` (NCCL, the default, one card per
rank) or ``"cpu"`` (gloo, the plain PyTorch kernels).  In a single process
that never set up a group, :func:`pool_mesh` returns a one-rank mesh over an
in-memory store: no port, no network.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["pool_mesh", "pool_batch_mesh", "init_distributed"]

# every group's collectives give up after this many seconds: a rank that
# waits for a rank that failed raises instead of hanging
GROUP_TIMEOUT_S = 600.0


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout: float = GROUP_TIMEOUT_S,
) -> int:
    """Join this process to the ranks of a sharded run; returns the world
    size.

    ``coordinator_address``: where the ranks meet, ``host:port`` (a TCP
    store) or any ``init_method`` URL (``file:///shared/path``); with none
    and ``WORLD_SIZE`` in the environment (``torchrun``) the environment's
    address, rank and size are used.  Given nothing in a single process,
    and when already initialised, it does nothing.

    The rank's device is ``cuda:{LOCAL_RANK % device_count}`` (the process
    id when no ``LOCAL_RANK`` is set) and its group NCCL when a card is
    visible, gloo on the CPU.  ``backend="gloo"`` keeps CUDA tensors on
    gloo, which copies them through the host: ranks that share one card
    (NCCL refuses two ranks on one device) run that way, eagerly
    (``solver/graphs.py``).  ``timeout``: the group's collective timeout
    in seconds."""
    if dist.is_initialized():
        return dist.get_world_size()
    from_env = "WORLD_SIZE" in os.environ
    if coordinator_address is None and num_processes is None and not from_env:
        return 1
    world = int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else os.environ["RANK"])
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    on_card = torch.cuda.is_available()
    if on_card:
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend or ("nccl" if on_card else "gloo"), init_method=init_method,
        world_size=world, rank=rank, timeout=datetime.timedelta(seconds=timeout))
    return world


def _device_type(platform) -> str:
    """The mesh's device type: the card unless the caller asks for the CPU."""
    if platform == "cpu":
        return "cpu"
    if platform not in (None, "gpu", "cuda"):
        raise ValueError(f"unknown platform {platform!r}: 'cpu' or 'gpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass platform='cpu' for a CPU mesh "
            "(gloo, the plain PyTorch versions of the kernels)")
    return "cuda"


def _ranks(device_type, devices) -> list:
    """The mesh's ranks: ``devices`` (global ranks) or the whole world.  A
    process with no group gets a one-rank group over an in-memory store."""
    if not dist.is_initialized():
        if device_type == "cuda":
            # select the device explicitly: DeviceMesh guesses (and warns)
            # for a process that never did
            torch.cuda.set_device(torch.cuda.current_device())
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo", store=dist.HashStore(),
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    if device_type == "cpu" and dist.get_backend() == "nccl":
        raise ValueError("a CPU mesh needs a gloo process group; this one is NCCL")
    return list(range(dist.get_world_size())) if devices is None else [int(r) for r in devices]


def _mesh(device_type, ranks, shape, names) -> DeviceMesh:
    if ranks == list(range(dist.get_world_size())):
        return init_device_mesh(device_type, shape, mesh_dim_names=names)
    # a mesh over some of the ranks: every rank of the world builds it (its
    # groups are made collectively); a rank outside holds no coordinate
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type, grid, mesh_dim_names=names)


def pool_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence[int]] = None,
              platform=None) -> DeviceMesh:
    """1-D mesh over the ``pools`` dim: the first ``n_devices`` of
    ``devices`` (global ranks; default every rank of the world)."""
    dtype = _device_type(platform)
    ranks = _ranks(dtype, devices)
    if n_devices is not None:
        if len(ranks) < n_devices:
            raise ValueError(f"need {n_devices} devices for a {n_devices}-rank "
                             f"pools mesh, have {len(ranks)}")
        ranks = ranks[:n_devices]
    return _mesh(dtype, ranks, (len(ranks),), ("pools",))


def pool_batch_mesh(pools: int, batch: int, devices: Optional[Sequence[int]] = None,
                    platform=None) -> DeviceMesh:
    """2-D mesh: scenario batch (outer) x pools (inner); rank
    ``b * pools + p`` holds batch row b's pool shard p."""
    dtype = _device_type(platform)
    ranks = _ranks(dtype, devices)
    if len(ranks) < pools * batch:
        raise ValueError(
            f"need {pools * batch} devices for a {batch}x{pools} mesh, "
            f"have {len(ranks)}"
        )
    return _mesh(dtype, ranks[: pools * batch], (batch, pools), ("batch", "pools"))
