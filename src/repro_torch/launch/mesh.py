"""Process group and `DeviceMesh` builders.

Mirrors `repro/launch/mesh.py`.  The model and training paths run SPMD,
one process (rank) per GPU: `torchrun --nproc-per-node=<gpus>` starts
them, `init_distributed` joins them into one process group (NCCL on CUDA;
gloo only when the caller asks for the CPU), and a mesh names the ranks'
grid.  The builders are functions, so importing this module touches no
device and no process group.
"""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.models.api import resolve_device


def init_distributed(device="cuda", store_path: str | None = None,
                     rank: int | None = None,
                     world_size: int | None = None) -> torch.device:
    """Join the default process group (once per process) and return this
    rank's device.

    Rank and world size come from the arguments, else from torchrun's
    environment (RANK, WORLD_SIZE, LOCAL_RANK), else this process is a
    group of one.  Rendezvous: a `FileStore` at `store_path` when given
    (the tests' spawned ranks, no port), torchrun's env:// store when
    launched by it, an in-process store for a group of one.  A CUDA
    device raises without CUDA: it never becomes the CPU."""
    dev = resolve_device(device)
    env = os.environ
    if rank is None:
        rank = int(env.get("RANK", 0))
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", 1))
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = "nccl" if dev.type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=600)
    if store_path is not None:
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size, timeout=timeout)
    elif "MASTER_ADDR" in env:
        dist.init_process_group(backend, rank=rank, world_size=world_size,
                                timeout=timeout)
    else:
        if world_size != 1:
            raise RuntimeError(
                f"world size {world_size} without a rendezvous: launch with "
                f"torchrun or pass store_path")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
    return dev


def launched_world() -> int:
    """The world size this process runs in: its process group's, else
    torchrun's (WORLD_SIZE), else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape, axes) -> DeviceMesh:
    world = dist.get_world_size()
    n = int(np.prod(shape))
    if n != world:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {n} ranks; "
                         f"the world size is {world}")
    ranks = torch.arange(world).reshape(tuple(shape))
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model"), over the world's ranks; raises unless the world is that
    size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_mesh(shape, axes) -> DeviceMesh:
    """A mesh of the given shape over every rank, rank r at the
    row-major coordinate r (as `jax.make_mesh` lays out host devices)."""
    return _mesh(shape, axes)


def make_slot_mesh(ranks, shape, axes=("data", "model")) -> DeviceMesh:
    """Mesh over an explicit subset of the ranks, reshaped to `shape`."""
    ranks = torch.as_tensor(np.asarray(ranks)).reshape(tuple(shape))
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=tuple(axes))


def make_host_mesh() -> DeviceMesh:
    """Every rank of the world as a 1-D ("data",) mesh."""
    return _mesh((dist.get_world_size(),), ("data",))
