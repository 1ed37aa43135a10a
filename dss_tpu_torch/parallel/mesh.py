"""Device-mesh construction for sharded training and multi-stream serving
(counterpart of dss_tpu/parallel/mesh.py) on ``torch.distributed``.

A ("data", "model") ``DeviceMesh`` over the default process group, one
rank a card (NCCL) or a CPU process (gloo): the data axis splits trials
or streams, the model axis the LSTM gate blocks (parallel/shard.py).
Collectives are explicit in the port, where GSPMD inserts them in JAX.

Where no process group exists and the mesh is one device, ``make_mesh``
starts a world-1 group itself, so a single card and the CPU tests need no
launcher.  Several ranks are started by ``torchrun`` (or by the caller)
before ``make_mesh`` is called.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device

AXES = ("data", "model")


def mesh_shape(n: int, model_parallel: int = 0) -> Tuple[int, int]:
    """(data, model) axis sizes of an ``n``-device mesh: the JAX rule,
    ``model_parallel <= 0`` picks 2 when n is even and above 1, else 1."""
    if model_parallel <= 0:
        model_parallel = 2 if n % 2 == 0 and n > 1 else 1
    if n % model_parallel:
        raise ValueError(f"a model axis of {model_parallel} does not divide "
                         f"{n} devices")
    return n // model_parallel, model_parallel


def backend_for(device: torch.device) -> str:
    """NCCL on the card, gloo on the CPU; there is no fallback between
    them."""
    return "nccl" if device.type == "cuda" else "gloo"


def local_device(device: torch.device) -> torch.device:
    """This rank's device: on CUDA the card of its local rank (torchrun's
    ``LOCAL_RANK``, else the global rank modulo the cards), made current."""
    if device.type != "cuda":
        return torch.device("cpu")
    if device.index is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        index = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        device = torch.device("cuda", index)
    torch.cuda.set_device(device)
    return device


def init_world(device: torch.device, rank: int = 0, world_size: int = 1,
               store: Optional[dist.Store] = None) -> None:
    """Start the default process group with the device's backend: from
    ``store`` with ``rank`` and ``world_size`` (a ``FileStore`` shared by
    spawned ranks); without one, from torchrun's environment where it is
    set, else as a world of one on a ``HashStore``."""
    backend = backend_for(device)
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("this torch has no NCCL; a CUDA mesh needs it")
    if store is None and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
        return
    if store is None:
        if world_size != 1:
            raise ValueError("a world of several ranks needs a store")
        store = dist.HashStore()
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size)


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 0,
              device=None) -> DeviceMesh:
    """A ("data", "model") mesh over the default process group's ranks,
    on ``device`` (``cuda`` unless the caller asks for the CPU).

    With no process group, one is started here: from torchrun's
    environment, or as a world of one when ``n_devices`` is 1 or None.
    The group must hold exactly ``n_devices`` ranks (default: all of
    them) and run the device's backend."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1) and "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                f"make_mesh({n_devices}): no process group; start one "
                f"process a device (torchrun --nproc-per-node {n_devices} "
                f"...) or call init_process_group first")
        init_world(dev)
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"make_mesh({n}) in a process group of {world} "
                         f"ranks: start {n} processes (torchrun "
                         f"--nproc-per-node {n} ...)")
    if dist.get_backend() != backend_for(dev):
        raise RuntimeError(f"a {dev.type} mesh needs the {backend_for(dev)} "
                           f"backend; the process group runs "
                           f"{dist.get_backend()}")
    local_device(dev)
    return init_device_mesh(dev.type, mesh_shape(n, model_parallel),
                            mesh_dim_names=AXES)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis(mesh: DeviceMesh, name: str):
    """(size, this rank's coordinate, process group) of one mesh axis."""
    return (mesh.shape[AXES.index(name)], mesh.get_local_rank(name),
            mesh.get_group(name))
