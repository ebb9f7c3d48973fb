"""The process group and the ("data", "model") mesh (port of
``cliffordtpu/parallel/mesh.py`` and ``data.py::initialize_multihost``).

JAX sees every chip from one process; here each rank is a process, which
``torchrun --nproc_per_node N`` starts (it sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT``).  Without ``torchrun`` the world is one process, and
``init_distributed`` makes that single-rank group itself on a free
localhost port, so ``--mesh dp`` runs on one card as it is.
"""

from __future__ import annotations

import os
import socket
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

AXES = ("data", "model")


def world_size() -> int:
    """The ranks of the group, or of the ``torchrun`` launch before it
    exists (1 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(device=None) -> torch.device:
    """Join (or make) the default process group and return this rank's
    device.  ``device``: the run's device ("cuda" or "cpu"; a CUDA rank
    takes card ``LOCAL_RANK`` modulo the cards it sees).  The backend is
    NCCL when every rank of the host has a card of its own, gloo when
    ranks share a card or run on the CPU (gloo carries CUDA tensors for
    all-reduce and broadcast, which DDP needs); it prints which.  A second
    call returns the device and changes nothing."""
    device = torch.device(device if device is not None else "cuda")
    local = int(os.environ.get("LOCAL_RANK", 0))
    if device.type == "cuda":
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    world = world_size()
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    own_card = (device.type == "cuda"
                and local_world <= torch.cuda.device_count())
    backend = "nccl" if own_card else "gloo"
    if "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend)
    else:
        if world != 1:
            raise ValueError(f"WORLD_SIZE={world} without MASTER_ADDR: "
                             f"start the ranks with torchrun")
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{_free_port()}", rank=0,
            world_size=1)
    print(f"process group: {backend}, rank {dist.get_rank()} of "
          f"{dist.get_world_size()}, {device}", flush=True)
    return device


def parse_mesh_spec(spec: str, n_devices: Optional[int] = None
                    ) -> Tuple[int, int]:
    """A CLI mesh spec -> a (data, model) shape: ``"dp"`` / ``"auto"``
    every rank on the data axis; ``"N"`` N-way DP; ``"NxM"`` N-way DP x
    M-way TP.  ``n_devices`` defaults to the world size."""
    n = n_devices if n_devices is not None else world_size()
    s = spec.strip().lower()
    if s in ("dp", "auto"):
        return (n, 1)
    if "x" in s:
        d, m = s.split("x", 1)
        return (int(d), int(m))
    return (int(s), 1)


def create_mesh(shape: Optional[Tuple[int, int]] = None,
                device_type: str = "cuda"):
    """A 2-D ("data", "model") ``DeviceMesh`` over the process group:
    default (world, 1), pure DP.  Its size must be the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    world = world_size()
    shape = tuple(shape) if shape is not None else (world, 1)
    need = shape[0] * shape[1]
    if need != world:
        raise ValueError(
            f"mesh shape {shape} needs {need} ranks, the group has {world}: "
            f"run it as torchrun --nproc_per_node {need} ...")
    return init_device_mesh(device_type, shape, mesh_dim_names=AXES)


def mesh_sizes(mesh) -> Dict[str, int]:
    """{"data": n, "model": m}: the axis sizes the sharding rules read."""
    return {name: mesh[name].size() for name in AXES}
