"""Process groups and the ``(rot, batch)`` device mesh.

Port of ``deeplocalproteindocking_tpu/parallel/mesh.py``.  The JAX
package runs one program over a ``jax.sharding.Mesh``; the port runs one
process per rank (``torchrun``), every rank calling the same entry point,
over a ``torch.distributed.device_mesh.DeviceMesh`` whose dimensions are
named as the JAX mesh's axes:

* ``rot``   -- the rotation set of a sweep (and a decoy set in
  training); a sweep's only collective is the top-K merge;
* ``batch`` -- complexes (batched evaluation, data-parallel training).

Ranks talk over NCCL when each has its own card and over gloo on the
CPU, or when ranks share a card (NCCL refuses two ranks on one card).
The backend is chosen from the layout before any collective runs; a
collective that fails raises.  A mesh above one rank needs a process
group: there is no silent single-rank mode.

    torchrun --nproc-per-node N -m deeplocalproteindocking_torch.cli \\
        dock --mesh-rot N ...
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

MESH_DIMS = ("rot", "batch")


def torchrun_line(world: int, command: str = "dock") -> str:
    """The command line that starts ``world`` ranks of the CLI."""
    return (f"torchrun --nproc-per-node {world} -m "
            f"deeplocalproteindocking_torch.cli {command} ...")


def backend_for(device_type: str, ranks_per_host: int) -> str:
    """NCCL when every rank of the host has a card of its own, gloo on
    the CPU or when ranks share a card."""
    if device_type == "cpu":
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"device type {device_type!r}: 'cuda' or 'cpu'")
    return "nccl" if ranks_per_host <= torch.cuda.device_count() else "gloo"


def init_distributed(device_type: str = "cuda", *,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     init_method: str = "env://") -> torch.device:
    """Join the process group and return this rank's device.

    The rank and world size are the existing process group's, else the
    arguments, else torchrun's ``RANK`` and ``WORLD_SIZE``; the rank on
    its host is ``LOCAL_RANK`` (default: the rank) of
    ``LOCAL_WORLD_SIZE`` (default: the world).  On ``cuda`` the rank takes
    ``cuda:(LOCAL_RANK % cards)`` and the backend is
    :func:`backend_for`'s; on ``cpu`` it is gloo.  Raises when no process
    group exists and the ranks are neither given nor set by torchrun, or
    when ``cuda`` has no card.
    """
    env = os.environ
    if dist.is_initialized():
        rank, world_size = dist.get_rank(), dist.get_world_size()
    elif rank is None:
        if "RANK" not in env or "WORLD_SIZE" not in env:
            raise RuntimeError(
                "no process group: start the ranks with torchrun (RANK "
                "and WORLD_SIZE are unset)")
        rank, world_size = int(env["RANK"]), int(env["WORLD_SIZE"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: no CUDA card is visible")
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    elif device_type == "cpu":
        device = torch.device("cpu")
    else:
        raise ValueError(f"device type {device_type!r}: 'cuda' or 'cpu'")
    if not dist.is_initialized():
        backend = backend_for(device_type,
                              int(env.get("LOCAL_WORLD_SIZE", world_size)))
        dist.init_process_group(
            backend, init_method=init_method, rank=rank,
            world_size=world_size,
            device_id=device if backend == "nccl" else None)
    return device


def make_mesh(rot: int = 1, batch: int = 1, device_type: str = "cuda"):
    """A ``DeviceMesh`` of shape ``(rot, batch)`` over every rank, dims
    named ``("rot", "batch")``.  Raises when there is no process group or
    its world size is not ``rot * batch``, naming the torchrun line that
    fits."""
    from torch.distributed.device_mesh import init_device_mesh
    if rot < 1 or batch < 1:
        raise ValueError(f"mesh rot={rot} x batch={batch}: sizes must be "
                         f">= 1")
    need = rot * batch
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh rot={rot} x batch={batch} needs {need} ranks and no "
            f"process group exists; run `{torchrun_line(need)}`")
    world = dist.get_world_size()
    if world != need:
        raise ValueError(
            f"mesh rot={rot} x batch={batch} needs {need} ranks, the "
            f"process group has {world}; run `{torchrun_line(need)}`")
    return init_device_mesh(device_type, (rot, batch),
                            mesh_dim_names=MESH_DIMS)


def is_main_rank() -> bool:
    """Rank 0 of the process group, or the only process without one:
    the rank that writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank (no-op without a process group)."""
    if dist.is_initialized():
        dist.barrier()


def describe(device: torch.device) -> dict:
    """The process group as the CLI's ``info`` and ``doctor`` print it:
    world size, backend, NCCL's availability and each rank's device
    (``device`` on this rank, gathered from every rank)."""
    here = (f"{device} ({torch.cuda.get_device_name(device)})"
            if device.type == "cuda" else str(device))
    devices = [None] * dist.get_world_size()
    dist.all_gather_object(devices, here)
    return dict(world_size=dist.get_world_size(), backend=dist.get_backend(),
                nccl_available=dist.is_nccl_available(),
                rank_devices=devices)
