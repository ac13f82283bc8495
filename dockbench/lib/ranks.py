"""Cells on a mesh: one process per rank, as ``torchrun`` would start
them, every rank calling the same entry points on its own card.

The harness starts ranks 1 .. N-1 itself (``spawn``) and runs rank 0 in
its own process; they meet at ``tcp://localhost:<a free port>``.  Rank
0's clock decides when the window ends, and rank 0 alone judges the
output and prints the result.
"""
from __future__ import annotations

import os
import socket
import sys
import traceback


class Solo:
    """One process, no process group."""
    rank, world = 0, 1

    @staticmethod
    def go(flag: bool) -> bool:
        return flag

    @staticmethod
    def gather(obj) -> list:
        return [obj]


class Ranks:
    """The process group's rank 0 decides; every rank gathers."""

    def __init__(self, device):
        import torch.distributed as dist
        self.dist = dist
        self.device = device
        self.rank, self.world = dist.get_rank(), dist.get_world_size()

    def go(self, flag: bool) -> bool:
        import torch
        t = torch.tensor([int(flag)], device=self.device)
        self.dist.broadcast(t, 0)
        return bool(t.item())

    def gather(self, obj) -> list:
        out = [None] * self.world
        self.dist.all_gather_object(out, obj)
        return out


def world_size(cell: dict) -> int:
    cfg = cell["config"]["dock_config"]
    return cfg.get("mesh_rot", 1) * cfg.get("mesh_batch", 1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_main(rank, world, port, cell, seed, seconds, traced, device_type,
              t0=None, rank_init=None):
    """One rank: join the group, build the mesh, run the cell.
    ``rank_init`` (picklable, or None) runs first on every rank, with
    ``LOCAL_RANK`` set."""
    import time
    import run
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    if rank_init is not None:
        rank_init()
    from deeplocalproteindocking_torch.parallel import mesh as pmesh
    device = pmesh.init_distributed(
        device_type, rank=rank, world_size=world,
        init_method=f"tcp://localhost:{port}")
    if rank == 0 and t0 is not None:
        print(f"setup: group joined at {time.perf_counter() - t0:.2f} s",
              file=sys.stderr)
    cfg = cell["config"]["dock_config"]
    mesh = pmesh.make_mesh(cfg.get("mesh_rot", 1), cfg.get("mesh_batch", 1),
                           device_type)
    try:
        out = run.run_cell(cell, seed, seconds, traced, str(device),
                           time.perf_counter() if t0 is None else t0,
                           comm=Ranks(device), mesh=mesh)
    except BaseException:
        if rank:         # gone at once, so that the peers' collectives fail
            traceback.print_exc()
            sys.stderr.flush()
            os._exit(1)
        raise
    pmesh.barrier()
    import torch.distributed as dist
    dist.destroy_process_group()
    return out


def run_ranks(cell, seed, seconds, traced, device_type, t0,
              rank_init=None):
    """``run.run_cell`` on every rank of the cell's mesh; rank 0's
    ``(result, checks)``.  Waits for every rank it started."""
    import torch.multiprocessing as mp
    world = world_size(cell)
    port = _free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main,
                         args=(r, world, port, cell, seed, seconds, traced,
                               device_type, None, rank_init))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        return rank_main(0, world, port, cell, seed, seconds, traced,
                         device_type, t0, rank_init)
    except BaseException:
        for p in procs:
            p.terminate()
        raise
    finally:
        for p in procs:
            p.join(timeout=600)
            if p.is_alive():
                p.terminate()
                p.join()
