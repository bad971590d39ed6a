"""Multi-process runs: one process per rank over torch.distributed.

Counterpart of storygen_tpu/parallel/multihost.py, where one JAX process
per host owns all of its chips. In the port each process owns one device:

- `initialize()` joins the process group from its arguments, else the JAX
  package's environment names (JAX_COORDINATOR_ADDRESS or
  COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID), else
  torchrun's (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK). Without any of
  them it does nothing. The backend is NCCL for a CUDA device; gloo runs
  only when the caller names it (the CPU, or several ranks on one card),
  never as a fallback.
- `rank_device()` is the rank's device: the one given, else the card of
  its local rank (LOCAL_RANK, else the process id); a rank whose local
  rank has no card raises.
- `global_mesh()` is the data mesh over every rank; `host_local_batch()`
  puts this process's own rows of the global batch (its DataLoader shard)
  on its device; `is_coordinator()` gates logs and writes to rank 0.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from storygen_tpu_torch.parallel.mesh import Mesh, make_mesh


def _config(coordinator_address, num_processes, process_id):
    """(init method, world size, rank) from the arguments, the JAX
    environment names or torchrun's; None when nothing asks for a process
    group."""
    env = os.environ
    address = (coordinator_address or env.get("JAX_COORDINATOR_ADDRESS")
               or env.get("COORDINATOR_ADDRESS"))
    if num_processes is None and "JAX_NUM_PROCESSES" in env:
        num_processes = int(env["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in env:
        process_id = int(env["JAX_PROCESS_ID"])
    if address is None and "MASTER_ADDR" in env:
        address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if address is None and num_processes is None:
        return None
    if address is None or num_processes is None or process_id is None:
        raise ValueError("a process group needs the coordinator's address, "
                         "the number of processes and this process's id")
    method = address if "://" in address else f"tcp://{address}"
    return method, int(num_processes), int(process_id)


def rank_device(device=None, rank: Optional[int] = None) -> torch.device:
    """This rank's device: `device` when it names one ("cpu", "cuda:1"),
    else the card of the local rank (LOCAL_RANK, else `rank`, else the
    process group's rank). Raises when that card does not exist."""
    if device is not None:
        dev = torch.device(device)
        if dev.type != "cuda" or dev.index is not None:
            return dev
    if "LOCAL_RANK" in os.environ:
        local = int(os.environ["LOCAL_RANK"])
    elif rank is not None:
        local = rank
    else:
        local = dist.get_rank() if dist.is_initialized() else 0
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local >= n:
        raise RuntimeError(f"local rank {local} has no card ({n} visible); "
                           "give each rank its device")
    return torch.device("cuda", local)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device=None) -> bool:
    """Join the process group if configured; True if it did (also at one
    rank), False when nothing asks for one. `coordinator_address` is
    host:port (TCP) or an init method URL (file:///path); `backend` is
    "nccl" (the default, for a CUDA device) or "gloo" when named."""
    cfg = _config(coordinator_address, num_processes, process_id)
    if cfg is None:
        return False
    method, n, rank = cfg
    dev = rank_device(device, rank)
    backend = backend or "nccl"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device, not {dev}; name "
                         "backend='gloo' to run there")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=method, world_size=n,
                            rank=rank)
    return True


def shutdown() -> None:
    """Leave the process group (nothing without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def global_mesh() -> Mesh:
    """1-D data mesh over every rank of every process."""
    return make_mesh()


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def host_local_batch(batch: Dict[str, Any], device) -> Dict[str,
                                                             torch.Tensor]:
    """This process's rows of the global batch, as its DataLoader shard
    loaded them, as tensors on its device: the rows that the JAX package
    assembles into one global array (each process loads global / world
    rows; ref-major keys hold theirs on axis 1)."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}
