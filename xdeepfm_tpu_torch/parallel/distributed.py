"""Multi-process bootstrap + per-rank input (port of
``xdeepfm_tpu/parallel/distributed.py``).

* :func:`initialize` starts ``torch.distributed``: one process per rank,
  the coordinator's address, the world size and this rank from the
  arguments or from ``XDEEPFM_COORDINATOR`` / ``XDEEPFM_NUM_PROCESSES`` /
  ``XDEEPFM_PROCESS_ID`` (a launcher such as ``torchrun`` sets
  ``MASTER_ADDR`` / ``WORLD_SIZE`` / ``RANK`` instead, which are read when
  those are absent); a no-op for one process.
* :func:`global_batch_from_host_local` gives each rank its own slice of the
  global batch on its device: no process ever holds the global batch.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
):
    """Join the process group.  Returns False (and does nothing) for one
    process, True once the group is up.

    ``coordinator_address`` is ``host:port`` of rank 0.  ``device`` is this
    rank's device, None meaning CUDA (a rank's GPU is ``cuda:<local rank>``,
    set by the caller, e.g. ``device=f"cuda:{local_rank}"``); with no GPU
    present None raises, as a model's ``device=None`` does.  ``backend``
    defaults to NCCL for a CUDA device and gloo for the CPU."""
    from ..basemodel import resolve_device

    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("XDEEPFM_NUM_PROCESSES", env.get("WORLD_SIZE", "1")))
    if num_processes <= 1:
        return False
    if process_id is None:
        process_id = int(env.get("XDEEPFM_PROCESS_ID", env.get("RANK", "0")))
    if coordinator_address is None:
        coordinator_address = env.get("XDEEPFM_COORDINATOR")
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if coordinator_address is None:
        raise ValueError("initialize: no coordinator address (XDEEPFM_COORDINATOR)")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist.is_initialized():
        return True
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )
    return True


def global_batch_from_host_local(local_batch: Dict[str, np.ndarray], mesh,
                                 data_axis: str = "data"):
    """Each rank passes its own slice of the global batch (split over
    ``data_axis``, or over both axes under the ``all_to_all`` lookup, as
    ``mesh.shard_batch`` splits it); returns it as tensors on the rank's
    device.  One process per device makes the rank's slice its local data:
    nothing is assembled or moved between ranks."""
    del data_axis
    return {k: torch.as_tensor(np.asarray(v)).to(mesh.device) for k, v in local_batch.items()}
