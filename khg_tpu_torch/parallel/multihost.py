"""Multi-process (multi-card, multi-host) set-up for data-parallel EM
(PyTorch port of khg_tpu/parallel/multihost.py).

Every process runs the same program (SPMD, one process per card, as
``torchrun`` launches it): each feeds its shard of the utterance list,
and parallel/mesh.py's all-reduce sums the shards' stats over the
process group.  Stats are additive, so the reduced sum equals the
serial sum on any process layout.  A single-process run is the
degenerate case: initialize() does nothing and the mesh has world
size 1.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "nccl",
) -> None:
    """torch.distributed.init_process_group for this process.

    ``coordinator_address`` is "host:port" (rank 0 listens there) or an
    init-method URL ("tcp://host:port", "file:///path" for a FileStore);
    ``num_processes`` and ``process_id`` are the world size and this
    process's rank.  Without them the torchrun environment gives all
    three (MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK); with neither, or
    with one process, this is a single-process run and nothing is
    initialised.  ``backend`` is the caller's choice, used as given:
    "nccl" for CUDA tensors, "gloo" for CPU tensors (or for a
    several-rank check on one card, which NCCL refuses).  A failure to
    initialise raises."""
    import torch.distributed as dist

    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    logger.info("distributed: process %d/%d (%s)", dist.get_rank(),
                dist.get_world_size(), backend)


def _rank_world() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_shard(num_items: int) -> Tuple[int, int]:
    """[start, end) of this process's contiguous shard of a global work
    list.  Every process must call with the same num_items; remainders
    go to the first processes so sizes differ by at most one."""
    p, n = _rank_world()
    base, rem = divmod(num_items, n)
    start = p * base + min(p, rem)
    end = start + base + (1 if p < rem else 0)
    return start, end


def global_data_mesh(devices=None):
    """The DataMesh over every process of the job (parallel/mesh.py's
    make_data_mesh over the whole process group)."""
    from khg_tpu_torch.parallel.mesh import make_data_mesh

    return make_data_mesh(devices=devices)


def make_global_batch(local_arrays, mesh):
    """This process's batch for the sharded steps.

    In khg_tpu a host's local arrays become a global jax.Array sharded
    over the mesh; in PyTorch a rank's local arrays ARE its shard of the
    global batch (the steps all-reduce what they sum), so nothing
    global is built: arrays come back as tensors on the mesh's device,
    in the same (nested tuple / NamedTuple) structure."""

    def build(x):
        if isinstance(x, tuple):
            items = [build(v) for v in x]
            return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
        if isinstance(x, list):
            return [build(v) for v in x]
        if isinstance(x, torch.Tensor):
            return x.to(mesh.device)
        return torch.from_numpy(np.ascontiguousarray(np.asarray(x))).to(mesh.device)

    return build(local_arrays)
