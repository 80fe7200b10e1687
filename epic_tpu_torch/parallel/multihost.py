"""Several processes, one mesh: bring-up on ``torch.distributed``.

The counterpart of ``epic_tpu.parallel.multihost``. The mesh solver
(:mod:`.sharded`) runs unchanged across processes: each process owns a
contiguous block of the mesh's shards (its own devices, in row-major
order), halos between processes travel by point-to-point sends
(``batch_isend_irecv``), the staggered check's delta is a local max and
then an ``all_reduce(MAX)``, and a readback gathers every shard to every
process.

Typical driver (the same script in every process):

    from epic_tpu_torch.parallel import multihost, make_mesh, sharded
    multihost.initialize("host0:29500", num_processes=2, process_id=rank)
    mesh = make_mesh(devices=[torch.device("cuda", 0)])   # this process's cards
    out = sharded.solve(state, mesh)                       # state identical everywhere

Backends: gloo for meshes on the CPU, NCCL for meshes on cards. A single
process needs none of this: :func:`initialize` is then a no-op.
``python -m epic_tpu_torch.parallel._mh_worker`` is a worker that runs a
sharded solve across processes.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None) -> None:
    """Join the process group: ``coordinator_address`` ("host:port", rank
    0's), the number of processes and this one's rank; each read from the
    environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``)
    when not given. A no-op when the group exists already or there is one
    process. ``backend`` defaults to NCCL where CUDA is available, else
    gloo."""
    if dist.is_initialized():
        return
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    # Every rank takes part in the group's first operation (batch_isend_irecv
    # requires it, and a halo exchange involves only neighbours).
    dist.barrier()


def is_multi_process() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def world() -> tuple[int, int]:
    """(number of processes, this process's rank); (1, 0) without a group."""
    if not is_multi_process():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()
