"""A worker for mesh solves across processes (gloo on the CPU).

Started once per process; the processes join one group through
:func:`epic_tpu_torch.parallel.multihost.initialize` and build one mesh of
``num_processes x local_devices`` CPU shards, each process owning its
``local_devices`` of them. They run a sharded solve (or a 137-sweep tick)
of the same seeded grid, ``solve_resident`` a solve of a 512-wide grid on
the resident route, or in the 3D modes (``tools/multihost_worker.py``'s) a
sharded solve of the same seeded volume: ``solve3d`` on the near-square
plane mesh, ``solve_resident_z`` on a z-only mesh with ``kernel="resident"``.
Process 0 writes the gathered result to ``--out`` as an .npz (``u``,
``iteration``, ``delta``, ``converged``, ``process_count``).

    python -m epic_tpu_torch.parallel._mh_worker --coordinator localhost:PORT \\
        --num-processes 2 --process-id K --local-devices 4 --out result.npz \\
        [--mode solve|update|solve_resident|solve3d|solve_resident_z] [--size 48]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from .. import constants as C
from .. import grid as G
from . import make_mesh, make_mesh3d, multihost, sharded, sharded3d

RESIDENT_WIDTH = 512   # the solve_resident mode's grid width


def worker_state(size: int = 48, width: int | None = None) -> G.GridState:
    """The seeded grid every process builds: ``size`` rows, ``width``
    (``size`` by default) columns, 15% obstacle cells (numpy
    default_rng(7)), the ring walled, one goal at the centre, epsilon
    1e-3."""
    n, w = size, size if width is None else width
    rng = np.random.default_rng(7)
    obstacle = np.zeros((n, w), dtype=bool)
    obstacle[rng.random((n, w)) < 0.15] = True
    goal = np.zeros((n, w), dtype=bool)
    goal[n // 2, w // 2] = True
    obstacle[n // 2, w // 2] = False
    obstacle[0, :] = obstacle[-1, :] = True
    obstacle[:, 0] = obstacle[:, -1] = True
    u = np.where(goal, C.LOG_SPACE_GOAL, C.LOG_SPACE_FREE).astype(np.float32)
    return G.make_state(u, goal | obstacle, epsilon=1e-3, device="cpu")


def worker_volume(size: int = 48) -> G.GridState:
    """The seeded volume of the 3D modes (``tools/multihost_worker.py``'s):
    ``max(4, size // 4) x size x size``, 10% obstacle voxels (numpy
    default_rng(7)), the shell walled, one goal at the centre, epsilon
    1e-3."""
    n, d = size, max(4, size // 4)
    rng = np.random.default_rng(7)
    obstacle = rng.random((d, n, n)) < 0.1
    goal = np.zeros((d, n, n), dtype=bool)
    goal[d // 2, n // 2, n // 2] = True
    obstacle[d // 2, n // 2, n // 2] = False
    for axis in range(3):
        for edge in (0, -1):
            obstacle[(slice(None),) * axis + (edge,)] = True
    u = np.where(goal, C.LOG_SPACE_GOAL, C.LOG_SPACE_FREE).astype(np.float32)
    return G.make_state(u, goal | obstacle, epsilon=1e-3, device="cpu")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--coordinator", required=True, help="host:port of process 0")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--out", required=True)
    ap.add_argument("--mode", default="solve",
                    choices=["solve", "update", "solve_resident", "solve3d", "solve_resident_z"])
    ap.add_argument("--size", type=int, default=48)
    args = ap.parse_args(argv)

    torch.set_num_threads(1)
    multihost.initialize(args.coordinator, args.num_processes, args.process_id, backend="gloo")
    assert multihost.world() == (args.num_processes, args.process_id)
    devices = [torch.device("cpu")] * args.local_devices
    if args.mode == "solve_resident_z":
        mesh = make_mesh3d(devices=devices)
    else:
        mesh = make_mesh(devices=devices)
    assert mesh.devices.size == args.num_processes * args.local_devices
    if args.mode == "solve":
        out = sharded.solve(worker_state(args.size), mesh)
    elif args.mode == "update":
        out = sharded.update_n(worker_state(args.size), 137, mesh)
    elif args.mode == "solve_resident":
        # A 512-wide grid, as tools/multihost_worker.py's resident mode (48 x
        # 512: 24 x 128 shards on 2 x 4); halos between the processes are the
        # resident route's copied neighbours.
        out = sharded.solve(worker_state(args.size, RESIDENT_WIDTH), mesh, kernel="resident")
    elif args.mode == "solve3d":
        out = sharded3d.solve(worker_volume(args.size), mesh)
    else:
        out = sharded3d.solve(worker_volume(args.size), mesh, kernel="resident")
    if args.process_id == 0:
        np.savez(args.out, u=out.u.numpy(), iteration=int(out.iteration),
                 delta=float(out.delta), converged=bool(out.converged),
                 process_count=multihost.world()[0])
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
