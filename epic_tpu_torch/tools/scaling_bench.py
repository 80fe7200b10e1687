"""Scaling harness on the port: sweeps/s of the sharded solver against the
number of shards of a virtual mesh.

The twin of the JAX package's ``tools/scaling_bench.py``. It runs
``parallel.sharded.update_n`` (the halo exchange and the shard chunks) on a
mesh of n shards, all on the one ``--device`` (``make_mesh((my, n // my),
devices=[device] * n)``): on a card the shard entry ``epic_shard2d_chunk``
(K14/K15, ``--kernel pallas``) or the resident entries
``epic_resident2d_cycle`` (K16/K17, ``--kernel resident``, and what
``auto`` takes where a shard is small enough, ``sharded.prefers_resident``).

CAVEAT recorded in the CSV: the shards of a virtual mesh share one card (or
the host's cores), so the compute budget does not grow with n and dividing
by n (``efficiency_vs_first``) is the wrong normalization here. The
meaningful number is ``throughput_vs_1dev``: n-shard throughput over the
1-shard throughput at the same total size; about 1.0 means the sharded
program (exchanges, halo recompute, per-shard launches) adds no overhead
over one shard. ``--assert-efficiency`` is therefore skipped, as the JAX
tool skips it on its virtual CPU mesh.

Usage: python -m epic_tpu_torch.tools.scaling_bench [--sizes 1024 4096]
       [--sweeps 200] [--devices 1 2 4 8] [--kernel auto]
       [--csv results_scaling.csv] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import csv
import os
import pathlib
import time

import torch

from . import add_device_flag, resolve_device, synchronize


def run(sizes, sweeps: int, devices, kernel: str, chunk_depth: int, device: torch.device,
        fields: dict | None = None) -> list[dict]:
    """The table's rows, printed as they come; with ``fields``, each run's
    relaxed state is kept there under ``(size, n)``."""
    from .. import grid, maps
    from ..parallel import make_mesh, sharded

    rows = []
    for size in sizes:
        img = maps.random_obstacles(size, size, density=0.1, seed=0)
        base = None
        print(f"grid {size}^2, {sweeps} sweeps per measurement, backend={device.type}, "
              f"kernel={kernel}")
        print("devices  mesh      sweeps/s   cell-updates/s   eff/dev  vs-1dev")
        for n in devices:
            my, mx = sharded.near_square(n)
            mesh = make_mesh((my, mx), devices=[device] * n)
            st = grid.from_occupancy_image(img, 1e-6, device=device)
            out = sharded.update_n(st, sweeps, mesh, chunk_depth=chunk_depth,
                                   kernel=kernel)  # warm-up: builds and loads the kernels
            float(out.delta)
            st = grid.from_occupancy_image(img, 1e-6, device=device)
            synchronize(device)
            t0 = time.perf_counter()
            out = sharded.update_n(st, sweeps, mesh, chunk_depth=chunk_depth, kernel=kernel)
            float(out.u.sum())  # the whole field read: the completion barrier
            dt = time.perf_counter() - t0
            if fields is not None:
                fields[(size, n)] = out
            sps = sweeps / dt
            cups = (size - 2) ** 2 / 2 * sps
            if base is None:
                base = (sps, n)
            eff = sps / (base[0] * n / base[1])
            tput = sps / base[0]
            print(f"{n:7d}  ({my},{mx})   {sps:9.1f}  {cups:13.3e}   {eff:6.2f}  x{tput:5.2f}")
            rows.append(dict(
                backend=device.type, kernel=kernel, size=size, devices=n, mesh=f"{my}x{mx}",
                sweeps=sweeps, chunk_depth=chunk_depth, sweeps_per_s=round(sps, 2),
                cell_updates_per_s=round(cups), efficiency_vs_first=round(eff, 3),
                throughput_vs_1dev=round(tput, 3),
                caveat=("virtual-mesh-shards-share-one-card" if device.type == "cuda"
                        else f"virtual-cpu-shards-share-{os.cpu_count()}-cores"),
            ))
    return rows


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[1024])
    ap.add_argument("--sweeps", type=int, default=100)
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8],
                    help="shard counts of the virtual mesh")
    ap.add_argument("--kernel", default="auto",
                    help="the mesh route (sharded.update_n's kernel=): auto, pallas, "
                         "resident on a card; auto, xla on the CPU")
    ap.add_argument("--chunk-depth", type=int, default=16)
    ap.add_argument("--csv", default=None,
                    help="append rows to this CSV (written with header if new)")
    ap.add_argument("--assert-efficiency", type=float, default=None,
                    help="exit nonzero if any >=2-shard row's efficiency_vs_first is "
                         "below this bound on a real mesh; skipped on a virtual mesh")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rows = run(args.sizes, args.sweeps, args.devices, args.kernel, args.chunk_depth, device)

    if args.csv:
        path = pathlib.Path(args.csv)
        new = not path.exists()
        with path.open("a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            if new:
                w.writeheader()
            w.writerows(rows)
        print(f"wrote {len(rows)} rows -> {path}")

    if args.assert_efficiency is not None:
        print("efficiency assertion skipped: virtual mesh (the shards share one "
              f"{'card' if device.type == 'cuda' else 'host'})")
    return rows


if __name__ == "__main__":
    main()
