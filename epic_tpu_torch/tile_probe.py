"""Measure the routing crossover between the 2D kernels on one CUDA card.

Run from the repository root: ``python -m epic_tpu_torch.tile_probe``. It
prints the card's name and power limit, then one JSON line per grid side: a
100-sweep tick per sweep through the in-place kernel (``hopper_sweep``, K1)
and through the tile route (``hopper_tile2d``), CUDA events, mean of
``--reps`` ticks after one warm-up, beside whether
:func:`hopper_tile2d.use_tiles` sends that grid to the tiles; the rule's
threshold is set where the tile route starts to win.

The grids are built on the card from a seed (10% locked cells, the ring
locked, one goal cell); the times do not depend on the map. Each result is
checked against the other route bit for bit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess

import torch

from . import grid as G
from .solver import hopper_sweep, hopper_tile2d

SIDES = (2048, 3072, 4096, 8192)


def random_state(side: int, dev: torch.device, seed: int = 0) -> G.GridState:
    gen = torch.Generator(device=dev).manual_seed(seed)
    locked = torch.rand((side, side), generator=gen, device=dev) < 0.1
    locked[0, :] = locked[-1, :] = True
    locked[:, 0] = locked[:, -1] = True
    u = torch.full((side, side), -1e6, device=dev)
    u[side // 2, side // 2] = 0.0
    locked[side // 2, side // 2] = True
    return G.make_state(u, locked, 1e-3, device=dev)


def event_ms(fn, reps: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def probe_crossover(dev, reps: int, sides=SIDES) -> None:
    for side in sides:
        st = random_state(side, dev)
        k = dataclasses.replace(st, u=st.u.clone())
        t = dataclasses.replace(st, u=st.u.clone())
        hopper_sweep.update_n(k, 100)
        hopper_tile2d.update_n(t, 100)
        same = bool(torch.equal(k.u, t.u))
        k_ms = event_ms(lambda: hopper_sweep.update_n(k, 100), reps)
        t_ms = event_ms(lambda: hopper_tile2d.update_n(t, 100), reps)
        print(json.dumps(dict(probe="crossover", side=side, bytes=5 * side * side,
                              l2_bytes=torch.cuda.get_device_properties(dev).L2_cache_size,
                              use_tiles=hopper_tile2d.use_tiles((side, side), dev),
                              sweep2d_ms_per_sweep=k_ms / 100, tile2d_ms_per_sweep=t_ms / 100,
                              same_bits=same)), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sides", type=int, nargs="+", default=SIDES,
                    help="grid sides to probe")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tile_probe needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    probe_crossover(dev, args.reps, args.sides)


if __name__ == "__main__":
    main()
