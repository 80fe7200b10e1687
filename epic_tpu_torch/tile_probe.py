"""Measure the routing crossovers of the tile kernels on one CUDA card.

Run from the repository root: ``python -m epic_tpu_torch.tile_probe
[--sides ...] [--volumes ...] [--shapes] [--mesh3d] [--mesh2d]``. It prints the card's
name and
power limit, then one JSON line per measurement, CUDA events, mean of
``--reps`` ticks after one warm-up:

- ``--sides`` (2D, the default): a 100-sweep tick per sweep through the
  in-place kernel (``hopper_sweep``, K1) and through the tile route
  (``hopper_tile2d``) on square grids, beside whether
  :func:`hopper_tile2d.use_tiles` sends that grid to the tiles;
- ``--volumes`` (3D): the same through K7 (``hopper_sweep3d``) and the 3D
  tile route (``hopper_tile3d``) on volumes given as ``D`` (a cube) or
  ``DxHxW``, beside :func:`hopper_tile3d.use_tiles`;
- ``--shapes`` (3D): the tile shape of ``csrc/tile3d.cu``. Each candidate
  centre and block size is built as a copy of that source with its
  constants replaced (under the build directory; the source keeps its one
  shape), and its cycle entry runs a 100-sweep tick at each depth that fits
  shared memory, on the ``--volumes`` shapes;
- ``--mesh3d`` (3D): the mesh orientation. A 100-sweep resident tick
  (``sharded3d.update_n_resident3d``) of each volume on a virtual z mesh
  of 8 shards and on a 2 x 4 plane mesh of the card, beside the model
  costs of :func:`sharded3d.sweep_cost` and the mesh
  :func:`sharded3d.choose_mesh3d` picks (default volumes:
  ``MESH_VOLUMES``, or the ``--volumes`` shapes);
- ``--mesh2d`` (2D): the mesh route. A 100-sweep tick and a solve capped
  at 500 sweeps of each square grid (``MESH_SIDES``, or the ``--sides``)
  on a 2 x 4 virtual mesh of the card through the per-shard route
  (``kernel="pallas"``) and the resident route (``kernel="resident"``),
  beside the route :func:`sharded.prefers_resident` picks.

Each routing rule's threshold is set where the tile route starts to win.
States are built on the card from a seed (10% locked cells, the shell
locked, one goal cell); the times do not depend on the map. Each result is
checked against the in-place route bit for bit.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import re
import subprocess

import torch

from . import grid as G
from .solver import _build, hopper_sweep, hopper_sweep3d, hopper_tile2d, hopper_tile3d, tiled

SIDES = (2048, 3072, 4096, 8192)
VOLUMES = ("160", "192", "224", "256", "320", "32x2048x2048")
# (TD, TH, TW, threads) candidates for --shapes.
SHAPES = ((8, 16, 64, 512), (16, 16, 64, 512), (8, 32, 64, 512), (8, 16, 64, 256),
          (8, 16, 128, 512), (16, 16, 64, 256))
DEPTHS = (2, 3, 4)
# --mesh3d's volumes: the two of chip_smoke.py's phases 20-22, and depths of
# 1024^2, 512^2 and 256^2 planes around the model's switch to the z mesh.
MESH_VOLUMES = ("256", "64x1024x1024", "128x1024x1024", "256x1024x1024", "384x1024x1024",
                "512x1024x1024", "128x512x512", "256x512x512", "64x256x256", "128x256x256")
# --mesh2d's grid sides: the maze's, and squares up to chip_smoke.py's 16384^2.
MESH_SIDES = (482, 1024, 2048, 3072, 4096, 6144, 8192, 12288, 16384)


def random_state(shape, dev: torch.device, seed: int = 0) -> G.GridState:
    gen = torch.Generator(device=dev).manual_seed(seed)
    locked = torch.rand(shape, generator=gen, device=dev) < 0.1
    for axis in range(len(shape)):
        locked.select(axis, 0).fill_(True)
        locked.select(axis, -1).fill_(True)
    u = torch.full(shape, -1e6, device=dev)
    centre = tuple(n // 2 for n in shape)
    u[centre] = 0.0
    locked[centre] = True
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


def volume_shape(spec: str) -> tuple[int, int, int]:
    dims = [int(v) for v in spec.split("x")]
    return tuple(dims * 3) if len(dims) == 1 else tuple(dims)


def probe_crossover(dev, reps: int, sides=SIDES) -> None:
    for side in sides:
        st = random_state((side, side), dev)
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


def probe_volumes(dev, reps: int, volumes=VOLUMES) -> None:
    for spec in volumes:
        shape = volume_shape(spec)
        st = random_state(shape, dev)
        k = dataclasses.replace(st, u=st.u.clone())
        t = dataclasses.replace(st, u=st.u.clone())
        hopper_sweep3d.update_n(k, 100)
        hopper_tile3d.update_n(t, 100)
        same = bool(torch.equal(k.u, t.u))
        k_ms = event_ms(lambda: hopper_sweep3d.update_n(k, 100), reps)
        t_ms = event_ms(lambda: hopper_tile3d.update_n(t, 100), reps)
        n = shape[0] * shape[1] * shape[2]
        print(json.dumps(dict(probe="crossover3d", shape=list(shape), bytes=5 * n,
                              l2_bytes=torch.cuda.get_device_properties(dev).L2_cache_size,
                              use_tiles=hopper_tile3d.use_tiles(shape, dev),
                              tile=list(hopper_tile3d.TILE), k=hopper_tile3d.DEFAULT_DEPTH,
                              sweep3d_ms_per_sweep=k_ms / 100, tile3d_ms_per_sweep=t_ms / 100,
                              same_bits=same)), flush=True)
        del st, k, t


def build_shapes(shapes=SHAPES) -> dict:
    """One library a candidate shape: ``csrc/tile3d.cu`` with its constants
    replaced, built beside the main library. Returns {shape: CDLL}."""
    src = (_build.CSRC / "tile3d.cu").read_text()
    out_dir = _build.BUILD_DIR / "tile_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    cmds, libs = [], {}
    for shape in shapes:
        text = src
        for name, value in zip(("kTD", "kTH", "kTW", "kThreads"), shape):
            text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                              text)
            if n != 1:
                raise RuntimeError(f"tile3d.cu has no single `constexpr int {name}`")
        tag = "x".join(map(str, shape))
        cu = out_dir / f"tile3d_{tag}.cu"
        cu.write_text(text)
        libs[shape] = out_dir / f"libtile3d_{tag}.so"
        cmds.append([nvcc, *_build.ARCH_FLAGS, "-shared", "-Xcompiler", "-fPIC",
                     "-I", str(_build.CSRC), "-o", str(libs[shape]), str(cu)])
    _build._run(cmds)
    loaded = {}
    for shape, path in libs.items():
        lib = ctypes.CDLL(str(path))
        _build.set_tile3d_types(lib)
        loaded[shape] = lib
    return loaded


def probe_shapes(dev, reps: int, volumes=VOLUMES, shapes=SHAPES, depths=DEPTHS) -> None:
    libs = build_shapes(shapes)
    smem_limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    stream = torch.cuda.current_stream(dev).cuda_stream
    for spec in volumes:
        shape = volume_shape(spec)
        st = random_state(shape, dev)
        ref = hopper_sweep3d.update_n(dataclasses.replace(st, u=st.u.clone()), 100).u
        it = torch.zeros((), dtype=torch.int32, device=dev)
        for cand, lib in libs.items():
            td, th, tw, threads = cand
            for k in depths:
                smem = (td + 2 * k) * (th + 2 * k) * (tw + 2 * k) * 5
                if smem > smem_limit:
                    continue
                n_chunks = -(-100 // k)
                a, b = st.u.clone(), torch.empty_like(st.u)
                deltas = torch.zeros(n_chunks, device=dev)

                def tick():
                    deltas.zero_()
                    _build.check(lib.epic_tile3d_cycle(
                        a.data_ptr(), b.data_ptr(), st.locked.data_ptr(), *shape, it.data_ptr(),
                        0, 100, n_chunks, deltas.data_ptr(), k, stream, dev.index),
                        "epic_tile3d_cycle")

                tick()
                same = bool(torch.equal(a if n_chunks % 2 == 0 else b, ref))
                ms = event_ms(tick, reps)
                print(json.dumps(dict(probe="shape3d", shape=list(shape), tile=[td, th, tw],
                                      threads=threads, k=k, smem_bytes=smem, chunks=n_chunks,
                                      sweeps=tiled.spread(100, n_chunks)[0],
                                      ms_per_sweep=ms / 100, same_bits=same)), flush=True)
                del a, b
        del st, ref


def probe_mesh3d(dev, reps: int, volumes=MESH_VOLUMES, shards: int = 8) -> None:
    from .parallel import make_mesh, make_mesh3d, sharded, sharded3d

    devs = [dev] * shards
    meshes = {"z": make_mesh3d((shards, 1, 1), devices=devs),
              "plane": make_mesh(sharded.near_square(shards), devices=devs)}
    for spec in volumes:
        shape = volume_shape(spec)
        st = random_state(shape, dev)
        ms, cost, fields = {}, {}, {}
        for name, mesh in meshes.items():
            sv = sharded3d.shard_state3d(st, mesh)
            sharded3d.update_n_resident3d(sv, 100, mesh)
            fields[name] = sharded3d.unshard3d(sv).u
            ms[name] = event_ms(lambda: sharded3d.update_n_resident3d(sv, 100, mesh), reps)
            cost[name] = sharded3d.sweep_cost(shape, sharded3d._extents(mesh))[1]
            del sv
        picked = sharded3d.choose_mesh3d(shape, devices=devs)
        print(json.dumps(dict(probe="mesh3d", shape=list(shape), shards=shards,
                              z_tick_ms=ms["z"], plane_tick_ms=ms["plane"],
                              z_over_plane=ms["z"] / ms["plane"],
                              model_z_over_plane=cost["z"] / cost["plane"],
                              choose_mesh3d="z" if "mz" in picked.shape else "plane",
                              same_bits=bool(torch.equal(fields["z"], fields["plane"])))),
              flush=True)
        del st, fields


def probe_mesh2d(dev, reps: int, sides=MESH_SIDES, shape=(2, 4)) -> None:
    from .parallel import make_mesh, sharded

    mesh = make_mesh(shape, devices=[dev] * (shape[0] * shape[1]))
    for side in sides:
        st = random_state((side, side), dev)
        ms, fields = {}, {}
        for kernel in ("pallas", "resident"):
            sh = sharded.shard_state(st, mesh)
            sharded.update_n_resident(sh, 100, mesh, kernel=kernel)
            ms[kernel, "tick"] = event_ms(
                lambda: sharded.update_n_resident(sh, 100, mesh, kernel=kernel), reps)
            ms[kernel, "solve"] = event_ms(
                lambda: sharded.solve_resident(sh, mesh, max_iterations=500, kernel=kernel), 1)
            fields[kernel] = sh.u
            h_loc, w_loc = sh.h_loc, sh.w_loc
            del sh
        print(json.dumps(dict(probe="mesh2d", side=side, mesh=list(shape), shard=[h_loc, w_loc],
                              k14_tick_ms=ms["pallas", "tick"],
                              resident_tick_ms=ms["resident", "tick"],
                              resident_over_k14_tick=ms["resident", "tick"] / ms["pallas", "tick"],
                              k14_solve500_ms=ms["pallas", "solve"],
                              resident_solve500_ms=ms["resident", "solve"],
                              auto="resident" if sharded.prefers_resident(mesh, h_loc, w_loc)
                              else "pallas",
                              same_bits=bool(torch.equal(fields["pallas"], fields["resident"])))),
              flush=True)
        del st, fields


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sides", type=int, nargs="*", default=None,
                    help="2D grid sides to probe (the default mode)")
    ap.add_argument("--volumes", nargs="*", default=None,
                    help="3D volumes to probe, each D (a cube) or DxHxW")
    ap.add_argument("--shapes", action="store_true",
                    help="probe the 3D tile shapes on the --volumes shapes")
    ap.add_argument("--mesh3d", action="store_true",
                    help="time the 3D mesh orientations (on the --volumes shapes if given)")
    ap.add_argument("--mesh2d", action="store_true",
                    help="time the 2D mesh routes (on the --sides grids if given)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tile_probe needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    volumes = VOLUMES if not args.volumes else args.volumes
    if args.mesh3d:
        probe_mesh3d(dev, args.reps, args.volumes or MESH_VOLUMES)
    elif args.mesh2d:
        probe_mesh2d(dev, args.reps, args.sides or MESH_SIDES)
    elif args.shapes:
        probe_shapes(dev, args.reps, volumes)
    elif args.volumes is not None:
        probe_volumes(dev, args.reps, volumes)
    else:
        probe_crossover(dev, args.reps, args.sides or SIDES)


if __name__ == "__main__":
    main()
