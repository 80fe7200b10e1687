"""Measure the routing crossovers of the tile kernels on one CUDA card.

Run from the repository root: ``python -m epic_tpu_torch.tile_probe
[--sides ...] [--volumes ...] [--shapes] [--ablate3d] [--solve3d] [--mesh3d] [--compare3d FILE]
[--mesh2d] [--shapes2d [--baseline FILE]] [--compare2d FILE] [--batch] [--lane-depths]
[--batch-small]
[--ablate-batch] [--sweep2d] [--sass]``. It prints the card's name
and power limit, then one JSON line per measurement, CUDA events, mean of
``--reps`` runs after one warm-up:

- ``--sides`` (2D, the default): a 100-sweep tick per sweep through the
  in-place kernel (``hopper_sweep``, K1) and through the tile route
  (``hopper_tile2d``) on square grids, beside whether
  :func:`hopper_tile2d.use_tiles` sends that grid to the tiles;
- ``--volumes`` (3D): the same through K7 (``hopper_sweep3d``) and the 3D
  tile route (``hopper_tile3d``) on volumes given as ``D`` (a cube) or
  ``DxHxW`` (the measurement behind sending every volume to K7);
- ``--shapes`` (3D): the column of ``csrc/tile3d.cu``. Each candidate
  column and register budget (``kTH``, ``kTW``, ``kMinBlocks``; a block has
  a lane a quad of its extended plane) is built as a copy of that source
  with its constants replaced (under the build directory; the source keeps
  its one shape),
  and its cycle entry runs a 100-sweep tick at each depth of ``DEPTHS``
  (the segments ``hopper_tile3d.tile_for`` picks for that column), held to
  K7 bit for bit, then the source's shape with the segments of 1..4
  blocks an SM; on 256^3 and 32 x 2048 x 2048, or the ``--volumes`` shapes;
- ``--mesh3d`` (3D): the mesh orientation and route. A 100-sweep
  resident tick (``sharded3d.update_n_resident3d``) of each volume on a
  virtual z mesh of 8 shards and on a 2 x 4 plane mesh of the card, each
  on the device route ("resident") and the per-shard route ("pallas"), beside
  K7's tick on the whole volume, the device route's on a 1 x 1 mesh (one
  shard, no face read from a neighbour: K7's work plus the entry's face
  tests), the model costs of :func:`sharded3d.sweep_cost` on each route,
  the mesh :func:`sharded3d.choose_mesh3d` picks, the route "auto" takes
  on each mesh (:func:`sharded3d.prefers_device`), and whether every route
  gave the same bits (default volumes: ``MESH_VOLUMES``, or the
  ``--volumes`` shapes). A last line gives, for each route, the
  ``ROW_COST`` that brings the model's z-over-plane ratios closest to the
  measured ones (least worst relative error; the per-shard route's over
  the volumes whose shards hold at least ``FIT_MIN_SHARD_VOXELS``, since
  its model leaves out the launches and the exchange);
- ``--compare3d FILE``: the source's 3D mesh entries against ``FILE``'s
  (another ``shard3d.cu``), each built into a whole library: the per-shard
  entry (``epic_shard3d_chunk``) in an 8-sweep chunk on the extended blocks
  of a 64 x 1024 x 1024 volume's 2 x 4 shard, a 256^3 volume's 2 x 4 shard
  and its 8 x 1 x 1 shard, and the 256^3 per-shard 100-sweep tick on both
  meshes; where FILE has the device entries too, the device route's
  100-sweep ticks of 256^3 on 2 x 4, 8 x 1 x 1 and 1 x 1 and of 64 x 1024
  x 1024 on 2 x 4, and its 256^3 solve capped at 500 on 2 x 4. In turns
  (FILE, source, source, FILE), the results held equal bit for bit;
- ``--mesh2d`` (2D): the mesh route. A 100-sweep tick and a solve capped
  at 500 sweeps of each square grid (``MESH_SIDES``, or the ``--sides``)
  on a 2 x 4 virtual mesh of the card through the per-shard route
  (``kernel="pallas"``) and the resident route (``kernel="resident"``),
  beside the route :func:`sharded.prefers_resident` picks;
- ``--shapes2d`` (2D): the tile shape of ``csrc/tile2d.cu``. Each candidate
  ``(kTH, kTW, kThreads, kMinBlocks)`` of ``SHAPES2D`` is built as a copy of
  the library with those constants replaced in ``tile2d.cu`` (under the
  build directory; the source keeps its one shape), and each of its
  ``-Xptxas -v`` lines is printed. At each depth of ``DEPTHS2D`` whose tile
  fits shared memory it times one chunk of K sweeps on an 8192² grid and
  on one 8192 x 4096 shard's K-extended block (the 16384² mesh's), and a
  100-sweep cycle on the 8192² grid, each held to the plain version bit for
  bit. With ``--baseline FILE`` (another ``tile2d.cu``, such as an earlier
  design, with its own constants) that file is built and timed the same
  way, in turns with the source's shape (baseline, source, source,
  baseline);
- ``--compare2d FILE``: the source's 2D tile, shard and resident entries
  against ``FILE``'s (another ``tile2d.cu`` with the same entries), each
  built into a whole library, at every shape of PERF.md's table of them:
  entries, ticks and solves through the wrappers with one library loaded
  and then the other, in turns (FILE, source, source, FILE) for each in
  a row, the results of the two held equal bit for bit;
- ``--batch``: the batched scenario kernels (``csrc/batched2d.cu``, and
  the tiled route's ``epic_lanes2d_*`` in ``csrc/tile2d.cu``). Each
  candidate of ``LANE_BLOCKS`` (one block for every lane, or the source's
  rule) is built as a copy of the library with those constants replaced
  (under the build directory), and each of its ``-Xptxas -v`` lines is
  printed. For square
  lanes of each side in ``BATCH_SIDES`` and the largest that
  :func:`hopper_batched.lane_resident` admits, as many lanes as fill 4096 x
  128^2 cells, a 100-sweep chunk on the resident route under each candidate
  and on the tiled route; at 128^2 also the solve capped at 1,000, a
  chunk with one lane active, and chip_smoke.py's goal batch (cap 8,000). In turns (each candidate, then the tiled
  route, then the same in reverse), the results held equal bit for bit.
  Then the cluster route: each ``CLUSTER_VARIANTS`` copy at each cluster
  size of ``CLUSTER_SIZES`` that fits, for square lanes of each side of
  ``CLUSTER_SIDES`` (or ``--sides``, which also skips the resident part)
  and the largest :func:`hopper_batched.lane_cluster` admits, at each
  batch of ``CLUSTER_LANES``, a 100-sweep chunk beside the tiled route
  (at ``CLUSTER_SOLVE`` also the capped solve), in turns, the same bits;
  each row names the cluster the rule picks, and a ``rule_fit`` row each
  (side, lanes) the source's time at the rule's cluster without the batch
  test beside the tiled route's: the data of ``lane_cluster``'s
  batch-size threshold. Last the tiled route's depth: a 100-sweep chunk
  and a capped solve of each ``LANE_DEPTH_CASES`` batch (chip_smoke.py's
  phase 25, few lanes past every cluster, and batches that clusters
  hold) at each depth of ``LANE_DEPTHS``, in turns, the same bits
  (``--lane-depths`` runs this part alone);
- ``--batch-small``: each cluster variant on small lanes at clusters of
  2, 3, 4 and 8, a gated chunk and a capped solve held to the plain
  version bit for bit; small enough to run under ``compute-sanitizer``;
- ``--ablate-batch``: where the cluster route spends its time. Copies of
  the library whose ``csrc/batched2d.cu`` drops the cluster barrier after
  each sweep, or the edge pushes, time a 100-sweep chunk of 256 lanes
  beside the source's (``ABLATE_BATCH_CASES``); only the source's bits are
  checked;
- ``--ablate3d``: where the 3D tile pass spends its time. Copies of the
  library whose ``csrc/tile3d.cu`` replaces each lse6 by a max of the six
  neighbours, or drops the barrier of each step, time a 100-sweep tick
  beside the source's on 256^3 and 32 x 2048 x 2048 (the copies' bits are
  not the plain version's; only the source's are checked, against K7);
- ``--solve3d``: the 3D tile solve kernel with the pass inlined once (the
  source) and twice (the check chunk and the other chunks at two call
  sites, ``SOLVE3D``), each built into a whole library, at every depth on
  ``SOLVE3D_VOLUMES`` (or the ``--volumes`` shapes), capped at 300 sweeps
  and to convergence, held to K7's solve: the voxels that differ;
- ``--sweep2d``: where K1's sweep goes, a 1,000-sweep maze tick on
  ``csrc/sweep2d.cu`` and on copies without its grid barrier or with only
  the barrier (``ABLATE_INPLACE``); then squares of ``SWEEP2D_SIDES``
  around the L2 crossover, a tick and a capped solve on K1/K2 and on the
  tiles, in turns, the same bits (the source of ``past_crossover``);
- ``--sass``: the SASS instructions of one ``lse4`` and one ``lse6``
  update (``sweep_common.cuh``), counted with ``cuobjdump -sass`` in a
  kernel that computes one a thread, less a kernel that adds the same
  loaded values (chip_smoke.py's ``LSE4_SASS`` and ``LSE6_SASS``).

Each 2D routing rule's threshold is set where the tile route starts to win;
in 3D the tiles won on no volume, so every volume runs on K7.
States are built on the card from a seed (10% locked cells, the shell
locked, one goal cell); the times do not depend on the map. Each result is
checked against the in-place route bit for bit.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import itertools
import json
import pathlib
import re
import shutil
import subprocess

import torch

from . import grid as G
from .solver import _build, hopper_sweep, hopper_sweep3d, hopper_tile2d, hopper_tile3d

SIDES = (2048, 3072, 4096, 8192)
VOLUMES = ("30x256x256", "64x256x256", "160", "192", "224", "256", "320", "384", "448", "512",
           "640", "64x1024x1024", "32x2048x2048", "32x1448x1448", "128x1448x1448",
           "1024x512x512", "2048x256x256", "2048x384x384", "768")
# (TH, TW, blocks an SM) candidates for --shapes: the source's shape first,
# then other register budgets (blocks an SM; a block has a lane a quad of
# its plane) and shorter, taller and wider columns (less halo recompute,
# fewer columns).
SHAPES = ((32, 128, 1), (32, 64, 1), (32, 64, 2), (16, 64, 2), (16, 64, 3), (24, 64, 2),
          (32, 96, 1))
DEPTHS = (2, 3, 4, 5)
SHAPE_VOLUMES = ("256", "32x2048x2048")
# --mesh3d's volumes: the two of chip_smoke.py's phases 20-22, and depths of
# 1024^2, 512^2 and 256^2 planes around the model's switch to the z mesh.
MESH_VOLUMES = ("256", "64x1024x1024", "128x1024x1024", "256x1024x1024", "384x1024x1024",
                "512x1024x1024", "128x512x512", "256x512x512", "64x256x256", "128x256x256")
# The smallest shard (voxels) whose per-shard tick --mesh3d fits the model to.
FIT_MIN_SHARD_VOXELS = 4_000_000
# --mesh2d's grid sides: the maze's, and squares up to chip_smoke.py's 16384^2.
MESH_SIDES = (482, 1024, 2048, 3072, 4096, 6144, 8192, 12288, 16384)
# (kTH, kTW, kThreads, kMinBlocks) candidates for --shapes2d: the class row
# (kTW / 2 + K cells) near a whole number of warp passes or not, taller and
# wider tiles (less halo recompute, fewer blocks an SM), and a register
# budget for three blocks an SM.
SHAPES2D = ((64, 128, 512, 2), (64, 160, 512, 3), (96, 160, 512, 2), (128, 96, 512, 2),
            (128, 160, 1024, 1), (160, 160, 1024, 1), (96, 224, 1024, 1), (128, 224, 1024, 1))
DEPTHS2D = (8, 12, 16, 24)
SHAPE2D_NAMES = ("kTH", "kTW", "kThreads", "kMinBlocks")
# --shapes2d's grid and shard: chip_smoke.py's 8192^2 and one 8192 x 4096
# shard of its 16384^2 mesh.
BIG2D = (8192, 8192)
SHARD2D = (8192, 4096)
# --batch's candidates: csrc/batched2d.cu's constants replaced so that every
# lane takes one block (threads, blocks an SM the registers are held to), and
# the source's own rule (256 threads where three lanes fit an SM, else 512).
# A 128^2 lane fits three blocks an SM; 512 threads at three hold 40
# registers a thread.
LANE_BLOCKS = {
    "t256b3": {"kSmallLaneThreads": 256, "kSmallLaneMinBlocks": 3, "kSmallLanesPerSM": 1},
    "t512b2": {"kBigLaneThreads": 512, "kBigLaneMinBlocks": 2, "kSmallLanesPerSM": 99},
    "t512b3": {"kSmallLaneThreads": 512, "kSmallLaneMinBlocks": 3, "kSmallLanesPerSM": 1},
    "rule": {},
}
BATCH_SIDES = (32, 64, 96, 128, 160, 192, 224)
BATCH_CELLS = 4096 * 128 * 128
# --batch's cluster candidates: csrc/batched2d.cu as it is and with 1024
# threads a block; each at every cluster size of CLUSTER_SIZES whose band
# fits, at each side of CLUSTER_SIDES (and the largest lane_cluster admits)
# and each batch of CLUSTER_LANES lanes, beside the tiled route.
CLUSTER_VARIANTS = {
    "source": {},
    "t1024": {"kClusterThreads": 1024},
}
CLUSTER_SIZES = (2, 3, 4, 6, 8, 16)
CLUSTER_SIDES = (240, 300, 384, 512, 640, 900)
CLUSTER_LANES = (8, 16, 32, 64, 256)
CLUSTER_SOLVE = (384, 256, 1000)   # side, lanes, cap of the capped solve also timed
# --batch's depth cases for the tiled route (lanes, side, solve cap; lane 0
# goalless): chip_smoke.py's batch_huge, few lanes of 1024^2, one lane,
# and two batches that clusters hold (forced onto the tiles).
LANE_DEPTH_CASES = ((32, 1024, 1200), (4, 1024, 1200), (1, 1024, 1200), (8, 512, 700),
                    (16, 930, 1000))
LANE_DEPTHS = (8, 16, 24)
BATCH_SMALL = ((3, 41, 37), (2, 3, 131), (2, 9, 20))   # --batch-small's lanes x H x W
# --ablate-batch: csrc/batched2d.cu without the cluster barrier after each
# sweep (a whole barrier kept before the chunk ends) or without the edge
# pushes (text edits; their bits are not the plain version's), timed beside
# the source on 256 lanes of these (side, cluster size).
ABLATE_BATCH = {
    "no_barrier": (("  cb.push_edges<kThreads>(q);\n  cluster_barrier();",
                    "  cb.push_edges<kThreads>(q);\n  __syncthreads();"),
                   ("  if (cb.rank == 0 && threadIdx.x == 0) delta[L] = __uint_as_float",
                    "  cb.cluster.sync();\n"
                    "  if (cb.rank == 0 && threadIdx.x == 0) delta[L] = __uint_as_float")),
    "no_push": (("    if (band.rows == 0) return;\n    const int P = m.P;",
                 "    return;\n    const int P = m.P;"),),
}
ABLATE_BATCH_CASES = ((384, 3), (384, 8), (640, 8), (930, 16))
# --sweep2d: K1/K2's in-place kernel (csrc/sweep2d.cu, a grid barrier a
# sweep) beside copies of it without the grid barrier, or with only the
# barrier (text edits; their bits are not the plain version's), and the
# sides of the size sweep against the tiles (2624 and 2688 on each side of
# the two-thirds-of-L2 crossover, past_crossover).
ABLATE_INPLACE = {
    "no_grid_barrier": (("grid.sync();", ";"),),
    "barrier_only": (("for (int y = 1 + blockIdx.x; y <= H - 2; y += gridDim.x) {",
                      "for (int y = H; y <= H - 2; y += gridDim.x) {"),),
}
SWEEP2D_SIDES = (768, 1024, 1280, 1536, 1792, 2048, 2304, 2432, 2560, 2624, 2688, 2736, 2816)
SWEEP2D_TICK = 100
SWEEP2D_CAP = 2000
# --sweep3d: K7's in-place kernels (csrc/sweep3d.cu) and, with --baseline, an
# earlier sweep3d.cu (the per-row design before the z walk: ``git show
# cd16244:epic_tpu_torch/csrc/sweep3d.cu``), each beside copies without the
# grid barrier, with only it, or without the locked loads (text edits;
# their bits are not the plain version's), and the source's design choices
# as copies that keep its bits: u through L2 only (__ldcg), segments of at
# least 4 or 8 planes, 1024 lanes a block or two blocks an SM (64
# registers), patches of at most 16, 64 or 8 quads, no prefetch of the next
# plane. Each is timed on a SWEEP3D_SWEEPS-sweep tick of each
# SWEEP3D_SHAPES volume.
SWEEP3D_ABLATE = {
    "no_grid_barrier": (("    grid.sync();\n    sweep<false>(u, locked, g, t0 + k);",
                         "    sweep<false>(u, locked, g, t0 + k);"),),
    "barrier_only": (("for (long long unit = blockIdx.x; unit < p.units;",
                      "for (long long unit = p.units; unit < p.units;"),),
    "no_locked": (("const unsigned upd = ~(locked_bits<kVec>(locked, q.at, q.lim) | q.shell)",
                   "const unsigned upd = ~(q.shell)"),),
}
SWEEP3D_DESIGN = {
    "ldcg": (("  return *reinterpret_cast<const float4*>(p);",
              "  return __ldcg(reinterpret_cast<const float4*>(p));"),
             ("float ld1(const float* p) { return *p; }",
              "float ld1(const float* p) { return __ldcg(p); }")),
    "seg4": (("    const int tz = cdiv(n, want);\n",
              "    const int tz = cdiv(n, want);\n    if (want > 1 && tz < 4) break;\n"),),
    "seg8": (("    const int tz = cdiv(n, want);\n",
              "    const int tz = cdiv(n, want);\n    if (want > 1 && tz < 8) break;\n"),),
    "t1024": (("constexpr int kThreads3d = 512;", "constexpr int kThreads3d = 1024;"),),
    "b2": (("constexpr int kMinBlocks3d = 1;", "constexpr int kMinBlocks3d = 2;"),),
    "band16": (("constexpr int kMaxBand = 32;", "constexpr int kMaxBand = 16;"),),
    "band64": (("constexpr int kMaxBand = 32;", "constexpr int kMaxBand = 64;"),),
    "band8": (("constexpr int kMaxBand = 32;", "constexpr int kMaxBand = 8;"),),
    "no_prefetch": (("  if (more) load8<kVec>(u, q.at + 2 * q.plane, q.lim, N);"
                     "   // the next step's row z + 2",
                     "  load8<kVec>(u, q.at + q.plane, q.lim, C);"),
                    ("    C[k] = N[k];\n", ""),
                    ("  load8<kVec>(u, q.at + q.plane, q.lim, C);\n  for (int z",
                     "  for (int z")),
}
SWEEP3D_BASELINE_ABLATE = {
    "no_grid_barrier": (("    grid.sync();\n    sweep<false>(u, locked, D, H, W, t0 + k);",
                         "    sweep<false>(u, locked, D, H, W, t0 + k);"),),
    "barrier_only": (("for (long long r = blockIdx.x; r < rows; r += gridDim.x) {",
                      "for (long long r = rows; r < rows; r += gridDim.x) {"),),
}
SWEEP3D_SHAPES = ("30x256x256", "256")
SWEEP3D_SWEEPS = 1000
# --sweep3d's comparison of the baseline and the source: (volume, tick sweeps,
# solve cap) as chip_smoke.py runs them (the session volume, 256^3, the floor).
SWEEP3D_COMPARE = (("30x256x256", 50, 1_000_000), ("256", 100, 1_000_000),
                   ("32x2048x2048", 100, 500))


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
                              tile=list(hopper_tile3d.tile_for(shape, dev)),
                              k=hopper_tile3d.DEFAULT_DEPTH,
                              sweep3d_ms_per_sweep=k_ms / 100, tile3d_ms_per_sweep=t_ms / 100,
                              same_bits=same)), flush=True)
        del st, k, t


def ptxas_lines(log: str) -> list[str]:
    """The registers and spills of each kernel in an nvcc log."""
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def build_shapes(shapes=SHAPES) -> dict:
    """One library a candidate shape: ``csrc/tile3d.cu`` with its constants
    replaced, built beside the main library; prints each one's
    ``-Xptxas -v`` lines. Returns {shape: CDLL}."""
    src = (_build.CSRC / "tile3d.cu").read_text()
    out_dir = _build.BUILD_DIR / "tile_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    cmds, libs = [], {}
    for shape in shapes:
        text = src
        for name, value in zip(("kTH", "kTW", "kMinBlocks"), shape):
            text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                              text)
            if n != 1:
                raise RuntimeError(f"tile3d.cu has no single `constexpr int {name}`")
        tag = "x".join(map(str, shape))
        cu = out_dir / f"tile3d_{tag}.cu"
        cu.write_text(text)
        libs[shape] = out_dir / f"libtile3d_{tag}.so"
        cmds.append([nvcc, *_build.ARCH_FLAGS, "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                     "-I", str(_build.CSRC), "-o", str(libs[shape]), str(cu)])
    for shape, log in zip(shapes, _build._run(cmds)):
        print(json.dumps(dict(probe="ptxas", shape=list(shape), lines=ptxas_lines(log))),
              flush=True)
    loaded = {}
    for shape, path in libs.items():
        lib = ctypes.CDLL(str(path))
        _build.set_tile3d_types(lib)
        loaded[shape] = lib
    return loaded


def cycle_tick3d(lib, st, ref, tz: int, k: int, reps: int) -> tuple[float, bool]:
    """A 100-sweep tick through ``lib``'s ``epic_tile3d_cycle`` with
    segments of ``tz`` planes at depth ``k``: (mean ms, whether the first
    tick gave ``ref``'s bits)."""
    dev = st.u.device
    n_chunks = -(-100 // k)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    a, b = st.u.clone(), torch.empty_like(st.u)
    deltas = torch.zeros(n_chunks, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def tick():
        deltas.zero_()
        _build.check(lib.epic_tile3d_cycle(
            a.data_ptr(), b.data_ptr(), st.locked.data_ptr(), *st.u.shape, tz, it.data_ptr(), 0,
            100, n_chunks, deltas.data_ptr(), k, stream, dev.index), "epic_tile3d_cycle")

    tick()
    same = bool(torch.equal(a if n_chunks % 2 == 0 else b, ref))
    return event_ms(tick, reps), same


def probe_shapes(dev, reps: int, volumes=SHAPE_VOLUMES, shapes=SHAPES, depths=DEPTHS) -> None:
    libs = build_shapes(shapes)
    props = torch.cuda.get_device_properties(dev)
    smem_limit, sms = props.shared_memory_per_block_optin, props.multi_processor_count
    for spec in volumes:
        shape = volume_shape(spec)
        st = random_state(shape, dev)
        ref = hopper_sweep3d.update_n(dataclasses.replace(st, u=st.u.clone()), 100).u
        for (th, tw, per_sm), lib in libs.items():
            tz = hopper_tile3d._segments_tile(shape, per_sm * sms, (th, tw))[0]
            for k in depths:
                smem = (k + 3) * (th + 2 * k + 2) * 2 * -(-(tw + 2 * k) // 8) * 4 * 4
                if smem > smem_limit or k > hopper_tile3d.MAX_DEPTH:
                    continue
                ms, same = cycle_tick3d(lib, st, ref, tz, k, reps)
                print(json.dumps(dict(probe="shape3d", shape=list(shape), tile=[tz, th, tw],
                                      blocks_per_sm=per_sm, k=k, smem_bytes=smem,
                                      ms_per_sweep=ms / 100, same_bits=same)), flush=True)
        # The segment rule on the source's column at the default depth: the
        # segments of 1..4 blocks an SM, and the whole depth.
        th, tw = shapes[0][:2]
        tzs = {shape[0]}
        for per_sm in (1, 2, 3, 4):
            tzs.add(hopper_tile3d._segments_tile(shape, per_sm * sms, (th, tw))[0])
        for tz in sorted(tzs):
            ms, same = cycle_tick3d(libs[shapes[0]], st, ref, tz, hopper_tile3d.DEFAULT_DEPTH,
                                    reps)
            print(json.dumps(dict(probe="segments3d", shape=list(shape), tile=[tz, th, tw],
                                  segments=-(-shape[0] // tz), k=hopper_tile3d.DEFAULT_DEPTH,
                                  ms_per_sweep=ms / 100, same_bits=same)), flush=True)
        del st, ref


ABLATE3D = {
    "source": lambda t: t,
    "lse6_as_max": lambda t: t.replace(
        '#include "sweep_common.cuh"\n',
        '#include "sweep_common.cuh"\n#define lse6(a, b, c, d, e, f) '
        'fmaxf(fmaxf(fmaxf(a, b), fmaxf(c, d)), fmaxf(e, f))\n', 1),
    "no_step_barrier": lambda t: t.replace(
        "      __syncthreads();   // plane p has arrived everywhere", "      // plane p has arrived", 1),
}


def probe_ablate3d(dev, reps: int, volumes=("256", "32x2048x2048")) -> None:
    text = (_build.CSRC / "tile3d.cu").read_text()
    variants = {name: edit(text) for name, edit in ABLATE3D.items()}
    for name, v in variants.items():
        if name != "source" and v == text:
            raise RuntimeError(f"tile3d.cu no longer has what --ablate3d edits for {name}")
    libs = build_libraries(variants, "tile3d.cu")
    for spec in volumes:
        shape = volume_shape(spec)
        st = random_state(shape, dev)
        ref = hopper_sweep3d.update_n(dataclasses.replace(st, u=st.u.clone()), 100).u
        tz = hopper_tile3d.tile_for(shape, dev)[0]
        for name, lib in libs.items():
            ms, same = cycle_tick3d(lib, st, ref, tz, hopper_tile3d.DEFAULT_DEPTH, reps)
            print(json.dumps(dict(probe="ablate3d", shape=list(shape), variant=name,
                                  tile=[tz, *hopper_tile3d.COLUMN], k=hopper_tile3d.DEFAULT_DEPTH,
                                  ms_per_sweep=ms / 100, same_bits=same)), flush=True)
        del st, ref


# --solve3d: tile3d.cu's solve loop as the source has it (one call site of
# the pass for every chunk of a cycle), and with the check chunk and the
# rest chunks at two call sites, the pass inlined twice.
ONE_CALL_SITE = """    int t = it;
    for (int c = 0; c <= n_rest; ++c) {
      const bool check = c == 0;
      const int ns = check ? depth : spread_at(rest, n_rest, c - 1);
      all_tiles<K>(cur, oth, check ? u1 : nullptr, g, t, ns, check ? acc + slot : nullptr, smem);
      grid.sync();
      if (check) {
        delta = __uint_as_float(__ldcg(acc + slot));
        if (grid.thread_rank() == 0) acc[slot ^ 1] = 0u;
        slot ^= 1;
        done = delta < eps && it + 1 >= m_max;
        if (done) {
          it += 1;
          cur = u1;
          break;
        }
      }
      float* tmp = cur;
      cur = oth;
      oth = tmp;
      t += ns;
    }
    if (done) break;
"""
TWO_CALL_SITES = """    all_tiles<K>(cur, oth, u1, g, it, depth, acc + slot, smem);
    grid.sync();
    delta = __uint_as_float(__ldcg(acc + slot));
    if (grid.thread_rank() == 0) acc[slot ^ 1] = 0u;
    slot ^= 1;
    done = delta < eps && it + 1 >= m_max;
    if (done) {
      it += 1;
      cur = u1;
      break;
    }
    float* tmp = cur;
    cur = oth;
    oth = tmp;
    int t = it + depth;
    for (int c = 0; c < n_rest; ++c) {
      const int ns = spread_at(rest, n_rest, c);
      all_tiles<K>(cur, oth, nullptr, g, t, ns, nullptr, smem);
      grid.sync();
      tmp = cur;
      cur = oth;
      oth = tmp;
      t += ns;
    }
"""
SOLVE3D = {"source": lambda t: t,
           "two_call_sites": lambda t: t.replace(ONE_CALL_SITE, TWO_CALL_SITES, 1)}
SOLVE3D_VOLUMES = ("20x37x150", "70x20x70", "100x33x65", "64", "256", "32x2048x2048")


def probe_solve3d(dev, volumes=SOLVE3D_VOLUMES) -> None:
    """Each variant of ``SOLVE3D`` built into a whole library; at every
    depth 1..MAX_DEPTH and staggers 100 and 7, its tile solve capped at 300
    sweeps, and to convergence up to 256^3, held to K7's: the voxels that
    differ and the largest difference."""
    text = (_build.CSRC / "tile3d.cu").read_text()
    variants = {name: edit(text) for name, edit in SOLVE3D.items()}
    for name, v in variants.items():
        if name != "source" and v == text:
            raise RuntimeError(f"tile3d.cu no longer has what --solve3d edits for {name}")
    libs = build_libraries(variants, "tile3d.cu")
    for spec in volumes:
        shape = volume_shape(spec)
        st = random_state(shape, dev)
        caps = (300, 1_000_000) if st.u.numel() <= 256**3 else (300,)
        for stagger, cap in itertools.product((100, 7), caps):
            ref = hopper_sweep3d.solve(dataclasses.replace(st, u=st.u.clone()), stagger, cap)
            for name, lib in libs.items():
                _build._lib = lib
                for k in range(1, hopper_tile3d.MAX_DEPTH + 1):
                    out = hopper_tile3d.solve(dataclasses.replace(st, u=st.u.clone()), stagger,
                                              cap, k)
                    diff = out.u != ref.u
                    print(json.dumps(dict(
                        probe="solve3d", shape=list(shape), variant=name, k=k, stagger=stagger,
                        cap=cap, tile=list(hopper_tile3d.tile_for(shape, dev)),
                        differing=int(diff.sum()),
                        max_abs_err=float((out.u - ref.u).abs().max()),
                        same_bits=not bool(diff.any()) and int(out.iteration) == int(
                            ref.iteration) and bool(torch.equal(out.delta, ref.delta)))),
                        flush=True)
        del st
    _build._lib = None


def build_libraries(variants: dict, source: str = "tile2d.cu") -> dict:
    """One whole kernel library a variant of ``csrc/<source>`` ({name:
    source text}): the other sources compiled once, each variant beside
    them, linked and bound under the build directory. Prints each variant's
    ``-Xptxas -v`` lines; returns {name: CDLL}."""
    out_dir = _build.BUILD_DIR / "tile_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    flags = [*_build.COMPILE_FLAGS, "-I", str(_build.CSRC)]
    stem = pathlib.Path(source).stem
    cus = {name: out_dir / f"{stem}_{name}.cu" for name in variants}
    for name, text in variants.items():
        cus[name].write_text(text)
    others = {src: out_dir / f"{src.stem}.o" for src in _build.SOURCES if src.name != source}
    logs = _build._run([[nvcc, *flags, "-o", str(cu.with_suffix(".o")), str(cu)]
                        for cu in cus.values()]
                       + [[nvcc, *flags, "-o", str(o), str(src)] for src, o in others.items()])
    _build._run([[nvcc, *_build.LINK_FLAGS, "-o", str(out_dir / f"lib_{name}.so"),
                  str(cu.with_suffix(".o")), *map(str, others.values())]
                 for name, cu in cus.items()])
    libs = {}
    for name, log in zip(variants, logs):
        print(json.dumps(dict(probe="ptxas", variant=name, lines=ptxas_lines(log))), flush=True)
        libs[name] = _build.bind(ctypes.CDLL(str(out_dir / f"lib_{name}.so")))
    return libs


def shape_variant(shape) -> str:
    """``csrc/tile2d.cu`` with its (kTH, kTW, kThreads, kMinBlocks) replaced."""
    text = (_build.CSRC / "tile2d.cu").read_text()
    for name, value in zip(SHAPE2D_NAMES, shape):
        text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                          text)
        if n != 1:
            raise RuntimeError(f"tile2d.cu has no single `constexpr int {name}`")
    return text


def source_shape(text: str) -> tuple:
    """The (kTH, kTW, kThreads, kMinBlocks) of a ``tile2d.cu`` text (1 block
    an SM where it names none)."""
    vals = []
    for name in SHAPE2D_NAMES:
        m = re.search(rf"constexpr int {name} = (\d+);", text)
        vals.append(int(m.group(1)) if m else 1)
    return tuple(vals)


def shard_block(shape, k: int, dev, seed: int = 0):
    """A random K-extended shard block (10% frozen cells, a frozen outer
    ring of the block), its parity origin 1."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    he, we = shape[0] + 2 * k, shape[1] + 2 * k
    frozen = torch.rand((he, we), generator=gen, device=dev) < 0.1
    frozen[0].fill_(True)
    frozen[:, 0].fill_(True)
    u = torch.where(frozen, torch.full((he, we), -1e6, device=dev),
                    -40 * torch.rand((he, we), generator=gen, device=dev))
    return u, frozen


def probe_shapes2d(dev, reps: int, shapes=SHAPES2D, depths=DEPTHS2D,
                   baseline: str | None = None) -> None:
    from .parallel import hopper_shard2d
    from .solver import core

    variants = {"x".join(map(str, shape)): shape_variant(shape) for shape in shapes}
    if baseline is not None:
        variants["baseline"] = pathlib.Path(baseline).read_text()
    libs = build_libraries(variants)
    shape_of = {name: source_shape(text) for name, text in variants.items()}
    smem_limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    stream = torch.cuda.current_stream(dev).cuda_stream
    st = random_state(BIG2D, dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    ref_tick = core.update_n(st, 100).u
    source = "x".join(map(str, source_shape((_build.CSRC / "tile2d.cu").read_text())))
    order = list(libs)
    if baseline is not None:   # in turns: baseline, the source's shape, again, baseline
        order = [v for v in order if v not in ("baseline", source)]
        order += ["baseline", source, source, "baseline"]
    for k in depths:
        ref_chunk = core.update_n(st, k).u
        u_sh, fz_sh = shard_block(SHARD2D, k, dev)
        ref_shard = hopper_shard2d.sweep_k_local(u_sh, fz_sh, 1, 0, k)[0][k:-k, k:-k]
        dst, sh_dst = torch.empty_like(st.u), torch.empty_like(u_sh)
        a, b = st.u.clone(), torch.empty_like(st.u)
        n_chunks = -(-100 // k)
        runs: dict = {}
        for name in order:
            lib = libs[name]
            th, tw, threads, min_blocks = shape_of[name]
            smem = (int(lib.epic_tile2d_smem_bytes(k)) if hasattr(lib, "epic_tile2d_smem_bytes")
                    else (th + 2 * k) * (tw + 2 * k) * 5)   # a design of 5 B a cell
            if smem > smem_limit:
                continue
            delta = torch.zeros((), device=dev)
            deltas = torch.zeros(n_chunks, device=dev)

            def chunk():
                _build.check(lib.epic_tile2d_chunk(
                    st.u.data_ptr(), dst.data_ptr(), None, st.locked.data_ptr(), *BIG2D,
                    it.data_ptr(), 0, k, delta.data_ptr(), k, stream, dev.index),
                    "epic_tile2d_chunk")

            def shard():
                _build.check(lib.epic_shard2d_chunk(
                    u_sh.data_ptr(), sh_dst.data_ptr(), None, fz_sh.data_ptr(), u_sh.stride(0),
                    *u_sh.shape, k, 1, it.data_ptr(), 0, k, delta.data_ptr(), stream, dev.index),
                    "epic_shard2d_chunk")

            def tick():
                _build.check(lib.epic_tile2d_cycle(
                    a.data_ptr(), b.data_ptr(), st.locked.data_ptr(), *BIG2D, it.data_ptr(), 0,
                    100, n_chunks, deltas.data_ptr(), k, stream, dev.index), "epic_tile2d_cycle")

            chunk()
            same = [bool(torch.equal(dst, ref_chunk))]
            shard()
            same.append(bool(torch.equal(sh_dst[k:-k, k:-k], ref_shard)))
            a.copy_(st.u)
            tick()
            same.append(bool(torch.equal(a if n_chunks % 2 == 0 else b, ref_tick)))
            ms = {"chunk8k": event_ms(chunk, reps), "shard16k": event_ms(shard, reps),
                  "tick8k": event_ms(tick, reps)}
            runs.setdefault(name, []).append(ms)
            print(json.dumps(dict(probe="shape2d", variant=name, tile=[th, tw], threads=threads,
                                  min_blocks=min_blocks, k=k, smem_bytes=smem,
                                  chunk8k_ms=ms["chunk8k"], shard16k_ms=ms["shard16k"],
                                  tick8k_ms=ms["tick8k"], chunk8k_ms_per_sweep=ms["chunk8k"] / k,
                                  shard16k_ms_per_sweep=ms["shard16k"] / k,
                                  same_bits=all(same))), flush=True)
        if baseline is not None and "baseline" in runs and source in runs:
            mean = {n: {w: sum(r[w] for r in runs[n]) / len(runs[n]) for w in runs[n][0]}
                    for n in ("baseline", source)}
            print(json.dumps(dict(probe="shape2d_vs_baseline", k=k, source=source,
                                  **{f"{w}_speedup": mean["baseline"][w] / mean[source][w]
                                     for w in mean[source]})), flush=True)
        del u_sh, fz_sh, sh_dst, ref_shard, ref_chunk


def probe_compare2d(dev, reps: int, baseline: str) -> None:
    """The source's 2D tile, shard and resident entries against
    ``baseline``'s at PERF.md's shapes, in turns (baseline, source, source,
    baseline); each workload's results under the two held equal."""
    import numpy as np

    from . import grid as Gm
    from .parallel import hopper_resident2d, hopper_shard2d, make_mesh, sharded

    libs = {"source": _build.load(),
            "baseline": build_libraries({"baseline": pathlib.Path(baseline).read_text()})[
                "baseline"]}
    maze_img = np.load(pathlib.Path(__file__).resolve().parents[1] / "tests" / "goldens"
                       / "maze.npz")["img"]
    maze = Gm.from_occupancy_image(maze_img, 1e-3, device=dev)
    g8, g4, strip = (random_state(s, dev) for s in ((8192, 8192), (4096, 4096), (2000, 33_333)))
    g16 = random_state((16384, 16384), dev)
    mesh = make_mesh((2, 4), devices=[dev] * 8)

    def copy(s):
        return dataclasses.replace(s, u=s.u.clone())

    def fresh_mesh(state):
        sh = sharded.shard_state(state, mesh)
        sharded.update_n_resident(sh, 1, mesh, kernel="pallas")   # halos exchanged once
        return sh

    sh16 = fresh_mesh(g16)
    k = sh16.halo
    H = sh16.halo
    view = (slice(H - k, H + sh16.h_loc + k), slice(H - k, H + sh16.w_loc + k))
    ij = (0, 1)
    shard_src = sh16.u_blocks[ij][view].clone()
    shard_fz = sh16.frozen_blocks[ij][view].clone()
    shard_dst = torch.empty_like(shard_src)
    sh_maze = fresh_mesh(maze)         # one maze shard's block: the entry alone, host bound path
    km = sh_maze.halo
    mview = (slice(0, sh_maze.h_loc + 2 * km), slice(0, sh_maze.w_loc + 2 * km))
    maze_src = sh_maze.u_blocks[0, 1][mview].clone()
    maze_fz = sh_maze.frozen_blocks[0, 1][mview].clone()
    maze_dst = torch.empty_like(maze_src)
    sh_cycle = fresh_mesh(g16)
    sh_cycle.u1_blocks = sharded._blank(mesh, sh_cycle.u_blocks[0, 0].shape, sharded.FILL,
                                        torch.float32)
    plan = hopper_resident2d.plans(mesh)[0]
    cyc_start = {ij: b.clone() for ij, b in sh_cycle.u_blocks.items()}

    def cycle():
        for key, b in cyc_start.items():
            sh_cycle.u_blocks[key].copy_(b)
        hopper_resident2d.cycle(sh_cycle, plan, k, 1, 3 * k, 3, u1=True)
        return torch.cat([sh_cycle.twin_blocks[key].flatten() for key in mesh.local])

    def mesh_run(state, route, solve_cap=None):
        def run():
            sh = fresh_mesh(state)
            if solve_cap is None:
                sharded.update_n_resident(sh, 100, mesh, kernel=route)
            else:
                sharded.solve_resident(sh, mesh, max_iterations=solve_cap, kernel=route)
            return sharded.unshard(sh).u
        return run

    a8, b8 = g8.u.clone(), torch.empty_like(g8.u)
    work = {
        "shard_chunk_8192x4096_k16": (lambda: (hopper_shard2d.chunk(
            shard_src, shard_dst, shard_fz, k=k, par0=1, iteration=0, ns=k, want_delta=True),
            shard_dst)[1], 30),
        "shard_chunk_241x121_k16": (lambda: (hopper_shard2d.chunk(
            maze_src, maze_dst, maze_fz, k=km, par0=1, iteration=0, ns=km, want_delta=True),
            maze_dst)[1], 200),
        "tile_chunk_8192_16": (lambda: hopper_tile2d.sweep_chunk(g8.u, g8.locked, 0, 16, k=16)[0],
                               20),
        "tile_cycle_8192_50in4": (lambda: hopper_tile2d.sweep_cycle(
            a8.copy_(g8.u), b8, g8.locked, 0, 4, 50, k=16)[0], 10),
        "tick_8192": (lambda: hopper_tile2d.update_n(copy(g8), 100).u, 5),
        "solve_8192_cap2000": (lambda: hopper_tile2d.solve(copy(g8), 100, 2000).u, 1),
        "tick_4096": (lambda: hopper_tile2d.update_n(copy(g4), 100).u, 5),
        "solve_4096_cap2000": (lambda: hopper_tile2d.solve(copy(g4), 100, 2000).u, 1),
        "tick_strip": (lambda: hopper_tile2d.update_n(copy(strip), 100).u, 5),
        "solve_strip_cap1000": (lambda: hopper_tile2d.solve(copy(strip), 100, 1000).u, 1),
        "maze_chunk_u1_16": (lambda: hopper_tile2d.sweep_chunk(maze.u, maze.locked, 0, 16, k=16,
                                                               u1=True)[2], 50),
        "maze_tile_solve": (lambda: hopper_tile2d.solve(copy(maze)).u, 1),
        "mesh16k_tick_pershard": (mesh_run(g16, "pallas"), 3),
        "mesh16k_tick_resident": (mesh_run(g16, "resident"), 3),
        "mesh16k_solve2000_pershard": (mesh_run(g16, "pallas", 2000), 1),
        "mesh16k_solve2000_resident": (mesh_run(g16, "resident", 2000), 1),
        "resident_cycle_3x16_u1": (cycle, 5),
        "maze_mesh_solve_resident": (mesh_run(maze, "resident", 1_000_000), 1),
        "maze_mesh_solve_pershard": (mesh_run(maze, "pallas", 1_000_000), 1),
    }
    times: dict = {w: {"baseline": [], "source": []} for w in work}
    results: dict = {w: {} for w in work}
    try:
        for w, (fn, n) in work.items():      # each workload's turns back to back
            for turn in ("baseline", "source", "source", "baseline"):
                _build._lib = libs[turn]
                if turn not in results[w]:
                    results[w][turn] = fn().clone()
                times[w][turn].append(event_ms(fn, n))
    finally:
        _build._lib = libs["source"]
    for w in work:
        old = sum(times[w]["baseline"]) / 2
        new = sum(times[w]["source"]) / 2
        print(json.dumps(dict(probe="compare2d", work=w, baseline_ms=times[w]["baseline"],
                              source_ms=times[w]["source"], speedup=old / new,
                              same_bits=bool(torch.equal(results[w]["baseline"],
                                                         results[w]["source"])))), flush=True)


SASS_PROBE = r"""
#include "sweep_common.cuh"
extern "C" __global__ void probe_lse4(const float* a, float* o) {
  const int i = threadIdx.x;
  o[i] = lse4(a[i], a[i + 32], a[i + 64], a[i + 96]);
}
extern "C" __global__ void probe_add4(const float* a, float* o) {
  const int i = threadIdx.x;
  o[i] = ((a[i] + a[i + 32]) + a[i + 64]) + a[i + 96];
}
extern "C" __global__ void probe_lse6(const float* a, float* o) {
  const int i = threadIdx.x;
  o[i] = lse6(a[i], a[i + 32], a[i + 64], a[i + 96], a[i + 128], a[i + 160]);
}
extern "C" __global__ void probe_add6(const float* a, float* o) {
  const int i = threadIdx.x;
  o[i] = ((((a[i] + a[i + 32]) + a[i + 64]) + a[i + 96]) + a[i + 128]) + a[i + 160];
}
"""


def sass_counts(sass: str) -> dict:
    """Instructions of each function in ``cuobjdump -sass`` output, less the
    NOPs and the branch that parks a finished warp; and its branches."""
    counts, branches, fn = {}, {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\w+)", line)
        if m:
            fn = m.group(1)
            counts[fn], branches[fn] = 0, 0
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if fn and m:
            op = m.group(2)
            if op.startswith("NOP"):
                continue
            counts[fn] += 1
            branches[fn] += op.startswith("BRA")
    return {fn: (counts[fn], branches[fn]) for fn in counts}


def random_batch(lanes: int, side: int, dev: torch.device, seed: int = 0):
    """``lanes`` square lanes (10% locked cells, the ring locked, one goal
    cell a lane, -1e6 elsewhere) as contiguous ``(u, locked)``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    locked = torch.rand((lanes, side, side), generator=gen, device=dev) < 0.1
    locked[:, [0, -1]] = True
    locked[:, :, [0, -1]] = True
    u = torch.full((lanes, side, side), -1e6, device=dev)
    gy, gx = (torch.randint(1, side - 1, (lanes,), generator=gen, device=dev) for _ in range(2))
    lane = torch.arange(lanes, device=dev)
    u[lane, gy, gx] = 0.0
    locked[lane, gy, gx] = True
    return u, locked


def goal_batch(lanes: int, side: int, dev: torch.device):
    """chip_smoke.py's goal batch: one maps.random_obstacles(side, side,
    density=0.12, seed=5) base map, one goal a lane drawn from its free
    cells by default_rng(5)."""
    import numpy as np

    from . import maps
    from .solver import hopper_batched

    img = maps.random_obstacles(side, side, density=0.12, seed=5)
    free_y, free_x = np.nonzero(img != 0)
    picks = np.random.default_rng(5).choice(len(free_y), size=lanes, replace=True)
    goal_xy = np.stack([free_x[picks], free_y[picks]], axis=-1)[:, None, :]
    return hopper_batched.make_goal_batch(np.full(img.shape, np.float32(-1e6)), img == 0, goal_xy,
                                          device=dev)


def lane_variant(consts: dict) -> str:
    """``csrc/batched2d.cu`` with the ``constexpr int`` constants ``consts``
    ({name: value}) replaced."""
    text = (_build.CSRC / "batched2d.cu").read_text()
    for name, value in consts.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                          text)
        if n != 1:
            raise RuntimeError(f"batched2d.cu has no single `constexpr int {name}`")
    return text


def in_turns(order, work: dict, u0, reps: int, setup, what_failed: str) -> dict:
    """Each name of ``order``, then the same in reverse: ``setup(name)``,
    then each ``work`` item timed (a solve from ``u0`` afresh, a chunk on a
    copy it keeps relaxing) and its result held to the first name's, bit
    for bit. Returns {name: [row of times, row of times]}."""
    times = {name: [] for name in order}
    outs = {}
    for name in [*order, *order[::-1]]:
        setup(name)
        row = {}
        for what, fn in work.items():
            x = u0.clone()
            row[f"{what}_ms"] = event_ms(
                (lambda: fn(x.copy_(u0))) if "solve" in what else (lambda: fn(x)), reps)
            out = fn(x.copy_(u0))
            torch.cuda.synchronize()
            ref = outs.setdefault(what, [t.clone() for t in out])
            if not all(torch.equal(a, b) for a, b in zip(out, ref)):
                raise RuntimeError(f"--batch {what_failed} {what}: {name} differs")
        times[name].append(row)
    return times


def probe_batch(dev, reps: int, sides=BATCH_SIDES) -> None:
    """The resident route's block candidates and the tiled route on the
    same lanes, in turns, the same bits required."""
    from .solver import hopper_batched

    libs = build_libraries({name: lane_variant(c) for name, c in LANE_BLOCKS.items()},
                           "batched2d.cu")
    fit = 3
    while hopper_batched.lane_resident(fit + 1, fit + 1, dev):
        fit += 1
    rules = hopper_batched.lane_resident, hopper_batched.lane_cluster
    hopper_batched.lane_cluster = lambda h, w, d, lanes=None: 0   # past resident: no cluster
    order = [*libs, "tiled"]

    def setup(name):
        _build._lib = libs.get(name, libs["rule"])
        hopper_batched.lane_resident = (lambda h, w, d: False) if name == "tiled" else rules[0]

    try:
        for side in (*sides, fit):
            lanes = max(1, BATCH_CELLS // (side * side))
            u0, locked = random_batch(lanes, side, dev)
            one = torch.zeros(lanes, dtype=torch.bool, device=dev)
            one[0] = True
            work = {"chunk": lambda u: hopper_batched.update_n_batch(u, locked, 0, 100)}
            if side == 128:
                work["one_lane"] = lambda u: hopper_batched.update_n_batch(u, locked, 0, 100, one)
                work["solve"] = lambda u: hopper_batched.solve_batch_device(u, locked, 1e-2, 100,
                                                                            1000)
                gu, gl = goal_batch(lanes, side, dev)
                work["goals"] = lambda u: hopper_batched.solve_batch_device(
                    u.copy_(gu), gl, 1e-2, 100, 8000)
            times = in_turns(order, work, u0, reps, setup, f"{side}^2")
            for name, rows in times.items():
                print(json.dumps(dict(probe="batch", side=side, lanes=lanes, variant=name, **{
                    k: [r[k] for r in rows] for k in rows[0]})), flush=True)
    finally:
        hopper_batched.lane_resident, hopper_batched.lane_cluster = rules
        _build._lib = None


def probe_clusters(dev, reps: int, sides=CLUSTER_SIDES) -> None:
    """The cluster route's candidates (variant, cluster size) and the tiled
    route on the same lanes, in turns, the same bits required; then each
    (side, lanes)'s ``rule_fit`` row."""
    from .solver import hopper_batched

    libs = build_libraries({name: lane_variant(c) for name, c in CLUSTER_VARIANTS.items()},
                           "batched2d.cu")
    _build._lib = libs["source"]
    largest = hopper_batched.max_cluster(dev)
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    top = 237
    while hopper_batched.lane_cluster(top + 1, top + 1, dev):
        top += 1
    rules = hopper_batched.lane_resident, hopper_batched.lane_cluster
    print(json.dumps(dict(probe="cluster_rule", max_cluster=largest, smem_limit=limit,
                          largest_side=top)), flush=True)

    def setup(key):
        name, c = key
        _build._lib = libs.get(name, libs["source"])
        hopper_batched.lane_cluster = lambda h, w, d, lanes=None, c=c: c

    try:
        hopper_batched.lane_resident = lambda h, w, d: False
        for side, lanes in itertools.product((*sides, top), CLUSTER_LANES):
            u0, locked = random_batch(lanes, side, dev)
            order = [(name, c) for name in libs for c in CLUSTER_SIZES
                     if c <= largest and hopper_batched.cluster_smem_bytes(side, side, c) <= limit]
            order.append(("tiled", 0))
            work = {"chunk": lambda u: hopper_batched.update_n_batch(u, locked, 0, 100)}
            if (side, lanes) == CLUSTER_SOLVE[:2]:
                work["solve"] = lambda u: hopper_batched.solve_batch_device(
                    u, locked, 1e-2, 100, CLUSTER_SOLVE[2])
            times = in_turns(order, work, u0, reps, setup, f"{lanes} x {side}^2")
            rule = rules[1](side, side, dev, lanes)
            for (name, c), rows in times.items():
                print(json.dumps(dict(probe="cluster", side=side, lanes=lanes, variant=name,
                                      blocks=c, rule=rule, **{
                                          k: [r[k] for r in rows] for k in rows[0]})), flush=True)
            alone = rules[1](side, side, dev)
            mean = {key: sum(r["chunk_ms"] for r in rows) / len(rows)
                    for key, rows in times.items()}
            print(json.dumps(dict(probe="rule_fit", side=side, lanes=lanes, cluster=alone,
                                  cluster_ms=mean.get(("source", alone)),
                                  tiled_ms=mean[("tiled", 0)], rule=rule)), flush=True)
            del u0, locked
    finally:
        hopper_batched.lane_resident, hopper_batched.lane_cluster = rules
        _build._lib = None


def probe_lane_depths(dev, reps: int, cases=LANE_DEPTH_CASES, depths=LANE_DEPTHS) -> None:
    """The tiled route at each depth of ``depths`` on each batch of
    ``cases`` (lanes, side, solve cap; lane 0 goalless): a 100-sweep chunk
    and the capped solve, in turns, the same bits required."""
    from .solver import hopper_batched

    rules = hopper_batched.lane_resident, hopper_batched.lane_cluster, hopper_batched.DEPTH

    def setup(depth):
        hopper_batched.DEPTH = depth

    try:
        hopper_batched.lane_resident = lambda h, w, d: False
        hopper_batched.lane_cluster = lambda h, w, d, lanes=None: 0
        for lanes, side, cap in cases:
            u0, locked = random_batch(lanes, side, dev, seed=2)
            u0[0] = -1e6   # goalless: it retires at its first check past `side` sweeps
            work = {"chunk": lambda u: hopper_batched.update_n_batch(u, locked, 0, 100),
                    "solve": lambda u: hopper_batched.solve_batch_device(u, locked, 1e-2, 100,
                                                                         cap)}
            times = in_turns(depths, work, u0, reps, setup, f"{lanes} x {side}^2")
            for name, rows in times.items():
                print(json.dumps(dict(probe="lane_depth", side=side, lanes=lanes, cap=cap,
                                      depth=name, **{k: [r[k] for r in rows] for k in rows[0]})),
                      flush=True)
            del u0, locked
    finally:
        hopper_batched.lane_resident, hopper_batched.lane_cluster, hopper_batched.DEPTH = rules


def probe_batch_small(dev) -> None:
    """Each ``CLUSTER_VARIANTS`` copy on small lanes (``BATCH_SMALL``) at
    clusters of 2, 3, 4 and 8: a gated 7-sweep chunk from an odd iteration
    and a solve capped at 300 (stagger 7, a goalless lane), held to the
    plain version bit for bit. Small enough to run under compute-sanitizer."""
    from .solver import batched, hopper_batched

    libs = build_libraries({name: lane_variant(c) for name, c in CLUSTER_VARIANTS.items()},
                           "batched2d.cu")
    rules = hopper_batched.lane_resident, hopper_batched.lane_cluster
    try:
        hopper_batched.lane_resident = lambda h, w, d: False
        for (lanes, h, w), (name, lib), c in itertools.product(BATCH_SMALL, libs.items(),
                                                               (2, 3, 4, 8)):
            _build._lib = lib
            hopper_batched.lane_cluster = lambda hh, ww, d, lanes=None, c=c: c
            u, locked = random_batch(lanes, max(h, w), dev, seed=c)
            u, locked = u[:, :h, :w].contiguous(), locked[:, :h, :w].contiguous()
            locked[:, -1] = True
            locked[:, :, -1] = True
            u[0] = -1e6   # a goalless lane
            gate = torch.arange(lanes, device=dev) % 3 != 1
            chunk = hopper_batched.update_n_batch(u.clone(), locked, 1, 7, gate)
            solve = hopper_batched.solve_batch_device(u.clone(), locked, 1e-2, 7, 300)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in (
                *zip(chunk, batched.update_n_batch(u, locked, 1, 7, gate)),
                *zip(solve, batched.solve_batch(u, locked, 1e-2, 7, 300))))
            print(json.dumps(dict(probe="batch_small", shape=[lanes, h, w], variant=name,
                                  blocks=c, same_bits=same)), flush=True)
    finally:
        hopper_batched.lane_resident, hopper_batched.lane_cluster = rules
        _build._lib = None


def probe_ablate_batch(dev, reps: int) -> None:
    """The cluster chunk's time with its barrier or its pushes taken out,
    beside the source's, in turns; only the source's bits are checked
    (against the plain version)."""
    from .solver import batched, hopper_batched

    text = (_build.CSRC / "batched2d.cu").read_text()
    variants = {"source": text}
    for name, edits in ABLATE_BATCH.items():
        v = text
        for old, new in edits:
            if v.count(old) != 1:
                raise RuntimeError(f"batched2d.cu no longer has what --ablate-batch edits for {name}")
            v = v.replace(old, new)
        variants[name] = v
    libs = build_libraries(variants, "batched2d.cu")
    rules = hopper_batched.lane_resident, hopper_batched.lane_cluster
    try:
        hopper_batched.lane_resident = lambda h, w, d: False
        for side, c in ABLATE_BATCH_CASES:
            hopper_batched.lane_cluster = lambda h, w, d, lanes=None, c=c: c
            u0, locked = random_batch(256, side, dev)
            times = {name: [] for name in libs}
            for name in [*libs, *reversed(libs)]:
                _build._lib = libs[name]
                x = u0.clone()
                times[name].append(event_ms(
                    lambda: hopper_batched.update_n_batch(x, locked, 0, 100), reps))
            _build._lib = libs["source"]
            out = hopper_batched.update_n_batch(u0.clone(), locked, 0, 100)
            ref = batched.update_n_batch(u0, locked, 0, 100)
            same = all(torch.equal(a, b) for a, b in zip(out, ref))
            print(json.dumps(dict(probe="ablate_batch", side=side, lanes=256, blocks=c,
                                  source_same_bits=same, chunk_ms=times)), flush=True)
            del u0, locked, out, ref
    finally:
        hopper_batched.lane_resident, hopper_batched.lane_cluster = rules
        _build._lib = None


def sass_of(path) -> str:
    """``cuobjdump -sass`` of an object or library (cuobjdump on PATH or
    beside nvcc)."""
    cuobjdump = (shutil.which("cuobjdump")
                 or str(pathlib.Path(_build.find_nvcc()).with_name("cuobjdump")))
    return subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout


def probe_sass() -> None:
    out_dir = _build.BUILD_DIR / "tile_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, obj = out_dir / "sass_probe.cu", out_dir / "sass_probe.o"
    cu.write_text(SASS_PROBE)
    _build._run([[_build.find_nvcc(), *_build.ARCH_FLAGS, "-c", "-I", str(_build.CSRC),
                  "-o", str(obj), str(cu)]])
    sass = sass_of(obj)
    counts = sass_counts(sass)
    (out_dir / "sass_probe.sass").write_text(sass)
    for name, base, adds in (("lse4", "probe_add4", 3), ("lse6", "probe_add6", 5)):
        n, br = counts[f"probe_{name}"]
        n0, br0 = counts[base]
        print(json.dumps(dict(probe="sass", update=name, instructions=n - n0 + adds,
                              kernel_instructions=n, baseline_instructions=n0,
                              branches=br - br0, command=f"cuobjdump -sass {obj.name}")),
              flush=True)


def probe_mesh3d(dev, reps: int, volumes=MESH_VOLUMES, shards: int = 8) -> None:
    from .parallel import make_mesh, make_mesh3d, sharded, sharded3d

    devs = [dev] * shards
    meshes = {"z": make_mesh3d((shards, 1, 1), devices=devs),
              "plane": make_mesh(sharded.near_square(shards), devices=devs)}
    one = make_mesh((1, 1), devices=[dev])
    kernels = {"device": "resident", "shard": "pallas"}
    rows = []
    for spec in volumes:
        shape = volume_shape(spec)
        st = random_state(shape, dev)
        k7 = dataclasses.replace(st, u=st.u.clone())
        k7_ms = event_ms(lambda: hopper_sweep3d.update_n(k7, 100), reps)
        ms, cost, fields = {}, {}, {}
        for name, mesh in {**meshes, "one": one}.items():
            for route, kernel in kernels.items():
                if name == "one" and route == "shard":
                    continue
                sv = sharded3d.shard_state3d(st, mesh)
                sharded3d.update_n_resident3d(sv, 100, mesh, kernel=kernel)
                fields[name, route] = sharded3d.unshard3d(sv).u
                ms[name, route] = event_ms(
                    lambda: sharded3d.update_n_resident3d(sv, 100, mesh, kernel=kernel), reps)
                cost[name, route] = sharded3d.sweep_cost(shape, sharded3d._extents(mesh),
                                                         route=route)[1]
                del sv
        picked = sharded3d.choose_mesh3d(shape, devices=devs)
        auto = {}
        for name, mesh in meshes.items():
            ext = sharded3d._extents(mesh)
            loc = [p // n for p, n in zip(sharded3d.padded_shape(shape, mesh), ext)]
            k = sharded3d.halo_for(shape, mesh, sharded3d.DEFAULT_CHUNK_DEPTH)
            auto[name] = ("device" if sharded3d.prefers_device(loc, [n > 1 for n in ext], k)
                          else "shard")
        ref = fields["one", "device"]
        row = dict(probe="mesh3d", shape=list(shape), shards=shards, k7_tick_ms=k7_ms,
                   one_shard_device_tick_ms=ms["one", "device"],
                   **{f"{name}_{route}_tick_ms": ms[name, route]
                      for name in meshes for route in kernels},
                   **{f"{route}_z_over_plane": ms["z", route] / ms["plane", route]
                      for route in kernels},
                   **{f"model_{route}_z_over_plane": cost["z", route] / cost["plane", route]
                      for route in kernels},
                   **{f"{name}_device_over_shard": ms[name, "device"] / ms[name, "shard"]
                      for name in meshes},
                   choose_mesh3d="z" if "mz" in picked.shape else "plane", auto=auto,
                   same_bits=all(bool(torch.equal(f, ref)) for f in fields.values()))
        rows.append((shape, row))
        print(json.dumps(row), flush=True)
        del st, k7, fields
    print(json.dumps(dict(probe="mesh3d_fit", **{
        f"row_cost_{route}": fit_row_cost(rows, route) for route in kernels})), flush=True)


def fit_row_cost(rows, route: str) -> dict:
    """The ``ROW_COST[route]`` (a quarter-slot grid on 0..64) whose model
    z-over-plane ratios come closest to the measured ones: the least worst
    relative error over the volumes (the per-shard route's over those whose
    shards hold at least ``FIT_MIN_SHARD_VOXELS``), and that error."""
    from .parallel import sharded, sharded3d

    kept = sharded3d.ROW_COST[route]
    best = None
    try:
        for q in range(0, 257):
            sharded3d.ROW_COST[route] = q / 4
            err = 0.0
            for shape, row in rows:
                if route == "shard" and shape[0] * shape[1] * shape[2] < (
                        FIT_MIN_SHARD_VOXELS * row["shards"]):
                    continue
                ext = {name: e for name, e in (("z", (row["shards"], 1, 1)),
                                               ("plane", (1, *sharded.near_square(row["shards"]))))}
                z, p = (sharded3d.sweep_cost(shape, ext[n], route=route)[1] for n in ("z", "plane"))
                err = max(err, abs(z / p / row[f"{route}_z_over_plane"] - 1))
            if best is None or err < best[1]:
                best = (q / 4, err)
    finally:
        sharded3d.ROW_COST[route] = kept
    return {"row_cost": best[0], "max_rel_err": best[1]}


def probe_compare3d(dev, reps: int, baseline: str) -> None:
    """The source's per-shard 3D entry against ``baseline``'s at PERF.md's
    shapes, in turns (baseline, source, source, baseline); each workload's
    results under the two held equal."""
    from .parallel import hopper_shard3d, make_mesh, make_mesh3d, sharded3d

    libs = {"source": _build.load(),
            "baseline": build_libraries({"baseline": pathlib.Path(baseline).read_text()},
                                        "shard3d.cu")["baseline"]}
    plane = make_mesh((2, 4), devices=[dev] * 8)
    zmesh = make_mesh3d((8, 1, 1), devices=[dev] * 8)
    cube, wide = random_state((256, 256, 256), dev), random_state((64, 1024, 1024), dev)

    def block(state, mesh, idx):
        sv = sharded3d.shard_state3d(state, mesh)
        sharded3d.update_n_resident3d(sv, 1, mesh, kernel="pallas")   # halos exchanged once
        k = sv.halo
        view, halo = sv.view(k), sv.halos(k)
        src = sv.u_blocks[idx][view].clone()
        work = sv.u_blocks[idx][view]
        frozen = sv.frozen_blocks[idx][view]
        par0 = sv.par0(idx, k)

        def run():
            work.copy_(src)
            hopper_shard3d.chunk(work, frozen, halo=halo, par0=par0, iteration=1, ns=k,
                                 want_delta=True)
            return work
        return run

    def tick(state, mesh, kernel="pallas"):
        sv = sharded3d.shard_state3d(state, mesh)
        start = {idx: b.clone() for idx, b in sv.u_blocks.items()}

        def run():
            for idx, b in start.items():
                sv.u_blocks[idx].copy_(b)
            sv.iteration.zero_()
            sharded3d.update_n_resident3d(sv, 100, mesh, kernel=kernel)
            return sharded3d.unshard3d(sv).u
        return run

    def solve(state, mesh, cap):
        def run():
            sv = sharded3d.shard_state3d(state, mesh)
            sharded3d.solve_resident3d(sv, mesh, max_iterations=cap, kernel="resident")
            return sharded3d.unshard3d(sv).u
        return run

    work = {"chunk_64x1024x1024_2x4_k8": (block(wide, plane, (0, 1)), 20),
            "chunk_256cube_2x4_k8": (block(cube, plane, (0, 1)), 20),
            "chunk_256cube_8x1x1_k8": (block(cube, zmesh, (3, 0, 0)), 20),
            "tick_256cube_2x4_pershard": (tick(cube, plane), 3),
            "tick_256cube_8x1x1_pershard": (tick(cube, zmesh), 3)}
    if hasattr(libs["baseline"], "epic_resident3d_cycle"):
        one = make_mesh((1, 1), devices=[dev])
        work.update({"tick_256cube_2x4_device": (tick(cube, plane, "resident"), 5),
                     "tick_256cube_8x1x1_device": (tick(cube, zmesh, "resident"), 5),
                     "tick_256cube_1x1_device": (tick(cube, one, "resident"), 5),
                     "tick_64x1024x1024_2x4_device": (tick(wide, plane, "resident"), 3),
                     "solve500_256cube_2x4_device": (solve(cube, plane, 500), 1)})
    times: dict = {w: {"baseline": [], "source": []} for w in work}
    results: dict = {w: {} for w in work}
    try:
        for w, (fn, n) in work.items():
            for turn in ("baseline", "source", "source", "baseline"):
                _build._lib = libs[turn]
                if turn not in results[w]:
                    results[w][turn] = fn().clone()
                times[w][turn].append(event_ms(fn, n))
    finally:
        _build._lib = libs["source"]
    for w in work:
        old = sum(times[w]["baseline"]) / 2
        new = sum(times[w]["source"]) / 2
        print(json.dumps(dict(probe="compare3d", work=w, baseline_ms=times[w]["baseline"],
                              source_ms=times[w]["source"], speedup=old / new,
                              same_bits=bool(torch.equal(results[w]["baseline"],
                                                         results[w]["source"])))), flush=True)


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


def edited(text: str, edits, what: str) -> str:
    """``text`` with each (old, new) of ``edits`` replaced; raises where
    ``old`` is missing."""
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{what} no longer has {old!r}")
        text = text.replace(old, new)
    return text


def probe_sweep2d(dev, reps: int) -> None:
    """Where K1's sweep goes, and where the tiles overtake K1/K2: a
    1,000-sweep maze tick on the source and on each ABLATE_INPLACE copy, in
    turns (the source's bits held to core); then squares of SWEEP2D_SIDES,
    a SWEEP2D_TICK-sweep tick and a solve capped at SWEEP2D_CAP on the
    in-place kernels and on the tiles, in turns, the same bits, with the
    route ``solver.update_grid`` takes."""
    import numpy as np

    from .grid import from_occupancy_image
    from .solver import core

    text = (_build.CSRC / "sweep2d.cu").read_text()
    libs = build_libraries({"inplace": text, **{
        f"inplace_{name}": edited(text, edits, f"sweep2d.cu ({name})")
        for name, edits in ABLATE_INPLACE.items()}}, "sweep2d.cu")
    try:
        g = np.load(pathlib.Path(__file__).resolve().parents[1] / "tests" / "goldens" / "maze.npz")
        st = from_occupancy_image(g["img"], 1e-3, device=dev)
        ref = core.update_n(st, 1000)
        times = {name: [] for name in libs}
        for name in [*libs, *reversed(libs)]:
            _build._lib = libs[name]
            x = dataclasses.replace(st, u=st.u.clone())
            times[name].append(event_ms(lambda: hopper_sweep.update_n(x, 1000), reps))
        _build._lib = libs["inplace"]
        out = hopper_sweep.update_n(dataclasses.replace(st, u=st.u.clone()), 1000)
        torch.cuda.synchronize()
        print(json.dumps(dict(probe="sweep2d_ablate", shape=list(st.u.shape), sweeps=1000,
                              us_per_sweep={n: [t / 1000 * 1e3 for t in ts] for n, ts in times.items()},
                              same_bits=bool(torch.equal(out.u, ref.u))
                              and bool(torch.equal(out.delta, ref.delta)))), flush=True)
        for s in SWEEP2D_SIDES:
            st = random_state((s, s), dev)
            names = ["inplace", "tiles"]
            times = {name: [] for name in names}
            outs = {}
            for name in [*names, *reversed(names)]:
                mod = hopper_tile2d if name == "tiles" else hopper_sweep
                x = dataclasses.replace(st, u=st.u.clone())
                t_ms = event_ms(lambda: mod.update_n(x, SWEEP2D_TICK), reps)
                s_ms = event_ms(lambda: outs.__setitem__(name, mod.solve(
                    dataclasses.replace(st, u=st.u.clone()), 100, SWEEP2D_CAP)), 1)
                times[name].append((t_ms, s_ms))
            torch.cuda.synchronize()
            same = bool(torch.equal(outs["tiles"].u, outs["inplace"].u)) and \
                int(outs["tiles"].iteration) == int(outs["inplace"].iteration)
            print(json.dumps(dict(probe="sweep2d_sizes", side=s, tick_sweeps=SWEEP2D_TICK,
                                  solve_cap=SWEEP2D_CAP, use_tiles=hopper_tile2d.use_tiles((s, s), dev),
                                  tick_and_solve_ms=times, same_bits=same)), flush=True)
            del st, outs
    finally:
        _build._lib = None


def sass_ops(lib_path, kernels=("chunk3d_kernel", "solve3d_kernel"),
             ops=("CCTL.IVALL", "LDG.E.128", "STG.E.128", "LDL", "STL")) -> dict:
    """Counts of ``ops`` in the SASS of each kernel of ``kernels`` in a
    library (cuobjdump -sass), with the device functions it calls."""
    counts, name = {}, None
    for line in sass_of(lib_path).splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = next((k for k in kernels if k in m.group(1) and "sweep3d" in m.group(1)), None)
            continue
        if name:
            row = counts.setdefault(name, dict.fromkeys(ops, 0))
            for op in ops:
                row[op] += len(re.findall(rf"\b{re.escape(op)}\b", line))
    return counts


def probe_sweep3d(dev, reps: int, baseline: str | None, shapes=SWEEP3D_SHAPES,
                  sweeps: int = SWEEP3D_SWEEPS, compare=SWEEP3D_COMPARE) -> None:
    """Where K7's sweep goes, and the redesign against a baseline: a
    SWEEP3D_SWEEPS-sweep tick of each SWEEP3D_SHAPES volume on the source,
    its ablated and design copies, and (with ``baseline``, another
    sweep3d.cu) the baseline and its ablated copies, in turns; the source's,
    its design copies' and the baseline's bits held to core. Then
    SWEEP3D_COMPARE's ticks and solves on the baseline and the source in
    turns, the same bits; and the SASS op counts of the source's kernels
    (CCTL.IVALL at each grid barrier: its L1 reads are safe)."""
    from .solver import core

    text = (_build.CSRC / "sweep3d.cu").read_text()
    variants = {"source": text}
    for name, edits in {**SWEEP3D_ABLATE, **SWEEP3D_DESIGN}.items():
        variants[f"source_{name}"] = edited(text, edits, f"sweep3d.cu ({name})")
    if baseline:
        old = pathlib.Path(baseline).read_text()
        variants["baseline"] = old
        for name, edits in SWEEP3D_BASELINE_ABLATE.items():
            variants[f"baseline_{name}"] = edited(old, edits, f"{baseline} ({name})")
    libs = build_libraries(variants, "sweep3d.cu")
    exact = ["source", *(f"source_{n}" for n in SWEEP3D_DESIGN), *(["baseline"] * bool(baseline))]
    lib_dir = _build.BUILD_DIR / "tile_probe"
    print(json.dumps(dict(probe="sweep3d_sass", source=sass_ops(lib_dir / "lib_source.so"),
                          baseline=sass_ops(lib_dir / "lib_baseline.so") if baseline else None)),
          flush=True)
    try:
        for spec in shapes:
            shape = volume_shape(spec)
            st = random_state(shape, dev)
            ref = core.update_n(dataclasses.replace(st, u=st.u.clone()), sweeps)
            times = {name: [] for name in libs}
            for name in [*libs, *reversed(libs)]:
                _build._lib = libs[name]
                x = dataclasses.replace(st, u=st.u.clone())
                ms = event_ms(lambda: hopper_sweep3d.update_n(x, sweeps), reps)
                times[name].append(ms / sweeps * 1e3)
            same = {}
            for name in exact:
                _build._lib = libs[name]
                out = hopper_sweep3d.update_n(dataclasses.replace(st, u=st.u.clone()), sweeps)
                torch.cuda.synchronize()
                same[name] = bool(torch.equal(out.u, ref.u)) and bool(torch.equal(out.delta,
                                                                                   ref.delta))
            print(json.dumps(dict(probe="sweep3d_ablate", shape=list(shape), sweeps=sweeps,
                                  plan=dataclasses.asdict(hopper_sweep3d.plan(
                                      shape, hopper_sweep3d.H100_SLOTS)),
                                  us_per_sweep=times, same_bits=same)), flush=True)
            del st, ref
        names = ["baseline", "source"] if baseline else ["source"]
        for spec, tick, cap in compare:
            shape = volume_shape(spec)
            st = random_state(shape, dev)
            times = {name: [] for name in names}
            outs = {}
            for name in [*names, *reversed(names)]:
                _build._lib = libs[name]
                x = dataclasses.replace(st, u=st.u.clone())
                t_ms = event_ms(lambda: hopper_sweep3d.update_n(x, tick), reps * 2)
                s_ms = event_ms(lambda: outs.__setitem__(name, hopper_sweep3d.solve(
                    dataclasses.replace(st, u=st.u.clone()), 100, cap)), 1)
                times[name].append((t_ms, s_ms))
            torch.cuda.synchronize()
            a, b = outs[names[0]], outs[names[-1]]
            print(json.dumps(dict(probe="sweep3d_compare", shape=list(shape), tick_sweeps=tick,
                                  solve_cap=cap, solve_iterations=int(b.iteration),
                                  tick_and_solve_ms=times,
                                  same_bits=bool(torch.equal(a.u, b.u))
                                  and int(a.iteration) == int(b.iteration)
                                  and bool(torch.equal(a.delta, b.delta)))), flush=True)
            del st, outs
    finally:
        _build._lib = None


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sides", type=int, nargs="*", default=None,
                    help="2D grid sides to probe (the default mode), or --batch's cluster sides")
    ap.add_argument("--volumes", nargs="*", default=None,
                    help="3D volumes to probe, each D (a cube) or DxHxW")
    ap.add_argument("--shapes", action="store_true",
                    help="probe the 3D tile shapes on the --volumes shapes")
    ap.add_argument("--mesh3d", action="store_true",
                    help="time the 3D mesh orientations (on the --volumes shapes if given)")
    ap.add_argument("--compare3d", default=None, metavar="FILE",
                    help="time the per-shard 3D entry against FILE's shard3d.cu")
    ap.add_argument("--mesh2d", action="store_true",
                    help="time the 2D mesh routes (on the --sides grids if given)")
    ap.add_argument("--shapes2d", action="store_true",
                    help="probe the 2D tile shapes at 8192^2 and on a 16384^2 mesh's shard")
    ap.add_argument("--baseline", default=None,
                    help="with --shapes2d: another tile2d.cu to time in turns with the source;"
                         " with --sweep3d: another sweep3d.cu")
    ap.add_argument("--compare2d", default=None, metavar="FILE",
                    help="time the 2D tile, shard and resident paths against FILE's tile2d.cu")
    ap.add_argument("--batch", action="store_true",
                    help="time the batched kernels' block and cluster candidates and the routes")
    ap.add_argument("--lane-depths", action="store_true",
                    help="only --batch's last part: the tiled route's depths")
    ap.add_argument("--batch-small", action="store_true",
                    help="hold the cluster route's variants to the plain version on small lanes")
    ap.add_argument("--ablate-batch", action="store_true",
                    help="time the cluster chunk without its barrier or its edge pushes")
    ap.add_argument("--ablate3d", action="store_true",
                    help="time the 3D tile pass without its lse6 or its step barrier")
    ap.add_argument("--solve3d", action="store_true",
                    help="hold the 3D tile solve, also with the pass at two call sites, to K7")
    ap.add_argument("--sweep2d", action="store_true",
                    help="time K1 without its grid barrier or with only it, and K1/K2 against the"
                         " tiles on squares around the crossover")
    ap.add_argument("--sweep3d", action="store_true",
                    help="time K7 without its grid barrier or with only it, its design copies,"
                         " and (with --baseline) an earlier sweep3d.cu")
    ap.add_argument("--sass", action="store_true",
                    help="count the SASS instructions of one lse4 and one lse6 update")
    args = ap.parse_args()
    if args.sass:
        probe_sass()
        return
    if not torch.cuda.is_available():
        raise SystemExit("tile_probe needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    volumes = VOLUMES if not args.volumes else args.volumes
    if args.sweep2d:
        probe_sweep2d(dev, args.reps)
    elif args.sweep3d and args.volumes:
        probe_sweep3d(dev, args.reps, args.baseline, args.volumes, SWEEP3D_SWEEPS // 5, ())
    elif args.sweep3d:
        probe_sweep3d(dev, args.reps, args.baseline)
    elif args.batch_small:
        probe_batch_small(dev)
    elif args.ablate_batch:
        probe_ablate_batch(dev, args.reps)
    elif args.lane_depths:
        probe_lane_depths(dev, args.reps)
    elif args.batch:
        if not args.sides:
            probe_batch(dev, args.reps)
        probe_clusters(dev, args.reps, args.sides or CLUSTER_SIDES)
        if not args.sides:
            probe_lane_depths(dev, args.reps)
    elif args.ablate3d:
        probe_ablate3d(dev, args.reps)
    elif args.solve3d:
        probe_solve3d(dev, args.volumes or SOLVE3D_VOLUMES)
    elif args.shapes2d:
        probe_shapes2d(dev, args.reps, baseline=args.baseline)
    elif args.compare2d:
        probe_compare2d(dev, args.reps, args.compare2d)
    elif args.compare3d:
        probe_compare3d(dev, args.reps, args.compare3d)
    elif args.mesh3d:
        probe_mesh3d(dev, args.reps, args.volumes or MESH_VOLUMES)
    elif args.mesh2d:
        probe_mesh2d(dev, args.reps, args.sides or MESH_SIDES)
    elif args.shapes:
        probe_shapes(dev, args.reps, args.volumes or SHAPE_VOLUMES)
    elif args.volumes is not None:
        probe_volumes(dev, args.reps, volumes)
    else:
        probe_crossover(dev, args.reps, args.sides or SIDES)


if __name__ == "__main__":
    main()
