#!/usr/bin/env python3
"""Drive epic_tpu_torch's main paths once on one CUDA card, and check them.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the CUDA kernels from ``epic_tpu_torch/csrc/`` with nvcc, then:

  1. build    — the card's name and power limit, the nvcc build time;
  2. maze     — K1 and K2 (csrc/sweep2d.cu) against their plain torch
                version on the maze demo map (tests/goldens/maze.npz),
                through a Planner with the counts zeroed around it: a
                50-sweep tick at an even and an odd start iteration and a
                full solve (K1 twice, K2's resident entry once, nothing
                else); then the tick's mean of 50 and the in-place K2's
                solve beside the resident one's, counted on its own (the
                in-place entry once, nothing else). Tolerance: the same bits
                (max abs diff 0.0); then the same on umass 310 x 940
                (phase "umass");
  3. goldens  — the 2D kernels on maze and umass against the reference
                binary's goldens, by tests/test_goldens.py's rules: 300
                sweeps within 1e-3 of the recorded field; the solve's
                iterations equal, or a whole number of stagger cycles apart
                with the deciding delta within 5e-4 of eps. The converged
                free-cell field is held within 1e-2 (FIELD_TOL below);
  4. session  — the 2D main path: the JSON/TCP server on localhost with
                configs/maze.yaml's settings and the maze map, driven over a
                real socket (info, ticks, a cell edit, a blocking solve,
                get_cell, compute_path from the golden starts, whose paths
                must reach the goal). The kernels' launch counts are zeroed
                just before and read just after; each 2D kernel must have
                run and the plain version must not;
  5. size     — a 4096 x 4096 random-obstacle grid: a 100-sweep tick and a
                solve capped at 2000 iterations through the in-place kernels
                called directly (comparable with earlier runs), and through
                a planner, which sends a grid beyond the L2 to the tile
                kernels; kernel against plain, same bits, with the times;
                then grid2048 — a 2048 x 2048 grid within two thirds of
                the L2, which the planner keeps on K1/K2: counted
                Planner ticks of 100 sweeps from an even and an odd
                iteration and a solve capped at 2000 (K1 and K2's
                resident entry must run, the in-place K2, the tiles and the
                plain versions must not), against core, same bits, the
                tick's mean of 10, and the in-place K2's capped solve,
                counted on its own (the in-place entry once);
  6. volume   — the 3D kernels against the plain version on a 30 x 256 x 256
                volume (numpy default_rng(0), 10% obstacle voxels, the shell
                locked, one goal voxel, as tests/test_pallas3d.py builds
                them): 50-sweep ticks from an even and an odd iteration and a
                solve capped at 3000 sweeps, same bits; an uncapped kernel
                solve, converged under the protocol;
  7. golden3d — 60 single-sweep kernel ticks on tests/goldens/fuzz3d_seed0
                against the reference binary's deltas and field
                (tests/test_goldens.py's rules): pins the 3D parity class;
  8. session3d — the 3D main path on the same server, over the same socket:
                occupancy_volume with phase 6's volume, add_goals_3d, ticks
                (both sessions tick), set_cells_3d, get_cell_3d, info, a
                blocking solve, compute_path_3d and compute_paths_3d from
                seeded starts (paths must reach the goal), and the 2D
                compute_paths from the golden starts. Counts zeroed just
                before, read just after: both 3D kernels must have run and
                the plain version must not;
  9. size3d   — a 256^3 volume (67 MB of u, beyond the 50 MB L2): a 100-sweep
                tick and a solve capped at 2000 sweeps, kernel against plain,
                same bits, with both times;
 10. batch    — batched scenarios at full width: 4096 lanes of 128^2, built as
                tools/probe.py's batched-solve builds them (numpy
                default_rng(1), 10% obstacle cells, the shell locked, one goal
                a lane; eps 1e-2, stagger 100), on the resident route of
                csrc/batched2d.cu (a block a lane in shared memory; every
                launch must take it). A 100-sweep chunk from an even and an
                odd iteration, kernel against plain; a solve capped at 1000
                sweeps through the one-launch, the host-driven and the plain
                route; all the same bits. A solve capped at 2000, as the
                probe's: every lane converged under the protocol. Four lanes
                re-solved solo with core.solve: the same bits. 132 lanes of
                224^2 (BATCH_WIDE; too large for three an SM, so the
                resident route's 512-thread block): a 100-sweep chunk and a
                solve capped at 1000 against plain, the same bits;
 11. batch_goals — the device-built goal batches: one
                maps.random_obstacles(128, 128, density=0.12, seed=5) base map
                and one goal a lane drawn from its free cells by
                default_rng(5) (tools/probe.py's batched-goals).
                make_goal_batch equals batch_from_goal_sets on 64 lanes; then
                the main path, counts zeroed just before and read just after:
                solve_batch_goals on 4096 lanes (one launch of the solve
                kernel) and the host-driven solve of the same batch (chunk
                kernel launches), capped at 8000 sweeps, bit-equal, every
                lane converged; both batch kernels must have run, on the
                resident route only, and the plain versions must not. Two
                lanes re-solved solo: the same bits;
 24. batch_big (run after phase 11) — the cluster route of
                csrc/batched2d.cu: 256 lanes of 384^2 (BATCH_BIG; a lane beyond
                a block's shared memory, held by a thread-block cluster; the
                batch 4x the L2), built as phase 10's with lane 0
                goalless. The main path, counts zeroed just before and read
                just after: update_n_batch of 100 sweeps from an even and an
                odd iteration, solve_batch_device and the host-driven
                solve_batch capped at BATCH_BIG_CAP; both batch kernels must
                have run, on the cluster route only, the plain versions must
                not. Each against the plain version, the same bits, the
                goalless lane retired at its first check past 384 sweeps; the
                chunk's mean of 10 and the solves' times;
 25. batch_huge (run after phase 24) — the tiled route (csrc/tile2d.cu's
                tile pass over every (lane, tile) pair): 32 lanes of
                1024^2 (BATCH_HUGE; beyond the largest cluster, 134 MB of u,
                2.7x the L2), phase 24's checks with a cap of
                BATCH_HUGE_CAP, so that the goalless lane retires at 1,101;
 26. batch_few (run after phase 25) — few lanes (a planner's few goals
                on a large map), each batch on the route the rule picks,
                with phase 24's checks: both sides of the rule's
                batch-size choice, BATCH_FEW_LANES lanes of
                BATCH_FEW_SIDE^2 on the clusters it widens for them (8 of
                384^2 on clusters of 8 on an H100 SXM) and four times as
                many on its smallest fitting cluster (3), and 8 lanes of
                512^2 (clusters of 8), each capped at BATCH_FEW_CAP;
 12. biggrid  — an 8192 x 8192 maps.random_obstacles grid (seed 0) with
                configs/maze.yaml's settings: 268 MB of u and 67 MB of
                locked, beyond the L2. The main path, counts zeroed just
                before and read just after: Planner.update(50) then (100)
                from an even and an odd start iteration, Planner.solve capped
                at 2000, and solver.solve_grid in segments of 500; the tile
                kernels must have run, the in-place 2D kernels and the plain
                versions must not. Then each against plain: the ticks against
                core.update_n and the solve against core.solve, same bits;
                the segments against the one-launch solve, same bits. The
                tile tick's and K1's mean of 10 on the same state; the chunk
                and cycle entries alone against the plain tile version
                (solver/tiled.py), same bits;
 13. wide     — a ragged 2000 x 33,333 strip (random_obstacles, seed 0): the
                same main path and count rule, a 100-sweep tick from an even
                and an odd iteration and a solve capped at 1000, against
                core, same bits;
 14. tile_small — maze 482^2: the chunk entry with u1 against one and 16
                plain sweeps (what epic_tpu's test-only check kernel
                computes), and an uncapped tile solve called directly
                against phase 2's in-place solve: the same 49,301 iterations
                and the same bits;
 15. biggrid3d — phase 9's 256^3 volume (84 MB of u and locked, beyond the
                L2). The main path, counts zeroed just before and read just
                after: VolumePlanner.update(50) then (100) from an even and
                an odd start iteration and an uncapped VolumePlanner.solve;
                K7 (the route of every volume: the tiles measured slower)
                must have run, the tile kernels and the plain versions must
                not. The ticks against core.update_n and
                the solve against core.solve and K7's one-launch solve
                (1,301 iterations), same bits. Then the tile route through
                hopper_tile3d's own entries (update_n, solve), counted the
                same way, against the same references; the chunk and cycle
                entries alone against the plain tile version
                (solver/tiled3d.py, handed hopper_tile3d.tile_for's tile)
                and core, same bits; the tile tick's and K7's mean of 10 on
                the same state, and both solves;
 16. wide3d   — a 32 x 2048 x 2048 volume, a building floor 102.4 m square
                and 1.6 m high at 5 cm (537 MB of u), built as phase 6's: the
                same main path and count rule (every volume runs on K7,
                whose z walk measured faster than the tiles on this
                wide-plane volume too: K7 must run, the tiles must not)
                with 100-sweep ticks from both parities, a solve capped at
                500 and solve_volume in segments of 200; then the tile route
                (update_n of 100 sweeps from both parities and of 50, solve,
                solve_segments) counted the same way; all against core, the
                segments against the one-launch solve, same bits; the tile
                tick's and K7's mean of 5 and K7's capped solve on the same
                state; the chunk and cycle entries alone against the plain
                tile version and core, same bits (the kernels line's three
                epic_tile3d rows; phase 15's 256^3 times beside them as
                "cube");
 17. tile3d_small — phase 6's 30 x 256 x 256 volume: the chunk entry with u1
                against one and K plain sweeps (what epic_tpu's test-only
                band kernel and the slab kernel's check variant compute),
                and an uncapped tile solve against phase 6's K7 solve: the
                same 1,101 iterations and the same bits;
 18. mesh_session — the 2D mesh path: a server on localhost whose node holds
                a MeshPlanner(kernel="pallas") on a 2 x 4 virtual mesh of
                the card (eight shards of 241 x 121 of the maze map,
                configs/maze.yaml), driven over the socket with phase 4's
                verbs (info, ticks, a cell edit, a blocking solve, get_cell,
                compute_path from the golden starts, whose paths must reach
                the goal). Counts zeroed just before and read just after:
                the shard entry must have run; the resident entries, the
                plain versions and the single-device 2D kernels must not.
                Then a single-device Planner replays the same verbs at the
                same ticks (its solve timed): the solved and the final field
                and iterations must be the same bits;
 19. mesh16k  — BASELINE.md's 16k x 16k multi-host grid: a 16384^2
                maps.random_obstacles grid (seed 0, configs/maze.yaml) on a
                2 x 4 virtual mesh of the card (eight shards of 8192 x 4096,
                far beyond the L2) on the per-shard route
                (MeshPlanner(kernel="pallas"): the K14/K15 entry; epic_tpu's
                auto route sends such shards to K16/K17, phase 23), ingested
                from numpy through MeshPlanner.init/update_occupancy.
                Counted main path (counts
                zeroed just before, read just after; the shard entry must
                run, the plain versions and the single-device kernels must
                not): MeshPlanner.update(50) then (100) from an even and an
                odd start iteration and MeshPlanner.solve capped at 2,000,
                each the same bits and iterations as solver.update_grid /
                solve_grid on the whole grid on the card (the tile route).
                The entry alone on one shard's extended block: 16 sweeps
                with and without u1 and a 5-sweep remainder, against the
                plain per-shard version, the same bits. The mesh tick's mean
                of 5 against the tile tick's, and the exchange's share of a
                tick (CUDA events around the halo copies);
 20. mesh3d   — phase 9's 256^3 volume on a 2 x 4 virtual plane mesh of the
                card (eight shards of 256 x 128 x 64), on both 3D mesh routes,
                each counted on its own (counts zeroed just before, read just
                after; K7, the 3D tiles and the plain versions must not run):
                the device route ("auto" and "resident": epic_resident3d_cycle
                and epic_resident3d_solve must run, the shard entry must not)
                and the per-shard route (kernel="pallas": epic_shard3d_chunk
                must run, the device entries must not).
                MeshVolumePlanner.update(50) then (100) from an even and an
                odd start iteration and an uncapped solve on each, and with
                "resident" ticks from the odd start and a solve in segments
                of 500; each the same bits and iterations as the
                VolumePlanner on the whole volume (K7; 1,301 iterations).
                Each route's tick (mean of 5) and solve beside K7's. The
                device entries alone against their plain versions: a
                13-sweep cycle with u1 and a 5-sweep one from an odd
                iteration, a solve capped at 300 in two segments, the same
                bits; a 100-sweep cycle and the capped solve timed beside
                the plain versions;
 21. mesh3d_z — the same volume on an 8 x 1 x 1 z mesh (shards of 32 whole
                planes), "auto" and "resident" (the device route) and
                "pallas" (the per-shard route), counted and compared the
                same way; the shard entry alone on one z shard's block (halo
                on z only): 8 sweeps with and without u1 and a 5-sweep
                remainder, against the plain per-shard version, the same
                bits; the orientation choose_mesh3d picks for it, and both
                orientations' tick times on both routes (mean of 5);
 22. mesh3d_wide — a 64 x 1024 x 1024 volume (tools/probe.py's
                sharded3d-resident shape, 268 MB of u) on 2 x 4 (shards of
                64 x 512 x 256): counted MeshVolumePlanner ticks of 100 from
                both parities and a solve capped at 1,000 on both routes,
                against the VolumePlanner. The shard entry alone on one
                shard's extended block: a chunk with and without u1 and a
                5-sweep remainder, against the plain per-shard version, the
                same bits. Each route's tick (mean of 5) against K7's (and
                the z mesh's), and the exchange's share of a per-shard tick;
 23. mesh_resident — the resident route (K16/K17: epic_resident2d_cycle and
                epic_resident2d_solve in csrc/tile2d.cu, all eight shards in
                one launch). Phase 18's maze session on
                MeshPlanner(kernel="resident"), counted (both resident
                entries must run; the shard entry, the single-device 2D
                kernels and the plain versions must not) and replayed on the
                Planner to the same bits; its solve's host-clock time beside
                K2's and phase 18's. Phase 19's grid on that route, counted
                the same way: update(50) then (100) from an even and an odd
                iteration, a solve capped at 2,000 and the same in segments
                of 500, each the same bits and iterations as the tile route
                and the K14/K15 route of phase 19; the resident tick's mean
                of 5 beside theirs, and the route "auto" picks for each
                shape. The entries alone against their plain versions, the
                same bits: a 3-chunk cycle with u1 on the 16384^2 mesh, and
                a solve capped at 1,000 on the maze mesh.

 27. native (run after phase 23) — the g++ build of epic_tpu_torch.native
                (its flags, the compiler and its output, whether with
                OpenMP; the library is required), then path.compute_path
                with impl="native" and impl="numpy" on phase 2's K2-solved
                maze field from 20 seeded free cells (step 0.2, precision
                0.4, 5,000 points at most): the same points or the same
                error, both walkers' host times;
 28. cascade  — Planner(PlannerConfig(cascade=True)).solve() on maze and
                umass, counted (the coarse levels on the native library, K2
                once on the fine level, nothing else), held bit for bit to
                the same cascade with core.solve as its fine solver on the
                card, each level's iterations and time beside phase 2's cold
                K2 solve; solve_cascade with the auto solver on a 3072^2
                maps.random_obstacles grid (density 0.1, seed 0; 47 MB at 5 B
                a cell, past two thirds of the L2), each level capped at
                20,000 sweeps, counted (K2 on every coarse level, the tile
                solve once on the fine one); and on a 128 x 256 x 256 volume
                built as phase 6's (one coarse level of 64 x 128 x 128, K7 on
                both), each against the plain cascade on the card, the same
                bits;
 29. nav_core — EpicNavCorePlugin on the card (recursive_maze(128, 128,
                seed=7)), two make_plan calls, counted (K2 once a plan,
                nothing else), the plans equal to a plugin's whose solve is
                the plain core.solve on the card; the make_plan latency;
 30. modules  — a 16^4 grid with two seeded goals through solver.solve_grid
                on the card (the plain core: no kernel may run) against the
                CPU plain solve (equal iterations, fields within rtol 2e-6,
                atol 1e-3); legacy.sor_red_black on the card against
                sor_numpy (atol 1e-4); a checkpoint of a Planner holding the
                maze field, saved on the card and loaded on the card and on
                the CPU, the same bits; profiling.timed_solve on the card,
                the same bits as phase 2's solve;
 31. sampling — the sampling_* verbs on an in-process server over a socket:
                sampling_occupancy with the maze, a goal, compute_path, 20
                ticks of its anytime budget, and the info block.

 32. battery (run after phase 31; every phase from here on finds the
                goldens' maze and umass images as the reference's PNGs
                through $EPIC_REFERENCE_ROOT, a fixture tree under build/,
                each PNG read back as its golden) — the battery tool
                (epic_tpu_torch.tools.batch_bench) on maze and umass at eps
                1e-3, --backend pallas, counted (K2 twice a domain, nothing
                else): the kernel row's iterations the goldens' ref_iters
                (49,301 and 32,701), its percent-valid the native row's and
                docs/results_batch_tpu_r3.csv's 1.0, the native row equal
                to that CSV's log_native_cpu row; the SOR rows printed
                beside the CSV's (the tool prints its CSV rows first);
 33. precision — the overlay tool on the maze at eps 1e-3, counted (K2
                once): the log-space region at least SOR f64's and f32's;
 34. demo     — the anytime demo tool on the maze, 40 ticks and 6 starts,
                counted (K1 only): every start gets a path, the PNG written;
 35. loadtest — the load test tool, 4 clients x 25 rounds on a 256^2 maze
                against an in-process server on the card, counted (K1
                only): no protocol error, every verb sampled, the per-verb
                percentiles printed;
 36. scaling  — the scaling tool on a 4096^2 random-obstacle grid, 100
                sweeps, on 1, 2, 4 and 8 shards of a virtual mesh of the
                card, kernel="auto" (the shard entry for the one shard past
                RESIDENT_MAX_SHARD_CELLS, the resident cycle below) and
                "pallas" (the shard entry only), each counted: every row's
                field the 1-shard row's, both kernels' and core.update_n's,
                bit for bit; throughput_vs_1dev printed.

Each phase prints one JSON line and raises on failure.
Then come the kernels' JSON line (each entry with its time, its plain
version's, its bound and its launches on the main path; the batch entries
once for each route, named ``entry/route``; K7's two rows also with
phase 9's 256^3 run as "cube", which carries the bytes bound of one
in-place pass a sweep, ``pass_bytes_bound_ms``: that volume is past the
L2, where the bound holds), the nvidia-smi
line, and last
``{"ok": true, "device": ...}``.

Bounds. ``bound_ms`` is the larger of two times for the same work as
``ms``: its bytes (u and locked read once, u written once: 9 B a cell) over
3.35 TB/s, and its operations (17 float32 operations an lse4 update and 25
an lse6 update, an expf or logf counted as one, which makes the bound
loose; the updates counted from this run's unlocked interior cells and
sweeps) over 67 TFLOP/s: the H100 SXM's published peaks. No bit-exact
kernel can come near the operation bound: an accurate expf or logf is
many instructions. ``issue_bound_ms`` is the least time to issue the same
updates' instructions: the updates times the SASS instructions of one
accurate lse4 or lse6 (``LSE4_SASS``, ``LSE6_SASS``), over the card's SMs
x 128 lanes a clock at the SM clock nvidia-smi reads under load in this
run (phase 12). No single PyTorch call computes a red-black logsumexp
sweep, so ``library_ms`` is null.
Times are CUDA-event times on the card the script ran on, unless a name
says ``_s`` (host clock around work that ends in a synchronize).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import pathlib
import select
import subprocess
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
GOLDENS = ROOT / "tests" / "goldens"
STAGGER = 100
EPS = 1e-3                 # configs/maze.yaml and the goldens' epsilon
# The converged demo fields sit below the reference binary's by up to
# 1.22e-3 (maze) and 8.64e-3 (umass), measured with the plain version on the
# CPU: the binary subtracts a double log(4), the port (like epic_tpu)
# float32(log 4), 3.8e-9 more per update, and the bias accumulates over the
# field's long random-walk paths. 1e-3 holds for the 300-sweep fields, as in
# tests/test_goldens.py; the converged fields are held to FIELD_TOL.
FIELD_TOL = 1e-2
SIZE_SIDE = 4096          # 67 MB of u: beyond the 50 MB L2, all 132 SMs busy
GRID_SIDE = 2048          # 21 MB of u and locked: within two thirds of the L2, K1/K2
VOLUME = (30, 256, 256)   # 1.97M cells, 7.9 MB of u: the VMEM-resident regime's full width
VOLUME_CAP = 3000         # the capped kernel-vs-plain solve
SIZE3D = (256, 256, 256)  # 67 MB of u: beyond L2
MESH = (2, 4)             # the virtual mesh of phases 18-19: eight shards on the one card
MESH_SIDE = 16384         # BASELINE.md:42, the 16k x 16k multi-host grid: 1.07 GB of u
MESH_CAP = 2000
MESH_SEGMENT = 500        # the resident route's solve in segments (phase 23)
SOLVE_ENTRY_CAP = 1000    # the solve entry alone on the maze mesh, against its plain version
MESH3D_WIDE = (64, 1024, 1024)   # tools/probe.py:1493's sharded3d-resident volume: 268 MB of u
MESH3D_WIDE_CAP = 1000
MESH3D_SEGMENT = 500
MESH3D_ALONE_CAP = 300     # the device solve entry alone against its plain version
WIDE3D = (32, 2048, 2048)  # a building floor at 5 cm: 537 MB of u, 10x the L2
WIDE3D_CAP = 500
WIDE3D_SEGMENT = 200
BATCH = (4096, 128)       # lanes x side: 67M cells, 268 MB of u, 5x the L2 (BASELINE config 3)
BATCH_EPS = 1e-2          # tools/probe.py's batched-solve and batched-goals
BATCH_CAP = 1000          # the capped three-route solve
BATCH_SOLVE_CAP = 2000    # tools/probe.py batched-solve's cap
BATCH_WIDE = (132, 224)   # resident lanes too large for three an SM: the 512-thread block
BATCH_BIG = (256, 384)    # lanes x side beyond a block's shared memory, 4x the L2: the cluster route
BATCH_BIG_CAP = 1000
BATCH_HUGE = (32, 1024)   # lanes x side beyond the largest cluster, 2.7x the L2: the tiled route
BATCH_HUGE_CAP = 1200     # past the goalless lane's first check beyond 1024 sweeps
BATCH_FEW_SIDE = 384      # lanes in clusters of 3; few of them on wider ones
BATCH_FEW_LANES = 8
BATCH_FEW_CAP = 700       # past the goalless lane's first check beyond 512 sweeps
GOALS_CAP = 8000          # tools/probe.py batched-goals' cap (a long tail of late lanes)
BIG_SIDE = 8192           # 268 MB of u + 67 MB of locked: 6.7x the L2
BIG_CAP = 2000
WIDE = (2000, 33_333)     # 66.7M cells, a ragged strip: the wide-grid regime
WIDE_CAP = 1000
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FP32_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
# float32 operations of one update: lse4 = 3 max, 4 sub, 4 expf, 3 add, logf,
# add, sub; lse6 = 5 max, 6 sub, 6 expf, 5 add, logf, add, sub.
OPS_LSE4, OPS_LSE6 = 17, 25
# SASS instructions of one update on sm_90a, counted once on the card with
# `python -m epic_tpu_torch.tile_probe --sass` (`cuobjdump -sass` of a kernel
# that computes one lse4 / lse6 a thread, less one that adds the same loaded
# values; no branch inside either): the issue slots an accurate update needs.
LSE4_SASS, LSE6_SASS = 71, 91
LANES_PER_SM_CLOCK = 128     # a Hopper SM: four schedulers, a warp instruction a clock each
BYTES_PER_CELL = 9           # u read, locked read, u written
SOURCES = {
    "epic_sweep2d_chunk": "epic_tpu_torch/csrc/sweep2d.cu",
    "epic_sweep2d_solve": "epic_tpu_torch/csrc/sweep2d.cu",
    "epic_sweep2d_solve_resident": "epic_tpu_torch/csrc/sweep2d.cu",
    "epic_sweep3d_chunk": "epic_tpu_torch/csrc/sweep3d.cu",
    "epic_sweep3d_solve": "epic_tpu_torch/csrc/sweep3d.cu",
    # One row an entry and route (hopper_batched.lane_resident and lane_cluster
    # pick the route).
    "epic_batched2d_chunk/resident": "epic_tpu_torch/csrc/batched2d.cu",
    "epic_batched2d_solve/resident": "epic_tpu_torch/csrc/batched2d.cu",
    "epic_batched2d_chunk/cluster": "epic_tpu_torch/csrc/batched2d.cu",
    "epic_batched2d_solve/cluster": "epic_tpu_torch/csrc/batched2d.cu",
    "epic_batched2d_chunk/tiled": "epic_tpu_torch/csrc/tile2d.cu",
    "epic_batched2d_solve/tiled": "epic_tpu_torch/csrc/tile2d.cu",
    "epic_tile2d_chunk": "epic_tpu_torch/csrc/tile2d.cu",
    "epic_tile2d_cycle": "epic_tpu_torch/csrc/tile2d.cu",
    "epic_tile2d_solve": "epic_tpu_torch/csrc/tile2d.cu",
    "epic_tile3d_chunk": "epic_tpu_torch/csrc/tile3d.cu",
    "epic_tile3d_cycle": "epic_tpu_torch/csrc/tile3d.cu",
    "epic_tile3d_solve": "epic_tpu_torch/csrc/tile3d.cu",
    "epic_shard2d_chunk": "epic_tpu_torch/csrc/tile2d.cu",
    "epic_shard3d_chunk": "epic_tpu_torch/csrc/shard3d.cu",
    "epic_resident2d_cycle": "epic_tpu_torch/csrc/tile2d.cu",
    "epic_resident2d_solve": "epic_tpu_torch/csrc/tile2d.cu",
    "epic_resident3d_cycle": "epic_tpu_torch/csrc/shard3d.cu",
    "epic_resident3d_solve": "epic_tpu_torch/csrc/shard3d.cu",
}
REPLACES = {
    "epic_sweep2d_chunk": "epic_tpu/solver/pallas_sweep.py:90",
    "epic_sweep2d_solve": "epic_tpu/solver/pallas_sweep.py:130",
    "epic_sweep2d_solve_resident": "epic_tpu/solver/pallas_sweep.py:130",
    # K7; ticks via sweep3d_chunk_flat (:110 -> :125), solves via _solve_padded (:261)
    "epic_sweep3d_chunk": "epic_tpu/solver/pallas_sweep3d.py:88",
    "epic_sweep3d_solve": "epic_tpu/solver/pallas_sweep3d.py:88",
    # K12 via sweep_chunk_blocks (:86 -> :99); K13 via _sweep_chunk_gated (:238 -> :249),
    # driven by _solve_collage_device (:275); each on all three routes
    "epic_batched2d_chunk/resident": "epic_tpu/solver/pallas_batched.py:65",
    "epic_batched2d_solve/resident": "epic_tpu/solver/pallas_batched.py:214",
    "epic_batched2d_chunk/cluster": "epic_tpu/solver/pallas_batched.py:65",
    "epic_batched2d_solve/cluster": "epic_tpu/solver/pallas_batched.py:214",
    "epic_batched2d_chunk/tiled": "epic_tpu/solver/pallas_batched.py:65",
    "epic_batched2d_solve/tiled": "epic_tpu/solver/pallas_batched.py:214",
    # K3 (and T2 :100), K5, and with u1 T1
    "epic_tile2d_chunk": ["epic_tpu/solver/pallas_biggrid.py:199",
                          "epic_tpu/solver/pallas_tiled2d.py:120",
                          "epic_tpu/solver/pallas_biggrid.py:100",
                          "epic_tpu/solver/pallas_sweep.py:109"],
    # K4, K6
    "epic_tile2d_cycle": ["epic_tpu/solver/pallas_cycle.py:59",
                          "epic_tpu/solver/pallas_cycle.py:355"],
    # the loops of _solve_banded (pallas_biggrid.py:482) and _solve_tiled
    # (pallas_tiled2d.py:430) over K4/K6 with the check fold, and K3/K5
    "epic_tile2d_solve": ["epic_tpu/solver/pallas_cycle.py:59",
                          "epic_tpu/solver/pallas_cycle.py:355",
                          "epic_tpu/solver/pallas_biggrid.py:199",
                          "epic_tpu/solver/pallas_tiled2d.py:120"],
    # K8 (and T3 :115), K10, and with u1 K10's check variant
    "epic_tile3d_chunk": ["epic_tpu/solver/pallas_biggrid3d.py:221",
                          "epic_tpu/solver/pallas_tiled3d.py:121",
                          "epic_tpu/solver/pallas_biggrid3d.py:115",
                          "epic_tpu/solver/pallas_tiled3d.py:225"],
    # K9, K11
    "epic_tile3d_cycle": ["epic_tpu/solver/pallas_cycle.py:657",
                          "epic_tpu/solver/pallas_cycle.py:869"],
    # the loops of _solve_banded (pallas_biggrid3d.py:460) and _solve_tiled3d
    # (pallas_tiled3d.py:451) over K9/K11 with K8/K10's check chunks
    "epic_tile3d_solve": ["epic_tpu/solver/pallas_cycle.py:657",
                          "epic_tpu/solver/pallas_cycle.py:869",
                          "epic_tpu/solver/pallas_biggrid3d.py:221",
                          "epic_tpu/solver/pallas_tiled3d.py:121"],
    # K14 (the whole extended shard in VMEM) and K15 (its DMA row bands)
    "epic_shard2d_chunk": ["epic_tpu/parallel/sharded.py:89",
                           "epic_tpu/parallel/sharded.py:152"],
    # K18 (the whole block in VMEM), K19 (DMA plane bands), K20 (K11's body via
    # resident3d._chunk_cycle), K21 (the z-resident plane bands)
    "epic_shard3d_chunk": ["epic_tpu/parallel/sharded3d.py:170",
                           "epic_tpu/parallel/sharded3d.py:243",
                           "epic_tpu/parallel/resident3d.py:233",
                           "epic_tpu/parallel/resident_z.py:166"],
    # K16 (the banded guard layout's chunk) and K17 (K6's body via _chunk_cycle
    # on the tiled guard layout), all of a device's shards in one launch; the
    # solve entry also carries their solve loops (resident.py:451,
    # resident_tiled.py:315)
    "epic_resident2d_cycle": ["epic_tpu/parallel/resident.py:188",
                              "epic_tpu/parallel/resident_tiled.py:167"],
    "epic_resident2d_solve": ["epic_tpu/parallel/resident.py:188",
                              "epic_tpu/parallel/resident_tiled.py:167"],
    # K18-K21 again, on every shard of a device in one launch (same-device face
    # neighbours read in place); the solve entry also carries the host loops
    # of stagger cycles around them
    "epic_resident3d_cycle": ["epic_tpu/parallel/sharded3d.py:170",
                              "epic_tpu/parallel/sharded3d.py:243",
                              "epic_tpu/parallel/resident3d.py:233",
                              "epic_tpu/parallel/resident_z.py:166"],
    "epic_resident3d_solve": ["epic_tpu/parallel/sharded3d.py:170",
                              "epic_tpu/parallel/sharded3d.py:243",
                              "epic_tpu/parallel/resident3d.py:233",
                              "epic_tpu/parallel/resident_z.py:166"],
}


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def event_ms(fn, reps: int = 1) -> float:
    """Mean CUDA-event time of ``reps`` calls of ``fn``, in ms."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def compare(k, p, what: str) -> float:
    """Kernel state vs plain state: the same bits in u, delta, iteration."""
    err = max(max_abs(k.u, p.u), max_abs(k.delta, p.delta))
    require(int(k.iteration) == int(p.iteration),
            f"{what}: iteration {int(k.iteration)} (kernel) != {int(p.iteration)} (plain)")
    require(bool(k.converged) == bool(p.converged), f"{what}: converged differs")
    require(bool(torch.isfinite(k.u).all()), f"{what}: non-finite values in u")
    require(err == 0.0, f"{what}: kernel and plain differ by {err}")
    return err


def copy_state(state):
    return dataclasses.replace(state, u=state.u.clone())


def zero_counts() -> None:
    from epic_tpu_torch.parallel import (hopper_resident2d, hopper_resident3d, hopper_shard2d,
                                         hopper_shard3d)
    from epic_tpu_torch.solver import (batched, core, hopper_batched, hopper_sweep,
                                       hopper_sweep3d, hopper_tile2d, hopper_tile3d, tiled,
                                       tiled3d)

    for d in (hopper_sweep.launches, hopper_sweep3d.launches, hopper_batched.launches,
              hopper_batched.routes,
              hopper_tile2d.launches, hopper_tile3d.launches, hopper_shard2d.launches,
              hopper_shard3d.launches, hopper_resident2d.launches, hopper_resident3d.launches,
              core.calls, batched.calls, tiled.calls, tiled3d.calls, hopper_shard2d.calls,
              hopper_shard3d.calls, hopper_resident2d.calls, hopper_resident3d.calls):
        for k in d:
            d[k] = 0


def at_iteration(state, t0: int):
    """A copy of ``state`` whose iteration is ``t0``."""
    return dataclasses.replace(state, u=state.u.clone(),
                               iteration=torch.tensor(t0, dtype=torch.int32, device=state.u.device))


def class_counts(locked: torch.Tensor, lanes: bool = False) -> torch.Tensor:
    """Unlocked interior cells whose coordinates sum to an even and to an odd
    number: ``[2]`` for a grid or a volume, ``[2, B]`` for a ``[B, H, W]``
    batch (``lanes``, lane coordinates); int64 on the host."""
    grid_dims = 2 if lanes else locked.ndim
    lead = locked.ndim - grid_dims
    inner = locked[(slice(None),) * lead + (slice(1, -1),) * grid_dims]
    total = torch.zeros(inner.shape[lead:], dtype=torch.int64, device=locked.device)
    for axis, n in enumerate(total.shape):
        view = [1] * grid_dims
        view[axis] = n
        total = total + torch.arange(1, n + 1, device=locked.device).view(view)
    odd = (total % 2).bool()
    free = ~inner
    dims = tuple(range(lead, inner.ndim))
    return torch.stack([(free & ~odd).sum(dim=dims), (free & odd).sum(dim=dims)]).cpu()


def updates(locked: torch.Tensor, t0: int, sweeps, lse6: bool = False,
            lanes: bool = False) -> int:
    """Cell updates of ``sweeps`` sweeps from iteration ``t0`` (``sweeps`` an
    int, or one a lane): a 2D sweep ``t`` updates the class ``!= t % 2``, a
    3D sweep the class ``== t % 2``."""
    even, odd = class_counts(locked, lanes)
    sweeps = torch.as_tensor(sweeps, dtype=torch.int64)
    at_even_t = (sweeps + 1 - t0 % 2) // 2
    at_odd_t = sweeps - at_even_t
    if lse6:
        return int((at_even_t * even + at_odd_t * odd).sum())
    return int((at_even_t * odd + at_odd_t * even).sum())


def bound(locked: torch.Tensor, t0: int, sweeps, lse6: bool = False,
          lanes: bool = False) -> dict:
    """The least time for ``sweeps`` sweeps from ``t0`` on the cells of
    ``locked`` (arguments of :func:`updates`): their bytes over the HBM rate
    or their operations over the float32 rate, whichever is larger."""
    n_updates = updates(locked, t0, sweeps, lse6, lanes)
    t_bytes = locked.numel() * BYTES_PER_CELL / PEAK_BYTES_PER_S
    t_ops = n_updates * (OPS_LSE6 if lse6 else OPS_LSE4) / PEAK_FP32_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                updates=n_updates, lse6=lse6)


def pass_bytes_bound_ms(shape, sweeps: int) -> float:
    """The least time for ``sweeps`` in-place passes over a volume of
    ``shape``, each reading u and locked and writing u once (9 B a cell a
    sweep), at the HBM rate: the bytes bound of a kernel that keeps nothing
    on chip between sweeps, as K7 does."""
    return sweeps * int(np.prod(shape)) * BYTES_PER_CELL / PEAK_BYTES_PER_S * 1e3


def issue_bound_ms(b: dict, sm_clock_mhz: float) -> float:
    """The least time to issue a bound's updates at ``LSE4_SASS`` or
    ``LSE6_SASS`` instructions each on every SM of the card."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_update = LSE6_SASS if b["lse6"] else LSE4_SASS
    return b["updates"] * per_update / (sms * LANES_PER_SM_CLOCK * sm_clock_mhz * 1e6) * 1e3


def sm_clock_mhz(fn) -> float:
    """The highest SM clock nvidia-smi reads, every 50 ms, while ``fn`` runs
    (it should keep the card busy for a second or more)."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
                             "-lms", "50"], stdout=subprocess.PIPE, text=True)
    try:
        time.sleep(0.5)
        fn()
        torch.cuda.synchronize()
        time.sleep(0.2)
    finally:
        proc.terminate()
        out = proc.communicate(timeout=10)[0]
    clocks = [float(v) for v in out.split() if v.replace(".", "", 1).isdigit()]
    require(bool(clocks), "nvidia-smi read no SM clock")
    return max(clocks)


def phase_build() -> dict:
    from epic_tpu_torch.solver import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    _build.load()
    load_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_info.get("log", "").splitlines()
             if "registers" in ln or "spill" in ln]
    emit(phase="build", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         nvcc_s=_build.build_info.get("seconds"), load_s=load_s,
         library=str(_build.library_path().relative_to(ROOT)), ptxas=ptxas)
    return {"smi": smi}


def phase_demo(dev, g, name: str) -> dict:
    """K1 and K2 on a reference demo map (``g``, a golden) against core.
    The main path, counts zeroed just before and read just after: a Planner
    (configs/maze.yaml: 50 sweeps a tick, eps 1e-3, stagger 100) ticks from
    the map's 300-sweep field at an even and an odd iteration and solves it
    in full; K1 must run twice and K2's resident entry once, the in-place K2,
    the tiles and the plain versions never. Then, outside the count, the
    tick's mean of 50 on ``hopper_sweep``, the in-place K2's solve (the same
    bits; counted on its own: the in-place entry once, nothing else, the
    count the ``kernels`` line's row reads) and the plain versions' times."""
    import epic_tpu_torch as T
    from epic_tpu_torch.config import EpicConfig
    from epic_tpu_torch.solver import core, hopper_sweep, hopper_tile2d, tiled

    cfg = EpicConfig.load_yaml(ROOT / "configs" / "maze.yaml")
    require(cfg.solver.epsilon == EPS and cfg.solver.stagger == STAGGER
            and cfg.service.steps_per_update == 50, f"{name}: configs/maze.yaml changed")
    locked = T.from_occupancy_image(g["img"], EPS, device="cpu").locked.numpy()
    arrays = {t0: dict(u=g["ref_u300"], locked=locked, iteration=np.int32(t0),
                       delta=np.float32(1.0), converged=np.bool_(False),
                       epsilon=np.float32(EPS)) for t0 in (300, 301)}
    planner = T.Planner(cfg, device=dev)
    got, out = {}, {}
    zero_counts()
    for t0 in (300, 301):
        planner.state = T.state_from_numpy(arrays[t0], device=dev)
        planner.update()
        got[t0] = copy_state(planner.state)
    planner.state = T.from_occupancy_image(g["img"], EPS, device=dev)
    solve_k_ms = event_ms(lambda: planner.solve())
    out["k"] = planner.state
    torch.cuda.synchronize()
    launches = {k: v for k, v in hopper_sweep.launches.items() if v}
    others = {**hopper_tile2d.launches, **{f"core.{k}": v for k, v in core.calls.items()},
              **{f"tiled.{k}": v for k, v in tiled.calls.items()}}
    require(launches == {"epic_sweep2d_chunk": 2, "epic_sweep2d_solve_resident": 1},
            f"{name}: K1/K2 launches {launches}")
    require(all(v == 0 for v in others.values()),
            f"{name}: another kernel or the plain version ran on the main path: {others}")
    errs = [compare(got[t0], core.update_n(T.state_from_numpy(arrays[t0], device=dev), 50),
                    f"{name} 50-sweep tick from iteration {t0}") for t0 in (300, 301)]

    state = {"k": T.state_from_numpy(arrays[300], device=dev),
             "p": T.state_from_numpy(arrays[300], device=dev)}

    def tick(which, fn):
        state[which] = fn(state[which], 50)

    tick_k_ms = event_ms(lambda: tick("k", hopper_sweep.update_n), reps=50)
    tick_p_ms = event_ms(lambda: tick("p", core.update_n), reps=10)
    solve_p_ms = event_ms(lambda: out.__setitem__(
        "p", core.solve(T.from_occupancy_image(g["img"], EPS, device=dev), STAGGER)))
    solve_err = compare(out["k"], out["p"], f"{name} full solve")
    in_place = {}
    in_place_ran = new_counts(f"{name} in-place K2", lambda: in_place.__setitem__(
        "ms", event_ms(lambda: out.__setitem__("i", hopper_sweep.solve_in_place(
            T.from_occupancy_image(g["img"], EPS, device=dev), STAGGER)))),
        {"epic_sweep2d_solve": 1})
    in_place_ms = in_place["ms"]
    in_place_err = compare(out["i"], out["p"], f"{name} full solve (in-place K2)")
    locked_t = out["k"].locked
    bounds = {"tick": bound(locked_t, 0, 50), "solve": bound(locked_t, 0, int(out["k"].iteration))}
    emit(phase=name, shape=list(g["img"].shape), launches=launches, tick_sweeps=50,
         tick_max_abs_err=max(errs), tick_kernel_ms=tick_k_ms, tick_plain_ms=tick_p_ms,
         solve_iterations=int(out["k"].iteration), solve_delta=float(out["k"].delta),
         solve_max_abs_err=solve_err, solve_kernel_ms=solve_k_ms,
         solve_plan=hopper_sweep.plan_on(g["img"].shape, dev)._asdict(),
         solve_in_place_ms=in_place_ms, solve_in_place_max_abs_err=in_place_err,
         solve_plain_ms=solve_p_ms, bounds=bounds)
    return {"tick_err": max(errs), "tick_ms": tick_k_ms, "tick_plain_ms": tick_p_ms,
            "solve_err": solve_err, "solve_ms": solve_k_ms, "solve_plain_ms": solve_p_ms,
            "in_place_err": in_place_err, "in_place_ms": in_place_ms,
            "solved": out["k"], "tick_bound": bounds["tick"], "solve_bound": bounds["solve"],
            "launches": {**launches, **in_place_ran}}


def check_golden(name: str, g, solved, u300) -> dict:
    """tests/test_goldens.py's rules for a 300-sweep field and a solve
    against the reference binary's recorded run."""
    err300 = float(np.max(np.abs(u300.cpu().numpy() - g["ref_u300"])))
    require(err300 <= 1e-3, f"{name}: 300-sweep field differs from the golden by {err300}")
    ref_iters = int(g["ref_iters"])
    iters = int(solved.iteration)
    checks = dict(zip(g["check_iters"].tolist(), g["check_deltas"].tolist()))
    deciding = None
    if iters != ref_iters:
        require((iters - ref_iters) % STAGGER == 0,
                f"{name}: {iters} iterations vs the reference's {ref_iters}")
        deciding = checks.get(min(iters, ref_iters) - 1, float(solved.delta))
        require(abs(deciding - EPS) <= 5e-4,
                f"{name}: deciding delta {deciding} not within 5e-4 of eps")
    u = solved.u.cpu().numpy()
    free = ~solved.locked.cpu().numpy()
    field_err = float(np.max(np.abs(u[free] - g["ref_u"][free])))
    require(field_err <= FIELD_TOL, f"{name}: field differs from the golden by {field_err}")
    return dict(u300_max_abs_err=err300, iterations=iters, ref_iterations=ref_iters,
                deciding_delta=deciding, field_max_abs_err=field_err,
                converged=bool(solved.converged))


def phase_goldens(dev, maze, maze_solved, umass, umass_solved) -> None:
    import epic_tpu_torch as T
    from epic_tpu_torch.solver import hopper_sweep

    def u300(g):
        return hopper_sweep.update_n(T.from_occupancy_image(g["img"], EPS, device=dev), 300).u

    emit(phase="goldens", field_tol=FIELD_TOL,
         maze=check_golden("maze", maze, maze_solved, u300(maze)),
         umass=check_golden("umass", umass, umass_solved, u300(umass)))


def golden_goal_starts(g) -> list[tuple[float, float]]:
    """The golden starts whose recorded walk (on the reference's own field)
    ends in a goal cell."""
    from epic_tpu_torch import path

    locked = (g["img"] == 0) | (g["img"] == 255)
    out, off = [], 0
    for (x, y), n in zip(g["starts"], g["path_lens"]):
        walk = g["paths_concat"][off:off + int(n)]
        off += int(n)
        if n > 0 and path.path_reaches_goal(g["ref_u"], locked, walk):
            out.append((float(x), float(y)))
    return out


class LoopbackSession:
    """A client on a real socket, with the server's loop turned by hand:
    each spin services the sockets and then runs one tick, so the number of
    ticks is known."""

    def __init__(self, server, client):
        self.server = server
        self.client = client
        self.ticks = 0

    def spin(self, n: int = 1) -> None:
        for _ in range(n):
            self.server.spin_once()
            self.ticks += 1

    def call(self, srv: str, **args) -> tuple[dict, int]:
        """Send one request; spin until its answer arrives. Returns the
        answer and the number of ticks that ran before it was served."""
        sock = self.client.sock
        # The server reads on this thread, so a request larger than the
        # socket buffers is sent in pieces, spinning the server between them.
        pending = memoryview(json.dumps({"srv": srv, **args}).encode() + b"\n")
        timeout = sock.gettimeout()
        sock.settimeout(0.0)
        try:
            while pending:
                try:
                    pending = pending[sock.send(pending):]
                except BlockingIOError:
                    self.spin()
        finally:
            sock.settimeout(timeout)
        buf = self.client._buf
        served_after = self.ticks
        while b"\n" not in buf:
            served_after = self.ticks
            self.spin()
            if select.select([sock], [], [], 1.0)[0]:
                data = sock.recv(1 << 20)
                require(bool(data), "server closed the connection")
                buf += data
        line, self.client._buf = buf.split(b"\n", 1)
        return json.loads(line), served_after


def phase_session(dev, maze) -> dict:
    from epic_tpu_torch import grid as G
    from epic_tpu_torch import path
    from epic_tpu_torch.config import EpicConfig
    from epic_tpu_torch.services.navigation_node import EpicNavigationNodeRviz
    from epic_tpu_torch.services.server import EpicClient, EpicServiceServer, ingest_map
    from epic_tpu_torch.solver import core, hopper_sweep

    cfg = EpicConfig.load_yaml(ROOT / "configs" / "maze.yaml")
    steps = cfg.service.steps_per_update
    img = maze["img"]
    t_start = time.perf_counter()
    node = EpicNavigationNodeRviz(cfg, update_rate=cfg.service.update_rate_hz, device=dev)
    ingest_map(node, img)
    server = EpicServiceServer(node, "127.0.0.1", 0)
    client = EpicClient(port=server.port, timeout=60.0)
    s = LoopbackSession(server, client)
    try:
        zero_counts()
        r, at = s.call("info")
        require(r["success"] and r["initialized"] and r["shape"] == list(img.shape),
                f"info: {r}")
        require(r["iteration"] == steps * at, f"info iteration {r['iteration']} after {at} ticks")
        t0 = time.perf_counter()
        s.spin(10)
        torch.cuda.synchronize()
        ten_ticks_s = time.perf_counter() - t0
        r, at = s.call("info")
        require(r["iteration"] == steps * at, f"info iteration {r['iteration']} after {at} ticks")

        # An obstacle edit on a free cell, relaxed around, then reverted.
        ys, xs = np.nonzero((img != 0) & (img != 255))
        ex, ey = int(xs[len(xs) // 2]), int(ys[len(ys) // 2])
        r, _ = s.call("set_cells", v=[ex, ey], types=[1])
        require(r["success"], f"set_cells: {r}")
        r, _ = s.call("get_cell", x=ex, y=ey)
        require(r["success"] and r["value"] == -1e6, f"get_cell on the new obstacle: {r}")
        s.spin(10)
        r, _ = s.call("set_cells", v=[ex, ey], types=[2])
        require(r["success"], f"set_cells: {r}")

        # The nav_core plugin's blocking solve (one launch of the solve kernel).
        t0 = time.perf_counter()
        node.planner.solve(max_iterations=cfg.solver.max_iterations)
        solved = node.planner.state
        require(bool(solved.converged), "session solve did not converge")
        solve_iterations = int(solved.iteration)
        solve_s = time.perf_counter() - t0

        gy, gx = np.argwhere(img == 255)[0]
        r, _ = s.call("get_cell", x=int(gx), y=int(gy))
        require(r["success"] and r["value"] == 0.0, f"get_cell on a goal: {r}")
        r, _ = s.call("get_cell", x=ex, y=ey)
        require(r["success"] and -1e6 < r["value"] < 0.0, f"get_cell on the freed cell: {r}")

        starts = golden_goal_starts(maze)
        require(len(starts) > 0, "no golden start reaches the goal")
        lengths = []
        path_s = []
        for x, y in starts:
            t0 = time.perf_counter()
            r, _ = s.call("compute_path", x=x, y=y, step_size=0.2, precision=0.4)
            path_s.append(time.perf_counter() - t0)
            require(r["success"], f"compute_path from ({x}, {y}): {r}")
            pts = np.asarray(r["path"], dtype=np.float32)[:, :2]
            st = node.planner.state
            require(path.path_reaches_goal(G.host_u(st), G.host_locked(st), pts),
                    f"path from ({x}, {y}) ends at {pts[-1].tolist()}, not in a goal")
            lengths.append(len(pts))
        r, _ = s.call("info")
        require(r["success"] and r["iteration"] >= solve_iterations, f"info: {r}")
        session_s = time.perf_counter() - t_start
    except BaseException:
        client.close()
        server.close()
        raise
    launches = dict(hopper_sweep.launches)
    plain = dict(core.calls)
    require(launches["epic_sweep2d_chunk"] > 0 and launches["epic_sweep2d_solve_resident"] > 0,
            f"a kernel never ran on the main path: {launches}")
    require(launches["epic_sweep2d_solve"] == 0,
            f"the maze's solve took the in-place K2: {launches}")
    require(all(v == 0 for v in plain.values()), f"the plain version ran on the main path: {plain}")
    emit(phase="session", config="configs/maze.yaml", ticks=s.ticks, sweeps_per_tick=steps,
         ten_ticks_s=ten_ticks_s, solve_iterations=solve_iterations, solve_s=solve_s,
         paths=len(lengths), path_points=lengths, compute_path_s=path_s,
         session_s=session_s, launches=launches, plain_calls=plain)
    return launches, s


def phase_size(dev) -> dict:
    """4096^2: K1/K2 called directly, as in earlier runs, and the planner,
    which sends this grid (beyond the L2) to the tile kernels."""
    import epic_tpu_torch as T
    from epic_tpu_torch import maps
    from epic_tpu_torch.config import EpicConfig
    from epic_tpu_torch.solver import core, hopper_sweep

    side = SIZE_SIDE
    cfg = EpicConfig.load_yaml(ROOT / "configs" / "maze.yaml")
    img = maps.random_obstacles(side, side, seed=0)
    base = T.from_occupancy_image(img, cfg.solver.epsilon, device=dev)

    res = {"k": copy_state(base)}
    tick_p_ms = event_ms(lambda: res.__setitem__("p", core.update_n(base, 100)))
    tick_k_ms = event_ms(lambda: res.__setitem__("k", hopper_sweep.update_n(res["k"], 100)))
    tick_err = compare(res["k"], res["p"], f"{side}^2 100-sweep tick (sweep2d)")
    planner = T.Planner(cfg, device=dev)
    planner.state = copy_state(base)
    tick_t_ms = event_ms(lambda: planner.update(100))
    tile_tick_err = compare(planner.state, res["p"], f"{side}^2 100-sweep tick (tile2d)")

    ticked = res["p"]
    solve_p_ms = event_ms(lambda: res.__setitem__("ps", core.solve(ticked, STAGGER, 2000)))
    solve_k_ms = event_ms(lambda: res.__setitem__(
        "ks", hopper_sweep.solve(copy_state(ticked), STAGGER, 2000)))
    solve_err = compare(res["ks"], res["ps"], f"{side}^2 solve capped at 2000 (sweep2d)")
    solve_t_ms = event_ms(lambda: planner.solve(max_iterations=2000))
    tile_solve_err = compare(planner.state, res["ps"], f"{side}^2 solve capped at 2000 (tile2d)")
    solve_iterations = int(res["ks"].iteration)

    k_state = {"s": res["ks"]}
    reps_k_ms = event_ms(lambda: k_state.__setitem__(
        "s", hopper_sweep.update_n(k_state["s"], 100)), reps=10)
    reps_t_ms = event_ms(lambda: planner.update(100), reps=10)
    emit(phase="size", shape=[side, side], tick_sweeps=100, tick_max_abs_err=tick_err,
         tick_kernel_ms=tick_k_ms, tick_kernel_ms_mean10=reps_k_ms, tick_plain_ms=tick_p_ms,
         solve_iterations=solve_iterations, solve_max_abs_err=solve_err,
         solve_kernel_ms=solve_k_ms, solve_plain_ms=solve_p_ms,
         cell_updates_per_s_kernel=(side - 2) ** 2 / 2 * 100 / (reps_k_ms / 1e3),
         tile_tick_ms=tick_t_ms, tile_tick_ms_mean10=reps_t_ms, tile_tick_max_abs_err=tile_tick_err,
         tile_solve_ms=solve_t_ms, tile_solve_max_abs_err=tile_solve_err,
         cell_updates_per_s_tile=(side - 2) ** 2 / 2 * 100 / (reps_t_ms / 1e3),
         bounds={"tick": bound(base.locked, 0, 100),
                 "solve": bound(base.locked, 0, solve_iterations)})
    return {"tick_err": tick_err, "solve_err": solve_err,
            "tile_err": max(tile_tick_err, tile_solve_err)}


def phase_grid2048(dev) -> dict:
    """2048^2 (21 MB of u and locked): within two thirds of the L2,
    where the planner keeps K1/K2. The main path, counts zeroed just before and read just after: Planner.update
    of 100 sweeps from an even and an odd iteration and Planner.solve capped
    at 2000; K1 and K2's resident entry must run, the in-place K2, the tiles
    and the plain versions must not. Each against core, the same bits; the
    tick's mean of 10; then the in-place K2's capped solve, timed, the same
    bits, counted on its own (the in-place entry once, nothing else)."""
    import epic_tpu_torch as T
    from epic_tpu_torch import maps
    from epic_tpu_torch.config import EpicConfig
    from epic_tpu_torch.solver import core, hopper_sweep, hopper_tile2d, tiled

    side = GRID_SIDE
    cfg = EpicConfig.load_yaml(ROOT / "configs" / "maze.yaml")
    base = T.from_occupancy_image(maps.random_obstacles(side, side, seed=0), cfg.solver.epsilon,
                                  device=dev)
    require(not hopper_tile2d.use_tiles((side, side), dev), f"{side}^2 is routed to the tiles")
    starts = {t: at_iteration(base, t) for t in (0, 1)}
    plain = {t: core.update_n(starts[t], 100) for t in (0, 1)}
    res = {}
    tick_p_ms = event_ms(lambda: core.update_n(starts[0], 100))
    solve_p_ms = event_ms(lambda: res.__setitem__("ps", core.solve(base, STAGGER, BIG_CAP)))
    planner = T.Planner(cfg, device=dev)
    got, times = {}, {}
    zero_counts()
    for t in (0, 1):
        planner.state = copy_state(starts[t])
        planner.update(100)
        got[t] = copy_state(planner.state)
    planner.state = copy_state(base)
    times["solve"] = event_ms(lambda: planner.solve(max_iterations=BIG_CAP))
    res["ks"] = planner.state
    torch.cuda.synchronize()
    launches = {k: v for k, v in hopper_sweep.launches.items() if v}
    others = {**hopper_tile2d.launches, **{f"core.{k}": v for k, v in core.calls.items()},
              **{f"tiled.{k}": v for k, v in tiled.calls.items()}}
    require(launches == {"epic_sweep2d_chunk": 2, "epic_sweep2d_solve_resident": 1},
            f"{side}^2: K1/K2 launches {launches}")
    require(all(v == 0 for v in others.values()),
            f"{side}^2: another kernel or the plain version ran on the main path: {others}")
    tick_err = max(compare(got[t], plain[t], f"{side}^2 100-sweep tick from iteration {t}")
                   for t in (0, 1))
    solve_err = compare(res["ks"], res["ps"], f"{side}^2 solve capped at {BIG_CAP}")
    in_place_ran = new_counts(f"{side}^2 in-place K2", lambda: times.__setitem__(
        "in_place", event_ms(lambda: res.__setitem__("is", hopper_sweep.solve_in_place(
            copy_state(base), STAGGER, BIG_CAP)))), {"epic_sweep2d_solve": 1})
    in_place_err = compare(res["is"], res["ps"], f"{side}^2 solve capped at {BIG_CAP} (in place)")
    planner.state = copy_state(starts[0])
    times["tick10"] = event_ms(lambda: planner.update(100), reps=10)
    iters = int(res["ks"].iteration)
    bounds = {"tick": bound(base.locked, 0, 100), "solve": bound(base.locked, 0, iters)}
    emit(phase="grid2048", shape=[side, side], launches=launches,
         tick_max_abs_err=tick_err, tick_kernel_ms_mean10=times["tick10"],
         tick_plain_ms=tick_p_ms, solve_cap=BIG_CAP, solve_iterations=iters,
         solve_max_abs_err=solve_err, solve_kernel_ms=times["solve"], solve_plain_ms=solve_p_ms,
         solve_plan=hopper_sweep.plan_on((side, side), dev)._asdict(),
         solve_in_place_ms=times["in_place"], solve_in_place_max_abs_err=in_place_err,
         cell_updates_per_s=(side - 2) ** 2 / 2 * 100 / (times["tick10"] / 1e3), bounds=bounds)
    return {"launches": {**launches, **in_place_ran}, "tick_err": tick_err,
            "solve_err": solve_err, "in_place_err": in_place_err,
            "tick": (times["tick10"], tick_p_ms, bounds["tick"]),
            "solve": (times["solve"], solve_p_ms, bounds["solve"]),
            "in_place": (times["in_place"], solve_p_ms, bounds["solve"])}


def counted_main_path(what: str, drive) -> dict:
    """Run ``drive()`` with every count zeroed just before and read just
    after: the tile kernels must have run, the in-place 2D kernels and the
    plain versions must not. Returns the tile kernels' launches."""
    from epic_tpu_torch.solver import core, hopper_sweep, hopper_tile2d, tiled

    zero_counts()
    drive()
    torch.cuda.synchronize()
    launches = dict(hopper_tile2d.launches)
    others = {**hopper_sweep.launches, **{f"core.{k}": v for k, v in core.calls.items()},
              **{f"tiled.{k}": v for k, v in tiled.calls.items()}}
    require(all(v > 0 for v in launches.values()), f"{what}: a tile kernel never ran: {launches}")
    require(all(v == 0 for v in others.values()),
            f"{what}: another kernel or the plain version ran on the main path: {others}")
    return launches


def phase_biggrid(dev) -> dict:
    import epic_tpu_torch as T
    from epic_tpu_torch import maps, solver
    from epic_tpu_torch.config import EpicConfig
    from epic_tpu_torch.solver import core, hopper_sweep, hopper_tile2d, tiled

    side = BIG_SIDE
    cfg = EpicConfig.load_yaml(ROOT / "configs" / "maze.yaml")
    k = cfg.solver.tile_depth
    t0 = time.perf_counter()
    base = T.from_occupancy_image(maps.random_obstacles(side, side, seed=0), cfg.solver.epsilon,
                                  device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    require(hopper_tile2d.use_tiles((side, side), dev), f"{side}^2 is not routed to the tiles")
    starts = {t: at_iteration(base, t) for t in (0, 1)}

    # The plain references, before the counted window.
    plain, res = {}, {}
    for t in (0, 1):
        plain[t, 50] = core.update_n(starts[t], 50)
        plain[t, 150] = core.update_n(plain[t, 50], 100)
    tick_p_ms = event_ms(lambda: core.update_n(starts[0], 100))
    solve_p_ms = event_ms(lambda: res.__setitem__("ps", core.solve(base, STAGGER, BIG_CAP)))

    planner = T.Planner(cfg, device=dev)
    got, times = {}, {}

    def drive():
        for t in (0, 1):
            planner.state = copy_state(starts[t])
            planner.update(50)
            got[t, 50] = copy_state(planner.state)
            planner.update(100)
            got[t, 150] = copy_state(planner.state)
        planner.state = copy_state(base)
        times["solve"] = event_ms(lambda: planner.solve(max_iterations=BIG_CAP))
        res["ks"] = planner.state
        times["segments"] = event_ms(lambda: res.__setitem__("seg", solver.solve_grid(
            copy_state(base), STAGGER, BIG_CAP, segment_iterations=500, chunk_depth=k)))
        planner.state = copy_state(starts[0])
        times["tick10"] = event_ms(lambda: planner.update(100), reps=10)

    launches = counted_main_path(f"{side}^2", drive)
    errs = [compare(got[key], plain[key], f"{side}^2 tick to iteration {key[0] + key[1]}")
            for key in sorted(plain)]
    solve_err = compare(res["ks"], res["ps"], f"{side}^2 solve capped at {BIG_CAP}")
    seg_err = compare(res["seg"], res["ks"], f"{side}^2 segmented solve vs one launch")

    k1 = copy_state(starts[0])
    k1_ms10 = event_ms(lambda: hopper_sweep.update_n(k1, 100), reps=10)
    clock = sm_clock_mhz(lambda: [hopper_sweep.update_n(k1, 100) for _ in range(50)])

    # The chunk and cycle entries alone, against the plain tile version.
    src, locked = base.u, base.locked
    chunk_ms = event_ms(lambda: res.__setitem__("c", hopper_tile2d.sweep_chunk(src, locked, 0, k, k=k)),
                        reps=10)
    chunk_p_ms = event_ms(lambda: res.__setitem__("pc", tiled.sweep_chunk(
        src, locked, 0, k, k=k, tile=hopper_tile2d.TILE)))
    chunk_err = max(max_abs(res["c"][0], res["pc"][0]), max_abs(res["c"][1], res["pc"][1]))
    require(chunk_err == 0.0, f"{side}^2 chunk entry vs plain: {chunk_err}")
    a, b = src.clone(), torch.empty_like(src)
    cycle_ms = event_ms(lambda: hopper_tile2d.sweep_cycle(a, b, locked, 0, 4, 50, k=k), reps=10)
    res["y"] = hopper_tile2d.sweep_cycle(src.clone(), torch.empty_like(src), locked, 0, 4, 50, k=k)
    cycle_p_ms = event_ms(lambda: res.__setitem__("py", tiled.sweep_cycle(
        src, src, locked, 0, 4, 50, k=k, tile=hopper_tile2d.TILE)))
    cycle_err = max(max_abs(res["y"][0], res["py"][0]), max_abs(res["y"][2], res["py"][2]))
    require(cycle_err == 0.0, f"{side}^2 cycle entry vs plain: {cycle_err}")
    iters = int(res["ks"].iteration)
    bounds = {"tick": bound(locked, 0, 100), "solve": bound(locked, 0, iters),
              "chunk": bound(locked, 0, k), "cycle": bound(locked, 0, 50)}
    emit(phase="biggrid", shape=[side, side], setup_s=setup_s, tile=list(hopper_tile2d.TILE), k=k,
         launches=launches, tick_max_abs_err=max(errs),
         tile_tick_ms_mean10=times["tick10"], sweep2d_tick_ms_mean10=k1_ms10,
         tick_plain_ms=tick_p_ms, solve_cap=BIG_CAP, solve_iterations=iters,
         solve_converged=bool(res["ks"].converged), solve_max_abs_err=solve_err,
         solve_kernel_ms=times["solve"], solve_plain_ms=solve_p_ms,
         segments_ms=times["segments"], segments_max_abs_err=seg_err,
         chunk_sweeps=k, chunk_kernel_ms_mean10=chunk_ms, chunk_plain_ms=chunk_p_ms,
         cycle_sweeps=50, cycle_chunks=4, cycle_kernel_ms_mean10=cycle_ms,
         cycle_plain_ms=cycle_p_ms,
         cell_updates_per_s_tile=(side - 2) ** 2 / 2 * 100 / (times["tick10"] / 1e3),
         cell_updates_per_s_sweep2d=(side - 2) ** 2 / 2 * 100 / (k1_ms10 / 1e3), bounds=bounds,
         sm_clock_mhz_under_load=clock)
    return {"launches": launches, "err": max(errs + [solve_err, seg_err, chunk_err, cycle_err]),
            "sm_clock_mhz": clock,
            "chunk": (chunk_ms, chunk_p_ms, bounds["chunk"]),
            "cycle": (cycle_ms, cycle_p_ms, bounds["cycle"]),
            "solve": (times["solve"], solve_p_ms, bounds["solve"])}


def phase_wide(dev) -> dict:
    import epic_tpu_torch as T
    from epic_tpu_torch import maps
    from epic_tpu_torch.config import EpicConfig
    from epic_tpu_torch.solver import core, hopper_sweep, hopper_tile2d

    h, w = WIDE
    cfg = EpicConfig.load_yaml(ROOT / "configs" / "maze.yaml")
    base = T.from_occupancy_image(maps.random_obstacles(h, w, seed=0), cfg.solver.epsilon,
                                  device=dev)
    require(hopper_tile2d.use_tiles((h, w), dev), f"{h}x{w} is not routed to the tiles")
    starts = {t: at_iteration(base, t) for t in (0, 1)}
    plain, res, got, times = {}, {}, {}, {}
    for t in (0, 1):
        plain[t] = core.update_n(starts[t], 100)
    solve_p_ms = event_ms(lambda: res.__setitem__("ps", core.solve(base, STAGGER, WIDE_CAP)))
    planner = T.Planner(cfg, device=dev)

    def drive():
        for t in (0, 1):
            planner.state = copy_state(starts[t])
            times[t] = event_ms(lambda: planner.update(100))
            got[t] = copy_state(planner.state)
        planner.state = copy_state(base)
        times["solve"] = event_ms(lambda: planner.solve(max_iterations=WIDE_CAP))

    launches = counted_main_path(f"{h}x{w}", drive)
    errs = [compare(got[t], plain[t], f"{h}x{w} 100-sweep tick from iteration {t}") for t in (0, 1)]
    solve_err = compare(planner.state, res["ps"], f"{h}x{w} solve capped at {WIDE_CAP}")
    k1 = copy_state(starts[0])
    k1_ms10 = event_ms(lambda: hopper_sweep.update_n(k1, 100), reps=10)
    t_state = copy_state(starts[0])
    t_ms10 = event_ms(lambda: hopper_tile2d.update_n(t_state, 100, cfg.solver.tile_depth), reps=10)
    emit(phase="wide", shape=[h, w], launches=launches, tick_max_abs_err=max(errs),
         tile_tick_ms=[times[0], times[1]], tile_tick_ms_mean10=t_ms10,
         sweep2d_tick_ms_mean10=k1_ms10, solve_cap=WIDE_CAP,
         solve_iterations=int(planner.state.iteration), solve_max_abs_err=solve_err,
         solve_kernel_ms=times["solve"], solve_plain_ms=solve_p_ms,
         cell_updates_per_s_tile=(h - 2) * (w - 2) / 2 * 100 / (t_ms10 / 1e3),
         bounds={"tick": bound(base.locked, 0, 100),
                 "solve": bound(base.locked, 0, int(planner.state.iteration))})
    return {"launches": launches, "err": max(errs + [solve_err])}


def phase_tile_small(dev, maze, maze_solved) -> dict:
    """The chunk entry with u1 on the maze field, and the converged exit path
    of the one-launch tile solve against K2's."""
    import epic_tpu_torch as T
    from epic_tpu_torch.solver import core, hopper_tile2d, tiled

    k = hopper_tile2d.DEFAULT_DEPTH
    locked = T.from_occupancy_image(maze["img"], EPS, device="cpu").locked.numpy()
    errs = []
    for t0 in (300, 301):
        arrays = dict(u=maze["ref_u300"], locked=locked, iteration=np.int32(t0),
                      delta=np.float32(1.0), converged=np.bool_(False), epsilon=np.float32(EPS))
        st = T.state_from_numpy(arrays, device=dev)
        dst, delta, u1 = hopper_tile2d.sweep_chunk(st.u, st.locked, st.iteration, k, k=k, u1=True)
        p_dst, p_delta, p_u1 = tiled.sweep_chunk(st.u, st.locked, st.iteration, k, k=k,
                                                 tile=hopper_tile2d.TILE, u1=True)
        full, one = core.update_n(st, k), core.update_n(st, 1)
        errs.append(max(max_abs(dst, full.u), max_abs(u1, one.u), max_abs(delta, full.delta),
                        max_abs(dst, p_dst), max_abs(u1, p_u1), max_abs(delta, p_delta)))
        require(errs[-1] == 0.0, f"maze chunk with u1 from iteration {t0}: differs by {errs[-1]}")
    chunk_ms = event_ms(lambda: hopper_tile2d.sweep_chunk(st.u, st.locked, st.iteration, k, k=k,
                                                          u1=True), reps=10)
    chunk_p_ms = event_ms(lambda: tiled.sweep_chunk(st.u, st.locked, st.iteration, k, k=k,
                                                    tile=hopper_tile2d.TILE, u1=True))
    res = {}
    solve_ms = event_ms(lambda: res.__setitem__("s", hopper_tile2d.solve(
        T.from_occupancy_image(maze["img"], EPS, device=dev), STAGGER)))
    solve_err = compare(res["s"], maze_solved, "maze tile solve vs the in-place solve")
    iters = int(res["s"].iteration)
    emit(phase="tile_small", shape=list(maze["img"].shape), chunk_sweeps=k,
         chunk_u1_max_abs_err=max(errs), chunk_u1_kernel_ms_mean10=chunk_ms,
         chunk_u1_plain_ms=chunk_p_ms, solve_iterations=iters,
         solve_converged=bool(res["s"].converged), solve_max_abs_err=solve_err,
         solve_kernel_ms=solve_ms,
         bounds={"chunk": bound(st.locked, 301, k), "solve": bound(st.locked, 0, iters)})
    return {"err": max(errs + [solve_err])}


def counted_3d(what: str, drive, tiles: bool) -> dict:
    """Run ``drive()`` with every count zeroed just before and read just
    after: the 3D family ``tiles`` names (the tile kernels, else K7) must
    have run, the other family and the plain versions must not. Returns the
    launches of the family that ran."""
    from epic_tpu_torch.solver import core, hopper_sweep3d, hopper_tile3d, tiled3d

    zero_counts()
    drive()
    torch.cuda.synchronize()
    ran, other = ((hopper_tile3d.launches, hopper_sweep3d.launches) if tiles
                  else (hopper_sweep3d.launches, hopper_tile3d.launches))
    ran = dict(ran)
    others = {**other, **{f"core.{k}": v for k, v in core.calls.items()},
              **{f"tiled3d.{k}": v for k, v in tiled3d.calls.items()}}
    require(all(v > 0 for v in ran.values()), f"{what}: a kernel never ran: {ran}")
    require(all(v == 0 for v in others.values()),
            f"{what}: another kernel or the plain version ran: {others}")
    return ran


def add_counts(total: dict, counts: dict) -> None:
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def phase_biggrid3d(dev) -> dict:
    """256^3 through the VolumePlanner (the routed main path) and through
    the tile route's own entries, against core, K7 and the plain tile
    version."""
    import epic_tpu_torch as T
    from epic_tpu_torch.solver import core, hopper_sweep3d, hopper_tile3d, tiled3d

    u, locked = volume_arrays(SIZE3D)
    base = volume_state(dev, u, locked)
    starts = {t: volume_state(dev, u, locked, t) for t in (0, 1)}
    lt = torch.from_numpy(locked)
    del u
    k, tile = hopper_tile3d.DEFAULT_DEPTH, hopper_tile3d.tile_for(SIZE3D, dev)

    # The references, before the counted windows.
    plain, res, times = {}, {}, {}
    for t in (0, 1):
        plain[t, 50] = core.update_n(starts[t], 50)
        plain[t, 150] = core.update_n(plain[t, 50], 100)
    tick_p_ms = event_ms(lambda: core.update_n(starts[0], 100))
    solve_p_ms = event_ms(lambda: res.__setitem__("ps", core.solve(base, STAGGER)))
    k7_solve_ms = event_ms(lambda: res.__setitem__("k7", hopper_sweep3d.solve(copy_state(base),
                                                                              STAGGER)))
    compare(res["k7"], res["ps"], "256^3 K7 solve vs plain")

    planner = T.VolumePlanner(T.VolumePlannerConfig(epsilon=EPS, stagger=STAGGER), device=dev)
    got = {}

    def drive_planner():
        for t in (0, 1):
            planner.state = copy_state(starts[t])
            planner.update(50)
            got[t, 50] = copy_state(planner.state)
            planner.update(100)
            got[t, 150] = copy_state(planner.state)
        planner.state = copy_state(base)
        times["planner_solve"] = event_ms(planner.solve)
        res["planner"] = planner.state

    main = counted_3d("256^3 VolumePlanner", drive_planner, False)
    errs = [compare(got[key], plain[key], f"256^3 VolumePlanner tick to iteration {sum(key)}")
            for key in sorted(plain)]
    errs.append(compare(res["planner"], res["ps"], "256^3 VolumePlanner solve vs plain"))
    errs.append(compare(res["planner"], res["k7"], "256^3 VolumePlanner solve vs K7"))
    require(bool(res["planner"].converged), "256^3 VolumePlanner solve did not converge")

    tgot = {}

    def drive_tiles():
        for t in (0, 1):
            st = hopper_tile3d.update_n(copy_state(starts[t]), 50, k)
            tgot[t, 50] = copy_state(st)
            tgot[t, 150] = hopper_tile3d.update_n(st, 100, k)
        times["tile_solve"] = event_ms(lambda: res.__setitem__(
            "ts", hopper_tile3d.solve(copy_state(base), STAGGER, k=k)))

    tile_launches = counted_3d("256^3 tile route", drive_tiles, True)
    errs += [compare(tgot[key], plain[key], f"256^3 tile tick to iteration {sum(key)}")
             for key in sorted(plain)]
    errs.append(compare(res["ts"], res["ps"], "256^3 tile solve vs plain"))
    iters = int(res["ts"].iteration)

    k7s, tls = copy_state(starts[0]), copy_state(starts[0])
    k7_ms10 = event_ms(lambda: hopper_sweep3d.update_n(k7s, 100), reps=10)
    tile_ms10 = event_ms(lambda: hopper_tile3d.update_n(tls, 100, k), reps=10)

    # The chunk and cycle entries alone, against the plain tile version and core.
    src, lk = base.u, base.locked
    chunk_ms = event_ms(lambda: res.__setitem__("c", hopper_tile3d.sweep_chunk(src, lk, 0, k, k=k)),
                        reps=10)
    chunk_p_ms = event_ms(lambda: res.__setitem__("pc", tiled3d.sweep_chunk(src, lk, 0, k, k=k,
                                                                            tile=tile)))
    ref = core.update_n(base, k)
    chunk_err = max(max_abs(res["c"][0], res["pc"][0]), max_abs(res["c"][1], res["pc"][1]),
                    max_abs(res["c"][0], ref.u), max_abs(res["c"][1], ref.delta))
    require(chunk_err == 0.0, f"256^3 chunk entry vs plain: {chunk_err}")
    cycle_sweeps, cycle_chunks = 4 * k, 4
    a, b = src.clone(), torch.empty_like(src)
    cycle_ms = event_ms(lambda: hopper_tile3d.sweep_cycle(a, b, lk, 0, cycle_chunks, cycle_sweeps,
                                                          k=k), reps=10)
    res["y"] = hopper_tile3d.sweep_cycle(src.clone(), torch.empty_like(src), lk, 0, cycle_chunks,
                                         cycle_sweeps, k=k)
    cycle_p_ms = event_ms(lambda: res.__setitem__("py", tiled3d.sweep_cycle(
        src, src, lk, 0, cycle_chunks, cycle_sweeps, k=k, tile=tile)))
    cycle_err = max(max_abs(res["y"][0], res["py"][0]), max_abs(res["y"][2], res["py"][2]),
                    max_abs(res["y"][0], core.update_n(base, cycle_sweeps).u))
    require(cycle_err == 0.0, f"256^3 cycle entry vs plain: {cycle_err}")
    bounds = {"tick": bound(lt, 0, 100, lse6=True), "solve": bound(lt, 0, iters, lse6=True),
              "chunk": bound(lt, 0, k, lse6=True), "cycle": bound(lt, 0, cycle_sweeps, lse6=True)}
    emit(phase="biggrid3d", shape=list(SIZE3D), tile=list(tile), k=k,
         launches=main, tile_route_launches=tile_launches, tick_max_abs_err=max(errs),
         tile_tick_ms_mean10=tile_ms10, sweep3d_tick_ms_mean10=k7_ms10,
         tick_plain_ms=tick_p_ms, solve_iterations=iters, solve_converged=bool(res["ts"].converged),
         planner_solve_ms=times["planner_solve"], tile_solve_ms=times["tile_solve"],
         sweep3d_solve_ms=k7_solve_ms, solve_plain_ms=solve_p_ms,
         chunk_sweeps=k, chunk_kernel_ms_mean10=chunk_ms, chunk_plain_ms=chunk_p_ms,
         cycle_sweeps=cycle_sweeps, cycle_chunks=cycle_chunks, cycle_kernel_ms_mean10=cycle_ms,
         cycle_plain_ms=cycle_p_ms, bounds=bounds)
    return {"main": main, "tile_launches": tile_launches,
            "err": max(errs + [chunk_err, cycle_err]),
            "rows": {"epic_tile3d_chunk": (chunk_ms, chunk_p_ms, bounds["chunk"]),
                     "epic_tile3d_cycle": (cycle_ms, cycle_p_ms, bounds["cycle"]),
                     "epic_tile3d_solve": (times["tile_solve"], solve_p_ms, bounds["solve"])}}


def phase_wide3d(dev) -> dict:
    import epic_tpu_torch as T
    from epic_tpu_torch import solver
    from epic_tpu_torch.solver import core, hopper_sweep3d, hopper_tile3d, tiled3d

    t0 = time.perf_counter()
    u, locked = volume_arrays(WIDE3D)
    base = volume_state(dev, u, locked)
    lt = torch.from_numpy(locked)
    del u, locked
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    k = hopper_tile3d.DEFAULT_DEPTH
    starts = {t: at_iteration(base, t) for t in (0, 1)}
    plain, res, got, times = {}, {}, {}, {}
    for t in (0, 1):
        plain[t] = core.update_n(starts[t], 100)
    plain[50] = core.update_n(starts[0], 50)
    solve_p_ms = event_ms(lambda: res.__setitem__("ps", core.solve(base, STAGGER, WIDE3D_CAP)))
    planner = T.VolumePlanner(T.VolumePlannerConfig(epsilon=EPS, stagger=STAGGER), device=dev)

    def drive():
        for t in (0, 1):
            planner.state = copy_state(starts[t])
            times[t] = event_ms(lambda: planner.update(100))
            got[t] = copy_state(planner.state)
        planner.state = copy_state(base)
        times["solve"] = event_ms(lambda: planner.solve(max_iterations=WIDE3D_CAP))
        times["segments"] = event_ms(lambda: res.__setitem__("seg", solver.solve_volume(
            copy_state(base), STAGGER, WIDE3D_CAP, segment_iterations=WIDE3D_SEGMENT)))

    what = "32x2048x2048"
    main = counted_3d(f"{what} VolumePlanner", drive, False)
    errs = [compare(got[t], plain[t], f"{what} 100-sweep tick from iteration {t}") for t in (0, 1)]
    errs.append(compare(planner.state, res["ps"], f"{what} solve capped at {WIDE3D_CAP}"))
    errs.append(compare(res["seg"], planner.state, f"{what} solve_volume segments vs one launch"))

    def drive_tiles():
        for t in (0, 1):
            times["tile", t] = event_ms(lambda: got.__setitem__(
                ("tile", t), hopper_tile3d.update_n(copy_state(starts[t]), 100, k)))
        # An odd chunk count: the remainder chunk.
        got["tile", 50] = hopper_tile3d.update_n(copy_state(starts[0]), 50, k)
        times["tile_solve"] = event_ms(lambda: res.__setitem__("ts", hopper_tile3d.solve(
            copy_state(base), STAGGER, WIDE3D_CAP, k)))
        times["tile_segments"] = event_ms(lambda: res.__setitem__("tseg", hopper_tile3d.solve_segments(
            copy_state(base), STAGGER, WIDE3D_CAP, WIDE3D_SEGMENT, k)))

    tile_launches = counted_3d(f"{what} tile route", drive_tiles, True)
    errs += [compare(got["tile", t], plain[t], f"{what} tile tick from iteration {t}")
             for t in (0, 1, 50)]
    errs.append(compare(res["ts"], res["ps"], f"{what} tile solve capped at {WIDE3D_CAP}"))
    errs.append(compare(res["tseg"], res["ts"], f"{what} tile segments vs one launch"))
    k7_solve_ms = event_ms(lambda: res.__setitem__("k7", hopper_sweep3d.solve(
        copy_state(base), STAGGER, WIDE3D_CAP)))
    errs.append(compare(res["k7"], res["ps"], f"{what} K7 solve capped at {WIDE3D_CAP}"))
    k7s, tls = copy_state(starts[0]), copy_state(starts[0])
    k7_ms5 = event_ms(lambda: hopper_sweep3d.update_n(k7s, 100), reps=5)
    tile_ms5 = event_ms(lambda: hopper_tile3d.update_n(tls, 100, k), reps=5)
    del k7s, tls
    iters = int(res["ts"].iteration)

    # The chunk and cycle entries alone on the routed volume (the kernels
    # line's rows), against the plain tile version and core.
    tile = hopper_tile3d.tile_for(WIDE3D, dev)
    src, lk = base.u, base.locked
    chunk_ms = event_ms(lambda: res.__setitem__("c", hopper_tile3d.sweep_chunk(src, lk, 0, k, k=k)),
                        reps=5)
    chunk_p_ms = event_ms(lambda: res.__setitem__("pc", tiled3d.sweep_chunk(src, lk, 0, k, k=k,
                                                                            tile=tile)))
    ref = core.update_n(base, k)
    chunk_err = max(max_abs(res["c"][0], res["pc"][0]), max_abs(res["c"][1], res["pc"][1]),
                    max_abs(res["c"][0], ref.u), max_abs(res["c"][1], ref.delta))
    require(chunk_err == 0.0, f"{what} chunk entry vs plain: {chunk_err}")
    del res["c"], res["pc"], ref
    cycle_sweeps, cycle_chunks = 4 * k, 4
    a, b = src.clone(), torch.empty_like(src)
    cycle_ms = event_ms(lambda: hopper_tile3d.sweep_cycle(a, b, lk, 0, cycle_chunks, cycle_sweeps,
                                                          k=k), reps=5)
    res["y"] = hopper_tile3d.sweep_cycle(a.copy_(src), b, lk, 0, cycle_chunks, cycle_sweeps, k=k)
    cycle_p_ms = event_ms(lambda: res.__setitem__("py", tiled3d.sweep_cycle(
        src, src, lk, 0, cycle_chunks, cycle_sweeps, k=k, tile=tile)))
    cycle_err = max(max_abs(res["y"][0], res["py"][0]), max_abs(res["y"][2], res["py"][2]),
                    max_abs(res["y"][0], core.update_n(base, cycle_sweeps).u))
    require(cycle_err == 0.0, f"{what} cycle entry vs plain: {cycle_err}")
    del res["y"], res["py"], a, b
    bounds = {"tick": bound(lt, 0, 100, lse6=True), "solve": bound(lt, 0, iters, lse6=True),
              "chunk": bound(lt, 0, k, lse6=True), "cycle": bound(lt, 0, cycle_sweeps, lse6=True)}
    emit(phase="wide3d", shape=list(WIDE3D), setup_s=setup_s,
         tile=list(tile), k=k,
         launches=main, tile_route_launches=tile_launches, max_abs_err=max(errs),
         planner_tick_ms=[times[0], times[1]], planner_solve_ms=times["solve"],
         solve_volume_segments_ms=times["segments"],
         tile_tick_ms=[times["tile", 0], times["tile", 1]], tile_solve_ms=times["tile_solve"],
         tile_segments_ms=times["tile_segments"], tile_tick_ms_mean5=tile_ms5,
         sweep3d_tick_ms_mean5=k7_ms5, sweep3d_solve_ms=k7_solve_ms, solve_cap=WIDE3D_CAP,
         segment_iterations=WIDE3D_SEGMENT,
         solve_iterations=iters, solve_plain_ms=solve_p_ms,
         chunk_sweeps=k, chunk_kernel_ms_mean5=chunk_ms, chunk_plain_ms=chunk_p_ms,
         cycle_sweeps=cycle_sweeps, cycle_chunks=cycle_chunks, cycle_kernel_ms_mean5=cycle_ms,
         cycle_plain_ms=cycle_p_ms, bounds=bounds,
         pass_bytes_bound_ms={"tick": pass_bytes_bound_ms(WIDE3D, 100),
                              "solve": pass_bytes_bound_ms(WIDE3D, iters)})
    return {"main": main, "tile_launches": tile_launches,
            "err": max(errs + [chunk_err, cycle_err]),
            "chunk": (chunk_ms, chunk_p_ms, bounds["chunk"]),
            "cycle": (cycle_ms, cycle_p_ms, bounds["cycle"]),
            "solve": (times["tile_solve"], solve_p_ms, bounds["solve"])}


def phase_tile3d_small(dev, volume, solved) -> dict:
    """The chunk entry with u1 on phase 6's volume, and the converged exit
    of the one-launch tile solve against K7's."""
    from epic_tpu_torch.solver import core, hopper_tile3d, tiled3d

    u, locked = volume
    k, tile = hopper_tile3d.DEFAULT_DEPTH, hopper_tile3d.tile_for(u.shape, dev)
    errs = []
    for t0 in (0, 1):
        st = volume_state(dev, u, locked, t0)
        dst, delta, u1 = hopper_tile3d.sweep_chunk(st.u, st.locked, st.iteration, k, k=k, u1=True)
        p_dst, p_delta, p_u1 = tiled3d.sweep_chunk(st.u, st.locked, st.iteration, k, k=k,
                                                   tile=tile, u1=True)
        full, one = core.update_n(st, k), core.update_n(st, 1)
        errs.append(max(max_abs(dst, full.u), max_abs(u1, one.u), max_abs(delta, full.delta),
                        max_abs(dst, p_dst), max_abs(u1, p_u1), max_abs(delta, p_delta)))
        require(errs[-1] == 0.0, f"30x256x256 chunk with u1 from iteration {t0}: "
                f"differs by {errs[-1]}")
    chunk_ms = event_ms(lambda: hopper_tile3d.sweep_chunk(st.u, st.locked, st.iteration, k, k=k,
                                                          u1=True), reps=10)
    chunk_p_ms = event_ms(lambda: tiled3d.sweep_chunk(st.u, st.locked, st.iteration, k, k=k,
                                                      tile=tile, u1=True))
    res = {}
    solve_ms = event_ms(lambda: res.__setitem__("s", hopper_tile3d.solve(
        volume_state(dev, u, locked), STAGGER)))
    solve_err = compare(res["s"], solved, "30x256x256 tile solve vs the in-place solve")
    iters = int(res["s"].iteration)
    lt = torch.from_numpy(locked)
    emit(phase="tile3d_small", shape=list(u.shape), tile=list(tile), chunk_sweeps=k,
         chunk_u1_max_abs_err=max(errs), chunk_u1_kernel_ms_mean10=chunk_ms,
         chunk_u1_plain_ms=chunk_p_ms, solve_iterations=iters,
         solve_converged=bool(res["s"].converged), solve_max_abs_err=solve_err,
         solve_kernel_ms=solve_ms,
         bounds={"chunk": bound(lt, 1, k, lse6=True), "solve": bound(lt, 0, iters, lse6=True)})
    return {"err": max(errs + [solve_err])}


def volume_arrays(shape, density: float = 0.1, seed: int = 0):
    """u, locked of a boundary-locked volume with seeded obstacle voxels and
    one goal voxel at the centre (tests/test_pallas3d.py:15-29)."""
    d, h, w = shape
    rng = np.random.default_rng(seed)
    u = np.full(shape, -1e6, dtype=np.float32)
    locked = np.zeros(shape, dtype=bool)
    locked[0], locked[-1] = True, True
    locked[:, 0], locked[:, -1] = True, True
    locked[:, :, 0], locked[:, :, -1] = True, True
    locked |= rng.random(shape) < density
    u[d // 2, h // 2, w // 2] = 0.0
    locked[d // 2, h // 2, w // 2] = True
    return u, locked


def volume_state(dev, u, locked, t0: int = 0):
    import epic_tpu_torch as T

    st = T.make_state(u, locked, EPS, device=dev)
    return dataclasses.replace(st, iteration=torch.tensor(t0, dtype=torch.int32, device=dev))


def kernel_vs_plain_3d(dev, u, locked, tick_sweeps: int, cap: int, what: str) -> dict:
    """A tick from an even and an odd iteration and a capped solve, through
    the 3D kernels and the plain version, compared bit for bit and timed."""
    from epic_tpu_torch.solver import core, hopper_sweep3d

    res, errs = {}, []
    for t0 in (0, 1):
        k, p = volume_state(dev, u, locked, t0), volume_state(dev, u, locked, t0)
        tick_k_ms = event_ms(lambda: res.__setitem__("k", hopper_sweep3d.update_n(k, tick_sweeps)))
        tick_p_ms = event_ms(lambda: res.__setitem__("p", core.update_n(p, tick_sweeps)))
        errs.append(compare(res["k"], res["p"], f"{what} {tick_sweeps}-sweep tick from iteration {t0}"))
    state = {"s": res["k"]}
    tick_k_ms10 = event_ms(lambda: state.__setitem__(
        "s", hopper_sweep3d.update_n(state["s"], tick_sweeps)), reps=10)
    k, p = volume_state(dev, u, locked), volume_state(dev, u, locked)
    solve_k_ms = event_ms(lambda: res.__setitem__("k", hopper_sweep3d.solve(k, STAGGER, cap)))
    solve_p_ms = event_ms(lambda: res.__setitem__("p", core.solve(p, STAGGER, cap)))
    solve_err = compare(res["k"], res["p"], f"{what} solve capped at {cap}")
    lt = torch.from_numpy(locked)
    bounds = {"tick": bound(lt, 0, tick_sweeps, lse6=True),
              "solve": bound(lt, 0, int(res["k"].iteration), lse6=True)}
    return dict(tick_sweeps=tick_sweeps, tick_max_abs_err=max(errs), tick_kernel_ms=tick_k_ms,
                tick_kernel_ms_mean10=tick_k_ms10, tick_plain_ms=tick_p_ms,
                solve_cap=cap, solve_iterations=int(res["k"].iteration),
                solve_converged=bool(res["k"].converged), solve_max_abs_err=solve_err,
                solve_kernel_ms=solve_k_ms, solve_plain_ms=solve_p_ms, bounds=bounds)


def phase_volume(dev) -> dict:
    from epic_tpu_torch.solver import hopper_sweep3d

    u, locked = volume_arrays(VOLUME)
    out = kernel_vs_plain_3d(dev, u, locked, 50, VOLUME_CAP, "30x256x256")
    st = volume_state(dev, u, locked)
    res = {}
    ms = event_ms(lambda: res.__setitem__("s", hopper_sweep3d.solve(st, STAGGER)))
    solved = res["s"]
    iters = int(solved.iteration)
    require(bool(solved.converged), "30x256x256 uncapped solve did not converge")
    require(iters >= max(VOLUME) and iters % STAGGER == 1,
            f"30x256x256 solve ended at iteration {iters}: not >= {max(VOLUME)} and 1 mod {STAGGER}")
    require(bool(torch.isfinite(solved.u).all()), "30x256x256 solve: non-finite values")
    d, h, w = VOLUME
    per_sweep = (d - 2) * (h - 2) * (w - 2) / 2
    emit(phase="volume", shape=list(VOLUME), obstacle_density=0.1, eps=EPS, **out,
         full_solve_iterations=iters, full_solve_delta=float(solved.delta),
         full_solve_kernel_ms=ms,
         cell_updates_per_s_kernel_tick=per_sweep * 50 / (out["tick_kernel_ms_mean10"] / 1e3),
         cell_updates_per_s_kernel_solve=per_sweep * iters / (ms / 1e3))
    return {"volume": (u, locked), "solved": solved, **out}


def phase_golden3d(dev) -> None:
    """tests/test_goldens.py:151-160 through the 3D chunk kernel."""
    import epic_tpu_torch as T
    from epic_tpu_torch.solver import hopper_sweep3d

    g = np.load(GOLDENS / "fuzz3d_seed0.npz")
    st = T.make_state(g["u0"], g["locked"], 1e-2, device=dev)
    worst = 0.0
    for t, d_ref in enumerate(g["deltas"]):
        st = hopper_sweep3d.update_n(st, 1)
        err = abs(float(st.delta) - float(d_ref))
        require(err <= 1e-6 + 1e-4 * abs(float(d_ref)),
                f"fuzz3d sweep {t}: delta {float(st.delta)} vs the reference's {float(d_ref)}")
        worst = max(worst, err / (1e-6 + 1e-4 * abs(float(d_ref))))
    field_err = float(np.max(np.abs(st.u.cpu().numpy() - g["ref_u"])))
    require(field_err <= 1e-3, f"fuzz3d field differs from the golden by {field_err}")
    emit(phase="golden3d", shape=list(g["u0"].shape), sweeps=len(g["deltas"]),
         worst_delta_err_over_bound=worst, field_max_abs_err=field_err)


def reaching_starts(planner, n: int, seed: int = 1) -> tuple[list, float]:
    """The first ``n`` of 512 seeded free voxels near the goal whose walk
    (the batched walker on the card, step 0.2, precision 0.4) ends in the
    goal, and the share of the 512 that do. On a field of single-voxel
    obstacles most walks stop at a plateau between obstacles, so the starts
    are picked; the server's walkers must then reach the goal from them."""
    from epic_tpu_torch import grid as G
    from epic_tpu_torch.solver import batched_path3d

    st = planner.state
    locked = G.host_locked(st)
    d, h, w = locked.shape
    zs, ys, xs = np.nonzero(~locked)
    dist = np.abs(zs - d // 2) + np.abs(ys - h // 2) + np.abs(xs - w // 2)
    near = np.nonzero((dist >= 8) & (dist <= 60))[0]
    pick = np.random.default_rng(seed).permutation(near)[:512]
    cand = np.stack([xs[pick], ys[pick], zs[pick]], 1).astype(np.float32)
    out = batched_path3d.walk(st.u, st.locked, cand, 0.2, 0.4, 4096, record_trajectories=False)
    reached = np.nonzero(out["reached_goal"].cpu().numpy())[0]
    require(len(reached) >= n, f"only {len(reached)} of {len(cand)} seeded starts reach the goal")
    return [tuple(float(v) for v in cand[i]) for i in reached[:n]], len(reached) / len(cand)


def phase_session3d(dev, s, maze, volume) -> dict:
    """The 3D verbs on phase 4's server over its socket, then the 2D
    compute_paths; the server is closed at the end."""
    from epic_tpu_torch import grid as G
    from epic_tpu_torch import path, path3d
    from epic_tpu_torch.solver import core, hopper_sweep3d

    server = s.server
    u, locked = volume
    d, h, w = u.shape
    occ = np.where(locked & (u != 0.0), 100, 0).astype(np.int8)
    goal = [float(w // 2), float(h // 2), float(d // 2)]
    try:
        zero_counts()
        t0 = time.perf_counter()
        r, _ = s.call("occupancy_volume", depth=d, height=h, width=w,
                      data=occ.reshape(-1).tolist(), resolution=1.0, origin=[0.0, 0.0, 0.0])
        ingest_s = time.perf_counter() - t0
        require(r["success"], f"occupancy_volume: {r}")
        vol = server.volume_planner
        require(vol.device == dev, f"the volume lives on {vol.device}, not {dev}")
        r, _ = s.call("add_goals_3d", goals=[goal])
        require(r["success"], f"add_goals_3d: {r}")
        # The ingested volume is phase 6's: the same locked voxels and values
        # (the free ones have ticked since).
        ul, ll = G.host_u(vol.state), G.host_locked(vol.state)
        require(np.array_equal(ll, locked) and np.array_equal(ul[ll], u[locked]),
                "the ingested volume differs from phase 6's")
        t0 = time.perf_counter()
        s.spin(10)
        torch.cuda.synchronize()
        ten_ticks_s = time.perf_counter() - t0

        free = np.argwhere(~locked)
        ez, ey, ex = (int(v) for v in free[len(free) // 3])
        r, _ = s.call("set_cells_3d", v=[ex, ey, ez], types=[1])
        require(r["success"], f"set_cells_3d: {r}")
        r, _ = s.call("get_cell_3d", x=ex, y=ey, z=ez)
        require(r["success"] and r["value"] == -1e6, f"get_cell_3d on the new obstacle: {r}")
        s.spin(10)
        r, _ = s.call("set_cells_3d", v=[ex, ey, ez], types=[2])
        require(r["success"], f"set_cells_3d: {r}")
        s.spin(5)
        r, _ = s.call("info")
        require(r["success"] and "volume" in r and r["volume"]["shape"] == [d, h, w]
                and r["volume"]["iteration"] > 0 and not r["volume"]["paused"], f"info: {r}")
        ticked = r["volume"]["iteration"]

        t0 = time.perf_counter()
        vol.solve()
        require(bool(vol.state.converged), "session volume solve did not converge")
        solve_iterations = int(vol.state.iteration)
        solve_s = time.perf_counter() - t0
        r, _ = s.call("get_cell_3d", x=int(goal[0]), y=int(goal[1]), z=int(goal[2]))
        require(r["success"] and r["value"] == 0.0, f"get_cell_3d on the goal: {r}")
        r, _ = s.call("get_cell_3d", x=ex, y=ey, z=ez)
        require(r["success"] and -1e6 < r["value"] < 0.0, f"get_cell_3d on the freed voxel: {r}")

        t0 = time.perf_counter()
        starts, reach_share = reaching_starts(vol, 3)
        pick_s = time.perf_counter() - t0
        st = vol.state
        ul, ll = G.host_u(st), G.host_locked(st)
        path_points, path_s = [], []
        for x, y, z in starts:
            t0 = time.perf_counter()
            r, _ = s.call("compute_path_3d", x=x, y=y, z=z, step_size=0.2, precision=0.4)
            path_s.append(time.perf_counter() - t0)
            require(r["success"], f"compute_path_3d from ({x}, {y}, {z}): {r}")
            pts = np.asarray(r["path"], dtype=np.float32)[:, :3]
            require(path3d.path_reaches_goal(ul, ll, pts), f"3D path from ({x}, {y}, {z}) misses the goal")
            path_points.append(len(pts))
        rng = np.random.default_rng(2)
        extra = [tuple(float(v) for v in free[i][::-1]) for i in rng.choice(len(free), 5, replace=False)]
        t0 = time.perf_counter()
        r, _ = s.call("compute_paths_3d", starts=[list(p) for p in starts + extra],
                      step_size=0.2, precision=0.4, max_steps=4096)
        batch_s = time.perf_counter() - t0
        require(r["success"] and len(r["paths"]) == 8, f"compute_paths_3d: {str(r)[:200]}")
        batch_points, batch_reach = [], []
        for i, p in enumerate(r["paths"]):
            reached = p is not None and path3d.path_reaches_goal(
                ul, ll, np.asarray(p, dtype=np.float32)[:, :3])
            batch_points.append(0 if p is None else len(p))
            batch_reach.append(bool(reached))
            if i < len(starts):
                require(reached, f"batched 3D path from {starts[i]} misses the goal")
        launches = dict(hopper_sweep3d.launches)
        plain = dict(core.calls)

        # The 2D batched walker on the session's maze field.
        g_starts = golden_goal_starts(maze)
        t0 = time.perf_counter()
        r, _ = s.call("compute_paths", starts=[list(p) for p in g_starts], step_size=0.2,
                      precision=0.4, max_steps=20000)
        paths2d_s = time.perf_counter() - t0
        require(r["success"], f"compute_paths: {str(r)[:200]}")
        st2 = server.node.planner.state
        paths2d_points = []
        for (x, y), p in zip(g_starts, r["paths"]):
            require(p is not None, f"compute_paths from ({x}, {y}): no path")
            pts = np.asarray(p, dtype=np.float32)[:, :2]
            require(path.path_reaches_goal(G.host_u(st2), G.host_locked(st2), pts),
                    f"batched 2D path from ({x}, {y}) ends at {pts[-1].tolist()}, not in a goal")
            paths2d_points.append(len(pts))
    finally:
        s.client.close()
        server.close()
    require(all(v > 0 for v in launches.values()), f"a 3D kernel never ran on the main path: {launches}")
    require(all(v == 0 for v in plain.values()), f"the plain version ran on the main path: {plain}")
    emit(phase="session3d", shape=[d, h, w], ingest_s=ingest_s, ten_ticks_s=ten_ticks_s,
         volume_iteration_at_info=ticked, solve_iterations=solve_iterations, solve_s=solve_s,
         seeded_reach_share=reach_share, pick_starts_s=pick_s, path3d_points=path_points,
         compute_path_3d_s=path_s, compute_paths_3d_points=batch_points,
         compute_paths_3d_reached=batch_reach, compute_paths_3d_s=batch_s,
         compute_paths_2d_points=paths2d_points, compute_paths_2d_s=paths2d_s,
         launches=launches, plain_calls=plain)
    return launches


def phase_size3d(dev) -> dict:
    u, locked = volume_arrays(SIZE3D)
    out = kernel_vs_plain_3d(dev, u, locked, 100, 2000, "256^3")
    d, h, w = SIZE3D
    emit(phase="size3d", shape=list(SIZE3D), **out,
         cell_updates_per_s_kernel=(d - 2) * (h - 2) * (w - 2) / 2 * 100
         / (out["tick_kernel_ms_mean10"] / 1e3))
    return out


def batch_arrays(lanes: int, side: int, seed: int):
    """tools/probe.py:546-556: -1e6 everywhere, 10% obstacle cells, the shell
    locked, one goal cell a lane."""
    rng = np.random.default_rng(seed)
    u = np.full((lanes, side, side), -1e6, np.float32)
    locked = rng.random((lanes, side, side)) < 0.1
    locked[:, 0], locked[:, -1] = True, True
    locked[:, :, 0], locked[:, :, -1] = True, True
    gy = rng.integers(1, side - 1, lanes)
    gx = rng.integers(1, side - 1, lanes)
    u[np.arange(lanes), gy, gx] = 0.0
    locked[np.arange(lanes), gy, gx] = True
    return u, locked


def compare_batch(a, b, what: str) -> float:
    """Two batch solves' (u, iterations, deltas, converged): the same bits."""
    require(torch.equal(a[1], b[1]), f"{what}: iterations differ")
    require(torch.equal(a[3], b[3]), f"{what}: converged differs")
    require(bool(torch.isfinite(a[0]).all()), f"{what}: non-finite values in u")
    err = max(max_abs(a[0], b[0]), max_abs(a[2], b[2]))
    require(err == 0.0, f"{what}: differ by {err}")
    return err


def solo_lanes(dev, u0, locked, out, lanes, cap: int, what: str) -> list:
    """Re-solve ``lanes`` of a batch alone with core.solve on the card; each
    must give the batch lane's bits (u, iteration, delta)."""
    import epic_tpu_torch as T
    from epic_tpu_torch.solver import core

    for lane in lanes:
        solo = core.solve(T.make_state(u0[lane], locked[lane], BATCH_EPS, device=dev), STAGGER, cap)
        require(int(solo.iteration) == int(out[1][lane]),
                f"{what} lane {lane}: {int(out[1][lane])} iterations, solo {int(solo.iteration)}")
        require(torch.equal(solo.u, out[0][lane]) and torch.equal(solo.delta, out[2][lane]),
                f"{what} lane {lane}: the batch lane differs from its solo solve")
    return [int(v) for v in lanes]


def phase_batch(dev) -> dict:
    from epic_tpu_torch.solver import batched, hopper_batched

    lanes, side = BATCH
    require(hopper_batched.lane_resident(side, side, dev), f"{side}^2 lanes are not resident")
    zero_counts()
    t0 = time.perf_counter()
    u_np, l_np = batch_arrays(lanes, side, seed=1)
    u0, locked = batched.batch_from_numpy(u_np, l_np, device=dev)
    del u_np, l_np
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    res, chunk_errs, chunk_ms, chunk_plain_ms = {}, [], {}, {}
    for it0 in (0, 1):
        ku = u0.clone()
        chunk_ms[it0] = event_ms(lambda: res.__setitem__(
            "k", hopper_batched.update_n_batch(ku, locked, it0, 100)))
        chunk_plain_ms[it0] = event_ms(lambda: res.__setitem__(
            "p", batched.update_n_batch(u0, locked, it0, 100)))
        err = max(max_abs(res["k"][0], res["p"][0]), max_abs(res["k"][1], res["p"][1]))
        require(bool(torch.isfinite(res["k"][0]).all()), "batch chunk: non-finite values")
        require(err == 0.0, f"batch 100-sweep chunk from iteration {it0}: kernel and plain differ by {err}")
        chunk_errs.append(err)
    ku = res["k"][0]
    chunk_ms10 = event_ms(lambda: hopper_batched.update_n_batch(ku, locked, 0, 100), reps=10)
    # A solve's tail: one lane active, the others skipped (flag reads and the barrier).
    one = torch.zeros(lanes, dtype=torch.bool, device=dev)
    one[0] = True
    one_lane_ms = event_ms(lambda: hopper_batched.update_n_batch(ku, locked, 0, 100, one), reps=10)

    # The probe's solve: every lane must converge under the protocol.
    x = u0.clone()
    full_ms = event_ms(lambda: res.__setitem__("full", hopper_batched.solve_batch_device(
        x, locked, BATCH_EPS, STAGGER, BATCH_SOLVE_CAP)))
    full = res["full"]
    iters = full[1].cpu().numpy()
    require(bool(full[3].all()), f"batch solve: {int((~full[3]).sum())} lanes did not converge "
            f"within {BATCH_SOLVE_CAP} sweeps")
    require(bool((iters >= side).all() and (iters % STAGGER == 1).all()),
            f"batch solve: iterations {iters.min()}..{iters.max()} not >= {side} and 1 mod {STAGGER}")

    # The capped solve through three routes; the cap is raised until some lane retires.
    cap = max(BATCH_CAP, int(iters.min()))
    solves, route_ms = {}, {}
    for name, fn in (("device", hopper_batched.solve_batch_device),
                     ("host", hopper_batched.solve_batch), ("plain", batched.solve_batch)):
        x = u0.clone()
        route_ms[name] = event_ms(lambda: solves.__setitem__(
            name, fn(x, locked, BATCH_EPS, STAGGER, cap)))
    solve_err = max(compare_batch(solves["device"], solves["plain"], f"batch solve capped at {cap}"),
                    compare_batch(solves["host"], solves["plain"], f"batch host-driven solve capped at {cap}"))
    retired = int(solves["device"][3].sum())
    require(retired > 0, f"no lane retired before the cap of {cap}")

    # Lanes that take the resident route's other block (csrc/batched2d.cu).
    wl, ws = BATCH_WIDE
    wu_np, wl_np = batch_arrays(wl, ws, seed=3)
    wu0, wlocked = batched.batch_from_numpy(wu_np, wl_np, device=dev)
    del wu_np, wl_np
    wide = {}
    wide_ms = {"chunk": event_ms(lambda: wide.__setitem__("k", hopper_batched.update_n_batch(
        wu0.clone(), wlocked, 1, 100)))}
    wide_ms["solve"] = event_ms(lambda: wide.__setitem__("s", hopper_batched.solve_batch_device(
        wu0.clone(), wlocked, BATCH_EPS, STAGGER, BATCH_CAP)))
    wide_err = max(max_abs(wide["k"][0], batched.update_n_batch(wu0, wlocked, 1, 100)[0]),
                   compare_batch(wide["s"], batched.solve_batch(wu0, wlocked, BATCH_EPS, STAGGER,
                                                                BATCH_CAP),
                                 f"{ws}^2 lanes: solve capped at {BATCH_CAP}"))
    require(wide_err == 0.0, f"{ws}^2 lanes: kernel and plain differ by {wide_err}")
    routes = dict(hopper_batched.routes)
    require(routes["resident"] == sum(routes.values()) > 0,
            f"batch: a launch left the resident route: {routes}")
    pick = [0, lanes - 1, *np.random.default_rng(1).choice(np.arange(1, lanes - 1), 2, replace=False)]
    solo = solo_lanes(dev, u0, locked, full, pick, BATCH_SOLVE_CAP, "batch")
    cells = (side - 2) ** 2 / 2
    bounds = {"chunk": bound(locked, 0, 100, lanes=True),
              "chunk_one_lane": bound(locked[0], 0, 100),
              "capped_solve": bound(locked, 0, solves["device"][1].cpu(), lanes=True),
              "solve": bound(locked, 0, full[1].cpu(), lanes=True)}
    emit(phase="batch", lanes=lanes, shape=[side, side], obstacle_density=0.1, eps=BATCH_EPS,
         stagger=STAGGER, setup_s=setup_s, chunk_sweeps=100, chunk_max_abs_err=max(chunk_errs),
         chunk_kernel_ms=chunk_ms[0], chunk_kernel_ms_odd=chunk_ms[1],
         chunk_kernel_ms_mean10=chunk_ms10, chunk_plain_ms=chunk_plain_ms[0],
         chunk_plain_ms_odd=chunk_plain_ms[1], chunk_kernel_ms_one_lane_mean10=one_lane_ms,
         cell_updates_per_s_chunk=lanes * cells * 100 / (chunk_ms10 / 1e3),
         capped_cap=cap, capped_retired=retired, capped_max_abs_err=solve_err,
         capped_device_ms=route_ms["device"], capped_host_ms=route_ms["host"],
         capped_plain_ms=route_ms["plain"],
         solve_cap=BATCH_SOLVE_CAP, solve_kernel_ms=full_ms, solves_per_s=lanes / (full_ms / 1e3),
         mean_iterations=float(iters.mean()), max_iterations=int(iters.max()),
         min_iterations=int(iters.min()),
         cell_updates_per_s_solve=float(iters.sum()) * cells / (full_ms / 1e3),
         solo_lanes=solo, wide_lanes=[wl, ws, ws], wide_chunk_ms=wide_ms["chunk"],
         wide_capped_solve_ms=wide_ms["solve"], wide_max_abs_err=wide_err, routes=routes,
         bounds=bounds)
    return {"chunk_err": max(*chunk_errs, wide_err), "chunk_ms": chunk_ms10,
            "chunk_plain_ms": chunk_plain_ms[0], "solve_err": max(solve_err, wide_err), "solve_ms": route_ms["device"], "solve_plain_ms": route_ms["plain"],
            "chunk_bound": bounds["chunk"], "solve_bound": bounds["capped_solve"]}


def phase_batch_goals(dev) -> dict:
    from epic_tpu_torch import maps
    from epic_tpu_torch.solver import batched, core, hopper_batched

    lanes, side = BATCH
    img = maps.random_obstacles(side, side, density=0.12, seed=5)
    rng = np.random.default_rng(5)
    free_y, free_x = np.nonzero(img != 0)
    picks = rng.choice(len(free_y), size=lanes, replace=True)
    goal_xy = np.stack([free_x[picks], free_y[picks]], axis=-1)[:, None, :]
    base_u = np.full(img.shape, np.float32(-1e6))
    base_locked = img == 0

    # tools/probe.py:646-654: the device builder equals the host builder.
    gate = 64
    gu, gl = hopper_batched.make_goal_batch(base_u, base_locked, goal_xy[:gate], device=dev)
    hu, hl = batched.batch_from_goal_sets(img, [[tuple(g[0])] for g in goal_xy[:gate]], device=dev)
    require(torch.equal(gu, hu) and torch.equal(gl, hl),
            "make_goal_batch differs from batch_from_goal_sets")

    zero_counts()
    res = {}
    build_ms = event_ms(lambda: res.__setitem__("b", hopper_batched.make_goal_batch(
        base_u, base_locked, goal_xy, device=dev)))
    u0, locked = res["b"]
    u0 = u0.clone()    # kept for the solo checks
    goals_ms = event_ms(lambda: res.__setitem__("g", hopper_batched.solve_batch_goals(
        base_u, base_locked, goal_xy, None, BATCH_EPS, STAGGER, GOALS_CAP, device=dev)))
    x = u0.clone()
    host_ms = event_ms(lambda: res.__setitem__("h", hopper_batched.solve_batch(
        x, locked, BATCH_EPS, STAGGER, GOALS_CAP)))
    err = compare_batch(res["g"], res["h"], "goal batch: one-launch vs host-driven solve")
    launches = dict(hopper_batched.launches)
    routes = dict(hopper_batched.routes)
    plain = {**{f"batched.{k}": v for k, v in batched.calls.items()},
             **{f"core.{k}": v for k, v in core.calls.items()}}
    require(all(v > 0 for v in launches.values()), f"a batch kernel never ran on the main path: {launches}")
    require(routes == {r: sum(launches.values()) if r == "resident" else 0 for r in routes},
            f"goal batch: a launch left the resident route: {routes}")
    require(all(v == 0 for v in plain.values()), f"the plain version ran on the main path: {plain}")

    out = res["g"]
    iters = out[1].cpu().numpy()
    require(bool(out[3].all()), f"goal batch: {int((~out[3]).sum())} lanes did not converge "
            f"within {GOALS_CAP} sweeps")
    require(bool((iters >= side).all() and (iters % STAGGER == 1).all()),
            f"goal batch: iterations {iters.min()}..{iters.max()} not >= {side} and 1 mod {STAGGER}")
    before = core.calls["solve"]
    pick = np.random.default_rng(5).choice(lanes, 2, replace=False)
    solo = solo_lanes(dev, u0, locked, out, pick, GOALS_CAP, "goal batch")
    emit(phase="batch_goals", lanes=lanes, shape=[side, side], density=0.12, eps=BATCH_EPS,
         stagger=STAGGER, cap=GOALS_CAP, gate_lanes=gate, build_ms=build_ms,
         solve_batch_goals_ms=goals_ms, solves_per_s=lanes / (goals_ms / 1e3),
         host_driven_ms=host_ms, host_vs_device_max_abs_err=err,
         mean_iterations=float(iters.mean()), max_iterations=int(iters.max()),
         min_iterations=int(iters.min()),
         cell_updates_per_s=float(iters.sum()) * (side - 2) ** 2 / 2 / (goals_ms / 1e3),
         launches=launches, routes=routes, plain_calls=plain, solo_lanes=solo,
         solo_core_solves=core.calls["solve"] - before,
         bounds={"solve": bound(locked, 0, out[1].cpu(), lanes=True)})
    return {"launches": {f"{k}/resident": v for k, v in launches.items()}, "err": err}


def big_lanes(dev, phase: str, shape, cap: int, route: str) -> dict:
    """Lanes beyond a block's shared memory on one route ("cluster" or
    "tiled"), which the rule must pick: phases batch_big, batch_huge
    and batch_few."""
    from epic_tpu_torch.solver import batched, core, hopper_batched, tiled

    lanes, side = shape
    blocks = hopper_batched._blocks(lanes, side, side, dev)
    require(blocks[1] == route, f"{side}^2 lanes take the {blocks[1]} route, not the {route} one")
    u_np, l_np = batch_arrays(lanes, side, seed=2)
    u_np[0] = -1e6    # lane 0 goalless: it retires at its first check past `side` sweeps
    u0, locked = batched.batch_from_numpy(u_np, l_np, device=dev)
    del u_np, l_np
    zero_counts()
    res, ms = {}, {}
    for it0 in (0, 1):
        ku = u0.clone()
        ms[f"chunk{it0}"] = event_ms(lambda: res.__setitem__(
            f"k{it0}", hopper_batched.update_n_batch(ku, locked, it0, 100)))
    x = u0.clone()
    ms["device"] = event_ms(lambda: res.__setitem__("device", hopper_batched.solve_batch_device(
        x, locked, BATCH_EPS, STAGGER, cap)))
    y = u0.clone()
    ms["host"] = event_ms(lambda: res.__setitem__("host", hopper_batched.solve_batch(
        y, locked, BATCH_EPS, STAGGER, cap)))
    torch.cuda.synchronize()
    launches = dict(hopper_batched.launches)
    routes = dict(hopper_batched.routes)
    plain = {**{f"batched.{k}": v for k, v in batched.calls.items()},
             **{f"core.{k}": v for k, v in core.calls.items()},
             **{f"tiled.{k}": v for k, v in tiled.calls.items()}}
    require(all(v > 0 for v in launches.values()), f"a batch kernel never ran on the main path: {launches}")
    require(routes == {r: sum(launches.values()) if r == route else 0 for r in routes},
            f"{side}^2 lanes: a launch left the {route} route: {routes}")
    require(all(v == 0 for v in plain.values()), f"the plain version ran on the main path: {plain}")

    chunk_errs = []
    for it0 in (0, 1):
        ms[f"chunk_plain{it0}"] = event_ms(lambda: res.__setitem__(
            "p", batched.update_n_batch(u0, locked, it0, 100)))
        k, p = res[f"k{it0}"], res["p"]
        require(bool(torch.isfinite(k[0]).all()), f"{side}^2 chunk: non-finite values")
        err = max(max_abs(k[0], p[0]), max_abs(k[1], p[1]))
        require(err == 0.0, f"{side}^2 100-sweep chunk from iteration {it0}: kernel and plain differ by {err}")
        chunk_errs.append(err)
    ms["plain"] = event_ms(lambda: res.__setitem__("plain", batched.solve_batch(
        u0, locked, BATCH_EPS, STAGGER, cap)))
    solve_err = max(compare_batch(res["device"], res["plain"], f"{side}^2 solve capped at {cap}"),
                    compare_batch(res["host"], res["plain"], f"{side}^2 host-driven solve"))
    iters = res["device"][1].cpu().numpy()
    first = -(-(side - 1) // STAGGER) * STAGGER + 1    # the first check past `side` sweeps
    require(bool(res["device"][3][0]) and int(iters[0]) == first,
            f"{side}^2 lanes: the goalless lane retired at {int(iters[0])}, not {first}")
    ku = res["k0"][0]
    chunk_ms10 = event_ms(lambda: hopper_batched.update_n_batch(ku, locked, 0, 100), reps=10)
    bounds = {"chunk": bound(locked, 0, 100, lanes=True),
              "capped_solve": bound(locked, 0, res["device"][1].cpu(), lanes=True)}
    emit(phase=phase, lanes=lanes, shape=[side, side], eps=BATCH_EPS, stagger=STAGGER, cap=cap,
         route=route, blocks=blocks[0], resident_smem_bytes=hopper_batched.lane_smem_bytes(side, side),
         cluster_smem_bytes=hopper_batched.cluster_smem_bytes(side, side, blocks[0]) if blocks[0] else None,
         smem_limit=torch.cuda.get_device_properties(dev).shared_memory_per_block_optin,
         max_cluster=hopper_batched.max_cluster(dev),
         chunk_max_abs_err=max(chunk_errs), chunk_kernel_ms=ms["chunk0"],
         chunk_kernel_ms_odd=ms["chunk1"], chunk_kernel_ms_mean10=chunk_ms10,
         chunk_plain_ms=ms["chunk_plain0"], chunk_plain_ms_odd=ms["chunk_plain1"],
         capped_max_abs_err=solve_err, capped_device_ms=ms["device"], capped_host_ms=ms["host"],
         capped_plain_ms=ms["plain"], capped_retired=int(res["device"][3].sum()),
         mean_iterations=float(iters.mean()), launches=launches, routes=routes,
         plain_calls=plain, bounds=bounds)
    return {"launches": {f"{k}/{route}": v for k, v in launches.items()},
            "chunk_err": max(chunk_errs), "solve_err": solve_err,
            "chunk": (chunk_ms10, ms["chunk_plain0"], bounds["chunk"]),
            "solve": (ms["device"], ms["plain"], bounds["capped_solve"])}


def phase_batch_few(dev) -> list[dict]:
    """Few lanes on the routes the rule picks: BATCH_FEW_LANES lanes of
    BATCH_FEW_SIDE^2 on the wider clusters lane_cluster gives so few, four
    times as many on the smallest fitting cluster, and 8 lanes of 512^2 on
    clusters."""
    from epic_tpu_torch.solver import hopper_batched

    side, few = BATCH_FEW_SIDE, BATCH_FEW_LANES
    narrow = hopper_batched.lane_cluster(side, side, dev)
    wide = hopper_batched.lane_cluster(side, side, dev, few)
    require(wide > narrow == hopper_batched.lane_cluster(side, side, dev, 4 * few) > 0,
            f"{side}^2 lanes: clusters of {wide} for {few} lanes, {narrow} alone")
    return [big_lanes(dev, "batch_few", shape, BATCH_FEW_CAP, "cluster")
            for shape in ((few, side), (4 * few, side), (8, 512))]


def mesh_counts(ran: dict, what: str, drive) -> dict:
    """Run ``drive()`` with every count zeroed just before and read just
    after: each launch count in ``ran`` (the route's entries) must have
    moved; the other 2D mesh entries, the single-device 2D kernels and the
    plain versions must not. Returns the route's launches."""
    from epic_tpu_torch.parallel import hopper_resident2d, hopper_shard2d
    from epic_tpu_torch.solver import core, hopper_sweep, hopper_tile2d, tiled

    zero_counts()
    drive()
    torch.cuda.synchronize()
    launches = dict(ran)
    others = {**hopper_sweep.launches, **hopper_tile2d.launches,
              **{k: v for k, v in {**hopper_shard2d.launches,
                                   **hopper_resident2d.launches}.items() if k not in ran},
              **{f"core.{k}": v for k, v in core.calls.items()},
              **{f"tiled.{k}": v for k, v in tiled.calls.items()},
              **{f"hopper_shard2d.{k}": v for k, v in hopper_shard2d.calls.items()},
              **{f"hopper_resident2d.{k}": v for k, v in hopper_resident2d.calls.items()}}
    require(all(v > 0 for v in launches.values()), f"{what}: an entry never ran: {launches}")
    require(all(v == 0 for v in others.values()),
            f"{what}: another entry, a plain version or a single-device kernel ran: {others}")
    return launches


def counted_mesh(what: str, drive) -> dict:
    """:func:`mesh_counts` for the per-shard route: the shard entry
    (K14/K15) must run."""
    from epic_tpu_torch.parallel import hopper_shard2d

    return mesh_counts(hopper_shard2d.launches, what, drive)


def counted_resident(what: str, drive) -> dict:
    """:func:`mesh_counts` for the resident route: both of its entries
    (K16/K17) must run."""
    from epic_tpu_torch.parallel import hopper_resident2d

    return mesh_counts(hopper_resident2d.launches, what, drive)


def same_field(a, b, what: str) -> float:
    """Two GridStates: the same bits in u and delta, equal iterations."""
    err = max(max_abs(a.u, b.u), max_abs(a.delta, b.delta))
    require(int(a.iteration) == int(b.iteration),
            f"{what}: iteration {int(a.iteration)} != {int(b.iteration)}")
    require(bool(torch.isfinite(a.u).all()), f"{what}: non-finite values in u")
    require(err == 0.0, f"{what}: differ by {err}")
    return err


def mesh_session(dev, maze, kernel: str) -> dict:
    """Phase 4's session on a MeshPlanner over a 2 x 4 virtual mesh on the
    route ``kernel`` names ("pallas": the shard entry; "resident": the
    resident entries), counted, then a single-device Planner replaying the
    same verbs at the same ticks (its solve timed: K2)."""
    from epic_tpu_torch import grid as G
    from epic_tpu_torch import path
    from epic_tpu_torch.config import EpicConfig
    from epic_tpu_torch.parallel import make_mesh
    from epic_tpu_torch.planner_mesh import MeshPlanner
    from epic_tpu_torch.services.navigation_node import EpicNavigationNodeRviz
    from epic_tpu_torch.services.server import EpicClient, EpicServiceServer, ingest_map

    cfg = EpicConfig.load_yaml(ROOT / "configs" / "maze.yaml")
    steps = cfg.service.steps_per_update
    img = maze["img"]
    mesh = make_mesh(MESH, devices=[dev] * (MESH[0] * MESH[1]))
    planner = MeshPlanner(cfg, mesh=mesh, kernel=kernel)
    node = EpicNavigationNodeRviz(cfg, update_rate=cfg.service.update_rate_hz, planner=planner)
    ingest_map(node, img)
    require(planner.device == dev, f"the mesh planner lives on {planner.device}")
    server = EpicServiceServer(node, "127.0.0.1", 0)
    client = EpicClient(port=server.port, timeout=60.0)
    s = LoopbackSession(server, client)
    edits, out = [], {}     # (ticks before, xy, types) of each edit

    def drive():
        r, at = s.call("info")
        require(r["success"] and r["shape"] == list(img.shape) and r["iteration"] == steps * at,
                f"info: {r} after {at} ticks")
        t0 = time.perf_counter()
        s.spin(10)
        torch.cuda.synchronize()
        out["ten_ticks_s"] = time.perf_counter() - t0
        r, at = s.call("info")
        require(r["iteration"] == steps * at, f"info iteration {r['iteration']} after {at} ticks")
        ys, xs = np.nonzero((img != 0) & (img != 255))
        ex, ey = int(xs[len(xs) // 2]), int(ys[len(ys) // 2])
        r, at = s.call("set_cells", v=[ex, ey], types=[1])
        require(r["success"], f"set_cells: {r}")
        edits.append((at, [(ex, ey)], [1]))
        r, _ = s.call("get_cell", x=ex, y=ey)
        require(r["success"] and r["value"] == -1e6, f"get_cell on the new obstacle: {r}")
        s.spin(10)
        r, at = s.call("set_cells", v=[ex, ey], types=[2])
        require(r["success"], f"set_cells: {r}")
        edits.append((at, [(ex, ey)], [2]))
        out["solve_at"] = s.ticks
        t0 = time.perf_counter()
        planner.solve(max_iterations=cfg.solver.max_iterations)
        torch.cuda.synchronize()
        out["solve_s"] = time.perf_counter() - t0
        out["solved"] = planner.state
        require(bool(out["solved"].converged), "mesh session solve did not converge")
        gy, gx = np.argwhere(img == 255)[0]
        r, _ = s.call("get_cell", x=int(gx), y=int(gy))
        require(r["success"] and r["value"] == 0.0, f"get_cell on a goal: {r}")
        r, _ = s.call("get_cell", x=ex, y=ey)
        require(r["success"] and -1e6 < r["value"] < 0.0, f"get_cell on the freed cell: {r}")
        out["lengths"], out["path_s"] = [], []
        for x, y in golden_goal_starts(maze):
            t0 = time.perf_counter()
            r, _ = s.call("compute_path", x=x, y=y, step_size=0.2, precision=0.4)
            out["path_s"].append(time.perf_counter() - t0)
            require(r["success"], f"compute_path from ({x}, {y}): {r}")
            pts = np.asarray(r["path"], dtype=np.float32)[:, :2]
            st = planner.state
            require(path.path_reaches_goal(G.host_u(st), G.host_locked(st), pts),
                    f"mesh path from ({x}, {y}) ends at {pts[-1].tolist()}, not in a goal")
            out["lengths"].append(len(pts))
        r, _ = s.call("info")
        require(r["success"] and r["iteration"] >= int(out["solved"].iteration), f"info: {r}")

    counted = counted_mesh if kernel == "pallas" else counted_resident
    try:
        launches = counted(f"mesh session ({kernel})", drive)
    finally:
        client.close()
        server.close()
    final = planner.state

    # The same verbs at the same ticks on one device (K1/K2).
    ref = EpicNavigationNodeRviz(cfg, update_rate=cfg.service.update_rate_hz, device=dev)
    ingest_map(ref, img)
    done = 0
    for at, xy, types in edits:
        for _ in range(at - done):
            ref.update()
        done = at
        ref.planner.set_cells(xy, types)
    for _ in range(out["solve_at"] - done):
        ref.update()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref.planner.solve(max_iterations=cfg.solver.max_iterations)
    torch.cuda.synchronize()
    k2_solve_s = time.perf_counter() - t0
    err = same_field(out["solved"], ref.planner.state, "mesh session solve vs the Planner")
    for _ in range(s.ticks - out["solve_at"]):
        ref.update()
    err = max(err, same_field(final, ref.planner.state, "mesh session's final field vs the Planner"))
    iters = int(out["solved"].iteration)
    return dict(kernel=kernel, shard=[planner._sh.h_loc, planner._sh.w_loc], ticks=s.ticks,
                sweeps_per_tick=steps, ten_ticks_s=out["ten_ticks_s"], solve_iterations=iters,
                solve_s=out["solve_s"], k2_solve_s=k2_solve_s, paths=len(out["lengths"]),
                path_points=out["lengths"], compute_path_s=out["path_s"],
                max_abs_err_vs_planner=err, launches=launches,
                bounds={"solve": bound(out["solved"].locked, 0, iters)}, planner=planner)


def phase_mesh_session(dev, maze) -> dict:
    """Phase 18: the maze session on the per-shard route (K14/K15)."""
    out = mesh_session(dev, maze, "pallas")
    emit(phase="mesh_session", config="configs/maze.yaml", mesh=list(MESH),
         **{k: v for k, v in out.items() if k != "planner"})
    del out["planner"]
    return {**out, "err": out["max_abs_err_vs_planner"]}


def shard_bound(frozen_view: torch.Tensor, par0: int, t0: int, sweeps: int, k: int,
                u1: bool = False) -> dict:
    """The least time for one shard's chunk: its bytes (the extended block's
    u and frozen bytes read, the centre written, twice with u1) over the HBM
    rate, or its updates (the centre's unfrozen cells of each sweep's class)
    over the float32 rate, whichever is larger."""
    return work_bound(*shard_work(frozen_view, par0, t0, sweeps, k, u1))


def work_bound(n_bytes: float, n_updates: int) -> dict:
    """The larger of ``n_bytes`` over the HBM rate and ``n_updates`` lse4
    updates over the float32 rate."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_updates * OPS_LSE4 / PEAK_FP32_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                updates=n_updates, lse6=False)


def shard_work(frozen_view: torch.Tensor, par0: int, t0: int, sweeps: int, k: int,
               u1: bool = False) -> tuple[float, int]:
    """:func:`shard_bound`'s bytes and updates."""
    he, we = frozen_view.shape
    centre = frozen_view[k:he - k, k:we - k]
    h, w = centre.shape
    r = torch.arange(h, device=centre.device)
    c = torch.arange(w, device=centre.device)
    odd = ((par0 + r[:, None] + c[None, :]) % 2).bool()
    free = ~centre
    n_even, n_odd = int((free & ~odd).sum()), int((free & odd).sum())
    at_even_t = (sweeps + 1 - t0 % 2) // 2
    n_updates = at_even_t * n_odd + (sweeps - at_even_t) * n_even
    return float(he * we * 5 + h * w * 4 * (2 if u1 else 1)), n_updates


def plan_bound(sh, k: int, t0: int, per_chunk, u1: bool = True) -> dict:
    """The least time for chunks of ``per_chunk`` sweeps from ``t0`` on every
    shard of the mesh grid ``sh`` (u1 in chunk 0): the sum of each shard's
    chunks' bytes and updates (:func:`shard_work`)."""
    H, n_bytes, n_updates, t = sh.halo, 0.0, 0, t0
    for c, ns in enumerate(per_chunk):
        for ij in sh.mesh.local:
            view = sh.frozen_blocks[ij][H - k:H + sh.h_loc + k, H - k:H + sh.w_loc + k]
            b, n = shard_work(view, sh.par0(ij), t, ns, k, u1 and c == 0)
            n_bytes, n_updates = n_bytes + b, n_updates + n
        t += ns
    return work_bound(n_bytes, n_updates)


def phase_mesh16k(dev) -> dict:
    import epic_tpu_torch as T  # noqa: F401
    from epic_tpu_torch import maps, solver
    from epic_tpu_torch.config import EpicConfig
    from epic_tpu_torch.parallel import hopper_shard2d, make_mesh, sharded
    from epic_tpu_torch.planner_mesh import MeshPlanner

    side = MESH_SIDE
    cfg = EpicConfig.load_yaml(ROOT / "configs" / "maze.yaml")
    k_tile = cfg.solver.tile_depth
    t0 = time.perf_counter()
    img = maps.random_obstacles(side, side, seed=0)
    occ = np.where(img == 0, 100, 0).astype(np.int8)
    gy, gx = (int(v) for v in np.argwhere(img == 255)[0])
    map_s = time.perf_counter() - t0
    del img
    t0 = time.perf_counter()
    mesh = make_mesh(MESH, devices=[dev] * (MESH[0] * MESH[1]))
    planner = MeshPlanner(cfg, mesh=mesh, kernel="pallas")
    planner.init(side, side)
    planner.update_occupancy(occ)
    require(planner.add_goals([(float(gx), float(gy))]), "the goal was refused")
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    del occ
    base = planner.state              # gathered: fresh tensors on the card
    require(solver.hopper_tile2d.use_tiles((side, side), dev), f"{side}^2 is not routed to the tiles")
    starts = {t: at_iteration(base, t) for t in (0, 1)}

    # The single-device references (the tile route), before the counted window.
    ref, times = {}, {}
    for t in (0, 1):
        ref[t, 50] = solver.update_grid(copy_state(starts[t]), 50, k_tile)
        ref[t, 150] = solver.update_grid(copy_state(ref[t, 50]), 100, k_tile)
    times["tile_solve"] = event_ms(lambda: ref.__setitem__(
        "solve", solver.solve_grid(copy_state(base), STAGGER, MESH_CAP, chunk_depth=k_tile)))
    tile_state = copy_state(starts[0])
    times["tile_tick5"] = event_ms(lambda: solver.update_grid(tile_state, 100, k_tile), reps=5)
    del tile_state

    got, exchange = {}, []
    exchange_copies = sharded._exchange

    def timed_exchange(sh, blocks, k):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        exchange_copies(sh, blocks, k)
        b.record()
        exchange.append((a, b))

    def drive():
        for t in (0, 1):
            planner.state = starts[t]
            planner.update(50)
            got[t, 50] = planner.state
            planner.update(100)
            got[t, 150] = planner.state
        planner.state = base
        times["mesh_solve"] = event_ms(lambda: planner.solve(max_iterations=MESH_CAP))
        got["solve"] = planner.state
        planner.state = starts[0]
        planner.update(100)      # warm: the frozen halos exchanged once
        sharded._exchange = timed_exchange
        try:
            times["mesh_tick5"] = event_ms(lambda: planner.update(100), reps=5)
        finally:
            sharded._exchange = exchange_copies

    launches = counted_mesh(f"{side}^2 mesh", drive)
    exchange_ms = sum(a.elapsed_time(b) for a, b in exchange) / 5
    errs = [same_field(got[key], ref[key], f"{side}^2 mesh tick to iteration {sum(key)}")
            for key in sorted(k for k in ref if k != "solve")]
    errs.append(same_field(got["solve"], ref["solve"], f"{side}^2 mesh solve capped at {MESH_CAP}"))
    require(bool(got["solve"].converged) == bool(ref["solve"].converged), "solve verdicts differ")

    # The entry alone on shard (0, 1)'s extended block, after an exchange.
    sh = planner._sh
    k = H = sh.halo          # the main path's exchange depth
    sharded._exchange(sh, sh.u_blocks, k)
    ij = (0, 1)
    view = (slice(H - k, H + sh.h_loc + k), slice(H - k, H + sh.w_loc + k))
    src, frozen = sh.u_blocks[ij][view], sh.frozen_blocks[ij][view]
    dst_b, u1_b = torch.empty_like(sh.u_blocks[ij]), torch.empty_like(sh.u_blocks[ij])
    dst, u1 = dst_b[view], u1_b[view]
    par0, it0 = sh.par0(ij), int(sh.iteration)
    centre = (slice(k, k + sh.h_loc), slice(k, k + sh.w_loc))
    entry_errs = []
    for ns, with_u1 in ((k, False), (k, True), (5, True)):
        d = hopper_shard2d.chunk(src, dst, frozen, k=k, par0=par0, iteration=it0, ns=ns,
                                 u1=u1 if with_u1 else None, want_delta=True)
        p_u, p_d, p_u1 = hopper_shard2d.sweep_k_local(src, frozen, par0, it0, ns, u1=True)
        e = max(max_abs(dst[centre], p_u[centre]), max_abs(d, p_d))
        if with_u1:
            e = max(e, max_abs(u1[centre], p_u1[centre]))
        require(e == 0.0, f"the shard entry ({ns} sweeps, u1={with_u1}) differs from plain by {e}")
        entry_errs.append(e)
    entry_ms = event_ms(lambda: hopper_shard2d.chunk(src, dst, frozen, k=k, par0=par0,
                                                     iteration=it0, ns=k, want_delta=True), reps=10)
    plain_ms = event_ms(lambda: hopper_shard2d.sweep_k_local(src, frozen, par0, it0, k))
    entry_bound = shard_bound(frozen, par0, it0, k, k)
    locked = base.locked
    emit(phase="mesh16k", shape=[side, side], mesh=list(MESH), shard=[sh.h_loc, sh.w_loc],
         chunk_depth=k, map_s=map_s, ingest_s=ingest_s, launches=launches,
         max_abs_err=max(errs), mesh_tick_ms_mean5=times["mesh_tick5"],
         tile_tick_ms_mean5=times["tile_tick5"], exchange_ms_per_tick=exchange_ms,
         exchange_share=exchange_ms / times["mesh_tick5"],
         mesh_solve_ms=times["mesh_solve"], tile_solve_ms=times["tile_solve"],
         solve_cap=MESH_CAP, solve_iterations=int(got["solve"].iteration),
         entry_sweeps=k, entry_ms_mean10=entry_ms, entry_plain_ms=plain_ms,
         entry_max_abs_err=max(entry_errs),
         cell_updates_per_s_mesh=(side - 2) ** 2 / 2 * 100 / (times["mesh_tick5"] / 1e3),
         bounds={"tick": bound(locked, 0, 100), "solve": bound(locked, 0, MESH_CAP),
                 "entry": entry_bound},
         peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    return {"launches": launches, "err": max(errs + entry_errs),
            "entry": (entry_ms, plain_ms, entry_bound), "base": base, "starts": starts,
            "ref": ref, "got": got, "times": times}

def copy_grid(sh):
    """A copy of a mesh grid with its own u, twin, u1 and frozen blocks."""
    c = copy.copy(sh)
    for name in ("u_blocks", "twin_blocks", "u1_blocks", "frozen_blocks"):
        setattr(c, name, {ij: b.clone() for ij, b in getattr(sh, name).items()})
    return c


def same_blocks(a, b, what: str) -> float:
    """Two mesh grids: the same bits in every u, twin and u1 block."""
    err = max(max_abs(getattr(a, n)[ij], getattr(b, n)[ij])
              for n in ("u_blocks", "twin_blocks", "u1_blocks") for ij in a.mesh.local)
    require(err == 0.0, f"{what}: differ by {err}")
    return err


def phase_mesh_resident(dev, maze, mesh_s, m16) -> dict:
    """Phase 23: the resident route (K16/K17's two entries) on phase 18's
    maze mesh and phase 19's 16384^2 mesh, counted, held to the
    single-device routes and to the per-shard route (K14/K15) bit for bit;
    each entry alone against its plain version."""
    from epic_tpu_torch.config import EpicConfig
    from epic_tpu_torch.parallel import hopper_resident2d, make_mesh, sharded
    from epic_tpu_torch.planner_mesh import MeshPlanner

    cfg = EpicConfig.load_yaml(ROOT / "configs" / "maze.yaml")
    mesh = make_mesh(MESH, devices=[dev] * (MESH[0] * MESH[1]))

    def route(sh) -> str:
        return "resident" if sharded.prefers_resident(mesh, sh.h_loc, sh.w_loc) else "pallas"

    # The maze session of phase 18 on the resident route.
    maze_run = mesh_session(dev, maze, "resident")
    maze_sh = maze_run.pop("planner")._sh

    # The solve entry alone: the maze mesh from its reset field, capped at
    # SOLVE_ENTRY_CAP, against the plain version on a copy.
    sharded.reset_free_cells_resident(maze_sh)
    locked = sharded.unshard(maze_sh).locked
    k = sharded._prepare(maze_sh, sharded.DEFAULT_CHUNK_DEPTH)
    plan = hopper_resident2d.plans(mesh)[0]
    plain_sh = copy_grid(maze_sh)

    def scalars():
        return (torch.zeros((), dtype=torch.int32, device=dev),
                (maze_sh.epsilon + 1.0).to(torch.float32),
                torch.zeros((), dtype=torch.int32, device=dev))

    kern, plain = scalars(), scalars()
    solve_ms = event_ms(lambda: hopper_resident2d.solve(maze_sh, plan, k, STAGGER,
                                                         SOLVE_ENTRY_CAP, *kern))
    t0 = time.perf_counter()
    hopper_resident2d.plain_solve(plain_sh, plan, k, STAGGER, SOLVE_ENTRY_CAP, *plain)
    torch.cuda.synchronize()
    solve_plain_ms = (time.perf_counter() - t0) * 1e3
    solve_err = same_blocks(maze_sh, plain_sh, "the solve entry vs plain")
    require([float(x) for x in kern] == [float(x) for x in plain],
            f"the solve entry's scalars {kern} differ from plain's {plain}")
    solve_bound = bound(locked, 0, int(kern[0]))
    del plain_sh

    # Phase 19's grid on the resident route.
    side = MESH_SIDE
    base, starts, ref, got19 = m16["base"], m16["starts"], m16["ref"], m16["got"]
    planner = MeshPlanner(cfg, mesh=mesh, kernel="resident")
    got, times = {}, {}

    def drive():
        for t in (0, 1):
            planner.state = starts[t]
            planner.update(50)
            got[t, 50] = planner.state
            planner.update(100)
            got[t, 150] = planner.state
        planner.state = base
        times["solve"] = event_ms(lambda: planner.solve(max_iterations=MESH_CAP))
        got["solve"] = planner.state
        planner.state = base
        times["segments"] = event_ms(lambda: planner.solve(max_iterations=MESH_CAP,
                                                            segment_iterations=MESH_SEGMENT))
        got["segments"] = planner.state
        planner.state = starts[0]
        planner.update(100)
        times["tick5"] = event_ms(lambda: planner.update(100), reps=5)

    launches16 = counted_resident(f"{side}^2 resident mesh", drive)
    errs = []
    for key in sorted(key for key in ref if key != "solve"):
        errs.append(same_field(got[key], ref[key], f"{side}^2 resident tick to {sum(key)} vs tiles"))
        errs.append(same_field(got[key], got19[key], f"{side}^2 resident tick to {sum(key)} vs K14"))
    for key in ("solve", "segments"):
        for other, name in ((ref["solve"], "tiles"), (got19["solve"], "K14")):
            errs.append(same_field(got[key], other, f"{side}^2 resident {key} vs {name}"))
            require(bool(got[key].converged) == bool(other.converged), f"{key} verdicts differ")
    del got

    # The cycle entry alone: three chunks with u1 on every shard, against
    # the plain version on a copy.
    sh = planner._sh
    k16 = sh.halo
    sh.u1_blocks = sharded._blank(mesh, sh.u_blocks[0, 0].shape, sharded.FILL, torch.float32)
    plan16 = hopper_resident2d.plans(mesh)[0]
    it0 = int(sh.iteration)
    plain_sh = copy_grid(sh)
    d = hopper_resident2d.cycle(sh, plan16, k16, it0, 3 * k16, 3, u1=True)
    t0 = time.perf_counter()
    p = hopper_resident2d.plain_cycle(plain_sh, plan16, k16, it0, 3 * k16, 3, u1=True)
    torch.cuda.synchronize()
    cycle_plain_ms = (time.perf_counter() - t0) * 1e3
    cycle_err = max(same_blocks(sh, plain_sh, "the cycle entry vs plain"), max_abs(d, p))
    require(cycle_err == 0.0, f"the cycle entry's deltas {d.tolist()} differ from {p.tolist()}")
    del plain_sh
    cycle_ms = event_ms(lambda: hopper_resident2d.cycle(sh, plan16, k16, it0, 3 * k16, 3, u1=True),
                        reps=10)
    cycle_bound = plan_bound(sh, k16, it0, [k16] * 3)

    t19 = m16["times"]
    emit(phase="mesh_resident", mesh=list(MESH),
         maze={**{key: v for key, v in maze_run.items() if key != "kernel"},
               "k14_solve_s": mesh_s["solve_s"], "k14_ten_ticks_s": mesh_s["ten_ticks_s"],
               "auto_route": route(maze_sh)},
         grid16k=dict(shape=[side, side], shard=[sh.h_loc, sh.w_loc], chunk_depth=k16,
                      launches=launches16, max_abs_err=max(errs),
                      resident_tick_ms_mean5=times["tick5"], k14_tick_ms_mean5=t19["mesh_tick5"],
                      tile_tick_ms_mean5=t19["tile_tick5"], resident_solve_ms=times["solve"],
                      resident_segments_ms=times["segments"], segment_iterations=MESH_SEGMENT,
                      k14_solve_ms=t19["mesh_solve"], tile_solve_ms=t19["tile_solve"],
                      solve_cap=MESH_CAP, auto_route=route(sh)),
         cycle_entry=dict(shards=len(plan16.slots), chunks=3, sweeps=3 * k16, u1=True,
                          ms_mean10=cycle_ms, plain_ms=cycle_plain_ms, max_abs_err=cycle_err,
                          bound=cycle_bound),
         solve_entry=dict(shape=list(locked.shape), cap=SOLVE_ENTRY_CAP,
                          iterations=int(kern[0]), ms=solve_ms, plain_ms=solve_plain_ms,
                          max_abs_err=solve_err, bound=solve_bound),
         peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    launches = dict(maze_run["launches"])
    add_counts(launches, launches16)
    return {"launches": launches,
            "err": max(maze_run["max_abs_err_vs_planner"], max(errs), cycle_err, solve_err),
            "cycle": (cycle_ms, cycle_plain_ms, cycle_bound),
            "solve": (solve_ms, solve_plain_ms, solve_bound)}


def counted_mesh3d(what: str, drive, route: str) -> dict:
    """Run ``drive()`` with every count zeroed just before and read just
    after: the entries of ``route`` must have run (the device route's
    epic_resident3d_cycle and epic_resident3d_solve, or the per-shard
    route's epic_shard3d_chunk); the other route's, the plain versions, K7
    and the 3D tiles must not. Returns the route's launches."""
    from epic_tpu_torch.parallel import hopper_resident3d, hopper_shard3d
    from epic_tpu_torch.solver import core, hopper_sweep3d, hopper_tile3d, tiled3d

    zero_counts()
    drive()
    torch.cuda.synchronize()
    ran, other = ((hopper_resident3d.launches, hopper_shard3d.launches) if route == "device"
                  else (hopper_shard3d.launches, hopper_resident3d.launches))
    launches = dict(ran)
    others = {**other, **hopper_sweep3d.launches, **hopper_tile3d.launches,
              **{f"core.{k}": v for k, v in core.calls.items()},
              **{f"tiled3d.{k}": v for k, v in tiled3d.calls.items()},
              **{f"hopper_shard3d.{k}": v for k, v in hopper_shard3d.calls.items()},
              **{f"hopper_resident3d.{k}": v for k, v in hopper_resident3d.calls.items()}}
    require(all(v > 0 for v in launches.values()),
            f"{what}: an entry of the {route} route never ran: {launches}")
    require(all(v == 0 for v in others.values()),
            f"{what}: another route's entry, a plain version or a single-device 3D kernel ran: "
            f"{others}")
    return launches


def same_volume(a, b, what: str) -> float:
    """Two volume states: the same bits in u and delta, equal iterations and
    verdicts."""
    err = same_field(a, b, what)
    require(bool(a.converged) == bool(b.converged), f"{what}: verdicts differ")
    return err


def volume_refs(dev, base, starts, ticks, cap):
    """The VolumePlanner's (K7's) results on the whole volume: ``ticks``
    sweeps chained from each start, and a solve capped at ``cap``."""
    import epic_tpu_torch as T
    from epic_tpu_torch import solver

    planner = T.VolumePlanner(T.VolumePlannerConfig(epsilon=EPS, stagger=STAGGER), device=dev)
    ref = {}
    for t, st in starts.items():
        planner.state = copy_state(st)
        done = 0
        for n in ticks:
            planner.update(n)
            done += n
            ref[t, done] = copy_state(planner.state)
    planner.state = copy_state(base)
    ref["solve_ms"] = event_ms(lambda: planner.solve(max_iterations=cap))
    ref["solve"] = planner.state
    k7 = copy_state(starts[0])
    ref["tick_ms5"] = event_ms(lambda: solver.update_volume(k7, 100), reps=5)
    return ref


def mesh_planner(dev, mesh, kernel: str = "auto"):
    from epic_tpu_torch.planner_mesh import MeshVolumePlanner, VolumePlannerConfig

    planner = MeshVolumePlanner(VolumePlannerConfig(epsilon=EPS, stagger=STAGGER), mesh=mesh,
                                kernel=kernel)
    require(planner.device == dev, f"the mesh volume planner lives on {planner.device}")
    return planner


def mesh_volume_session(dev, mesh, base, starts, ticks, cap, kernel="auto", segments=None):
    """A MeshVolumePlanner on ``mesh``: ``ticks`` chained from each start,
    then a solve capped at ``cap`` from ``base``; the gathered states."""
    planner = mesh_planner(dev, mesh, kernel)
    got = {"planner": planner}
    for t, st in starts.items():
        planner.state = st
        done = 0
        for n in ticks:
            planner.update(n)
            done += n
            got[t, done] = planner.state
    planner.state = base
    got["solve_ms"] = event_ms(lambda: planner.solve(max_iterations=cap,
                                                     segment_iterations=segments))
    got["solve"] = planner.state
    return got


def mesh_tick_ms(planner, start, exchange: list | None = None) -> float:
    """The mesh planner's 100-sweep tick, mean of 5 (after a warm tick that
    exchanges the frozen halos); with ``exchange``, CUDA events around each
    halo exchange are appended to it."""
    from epic_tpu_torch.parallel import sharded3d

    planner.state = start
    planner.update(100)
    if exchange is None:
        return event_ms(lambda: planner.update(100), reps=5)
    copies = sharded3d._exchange

    def timed(sv, blocks, k):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        copies(sv, blocks, k)
        b.record()
        exchange.append((a, b))

    sharded3d._exchange = timed
    try:
        return event_ms(lambda: planner.update(100), reps=5)
    finally:
        sharded3d._exchange = copies


def compare_session(got, ref, keys, what: str) -> list:
    errs = [same_volume(got[key], ref[key], f"{what} tick to iteration {sum(key)}")
            for key in keys]
    errs.append(same_volume(got["solve"], ref["solve"], f"{what} solve"))
    return errs


def copy_volume(sv):
    """A ShardedVolume sharing ``sv``'s frozen blocks, with copies of its u
    (and u1) blocks."""
    out = copy.copy(sv)
    out.u_blocks = {idx: b.clone() for idx, b in sv.u_blocks.items()}
    if sv.u1_blocks is not None:
        out.u1_blocks = {idx: b.clone() for idx, b in sv.u1_blocks.items()}
    return out


def same_volumes(a, b, what: str) -> float:
    """Two ShardedVolumes: the same bits in every u block, and in the u1
    blocks' centres."""
    err = 0.0
    for idx in a.u_blocks:
        err = max(err, max_abs(a.u_blocks[idx], b.u_blocks[idx]))
        if a.u1_blocks is not None:
            c = a.view(0)
            err = max(err, max_abs(a.u1_blocks[idx][c], b.u1_blocks[idx][c]))
    require(err == 0.0, f"{what}: kernel and plain blocks differ by {err}")
    return err


def device_alone(dev, base, mesh, lt, what: str) -> dict:
    """The device entries alone on every shard of ``mesh`` holding ``base``,
    against their plain versions on copies of the same blocks: a 13-sweep
    cycle with u1 and a 5-sweep one from an odd iteration, and a solve
    capped at MESH3D_ALONE_CAP in two segments; the same bits. Then a
    100-sweep cycle and the capped solve timed beside the plain versions,
    with their bounds."""
    from epic_tpu_torch.parallel import hopper_resident3d, sharded3d

    sv = sharded3d.shard_state3d(base, mesh)
    sv.u1_blocks = sharded3d._blank(mesh, sv.block_shape(sv.halo), -7.0, torch.float32)
    (plan,) = hopper_resident3d.plans(mesh)
    errs = []
    for t0, ns, u1 in ((0, 13, True), (1, 5, False)):
        k, p = copy_volume(sv), copy_volume(sv)
        dk = hopper_resident3d.cycle(k, plan, t0, ns, u1=u1)
        dp = hopper_resident3d.plain_cycle3d(p, plan, t0, ns, u1=u1)
        torch.cuda.synchronize()
        errs.append(max(same_volumes(k, p, f"{what} cycle ({ns} sweeps)"), max_abs(dk, dp)))
    seg = MESH3D_ALONE_CAP // 2

    def solved(fn, bounds):
        out = copy_volume(sv)
        it = torch.zeros((), dtype=torch.int32, device=dev)
        delta = (sv.epsilon + 1.0).to(device=dev, dtype=torch.float32)
        done = torch.zeros((), dtype=torch.int32, device=dev)
        for bound in bounds:
            fn(out, plan, STAGGER, bound, it, delta, done)
        return out, int(it), float(delta), int(done)

    (a, *ka), (b, *kb) = (solved(hopper_resident3d.solve, (seg, MESH3D_ALONE_CAP)),
                          solved(hopper_resident3d.plain_solve3d, (seg, MESH3D_ALONE_CAP)))
    require(ka == kb, f"{what}: the solve entry's (iteration, delta, done) {ka} != plain {kb}")
    errs.append(same_volumes(a, b, f"{what} solve capped at {MESH3D_ALONE_CAP}"))
    work = copy_volume(sv)
    cycle_ms = event_ms(lambda: hopper_resident3d.cycle(work, plan, 0, 100), reps=5)
    cycle_plain = event_ms(lambda: hopper_resident3d.plain_cycle3d(work, plan, 0, 100))
    solve_ms = event_ms(lambda: solved(hopper_resident3d.solve, (MESH3D_ALONE_CAP,)))
    solve_plain = event_ms(lambda: solved(hopper_resident3d.plain_solve3d, (MESH3D_ALONE_CAP,)))
    iters = ka[0]
    return {"errs": errs, "cycle": (cycle_ms, cycle_plain, bound(lt, 0, 100, lse6=True)),
            "solve": (solve_ms, solve_plain, bound(lt, 0, iters, lse6=True)),
            "solve_iterations": iters}


def phase_mesh3d(dev) -> dict:
    """Phase 9's 256^3 volume on a 2 x 4 plane mesh of the card, on both
    routes, and the device entries alone."""
    from epic_tpu_torch.parallel import make_mesh

    u, locked = volume_arrays(SIZE3D)
    base = volume_state(dev, u, locked)
    starts = {t: volume_state(dev, u, locked, t) for t in (0, 1)}
    lt = torch.from_numpy(locked)
    del u, locked
    ref = volume_refs(dev, base, starts, (50, 100), 1_000_000)
    require(bool(ref["solve"].converged), "256^3 VolumePlanner solve did not converge")
    mesh = make_mesh(MESH, devices=[dev] * (MESH[0] * MESH[1]))
    out = {}

    def drive_device():
        out["auto"] = mesh_volume_session(dev, mesh, base, starts, (50, 100), 1_000_000)
        out["resident"] = mesh_volume_session(dev, mesh, base, {1: starts[1]}, (50, 100),
                                              1_000_000, "resident", MESH3D_SEGMENT)
        out["tick_ms5"] = mesh_tick_ms(out["auto"]["planner"], starts[0])

    def drive_shard():
        out["pallas"] = mesh_volume_session(dev, mesh, base, starts, (50, 100), 1_000_000,
                                            "pallas")
        out["pallas_tick_ms5"] = mesh_tick_ms(out["pallas"]["planner"], starts[0])

    launches = counted_mesh3d("256^3 plane mesh, device route", drive_device, "device")
    launches.update(counted_mesh3d("256^3 plane mesh, per-shard route", drive_shard, "shard"))
    keys = [(t, n) for t in (0, 1) for n in (50, 150)]
    errs = compare_session(out["auto"], ref, keys, "256^3 2x4 mesh (auto)")
    errs += compare_session(out["resident"], ref, [(1, 50), (1, 150)], "256^3 2x4 resident mesh")
    errs += compare_session(out["pallas"], ref, keys, "256^3 2x4 mesh (pallas)")
    alone = device_alone(dev, base, mesh, lt, "256^3 2x4 device entries")
    sv = out["pallas"]["planner"]._sv
    iters = int(ref["solve"].iteration)
    emit(phase="mesh3d", shape=list(SIZE3D), mesh=list(MESH), shard=list(sv.loc),
         chunk_depth=sv.halo, launches=launches, max_abs_err=max(errs),
         solve_iterations=iters, device_solve_ms=out["auto"]["solve_ms"],
         device_segments_solve_ms=out["resident"]["solve_ms"],
         segment_iterations=MESH3D_SEGMENT, pershard_solve_ms=out["pallas"]["solve_ms"],
         sweep3d_solve_ms=ref["solve_ms"], device_tick_ms_mean5=out["tick_ms5"],
         pershard_tick_ms_mean5=out["pallas_tick_ms5"], sweep3d_tick_ms_mean5=ref["tick_ms5"],
         device_alone_max_abs_err=max(alone["errs"]),
         device_cycle100_ms_mean5=alone["cycle"][0], device_cycle100_plain_ms=alone["cycle"][1],
         device_solve_capped_ms=alone["solve"][0], device_solve_capped_plain_ms=alone["solve"][1],
         device_solve_cap=MESH3D_ALONE_CAP,
         bounds={"tick": bound(lt, 0, 100, lse6=True), "solve": bound(lt, 0, iters, lse6=True),
                 "solve_capped": alone["solve"][2]})
    return {"launches": launches, "err": max(errs + alone["errs"]), "ref": ref, "base": base,
            "starts": starts, "plane_tick_ms5": out["tick_ms5"],
            "plane_pallas_tick_ms5": out["pallas_tick_ms5"], "cycle": alone["cycle"],
            "solve": alone["solve"]}


def phase_mesh3d_z(dev, m3) -> dict:
    """The same volume on an 8 x 1 x 1 z mesh, "auto" and "resident" (the
    device route) and "pallas" (the per-shard route), held to phase 20's
    VolumePlanner results; the orientation choose_mesh3d picks, and both
    orientations' tick times on both routes."""
    from epic_tpu_torch.parallel import choose_mesh3d, make_mesh, make_mesh3d

    n = MESH[0] * MESH[1]
    ref, base, starts = m3["ref"], m3["base"], m3["starts"]
    zmesh = make_mesh3d((n, 1, 1), devices=[dev] * n)
    out = {}

    def drive_device():
        for kernel in ("auto", "resident"):
            out[kernel] = mesh_volume_session(dev, zmesh, base, starts, (50, 100), 1_000_000,
                                              kernel)

    def drive_shard():
        out["pallas"] = mesh_volume_session(dev, zmesh, base, starts, (50, 100), 1_000_000,
                                            "pallas")

    launches = counted_mesh3d("256^3 z mesh, device route", drive_device, "device")
    launches.update(counted_mesh3d("256^3 z mesh, per-shard route", drive_shard, "shard"))
    keys = [(t, n_) for t in (0, 1) for n_ in (50, 150)]
    errs = []
    for kernel in ("auto", "resident", "pallas"):
        errs += compare_session(out[kernel], ref, keys, f"256^3 8x1x1 mesh ({kernel})")
    picked = choose_mesh3d(SIZE3D, devices=[dev] * n)
    times = {"z": mesh_tick_ms(out["auto"]["planner"], starts[0]),
             "z_pallas": mesh_tick_ms(out["pallas"]["planner"], starts[0]),
             "plane": mesh_tick_ms(mesh_planner(dev, make_mesh(MESH, devices=[dev] * n)),
                                   starts[0])}
    # The shard entry alone on a z shard's block (halo on z only), after the
    # timed ticks: 8 sweeps with and without u1, and a 5-sweep remainder.
    sv = out["pallas"]["planner"]._sv
    k = sv.halo
    entry_errs, _ = entry_alone(sv, (3, 0, 0), ((k, False), (k, True), (5, True)),
                                "256^3 z shard")
    emit(phase="mesh3d_z", shape=list(SIZE3D), mesh=[n, 1, 1], shard=list(sv.loc),
         launches=launches, max_abs_err=max(errs), device_solve_ms=out["auto"]["solve_ms"],
         resident_solve_ms=out["resident"]["solve_ms"],
         pershard_solve_ms=out["pallas"]["solve_ms"], sweep3d_solve_ms=ref["solve_ms"],
         choose_mesh3d={axis: int(v) for axis, v in picked.shape.items()},
         z_device_tick_ms_mean5=times["z"], z_pershard_tick_ms_mean5=times["z_pallas"],
         plane_device_tick_ms_mean5=times["plane"],
         plane_device_tick_ms_mean5_phase20=m3["plane_tick_ms5"],
         plane_pershard_tick_ms_mean5_phase20=m3["plane_pallas_tick_ms5"],
         sweep3d_tick_ms_mean5=ref["tick_ms5"], entry_block=list(sv.block_shape(k)),
         entry_max_abs_err=max(entry_errs))
    return {"launches": launches, "err": max(errs + entry_errs)}


def shard_bound3d(frozen_view: torch.Tensor, halo, par0: int, t0: int, sweeps: int,
                  u1: bool = False) -> dict:
    """The least time for one shard's chunk: its bytes (the extended block's
    u and frozen bytes read, the centre written, twice with u1) over the HBM
    rate, or its lse6 updates (the centre's unfrozen voxels of each sweep's
    class) over the float32 rate, whichever is larger."""
    centre = frozen_view[tuple(slice(h, n - h) for n, h in zip(frozen_view.shape, halo))]
    z, y, x = (torch.arange(n, device=centre.device) for n in centre.shape)
    odd = ((par0 + sum(halo) + z[:, None, None] + y[None, :, None] + x[None, None, :]) % 2).bool()
    free = ~centre
    n_even, n_odd = int((free & ~odd).sum()), int((free & odd).sum())
    at_even_t = (sweeps + 1 - t0 % 2) // 2
    n_updates = at_even_t * n_even + (sweeps - at_even_t) * n_odd
    t_bytes = (frozen_view.numel() * 5 + centre.numel() * 4 * (2 if u1 else 1)) / PEAK_BYTES_PER_S
    t_ops = n_updates * OPS_LSE6 / PEAK_FP32_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                updates=n_updates, lse6=True)


def entry_alone(sv, idx, runs, what: str):
    """The 3D shard entry alone on shard ``idx``'s extended block after an
    exchange, against the plain per-shard version on the same block: one
    chunk for each ``(sweeps, with_u1)`` of ``runs``, the same bits. Returns
    the errors and ``(work, src, frozen, halo, par0, iteration)``."""
    from epic_tpu_torch.parallel import hopper_shard3d, sharded3d

    k = sv.halo
    sharded3d._exchange(sv, sv.u_blocks, k)
    view, halo = sv.view(k), sv.halos(k)
    src, frozen = sv.u_blocks[idx][view].clone(), sv.frozen_blocks[idx][view]
    work_b, u1_b = torch.empty_like(sv.u_blocks[idx]), torch.empty_like(sv.u_blocks[idx])
    work, u1 = work_b[view], u1_b[view]
    par0, it0 = sv.par0(idx, k), int(sv.iteration)
    centre = tuple(slice(h, n - h) for n, h in zip(src.shape, halo))
    errs = []
    for ns, with_u1 in runs:
        work.copy_(src)
        d = hopper_shard3d.chunk(work, frozen, halo=halo, par0=par0, iteration=it0, ns=ns,
                                 u1=u1 if with_u1 else None, want_delta=True)
        p_u, p_d, p_u1 = hopper_shard3d.sweep_k_local3d(src, frozen, par0, it0, ns, halo=halo,
                                                        u1=True)
        e = max(max_abs(work, p_u), max_abs(d, p_d))
        if with_u1:
            e = max(e, max_abs(u1[centre], p_u1[centre]))
        require(e == 0.0, f"{what}: the 3D shard entry ({ns} sweeps, u1={with_u1}) differs "
                f"from plain by {e}")
        errs.append(e)
    return errs, (work, src, frozen, halo, par0, it0)


def phase_mesh3d_wide(dev) -> dict:
    """64 x 1024 x 1024 on 2 x 4: the counted mesh path on both routes
    against the VolumePlanner, and the shard entry alone against the plain
    per-shard version."""
    from epic_tpu_torch.parallel import hopper_shard3d, make_mesh, make_mesh3d

    t0_s = time.perf_counter()
    u, locked = volume_arrays(MESH3D_WIDE)
    base = volume_state(dev, u, locked)
    lt = torch.from_numpy(locked)
    del u, locked
    starts = {t: at_iteration(base, t) for t in (0, 1)}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0_s
    ref = volume_refs(dev, base, starts, (100,), MESH3D_WIDE_CAP)
    n = MESH[0] * MESH[1]
    mesh = make_mesh(MESH, devices=[dev] * n)
    out, exchange = {}, []

    def drive_device():
        out["auto"] = mesh_volume_session(dev, mesh, base, starts, (100,), MESH3D_WIDE_CAP)
        out["tick_ms5"] = mesh_tick_ms(out["auto"]["planner"], starts[0])

    def drive_shard():
        out["pallas"] = mesh_volume_session(dev, mesh, base, starts, (100,), MESH3D_WIDE_CAP,
                                            "pallas")
        out["pallas_tick_ms5"] = mesh_tick_ms(out["pallas"]["planner"], starts[0], exchange)

    launches = counted_mesh3d("64x1024x1024 plane mesh, device route", drive_device, "device")
    launches.update(counted_mesh3d("64x1024x1024 plane mesh, per-shard route", drive_shard,
                                   "shard"))
    errs = []
    for kernel in ("auto", "pallas"):
        errs += compare_session(out[kernel], ref, [(0, 100), (1, 100)],
                                f"64x1024x1024 2x4 mesh ({kernel})")
    exchange_ms = sum(a.elapsed_time(b) for a, b in exchange) / 5
    z_tick = mesh_tick_ms(mesh_planner(dev, make_mesh3d((n, 1, 1), devices=[dev] * n)),
                          starts[0])

    # The shard entry alone on shard (0, 1)'s extended block.
    sv = out["pallas"]["planner"]._sv
    k = sv.halo
    entry_errs, (work, src, frozen, halo, par0, it0) = entry_alone(
        sv, (0, 1), ((k, False), (k, True), (5, True)), "64x1024x1024 shard")
    work.copy_(src)
    entry_ms = event_ms(lambda: hopper_shard3d.chunk(work, frozen, halo=halo, par0=par0,
                                                     iteration=it0, ns=k, want_delta=True),
                        reps=10)
    plain_ms = event_ms(lambda: hopper_shard3d.sweep_k_local3d(src, frozen, par0, it0, k,
                                                               halo=halo))
    entry_bound = shard_bound3d(frozen, halo, par0, it0, k)
    iters = int(ref["solve"].iteration)
    d, h, w = MESH3D_WIDE
    emit(phase="mesh3d_wide", shape=list(MESH3D_WIDE), mesh=list(MESH), shard=list(sv.loc),
         chunk_depth=k, setup_s=setup_s, launches=launches, max_abs_err=max(errs),
         device_tick_ms_mean5=out["tick_ms5"], pershard_tick_ms_mean5=out["pallas_tick_ms5"],
         sweep3d_tick_ms_mean5=ref["tick_ms5"], z_mesh_device_tick_ms_mean5=z_tick,
         exchange_ms_per_pershard_tick=exchange_ms,
         exchange_share=exchange_ms / out["pallas_tick_ms5"],
         device_solve_ms=out["auto"]["solve_ms"], pershard_solve_ms=out["pallas"]["solve_ms"],
         sweep3d_solve_ms=ref["solve_ms"], solve_cap=MESH3D_WIDE_CAP, solve_iterations=iters,
         entry_sweeps=k, entry_block=list(src.shape), entry_ms_mean10=entry_ms,
         entry_plain_ms=plain_ms, entry_max_abs_err=max(entry_errs),
         cell_updates_per_s_device=(d - 2) * (h - 2) * (w - 2) / 2 * 100
         / (out["tick_ms5"] / 1e3),
         bounds={"tick": bound(lt, 0, 100, lse6=True), "solve": bound(lt, 0, iters, lse6=True),
                 "entry": entry_bound},
         peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    return {"launches": launches, "err": max(errs + entry_errs),
            "entry": (entry_ms, plain_ms, entry_bound)}


NATIVE_STARTS = 20         # seeded maze starts walked by both host walkers
NATIVE_POINTS = 5000       # each walk's point budget in phase native
CASCADE_SIDE = 3072        # 3072^2 at 5 B a cell: 47 MB, past two thirds of the L2
CASCADE_CAP = 20_000       # each level's cap on the 3072^2 pyramid
CASCADE_VOLUME = (128, 256, 256)
ND_SHAPE = (16, 16, 16, 16)
FIELD = dict(rtol=2e-6, atol=1e-3)   # tests/test_torch_solver.py's fields across devices


def host_s(fn):
    """``fn()``'s result and its host-clock seconds, the card drained on both
    sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def new_counts(what: str, drive, expect: dict) -> dict:
    """Run ``drive()`` with every count zeroed just before and read just
    after: exactly the launches of ``expect`` (entry -> count, or None for at
    least one), and nothing else of the kernels or the plain versions."""
    from epic_tpu_torch.solver import core, hopper_sweep, hopper_sweep3d, hopper_tile2d

    zero_counts()
    drive()
    torch.cuda.synchronize()
    ran = {k: v for d in (hopper_sweep.launches, hopper_tile2d.launches, hopper_sweep3d.launches)
           for k, v in d.items() if v}
    plain = {f"core.{k}": v for k, v in core.calls.items() if v}
    require(not plain, f"{what}: the plain version ran on the main path: {plain}")
    require(set(ran) == set(expect), f"{what}: launches {ran}, expected {expect}")
    for k, n in expect.items():
        require(n is None or ran[k] == n, f"{what}: {k} launched {ran[k]} times, not {n}")
    return ran


def phase_native(dev, maze, maze_solved) -> dict:
    """The g++ build of the native helpers, then both host walkers on phase
    2's K2-solved maze field from NATIVE_STARTS seeded free cells (step 0.2,
    precision 0.4, at most NATIVE_POINTS points a walk: the NumPy walker
    takes about 60 us a point on the chip host, so full walks of up to 85,000
    points at the verb's step 0.05 would cost a minute): the same points (or
    the same error), each walker's host time."""
    from epic_tpu_torch import native, path

    ok, load_s = host_s(native.available)
    info = {k: v for k, v in native.build_info.items() if k != "log"}
    emit(phase="native_build", available=ok, load_s=load_s, **info,
         compiler_output=native.build_info.get("log", "")[-2000:])
    require(ok, f"the native library did not build: {native.build_info}")
    u = maze_solved.u.cpu().numpy()
    locked = maze_solved.locked.cpu().numpy()
    free = np.argwhere(~locked)
    picks = free[np.random.default_rng(0).choice(len(free), NATIVE_STARTS, replace=False)]
    times = {"numpy": [], "native": []}
    points, errors = [], 0
    for y, x in picks:
        got = {}
        for impl in ("numpy", "native"):
            t0 = time.perf_counter()
            try:
                got[impl] = path.compute_path(u, locked, float(x), float(y), 0.2, 0.4,
                                              NATIVE_POINTS, impl=impl)
            except Exception as e:  # the error's type is part of the contract
                got[impl] = type(e).__name__
            times[impl].append(time.perf_counter() - t0)
        a, b = got["numpy"], got["native"]
        if isinstance(a, str) or isinstance(b, str):
            require(a == b if isinstance(a, str) and isinstance(b, str) else False,
                    f"walkers differ from ({x}, {y}): {a if isinstance(a, str) else len(a)} "
                    f"vs {b if isinstance(b, str) else len(b)}")
            errors += 1
            continue
        require(a.shape == b.shape and np.array_equal(a, b),
                f"native and NumPy walks from ({x}, {y}) differ")
        points.append(len(a))
    require(len(points) >= NATIVE_STARTS // 2, f"only {len(points)} starts walked")
    out = dict(starts=NATIVE_STARTS, walked=len(points), errors=errors, points=points,
               numpy_s=float(np.sum(times["numpy"])), native_s=float(np.sum(times["native"])),
               numpy_us_per_point=float(np.sum(times["numpy"]) / sum(points) * 1e6),
               native_us_per_point=float(np.sum(times["native"]) / sum(points) * 1e6),
               numpy_walk_s=times["numpy"], native_walk_s=times["native"])
    emit(phase="native", **out)
    return out


def timed_levels(solve, clock: str):
    """``solve`` wrapped to record each call's time (CUDA events on the card,
    or the host clock for a host solver) in the returned list, and on the
    card each call's bound (:func:`bound`) in the second list."""
    log, bounds = [], []

    def run(st, stagger, max_iterations):
        res = {}
        if clock == "host":
            res["o"], secs = host_s(lambda: solve(st, stagger, max_iterations))
            log.append(secs * 1e3)
        else:
            log.append(event_ms(lambda: res.__setitem__("o", solve(st, stagger, max_iterations))))
            bounds.append(bound(st.locked, 0, int(res["o"].iteration), lse6=st.u.ndim == 3))
        return res["o"]

    return run, log, bounds


def cascade_demo(dev, g, name: str, cold_ms: float) -> dict:
    """Planner(cascade=True).solve() on a demo map, counted (coarse levels on
    the native library, the fine level on K2 once, nothing else), held bit
    for bit to the same cascade with core.solve as the fine solver on the
    card. That plain cascade also times each coarse level (host clock) and
    K2 on its fine level's warm start (CUDA events): the same bits again."""
    import epic_tpu_torch as T
    from epic_tpu_torch.planner import Planner, PlannerConfig
    from epic_tpu_torch.solver import cascade, core, hopper_sweep

    img = g["img"]
    pl = Planner(PlannerConfig(epsilon=EPS, stagger=STAGGER, cascade=True), device=dev)
    pl.state = T.from_occupancy_image(img, EPS, device=dev)
    ran = {}

    def drive():
        _, ran["s"] = host_s(pl.solve)

    launches = new_counts(f"{name} cascade", drive, {"epic_sweep2d_solve_resident": 1})
    coarse, coarse_ms, _ = timed_levels(cascade.native_solver, "host")
    fine = {}

    def final(st, stagger, max_iterations):
        warm = copy_state(st)
        fine["ms"] = event_ms(lambda: fine.__setitem__(
            "k", hopper_sweep.solve(warm, stagger, max_iterations)))
        return core.solve(st, stagger, max_iterations)

    plain, stats = cascade.solve_cascade(T.from_occupancy_image(img, EPS, device=dev),
                                         solver=final, coarse_solver=coarse)
    err = compare(pl.state, plain, f"{name} cascade against the plain cascade")
    compare(fine["k"], plain, f"{name} K2 on the warm start against the plain cascade")
    require(bool(plain.converged) and int(plain.iteration) == stats.iterations[-1],
            f"{name} cascade: {stats}")
    return dict(shape=list(img.shape), levels=[list(s) for s in stats.shapes],
                iterations=list(stats.iterations),
                total_fine_equivalent=stats.total_fine_equivalent,
                level_ms=coarse_ms + [fine["ms"]],
                level_clock=["host"] * len(coarse_ms) + ["cuda"],
                fine_bound=bound(plain.locked, 0, stats.iterations[-1]),
                planner_solve_s=ran["s"], max_abs_err=err, launches=launches,
                cold_k2_solve_ms=cold_ms)


def phase_cascade(dev, maze, umass, m, um, volume_arrays_fn) -> dict:
    """The cascade on the card's kernels: the demo maps through the Planner,
    a 3072^2 pyramid with every level on the card (K2 on the coarse levels,
    the tile solve on the fine one), and a 3D pyramid on K7."""
    import epic_tpu_torch as T
    from epic_tpu_torch import maps, solver
    from epic_tpu_torch.solver import cascade, core

    res = {"maze": cascade_demo(dev, maze, "maze", m["solve_ms"]),
           "umass": cascade_demo(dev, umass, "umass", um["solve_ms"])}
    img = maps.random_obstacles(CASCADE_SIDE, CASCADE_SIDE, density=0.1, seed=0)
    out = {}

    def drive():
        out["k"], out["k_s"] = host_s(lambda: cascade.solve_cascade(
            T.from_occupancy_image(img, EPS, device=dev), max_iterations=CASCADE_CAP))

    launches = new_counts("3072^2 cascade", drive,
                          {"epic_tile2d_solve": 1, "epic_sweep2d_solve_resident": None})
    k, stats = out["k"]
    require(launches["epic_sweep2d_solve_resident"] == len(stats.iterations) - 1,
            f"3072^2 cascade: K2 on {launches['epic_sweep2d_solve_resident']} of "
            f"{len(stats.iterations) - 1} coarse levels")
    level, level_ms, level_bounds = timed_levels(lambda st, a, b: solver.solve_grid(st, a, b),
                                                 "cuda")
    timed, _ = cascade.solve_cascade(T.from_occupancy_image(img, EPS, device=dev),
                                     max_iterations=CASCADE_CAP, solver=level)
    plain, pstats = cascade.solve_cascade(T.from_occupancy_image(img, EPS, device=dev),
                                          max_iterations=CASCADE_CAP, solver=core.solve)
    err = compare(k, plain, "3072^2 cascade against the plain cascade")
    compare(timed, plain, "3072^2 timed cascade against the plain cascade")
    require(stats == pstats, f"3072^2 cascade: {stats} vs {pstats}")
    res["grid3072"] = dict(shape=[CASCADE_SIDE] * 2, cap=CASCADE_CAP,
                           levels=[list(s) for s in stats.shapes],
                           iterations=list(stats.iterations),
                           converged=bool(k.converged),
                           total_fine_equivalent=stats.total_fine_equivalent,
                           level_ms=level_ms, level_bounds=level_bounds,
                           solve_cascade_s=out["k_s"], max_abs_err=err,
                           launches=launches)
    u, locked = volume_arrays_fn(CASCADE_VOLUME)

    def drive3():
        out["v"], out["v_s"] = host_s(lambda: cascade.solve_cascade(
            T.make_state(u, locked, EPS, device=dev)))

    launches3 = new_counts("3D cascade", drive3, {"epic_sweep3d_solve": 2})
    kv, vstats = out["v"]
    require(vstats.shapes == (tuple(n // 2 for n in CASCADE_VOLUME), CASCADE_VOLUME),
            f"3D cascade: {vstats.shapes}")
    level, level3_ms, level3_bounds = timed_levels(lambda st, a, b: solver.solve_grid(st, a, b),
                                                   "cuda")
    timed, _ = cascade.solve_cascade(T.make_state(u, locked, EPS, device=dev), solver=level)
    plain, pstats = cascade.solve_cascade(T.make_state(u, locked, EPS, device=dev),
                                          solver=core.solve)
    err3 = compare(kv, plain, "3D cascade against the plain cascade")
    compare(timed, plain, "3D timed cascade against the plain cascade")
    require(vstats == pstats and bool(kv.converged), f"3D cascade: {vstats} vs {pstats}")
    res["volume"] = dict(shape=list(CASCADE_VOLUME), levels=[list(s) for s in vstats.shapes],
                         iterations=list(vstats.iterations),
                         total_fine_equivalent=vstats.total_fine_equivalent,
                         level_ms=level3_ms, level_bounds=level3_bounds,
                         solve_cascade_s=out["v_s"], max_abs_err=err3,
                         launches=launches3)
    emit(phase="cascade", **res)
    return res


def phase_nav_core(dev) -> dict:
    """EpicNavCorePlugin on the card, two make_plan calls, counted (K2 once a
    plan, nothing else); the plans equal a plugin's whose solve is the plain
    core.solve on the card."""
    from epic_tpu_torch import maps
    from epic_tpu_torch.services import EpicNavCorePlugin
    from epic_tpu_torch.solver import core

    img = maps.recursive_maze(128, 128, seed=7)
    costmap = np.where(img == 0, 254, 0).astype(np.uint8)
    free = np.argwhere(img == 128)
    requests = [(tuple(map(float, free[-3][::-1])), tuple(map(float, free[5][::-1]))),
                (tuple(map(float, free[17][::-1])), tuple(map(float, free[len(free) // 2][::-1])))]
    ours = EpicNavCorePlugin(device=dev)
    plain = EpicNavCorePlugin(device=dev, solve_fn=core.solve)
    for pl in (ours, plain):
        pl.initialize(costmap)
    plans, plan_s = [], []

    def drive():
        for start, goal in requests:
            plan, secs = host_s(lambda: ours.make_plan(start, goal))
            plans.append(plan)
            plan_s.append(secs)

    launches = new_counts("nav_core", drive, {"epic_sweep2d_solve_resident": len(requests)})
    for (start, goal), plan in zip(requests, plans):
        ref = plain.make_plan(start, goal)
        require((plan is None) == (ref is None), f"nav_core plan from {start}: {plan is None}")
        require(plan is None or plan == ref, f"nav_core plans from {start} differ")
    require(plans[-1] is not None, "nav_core: no plan")
    # The last request again, on a warm plugin: the make_plan latency a
    # replanning user sees (solve, host copy of the field, walk).
    _, warm_s = host_s(lambda: ours.make_plan(*requests[-1]))
    out = dict(shape=list(img.shape), plan_poses=[None if p is None else len(p) for p in plans],
               make_plan_s=plan_s, make_plan_warm_s=warm_s, launches=launches)
    emit(phase="nav_core", **out)
    return out


def phase_modules(dev, maze, maze_solved) -> dict:
    """A 16^4 grid on the card through solver.solve_grid (the plain core: no
    kernel may run) against the CPU plain solve; legacy.sor_red_black on the
    card against the row-major NumPy SOR; a checkpoint round trip of a maze
    planner (saved on the card, loaded on the card and on the CPU);
    profiling.timed_solve on the card."""
    import epic_tpu_torch as T
    from epic_tpu_torch import checkpoint, maps, profiling, solver
    from epic_tpu_torch.planner import Planner, PlannerConfig
    from epic_tpu_torch.solver import core, legacy

    def nd_state(device):
        st = T.empty_grid_nd(ND_SHAPE, EPS, device="cpu")
        u = torch.where(st.locked, st.u, torch.full_like(st.u, -1e6))
        locked = st.locked.clone()
        rng = np.random.default_rng(0)
        for _ in range(2):
            goal = tuple(int(v) for v in rng.integers(1, np.array(ND_SHAPE) - 1))
            u[goal] = 0.0
            locked[goal] = True
        return T.make_state(u, locked, EPS, device=device)

    res = {}

    def drive():
        res["nd"], res["nd_s"] = host_s(lambda: solver.solve_grid(nd_state(dev)))

    zero_counts()
    drive()
    torch.cuda.synchronize()
    from epic_tpu_torch.solver import hopper_sweep, hopper_sweep3d, hopper_tile2d
    ran = {k: v for d in (hopper_sweep.launches, hopper_tile2d.launches, hopper_sweep3d.launches)
           for k, v in d.items() if v}
    require(not ran, f"16^4 on the card launched a kernel: {ran}")
    require(core.calls["solve"] == 1, f"16^4 did not run the plain core: {core.calls}")
    cpu = core.solve(nd_state("cpu"))
    nd = res["nd"]
    require(int(nd.iteration) == int(cpu.iteration) and bool(nd.converged),
            f"16^4: {int(nd.iteration)} iterations on the card, {int(cpu.iteration)} on the CPU")
    np.testing.assert_allclose(nd.u.cpu().numpy(), cpu.u.numpy(), **FIELD)
    nd_err = max_abs(nd.u.cpu(), cpu.u)

    img = maps.open_room(24, 24)
    u, locked = legacy.from_image(img, dtype=np.float32)
    sor_ref, sor_it = legacy.sor_numpy(u.copy(), locked, epsilon=1e-6, min_iterations=2000,
                                       max_iterations=4000)
    sor_out = {}
    sor_ms = event_ms(lambda: sor_out.__setitem__("r", legacy.sor_red_black(
        torch.from_numpy(u).to(dev), torch.from_numpy(locked).to(dev), 1e-6,
        min_iterations=2000, max_iterations=4000)))
    sor_err = float(np.max(np.abs(sor_out["r"][0].cpu().numpy() - sor_ref)))
    require(sor_err <= 1e-4, f"sor_red_black on the card differs from sor_numpy by {sor_err}")

    pl = Planner(PlannerConfig(epsilon=EPS, resolution=0.1, origin_x=-3.0), device=dev)
    pl.state = T.state_from_numpy(T.state_to_numpy(maze_solved), device=dev)
    ck_dir = ROOT / "build" / "epic_tpu_torch" / "chip_smoke"
    ck_dir.mkdir(parents=True, exist_ok=True)
    f = ck_dir / "maze_planner.npz"
    checkpoint.save_planner(f, pl)
    ref = T.state_to_numpy(pl.state)
    for where in (dev, "cpu"):
        back = checkpoint.load_planner(f, device=where)
        require(back.state.u.device == torch.device(where), f"checkpoint loaded on {back.state.u.device}")
        got = T.state_to_numpy(back.state)
        require(all(np.array_equal(got[k], ref[k]) for k in ref),
                f"checkpoint round trip on {where}: bits differ")
        require(back.config.resolution == 0.1 and back.config.origin_x == -3.0,
                f"checkpoint round trip on {where}: transforms")
    f.unlink()

    solved, stats = profiling.timed_solve(solver.solve_grid,
                                          T.from_occupancy_image(maze["img"], EPS, device=dev))
    compare(solved, maze_solved, "profiling.timed_solve against phase 2's K2 solve")
    out = dict(nd=dict(shape=list(ND_SHAPE), iterations=int(nd.iteration), solve_s=res["nd_s"],
                       max_abs_err_vs_cpu=nd_err, kernel_launches=ran),
               sor_red_black=dict(shape=list(img.shape), iterations=sor_out["r"][1],
                                  numpy_iterations=sor_it, ms=sor_ms, max_abs_err=sor_err),
               checkpoint="same bits on the card and the CPU",
               timed_solve=dict(iterations=stats.iterations, wall_s=stats.wall_s,
                                device_ms=stats.device_ms,
                                cell_updates_per_s=stats.cell_updates_per_s))
    emit(phase="modules", **out)
    return out


def phase_sampling(dev, maze) -> dict:
    """The sampling_* verbs on an in-process server over a real socket:
    sampling_occupancy with the maze, a goal, sampling_compute_path, a few
    ticks of the anytime budget, and the info block."""
    from epic_tpu_torch.config import EpicConfig
    from epic_tpu_torch.services.navigation_node import EpicNavigationNodeRviz
    from epic_tpu_torch.services.server import EpicClient, EpicServiceServer, ingest_map

    cfg = EpicConfig.load_yaml(ROOT / "configs" / "maze.yaml")
    img = maze["img"]
    h, w = img.shape
    node = EpicNavigationNodeRviz(cfg, update_rate=cfg.service.update_rate_hz, device=dev)
    ingest_map(node, img)
    server = EpicServiceServer(node, "127.0.0.1", 0)
    client = EpicClient(port=server.port, timeout=60.0)
    s = LoopbackSession(server, client)
    try:
        occ = np.where(img == 0, 100, 0).astype(np.int8)
        r, _ = s.call("sampling_occupancy", width=w, height=h, seed=0,
                      data=occ.reshape(-1).tolist())
        require(r["success"], f"sampling_occupancy: {r}")
        gy, gx = np.argwhere(img == 255)[0]
        r, _ = s.call("sampling_add_goals", goals=[[float(gx), float(gy)]])
        require(r["success"], f"sampling_add_goals: {r}")
        ys, xs = np.nonzero((img != 0) & (img != 255))
        start = [float(xs[len(xs) // 3]), float(ys[len(ys) // 3])]
        r, _ = s.call("sampling_compute_path", start=start)
        require(r["success"], f"sampling_compute_path: {r}")
        _, spin_s = host_s(lambda: s.spin(20))
        r, _ = s.call("sampling_compute_path", start=start)
        require(r["success"], f"sampling_compute_path after 20 ticks: {r}")
        info, _ = s.call("info")
        require(info["success"] and "sampling" in info, f"info has no sampling block: {info}")
    finally:
        client.close()
        server.close()
    out = dict(shape=[h, w], budget_s=server.sampling_budget_s, twenty_ticks_s=spin_s,
               solved=r["solved"], iterations=r["iterations"], path_poses=len(r["path"]),
               info=info["sampling"])
    emit(phase="sampling", **out)
    return out


SCRATCH = ROOT / "build" / "epic_tpu_torch" / "chip_smoke"
R3_CSV = ROOT / "docs" / "results_batch_tpu_r3.csv"   # the reference's battery on a TPU
LOADTEST = ["--clients", "4", "--rounds", "25", "--size", "256"]
SCALING_SIDE = 4096       # 67 MB of u: past the L2 on one shard
SCALING_SWEEPS = 100
SCALING_SHARDS = [1, 2, 4, 8]


def reference_tree(goldens: dict) -> pathlib.Path:
    """The goldens' maze and umass images written as the reference's own
    PNGs into a fixture tree that ``maps.REFERENCE_MAP_DIRS`` searches, named
    by ``$EPIC_REFERENCE_ROOT`` from here on: the tools load the reference's
    maps as the TPU battery did. Each PNG must read back as its golden."""
    import os

    from PIL import Image

    from epic_tpu_torch import maps

    root = SCRATCH / "reference"
    d = root / maps.REFERENCE_MAP_DIRS[0]
    d.mkdir(parents=True, exist_ok=True)
    for name, g in goldens.items():
        png = d / f"{name}.png"
        Image.fromarray(g["img"]).save(png)
        require(np.array_equal(maps.load_png(png), g["img"]), f"{name}.png round trip")
    os.environ["EPIC_REFERENCE_ROOT"] = str(root)
    for name in goldens:
        require(maps.reference_map_path(f"{name}.png") == d / f"{name}.png",
                f"{name}.png is not found through $EPIC_REFERENCE_ROOT")
    return root


def r3_rows() -> dict:
    import csv

    with open(R3_CSV, newline="") as f:
        return {(r["Domain"], r["Solver"]): r for r in csv.DictReader(f)}


def phase_battery(dev, goldens: dict) -> dict:
    """The battery tool (epic_tpu_torch.tools.batch_bench) on the reference's
    maze and umass at eps 1e-3, --backend pallas (the plain row would take
    14 s of plain torch on the maze), counted: K2 twice a domain (warm-up
    and timed run), nothing else on the card. The kernel row's iterations
    must be the goldens' ref_iters, its percent-valid the native row's and
    the TPU battery's (docs/results_batch_tpu_r3.csv) 1.0; the native row
    must equal that battery's log_native_cpu row; the SOR rows are printed
    beside its own."""
    from epic_tpu_torch.config import EpicConfig, SolverConfig
    from epic_tpu_torch.tools import batch_bench

    r3 = r3_rows()
    cfg = EpicConfig(solver=SolverConfig(epsilon=EPS))
    out = {"launches": {}}
    for name, g in goldens.items():
        res = {}
        ran = new_counts(f"battery {name}", lambda: res.__setitem__(
            "rows", batch_bench.run(name, cfg, None, backend="pallas", device=dev)),
            {"epic_sweep2d_solve_resident": 2})
        add_counts(out["launches"], ran)
        rows = {r[1]: r for r in res["rows"]}
        require(set(rows) == {"cpu_sor_f32", "cpu_sor_f64", "log_native_cpu", "log_hopper_cuda"},
                f"battery {name}: rows {sorted(rows)}")
        kern, nat = rows["log_hopper_cuda"], rows["log_native_cpu"]
        tpu_nat = r3[(name, "log_native_cpu")]
        require(kern[6] == int(g["ref_iters"]),
                f"battery {name}: kernel row {kern[6]} iterations, goldens {int(g['ref_iters'])}")
        require(kern[3] == nat[3] == float(tpu_nat["Percent Valid"]) == 1.0,
                f"battery {name}: percent-valid kernel {kern[3]}, native {nat[3]}, "
                f"TPU battery {tpu_nat['Percent Valid']}")
        require(nat[6] == int(tpu_nat["Iterations"]),
                f"battery {name}: native {nat[6]} iterations, TPU battery {tpu_nat['Iterations']}")
        side = {label: dict(percent_valid=r[3], time_per_update_s=r[4], time_to_converge_s=r[5],
                            iterations=r[6],
                            tpu_battery=dict(percent_valid=float(r3[(name, label)]["Percent Valid"]),
                                             time_to_converge_s=float(
                                                 r3[(name, label)]["Time to Converge"]),
                                             iterations=int(r3[(name, label)]["Iterations"]))
                            if (name, label) in r3 else None)
                for label, r in rows.items()}
        side["log_hopper_cuda"]["tpu_battery_log_pallas"] = {
            k: r3[(name, "log_pallas_tpu")][k]
            for k in ("Percent Valid", "Time to Converge", "Iterations")}
        out[name] = side
        emit(phase="battery", domain=name, shape=list(g["img"].shape), epsilon=EPS,
             launches=ran, rows=side)
    return out


def phase_precision(dev) -> dict:
    """The precision overlay tool on the reference's maze at eps 1e-3 to a
    PNG, counted (K2 once, nothing else on the card): the log-space region's
    share of the free cells at least SOR f64's and SOR f32's."""
    from epic_tpu_torch import maps
    from epic_tpu_torch.tools import compare_precision

    png = SCRATCH / "precision_maze.png"
    png.unlink(missing_ok=True)
    res = {}
    ran = new_counts("precision", lambda: res.__setitem__("s", compare_precision.main(
        ["--domain", "maze", "--epsilon", str(EPS), "--out", str(png), "--device", str(dev)])),
        {"epic_sweep2d_solve_resident": 1})
    s = res["s"]
    require(png.exists() and maps.load_png(png).shape == (482, 482), "precision: no overlay")
    require(s["log"] >= s["sor_f64"] and s["log"] >= s["sor_f32"],
            f"precision: log-space region smaller than SOR's: {s}")
    emit(phase="precision", domain="maze", epsilon=EPS, shares=s, launches=ran)
    return dict(shares=s, launches=ran)


def phase_demo_tool(dev) -> dict:
    """The anytime demo tool on the reference's maze: 40 ticks of 50 sweeps
    (K1), then paths from 6 seeded starts with its retry rounds, counted (K1
    only). Every start must get a path, and the PNG must be written."""
    from epic_tpu_torch import maps
    from epic_tpu_torch.tools import anytime_demo

    png = SCRATCH / "demo_maze.png"
    png.unlink(missing_ok=True)
    res = {}
    ran = new_counts("demo", lambda: res.__setitem__("d", anytime_demo.main(
        ["--ticks", "40", "--starts", "6", "--out", str(png), "--device", str(dev)])),
        {"epic_sweep2d_chunk": None})
    d = res["d"]
    require(d["sweeps"] == 2000, f"demo: {d['sweeps']} sweeps in the first loop")
    require(not d["pending"] and len(d["poses"]) == 6, f"demo: starts without a path: {d}")
    require(png.exists() and maps.load_png(png).shape == (482, 482), "demo: no PNG")
    out = dict(loop_sweeps=d["sweeps"], loop_s=d["loop_s"], final_sweeps=d["final_sweeps"],
               poses=d["poses"], launches=ran)
    emit(phase="demo", **out)
    return out


def phase_loadtest(dev) -> dict:
    """The load test tool: 4 clients x 25 rounds against an in-process
    server on the card (a 256^2 maze), counted (the server's ticks on K1
    only). No protocol error, and every verb sampled."""
    from epic_tpu_torch.tools import server_loadtest

    res = {}
    ran = new_counts("loadtest", lambda: res.__setitem__("r", server_loadtest.main(
        [*LOADTEST, "--device", str(dev)])), {"epic_sweep2d_chunk": None})
    d = res["r"]["detail"]
    require(d["protocol_errors"] == 0, f"loadtest: {d['protocol_errors']} protocol errors")
    require(set(d["verbs"]) == {"compute_path", "get_cell", "set_cells"}
            and all(v["n"] > 0 for v in d["verbs"].values()), f"loadtest: verbs {d['verbs']}")
    require(d["verbs"]["compute_path"]["n"] == 100, "loadtest: compute_path samples")
    out = dict(requests_per_s=res["r"]["value"], wall_s=d["wall_s"], verbs=d["verbs"],
               protocol_errors=d["protocol_errors"], launches=ran)
    emit(phase="loadtest", **out)
    return out


def phase_scaling(dev) -> dict:
    """The scaling tool on a 4096^2 random-obstacle grid, 100 sweeps, on 1,
    2, 4 and 8 shards of a virtual mesh of the card, for kernel="auto" and
    "pallas", each counted: "pallas" runs the shard entry (K14/K15) only;
    "auto" the shard entry where a shard is past RESIDENT_MAX_SHARD_CELLS
    (one shard) and the resident cycle (K16/K17) below; nothing else. Every
    row's field must equal the 1-shard row's, and both kernels' and
    core.update_n's on the whole grid on the card, bit for bit."""
    import epic_tpu_torch as T
    from epic_tpu_torch import maps
    from epic_tpu_torch.parallel import hopper_resident2d, hopper_shard2d, sharded
    from epic_tpu_torch.solver import core, hopper_sweep, hopper_tile2d, tiled
    from epic_tpu_torch.tools import scaling_bench

    def route(n):
        my, mx = sharded.near_square(n)
        cells = -(-SCALING_SIDE // my) * -(-SCALING_SIDE // mx)
        return ("epic_resident2d_cycle" if cells <= sharded.RESIDENT_MAX_SHARD_CELLS
                else "epic_shard2d_chunk")

    out = {"launches": {}, "err": 0.0}
    first = None
    for kernel in ("auto", "pallas"):
        fields = {}
        zero_counts()
        rows = scaling_bench.run([SCALING_SIDE], SCALING_SWEEPS, SCALING_SHARDS, kernel, 16, dev,
                                 fields=fields)
        torch.cuda.synchronize()
        mesh_ran = {k: v for d in (hopper_shard2d.launches, hopper_resident2d.launches)
                    for k, v in d.items() if v}
        others = {**{k: v for d in (hopper_sweep.launches, hopper_tile2d.launches)
                     for k, v in d.items() if v},
                  **{f"core.{k}": v for k, v in core.calls.items() if v},
                  **{f"tiled.{k}": v for k, v in tiled.calls.items() if v},
                  **{f"hopper_shard2d.{k}": v for k, v in hopper_shard2d.calls.items() if v},
                  **{f"hopper_resident2d.{k}": v for k, v in hopper_resident2d.calls.items()
                     if v}}
        expect = ({route(n) for n in SCALING_SHARDS} if kernel == "auto"
                  else {"epic_shard2d_chunk"})
        require(set(mesh_ran) == expect, f"scaling {kernel}: launches {mesh_ran}, expected {expect}")
        require(not others, f"scaling {kernel}: another kernel or a plain version ran: {others}")
        add_counts(out["launches"], mesh_ran)
        one = fields[(SCALING_SIDE, 1)]
        if first is None:
            first = one
        for n in SCALING_SHARDS:
            out["err"] = max(out["err"], same_field(fields[(SCALING_SIDE, n)], one,
                                                    f"scaling {kernel}: {n} shards against 1"))
        out["err"] = max(out["err"], same_field(one, first, f"scaling {kernel} against auto"))
        out[kernel] = dict(rows=rows, launches=mesh_ran)
        emit(phase="scaling", kernel=kernel, side=SCALING_SIDE, sweeps=SCALING_SWEEPS,
             launches=mesh_ran,
             throughput_vs_1dev={r["devices"]: r["throughput_vs_1dev"] for r in rows},
             rows=rows)
        del fields
    img = maps.random_obstacles(SCALING_SIDE, SCALING_SIDE, density=0.1, seed=0)
    ref = core.update_n(T.from_occupancy_image(img, 1e-6, device=dev), SCALING_SWEEPS)
    out["err"] = max(out["err"], same_field(first, ref, "scaling: the mesh against core.update_n"))
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is False")
    import epic_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    maze = np.load(GOLDENS / "maze.npz")
    umass = np.load(GOLDENS / "umass.npz")
    built = phase_build()
    m = phase_demo(dev, maze, "maze")
    um = phase_demo(dev, umass, "umass")
    phase_goldens(dev, maze, m["solved"], umass, um["solved"])
    launches, session = phase_session(dev, maze)
    z = phase_size(dev)
    g2 = phase_grid2048(dev)
    v = phase_volume(dev)
    phase_golden3d(dev)
    launches.update(phase_session3d(dev, session, maze, v["volume"]))
    z3 = phase_size3d(dev)
    b = phase_batch(dev)
    goals = phase_batch_goals(dev)
    launches.update(goals["launches"])
    bb = big_lanes(dev, "batch_big", BATCH_BIG, BATCH_BIG_CAP, "cluster")
    launches.update(bb["launches"])
    bh = big_lanes(dev, "batch_huge", BATCH_HUGE, BATCH_HUGE_CAP, "tiled")
    launches.update(bh["launches"])
    bf = phase_batch_few(dev)
    for r in bf:
        add_counts(launches, r["launches"])
    big = phase_biggrid(dev)
    wide = phase_wide(dev)
    small = phase_tile_small(dev, maze, m["solved"])
    big3 = phase_biggrid3d(dev)
    wide3 = phase_wide3d(dev)
    small3 = phase_tile3d_small(dev, v["volume"], v["solved"])
    mesh_s = phase_mesh_session(dev, maze)
    mesh16 = phase_mesh16k(dev)
    m3 = phase_mesh3d(dev)
    m3z = phase_mesh3d_z(dev, m3)
    del m3["ref"], m3["base"], m3["starts"]
    m3w = phase_mesh3d_wide(dev)
    res = phase_mesh_resident(dev, maze, mesh_s, mesh16)
    del mesh16["base"], mesh16["starts"], mesh16["ref"], mesh16["got"]
    phase_native(dev, maze, m["solved"])
    casc = phase_cascade(dev, maze, umass, m, um, volume_arrays)
    nav = phase_nav_core(dev)
    phase_modules(dev, maze, m["solved"])
    phase_sampling(dev, maze)
    reference_tree({"maze": maze, "umass": umass})
    bat = phase_battery(dev, {"maze": maze, "umass": umass})
    prec = phase_precision(dev)
    demo = phase_demo_tool(dev)
    load = phase_loadtest(dev)
    scal = phase_scaling(dev)
    # The tools' counted runs: K2 in the battery and the overlay, K1 in the
    # demo and the load test, K14/K15 and K16/K17 in the scaling tool.
    for counts in (bat["launches"], prec["launches"], demo["launches"], load["launches"],
                   scal["launches"]):
        add_counts(launches, counts)
    for counts in (mesh_s["launches"], mesh16["launches"], m3["launches"], m3z["launches"],
                   m3w["launches"], res["launches"]):
        add_counts(launches, counts)
    for name in big["launches"]:
        launches[name] = big["launches"][name] + wide["launches"][name]
    for counts in (big3["main"], big3["tile_launches"], wide3["main"], wide3["tile_launches"]):
        add_counts(launches, counts)
    # The launches of the cascade's and nav_core's counted runs (K2, the tile
    # solve, K7).
    for counts in (casc["maze"]["launches"], casc["umass"]["launches"],
                   casc["grid3072"]["launches"], casc["volume"]["launches"], nav["launches"]):
        add_counts(launches, counts)
    tile_err = max(z["tile_err"], big["err"], wide["err"], small["err"])
    tile3d_err = max(big3["err"], wide3["err"], small3["err"])
    errs = {
        "epic_sweep2d_chunk": max(m["tick_err"], um["tick_err"], z["tick_err"], g2["tick_err"]),
        "epic_sweep2d_solve": max(m["in_place_err"], um["in_place_err"], z["solve_err"],
                                  g2["in_place_err"]),
        "epic_sweep2d_solve_resident": max(m["solve_err"], um["solve_err"], g2["solve_err"]),
        "epic_sweep3d_chunk": max(v["tick_max_abs_err"], z3["tick_max_abs_err"]),
        "epic_sweep3d_solve": max(v["solve_max_abs_err"], z3["solve_max_abs_err"]),
        "epic_batched2d_chunk/resident": b["chunk_err"],
        "epic_batched2d_solve/resident": max(b["solve_err"], goals["err"]),
        "epic_batched2d_chunk/cluster": max(bb["chunk_err"], *(r["chunk_err"] for r in bf)),
        "epic_batched2d_solve/cluster": max(bb["solve_err"], *(r["solve_err"] for r in bf)),
        "epic_batched2d_chunk/tiled": bh["chunk_err"],
        "epic_batched2d_solve/tiled": bh["solve_err"],
        "epic_tile2d_chunk": tile_err,
        "epic_tile2d_cycle": tile_err,
        "epic_tile2d_solve": tile_err,
        "epic_tile3d_chunk": tile3d_err,
        "epic_tile3d_cycle": tile3d_err,
        "epic_tile3d_solve": tile3d_err,
        "epic_shard2d_chunk": max(mesh_s["err"], mesh16["err"]),
        "epic_shard3d_chunk": max(m3["err"], m3z["err"], m3w["err"]),
        "epic_resident2d_cycle": res["err"],
        "epic_resident2d_solve": res["err"],
        "epic_resident3d_cycle": max(m3["err"], m3z["err"], m3w["err"]),
        "epic_resident3d_solve": max(m3["err"], m3z["err"], m3w["err"]),
    }
    # The scaling tool's meshes held their fields to core.update_n's.
    for name in ("epic_shard2d_chunk", "epic_resident2d_cycle"):
        errs[name] = max(errs[name], scal["err"])
    # The cascade's counted runs held their fields to the plain cascade's.
    for name, runs in (("epic_sweep2d_solve_resident", ("maze", "umass", "grid3072")),
                       ("epic_tile2d_solve", ("grid3072",)),
                       ("epic_sweep3d_solve", ("volume",))):
        errs[name] = max(errs[name], *(casc[r]["max_abs_err"] for r in runs))
    # (ms, plain_ms, bound) of one piece of work on each main path's shapes:
    # maze 482^2, the 30 x 256 x 256 volume, 4096 x 128^2 (the resident batch
    # route), 256 x 384^2 (the cluster one), 32 x 1024^2 (the tiled one), 8192^2, 32 x 2048 x 2048 (the
    # volume the router sends to the 3D tiles; 256^3 beside it, under
    # "cube"), one 8192 x 4096 shard of the 16384^2 mesh, one 64 x 512 x 256 shard of the
    # 64 x 1024 x 1024 mesh, all eight shards of the 16384^2 mesh (the cycle
    # entry) and of the maze mesh (the solve entry), all eight shards of
    # 256^3 on 2 x 4 (a 100-sweep cycle, a solve capped at 300).
    times = {
        "epic_sweep2d_chunk": (m["tick_ms"], m["tick_plain_ms"], m["tick_bound"]),
        "epic_sweep2d_solve": (m["in_place_ms"], m["solve_plain_ms"], m["solve_bound"]),
        "epic_sweep2d_solve_resident": (m["solve_ms"], m["solve_plain_ms"], m["solve_bound"]),
        "epic_sweep3d_chunk": (v["tick_kernel_ms"], v["tick_plain_ms"], v["bounds"]["tick"]),
        "epic_sweep3d_solve": (v["solve_kernel_ms"], v["solve_plain_ms"], v["bounds"]["solve"]),
        "epic_batched2d_chunk/resident": (b["chunk_ms"], b["chunk_plain_ms"], b["chunk_bound"]),
        "epic_batched2d_solve/resident": (b["solve_ms"], b["solve_plain_ms"], b["solve_bound"]),
        "epic_batched2d_chunk/cluster": bb["chunk"],
        "epic_batched2d_solve/cluster": bb["solve"],
        "epic_batched2d_chunk/tiled": bh["chunk"],
        "epic_batched2d_solve/tiled": bh["solve"],
        "epic_tile2d_chunk": big["chunk"],
        "epic_tile2d_cycle": big["cycle"],
        "epic_tile2d_solve": big["solve"],
        "epic_tile3d_chunk": wide3["chunk"],
        "epic_tile3d_cycle": wide3["cycle"],
        "epic_tile3d_solve": wide3["solve"],
        "epic_shard2d_chunk": mesh16["entry"],
        "epic_shard3d_chunk": m3w["entry"],
        "epic_resident2d_cycle": res["cycle"],
        "epic_resident2d_solve": res["solve"],
        "epic_resident3d_cycle": m3["cycle"],
        "epic_resident3d_solve": m3["solve"],
    }
    kernels = [dict(name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
                    launches=launches[name], max_abs_err=errs[name], ms=times[name][0],
                    plain_ms=times[name][1], bound_ms=times[name][2]["bound_ms"],
                    bound_by=times[name][2]["bound_by"],
                    issue_bound_ms=issue_bound_ms(times[name][2], big["sm_clock_mhz"]),
                    library_ms=None)
               for name in SOURCES]
    # K1 and K2 on umass and 2048^2 beside the maze's row: each its time,
    # plain time, bounds, error and the launches of its own run.
    demo_rows = {
        "epic_sweep2d_chunk": {"umass": (um, "tick_err", (um["tick_ms"], um["tick_plain_ms"],
                                                          um["tick_bound"])),
                               "grid2048": (g2, "tick_err", g2["tick"])},
        "epic_sweep2d_solve": {"umass": (um, "in_place_err", (um["in_place_ms"],
                                                              um["solve_plain_ms"],
                                                              um["solve_bound"])),
                               "grid2048": (g2, "in_place_err", g2["in_place"])},
        "epic_sweep2d_solve_resident": {"umass": (um, "solve_err", (um["solve_ms"],
                                                                    um["solve_plain_ms"],
                                                                    um["solve_bound"])),
                                        "grid2048": (g2, "solve_err", g2["solve"])},
    }
    shapes = {"umass": list(umass["img"].shape), "grid2048": [GRID_SIDE, GRID_SIDE]}
    for row in kernels:
        for key, (ph, err, (ms, plain_ms, bnd)) in demo_rows.get(row["name"], {}).items():
            row[key] = dict(shape=shapes[key], ms=ms, plain_ms=plain_ms, bound_ms=bnd["bound_ms"],
                            bound_by=bnd["bound_by"],
                            issue_bound_ms=issue_bound_ms(bnd, big["sm_clock_mhz"]),
                            max_abs_err=ph[err], launches=ph["launches"][row["name"]])
    # K7 on 256^3 ("cube"), beside the bytes one in-place pass a sweep
    # moves through HBM (9 B a cell a sweep, the bound of a kernel that
    # keeps nothing on chip between sweeps). Only there: the 3D session's
    # volume stays in the L2, which that bound does not see.
    k7 = {"epic_sweep3d_chunk": ("tick", "tick_sweeps"),
          "epic_sweep3d_solve": ("solve", "solve_iterations")}
    for row in kernels:
        if row["name"] in k7:
            key, sweeps = k7[row["name"]]
            bnd = z3["bounds"][key]
            row["cube"] = dict(shape=list(SIZE3D), ms=z3[f"{key}_kernel_ms"],
                               plain_ms=z3[f"{key}_plain_ms"], bound_ms=bnd["bound_ms"],
                               bound_by=bnd["bound_by"],
                               issue_bound_ms=issue_bound_ms(bnd, big["sm_clock_mhz"]),
                               pass_bytes_bound_ms=pass_bytes_bound_ms(SIZE3D, z3[sweeps]),
                               max_abs_err=z3[f"{key}_max_abs_err"])
    for row in kernels:
        if row["name"] in big3["rows"]:
            ms, plain_ms, bnd = big3["rows"][row["name"]]
            row["cube"] = dict(shape=list(SIZE3D), ms=ms, plain_ms=plain_ms,
                               bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(built["smi"], flush=True)
    # Every phase ran on the one card `dev`: the run drove one card, however
    # many the host has.
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1}}), flush=True)


if __name__ == "__main__":
    main()
