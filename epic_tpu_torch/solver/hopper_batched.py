"""Batched scenario solves on the CUDA kernels.

The counterpart of ``epic_tpu.solver.pallas_batched``: ``update_n_batch``
launches ``epic_batched2d_chunk`` (for ``_block_kernel``), the host-driven
``solve_batch`` drives it through the lockstep protocol, and
``solve_batch_device`` runs the whole protocol in one launch of
``epic_batched2d_solve`` (for ``_block_kernel_gated`` and
``_solve_collage_device``), from ``csrc/batched2d.cu``; on the tiled route
the two launches are ``epic_lanes2d_chunk`` and ``epic_lanes2d_solve`` of
``csrc/tile2d.cu`` instead.
``make_goal_batch`` and ``solve_batch_goals`` build B lanes on the device
from one base map and index arrays.

The batch is the contiguous ``[B, H, W]`` tensor, not the TPU's collage of
VMEM-sized blocks; any height works. A batch on the CPU goes to the plain
version in :mod:`.batched`; a batch on a CUDA device goes to the kernels or
raises.

Three routes, one rule. A lane whose layout (:func:`lane_smem_bytes`) fits
the device's opt-in shared memory a block (:func:`lane_resident`; lanes up
to about 236 x 236 on an H100) takes the resident route: a block a lane,
which stays in shared memory for the whole chunk or the whole solve. A
larger lane that a thread-block cluster can hold (:func:`lane_cluster`;
up to 930 x 930 on an H100, clusters of 16) takes the cluster route: a
cluster of C blocks a lane, each block a band of its rows
(:func:`bands`, :func:`cluster_smem_bytes`), also for the whole chunk or
solve; a batch of few lanes gets wider clusters. Lanes beyond any
cluster take the tiled route: ``csrc/tile2d.cu``'s
temporally blocked tile pass over every (lane, tile) pair, K sweeps
(``DEPTH``) a trip through memory, ping-pong through a twin batch (and the
solve's check through a u1 batch), scratch kept for the last (device,
shape) as ``_tiles.scratch_for`` keeps it; its plain model is
``tiled.lanes_update_n`` / ``tiled.lanes_solve``. The wrapper names the
other routes to ``csrc/batched2d.cu``'s entries by the blocks a lane takes
(1 resident, C a cluster); an entry refuses a lane that does not fit;
nothing retries.

In place: on CUDA the kernels relax ``u`` in place and the returned ``u``
is the same tensor; keep only what a call returns. The solves return
``(u, iterations int32[B], deltas float32[B], converged bool[B])`` as device
tensors; ``solve_batch_device`` does not wait for the card.

``launches`` counts each kernel's launches and ``routes`` the route of each
launch; nothing else changes them. The spans of :mod:`..profiling` name the
same route: ``solve.batched.<route>`` around ``solve_batch_device``'s launch,
``tick.batched.<route>`` around each chunk launch (``core`` for a batch on
the CPU), and ``batch.make_goals`` around ``make_goal_batch``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import constants as C
from .. import profiling
from . import _build, batched, hopper_tile2d
from ._tiles import scratch_for
from .hopper_sweep import _iteration, _stream

# K12's and K13's launches on every route, and each launch's route.
launches = {"epic_batched2d_chunk": 0, "epic_batched2d_solve": 0}
routes = {"resident": 0, "cluster": 0, "tiled": 0}
_SOLVE_SPANS = {r: f"solve.batched.{r}" for r in (*routes, "core")}
_TICK_SPANS = {r: f"tick.batched.{r}" for r in (*routes, "core")}
# The tiled route's halo depth: the sweeps a chunk runs on a trip through
# memory (the grid tiles' default; `tile_probe --batch` times 8, 16, 24).
DEPTH = hopper_tile2d.DEFAULT_DEPTH
_scratch: dict = {}   # the tiled route's twin and u1 batches

# csrc/batched2d.cu's resident layout: the delta words after the lane.
DELTA_SLOTS = 3
# The cluster sizes lane_cluster takes, the smallest whose band fits. Measured
# with `tile_probe --batch` on an H100 80GB HBM3 at 700 W (PERF.md): at 256
# lanes the smallest fitting size of these was the fastest or within 3% of
# it from 240^2 to 930^2, while clusters of 6 lost 22% to clusters of 8 at
# 512^2 (blocks of a cluster share a GPC, whose SMs clusters of 2, 4, 8 and
# 16 fill evenly).
CLUSTER_SIZES = (2, 3, 4, 8, 16)


def lane_smem_bytes(h: int, w: int) -> int:
    """The resident route's shared memory for an ``h x w`` lane, as
    ``csrc/batched2d.cu`` lays it out (``epic_batched2d_smem_bytes``): u of
    each class in ``h`` rows of ``(w + 1) // 2`` floats, the frozen bits of
    each class in ``h`` rows of 32-bit words, and the delta words."""
    p = (w + 1) // 2
    return 4 * (2 * h * p + 2 * h * ((p + 31) // 32) + DELTA_SLOTS)


def lane_resident(h: int, w: int, device: torch.device) -> bool:
    """Whether ``h x w`` lanes take the resident route on ``device``: their
    layout fits its opt-in shared memory a block."""
    limit = torch.cuda.get_device_properties(device).shared_memory_per_block_optin
    return h >= 1 and w >= 1 and lane_smem_bytes(h, w) <= limit


def bands(h: int, c: int) -> list[tuple[int, int]]:
    """Each block's band of an ``h``-row lane in a cluster of ``c``, as
    ``csrc/batched2d.cu``'s ``Band`` cuts the ``h - 2`` interior rows: its
    first interior row and its row count, ``n // c`` or ``n // c + 1``
    rows, the longer first (a rank past ``n`` gets none)."""
    n = max(h - 2, 0)
    q, rem = divmod(n, c)
    return [(1 + r * q + min(r, rem), q + (r < rem)) for r in range(c)]


def cluster_smem_bytes(h: int, w: int, c: int) -> int:
    """The cluster route's shared memory a block for ``h x w`` lanes in
    clusters of ``c`` (``epic_batched2d_cluster_smem_bytes``): the resident
    layout of the largest band and its two halo rows."""
    return lane_smem_bytes(bands(h, c)[0][1] + 2, w)


_largest_cluster: dict[int, int] = {}


def max_cluster(device: torch.device) -> int:
    """The largest cluster (2..16, or 0) that ``device`` co-schedules for
    the cluster kernels with its whole opt-in shared memory a block, as the
    occupancy query answers it (``epic_batched2d_max_cluster``); asked once a
    device."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _largest_cluster:
        largest = ctypes.c_int(0)
        _build.check(_build.load().epic_batched2d_max_cluster(index, ctypes.byref(largest)),
                     "epic_batched2d_max_cluster")
        _largest_cluster[index] = largest.value
    return _largest_cluster[index]


def lane_cluster(h: int, w: int, device: torch.device, lanes: int | None = None) -> int:
    """The cluster size for ``h x w`` lanes on ``device``: 0 where
    :func:`lane_resident` admits them, else the smallest of
    ``CLUSTER_SIZES`` up to :func:`max_cluster` whose largest band fits the
    device's opt-in shared memory a block; 0 (the tiled route) if none
    does. Given the batch's ``lanes``, the largest of those sizes whose
    clusters fill at most half the device's SMs (2 x lanes x C <= SMs)
    where one does: a few lanes (a planner's few goals on a large map) get
    wider clusters, so that more SMs sweep them. Measured with `tile_probe
    --batch` at 8 to 256 lanes of 240^2 to 930^2 on an H100 80GB HBM3 at
    700 W (PERF.md), a 100-sweep chunk: the widened cluster beat the
    smallest fitting one and the tiles at 8 and 16 lanes of 240^2 to 384^2
    (8 x 384^2: 0.544 ms at C = 8, 1.129 at C = 3, 0.775 tiled); the
    rule's cluster is within 1% of the tiles or faster at every batch
    measured but 16 x 640^2 (2.47 against 2.24 ms tiled), 8 x 900^2 and
    8 x 930^2 (2.95 against 2.24)."""
    if h < 3 or w < 3 or lane_resident(h, w, device):
        return 0
    props = torch.cuda.get_device_properties(device)
    largest = max_cluster(device)
    fits = [c for c in CLUSTER_SIZES
            if c <= largest and cluster_smem_bytes(h, w, c) <= props.shared_memory_per_block_optin]
    if not fits:
        return 0
    wide = [c for c in fits if lanes and 2 * lanes * c <= props.multi_processor_count]
    return wide[-1] if wide else fits[0]


def _blocks(b: int, h: int, w: int, device: torch.device) -> tuple[int, str]:
    """The blocks a lane of a ``b``-lane batch takes, as the batched2d.cu
    entries name the route (1 resident, C >= 2 a cluster of C; 0 for the
    tiled route, which the tile2d.cu entries take), and the route's name."""
    if lane_resident(h, w, device):
        return 1, "resident"
    c = lane_cluster(h, w, device, b)
    return (c, "cluster") if c else (0, "tiled")


def _depth(device: torch.device) -> int:
    """:data:`DEPTH`, checked against the card's shared memory a block."""
    hopper_tile2d.check_depth(DEPTH, torch.cuda.get_device_properties(device)
                              .shared_memory_per_block_optin)
    return DEPTH


def _check_cuda_batch(u: torch.Tensor, locked: torch.Tensor) -> None:
    """What the kernels take: a contiguous float32 ``u [B, H, W]`` and a bool
    ``locked`` of its shape, on one CUDA device."""
    if u.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got one on {u.device}")
    if u.ndim != 3:
        raise ValueError(f"a batch is [B, H, W]; got a tensor of rank {u.ndim}")
    if u.dtype != torch.float32 or locked.dtype != torch.bool:
        raise TypeError(f"need float32 u and bool locked, got {u.dtype} and {locked.dtype}")
    if locked.shape != u.shape:
        raise ValueError(f"locked shape {tuple(locked.shape)} != u shape {tuple(u.shape)}")
    if not (u.is_contiguous() and locked.is_contiguous()):
        raise ValueError("u and locked must be contiguous")
    if locked.device != u.device:
        raise ValueError(f"locked on {locked.device}, u on {u.device}")


def _lane_flags(active: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """A bool ``[B]`` on u's device, as the uint8 flags the kernel reads."""
    if active.dtype != torch.bool or active.shape != u.shape[:1]:
        raise TypeError(f"active must be bool [{u.shape[0]}], got {active.dtype} "
                        f"{tuple(active.shape)}")
    if active.device != u.device:
        raise ValueError(f"active on {active.device}, u on {u.device}")
    return active.to(torch.uint8).contiguous()


def _launch_chunk(u: torch.Tensor, locked: torch.Tensor, iteration, num_steps: int,
                  active: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of K12 on a checked batch, on the route the rule picks:
    ``epic_batched2d_chunk``, or ``epic_lanes2d_chunk`` on the tiled route."""
    dev = u.device
    it = _iteration(iteration, dev)
    flags = None if active is None else _lane_flags(active, u)
    blocks, route = _blocks(*u.shape, dev)
    flag_ptr = None if flags is None else flags.data_ptr()
    # The tiled route max-accumulates into zeroed slots; the others write each.
    delta = (torch.empty if blocks else torch.zeros)(u.shape[0], dtype=torch.float32, device=dev)
    with profiling.span(_TICK_SPANS[route]):
        if route == "tiled":
            err = _build.load().epic_lanes2d_chunk(
                u.data_ptr(), scratch_for(_scratch, u, "twin").data_ptr(), locked.data_ptr(),
                *u.shape, it.data_ptr(), num_steps, flag_ptr, delta.data_ptr(), _depth(dev),
                _stream(dev), dev.index)
            _build.check(err, "epic_lanes2d_chunk")
        else:
            err = _build.load().epic_batched2d_chunk(
                u.data_ptr(), locked.data_ptr(), *u.shape, it.data_ptr(), num_steps, flag_ptr,
                delta.data_ptr(), blocks, _stream(dev), dev.index)
            _build.check(err, "epic_batched2d_chunk")
    launches["epic_batched2d_chunk"] += 1
    routes[route] += 1
    return u, delta


def update_n_batch(u: torch.Tensor, locked: torch.Tensor, iteration, num_steps: int,
                   active: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``num_steps`` sweeps of every lane from ``iteration`` (an int or a 0-d
    int32 tensor on u's device), per-lane delta of sweep 0; lanes where the
    optional bool ``active [B]`` is False are left untouched with delta 0.
    The counterpart of ``sweep_chunk_batch``, with one delta a lane (the
    TPU's one a collage block is an artifact of the collage). Returns
    ``(u, delta [B])``."""
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    if u.device.type == "cpu":
        with profiling.span(_TICK_SPANS["core"]):
            return batched.update_n_batch(u, locked, iteration, num_steps, active)
    _check_cuda_batch(u, locked)
    return _launch_chunk(u, locked, iteration, num_steps, active)


def solve_batch(u: torch.Tensor, locked: torch.Tensor, epsilon=C.DEFAULT_EPSILON,
                stagger: int = C.DEFAULT_STAGGER, max_iterations: int = 1_000_000):
    """The host-driven lockstep solve (``pallas_batched.solve_batch``,
    :567-638): per cycle one checked chunk launch over the active lanes and
    one launch of ``stagger - 1`` sweeps over those still active; retired
    lanes are masked by the kernel's active flags. The host reads the
    verdicts once a cycle, once an exit is possible. ``epsilon`` is a scalar
    or one value a lane."""
    if stagger < 1:
        raise ValueError(f"stagger must be >= 1, got {stagger}")
    if u.device.type == "cpu":
        return batched.solve_batch(u, locked, epsilon, stagger, max_iterations)
    _check_cuda_batch(u, locked)
    return batched.lockstep(u, locked, epsilon, stagger, max_iterations, _launch_chunk)


def solve_batch_device(u: torch.Tensor, locked: torch.Tensor, epsilon=C.DEFAULT_EPSILON,
                       stagger: int = C.DEFAULT_STAGGER, max_iterations: int = 1_000_000):
    """The whole lockstep protocol in one launch (``pallas_batched.
    solve_batch_device``, :362-417): checks, per-lane retirement and the
    exit decision run on the card, and the host reads nothing. Same results
    as :func:`solve_batch`, bit for bit."""
    if stagger < 1:
        raise ValueError(f"stagger must be >= 1, got {stagger}")
    if u.device.type == "cpu":
        with profiling.span(_SOLVE_SPANS["core"]):
            return batched.solve_batch(u, locked, epsilon, stagger, max_iterations)
    _check_cuda_batch(u, locked)
    b, h, w = u.shape
    dev = u.device
    eps = batched.epsilon_lanes(epsilon, b, dev)
    retired = torch.zeros(b, dtype=torch.uint8, device=dev)
    iters = torch.zeros(b, dtype=torch.int32, device=dev)
    deltas = eps + 1.0
    blocks, route = _blocks(b, h, w, dev)
    cap = min(max_iterations, 2**31 - 1 - stagger)
    with profiling.span(_SOLVE_SPANS[route]):
        if route == "tiled":
            # The protocol's scratch: two [B] delta halves and two lane counts.
            acc = torch.zeros(2 * b, dtype=torch.int32, device=dev)
            count = torch.zeros(2, dtype=torch.int32, device=dev)
            err = _build.load().epic_lanes2d_solve(
                u.data_ptr(), scratch_for(_scratch, u, "twin").data_ptr(),
                scratch_for(_scratch, u, "u1").data_ptr(), locked.data_ptr(), b, h, w,
                eps.data_ptr(), max(h, w), cap, stagger, acc.data_ptr(), count.data_ptr(),
                retired.data_ptr(), iters.data_ptr(), deltas.data_ptr(), _depth(dev),
                _stream(dev), dev.index)
            _build.check(err, "epic_lanes2d_solve")
        else:
            err = _build.load().epic_batched2d_solve(
                u.data_ptr(), locked.data_ptr(), b, h, w, eps.data_ptr(), max(h, w), cap,
                stagger, retired.data_ptr(), iters.data_ptr(), deltas.data_ptr(), blocks,
                _stream(dev), dev.index)
            _build.check(err, "epic_batched2d_solve")
    launches["epic_batched2d_solve"] += 1
    routes[route] += 1
    return u, iters, deltas, retired.bool()


def _coords(xy, device: torch.device) -> torch.Tensor:
    xy = torch.as_tensor(xy, device=device).long()
    if xy.ndim != 3 or xy.shape[-1] != 2:
        raise ValueError(f"coordinates must be [B, G, 2] (x, y) pairs, got {tuple(xy.shape)}")
    return xy


def make_goal_batch(base_u, base_locked, goal_xy, obstacle_xy=None, *,
                    device: torch.device | str):
    """B lanes that share one base grid, each with its own goal cells and
    optional extra obstacle cells, built on ``device`` (``pallas_batched.
    make_goal_batch`` over ``_goal_batch_arrays``, :444-525): one ``H x W``
    map and index arrays cross to the card instead of B grids.

    ``goal_xy`` is int ``[B, G, 2]`` of ``(x, y)`` cells, ragged sets padded
    with ``(-1, -1)``; ``obstacle_xy`` an optional ``[B, K, 2]``. Every lane's
    ring outside ``1..H-2 x 1..W-2`` is locked. Obstacles (u = -1e6, locked)
    are scattered before goals (u = 0, locked), so a goal wins a collision; a
    negative coordinate or one beyond ``H x W`` is dropped. Unlike
    :func:`.batched.batch_from_goal_sets`, a goal on a base obstacle becomes a
    goal. Returns contiguous ``(u float32[B, H, W], locked bool[B, H, W])``."""
    with profiling.span("batch.make_goals"):
        device = torch.device(device)
        base_u = torch.as_tensor(base_u, dtype=torch.float32, device=device)
        base_locked = torch.as_tensor(base_locked, device=device).bool()
        if base_u.ndim != 2 or base_locked.shape != base_u.shape:
            raise ValueError(f"need one 2D base map, got u {tuple(base_u.shape)} and "
                             f"locked {tuple(base_locked.shape)}")
        h, w = base_u.shape
        goals = _coords(goal_xy, device)
        b = goals.shape[0]
        ring = torch.ones((h, w), dtype=torch.bool, device=device)
        ring[1:-1, 1:-1] = False
        n = b * h * w
        # One spare cell past the batch takes every dropped coordinate (the JAX
        # builder's out-of-bounds sentinel), so no mask is read on the host.
        u = torch.empty(n + 1, dtype=torch.float32, device=device)
        locked = torch.empty(n + 1, dtype=torch.bool, device=device)
        u[:n].view(b, h, w).copy_(base_u.expand(b, h, w))
        locked[:n].view(b, h, w).copy_((base_locked | ring).expand(b, h, w))

        def scatter(xy: torch.Tensor, value: float) -> None:
            if xy.shape[0] != b:
                raise ValueError(f"{xy.shape[0]} lanes of coordinates for {b} lanes of goals")
            x, y = xy[..., 0], xy[..., 1]
            lane = torch.arange(b, device=device).view(b, 1)
            ok = (x >= 0) & (y >= 0) & (x < w) & (y < h)
            flat = torch.where(ok, (lane * h + y) * w + x, n).reshape(-1)
            u.index_fill_(0, flat, value)
            locked.index_fill_(0, flat, True)

        if obstacle_xy is not None:
            scatter(_coords(obstacle_xy, device), float(C.LOG_SPACE_OBSTACLE))
        scatter(goals, float(C.LOG_SPACE_GOAL))
        return u[:n].view(b, h, w), locked[:n].view(b, h, w)


def solve_batch_goals(base_u, base_locked, goal_xy, obstacle_xy=None,
                      epsilon=C.DEFAULT_EPSILON, stagger: int = C.DEFAULT_STAGGER,
                      max_iterations: int = 1_000_000, *, device: torch.device | str):
    """Solve B distinct-goal lanes on one shared base grid:
    :func:`make_goal_batch`, then :func:`solve_batch_device` (one launch on
    the card; the plain version on the CPU). Returns ``(u, iterations,
    deltas, converged)``."""
    u, locked = make_goal_batch(base_u, base_locked, goal_xy, obstacle_xy, device=device)
    return solve_batch_device(u, locked, epsilon, stagger, max_iterations)
