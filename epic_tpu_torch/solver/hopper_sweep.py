"""The 2D anytime stepper and solve on the CUDA kernels.

The counterpart of ``epic_tpu.solver.pallas_sweep``: ``update_n`` launches
``epic_sweep2d_chunk`` (for ``_multisweep_kernel``) and ``solve`` launches
one of K2's two entries for ``_solve_whole_kernel``, both in
``csrc/sweep2d.cu``: ``epic_sweep2d_solve_resident`` where the grid's tile
plan (:func:`plan_on`) fits the card's shared memory, else the in-place
``epic_sweep2d_solve`` (``solve_resident`` and ``solve_in_place`` run one
route each). A state on the CPU goes to the plain
version in :mod:`.core`; a state on a CUDA device goes to a kernel or raises.
There is no padding: the kernels take the unpadded grid, in place. The 3D
volume has its own wrapper, :mod:`.hopper_sweep3d`, which launches through
the helpers here.

In place: on CUDA the returned state holds the same ``u`` tensor as the
input, relaxed. Keep only the returned state (the JAX version donates it).

``launches`` counts each kernel's launches; nothing else changes it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from .. import constants as C
from ..grid import GridState
from . import _build, core

launches = {"epic_sweep2d_chunk": 0, "epic_sweep2d_solve": 0, "epic_sweep2d_solve_resident": 0}

# The resident route's halo depth K, the most sweeps between two grid
# barriers (kDepth of csrc/sweep2d.cu), and the static shared memory of its
# block (the delta reduction's 16 floats), which the opt-in limit must also
# hold. K was chosen by ``tile_probe --resident`` on an H100 80GB HBM3 at
# 700 W, cold solves to convergence, each K on its own plan (ms, the mean of
# two turns alike to 0.6%): maze (49,301 sweeps) K = 2 98.5, K = 4 73.1,
# K = 8 61.9, in place 121.2; umass (32,701) 75.2, 55.1, 46.6, in place 83.4.
RESIDENT_DEPTH = 8
RESIDENT_STATIC_SMEM = 64

_WRAPPER = {2: "hopper_sweep (solver.solve_grid)", 3: "hopper_sweep3d (solver.solve_volume)"}


def _check_cuda_state(state: GridState, ndim: int = 2) -> None:
    """What the kernels take: a contiguous float32 ``u`` of rank ``ndim`` and
    a bool ``locked`` of its shape, and the scalars as 0-d tensors, all on
    one CUDA device."""
    u, locked = state.u, state.locked
    if u.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got one on {u.device}")
    if u.ndim != ndim:
        where = _WRAPPER.get(u.ndim, "the plain core (solver.solve_grid / update_grid), which "
                                     "has no kernel for rank >= 4")
        raise NotImplementedError(
            f"these CUDA kernels take a {ndim}D grid; a {u.ndim}D grid on the card "
            f"goes to {where}")
    if u.dtype != torch.float32 or locked.dtype != torch.bool:
        raise TypeError(f"need float32 u and bool locked, got {u.dtype} and {locked.dtype}")
    if locked.shape != u.shape:
        raise ValueError(f"locked shape {tuple(locked.shape)} != u shape {tuple(u.shape)}")
    if not (u.is_contiguous() and locked.is_contiguous()):
        raise ValueError("u and locked must be contiguous")
    for name, t, dtype in (("iteration", state.iteration, torch.int32),
                           ("epsilon", state.epsilon, torch.float32)):
        if t.dtype != dtype or t.ndim != 0:
            raise TypeError(f"{name} must be a 0-d {dtype} tensor")
    for t in (locked, state.iteration, state.epsilon):
        if t.device != u.device:
            raise ValueError(f"state tensors on {t.device} and {u.device}")


def _iteration(iteration, device: torch.device) -> torch.Tensor:
    """The start iteration as the 0-d int32 device tensor the kernel reads
    (an int is filled in on the device: no copy from the host, no sync)."""
    if not isinstance(iteration, torch.Tensor):
        return torch.full((), int(iteration), dtype=torch.int32, device=device)
    if iteration.dtype != torch.int32 or iteration.ndim != 0:
        raise TypeError(f"iteration must be a 0-d int32 tensor, got {iteration.dtype} "
                        f"of shape {tuple(iteration.shape)}")
    if iteration.device != device:
        raise ValueError(f"iteration on {iteration.device}, u on {device}")
    return iteration


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch_chunk(state: GridState, num_steps: int, entry: str, counts: dict) -> GridState:
    """Launch the chunk entry ``entry`` (``u, locked, *shape, it, n, delta,
    stream, device``) on a checked CUDA state and count it in ``counts``.
    The kernel reads the start iteration from the state's device scalar, so
    a tick never syncs."""
    lib = _build.load()
    dev = state.u.device
    delta = torch.zeros((), dtype=torch.float32, device=dev)
    err = getattr(lib, entry)(
        state.u.data_ptr(), state.locked.data_ptr(), *state.u.shape,
        state.iteration.data_ptr(), num_steps, delta.data_ptr(),
        _stream(dev), dev.index)
    _build.check(err, entry)
    counts[entry] += 1
    return dataclasses.replace(
        state,
        iteration=state.iteration + num_steps,
        delta=delta,
        converged=(delta < state.epsilon) if num_steps == 1
        else torch.zeros((), dtype=torch.bool, device=dev),
    )


def launch_solve(state: GridState, stagger: int, max_iterations: int, entry: str,
                 counts: dict, *extra) -> GridState:
    """Launch the solve entry ``entry`` (``u, locked, *shape, eps, m_max,
    max_iterations, stagger, acc, it, delta, done, *extra, stream,
    device``) on a checked CUDA state and count it in ``counts``."""
    lib = _build.load()
    dev = state.u.device
    acc = torch.zeros(2, dtype=torch.int32, device=dev)
    iteration = torch.empty((), dtype=torch.int32, device=dev)
    delta = torch.empty((), dtype=torch.float32, device=dev)
    done = torch.empty((), dtype=torch.int32, device=dev)
    err = getattr(lib, entry)(
        state.u.data_ptr(), state.locked.data_ptr(), *state.u.shape,
        state.epsilon.data_ptr(), max(state.u.shape),
        min(max_iterations, 2**31 - 1 - stagger), stagger,
        acc.data_ptr(), iteration.data_ptr(), delta.data_ptr(), done.data_ptr(), *extra,
        _stream(dev), dev.index)
    _build.check(err, entry)
    counts[entry] += 1
    return dataclasses.replace(
        state, iteration=iteration, delta=delta, converged=done != 0)


class ResidentPlan(NamedTuple):
    """A cut of an H x W grid into ``tiles[0] x tiles[1]`` tiles of ``tile
    = (TH, TW)`` cells (the last row and column of tiles ragged), one block
    an SM, each holding its tile with a ``RESIDENT_DEPTH``-deep halo in
    ``smem_bytes`` of dynamic shared memory."""
    tile: tuple[int, int]
    tiles: tuple[int, int]
    smem_bytes: int

    @property
    def n_tiles(self) -> int:
        return self.tiles[0] * self.tiles[1]


def resident_smem_bytes(tile, k: int) -> int:
    """Dynamic shared memory of a resident block (``resident::smem_bytes``):
    each of the extended tile's ``TH + 2k`` rows holds two class rows of
    ``TW / 2 + k`` floats and their frozen flags as bits in 32-bit words."""
    th, tw = tile
    p = tw // 2 + k
    return (th + 2 * k) * 2 * (4 * p + 4 * -(-p // 32))


@functools.lru_cache(maxsize=256)
def resident_plan(h: int, w: int, sms: int, smem_limit: int, k: int) -> ResidentPlan | None:
    """The resident route's tiles for an ``h x w`` grid on a card of ``sms``
    SMs whose block may hold ``smem_limit`` bytes of dynamic shared memory,
    with a ``k``-deep halo, or None where no cut fits. At most one tile an
    SM, ``TW`` even (the class-split rows); among the cuts that fit, the one
    whose extended tile ``(TH + 2k) x (TW + 2k)`` is smallest, then the one
    with fewer tiles. For each count of tile rows the least ``TH`` and the
    least even ``TW`` whose columns of tiles fit the SMs left are the only
    candidates. On an H100 (132 SMs, 232,448 bytes) at k = 8 the maze (482²)
    takes 12 x 11 tiles of 41 x 44, umass (310 x 940) 6 x 22 of 52 x 44,
    2048² 12 x 11 of 171 x 188; the largest square that fits is 2530² (12 x
    11 of 211 x 230)."""
    best = None
    for rows in range(1, min(h, sms) + 1):
        th = -(-h // rows)
        ny = -(-h // th)
        tw = max(2, 2 * -(-w // (2 * (sms // ny))))
        nx = -(-w // tw)
        smem = resident_smem_bytes((th, tw), k)
        if smem > smem_limit:
            continue
        key = ((th + 2 * k) * (tw + 2 * k), ny * nx)
        if best is None or key < best[0]:
            best = key, ResidentPlan((th, tw), (ny, nx), smem)
    return None if best is None else best[1]


def plan_on(shape, device) -> ResidentPlan | None:
    """:func:`resident_plan` for a 2D grid of ``shape`` on the CUDA
    ``device`` at ``RESIDENT_DEPTH``, and the routing rule of :func:`solve`:
    a grid goes to the resident entry wherever this plan is not None, and to
    the in-place K2 otherwise. On an H100 (``tile_probe --resident``, 700 W;
    seeded squares, solves capped at 2,000 sweeps, in place against
    resident, ms, the mean of two turns) the resident entry led at every
    size measured: 2048² 26.9 against 18.5, and 2530², the largest square
    whose plan fits, 42.6 against 24.3; 2531² runs in place, 41.6. The demo
    maps: above (``RESIDENT_DEPTH``). Past two thirds of the L2 (about
    2644²) ``solver.solve_grid`` sends a grid to the tile kernels before
    this rule is asked."""
    props = torch.cuda.get_device_properties(device)
    return resident_plan(*shape, props.multi_processor_count,
                         props.shared_memory_per_block_optin - RESIDENT_STATIC_SMEM,
                         RESIDENT_DEPTH)


def update_n(state: GridState, num_steps: int) -> GridState:
    """``num_steps`` sweeps, delta from the first; semantics of
    :func:`epic_tpu_torch.solver.core.update_n`."""
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    if state.u.device.type == "cpu":
        return core.update_n(state, num_steps)
    _check_cuda_state(state)
    return launch_chunk(state, num_steps, "epic_sweep2d_chunk", launches)


def solve(
    state: GridState,
    stagger: int = C.DEFAULT_STAGGER,
    max_iterations: int = 1_000_000,
) -> GridState:
    """Relax to convergence in one launch; protocol of
    :func:`epic_tpu_torch.solver.core.solve` (iteration reset to 0, checks
    every ``stagger`` sweeps, exit only right after a passing check with
    ``iteration >= max(H, W)``). The host reads nothing until the caller
    reads the returned scalars."""
    if stagger < 1:
        raise ValueError(f"stagger must be >= 1, got {stagger}")
    if state.u.device.type == "cpu":
        return core.solve(state, stagger, max_iterations)
    _check_cuda_state(state)
    plan = plan_on(state.u.shape, state.u.device)
    if plan is not None:
        return _launch_resident(state, stagger, max_iterations, plan)
    return launch_solve(state, stagger, max_iterations, "epic_sweep2d_solve", launches)


def solve_in_place(state: GridState, stagger: int = C.DEFAULT_STAGGER,
                   max_iterations: int = 1_000_000) -> GridState:
    """:func:`solve` on the in-place entry ``epic_sweep2d_solve``, whatever
    the grid: a grid barrier every sweep."""
    if stagger < 1:
        raise ValueError(f"stagger must be >= 1, got {stagger}")
    _check_cuda_state(state)
    return launch_solve(state, stagger, max_iterations, "epic_sweep2d_solve", launches)


def solve_resident(state: GridState, stagger: int = C.DEFAULT_STAGGER,
                   max_iterations: int = 1_000_000) -> GridState:
    """:func:`solve` on the resident entry ``epic_sweep2d_solve_resident``:
    each block keeps a tile of :func:`plan_on`'s plan in shared memory for
    the whole solve and meets the others at a grid barrier once every
    ``RESIDENT_DEPTH`` sweeps at most. Raises where the plan does not fit."""
    if stagger < 1:
        raise ValueError(f"stagger must be >= 1, got {stagger}")
    _check_cuda_state(state)
    plan = plan_on(state.u.shape, state.u.device)
    if plan is None:
        raise ValueError(f"no resident tile plan of a {tuple(state.u.shape)} grid fits "
                         f"{state.u.device}'s shared memory")
    return _launch_resident(state, stagger, max_iterations, plan)


def _launch_resident(state: GridState, stagger: int, max_iterations: int,
                     plan: ResidentPlan) -> GridState:
    scratch = torch.empty((2, *state.u.shape), dtype=torch.float32, device=state.u.device)
    return launch_solve(state, stagger, max_iterations, "epic_sweep2d_solve_resident", launches,
                        scratch.data_ptr(), *plan.tile)
