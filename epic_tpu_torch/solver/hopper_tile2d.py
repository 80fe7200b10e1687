"""Big and wide 2D grids on the temporally blocked CUDA tile kernels.

The counterpart of ``epic_tpu.solver.pallas_biggrid`` and
``pallas_tiled2d`` (with the 2D cycles of ``pallas_cycle``): ``update_n``
runs a tick as one launch of ``epic_tile2d_cycle`` (K4/K6), with an odd
chunk count's last chunk through ``epic_tile2d_chunk`` (K3/K5, the TPU's
remainder chunk) and copied back; ``solve`` runs the whole protocol in one
launch of ``epic_tile2d_solve``; ``solve_segments`` is a host loop of such
launches, each resuming where the last stopped. All from
``csrc/tile2d.cu``. ``sweep_chunk`` and ``sweep_cycle`` expose the chunk
and cycle entries themselves. A grid on the CPU goes to the plain version in
:mod:`.tiled`; a grid on a CUDA device goes to the kernels or raises.

Routing (:func:`use_tiles`): a grid goes here when its ``u`` and ``locked``
(5 B a cell) exceed three quarters of the card's L2; below that the
in-place kernels of :mod:`.hopper_sweep` run it from L2 faster. On an H100
(50 MB of L2) the measured crossover lies between 2560² (32.8 MB, where the
in-place kernel is 20% faster) and 2816² (39.6 MB, where the tiles are 2%
faster): ``tile_probe.py``, PERF.md.

In place, like every other wrapper: on CUDA the returned state holds the
caller's ``u`` tensor, relaxed. The chunks ping-pong through a twin grid
(and a solve's check writes a u1 grid), scratch that this module owns,
allocated with ``torch.empty`` when first needed for the last (device,
shape) seen: a tick takes only the twin.

``launches`` counts each kernel's launches; nothing else changes it.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import constants as C
from ..grid import GridState
from . import _build, tiled
from .hopper_sweep import _check_cuda_state, _iteration, _stream

launches = {"epic_tile2d_chunk": 0, "epic_tile2d_cycle": 0, "epic_tile2d_solve": 0}

DEFAULT_DEPTH = 16        # SolverConfig.tile_depth's default: sweeps per trip to memory
# The centre a block owns, TH x TW: kTH x kTW of csrc/tile2d.cu, fixed there
# (with 512 threads a block) as the fastest shape measured at 4096² and 8192²
# on an H100 (PERF.md). The plain version takes any tile; it is held to the
# kernels at this one.
TILE = (64, 128)

_scratch: dict = {}


def smem_bytes(k: int) -> int:
    """Dynamic shared memory of one block: u (4 B) and a frozen byte for
    each cell of the halo-extended tile."""
    th, tw = TILE
    return (th + 2 * k) * (tw + 2 * k) * 5


def check_depth(k: int, smem_limit: int) -> None:
    """Refuse a halo depth the kernels cannot take: below 1, or one whose
    extended tile exceeds ``smem_limit``, the shared memory a block may opt
    into."""
    if k < 1:
        raise ValueError(f"tile_depth must be >= 1, got {k}")
    if smem_bytes(k) > smem_limit:
        raise ValueError(
            f"tile_depth {k} needs {smem_bytes(k)} B of shared memory for a "
            f"{TILE[0]}x{TILE[1]} tile; a block has {smem_limit}")


def past_crossover(shape, l2_bytes: int) -> bool:
    """The routing rule: ``u`` (4 B) and ``locked`` (1 B) of a 2D grid
    exceed three quarters of ``l2_bytes``, where the tiles start to win."""
    h, w = shape
    return 4 * 5 * h * w > 3 * l2_bytes


def use_tiles(shape, device) -> bool:
    """Whether a 2D grid of ``shape`` on ``device`` runs on the tile
    kernels: on a CUDA device, past the crossover of its L2
    (:func:`past_crossover`). A grid on the CPU never does (it runs
    ``core``)."""
    device = torch.device(device)
    if device.type != "cuda" or len(shape) != 2:
        return False
    return past_crossover(shape, torch.cuda.get_device_properties(device).L2_cache_size)


def _scratch_for(u: torch.Tensor, name: str) -> torch.Tensor:
    """The scratch grid ``name`` ("twin" or "u1") for u's device and shape,
    kept for the last (device, shape) only."""
    key = (u.device, tuple(u.shape))
    if _scratch.get("key") != key:
        _scratch.clear()
        _scratch["key"] = key
    if name not in _scratch:
        _scratch[name] = torch.empty_like(u)
    return _scratch[name]


def _check_grid(u: torch.Tensor, locked: torch.Tensor, *others: torch.Tensor) -> None:
    """What the entries take: contiguous float32 ``[H, W]`` grids and a bool
    ``locked`` of their shape, on one CUDA device, no grid twice."""
    if u.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got one on {u.device}")
    for t in (u, *others):
        if t.dtype != torch.float32:
            raise TypeError(f"need float32 grids, got {t.dtype}")
        if t.ndim != 2 or t.shape != u.shape:
            raise ValueError(f"need [H, W] grids of one shape, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("grids must be contiguous")
        if t.device != u.device:
            raise ValueError(f"grids on {t.device} and {u.device}")
    if locked.dtype != torch.bool:
        raise TypeError(f"need a bool locked, got {locked.dtype}")
    if locked.shape != u.shape or not locked.is_contiguous() or locked.device != u.device:
        raise ValueError("locked must be a contiguous tensor of u's shape on u's device")
    ptrs = [t.data_ptr() for t in (u, *others)]
    if len(set(ptrs)) != len(ptrs):
        raise ValueError("source and destination must be distinct tensors (the chunks "
                         "ping-pong: neighbouring tiles read the source's halo)")


def _depth(k: int, device: torch.device) -> int:
    """``k``, checked against the card's shared memory a block may opt into."""
    check_depth(k, torch.cuda.get_device_properties(device).shared_memory_per_block_optin)
    return k


def _launch_chunk(src, dst, u1, locked, it: torch.Tensor, t_off: int, ns: int,
                  k: int) -> torch.Tensor:
    dev = src.device
    delta = torch.zeros((), dtype=torch.float32, device=dev)
    err = _build.load().epic_tile2d_chunk(
        src.data_ptr(), dst.data_ptr(), None if u1 is None else u1.data_ptr(),
        locked.data_ptr(), *src.shape, it.data_ptr(), t_off, ns, delta.data_ptr(),
        _depth(k, dev), _stream(dev), dev.index)
    _build.check(err, "epic_tile2d_chunk")
    launches["epic_tile2d_chunk"] += 1
    return delta


def _launch_cycle(a, b, locked, it: torch.Tensor, t_off: int, total: int, n_chunks: int,
                  k: int) -> torch.Tensor:
    dev = a.device
    deltas = torch.zeros(n_chunks, dtype=torch.float32, device=dev)
    err = _build.load().epic_tile2d_cycle(
        a.data_ptr(), b.data_ptr(), locked.data_ptr(), *a.shape, it.data_ptr(), t_off, total,
        n_chunks, deltas.data_ptr(), _depth(k, dev), _stream(dev), dev.index)
    _build.check(err, "epic_tile2d_cycle")
    launches["epic_tile2d_cycle"] += 1
    return deltas


def _check_chunks(num_sweeps: int, n_chunks: int, k: int) -> None:
    if n_chunks < 1 or not n_chunks <= num_sweeps <= n_chunks * k:
        raise ValueError(f"{num_sweeps} sweeps over {n_chunks} chunks of 1..{k} sweeps")


def sweep_chunk(src: torch.Tensor, locked: torch.Tensor, iteration, num_sweeps: int, *,
                k: int = DEFAULT_DEPTH, u1: bool = False, out: torch.Tensor | None = None):
    """One chunk of ``num_sweeps`` (1..k) sweeps from ``iteration`` (an int
    or a 0-d int32 tensor on src's device): :func:`.tiled.sweep_chunk`'s
    contract, ``(dst, delta, u1)``. On CUDA ``dst`` is ``out`` when given
    (never ``src``) and ``src`` is left as it was."""
    _check_chunks(num_sweeps, 1, k)
    if src.device.type == "cpu":
        return tiled.sweep_chunk(src, locked, iteration, num_sweeps, k=k, tile=TILE, u1=u1)
    dst = torch.empty_like(src) if out is None else out
    first = torch.empty_like(src) if u1 else None
    _check_grid(src, locked, dst, *([first] if u1 else []))
    delta = _launch_chunk(src, dst, first, locked, _iteration(iteration, src.device), 0,
                          num_sweeps, k)
    return dst, delta, first


def sweep_cycle(a: torch.Tensor, b: torch.Tensor, locked: torch.Tensor, iteration,
                n_chunks: int, num_sweeps: int | None = None, *, k: int = DEFAULT_DEPTH):
    """``num_sweeps`` (default ``n_chunks * k``) sweeps spread over
    ``n_chunks`` ping-pong chunks in one launch: :func:`.tiled.sweep_cycle`'s
    contract, ``(a', b', deltas)``. On CUDA ``a`` and ``b`` (distinct) are
    updated in place and returned."""
    num_sweeps = n_chunks * k if num_sweeps is None else num_sweeps
    _check_chunks(num_sweeps, n_chunks, k)
    if a.device.type == "cpu":
        return tiled.sweep_cycle(a, b, locked, iteration, n_chunks, num_sweeps, k=k, tile=TILE)
    _check_grid(a, locked, b)
    deltas = _launch_cycle(a, b, locked, _iteration(iteration, a.device), 0, num_sweeps,
                           n_chunks, k)
    return a, b, deltas


def update_n(state: GridState, num_steps: int, k: int = DEFAULT_DEPTH) -> GridState:
    """``num_steps`` sweeps, delta from the first; semantics of
    :func:`epic_tpu_torch.solver.core.update_n`, in the chunks of
    :func:`.tiled.tick_schedule`."""
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    if state.u.device.type == "cpu":
        return tiled.update_n(state, num_steps, k=k, tile=TILE)
    _check_cuda_state(state)
    u, locked = state.u, state.locked
    twin = _scratch_for(u, "twin")
    cycle_sweeps, n_chunks, tail = tiled.tick_schedule(num_steps, k)
    delta = None
    if n_chunks:
        delta = _launch_cycle(u, twin, locked, state.iteration, 0, cycle_sweeps, n_chunks, k)[0]
    if tail:
        d = _launch_chunk(u, twin, None, locked, state.iteration, cycle_sweeps, tail, k)
        u.copy_(twin)
        delta = d if delta is None else delta
    return dataclasses.replace(
        state,
        iteration=state.iteration + num_steps,
        delta=delta,
        converged=(delta < state.epsilon) if num_steps == 1
        else torch.zeros((), dtype=torch.bool, device=u.device),
    )


class _Protocol:
    """The device scalars of a solve and its launches of
    ``epic_tile2d_solve``, each resuming from them."""

    def __init__(self, state: GridState, stagger: int, k: int):
        dev = state.u.device
        self.state, self.stagger, self.k = state, stagger, k
        self.acc = torch.zeros(2, dtype=torch.int32, device=dev)
        self.iteration = torch.zeros((), dtype=torch.int32, device=dev)
        self.delta = state.epsilon + 1.0
        self.done = torch.zeros((), dtype=torch.int32, device=dev)

    def run(self, bound: int) -> None:
        st = self.state
        u = st.u
        twin, u1 = _scratch_for(u, "twin"), _scratch_for(u, "u1")
        self.acc.zero_()
        err = _build.load().epic_tile2d_solve(
            u.data_ptr(), twin.data_ptr(), u1.data_ptr(), st.locked.data_ptr(), *u.shape,
            st.epsilon.data_ptr(), max(u.shape), min(bound, 2**31 - 1 - self.stagger),
            self.stagger, self.acc.data_ptr(), self.iteration.data_ptr(),
            self.delta.data_ptr(), self.done.data_ptr(), _depth(self.k, u.device),
            _stream(u.device), u.device.index)
        _build.check(err, "epic_tile2d_solve")
        launches["epic_tile2d_solve"] += 1

    def result(self) -> GridState:
        return dataclasses.replace(self.state, iteration=self.iteration, delta=self.delta,
                                   converged=self.done != 0)


def solve(state: GridState, stagger: int = C.DEFAULT_STAGGER,
          max_iterations: int = 1_000_000, k: int = DEFAULT_DEPTH) -> GridState:
    """Relax to convergence in one launch; protocol of
    :func:`epic_tpu_torch.solver.core.solve`. The host reads nothing until
    the caller reads the returned scalars."""
    if stagger < 1:
        raise ValueError(f"stagger must be >= 1, got {stagger}")
    if state.u.device.type == "cpu":
        return tiled.solve(state, stagger, max_iterations, k=k, tile=TILE)
    _check_cuda_state(state)
    p = _Protocol(state, stagger, k)
    p.run(max_iterations)
    return p.result()


def solve_segments(state: GridState, stagger: int = C.DEFAULT_STAGGER,
                   max_iterations: int = 1_000_000, segment_iterations: int = 5_000,
                   k: int = DEFAULT_DEPTH) -> GridState:
    """:func:`solve` as a host loop of launches, each ending at the next
    bound of :func:`.tiled.segment_bounds` (whole stagger cycles) and
    reading the verdict once; bit-identical to one solve."""
    if stagger < 1:
        raise ValueError(f"stagger must be >= 1, got {stagger}")
    if state.u.device.type == "cpu":
        return tiled.solve_segments(state, stagger, max_iterations, segment_iterations,
                                    k=k, tile=TILE)
    _check_cuda_state(state)
    p = _Protocol(state, stagger, k)
    for bound in tiled.segment_bounds(stagger, max_iterations, segment_iterations):
        p.run(bound)
        if bool(p.done):
            break
    return p.result()
