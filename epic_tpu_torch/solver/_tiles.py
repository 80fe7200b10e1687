"""One wrapper for both temporally blocked tile kernel families.

``csrc/tile2d.cu`` and ``csrc/tile3d.cu`` export the same three entries,
``<prefix>_chunk``, ``<prefix>_cycle`` and ``<prefix>_solve``, with the same
arguments (the grid's shape, 2 or 3 ints, in the middle), and answer the
same contract as their plain versions :mod:`.tiled` and :mod:`.tiled3d`.
:class:`TileKernels` wraps one family: the checks, the scratch grids, the
launches and their count. :mod:`.hopper_tile2d` and :mod:`.hopper_tile3d`
each hold one, with their own tile, default depth and routing rule.

A grid on the CPU goes to the plain version; a grid on a CUDA device goes
to the kernels or raises. In place: on CUDA the returned state holds the
caller's ``u`` tensor, relaxed. The chunks ping-pong through a twin grid
(and a solve's check writes a u1 grid), scratch kept for the last (device,
shape) seen and allocated when first needed: a tick takes only the twin.

A family whose tile depends on the grid's shape (the 3D column segments)
passes ``tile_for(shape, device)``: the plain version is handed that tile,
and the kernels its first extent after the grid's shape.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import constants as C
from ..grid import GridState
from . import _build
from .hopper_sweep import _check_cuda_state, _iteration, _stream


def scratch_for(cache: dict, u: torch.Tensor, name: str) -> torch.Tensor:
    """The scratch tensor ``name`` ("twin" or "u1") of u's device and shape
    in ``cache``, which keeps those of the last (device, shape) only."""
    key = (u.device, tuple(u.shape))
    if cache.get("key") != key:
        cache.clear()
        cache["key"] = key
    if name not in cache:
        cache[name] = torch.empty_like(u)
    return cache[name]


def _check_chunks(num_sweeps: int, n_chunks: int, k: int) -> None:
    if n_chunks < 1 or not n_chunks <= num_sweeps <= n_chunks * k:
        raise ValueError(f"{num_sweeps} sweeps over {n_chunks} chunks of 1..{k} sweeps")


class TileKernels:
    """The kernels ``<prefix>_{chunk,cycle,solve}`` of one tile family:
    centre ``tile`` (its rank the grid's), ``smem_bytes(k)`` the dynamic
    shared memory of a block at halo depth k, halo depth ``default_depth``
    unless a call says otherwise (at most ``max_depth`` when given), plain
    version ``plain``; ``tile_for(shape, device)``, when given, the tile of
    each grid in place of ``tile``. ``launches`` counts each kernel's
    launches; nothing else changes it."""

    def __init__(self, prefix: str, plain, tile: tuple[int, ...], default_depth: int,
                 smem_bytes, max_depth: int | None = None, tile_for=None):
        self.prefix, self.plain, self.tile = prefix, plain, tuple(tile)
        self.default_depth, self.max_depth, self.tile_for = default_depth, max_depth, tile_for
        self.smem_bytes = smem_bytes   # a block's dynamic shared memory at halo depth k
        self.ndim = len(self.tile)
        self.launches = {f"{prefix}_{e}": 0 for e in ("chunk", "cycle", "solve")}
        self.scratch: dict = {}

    # -- shared memory ---------------------------------------------------------------

    def check_depth(self, k: int, smem_limit: int) -> None:
        """Refuse a halo depth the kernels cannot take: below 1, one whose
        extended tile exceeds ``smem_limit``, the shared memory a block may
        opt into, or one above ``max_depth``."""
        if k < 1:
            raise ValueError(f"the halo depth must be >= 1, got {k}")
        if self.smem_bytes(k) > smem_limit:
            raise ValueError(
                f"halo depth {k} needs {self.smem_bytes(k)} B of shared memory for a "
                f"{'x'.join(map(str, self.tile))} tile; a block has {smem_limit}")
        if self.max_depth is not None and k > self.max_depth:
            raise ValueError(f"the halo depth must be at most {self.max_depth}, got {k}")

    def _depth(self, k: int | None, device: torch.device) -> int:
        """``k`` (the default depth when None), checked against the card's
        shared memory a block may opt into."""
        k = self.default_depth if k is None else k
        self.check_depth(k, torch.cuda.get_device_properties(device).shared_memory_per_block_optin)
        return k

    def tile_of(self, shape, device) -> tuple[int, ...]:
        """The tile of a grid of ``shape`` on ``device``."""
        return self.tile if self.tile_for is None else tuple(self.tile_for(tuple(shape), device))

    def _shape_args(self, u: torch.Tensor) -> tuple[int, ...]:
        """The grid's extents as the entries take them: the shape, and for a
        family with ``tile_for`` its tile's first extent."""
        if self.tile_for is None:
            return tuple(u.shape)
        return (*u.shape, self.tile_of(u.shape, u.device)[0])

    # -- checks and scratch ----------------------------------------------------------

    def _check_grid(self, u: torch.Tensor, locked: torch.Tensor, *others: torch.Tensor) -> None:
        """What the entries take: contiguous float32 grids of the family's
        rank and a bool ``locked`` of their shape, on one CUDA device, no
        grid twice."""
        if u.device.type != "cuda":
            raise ValueError(f"expected a CUDA tensor, got one on {u.device}")
        for t in (u, *others):
            if t.dtype != torch.float32:
                raise TypeError(f"need float32 grids, got {t.dtype}")
            if t.ndim != self.ndim or t.shape != u.shape:
                raise ValueError(f"need rank-{self.ndim} grids of one shape, got "
                                 f"{tuple(t.shape)}")
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

    # -- launches --------------------------------------------------------------------

    def _launch(self, entry: str, *args) -> None:
        err = getattr(_build.load(), f"{self.prefix}_{entry}")(*args)
        _build.check(err, f"{self.prefix}_{entry}")
        self.launches[f"{self.prefix}_{entry}"] += 1

    def _launch_chunk(self, src, dst, u1, locked, it: torch.Tensor, t_off: int, ns: int,
                      k: int | None) -> torch.Tensor:
        dev = src.device
        delta = torch.zeros((), dtype=torch.float32, device=dev)
        self._launch("chunk", src.data_ptr(), dst.data_ptr(),
                     None if u1 is None else u1.data_ptr(), locked.data_ptr(),
                     *self._shape_args(src),
                     it.data_ptr(), t_off, ns, delta.data_ptr(), self._depth(k, dev),
                     _stream(dev), dev.index)
        return delta

    def _launch_cycle(self, a, b, locked, it: torch.Tensor, t_off: int, total: int,
                      n_chunks: int, k: int | None) -> torch.Tensor:
        dev = a.device
        deltas = torch.zeros(n_chunks, dtype=torch.float32, device=dev)
        self._launch("cycle", a.data_ptr(), b.data_ptr(), locked.data_ptr(), *self._shape_args(a),
                     it.data_ptr(), t_off, total, n_chunks, deltas.data_ptr(),
                     self._depth(k, dev), _stream(dev), dev.index)
        return deltas

    # -- the entries -----------------------------------------------------------------

    def sweep_chunk(self, src: torch.Tensor, locked: torch.Tensor, iteration, num_sweeps: int,
                    *, k: int | None = None, u1: bool = False, out: torch.Tensor | None = None):
        """One chunk of ``num_sweeps`` (1..k) sweeps from ``iteration`` (an
        int or a 0-d int32 tensor on src's device): the plain version's
        ``sweep_chunk`` contract, ``(dst, delta, u1)``. On CUDA ``dst`` is
        ``out`` when given (never ``src``) and ``src`` is left as it was."""
        k = self.default_depth if k is None else k
        _check_chunks(num_sweeps, 1, k)
        if src.device.type == "cpu":
            return self.plain.sweep_chunk(src, locked, iteration, num_sweeps, k=k,
                                          tile=self.tile_of(src.shape, src.device), u1=u1)
        dst = torch.empty_like(src) if out is None else out
        first = torch.empty_like(src) if u1 else None
        self._check_grid(src, locked, dst, *([first] if u1 else []))
        delta = self._launch_chunk(src, dst, first, locked, _iteration(iteration, src.device),
                                   0, num_sweeps, k)
        return dst, delta, first

    def sweep_cycle(self, a: torch.Tensor, b: torch.Tensor, locked: torch.Tensor, iteration,
                    n_chunks: int, num_sweeps: int | None = None, *, k: int | None = None):
        """``num_sweeps`` (default ``n_chunks * k``) sweeps spread over
        ``n_chunks`` ping-pong chunks in one launch: the plain version's
        ``sweep_cycle`` contract, ``(a', b', deltas)``. On CUDA ``a`` and
        ``b`` (distinct) are updated in place and returned."""
        k = self.default_depth if k is None else k
        num_sweeps = n_chunks * k if num_sweeps is None else num_sweeps
        _check_chunks(num_sweeps, n_chunks, k)
        if a.device.type == "cpu":
            return self.plain.sweep_cycle(a, b, locked, iteration, n_chunks, num_sweeps, k=k,
                                          tile=self.tile_of(a.shape, a.device))
        self._check_grid(a, locked, b)
        deltas = self._launch_cycle(a, b, locked, _iteration(iteration, a.device), 0, num_sweeps,
                                    n_chunks, k)
        return a, b, deltas

    def update_n(self, state: GridState, num_steps: int, k: int | None = None) -> GridState:
        """``num_steps`` sweeps, delta from the first; semantics of
        :func:`epic_tpu_torch.solver.core.update_n`, in the chunks of
        :func:`.tiled.tick_schedule`: one cycle launch, and for an odd chunk
        count the last chunk through the chunk entry, copied back."""
        if num_steps < 1:
            raise ValueError(f"num_steps must be >= 1, got {num_steps}")
        k = self.default_depth if k is None else k
        if state.u.device.type == "cpu":
            return self.plain.update_n(state, num_steps, k=k,
                                       tile=self.tile_of(state.u.shape, state.u.device))
        _check_cuda_state(state, self.ndim)
        u, locked = state.u, state.locked
        twin = scratch_for(self.scratch, u, "twin")
        cycle_sweeps, n_chunks, tail = self.plain.tick_schedule(num_steps, k)
        delta = None
        if n_chunks:
            delta = self._launch_cycle(u, twin, locked, state.iteration, 0, cycle_sweeps,
                                       n_chunks, k)[0]
        if tail:
            d = self._launch_chunk(u, twin, None, locked, state.iteration, cycle_sweeps, tail, k)
            u.copy_(twin)
            delta = d if delta is None else delta
        return dataclasses.replace(
            state,
            iteration=state.iteration + num_steps,
            delta=delta,
            converged=(delta < state.epsilon) if num_steps == 1
            else torch.zeros((), dtype=torch.bool, device=u.device),
        )

    def solve(self, state: GridState, stagger: int = C.DEFAULT_STAGGER,
              max_iterations: int = 1_000_000, k: int | None = None) -> GridState:
        """Relax to convergence in one launch of the solve entry; protocol of
        :func:`epic_tpu_torch.solver.core.solve`. The host reads nothing
        until the caller reads the returned scalars."""
        return self.solve_segments(state, stagger, max_iterations, None, k)

    def solve_segments(self, state: GridState, stagger: int = C.DEFAULT_STAGGER,
                       max_iterations: int = 1_000_000, segment_iterations: int | None = 5_000,
                       k: int | None = None) -> GridState:
        """:func:`solve` as a host loop of launches, each resuming the
        protocol from the last one's iteration, delta and verdict and ending
        at the next bound of :func:`.tiled.segment_bounds` (whole stagger
        cycles), the verdict read once a segment; bit-identical to one
        solve. ``segment_iterations=None`` is one launch."""
        if stagger < 1:
            raise ValueError(f"stagger must be >= 1, got {stagger}")
        k = self.default_depth if k is None else k
        if state.u.device.type == "cpu":
            tile = self.tile_of(state.u.shape, state.u.device)
            if segment_iterations is None:
                return self.plain.solve(state, stagger, max_iterations, k=k, tile=tile)
            return self.plain.solve_segments(state, stagger, max_iterations, segment_iterations,
                                             k=k, tile=tile)
        _check_cuda_state(state, self.ndim)
        bounds = ([max_iterations] if segment_iterations is None
                  else self.plain.segment_bounds(stagger, max_iterations, segment_iterations))
        u, dev = state.u, state.u.device
        twin, u1 = scratch_for(self.scratch, u, "twin"), scratch_for(self.scratch, u, "u1")
        acc = torch.zeros(2, dtype=torch.int32, device=dev)
        iteration = torch.zeros((), dtype=torch.int32, device=dev)
        delta = state.epsilon + 1.0
        done = torch.zeros((), dtype=torch.int32, device=dev)
        for bound in bounds:
            acc.zero_()
            self._launch("solve", u.data_ptr(), twin.data_ptr(), u1.data_ptr(),
                         state.locked.data_ptr(), *self._shape_args(u), state.epsilon.data_ptr(),
                         max(u.shape), min(bound, 2**31 - 1 - stagger), stagger, acc.data_ptr(),
                         iteration.data_ptr(), delta.data_ptr(), done.data_ptr(),
                         self._depth(k, dev), _stream(dev), dev.index)
            if len(bounds) > 1 and bool(done):
                break
        return dataclasses.replace(state, iteration=iteration, delta=delta, converged=done != 0)
