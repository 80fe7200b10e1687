"""The 2D anytime stepper and solve on the CUDA kernels.

The counterpart of ``epic_tpu.solver.pallas_sweep``: ``update_n`` launches
``epic_sweep2d_chunk`` (for ``_multisweep_kernel``) and ``solve`` launches
``epic_sweep2d_solve`` (for ``_solve_whole_kernel``), both from
``csrc/sweep2d.cu``. A state on the CPU goes to the plain version in
:mod:`.core`; a state on a CUDA device goes to the kernel or raises. There is
no padding: the kernels take the unpadded grid, in place. The 3D volume has
its own wrapper, :mod:`.hopper_sweep3d`, which launches through the helpers
here.

In place: on CUDA the returned state holds the same ``u`` tensor as the
input, relaxed. Keep only the returned state (the JAX version donates it).

``launches`` counts each kernel's launches; nothing else changes it.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import constants as C
from ..grid import GridState
from . import _build, core

launches = {"epic_sweep2d_chunk": 0, "epic_sweep2d_solve": 0}

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
                 counts: dict) -> GridState:
    """Launch the solve entry ``entry`` (``u, locked, *shape, eps, m_max,
    max_iterations, stagger, acc, it, delta, done, stream, device``) on a
    checked CUDA state and count it in ``counts``."""
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
        acc.data_ptr(), iteration.data_ptr(), delta.data_ptr(), done.data_ptr(),
        _stream(dev), dev.index)
    _build.check(err, entry)
    counts[entry] += 1
    return dataclasses.replace(
        state, iteration=iteration, delta=delta, converged=done != 0)


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
    return launch_solve(state, stagger, max_iterations, "epic_sweep2d_solve", launches)
