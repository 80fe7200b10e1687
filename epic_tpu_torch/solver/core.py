"""Plain PyTorch red-black relaxation: the reference version of the kernels.

The counterpart of ``epic_tpu.solver.core``, on torch tensors. It is the
plain version of the CUDA kernels in ``csrc/sweep2d.cu`` (2D) and
``csrc/sweep3d.cu`` (3D): the CPU path of the package, and what
``chip_smoke.py`` holds the kernels against on the card. Any rank >= 2
works here.

Semantics carried over from the JAX version (and harmonic_complete_cpu,
harmonic_cpu.cpp:136-184):

- a sweep updates the unlocked interior cells of one parity class,
  ``sum(coords) % 2 != (t + flip) % 2`` with ``flip = ndim % 2`` (2D updates
  ``(y + x) % 2 != t % 2``; 3D the other class);
- ``update_n`` records the delta of its first sweep;
- ``solve`` resets the iteration to 0, checks every ``stagger`` sweeps, and
  exits only right after a passing check with ``iteration >= max(shape)``,
  keeping the post-check state. The verdict is not sticky.

``calls`` counts the calls of ``update_n``, ``solve`` and ``solve_py``, so
a run on the card can show that its main path never came here (or, for a
grid of rank 4 and more, the one route on the card without a kernel, that
it did).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from .. import constants as C
from ..grid import GridState
from ._sweep_body import lse2n, lse4, lse6

calls = {"update_n": 0, "solve": 0, "solve_py": 0}


def _log2n(nd: int) -> float:
    """log(2n) as a float32 value: log(4) in 2D, log(6) in 3D."""
    return float(np.float32(np.log(np.float64(2.0 * nd))))


def _neighbor_logsumexp(u: torch.Tensor) -> torch.Tensor:
    """Shifted logsumexp of the 2n axis neighbours over the interior, in the
    pinned op order (2D and 3D go through :func:`lse4` and :func:`lse6`, the
    kernels' twins)."""
    nd = u.ndim
    nbrs = []
    for axis in range(nd):
        lo = tuple(slice(0, -2) if a == axis else slice(1, -1) for a in range(nd))
        hi = tuple(slice(2, None) if a == axis else slice(1, -1) for a in range(nd))
        nbrs.append(u[lo])
        nbrs.append(u[hi])
    if nd == 2:
        return lse4(*nbrs)
    if nd == 3:
        return lse6(*nbrs)
    return lse2n(nbrs, _log2n(nd))


@functools.lru_cache(maxsize=8)
def _parity(shape: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """(sum of coordinates) % 2 over the interior, as uint8."""
    total = torch.zeros([s - 2 for s in shape], dtype=torch.int64, device=device)
    for axis, s in enumerate(shape):
        view = [1] * len(shape)
        view[axis] = s - 2
        total = total + torch.arange(1, s - 1, device=device).view(view)
    return (total % 2).to(torch.uint8)


def sweep(u: torch.Tensor, locked: torch.Tensor, iteration) -> tuple[torch.Tensor, torch.Tensor]:
    """One red-black sweep over the parity class selected by ``iteration``
    (an int or a 0-d tensor). Returns ``(u_new, delta)``, delta = max
    |u' - u| over the interior (0 where nothing updates)."""
    inner = (slice(1, -1),) * u.ndim
    val = _neighbor_logsumexp(u)
    flip = u.ndim % 2
    update = (_parity(tuple(u.shape), u.device) != (iteration + flip) % 2) & ~locked[inner]
    old = u[inner]
    new = torch.where(update, val, old)
    if new.numel():
        delta = (new - old).abs().max()
    else:
        delta = torch.zeros((), dtype=u.dtype, device=u.device)
    u_new = u.clone()
    u_new[inner] = new
    return u_new, delta


def update_n(state: GridState, num_steps: int) -> GridState:
    """The anytime stepper: ``num_steps`` sweeps, delta checked on the first
    (EpicNavigationNodeHarmonic::update, epic_navigation_node_harmonic.cpp:
    165-204). ``num_steps`` must be >= 1."""
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    calls["update_n"] += 1
    u, delta = sweep(state.u, state.locked, state.iteration)
    for k in range(1, num_steps):
        u, _ = sweep(u, state.locked, state.iteration + k)
    return dataclasses.replace(
        state,
        u=u,
        iteration=state.iteration + num_steps,
        delta=delta,
        converged=(delta < state.epsilon) if num_steps == 1
        else torch.zeros((), dtype=torch.bool, device=u.device),
    )


def solve(
    state: GridState,
    stagger: int = C.DEFAULT_STAGGER,
    max_iterations: int = 1_000_000,
) -> GridState:
    """Relax to convergence with the protocol of harmonic_complete_cpu
    (:136-184), driven from the host: one checked sweep, then, unless the
    exit fired, ``stagger - 1`` plain sweeps. The host reads the check's
    delta only once ``iteration >= max(shape)`` makes an exit possible.
    ``iteration`` is reset to 0 on entry (harmonic_cpu.cpp:153); final
    iteration counts are 1 mod ``stagger`` when converged."""
    if stagger < 1:
        raise ValueError(f"stagger must be >= 1, got {stagger}")
    calls["solve"] += 1
    m_max = max(state.u.shape)
    locked = state.locked
    u = state.u
    iteration = 0
    delta = state.epsilon + 1.0
    converged = False
    while not converged and iteration < max_iterations:
        u, delta = sweep(u, locked, iteration)
        iteration += 1
        if iteration >= m_max and bool(delta < state.epsilon):
            converged = True
            break
        for s in range(stagger - 1):
            u, _ = sweep(u, locked, iteration + s)
        iteration += stagger - 1
    dev = u.device
    return dataclasses.replace(
        state,
        u=u,
        iteration=torch.tensor(iteration, dtype=torch.int32, device=dev),
        delta=delta,
        converged=torch.tensor(converged, dtype=torch.bool, device=dev),
    )


def solve_py(
    state: GridState,
    stagger: int = C.DEFAULT_STAGGER,
    max_iterations: int = 1_000_000,
    sweep_fn: Callable | None = None,
) -> GridState:
    """Host-driven variant of :func:`solve` (``epic_tpu.solver.core.solve_py``):
    the same protocol, with each checked sweep done by ``sweep_fn(u, locked,
    iteration)`` (default :func:`sweep`) and its delta read on the host, so
    a caller can observe each check or swap in another sweep (an oracle's).
    The ``stagger - 1`` plain sweeps after a check are :func:`sweep`'s. With
    the default ``sweep_fn`` the result has :func:`solve`'s bits on any
    device."""
    if stagger < 1:
        raise ValueError(f"stagger must be >= 1, got {stagger}")
    calls["solve_py"] += 1
    sweep_fn = sweep_fn or sweep
    m_max = max(state.u.shape)
    locked = state.locked
    u = state.u
    eps = float(state.epsilon)
    iteration = 0
    delta = eps + 1.0
    converged = False
    while not converged and iteration < max_iterations:
        u, d = sweep_fn(u, locked, iteration)
        iteration += 1
        delta = float(d)
        if delta < eps and iteration >= m_max:
            converged = True
            break
        for s in range(stagger - 1):
            u, _ = sweep(u, locked, iteration + s)
        iteration += stagger - 1
    dev = u.device
    return dataclasses.replace(
        state,
        u=u,
        iteration=torch.tensor(iteration, dtype=torch.int32, device=dev),
        delta=torch.tensor(delta, dtype=torch.float32, device=dev),
        converged=torch.tensor(converged, dtype=torch.bool, device=dev),
    )
