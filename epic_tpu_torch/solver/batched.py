"""Batched multi-scenario solves in plain torch: B independent lanes.

The counterpart of ``epic_tpu.solver.batched`` (``vmap`` over lanes there, a
batch axis written out here). It is the plain version of the CUDA kernels in
``csrc/batched2d.cu``: the CPU path of :mod:`.hopper_batched`, and what
``chip_smoke.py`` holds those kernels against on the card.

A batch is ``u: float32[B, H, W]`` with ``locked: bool[B, H, W]``. Every lane
follows the solve protocol of :mod:`.core` on its own: lanes run in lockstep
on one shared iteration, and a lane retires (freezes) right after its own
check passes the exit rule, so its final field and iteration count equal a
solo solve of that lane.

A batch is not a volume: ``core.sweep`` reads a rank-3 tensor as a 3D grid
(six neighbours, the flipped parity). The sweep here is the 2D ``lse4`` over
axes 1 and 2, with the 2D class ``(y + x) % 2 != t % 2`` in each lane's own
coordinates, and a per-lane delta over axes 1 and 2.

``calls`` counts the calls of the batch entries, so a run on the card can
show that its main path never came here.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from ._sweep_body import lse4
from .core import _parity

calls = {"update_n_batch": 0, "update_n_batch_rolled": 0, "solve_batch": 0}


def _sweep_batch(u: torch.Tensor, locked: torch.Tensor, iteration
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One red-black sweep of every lane: ``u [B, H, W] -> (u', delta [B])``.
    ``iteration`` is an int or a 0-d tensor."""
    inner = (slice(None), slice(1, -1), slice(1, -1))
    val = lse4(u[:, :-2, 1:-1], u[:, 2:, 1:-1], u[:, 1:-1, :-2], u[:, 1:-1, 2:])
    update = (_parity(tuple(u.shape[1:]), u.device) != iteration % 2) & ~locked[inner]
    old = u[inner]
    new = torch.where(update, val, old)
    if new.numel():
        delta = (new - old).abs().amax(dim=(1, 2))
    else:
        delta = torch.zeros(u.shape[0], dtype=u.dtype, device=u.device)
    u_new = u.clone()
    u_new[inner] = new
    return u_new, delta


def _frozen_batch(locked: torch.Tensor) -> torch.Tensor:
    """``locked | ~interior`` per lane: the mask of cells a sweep never
    updates, the boundary ring included."""
    ring = torch.ones(locked.shape[1:], dtype=torch.bool, device=locked.device)
    ring[1:-1, 1:-1] = False
    return locked | ring


def _sweep_batch_rolled(u: torch.Tensor, frozen: torch.Tensor, iteration
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The roll formulation of :func:`_sweep_batch`. ``frozen`` must cover the
    ring (:func:`_frozen_batch`): wrapped-around values reach only frozen
    cells. Returns ``(u', delta [B])``."""
    un = torch.roll(u, 1, 1)
    us = torch.roll(u, -1, 1)
    uw = torch.roll(u, 1, 2)
    ue = torch.roll(u, -1, 2)
    val = lse4(un, us, uw, ue)
    _, h, w = u.shape
    row = torch.arange(h, device=u.device).view(h, 1)
    col = torch.arange(w, device=u.device).view(1, w)
    update = (((row + col) % 2) != iteration % 2) & ~frozen
    u_new = torch.where(update, val, u)
    return u_new, (u_new - u).abs().amax(dim=(1, 2))


def _check_steps(num_steps: int) -> None:
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")


def _chunk(u: torch.Tensor, locked: torch.Tensor, iteration, num_steps: int,
           active: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`update_n_batch` without its checks and count."""
    gate = None if active is None else active.view(-1, 1, 1)
    u_new, delta = _sweep_batch(u, locked, iteration)
    if active is not None:
        u_new = torch.where(gate, u_new, u)
        delta = torch.where(active, delta, torch.zeros_like(delta))
    u = u_new
    for k in range(1, num_steps):
        u_new, _ = _sweep_batch(u, locked, iteration + k)
        u = u_new if gate is None else torch.where(gate, u_new, u)
    return u, delta


def update_n_batch(u: torch.Tensor, locked: torch.Tensor, iteration, num_steps: int,
                   active: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The batched anytime chunk: ``num_steps`` sweeps from ``iteration``,
    per-lane delta of sweep 0. Lanes where the optional bool ``active [B]``
    is False keep their field and report delta 0. Returns ``(u, delta [B])``."""
    _check_steps(num_steps)
    calls["update_n_batch"] += 1
    return _chunk(u, locked, iteration, num_steps, active)


def update_n_batch_rolled(u: torch.Tensor, frozen: torch.Tensor, iteration,
                          num_steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`update_n_batch` on the roll formulation; ``frozen`` from
    :func:`_frozen_batch` (or any mask that covers the ring)."""
    _check_steps(num_steps)
    calls["update_n_batch_rolled"] += 1
    u, delta = _sweep_batch_rolled(u, frozen, iteration)
    for k in range(1, num_steps):
        u, _ = _sweep_batch_rolled(u, frozen, iteration + k)
    return u, delta


def epsilon_lanes(epsilon, b: int, device) -> torch.Tensor:
    """A scalar or ``[B]`` epsilon as a float32 ``[B]`` tensor on ``device``."""
    if not isinstance(epsilon, torch.Tensor) and bool((np.asarray(epsilon) <= 0).any()):
        # harmonic_complete_cpu rejects epsilon <= 0 (harmonic_cpu.cpp:141-145).
        raise ValueError(f"epsilon must be > 0, got {epsilon}")
    if not isinstance(epsilon, torch.Tensor) and np.ndim(epsilon) == 0:
        # Filled in on the device: no copy from the host, no sync.
        return torch.full((b,), float(epsilon), dtype=torch.float32, device=device)
    eps = torch.as_tensor(epsilon, dtype=torch.float32, device=device)
    if eps.ndim > 1 or (eps.ndim == 1 and eps.shape[0] != b):
        raise ValueError(f"epsilon must be a scalar or have shape [{b}], got {tuple(eps.shape)}")
    return eps.broadcast_to((b,)).contiguous()


def lockstep(u: torch.Tensor, locked: torch.Tensor, epsilon, stagger: int,
             max_iterations: int, chunk):
    """The lockstep protocol of ``epic_tpu.solver.batched.solve_batch``
    (:110-132) over a chunk function ``chunk(u, locked, iteration,
    num_steps, active) -> (u, delta [B])``: the plain :func:`_chunk` here,
    the CUDA kernel in :mod:`.hopper_batched`. The host reads the verdicts
    only once an exit is possible, once a cycle."""
    b, h, w = u.shape
    dev = u.device
    m_max = max(h, w)
    eps = epsilon_lanes(epsilon, b, dev)
    iters = torch.zeros(b, dtype=torch.int32, device=dev)
    deltas = eps + 1.0
    retired = torch.zeros(b, dtype=torch.bool, device=dev)
    t = 0
    while t < max_iterations:
        active = ~retired
        u, d = chunk(u, locked, t, 1, active)
        deltas = torch.where(active, d, deltas)
        iters = torch.where(active, t + 1, iters)
        retired = retired | (active & (d < eps) & (t + 1 >= m_max))
        if t + 1 >= m_max and bool(retired.all()):
            break
        active = ~retired
        if stagger > 1:
            u, _ = chunk(u, locked, t + 1, stagger - 1, active)
        iters = torch.where(active, t + stagger, iters)
        t += stagger
    return u, iters, deltas, retired


def solve_batch(
    u: torch.Tensor,
    locked: torch.Tensor,
    epsilon=C.DEFAULT_EPSILON,
    stagger: int = C.DEFAULT_STAGGER,
    max_iterations: int = 1_000_000,
):
    """Solve B lanes to convergence in lockstep (``epic_tpu.solver.batched.
    solve_batch``): each cycle one checked sweep of the active lanes, then
    ``stagger - 1`` plain sweeps of the lanes still active. A lane retires
    right after a check with ``delta < eps`` and ``iteration >= max(H, W)``.
    ``epsilon`` is a scalar or one value a lane.

    Returns ``(u, iterations int32[B], deltas float32[B], converged
    bool[B])``; the input ``u`` is left intact."""
    if stagger < 1:
        raise ValueError(f"stagger must be >= 1, got {stagger}")
    calls["solve_batch"] += 1
    return lockstep(u, locked, epsilon, stagger, max_iterations, _chunk)


def batch_from_goal_sets(base_img: np.ndarray, goal_sets, *, device: torch.device | str):
    """A ``(u, locked)`` batch from one occupancy image and B goal sets of
    ``(x, y)`` cells. The image's obstacles (pixel 0) are every lane's; its
    own goal pixels are ignored. A goal out of range or on an obstacle is
    skipped (``epic_tpu.solver.batched.batch_from_goal_sets``, :181-191)."""
    img = np.asarray(base_img)
    obstacle = img == 0
    u0 = np.full(img.shape, C.LOG_SPACE_FREE, np.float32)
    u0[obstacle] = C.LOG_SPACE_OBSTACLE
    b = len(goal_sets)
    u = np.tile(u0, (b, 1, 1))
    locked = np.tile(obstacle, (b, 1, 1))
    h, w = img.shape
    for lane, goals in enumerate(goal_sets):
        for gx, gy in goals:
            if not (0 <= gx < w and 0 <= gy < h) or obstacle[gy, gx]:
                continue
            u[lane, gy, gx] = C.LOG_SPACE_GOAL
            locked[lane, gy, gx] = True
    return (torch.from_numpy(u).to(device).contiguous(),
            torch.from_numpy(locked).to(device).contiguous())


def batch_from_numpy(u, locked, *, device: torch.device | str):
    """Carry a batch across (from ``epic_tpu`` or any array): ``u``
    float32 ``[B, H, W]`` and ``locked`` bool of its shape, as contiguous
    tensors on ``device`` holding the same bits."""
    u = np.asarray(u)
    locked = np.asarray(locked)
    if u.dtype != np.float32 or locked.dtype != np.bool_:
        raise TypeError(f"need float32 u and bool locked, got {u.dtype} and {locked.dtype}")
    if u.ndim != 3 or locked.shape != u.shape:
        raise ValueError(f"need u and locked of one shape [B, H, W], got {u.shape} and {locked.shape}")
    return (torch.tensor(u, device=device).contiguous(),
            torch.tensor(locked, device=device).contiguous())
