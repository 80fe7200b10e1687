"""Batched streamline extraction: B walkers in lockstep on torch tensors.

The counterpart of ``epic_tpu.solver.batched_path``: per step, a batched
bilinear gather, a central-difference gradient and a unit step for every
lane, with per-lane termination (locked cell reached, stuck against a
5-point ring of past points, step budget) mirroring the host walker's rules
(:func:`epic_tpu_torch.path.compute_path`). It runs on the device that holds
``u``: plain torch, since the JAX package has no Pallas kernel here either.

The JAX version is one ``fori_loop`` of ``max_steps`` steps. Eager torch
stops early once no lane is active, looking every ``CHECK_EVERY`` steps (one
host sync each): a lane that stopped never moves again, so the outputs are
what the full loop gives.
"""

from __future__ import annotations

import torch

from .. import constants as C

CHECK_EVERY = 64


def _cell_index(v: torch.Tensor) -> torch.Tensor:
    """(v + 0.5) truncated toward zero: the cell a point lies in."""
    return (v + 0.5).to(torch.int64)


def _corners(x, y, h: int, w: int, mode: str):
    if mode == "bilinear":
        xl = x.to(torch.int64).clamp(0, w - 2)
        yl = y.to(torch.int64).clamp(0, h - 2)
        xr, yb = xl + 1, yl + 1
    elif mode == "reference":
        # Truncation of (v - 0.5) toward zero, clamped at 0 — may give
        # alpha/beta > 1 (the reference's extrapolation quirk).
        xl = (x - 0.5).to(torch.int64).clamp(min=0)
        yl = (y - 0.5).to(torch.int64).clamp(min=0)
        xr = (x + 0.5).to(torch.int64).clamp(0, w - 1)
        yb = (y + 0.5).to(torch.int64).clamp(0, h - 1)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return xl, yl, xr, yb


def _potential(u, x, y, mode: str):
    """Batched interpolated potential at the points (x, y)."""
    h, w = u.shape
    xl, yl, xr, yb = _corners(x, y, h, w, mode)
    alpha = x - xl.to(torch.float32)
    beta = y - yl.to(torch.float32)
    top = (1.0 - alpha) * u[yl, xl] + alpha * u[yl, xr]
    bot = (1.0 - alpha) * u[yb, xl] + alpha * u[yb, xr]
    return (1.0 - beta) * top + beta * bot


def walk(
    u: torch.Tensor,
    locked: torch.Tensor,
    starts,
    step_size: float = C.DEFAULT_STEP_SIZE,
    cd_precision: float = C.DEFAULT_CD_PRECISION,
    max_steps: int = 2048,
    mode: str = "bilinear",
    record_trajectories: bool = True,
) -> dict:
    """Walk B streamlines on ``u``'s device.

    Args:
      u: f32[H, W] solved log-potential.
      locked: bool[H, W].
      starts: f32[B, 2] (x, y) start positions (array or tensor).

    Returns a dict of tensors on ``u``'s device:
      positions: f32[B, max_steps + 1, 2] (only when record_trajectories;
        padded by repeating the final position),
      lengths: i32[B] number of recorded points per lane (>= 1),
      reached_goal: bool[B] ended in a locked cell with u == 0,
      terminated: bool[B] lane stopped before the step budget,
      end_xy: f32[B, 2] final positions.
    """
    h, w = u.shape
    dev = u.device
    starts = torch.as_tensor(starts, dtype=torch.float32, device=dev)
    b = starts.shape[0]
    x, y = starts[:, 0], starts[:, 1]
    lane = torch.arange(b, device=dev)

    def in_bounds(xc, yc):
        return (xc >= 0) & (yc >= 0) & (xc < w) & (yc < h)

    def cell_locked(xc, yc):
        return locked[yc.clamp(0, h - 1), xc.clamp(0, w - 1)]

    xc, yc = _cell_index(x), _cell_index(y)
    # Invalid starts (off-map or obstacle cell) never walk.
    start_obstacle = cell_locked(xc, yc) & (u[yc.clamp(0, h - 1), xc.clamp(0, w - 1)] < 0.0)
    active = in_bounds(xc, yc) & ~start_obstacle & ~cell_locked(xc, yc)

    # Ring of the last 5 points (newest first), matching the host walker's
    # stuck window. +inf rows: no spurious hits before 5 real entries exist.
    history = torch.full((b, C.PATH_STUCK_HISTORY_LENGTH, 2), float("inf"), device=dev)
    history[:, 0] = torch.stack([x, y], -1)
    if record_trajectories:
        traj = torch.zeros((b, max_steps + 1, 2), device=dev)
        traj[:, 0] = torch.stack([x, y], -1)
    lengths = torch.zeros(b, dtype=torch.int32, device=dev)

    cd = cd_precision
    for k in range(max_steps):
        # The four central-difference samples as one batch of 4B points.
        v = _potential(u, torch.cat([x - cd, x + cd, x, x]),
                       torch.cat([y, y, y - cd, y + cd]), mode).view(4, b)
        gx = (v[1] - v[0]) / (2.0 * cd)
        gy = (v[3] - v[2]) / (2.0 * cd)
        norm = torch.sqrt(gx * gx + gy * gy)
        grad_ok = (norm > 0.0) & torch.isfinite(norm)
        safe = torch.where(grad_ok, norm, 1.0)
        stepped = active & grad_ok
        nx = torch.where(stepped, x + gx / safe * step_size, x)
        ny = torch.where(stepped, y + gy / safe * step_size, y)

        # Stuck: new point within step/2 of any of the last 5 points.
        dx = history[:, :, 0] - nx[:, None]
        dy = history[:, :, 1] - ny[:, None]
        stuck = (torch.sqrt(dx * dx + dy * dy) < step_size / 2.0).any(1)

        xc, yc = _cell_index(nx), _cell_index(ny)
        off = ~in_bounds(xc, yc)
        hit_locked = cell_locked(xc, yc)

        lengths = torch.where(stepped, lengths + 1, lengths)
        pos = torch.stack([nx, ny], -1)
        if record_trajectories:
            traj[lane, lengths.clamp(0, max_steps).long()] = pos
        # Inactive lanes push their frozen position, which cannot change
        # their (already final) outcome.
        history = torch.cat([pos[:, None], history[:, :-1]], 1)
        active = stepped & ~stuck & ~off & ~hit_locked
        x, y = nx, ny
        if (k + 1) % CHECK_EVERY == 0 and not bool(active.any()):
            break

    xc = _cell_index(x).clamp(0, w - 1)
    yc = _cell_index(y).clamp(0, h - 1)
    end = torch.stack([x, y], -1)
    out = {
        "lengths": lengths + 1,
        "reached_goal": locked[yc, xc] & (u[yc, xc] == 0.0),
        "terminated": ~active,
        "end_xy": end,
    }
    if record_trajectories:
        # Pad the tail with the final position for clean downstream use.
        steps = torch.arange(max_steps + 1, device=dev)[None, :]
        mask = steps < (lengths + 1)[:, None]
        out["positions"] = torch.where(mask[:, :, None], traj, end[:, None, :])
    return out
