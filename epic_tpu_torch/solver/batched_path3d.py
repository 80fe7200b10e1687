"""Batched 3D streamline extraction: B walkers in lockstep on torch tensors.

The counterpart of ``epic_tpu.solver.batched_path3d``, with the semantics
of the host 3D walker (:mod:`epic_tpu_torch.path3d`). Per step: a batched
trilinear gather over ``u[z, y, x]``, a central-difference gradient on all
three axes, a unit step, per-lane termination (locked cell / 5-point stuck
ring / budget). Interpolation never extrapolates: the ``mode="reference"``
quirk is a 2D behaviour with no 3D twin. Plain torch on ``u``'s device, with
the early stop of :mod:`.batched_path`.
"""

from __future__ import annotations

import torch

from .. import constants as C
from .batched_path import CHECK_EVERY, _cell_index


def _potential(u, x, y, z):
    """Batched trilinear potential at the points (x, y, z) over u[D, H, W]."""
    d, h, w = u.shape
    x0 = x.to(torch.int64).clamp(0, w - 2)
    y0 = y.to(torch.int64).clamp(0, h - 2)
    z0 = z.to(torch.int64).clamp(0, d - 2)
    a = x - x0.to(torch.float32)
    b = y - y0.to(torch.float32)
    c = z - z0.to(torch.float32)
    x1, y1, z1 = x0 + 1, y0 + 1, z0 + 1
    c00 = (1.0 - a) * u[z0, y0, x0] + a * u[z0, y0, x1]
    c01 = (1.0 - a) * u[z0, y1, x0] + a * u[z0, y1, x1]
    c10 = (1.0 - a) * u[z1, y0, x0] + a * u[z1, y0, x1]
    c11 = (1.0 - a) * u[z1, y1, x0] + a * u[z1, y1, x1]
    c0 = (1.0 - b) * c00 + b * c01
    c1 = (1.0 - b) * c10 + b * c11
    return (1.0 - c) * c0 + c * c1


def walk(
    u: torch.Tensor,
    locked: torch.Tensor,
    starts,
    step_size: float = C.DEFAULT_STEP_SIZE,
    cd_precision: float = C.DEFAULT_CD_PRECISION,
    max_steps: int = 2048,
    record_trajectories: bool = True,
) -> dict:
    """Walk B 3D streamlines on ``u``'s device.

    Args:
      u: f32[D, H, W] solved log-potential volume.
      locked: bool[D, H, W].
      starts: f32[B, 3] (x, y, z) start positions (array or tensor).

    Returns a dict of tensors: lengths i32[B], reached_goal bool[B],
    terminated bool[B], end_xyz f32[B, 3], and (when record_trajectories)
    positions f32[B, max_steps + 1, 3] padded with the final position.
    """
    d, h, w = u.shape
    dev = u.device
    starts = torch.as_tensor(starts, dtype=torch.float32, device=dev)
    b = starts.shape[0]
    x, y, z = starts[:, 0], starts[:, 1], starts[:, 2]
    lane = torch.arange(b, device=dev)

    def in_bounds(xc, yc, zc):
        return (xc >= 0) & (yc >= 0) & (zc >= 0) & (xc < w) & (yc < h) & (zc < d)

    def cell_locked(xc, yc, zc):
        return locked[zc.clamp(0, d - 1), yc.clamp(0, h - 1), xc.clamp(0, w - 1)]

    xc, yc, zc = _cell_index(x), _cell_index(y), _cell_index(z)
    active = in_bounds(xc, yc, zc) & ~cell_locked(xc, yc, zc)

    history = torch.full((b, C.PATH_STUCK_HISTORY_LENGTH, 3), float("inf"), device=dev)
    history[:, 0] = torch.stack([x, y, z], -1)
    if record_trajectories:
        traj = torch.zeros((b, max_steps + 1, 3), device=dev)
        traj[:, 0] = torch.stack([x, y, z], -1)
    lengths = torch.zeros(b, dtype=torch.int32, device=dev)

    cd = cd_precision
    for k in range(max_steps):
        # The six central-difference samples as one batch of 6B points, in
        # the order (x+, x-, y+, y-, z+, z-).
        v = _potential(u, torch.cat([x + cd, x - cd, x, x, x, x]),
                       torch.cat([y, y, y + cd, y - cd, y, y]),
                       torch.cat([z, z, z, z, z + cd, z - cd])).view(6, b)
        gx = (v[0] - v[1]) / (2.0 * cd)
        gy = (v[2] - v[3]) / (2.0 * cd)
        gz = (v[4] - v[5]) / (2.0 * cd)
        norm = torch.sqrt(gx * gx + gy * gy + gz * gz)
        grad_ok = (norm > 0.0) & torch.isfinite(norm)
        safe = torch.where(grad_ok, norm, 1.0)
        stepped = active & grad_ok
        nx = torch.where(stepped, x + gx / safe * step_size, x)
        ny = torch.where(stepped, y + gy / safe * step_size, y)
        nz = torch.where(stepped, z + gz / safe * step_size, z)

        dx = history[:, :, 0] - nx[:, None]
        dy = history[:, :, 1] - ny[:, None]
        dz = history[:, :, 2] - nz[:, None]
        stuck = (torch.sqrt(dx * dx + dy * dy + dz * dz) < step_size / 2.0).any(1)

        xc, yc, zc = _cell_index(nx), _cell_index(ny), _cell_index(nz)
        off = ~in_bounds(xc, yc, zc)
        hit_locked = cell_locked(xc, yc, zc)

        lengths = torch.where(stepped, lengths + 1, lengths)
        pos = torch.stack([nx, ny, nz], -1)
        if record_trajectories:
            traj[lane, lengths.clamp(0, max_steps).long()] = pos
        history = torch.cat([pos[:, None], history[:, :-1]], 1)
        active = stepped & ~stuck & ~off & ~hit_locked
        x, y, z = nx, ny, nz
        if (k + 1) % CHECK_EVERY == 0 and not bool(active.any()):
            break

    xc = _cell_index(x).clamp(0, w - 1)
    yc = _cell_index(y).clamp(0, h - 1)
    zc = _cell_index(z).clamp(0, d - 1)
    end = torch.stack([x, y, z], -1)
    out = {
        "lengths": lengths + 1,
        "reached_goal": locked[zc, yc, xc] & (u[zc, yc, xc] == 0.0),
        "terminated": ~active,
        "end_xyz": end,
    }
    if record_trajectories:
        steps = torch.arange(max_steps + 1, device=dev)[None, :]
        mask = steps < (lengths + 1)[:, None]
        out["positions"] = torch.where(mask[:, :, None], traj, end[:, None, :])
    return out
