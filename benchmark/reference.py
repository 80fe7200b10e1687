"""The plain reference of the benchmark: the log-space harmonic solve and the
streamline walk, written out in plain PyTorch and NumPy.

This module is the yardstick that decides ``correct``. It imports torch and
NumPy only, nothing of the program under test, and takes nothing the program
made: it builds every field from the map, the goal cell, epsilon and the
stagger that the benchmark hands to both sides.

What it computes is the semantics of the upstream planner (kylewray/epic,
libepic ``harmonic_complete_cpu`` and ``harmonic_compute_path_2d_cpu``):

- A sweep at iteration ``t`` updates the unlocked interior cells with
  ``(y + x) % 2 != t % 2`` to the shifted log-sum-exp of their four axis
  neighbours minus log(4): the max over ((N, S), (W, E)), a left-associated
  sum of the four shifted exponentials, log, add the max, subtract log(4),
  each step rounded to the field's dtype (float32 as the deployments state).
- The solve starts at iteration 0, checks every ``stagger`` sweeps, and stops
  right after a check whose largest change is below epsilon once the
  iteration has reached ``max(H, W)``; its iteration count is then 1 mod the
  stagger.
- The walk is gradient ascent on the interpolated field with central
  differences, a unit step of ``step_size`` cells, and the upstream stuck test
  against the last five points; it ends on a locked cell.

A batch of lanes solves in lockstep, each lane retiring at its own exit, so a
lane's field and count equal a solve of that lane alone. ``solve`` takes any
floating dtype: the control of the benchmark runs it in bfloat16.
"""

from __future__ import annotations

import math

import numpy as np
import torch

GOAL = 0.0
OBSTACLE = -1e6
STUCK_HISTORY = 5
LOG4 = float(np.float32(np.log(np.float64(4.0))))


def initial_lanes(obstacle: np.ndarray, goals, device, dtype=torch.float32):
    """The fields of one map with one goal cell a lane: ``u [B, H, W]`` with
    0 at the goal and -1e6 everywhere else, and ``locked`` at the obstacles,
    the boundary ring and the goal. ``goals`` is ``(x, y)`` a lane."""
    obstacle = np.asarray(obstacle, dtype=bool)
    h, w = obstacle.shape
    locked = np.repeat(obstacle[None], len(goals), axis=0)
    locked[:, 0, :] = locked[:, -1, :] = True
    locked[:, :, 0] = locked[:, :, -1] = True
    u = np.full(locked.shape, OBSTACLE, dtype=np.float32)
    for lane, (gx, gy) in enumerate(goals):
        u[lane, gy, gx] = GOAL
        locked[lane, gy, gx] = True
    return (torch.tensor(u, device=device).to(dtype),
            torch.tensor(locked, device=device))


def _lse4(n, s, w, e):
    m = torch.maximum(torch.maximum(n, s), torch.maximum(w, e))
    t = ((torch.exp(n - m) + torch.exp(s - m)) + torch.exp(w - m)) + torch.exp(e - m)
    return (m + torch.log(t)) - LOG4


def _class_masks(locked: torch.Tensor) -> list[torch.Tensor]:
    """The cells a sweep at an even and at an odd iteration updates."""
    _, h, w = locked.shape
    y = torch.arange(1, h - 1, device=locked.device).view(-1, 1)
    x = torch.arange(1, w - 1, device=locked.device).view(1, -1)
    odd = ((y + x) % 2 == 1)
    free = ~locked[:, 1:-1, 1:-1]
    return [free & odd, free & ~odd]


def solve(u: torch.Tensor, locked: torch.Tensor, epsilon: float, stagger: int,
          max_iterations: int = 1_000_000):
    """Relax every lane of ``u [B, H, W]`` in place to its exit; returns
    ``(u, iterations [B] int64, converged [B] bool)`` on the host.

    The update writes only cells of the class being swept, whose neighbours
    are all of the other class, so updating in place reads what a copy would.
    """
    b, h, w = u.shape
    m_max = max(h, w)
    inner = u[:, 1:-1, 1:-1]
    masks = _class_masks(locked)
    active = torch.ones(b, dtype=torch.bool, device=u.device)
    iterations = np.zeros(b, dtype=np.int64)
    converged = np.zeros(b, dtype=bool)
    t = 0
    while t < max_iterations:
        for k in range(stagger):
            val = _lse4(u[:, :-2, 1:-1], u[:, 2:, 1:-1], u[:, 1:-1, :-2], u[:, 1:-1, 2:])
            new = torch.where(masks[(t + k) % 2], val, inner)
            if k == 0:
                delta = (new.float() - inner.float()).abs().amax(dim=(1, 2))
            inner.copy_(new)
            if k == 0 and t + 1 >= m_max:
                done = (delta < epsilon) & active
                if bool(done.any()):
                    lanes = done.nonzero().flatten().tolist()
                    iterations[lanes] = t + 1
                    converged[lanes] = True
                    active &= ~done
                    if not bool(active.any()):
                        return u, iterations, converged
                    masks = [mk & active.view(-1, 1, 1) for mk in masks]
            if t + k + 1 >= max_iterations:
                break
        t += stagger
    iterations[~converged] = min(t, max_iterations)
    return u, iterations, converged


# ---------------------------------------------------------------------------
# The streamline walk, many starts at once (NumPy, float32 as upstream).
# ---------------------------------------------------------------------------

OK, LOCATION, GRADIENT, SHORT = 0, 1, 2, 3   # a walk's outcome


def _cell(v: np.ndarray) -> np.ndarray:
    """(unsigned int)(v + 0.5f), -1 for a negative sum."""
    f = v.astype(np.float32) + np.float32(0.5)
    return np.where(f < 0, -1, np.trunc(np.maximum(f, 0))).astype(np.int64)


def _valid(u, locked, lane, x, y):
    """Whether each float32 pixel lies on its lane's map, not in an obstacle."""
    _, h, w = u.shape
    xc, yc = _cell(x), _cell(y)
    inside = (xc >= 0) & (yc >= 0) & (xc < w) & (yc < h)
    xs, ys = np.clip(xc, 0, w - 1), np.clip(yc, 0, h - 1)
    return inside & ~(locked[lane, ys, xs] & (u[lane, ys, xs] < 0))


def _potential(u, lane, x, y, mode: str):
    """The interpolated field at valid float32 pixels of each lane."""
    _, h, w = u.shape
    half, one = np.float32(0.5), np.float32(1.0)
    if mode == "reference":
        xtl = np.maximum(np.trunc(x - half), 0).astype(np.int64)
        ytl = np.maximum(np.trunc(y - half), 0).astype(np.int64)
        xtr = np.trunc(x + half).astype(np.int64)
        ybl = np.trunc(y + half).astype(np.int64)
    elif mode == "bilinear":
        xtl = np.minimum(np.trunc(x).astype(np.int64), w - 2)
        ytl = np.minimum(np.trunc(y).astype(np.int64), h - 2)
        xtr, ybl = xtl + 1, ytl + 1
    else:
        raise ValueError(f"unknown interpolation mode {mode!r}")
    alpha = x - xtl.astype(np.float32)
    beta = y - ytl.astype(np.float32)
    top = (one - alpha) * u[lane, ytl, xtl] + alpha * u[lane, ytl, xtr]
    bottom = (one - alpha) * u[lane, ybl, xtl] + alpha * u[lane, ybl, xtr]
    return (one - beta) * top + beta * bottom


def walk(u: np.ndarray, locked: np.ndarray, starts, step_size: float,
         cd_precision: float, max_length: int, mode: str = "reference"):
    """Walk from each ``(x, y)`` start, in map cells, on its own field
    (``u``, ``locked`` of shape ``[B, H, W]``, a start a lane) or on one
    shared field (``[H, W]``). Returns ``(outcome, points float32 [k, 2])``
    a start; the points are empty unless the outcome is ``OK``."""
    starts = np.asarray(starts, dtype=np.float64).reshape(-1, 2)
    n = len(starts)
    u = np.asarray(u, dtype=np.float32)
    locked = np.asarray(locked, dtype=bool)
    if u.ndim == 2:
        u, locked = u[None], locked[None]
        lane_of = np.zeros(n, dtype=np.int64)
    else:
        lane_of = np.arange(n)
    _, h, w = u.shape
    x = starts[:, 0].astype(np.float32)
    y = starts[:, 1].astype(np.float32)
    outcome = np.where(_valid(u, locked, lane_of, x, y), OK, LOCATION)
    points = [[(float(a), float(b))] for a, b in zip(x, y)]
    # The newest point and the five before it, for the stuck test.
    hist = np.zeros((n, STUCK_HISTORY + 1, 2))
    hist[:, 0, 0], hist[:, 0, 1] = x, y
    count = np.ones(n, dtype=np.int64)
    xc, yc = _cell(x), _cell(y)
    step = np.float32(step_size)
    cd2 = np.float32(2.0) * np.float32(cd_precision)
    idx = np.flatnonzero(outcome == OK)
    while len(idx):
        stuck = np.zeros(len(idx), dtype=bool)
        if len(idx):
            last = hist[idx, (count[idx] - 1) % (STUCK_HISTORY + 1)]
            for back in range(1, STUCK_HISTORY + 1):
                has = count[idx] - 1 - back >= 0
                prev = hist[idx, (count[idx] - 1 - back) % (STUCK_HISTORY + 1)]
                d = np.sqrt((last[:, 0] - prev[:, 0]) ** 2 + (last[:, 1] - prev[:, 1]) ** 2)
                stuck |= has & (d < step_size / 2.0)
        on_lock = locked[lane_of[idx], yc[idx], xc[idx]]
        idx = idx[~on_lock & ~stuck & (count[idx] < max_length)]
        if not len(idx):
            break
        xf, yf = x[idx].astype(np.float64), y[idx].astype(np.float64)
        sx = np.concatenate([xf - cd_precision, xf + cd_precision, xf, xf]).astype(np.float32)
        sy = np.concatenate([yf, yf, yf - cd_precision, yf + cd_precision]).astype(np.float32)
        lane4 = np.tile(lane_of[idx], 4)
        ok = _valid(u, locked, lane4, sx, sy)
        v = _potential(u, lane4, np.where(ok, sx, np.float32(1)),
                       np.where(ok, sy, np.float32(1)), mode).reshape(4, -1)
        px = (v[1] - v[0]) / cd2
        py = (v[3] - v[2]) / cd2
        with np.errstate(invalid="ignore", over="ignore"):
            denom = np.sqrt(px.astype(np.float64) ** 2 + py.astype(np.float64) ** 2
                            ).astype(np.float32)
        bad = ~ok.reshape(4, -1).all(axis=0) | (denom == 0) | ~np.isfinite(denom)
        outcome[idx[bad]] = GRADIENT
        keep = ~bad
        idx, px, py, denom = idx[keep], px[keep], py[keep], denom[keep]
        x[idx] = x[idx] + (px / denom) * step
        y[idx] = y[idx] + (py / denom) * step
        slot = count[idx] % (STUCK_HISTORY + 1)
        hist[idx, slot, 0], hist[idx, slot, 1] = x[idx], y[idx]
        count[idx] += 1
        for i, a, b in zip(idx.tolist(), x[idx].tolist(), y[idx].tolist()):
            points[i].append((a, b))
        xc[idx], yc[idx] = _cell(x[idx]), _cell(y[idx])
        off = (xc[idx] < 0) | (yc[idx] < 0) | (xc[idx] >= w) | (yc[idx] >= h)
        outcome[idx[off]] = GRADIENT
        idx = idx[~off]
    out = []
    for i in range(n):
        if outcome[i] == OK and len(points[i]) <= 2:
            outcome[i] = SHORT
        pts = np.asarray(points[i] if outcome[i] == OK else np.zeros((0, 2)), dtype=np.float32)
        out.append((int(outcome[i]), pts))
    return out


def _stuck_along(points: np.ndarray, step_size: float) -> np.ndarray:
    """For each point of a walk, whether it lies within half a step of any of
    the five points before it (the upstream stuck test, in float64)."""
    p = points.astype(np.float64)
    stuck = np.zeros(len(p), dtype=bool)
    for back in range(1, STUCK_HISTORY + 1):
        d = np.sqrt(((p[back:] - p[:-back]) ** 2).sum(axis=1))
        stuck[back:] |= d < step_size / 2.0
    return stuck


def step_gap(u: np.ndarray, locked: np.ndarray, start, points: np.ndarray,
             step_size: float, cd_precision: float, max_length: int,
             mode: str = "reference") -> float:
    """How far a walk strays from this field's streamline, checked a step at
    a time from its own points: the largest distance, in cells, between a
    point and the step the walk rule takes from the point before it. ``inf``
    where the walk breaks the rule's structure: another start, a step from a
    point where the walk must end or cannot go on, an end where it must go
    on, or fewer than three points. A walk that is the rule's own walk from
    ``start`` reads 0; it is checked whole, since each step follows from the
    one before."""
    u = np.asarray(u, dtype=np.float32)[None]
    locked = np.asarray(locked, dtype=bool)[None]
    p = np.asarray(points, dtype=np.float64).astype(np.float32)
    k = len(p)
    _, h, w = u.shape
    first = np.asarray(start, dtype=np.float64).astype(np.float32)
    if k <= 2 or not np.array_equal(p[0], first):
        return math.inf
    lane = np.zeros(k, dtype=np.int64)
    if not _valid(u, locked, lane[:1], p[:1, 0], p[:1, 1])[0]:
        return math.inf
    xc, yc = _cell(p[:, 0]), _cell(p[:, 1])
    if ((xc < 0) | (yc < 0) | (xc >= w) | (yc >= h)).any():
        return math.inf
    terminal = locked[0, yc, xc] | _stuck_along(p, step_size)
    terminal |= np.arange(1, k + 1) >= max_length
    if terminal[:-1].any() or not terminal[-1]:
        return math.inf
    xf, yf = p[:-1, 0].astype(np.float64), p[:-1, 1].astype(np.float64)
    sx = np.concatenate([xf - cd_precision, xf + cd_precision, xf, xf]).astype(np.float32)
    sy = np.concatenate([yf, yf, yf - cd_precision, yf + cd_precision]).astype(np.float32)
    lane4 = np.zeros(len(sx), dtype=np.int64)
    ok = _valid(u, locked, lane4, sx, sy)
    if not ok.all():
        return math.inf
    v = _potential(u, lane4, sx, sy, mode).reshape(4, -1)
    cd2 = np.float32(2.0) * np.float32(cd_precision)
    px = (v[1] - v[0]) / cd2
    py = (v[3] - v[2]) / cd2
    with np.errstate(invalid="ignore", over="ignore"):
        denom = np.sqrt(px.astype(np.float64) ** 2 + py.astype(np.float64) ** 2
                        ).astype(np.float32)
    if ((denom == 0) | ~np.isfinite(denom)).any():
        return math.inf
    step = np.float32(step_size)
    nx = p[:-1, 0] + (px / denom) * step
    ny = p[:-1, 1] + (py / denom) * step
    d = np.hypot(p[1:, 0].astype(np.float64) - nx, p[1:, 1].astype(np.float64) - ny)
    return float(d.max())
