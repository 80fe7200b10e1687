"""The plain reference of the volume cells: the 3D log-space harmonic solve
and the trilinear streamline walk, written out in plain PyTorch and NumPy.

The yardstick that decides ``correct`` for a mix whose comparison is
``checks/volume.py``. It imports torch and NumPy only, nothing of the program
under test, and takes nothing the program made: it builds every field from
the volume's locked voxels (:func:`benchmark.volume.locked`), the goal voxel,
epsilon and the stagger that the benchmark hands to both sides.

What it computes is the semantics of the upstream 3D solver (kylewray/epic,
libepic ``harmonic_update_3d_cpu``, ``harmonic_cpu.cpp:81-133``, under the
``harmonic_complete`` protocol) and of the program's 3D walk rule:

- A sweep at iteration ``t`` updates the unlocked interior voxels with
  ``(z + y + x) % 2 == t % 2`` (the opposite class to the 2D rule's) to the
  shifted log-sum-exp of their six axis neighbours minus log(6): the
  neighbours in the order (z-, z+, y-, y+, x-, x+), a left-to-right max
  chain, a left-associated sum of the six shifted exponentials, log, add the
  max, subtract log(6), each step rounded to the field's dtype (float32 as
  the configurations state). A swept voxel's neighbours are all of the other
  class or locked, so the sweep gathers them, computes the update for the
  swept class alone and writes it back.
- The solve starts at iteration 0, checks every ``stagger`` sweeps, and stops
  right after a check whose largest change is below epsilon once the
  iteration has reached ``max(D, H, W)``.
- The walk is gradient ascent on the trilinear interpolation of the 8
  surrounding voxel centres (corners ``floor(v)`` and ``floor(v) + 1``,
  clamped inside the volume), with central differences at ``cd_precision``
  (each sample point the float64 difference rounded once to float32), the
  gradient's norm in float64 rounded once, a float32 step of ``step_size``
  voxels, and the stuck test (within half a step of one of the last five
  points, in float64); it ends on a locked voxel or at its point budget, and
  fails where a sample leaves the volume or enters an obstacle, where the
  gradient vanishes, where a step leaves the volume, or with fewer than
  three points.

``solve`` takes any floating dtype: the control of the check runs it in
bfloat16.
"""

from __future__ import annotations

import math

import numpy as np
import torch

GOAL = 0.0
OBSTACLE = -1e6
STUCK_HISTORY = 5
LOG6 = float(np.float32(np.log(np.float64(6.0))))

OK, LOCATION, GRADIENT, SHORT = 0, 1, 2, 3   # a walk's outcome


def initial_field(locked: np.ndarray, goal, device, dtype=torch.float32):
    """``u [D, H, W]``, 0 at the goal voxel ``(x, y, z)`` and -1e6 everywhere
    else, and ``locked`` with the goal added; both on ``device``."""
    gx, gy, gz = (int(v) for v in goal)
    lk = np.array(locked, dtype=bool)
    lk[gz, gy, gx] = True
    u = torch.full(lk.shape, OBSTACLE, dtype=torch.float32, device=device)
    u[gz, gy, gx] = GOAL
    return u.to(dtype), torch.tensor(lk, device=device)


def lse6(zm, zp, ym, yp, xm, xp):
    """Six-neighbour shifted logsumexp minus log(6), elementwise."""
    nbrs = (zm, zp, ym, yp, xm, xp)
    m = nbrs[0]
    for nb in nbrs[1:]:
        m = torch.maximum(m, nb)
    s = torch.exp(nbrs[0] - m)
    for nb in nbrs[1:]:
        s = s + torch.exp(nb - m)
    return (m + torch.log(s)) - LOG6


def _classes(locked: torch.Tensor) -> list[tuple[torch.Tensor, list[torch.Tensor]]]:
    """For the sweeps at even and at odd iterations: the flat indices of the
    voxels they update (unlocked, interior, ``(z + y + x) % 2 == t % 2``) and
    of those voxels' six neighbours, in the order (z-, z+, y-, y+, x-, x+)."""
    d, h, w = locked.shape
    dev = locked.device
    inner = torch.zeros_like(locked)
    inner[1:-1, 1:-1, 1:-1] = True
    parity = ((torch.arange(d, device=dev).view(-1, 1, 1)
               + torch.arange(h, device=dev).view(1, -1, 1)
               + torch.arange(w, device=dev).view(1, 1, -1)) % 2).bool()
    free = inner & ~locked
    out = []
    for odd in (False, True):
        idx = (free & (parity == odd)).flatten().nonzero().flatten()
        out.append((idx, [idx + off for off in (-h * w, h * w, -w, w, -1, 1)]))
    return out


def solve(u: torch.Tensor, locked: torch.Tensor, epsilon: float, stagger: int,
          max_iterations: int = 1_000_000) -> tuple[torch.Tensor, int, bool]:
    """Relax ``u [D, H, W]`` in place to its exit; returns ``(u, iterations,
    converged)``. A capped solve stops after ``max_iterations`` sweeps."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m_max = max(u.shape)
    flat = u.view(-1)
    classes = _classes(locked)
    t = 0
    while t < max_iterations:
        for k in range(stagger):
            idx, nbrs = classes[(t + k) % 2]
            new = lse6(*(flat[n] for n in nbrs))
            if k == 0:
                delta = ((new.float() - flat[idx].float()).abs().amax()
                         if len(idx) else torch.zeros((), device=u.device))
            flat[idx] = new
            if k == 0 and t + 1 >= m_max and bool(delta < epsilon):
                return u, t + 1, True
            if t + k + 1 >= max_iterations:
                return u, t + k + 1, False
        t += stagger
    return u, t, False


# ---------------------------------------------------------------------------
# The trilinear walk (NumPy, float32 as the program's walker).
# ---------------------------------------------------------------------------

def _cell(v: np.ndarray) -> np.ndarray:
    """(unsigned int)(v + 0.5f), -1 for a negative sum."""
    f = np.asarray(v, dtype=np.float32) + np.float32(0.5)
    return np.where(f < 0, -1, np.trunc(np.maximum(f, 0))).astype(np.int64)


def _valid(u, locked, x, y, z):
    """Whether each float32 point lies in the volume, not in an obstacle."""
    d, h, w = u.shape
    xc, yc, zc = _cell(x), _cell(y), _cell(z)
    inside = (xc >= 0) & (yc >= 0) & (zc >= 0) & (xc < w) & (yc < h) & (zc < d)
    xs, ys, zs = np.clip(xc, 0, w - 1), np.clip(yc, 0, h - 1), np.clip(zc, 0, d - 1)
    return inside & ~(locked[zs, ys, xs] & (u[zs, ys, xs] < 0))


def _potential(u, x, y, z):
    """The trilinear field at valid float32 points: bilinear on the lower
    plane and on the upper one, then a lerp along z."""
    d, h, w = u.shape
    one = np.float32(1.0)
    x0 = np.minimum(np.trunc(x).astype(np.int64), w - 2)
    y0 = np.minimum(np.trunc(y).astype(np.int64), h - 2)
    z0 = np.minimum(np.trunc(z).astype(np.int64), d - 2)
    a = x - x0.astype(np.float32)
    b = y - y0.astype(np.float32)
    c = z - z0.astype(np.float32)
    p00 = (one - a) * u[z0, y0, x0] + a * u[z0, y0, x0 + 1]
    p01 = (one - a) * u[z0, y0 + 1, x0] + a * u[z0, y0 + 1, x0 + 1]
    pz0 = (one - b) * p00 + b * p01
    p10 = (one - a) * u[z0 + 1, y0, x0] + a * u[z0 + 1, y0, x0 + 1]
    p11 = (one - a) * u[z0 + 1, y0 + 1, x0] + a * u[z0 + 1, y0 + 1, x0 + 1]
    pz1 = (one - b) * p10 + b * p11
    return (one - c) * pz0 + c * pz1


def _steps(u, locked, p: np.ndarray, step_size: float, cd_precision: float):
    """The walk rule's step from each float32 point of ``p [n, 3]``: returns
    ``(ok [n], next [n, 3] float32)``; ``ok`` is False where a sample point
    is not valid or the gradient vanishes."""
    n = len(p)
    xf, yf, zf = (p[:, i].astype(np.float64) for i in range(3))
    cd = cd_precision
    sx = np.concatenate([xf - cd, xf + cd, xf, xf, xf, xf]).astype(np.float32)
    sy = np.concatenate([yf, yf, yf - cd, yf + cd, yf, yf]).astype(np.float32)
    sz = np.concatenate([zf, zf, zf, zf, zf - cd, zf + cd]).astype(np.float32)
    ok = _valid(u, locked, sx, sy, sz)
    one = np.float32(1.0)
    v = _potential(u, np.where(ok, sx, one), np.where(ok, sy, one),
                   np.where(ok, sz, one)).reshape(6, n)
    cd2 = np.float32(2.0) * np.float32(cd_precision)
    px = (v[1] - v[0]) / cd2
    py = (v[3] - v[2]) / cd2
    pz = (v[5] - v[4]) / cd2
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        p64 = [q.astype(np.float64) for q in (px, py, pz)]
        denom = np.sqrt(p64[0] * p64[0] + p64[1] * p64[1] + p64[2] * p64[2]).astype(np.float32)
        good = ok.reshape(6, n).all(axis=0) & (denom != 0) & np.isfinite(denom)
        step = np.float32(step_size)
        nxt = np.stack([p[:, 0] + (px / denom) * step, p[:, 1] + (py / denom) * step,
                        p[:, 2] + (pz / denom) * step], axis=1)
    return good, nxt


def _stuck(newest: np.ndarray, before: np.ndarray, step_size: float) -> bool:
    """Whether ``newest`` lies within half a step of a row of ``before``
    (float64 distances)."""
    if not len(before):
        return False
    dv = before.astype(np.float64) - newest.astype(np.float64)
    return bool((np.sqrt(dv[:, 0] * dv[:, 0] + dv[:, 1] * dv[:, 1] + dv[:, 2] * dv[:, 2])
                 < step_size / 2.0).any())


def walk(u: np.ndarray, locked: np.ndarray, start, step_size: float, cd_precision: float,
         max_length: int) -> tuple[int, np.ndarray]:
    """Walk from ``start``, ``(x, y, z)`` in voxels. Returns ``(outcome,
    points float32 [k, 3])``; the points are empty unless the outcome is
    ``OK``."""
    u = np.asarray(u, dtype=np.float32)
    locked = np.asarray(locked, dtype=bool)
    d, h, w = u.shape
    p = np.asarray(start, dtype=np.float64).astype(np.float32).reshape(1, 3)
    if not _valid(u, locked, p[:, 0], p[:, 1], p[:, 2])[0]:
        return LOCATION, np.zeros((0, 3), np.float32)
    points = [p[0]]
    while True:
        last = points[-1]
        xc, yc, zc = (int(v) for v in _cell(last))
        if (locked[zc, yc, xc] or len(points) >= max_length
                or _stuck(last, np.asarray(points[-1 - STUCK_HISTORY:-1]), step_size)):
            break
        good, nxt = _steps(u, locked, last.reshape(1, 3), step_size, cd_precision)
        if not good[0]:
            return GRADIENT, np.zeros((0, 3), np.float32)
        q = nxt[0]
        c = _cell(q)
        if (c < 0).any() or c[0] >= w or c[1] >= h or c[2] >= d:
            return GRADIENT, np.zeros((0, 3), np.float32)
        points.append(q)
    if len(points) <= 2:
        return SHORT, np.zeros((0, 3), np.float32)
    return OK, np.asarray(points, dtype=np.float32)


def _stuck_along(points: np.ndarray, step_size: float) -> np.ndarray:
    """For each point of a walk, whether it lies within half a step of any of
    the five points before it (float64)."""
    p = points.astype(np.float64)
    stuck = np.zeros(len(p), dtype=bool)
    for back in range(1, STUCK_HISTORY + 1):
        dv = p[back:] - p[:-back]
        d = np.sqrt(dv[:, 0] * dv[:, 0] + dv[:, 1] * dv[:, 1] + dv[:, 2] * dv[:, 2])
        stuck[back:] |= d < step_size / 2.0
    return stuck


def step_gap(u: np.ndarray, locked: np.ndarray, start, points: np.ndarray,
             step_size: float, cd_precision: float, max_length: int) -> float:
    """How far a walk strays from this field's streamline, checked a step at
    a time from its own points: the largest distance, in voxels, between a
    point and the step the walk rule takes from the point before it. ``inf``
    where the walk breaks the rule's structure: another start, a step from a
    point where the walk must end or cannot go on, an end where it must go
    on, or fewer than three points. The rule's own walk from ``start``
    reads 0."""
    u = np.asarray(u, dtype=np.float32)
    locked = np.asarray(locked, dtype=bool)
    p = np.asarray(points, dtype=np.float64).astype(np.float32).reshape(-1, 3)
    k = len(p)
    d, h, w = u.shape
    first = np.asarray(start, dtype=np.float64).astype(np.float32)
    if k <= 2 or not np.array_equal(p[0], first):
        return math.inf
    if not _valid(u, locked, p[:1, 0], p[:1, 1], p[:1, 2])[0]:
        return math.inf
    xc, yc, zc = _cell(p[:, 0]), _cell(p[:, 1]), _cell(p[:, 2])
    if ((xc < 0) | (yc < 0) | (zc < 0) | (xc >= w) | (yc >= h) | (zc >= d)).any():
        return math.inf
    terminal = locked[zc, yc, xc] | _stuck_along(p, step_size)
    terminal |= np.arange(1, k + 1) >= max_length
    if terminal[:-1].any() or not terminal[-1]:
        return math.inf
    good, nxt = _steps(u, locked, p[:-1], step_size, cd_precision)
    if not good.all():
        return math.inf
    dv = p[1:].astype(np.float64) - nxt.astype(np.float64)
    return float(np.sqrt((dv * dv).sum(axis=1)).max())
