"""The 3D anytime stepper and solve on the CUDA kernels.

The counterpart of ``epic_tpu.solver.pallas_sweep3d``: ``update_n`` launches
``epic_sweep3d_chunk`` (for ``_multisweep3d_kernel`` behind
``sweep3d_chunk_flat``) and ``solve`` launches ``epic_sweep3d_solve`` (for
``_solve_padded``'s while-loop of that kernel), both from
``csrc/sweep3d.cu``. A volume on the CPU goes to the plain version in
:mod:`.core`; a volume on a CUDA device goes to the kernel or raises. The
kernels take the unpadded volume, in place: keep only the returned state.

The kernels' walk (the note at the head of ``csrc/sweep3d.cu``): a lane
owns a quad, 8 consecutive voxels of a row, and walks a segment of planes
along z; a block's lanes are a patch of rows, and a block walks units
(segment, patch). :func:`plan` mirrors the C entries' plan and
:func:`walk_cells` the voxels a sweep updates and writes, so the CPU tests
hold the index arithmetic to the interior and its class.

``launches`` counts each kernel's launches; nothing else changes it.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np

from .. import constants as C
from ..grid import GridState
from . import core
from .hopper_sweep import _check_cuda_state, launch_chunk, launch_solve

launches = {"epic_sweep3d_chunk": 0, "epic_sweep3d_solve": 0}

# The constants of csrc/sweep3d.cu: lanes a block (kThreads3d), quads across
# a patch at most (kMaxBand) and at least (kMinBand).
THREADS = 512
MAX_BAND = 32
MIN_BAND = 8
H100_SLOTS = 132   # the slots of an H100 (one block an SM), for a plan on the CPU
# Alignment the kernels take: u 16-byte (the quads' 16-byte loads), locked
# 4-byte (the quads' locked bytes, 4 at a time).
U_ALIGN, LOCKED_ALIGN = 16, 4


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch's plan (``make_plan`` of ``csrc/sweep3d.cu``): the interior
    planes in ``segments`` segments of ``tz`` (the last ragged); a patch of
    ``rb`` rows of ``pw`` quads, ``nb`` patches across a row's quads and
    ``nrb`` down the interior rows; ``units`` = segments x nrb x nb, walked
    by ``blocks`` blocks."""

    segments: int
    tz: int
    pw: int
    rb: int
    nb: int
    nrb: int
    units: int
    blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _band_cost(pw: int) -> int:
    """A lane's relative cost in a patch ``pw`` quads wide, in hundredths
    (``band_cost`` of ``csrc/sweep3d.cu``)."""
    return 100 if pw >= 32 else 103 if pw >= 16 else 110


def plan(shape, slots: int = H100_SLOTS) -> Plan:
    """The plan of a ``D x H x W`` volume on a card that holds ``slots``
    blocks at once: patches of 32, 16 or 8 quads (whole warps on rows of
    one class offset; the width whose lanes, padded and weighted by
    ``_band_cost``, are fewest), a power of two up to 8 on shorter rows, and the
    segment count whose rounds x (tz + 2) steps is least (the fewest
    segments on a tie). A volume with no interior has no units (and one idle block)."""
    d, h, w = shape
    if d < 3 or h < 3 or w < 3:
        return Plan(0, 0, 1, 1, 1, 1, 0, 1)
    n = d - 2
    qw = _cdiv(w, 8)
    pw = 1
    while pw < qw and pw < MIN_BAND:
        pw *= 2
    if qw >= MIN_BAND:
        pw = MAX_BAND
        c = MAX_BAND // 2
        while c >= MIN_BAND:
            if _cdiv(qw, c) * c * _band_cost(c) < _cdiv(qw, pw) * pw * _band_cost(pw):
                pw = c
            c //= 2
    nb = _cdiv(qw, pw)
    rb = THREADS // pw
    nrb = _cdiv(h - 2, rb)
    patches = nb * nrb
    slots = max(slots, 1)
    best = None
    for want in range(1, n + 1):
        tz = _cdiv(n, want)
        segments = _cdiv(n, tz)
        cost = _cdiv(segments * patches, slots) * (tz + 2)
        if best is None or cost < best[0]:
            best = (cost, segments, tz)
    _, segments, tz = best
    units = segments * patches
    return Plan(segments, tz, pw, rb, nb, nrb, units, min(max(units, 1), slots))


def walk_cells(shape, q: int, p: Plan) -> tuple[np.ndarray, np.ndarray]:
    """The voxels one sweep of class ``q`` visits and writes under plan
    ``p``, as the kernels walk them, with nothing locked: ``(updates,
    writes)``, each a count a voxel. Block b takes units b, b + blocks, ...
    (digits advanced by carries), lane tid the quad x0 = 8 (cb pw + j) of
    row 1 + rb' rb + r, j = tid % pw, r the patch's even rows and then its
    odd rows over the slots tid // pw, planes 1 + seg tz .. on; a plane's class
    offset o = (q + z + y) & 1, the updated offsets o, o + 2, o + 4, o + 6
    where x is not the shell. With W % 4 == 0 a half quad inside x = 1 ..
    W - 2 with an update is stored whole (one 16-byte store), else only the
    updated voxels."""
    d, h, w = shape
    updates = np.zeros(d * h * w, np.int64)
    writes = np.zeros(d * h * w, np.int64)
    tid = np.arange(THREADS)
    slot, j = tid // p.pw, tid % p.pw
    evens = (p.rb + 1) // 2
    r = np.where(slot < evens, 2 * slot, 2 * (slot - evens) + 1)   # even rows first
    lane_ok = slot < p.rb
    vec = w % 4 == 0

    def digits(v: int):
        return v % p.nb, (v // p.nb) % p.nrb, v // (p.nb * p.nrb)

    step = digits(p.blocks)
    k = np.arange(8)
    for b in range(min(p.blocks, p.units)):
        cb, rb, seg = digits(b)
        for _ in range(b, p.units, p.blocks):
            y = 1 + rb * p.rb + r
            x0 = 8 * (cb * p.pw + j)
            ok = lane_ok & (y <= h - 2) & (x0 < w)
            ys, x0s = y[ok], x0[ok]
            z0 = 1 + seg * p.tz
            for z in range(z0, min(z0 + p.tz, d - 1)):
                x = x0s[:, None] + k[None, :]                      # lanes x 8
                shell = (x == 0) | (x >= w - 1)
                o = (q + z + ys) & 1
                upd = ~shell & ((k[None, :] & 1) == o[:, None])
                flat = (z * h + ys[:, None]) * w + x
                np.add.at(updates, flat[upd], 1)
                wrote = upd.copy()
                if vec:
                    for half in (0, 1):
                        cols = slice(4 * half, 4 * half + 4)
                        whole = (x0s + 4 * half >= 1) & (x0s + 4 * half + 3 <= w - 2)
                        any_upd = upd[:, cols].any(axis=1)
                        wrote[whole & any_upd, cols] = True
                np.add.at(writes, flat[wrote], 1)
            cb, c = cb + step[0], 0
            if cb >= p.nb:
                cb, c = cb - p.nb, 1
            rb, c = rb + step[1] + c, 0
            if rb >= p.nrb:
                rb, c = rb - p.nrb, 1
            seg += step[2] + c
    return updates.reshape(shape), writes.reshape(shape)


def check_aligned(u, locked) -> None:
    """Raise ``ValueError`` unless ``u`` starts on a 16-byte and ``locked``
    on a 4-byte boundary, as the kernels' quad loads need (a view into a
    larger tensor may not)."""
    for name, t, align in (("u", u, U_ALIGN), ("locked", locked, LOCKED_ALIGN)):
        if t.data_ptr() % align:
            raise ValueError(f"hopper_sweep3d needs {name} aligned to {align} bytes, "
                             f"got address {t.data_ptr():#x}")


def slots(device) -> tuple[int, int]:
    """The blocks the card of CUDA ``device`` holds at once of the chunk
    and the solve kernel (the plan's ``slots``)."""
    from . import _build

    out = (ctypes.c_int * 2)()
    _build.check(_build.load().epic_sweep3d_slots(device.index or 0, ctypes.addressof(out)),
                 "epic_sweep3d_slots")
    return out[0], out[1]


def _check_volume(state: GridState) -> None:
    if state.u.ndim != 3:
        raise ValueError(f"hopper_sweep3d requires a 3D volume, got {state.u.ndim}D")


def _check_cuda_volume(state: GridState) -> None:
    _check_cuda_state(state, 3)
    check_aligned(state.u, state.locked)


def update_n(state: GridState, num_steps: int) -> GridState:
    """``num_steps`` sweeps, delta from the first; semantics of
    :func:`epic_tpu_torch.solver.core.update_n` on a volume."""
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    _check_volume(state)
    if state.u.device.type == "cpu":
        return core.update_n(state, num_steps)
    _check_cuda_volume(state)
    return launch_chunk(state, num_steps, "epic_sweep3d_chunk", launches)


def solve(
    state: GridState,
    stagger: int = C.DEFAULT_STAGGER,
    max_iterations: int = 1_000_000,
) -> GridState:
    """Relax a volume to convergence in one launch; protocol of
    :func:`epic_tpu_torch.solver.core.solve` (exit only right after a
    passing check with ``iteration >= max(D, H, W)``)."""
    if stagger < 1:
        raise ValueError(f"stagger must be >= 1, got {stagger}")
    _check_volume(state)
    if state.u.device.type == "cpu":
        return core.solve(state, stagger, max_iterations)
    _check_cuda_volume(state)
    return launch_solve(state, stagger, max_iterations, "epic_sweep3d_solve", launches)
