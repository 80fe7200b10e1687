"""The grid state and its cell edits, on torch tensors.

The counterpart of ``epic_tpu.grid`` (2D and 3D). ``GridState`` holds the
same six fields as the JAX pytree, with the scalars kept as 0-d tensors on
the state's device, so an anytime tick never waits for the host.

Mutation rule: the edits here (``set_cells``, ``reset_free_cells``) return a
state with fresh tensors and leave their input intact. The solver entry
points do not: on a CUDA tensor the kernels relax ``u`` in place and the
returned state holds the same tensor (the JAX package donates the buffer
instead). Keep only the state a solver call returns.

Coordinate convention matches the reference: ``u`` is indexed ``[y, x]``
(row major, ``m[0] = height``, ``m[1] = width``), and cell-edit vectors are
``(x, y)`` pairs (harmonic_utilities_cpu.cpp:47-49). A volume is indexed
``[z, y, x]`` and its edits are ``(x, y, z)`` triples.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from . import constants as C
from . import profiling


@dataclasses.dataclass(frozen=True, eq=False)
class GridState:
    """Log-space harmonic grid state (2D or 3D).

    Attributes:
      u: float32[H, W] or [D, H, W] log-potentials. GOAL cells hold 0.0;
        OBSTACLE and unrelaxed FREE cells hold -1e6 (constants.h:41-43).
      locked: bool, u's shape. Locked cells are never updated by the solver
        (harmonic_cpu.cpp:53).
      iteration: int32 0-d tensor; the reference's ``currentIteration``.
        Parity of the red-black sweep is derived from it.
      delta: float32 0-d tensor; max |u' - u| over the cells updated in the
        most recent *checked* sweep (harmonic_cpu.cpp:74).
      converged: bool 0-d tensor; the most recent check's verdict. Not
        sticky: plain sweeps reset it to False (harmonic_cpu.cpp:158-173).
      epsilon: float32 0-d tensor; the convergence threshold in log space.
    """

    u: torch.Tensor
    locked: torch.Tensor
    iteration: torch.Tensor
    delta: torch.Tensor
    converged: torch.Tensor
    epsilon: torch.Tensor

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.u.shape)

    @property
    def height(self) -> int:
        return self.u.shape[0]

    @property
    def width(self) -> int:
        return self.u.shape[1]

    @property
    def ndim_grid(self) -> int:
        return self.u.ndim

    @property
    def device(self) -> torch.device:
        return self.u.device


def _tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    """A fresh contiguous copy of ``x`` on ``device`` (never a view of the
    caller's array, so later edits cannot reach back into it)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=dtype, copy=True).contiguous()
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def _scalars(epsilon: float, device) -> dict:
    return dict(
        iteration=torch.zeros((), dtype=torch.int32, device=device),
        delta=torch.tensor(epsilon + 1.0, dtype=torch.float32, device=device),
        converged=torch.zeros((), dtype=torch.bool, device=device),
        epsilon=torch.tensor(epsilon, dtype=torch.float32, device=device),
    )


def make_state(
    u,
    locked,
    epsilon: float = C.DEFAULT_EPSILON,
    *,
    device: torch.device | str,
) -> GridState:
    """Build a fresh GridState from u/locked arrays (resets solver bookkeeping).

    ``delta`` starts at ``epsilon + 1`` and ``converged`` at False, matching
    harmonic_complete_cpu's preamble (harmonic_cpu.cpp:153-156).
    """
    if epsilon <= 0.0:
        # harmonic_complete_cpu rejects epsilon <= 0 as INVALID_DATA
        # (harmonic_cpu.cpp:141-145); the solve loop could never terminate.
        raise ValueError(f"epsilon must be > 0, got {epsilon}")
    u = _tensor(u, torch.float32, device)
    locked = _tensor(locked, torch.bool, device)
    if u.shape != locked.shape:
        raise ValueError(f"u shape {tuple(u.shape)} != locked shape {tuple(locked.shape)}")
    if u.ndim < 2:
        raise ValueError(f"grids must be at least 2D, got {u.ndim}D")
    return GridState(u=u, locked=locked, **_scalars(epsilon, u.device))


def empty_state(
    height: int,
    width: int,
    epsilon: float = C.DEFAULT_EPSILON,
    *,
    device: torch.device | str,
) -> GridState:
    """All-free grid with u = 0, as the ROS node's initAlg creates it
    (epic_navigation_node_harmonic.cpp:216-226), with the boundary ring forced
    to locked obstacles (setBoundariesAsObstacles, :282-307)."""
    u = np.zeros((height, width), dtype=np.float32)
    locked = np.zeros((height, width), dtype=bool)
    u[0, :] = C.LOG_SPACE_OBSTACLE
    u[-1, :] = C.LOG_SPACE_OBSTACLE
    u[:, 0] = C.LOG_SPACE_OBSTACLE
    u[:, -1] = C.LOG_SPACE_OBSTACLE
    locked[0, :] = True
    locked[-1, :] = True
    locked[:, 0] = True
    locked[:, -1] = True
    return make_state(u, locked, epsilon, device=device)


def empty_volume(
    depth: int,
    height: int,
    width: int,
    epsilon: float = C.DEFAULT_EPSILON,
    *,
    device: torch.device | str,
) -> GridState:
    """3D analogue of :func:`empty_state`: all-free volume with u = 0 and the
    boundary *shell* (all six faces) forced to locked obstacles (initAlg's
    semantics, epic_navigation_node_harmonic.cpp:216-226, :282-307, one
    dimension up)."""
    u = np.zeros((depth, height, width), dtype=np.float32)
    shell = np.ones((depth, height, width), dtype=bool)
    shell[1:-1, 1:-1, 1:-1] = False
    u[shell] = C.LOG_SPACE_OBSTACLE
    return make_state(u, shell, epsilon, device=device)


def empty_grid_nd(
    shape: tuple[int, ...],
    epsilon: float = C.DEFAULT_EPSILON,
    *,
    device: torch.device | str,
) -> GridState:
    """N-dimensional analogue of :func:`empty_state`/:func:`empty_volume`:
    an all-free rank-n grid with u = 0 and the full boundary shell locked as
    obstacles. The reference solves 2D/3D only and stubs 4D out
    (harmonic_cpu.cpp:193-195); the plain solver (``solver.core``) handles
    any rank >= 2 with the same update rule and protocol, on any device."""
    if len(shape) < 2 or any(s < 3 for s in shape):
        raise ValueError(f"need rank >= 2 with every dim >= 3, got {shape}")
    u = np.zeros(shape, dtype=np.float32)
    shell = np.ones(shape, dtype=bool)
    shell[(slice(1, -1),) * len(shape)] = False
    u[shell] = C.LOG_SPACE_OBSTACLE
    return make_state(u, shell, epsilon, device=device)


def from_occupancy_volume(
    vol: np.ndarray,
    epsilon: float = C.DEFAULT_EPSILON,
    *,
    device: torch.device | str,
) -> GridState:
    """Ingest a 3D occupancy volume with HarmonicMap.load's pixel semantics
    (libepic/python/epic/harmonic_map.py:54-100) applied per voxel:

      voxel == 255 -> GOAL (locked, u = 0.0)
      voxel == 0   -> OBSTACLE (locked, u = -1e6)
      otherwise    -> FREE (unlocked, u = -1e6)
    """
    vol = np.asarray(vol)
    if vol.ndim != 3:
        raise ValueError("expected a 3D occupancy volume")
    goal = vol == 255
    u = np.where(goal, C.LOG_SPACE_GOAL, C.LOG_SPACE_FREE).astype(np.float32)
    return make_state(u, goal | (vol == 0), epsilon, device=device)


def from_occupancy_image(
    img: np.ndarray,
    epsilon: float = C.DEFAULT_EPSILON,
    *,
    device: torch.device | str,
) -> GridState:
    """Ingest a grayscale occupancy image, HarmonicMap.load semantics
    (libepic/python/epic/harmonic_map.py:54-100):

      pixel == 255 -> GOAL (locked, u = 0.0)
      pixel == 0   -> OBSTACLE (locked, u = -1e6)
      otherwise    -> FREE (unlocked, u = -1e6)
    """
    img = np.asarray(img)
    if img.ndim != 2:
        raise ValueError("expected a 2D grayscale image")
    goal = img == 255
    obstacle = img == 0
    u = np.where(goal, C.LOG_SPACE_GOAL, C.LOG_SPACE_FREE).astype(np.float32)
    locked = goal | obstacle
    return make_state(u, locked, epsilon, device=device)


def state_to_numpy(state) -> dict[str, np.ndarray]:
    """The six fields of a GridState as NumPy arrays. Works on this
    package's states and, since it only reads the fields, on a JAX
    ``epic_tpu.grid.GridState`` too: the way a state crosses between the two
    packages."""
    return {
        "u": np.asarray(_host(state.u), dtype=np.float32),
        "locked": np.asarray(_host(state.locked), dtype=bool),
        "iteration": np.asarray(_host(state.iteration), dtype=np.int32),
        "delta": np.asarray(_host(state.delta), dtype=np.float32),
        "converged": np.asarray(_host(state.converged), dtype=bool),
        "epsilon": np.asarray(_host(state.epsilon), dtype=np.float32),
    }


def state_from_numpy(arrays: Mapping[str, np.ndarray], *, device: torch.device | str) -> GridState:
    """Inverse of :func:`state_to_numpy`: a GridState on ``device`` holding
    exactly the given bits."""
    dtypes = {
        "u": torch.float32,
        "locked": torch.bool,
        "iteration": torch.int32,
        "delta": torch.float32,
        "converged": torch.bool,
        "epsilon": torch.float32,
    }
    fields = {k: _tensor(np.asarray(arrays[k]), dt, device) for k, dt in dtypes.items()}
    if fields["u"].shape != fields["locked"].shape:
        raise ValueError("u and locked shapes differ")
    for k in ("iteration", "delta", "converged", "epsilon"):
        if fields[k].ndim != 0:
            raise ValueError(f"{k} must be a scalar, got shape {tuple(fields[k].shape)}")
    return GridState(**fields)


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Cell edits (the SetCells family).
# ---------------------------------------------------------------------------

_TYPE_TO_U = {
    C.CELL_TYPE_GOAL: float(C.LOG_SPACE_GOAL),
    C.CELL_TYPE_OBSTACLE: float(C.LOG_SPACE_OBSTACLE),
    C.CELL_TYPE_FREE: float(C.LOG_SPACE_FREE),
}
_TYPE_TO_LOCKED = {
    C.CELL_TYPE_GOAL: True,
    C.CELL_TYPE_OBSTACLE: True,
    C.CELL_TYPE_FREE: False,
}
# The same two maps as arrays indexed by the type constant (0, 1, 2), for an
# edit of millions of voxels at once (:func:`sanitize_cell_edits_3d`).
_U_OF_TYPE = np.array([_TYPE_TO_U[t] for t in range(len(_TYPE_TO_U))], dtype=np.float32)
_LOCKED_OF_TYPE = np.array([_TYPE_TO_LOCKED[t] for t in range(len(_TYPE_TO_LOCKED))],
                           dtype=bool)


def sanitize_cell_edits(xy, types, width: int, height: int):
    """Shared SetCells preprocessing (harmonic_utilities_cpu.cpp:38-76):
    drop out-of-bounds / unknown-type entries (the reference warns and
    continues) and resolve duplicate coordinates last-wins (the reference
    applies edits sequentially; two independent scatters need not pick the
    same winner).

    Returns (xy[int64, N, 2], u_vals f32[N], locked_vals bool[N]); N may be 0.
    """
    xy = np.atleast_2d(np.asarray(xy, dtype=np.int64))
    types = np.asarray(types, dtype=np.int64).reshape(-1)
    if xy.shape[0] != types.shape[0]:
        raise ValueError("xy and types length mismatch")
    valid = (
        (xy[:, 0] >= 0)
        & (xy[:, 0] < width)
        & (xy[:, 1] >= 0)
        & (xy[:, 1] < height)
        & np.isin(types, list(_TYPE_TO_U))
    )
    xy = xy[valid]
    types = types[valid]
    if xy.shape[0]:
        flat = xy[:, 1] * width + xy[:, 0]
        _, last_idx = np.unique(flat[::-1], return_index=True)
        keep = np.sort(len(flat) - 1 - last_idx)
        xy = xy[keep]
        types = types[keep]
    u_vals = np.array([_TYPE_TO_U[t] for t in types], dtype=np.float32)
    l_vals = np.array([_TYPE_TO_LOCKED[t] for t in types], dtype=bool)
    return xy, u_vals, l_vals


def set_cells(
    state: GridState,
    xy: np.ndarray | Sequence[tuple[int, int]],
    types: np.ndarray | Sequence[int],
) -> GridState:
    """Point edits: (x, y, type) -> (u, locked) writes, into copies of the
    state's tensors (``harmonic_utilities_set_cells_2d_cpu``,
    harmonic_utilities_cpu.cpp:38-76). Out-of-bounds or unknown-type entries
    are skipped; duplicates resolve last-wins. Resets ``converged``: an edit
    perturbs the field, so the previous verdict no longer holds.
    """
    h, w = state.u.shape[:2]
    xy, u_vals, l_vals = sanitize_cell_edits(xy, types, w, h)
    if xy.shape[0] == 0:
        return state
    return _scatter(state, (xy[:, 1], xy[:, 0]), u_vals, l_vals)


def sanitize_cell_edits_3d(xyz, types, width: int, height: int, depth: int):
    """3D twin of :func:`sanitize_cell_edits` for (x, y, z) voxel edits:
    drop out-of-bounds / unknown-type entries, resolve duplicates last-wins.

    Returns (xyz[int64, N, 3], u_vals f32[N], locked_vals bool[N]); N may be 0.
    """
    xyz = np.atleast_2d(np.asarray(xyz, dtype=np.int64))
    types = np.asarray(types, dtype=np.int64).reshape(-1)
    if xyz.shape[0] != types.shape[0]:
        raise ValueError("xyz and types length mismatch")
    valid = (
        (xyz[:, 0] >= 0)
        & (xyz[:, 0] < width)
        & (xyz[:, 1] >= 0)
        & (xyz[:, 1] < height)
        & (xyz[:, 2] >= 0)
        & (xyz[:, 2] < depth)
        & np.isin(types, list(_TYPE_TO_U))
    )
    xyz = xyz[valid]
    types = types[valid]
    if xyz.shape[0]:
        flat = (xyz[:, 2] * height + xyz[:, 1]) * width + xyz[:, 0]
        _, last_idx = np.unique(flat[::-1], return_index=True)
        keep = np.sort(len(flat) - 1 - last_idx)
        xyz = xyz[keep]
        types = types[keep]
    return xyz, _U_OF_TYPE[types], _LOCKED_OF_TYPE[types]


def _scatter(state: GridState, index: tuple, u_vals, l_vals) -> GridState:
    """Write the edits into copies of u and locked; reset ``converged``."""
    dev = state.u.device
    index = tuple(torch.as_tensor(i, device=dev) for i in index)
    u = state.u.clone()
    locked = state.locked.clone()
    u[index] = torch.as_tensor(u_vals, device=dev)
    locked[index] = torch.as_tensor(l_vals, device=dev)
    return dataclasses.replace(
        state, u=u, locked=locked,
        converged=torch.zeros((), dtype=torch.bool, device=dev),
    )


def set_cells_3d(
    state: GridState,
    xyz: np.ndarray | Sequence[tuple[int, int, int]],
    types: np.ndarray | Sequence[int],
) -> GridState:
    """Point edits on a volume: (x, y, z, type) -> (u, locked) writes into
    ``u[z, y, x]``, with :func:`set_cells`'s contract (skip invalid entries,
    duplicates last-wins, ``converged`` reset)."""
    if state.u.ndim != 3:
        raise ValueError(f"set_cells_3d requires a 3D grid, got {state.u.ndim}D")
    d, h, w = state.u.shape
    xyz, u_vals, l_vals = sanitize_cell_edits_3d(xyz, types, w, h, d)
    if xyz.shape[0] == 0:
        return state
    return _scatter(state, (xyz[:, 2], xyz[:, 1], xyz[:, 0]), u_vals, l_vals)


def reset_free_cells(state: GridState) -> GridState:
    """Rewrite every unlocked interior cell to the FREE value -1e6, clearing
    stale potentials (srvResetFreeCells,
    epic_navigation_node_harmonic.cpp:582-611). The explicit cold restart.
    On a volume "interior" excludes all six faces."""
    inner = (slice(1, -1),) * state.u.ndim
    u = state.u.clone()
    u[inner] = torch.where(state.locked[inner], u[inner], float(C.LOG_SPACE_FREE))
    dev = state.u.device
    return dataclasses.replace(
        state,
        u=u,
        converged=torch.zeros((), dtype=torch.bool, device=dev),
        iteration=torch.zeros((), dtype=torch.int32, device=dev),
        delta=state.epsilon + 1.0,
    )


def host_u(state: GridState) -> np.ndarray:
    """Host copy of state.u. There is no mirror cache: the CUDA kernels
    update ``u`` in place, so a copy keyed on the tensor could go stale.
    On a CPU state this is a view; do not mutate it."""
    with profiling.span("grid.host_copy"):
        return state.u.detach().cpu().numpy()


def host_locked(state: GridState) -> np.ndarray:
    """Host copy of state.locked (a view on a CPU state; do not mutate)."""
    with profiling.span("grid.host_copy"):
        return state.locked.detach().cpu().numpy()


def _cell(state: GridState, x: int, y: int) -> tuple[bool, float]:
    """(locked, u) of one cell: a 5-byte read, not a grid fetch."""
    return bool(state.locked[y, x]), float(state.u[y, x])


def is_cell_obstacle(state: GridState, x: int, y: int) -> bool:
    """epic_navigation_node_harmonic.cpp:332-341: out-of-map counts as obstacle."""
    h, w = state.u.shape[:2]
    if not (0 <= x < w and 0 <= y < h):
        return True
    locked, u = _cell(state, x, y)
    return locked and u == float(C.LOG_SPACE_OBSTACLE)


def is_cell_goal(state: GridState, x: int, y: int) -> bool:
    """epic_navigation_node_harmonic.cpp:344-353."""
    h, w = state.u.shape[:2]
    if not (0 <= x < w and 0 <= y < h):
        return False
    locked, u = _cell(state, x, y)
    return locked and u == float(C.LOG_SPACE_GOAL)
