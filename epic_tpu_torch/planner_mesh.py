"""The anytime planner on a device mesh: service verbs over sharded state.

The counterpart of ``epic_tpu.planner_mesh.MeshPlanner`` (2D). The
authoritative state is a mesh-resident
:class:`epic_tpu_torch.parallel.sharded.ShardedGrid`:

- anytime ticks run :func:`~epic_tpu_torch.parallel.sharded.update_n_resident`
  (in place: no re-pad, no re-upload) on the route ``kernel`` picks, the
  resident one (one launch a device) or the per-shard one;
- blocking solves run :func:`~epic_tpu_torch.parallel.sharded.solve_resident`
  from the current blocks (warm-started, like every verb);
- SetCells, the goal verbs, ResetFreeCells and occupancy ingest write into
  the owning shards; GetCell reads one cell from its shard;
- verbs that need the whole grid (ComputePath, the server's get_field and
  info) read :attr:`MeshPlanner.state`, gathered lazily onto the mesh's
  first device and kept until the next tick or edit.

Everything else (world<->map transforms, path extraction, the anytime
contract) is inherited from :class:`epic_tpu_torch.planner.Planner`: its
verbs read and write ``self.state``, a property here (reads gather, writes
re-shard). ResetFreeCells resets the iteration and delta as the Planner's
does (``grid.reset_free_cells``); ``epic_tpu``'s MeshPlanner keeps them.

:class:`MeshVolumePlanner` is the same one rank up, over a
:class:`epic_tpu_torch.parallel.sharded3d.ShardedVolume`, with the verbs of
:class:`epic_tpu_torch.planner3d.VolumePlanner`.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from . import constants as C
from .errors import EpicError, InvalidLocationError
from .grid import GridState
from .parallel import make_mesh, sharded, sharded3d
from .parallel.sharded import local_devices
from .planner import Planner, PlannerConfig
from .planner3d import VolumePlanner, VolumePlannerConfig

logger = logging.getLogger("epic_tpu_torch.planner_mesh")


class MeshPlanner(Planner):
    """Anytime harmonic planner whose grid lives sharded on a device mesh.

    Same verbs as :class:`Planner`. ``mesh=None`` is
    :func:`~epic_tpu_torch.parallel.make_mesh` over every visible card;
    ``chunk_depth`` (sweeps per halo exchange) and ``kernel`` (the route:
    :func:`~epic_tpu_torch.parallel.sharded.check_kernel`'s names) go to
    the sharded verbs, which run on the mesh's device (the CUDA entries on
    a card). The planner's ``device`` is the mesh's first device."""

    def __init__(self, config=None, mesh=None, chunk_depth: int | None = None,
                 kernel: str = "auto"):
        self._sh: sharded.ShardedGrid | None = None
        self._host_state: GridState | None = None
        self._converged = False
        self.mesh = mesh if mesh is not None else make_mesh()
        sharded.check_kernel(kernel, self.mesh)
        self.kernel = kernel
        self.chunk_depth = sharded.DEFAULT_CHUNK_DEPTH if chunk_depth is None else chunk_depth
        super().__init__(config, device=self.mesh.first_device)

    # -- state residency ---------------------------------------------------

    @property
    def state(self) -> GridState | None:
        """The mesh-resident state as one GridState on the mesh's first
        device (gathered lazily, kept until the next tick or edit)."""
        if self._sh is None:
            return None
        if self._host_state is None:
            st = sharded.unshard(self._sh)
            self._host_state = dataclasses.replace(
                st, converged=torch.tensor(self._converged, device=st.u.device))
        return self._host_state

    @state.setter
    def state(self, value: GridState | None) -> None:
        # The base verbs assign whole new states; landing one here re-shards
        # it. The hot verbs below write into the resident blocks instead.
        self._host_state = None
        if value is None:
            self._sh = None
            self._converged = False
            return
        self._sh = sharded.shard_state(
            value, self.mesh, sharded.halo_for(tuple(value.u.shape), self.mesh, self.chunk_depth))
        self._converged = bool(value.converged)

    def _resident(self) -> sharded.ShardedGrid:
        if self._sh is None:
            raise EpicError(2, "planner not initialized")
        return self._sh

    def _edited(self) -> bool:
        self._converged = False
        self._host_state = None
        return True

    def world_to_map(self, wx: float, wy: float) -> tuple[float, float]:
        """:meth:`Planner.world_to_map` on the resident grid's shape (no
        gather)."""
        cfg = self.config
        sh = self._resident()
        if (wx < cfg.origin_x or wy < cfg.origin_y
                or wx >= cfg.origin_x + sh.width * cfg.resolution
                or wy >= cfg.origin_y + sh.height * cfg.resolution):
            raise InvalidLocationError(f"world ({wx}, {wy}) outside map")
        return (wx - cfg.origin_x) / cfg.resolution, (wy - cfg.origin_y) / cfg.resolution

    # -- the anytime loop --------------------------------------------------

    def update(self, num_steps: int | None = None) -> None:
        """An anytime tick on the resident blocks."""
        if self._sh is None or self.paused:
            return
        n = num_steps if num_steps is not None else self.config.steps_per_update
        if n < 1:
            return
        sharded.update_n_resident(self._sh, n, self.mesh, self.chunk_depth, self.kernel)
        # A single-sweep tick carries a verdict (its delta is the check's).
        self._converged = bool(self._sh.delta < self._sh.epsilon) if n == 1 else False
        self._host_state = None

    def solve(self, max_iterations: int | None = None,
              segment_iterations: int | None = None) -> None:
        """Blocking solve to convergence on the resident blocks; with
        ``segment_iterations`` (the resident route) paused at stagger-aligned
        bounds, the same trajectory. ``config.cascade`` is not read: the mesh
        solves cold, as ``epic_tpu``'s MeshPlanner does."""
        cap = 1_000_000 if max_iterations is None else int(max_iterations)
        _, conv = sharded.solve_resident(
            self._resident(), self.mesh, self.config.stagger, cap, self.chunk_depth, self.kernel,
            segment_iterations)
        self._converged = bool(conv)
        self._host_state = None

    # -- resident service verbs --------------------------------------------

    def set_cells(self, xy, types) -> bool:
        """srvSetCells as writes into the owning shards."""
        sharded.set_cells_resident(self._resident(), xy, types)
        return self._edited()

    def _cell(self, x: int, y: int) -> tuple[bool, float]:
        """(locked, u) of one in-map cell, from its shard (or, when another
        process owns it, from the gathered state)."""
        got = sharded.read_cell(self._resident(), x, y)
        if got is None:
            st = self.state
            got = bool(st.locked[y, x]), float(st.u[y, x])
        return got

    def add_goals(self, world_points) -> bool:
        """srvAddGoals: world -> cells, goals refused inside obstacles (one
        cell read each), then one write into the shards."""
        sh = self._resident()
        xy = []
        for wx, wy in world_points:
            try:
                mx, my = self.world_to_map(wx, wy)
            except InvalidLocationError:
                continue
            cx, cy = int(mx + 0.5), int(my + 0.5)
            if not (0 <= cx < sh.width and 0 <= cy < sh.height):
                continue
            locked, u = self._cell(cx, cy)
            if locked and u == float(C.LOG_SPACE_OBSTACLE):
                continue
            xy.append((int(mx), int(my)))
        if not xy:
            return False
        return self.set_cells(xy, [C.CELL_TYPE_GOAL] * len(xy))

    def remove_goals(self, world_points) -> bool:
        """srvRemoveGoals: removed goals become FREE cells."""
        self._resident()
        xy = []
        for wx, wy in world_points:
            try:
                mx, my = self.world_to_map(wx, wy)
            except InvalidLocationError:
                continue
            xy.append((int(mx), int(my)))
        if xy:
            self.set_cells(xy, [C.CELL_TYPE_FREE] * len(xy))
        return True

    def get_cell(self, x: int, y: int) -> float:
        """srvGetCell: a read from the owning shard."""
        sh = self._resident()
        if not (0 <= x < sh.width and 0 <= y < sh.height):
            raise InvalidLocationError(f"cell ({x}, {y}) outside map")
        return self._cell(x, y)[1]

    def reset_free_cells(self) -> bool:
        """srvResetFreeCells on the resident blocks."""
        sharded.reset_free_cells_resident(self._resident())
        return self._edited()

    def update_occupancy(self, data: np.ndarray, resolution: float | None = None,
                         origin: tuple[float, float] | None = None) -> None:
        """OccupancyGrid ingest on the resident blocks, with
        :meth:`Planner.update_occupancy`'s rule (a size change reinitialises
        the grid, goals lost)."""
        data = np.asarray(data)
        h, w = data.shape
        sh = self._sh
        if sh is None or (sh.height, sh.width) != (h, w):
            if sh is not None:
                logger.warning("occupancy resize %s -> (%d, %d): full reinit, goals lost"
                               " (reference behaviour)", (sh.height, sh.width), h, w)
            self.uninit()
            self.init(w, h)
        if resolution is not None:
            self.config.resolution = float(resolution)
        if origin is not None:
            self.config.origin_x, self.config.origin_y = map(float, origin)
        if sharded.occupancy_resident(self._sh, data):
            self._edited()


class MeshVolumePlanner(VolumePlanner):
    """The 3D anytime planner on a device mesh: :class:`MeshPlanner`'s
    volume twin (``epic_tpu.planner_mesh.MeshVolumePlanner``).

    Same verbs as :class:`VolumePlanner`. The hot ones run on the resident
    blocks: ticks (:func:`~epic_tpu_torch.parallel.sharded3d.
    update_n_resident3d`), blocking solves (``solve_resident3d``, with
    ``segment_iterations``), SetCells and the goal verbs, ResetFreeCells,
    occupancy ingest and one-voxel reads; ComputePath and the batched walker
    read :attr:`state`, gathered lazily onto the mesh's first device (the
    planner's ``device``). ``mesh=None`` picks the orientation per ingested
    volume with :func:`~epic_tpu_torch.parallel.sharded3d.choose_mesh3d`
    over every visible card, and raises when there is none. ``kernel``
    picks the route (the device route, one launch a device, or the
    per-shard one) with the names of
    :func:`~epic_tpu_torch.parallel.sharded3d.check_kernel`, which refuses
    the ones this mesh does not run."""

    def __init__(self, config: VolumePlannerConfig | None = None, mesh=None,
                 chunk_depth: int | None = None, kernel: str = "auto"):
        self._sv: sharded3d.ShardedVolume | None = None
        self._host_state: GridState | None = None
        self._converged = False
        self._devices = local_devices(None, "MeshVolumePlanner") if mesh is None else None
        if mesh is not None:
            sharded3d.check_kernel(kernel, mesh)
        self.mesh = mesh
        self.kernel = kernel
        self.chunk_depth = sharded3d.DEFAULT_CHUNK_DEPTH if chunk_depth is None else chunk_depth
        super().__init__(config, device=self._devices[0] if mesh is None else mesh.first_device)

    # -- state residency ---------------------------------------------------

    @property
    def state(self) -> GridState | None:
        """The mesh-resident volume as one GridState on the mesh's first
        device (gathered lazily, kept until the next tick or edit)."""
        if self._sv is None:
            return None
        if self._host_state is None:
            st = sharded3d.unshard3d(self._sv)
            self._host_state = dataclasses.replace(
                st, converged=torch.tensor(self._converged, device=st.u.device))
        return self._host_state

    @state.setter
    def state(self, value: GridState | None) -> None:
        self._host_state = None
        if value is None:
            self._sv = None
            self._converged = False
            return
        shape = tuple(value.u.shape)
        if self._devices is not None:
            self.mesh = sharded3d.choose_mesh3d(shape, devices=self._devices)
        self._sv = sharded3d.shard_state3d(
            value, self.mesh, sharded3d.halo_for(shape, self.mesh, self.chunk_depth))
        self._converged = bool(value.converged)

    @property
    def initialized(self) -> bool:
        return self._sv is not None

    def _resident(self) -> sharded3d.ShardedVolume:
        if self._sv is None:
            raise EpicError(2, "planner not initialized")
        return self._sv

    def _edited(self) -> bool:
        self._converged = False
        self._host_state = None
        return True

    def world_to_map(self, wx: float, wy: float, wz: float):
        """:meth:`VolumePlanner.world_to_map` on the resident volume's
        shape (no gather)."""
        cfg = self.config
        d, h, w = self._resident().shape
        if (wx < cfg.origin_x or wy < cfg.origin_y or wz < cfg.origin_z
                or wx >= cfg.origin_x + w * cfg.resolution
                or wy >= cfg.origin_y + h * cfg.resolution
                or wz >= cfg.origin_z + d * cfg.resolution):
            raise InvalidLocationError(f"world ({wx}, {wy}, {wz}) outside map")
        return ((wx - cfg.origin_x) / cfg.resolution, (wy - cfg.origin_y) / cfg.resolution,
                (wz - cfg.origin_z) / cfg.resolution)

    # -- the anytime loop --------------------------------------------------

    def update(self, num_steps: int | None = None) -> None:
        """An anytime tick on the resident blocks."""
        if self._sv is None or self.paused:
            return
        n = num_steps if num_steps is not None else self.config.steps_per_update
        if n < 1:
            return
        sharded3d.update_n_resident3d(self._sv, n, self.mesh, self.chunk_depth, self.kernel)
        # A single-sweep tick carries a verdict (its delta is the check's).
        self._converged = bool(self._sv.delta < self._sv.epsilon) if n == 1 else False
        self._host_state = None

    def solve(self, max_iterations: int | None = None,
              segment_iterations: int | None = None) -> None:
        """Blocking solve to convergence on the resident blocks."""
        cap = 1_000_000 if max_iterations is None else int(max_iterations)
        _, conv = sharded3d.solve_resident3d(
            self._resident(), self.mesh, self.config.stagger, cap, self.chunk_depth, self.kernel,
            segment_iterations)
        self._converged = bool(conv)
        self._host_state = None

    # -- resident service verbs --------------------------------------------

    def set_cells(self, xyz, types) -> bool:
        """SetCells as writes into the owning shards."""
        sharded3d.set_cells_resident3d(self._resident(), xyz, types)
        return self._edited()

    def _cell(self, x: int, y: int, z: int) -> tuple[bool, float]:
        """(locked, u) of one in-map voxel, from its shard (or, when another
        process owns it, from the gathered state)."""
        got = sharded3d.read_cell3d(self._resident(), x, y, z)
        if got is None:
            st = self.state
            got = bool(st.locked[z, y, x]), float(st.u[z, y, x])
        return got

    def add_goals(self, world_points) -> bool:
        """ModifyGoals(add): world -> voxels, goals refused inside obstacles
        (one voxel read each), then one write into the shards."""
        d, h, w = self._resident().shape
        xyz = []
        for wx, wy, wz in world_points:
            try:
                mx, my, mz = self.world_to_map(wx, wy, wz)
            except InvalidLocationError:
                continue
            cx, cy, cz = int(mx + 0.5), int(my + 0.5), int(mz + 0.5)
            if not (0 <= cx < w and 0 <= cy < h and 0 <= cz < d):
                continue
            locked, u = self._cell(cx, cy, cz)
            if locked and u == float(C.LOG_SPACE_OBSTACLE):
                continue
            xyz.append((int(mx), int(my), int(mz)))
        if not xyz:
            return False
        return self.set_cells(xyz, [C.CELL_TYPE_GOAL] * len(xyz))

    def remove_goals(self, world_points) -> bool:
        """ModifyGoals(remove): removed goals become FREE voxels."""
        self._resident()
        xyz = []
        for wx, wy, wz in world_points:
            try:
                mx, my, mz = self.world_to_map(wx, wy, wz)
            except InvalidLocationError:
                continue
            xyz.append((int(mx), int(my), int(mz)))
        if xyz:
            self.set_cells(xyz, [C.CELL_TYPE_FREE] * len(xyz))
        return True

    def get_cell(self, x: int, y: int, z: int) -> float:
        """GetCell: a read from the owning shard."""
        d, h, w = self._resident().shape
        if not (0 <= x < w and 0 <= y < h and 0 <= z < d):
            raise InvalidLocationError(f"cell ({x}, {y}, {z}) outside map")
        return self._cell(x, y, z)[1]

    def reset_free_cells(self) -> bool:
        """srvResetFreeCells on the resident blocks."""
        sharded3d.reset_free_cells_resident3d(self._resident())
        return self._edited()

    def update_occupancy(self, data: np.ndarray, resolution: float | None = None,
                         origin: tuple[float, float, float] | None = None) -> None:
        """Occupancy-volume ingest on the resident blocks, with
        :meth:`VolumePlanner.update_occupancy`'s rule (a size change
        reinitialises the volume, goals lost)."""
        data = np.asarray(data)
        d, h, w = data.shape
        sv = self._sv
        if sv is None or sv.shape != (d, h, w):
            if sv is not None:
                logger.warning("occupancy resize %s -> (%d, %d, %d): full reinit, goals lost"
                               " (reference behaviour)", sv.shape, d, h, w)
            self.uninit()
            self.init(w, h, d)
        if resolution is not None:
            self.config.resolution = float(resolution)
        if origin is not None:
            (self.config.origin_x, self.config.origin_y,
             self.config.origin_z) = map(float, origin)
        if sharded3d.occupancy_resident3d(self._sv, data):
            self._edited()


__all__ = ["MeshPlanner", "MeshVolumePlanner", "PlannerConfig", "VolumePlannerConfig"]
