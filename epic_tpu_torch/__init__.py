"""epic_tpu_torch — the PyTorch / CUDA port of epic_tpu for one NVIDIA H100.

Log-space harmonic-function path planning: occupancy-grid ingest,
red-black relaxation of the harmonic potential, gradient-ascent streamline
extraction, the anytime planners (2D grids and 3D volumes) with their
JSON/TCP service verbs, and batched scenario solves (B independent 2D lanes
in lockstep, ``solver.batched`` / ``solver.hopper_batched``), and 2D grids
and 3D volumes sharded over a device mesh (``parallel``, ``planner_mesh``),
the coarse-to-fine cascade (``solver.cascade``), grids of any rank
(``empty_grid_nd``, ``path_nd``), checkpoints, profiling, the
percent-valid analysis and rendering (``analysis``, ``viz``), the native
C++ helpers (``native``, built with g++ at first use) and the sampling-based
node (``services.sampling_node``).
The sweeps and solves run as hand-written CUDA kernels (``csrc/*.cu``,
built with nvcc at first use) on a CUDA tensor, and as plain torch
(``solver.core``, ``solver.batched``, ``parallel.hopper_shard2d``,
``parallel.hopper_shard3d``) on a CPU tensor. ``epic_tpu`` (JAX) stays the
reference;
this package imports torch and NumPy, never JAX.
"""

from . import (analysis, checkpoint, config, constants, errors, maps, path, path3d, path_nd,
               profiling, viz)
from .grid import (
    GridState,
    empty_grid_nd,
    empty_state,
    empty_volume,
    from_occupancy_image,
    from_occupancy_volume,
    make_state,
    reset_free_cells,
    set_cells,
    set_cells_3d,
    state_from_numpy,
    state_to_numpy,
)
from .planner import Planner, PlannerConfig
from .planner3d import VolumePlanner, VolumePlannerConfig
from .planner_mesh import MeshPlanner
from .solver import core as solver_core
from .solver import reference_np as solver_oracle
from .solver import solve_volume, update_volume

__version__ = "0.1.0"

__all__ = [
    "GridState",
    "MeshPlanner",
    "Planner",
    "PlannerConfig",
    "VolumePlanner",
    "VolumePlannerConfig",
    "analysis",
    "checkpoint",
    "config",
    "constants",
    "errors",
    "empty_grid_nd",
    "empty_state",
    "empty_volume",
    "from_occupancy_image",
    "from_occupancy_volume",
    "make_state",
    "maps",
    "path",
    "path3d",
    "path_nd",
    "profiling",
    "reset_free_cells",
    "set_cells",
    "set_cells_3d",
    "solve_volume",
    "solver_core",
    "solver_oracle",
    "state_from_numpy",
    "state_to_numpy",
    "update_volume",
    "viz",
]
