"""epic_tpu_torch — the PyTorch / CUDA port of epic_tpu for one NVIDIA H100.

Log-space harmonic-function path planning: occupancy-grid ingest,
red-black relaxation of the harmonic potential, gradient-ascent streamline
extraction, and the anytime planner with its JSON/TCP service verbs. The 2D
sweep and solve run as hand-written CUDA kernels (``csrc/sweep2d.cu``,
built with nvcc at first use) on a CUDA tensor, and as plain torch
(``solver.core``) on a CPU tensor. ``epic_tpu`` (JAX) stays the reference;
this package imports torch and NumPy, never JAX.
"""

from . import config, constants, errors, maps, path
from .grid import (
    GridState,
    empty_state,
    from_occupancy_image,
    make_state,
    reset_free_cells,
    set_cells,
    state_from_numpy,
    state_to_numpy,
)
from .planner import Planner, PlannerConfig
from .solver import core as solver_core

__version__ = "0.1.0"

__all__ = [
    "GridState",
    "Planner",
    "PlannerConfig",
    "config",
    "constants",
    "errors",
    "empty_state",
    "from_occupancy_image",
    "make_state",
    "maps",
    "path",
    "reset_free_cells",
    "set_cells",
    "solver_core",
    "state_from_numpy",
    "state_to_numpy",
]
