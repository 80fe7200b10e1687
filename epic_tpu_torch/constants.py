"""Cell-type and log-space constants for the epic_tpu_torch planning engine.

Semantics mirror the reference library's ``epic/constants.h``
(the reference's libepic/include/epic/constants.h:34-43):

- A GOAL cell holds ``log(1) = 0.0`` and is locked.
- An OBSTACLE cell holds ``log(~0) = -1e6`` and is locked.
- A FREE cell is initialised to ``-1e6`` and is unlocked (relaxed by the
  solver).

All potentials live in log space; the solver relaxes ``u`` toward the log of
the harmonic mean-of-exponentials of the neighbours, which is the whole point
of the log-space formulation (float underflow immunity on large maps).
"""

from __future__ import annotations

import numpy as np

# Log-space sentinel range (constants.h:34-35). Stored in float32 grids, so the
# practical magnitude is bounded by float32 anyway; these are used as logsumexp
# max seeds and "impossible" initial values.
FLT_MAX = 1e300
FLT_MIN = -1e300

# Cell types (constants.h:37-39).
CELL_TYPE_GOAL = 0
CELL_TYPE_OBSTACLE = 1
CELL_TYPE_FREE = 2

# Log-space values per cell type (constants.h:41-43).
LOG_SPACE_GOAL = np.float32(0.0)
LOG_SPACE_OBSTACLE = np.float32(-1e6)
LOG_SPACE_FREE = np.float32(-1e6)

# Occupancy-grid ingest thresholds
# (include/epic/epic_navigation_node_constants.h:30-34).
OCCUPANCY_OBSTACLE_THRESHOLD = 50
OCCUPANCY_NO_CHANGE = -2

# Convergence-check cadence default (libepic/python/epic/harmonic.py:47).
DEFAULT_STAGGER = 100

# Default solver epsilons: the Python API default (harmonic.py:45) and the ROS
# node default (src/epic_navigation_node_harmonic.cpp:64).
DEFAULT_EPSILON = 1e-2
DEFAULT_EPSILON_NODE = 1e-3

# Path-extraction defaults: interactive viz (harmonic_map.py:117-119) and ROS
# (src/epic_navigation_node_harmonic_rviz.cpp:114-116).
DEFAULT_STEP_SIZE = 0.2
DEFAULT_CD_PRECISION = 0.4
DEFAULT_MAX_LENGTH = int(1e6)

# Stuck-detection history (libepic/src/harmonic/harmonic_path_cpu.cpp:39).
PATH_STUCK_HISTORY_LENGTH = 5

# Legacy SOR solver (libepic/src/harmonic/harmonic_legacy_cpu.cpp:34) floor.
LEGACY_MIN_ITERATIONS = 10000
DEFAULT_OMEGA = 1.5
