"""The 3D anytime stepper and solve on the CUDA kernels.

The counterpart of ``epic_tpu.solver.pallas_sweep3d``: ``update_n`` launches
``epic_sweep3d_chunk`` (for ``_multisweep3d_kernel`` behind
``sweep3d_chunk_flat``) and ``solve`` launches ``epic_sweep3d_solve`` (for
``_solve_padded``'s while-loop of that kernel), both from
``csrc/sweep3d.cu``. A volume on the CPU goes to the plain version in
:mod:`.core`; a volume on a CUDA device goes to the kernel or raises. The
kernels take the unpadded volume, in place: keep only the returned state.

``launches`` counts each kernel's launches; nothing else changes it.
"""

from __future__ import annotations

from .. import constants as C
from ..grid import GridState
from . import core
from .hopper_sweep import _check_cuda_state, launch_chunk, launch_solve

launches = {"epic_sweep3d_chunk": 0, "epic_sweep3d_solve": 0}


def _check_volume(state: GridState) -> None:
    if state.u.ndim != 3:
        raise ValueError(f"hopper_sweep3d requires a 3D volume, got {state.u.ndim}D")


def update_n(state: GridState, num_steps: int) -> GridState:
    """``num_steps`` sweeps, delta from the first; semantics of
    :func:`epic_tpu_torch.solver.core.update_n` on a volume."""
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    _check_volume(state)
    if state.u.device.type == "cpu":
        return core.update_n(state, num_steps)
    _check_cuda_state(state, 3)
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
    _check_cuda_state(state, 3)
    return launch_solve(state, stagger, max_iterations, "epic_sweep3d_solve", launches)
