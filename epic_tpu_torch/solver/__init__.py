"""The port's solvers: the plain torch version (``core``) and the CUDA
kernels behind it (``hopper_sweep`` in 2D, ``hopper_sweep3d`` in 3D), with
the library-level entries; batched scenario solves over ``[B, H, W]`` lanes
in plain torch (``batched``) and on their CUDA kernels (``hopper_batched``)."""

from . import batched, core, hopper_batched, hopper_sweep, hopper_sweep3d
from .. import constants as _C

__all__ = ["batched", "core", "hopper_batched", "hopper_sweep", "hopper_sweep3d",
           "solve_grid", "update_grid", "solve_volume", "update_volume"]


def _check_rank(state) -> None:
    """The card runs 2D and 3D grids; the plain version on the CPU any rank."""
    if state.u.device.type != "cpu" and state.u.ndim not in (2, 3):
        raise NotImplementedError(
            f"a {state.u.ndim}D grid on the card waits for the N-d slice of the port")


def solve_grid(state, stagger=None, max_iterations: int = 1_000_000):
    """Solve to convergence on whatever device holds ``state`` — the
    counterpart of ``epic_tpu.solver.solve_grid``: the plain version for a
    tensor on the CPU (any rank), the CUDA kernels for a 2D grid or (through
    :func:`solve_volume`) a 3D volume on the card; another rank on the card
    raises NotImplementedError. Protocol identical on every route
    (harmonic_complete_cpu)."""
    stagger = _C.DEFAULT_STAGGER if stagger is None else stagger
    if state.u.ndim == 3:
        return solve_volume(state, stagger, max_iterations)
    _check_rank(state)
    return hopper_sweep.solve(state, stagger, max_iterations)


def update_grid(state, num_steps: int):
    """The anytime stepper on whatever device holds ``state``; routes as
    :func:`solve_grid`."""
    if state.u.ndim == 3:
        return update_volume(state, num_steps)
    _check_rank(state)
    return hopper_sweep.update_n(state, num_steps)


def solve_volume(state, stagger=None, max_iterations: int = 1_000_000):
    """3D solve: the CUDA kernel for a volume on the card, the plain version
    for one on the CPU (``epic_tpu.solver.solve_volume``'s counterpart)."""
    stagger = _C.DEFAULT_STAGGER if stagger is None else stagger
    return hopper_sweep3d.solve(state, stagger, max_iterations)


def update_volume(state, num_steps: int):
    """The 3D anytime stepper; routes as :func:`solve_volume`."""
    return hopper_sweep3d.update_n(state, num_steps)
