"""The port's solvers: the plain torch version (``core``) and the CUDA
kernels behind it (``hopper_sweep``), with the library-level entries."""

from . import core, hopper_sweep
from .. import constants as _C

__all__ = ["core", "hopper_sweep", "solve_grid", "update_grid"]


def solve_grid(state, stagger=None, max_iterations: int = 1_000_000):
    """Solve to convergence on whatever device holds ``state`` — the
    counterpart of ``epic_tpu.solver.solve_grid``: the plain version for a
    tensor on the CPU (any rank), the CUDA kernel for a 2D tensor on the
    card; a grid of another rank on the card raises NotImplementedError
    (the 3D slice of the port). Protocol identical on both routes
    (harmonic_complete_cpu)."""
    stagger = _C.DEFAULT_STAGGER if stagger is None else stagger
    return hopper_sweep.solve(state, stagger, max_iterations)


def update_grid(state, num_steps: int):
    """The anytime stepper on whatever device holds ``state``; routes as
    :func:`solve_grid`."""
    return hopper_sweep.update_n(state, num_steps)
