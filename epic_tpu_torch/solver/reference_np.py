"""NumPy oracle for the log-space red-black relaxation.

A copy of ``epic_tpu.solver.reference_np`` (exported at the top level as
``solver_oracle``), independent of torch. Two implementations of the update
rule documented in the reference's libepic/src/harmonic/harmonic_cpu.cpp:

- ``sweep_scalar``: a literal scalar loop in float32, mirroring
  harmonic_update_2d_cpu (:38-78) operation for operation. Slow; used only as
  the ground-truth oracle on tiny grids.
- ``sweep``: a vectorized float32 formulation with identical operation
  ordering, used to validate the solvers.

Red-black bookkeeping (harmonic_cpu.cpp:46-51): iteration ``t`` updates
interior cells whose coordinate parity satisfies ``(x0 + x1) % 2 != t % 2``
(derived from ``offset = (t % 2) != (x0 % 2)`` with the inner loop starting at
``1 + offset`` and striding by 2). A cell's 4 neighbours always have the other
parity, so the in-place "Gauss-Seidel" update is functionally a Jacobi update
on one parity class — which is why a pure-functional formulation can match the
reference exactly.
"""

from __future__ import annotations

import numpy as np

from .. import constants as C

_LOG2N_2D = np.float32(np.log(np.float64(4.0)))
_LOG2N_3D = np.float32(np.log(np.float64(6.0)))


def update_parity(iteration: int) -> int:
    """Cell parity class ((x0 + x1) % 2) updated at this iteration."""
    return 1 - (iteration % 2)


def sweep_scalar(u: np.ndarray, locked: np.ndarray, iteration: int):
    """One red-black sweep, literal scalar port of harmonic_update_2d_cpu.

    Returns (u_new, delta). float32 throughout.
    """
    u = np.array(u, dtype=np.float32)
    locked = np.asarray(locked)
    h, w = u.shape
    delta = np.float32(0.0)
    for x0 in range(1, h - 1):
        offset = int((iteration % 2) != (x0 % 2))
        for x1 in range(1 + offset, w - 1, 2):
            if locked[x0, x1]:
                continue
            prev = u[x0, x1]
            n_, s_, w_, e_ = u[x0 - 1, x1], u[x0 + 1, x1], u[x0, x1 - 1], u[x0, x1 + 1]
            m = max(max(n_, s_), max(w_, e_))
            s = (
                np.exp(np.float32(n_ - m))
                + np.exp(np.float32(s_ - m))
                + np.exp(np.float32(w_ - m))
                + np.exp(np.float32(e_ - m))
            )
            u[x0, x1] = np.float32(m + np.float32(np.log(s)) - _LOG2N_2D)
            delta = max(delta, np.float32(abs(prev - u[x0, x1])))
    return u, delta


def sweep(u: np.ndarray, locked: np.ndarray, iteration: int):
    """One red-black sweep, vectorized float32. Returns (u_new, delta).

    Operation order matches the scalar oracle: max tree over (N,S) and (W,E),
    then left-associated sum of the four shifted exponentials, log, add max,
    subtract log(4).
    """
    u = np.asarray(u, dtype=np.float32)
    locked = np.asarray(locked)
    h, w = u.shape
    un = u[:-2, 1:-1]
    us = u[2:, 1:-1]
    uw = u[1:-1, :-2]
    ue = u[1:-1, 2:]
    m = np.maximum(np.maximum(un, us), np.maximum(uw, ue))
    s = ((np.exp(un - m) + np.exp(us - m)) + np.exp(uw - m)) + np.exp(ue - m)
    val = (m + np.log(s)) - _LOG2N_2D

    yy, xx = np.meshgrid(np.arange(1, h - 1), np.arange(1, w - 1), indexing="ij")
    parity_mask = ((yy + xx) % 2) != (iteration % 2)
    update = parity_mask & ~locked[1:-1, 1:-1]

    u_new = u.copy()
    interior = np.where(update, val, u[1:-1, 1:-1])
    u_new[1:-1, 1:-1] = interior
    diffs = np.abs(u_new[1:-1, 1:-1] - u[1:-1, 1:-1])
    delta = np.float32(diffs.max(initial=np.float32(0.0), where=update))
    return u_new, delta


def sweep_3d(u: np.ndarray, locked: np.ndarray, iteration: int):
    """One 3D red-black sweep (6-neighbour logsumexp), vectorized float32.

    Parity derivation from harmonic_update_3d_cpu (harmonic_cpu.cpp:89-100):
    ``offset = ((t % 2) != (x0 % 2))`` negated when ``x1`` is even, inner loop
    over ``x2`` from ``1 + offset`` step 2 — equivalent to updating cells with
    ``(x0 + x1 + x2) % 2 == t % 2``. Note this is the OPPOSITE class from the
    2D convention (``!= t % 2``): the extra x1-even negation flips it
    (cross-validated against the prebuilt binary's 3D sweeps in
    tests/test_reference_binary.py — the 2D-style ``!=`` made sweep 0 a
    goal-blind no-op half the time).
    """
    u = np.asarray(u, dtype=np.float32)
    locked = np.asarray(locked)
    d, h, w = u.shape
    c = (slice(1, -1),) * 3
    nbrs = [
        u[:-2, 1:-1, 1:-1],
        u[2:, 1:-1, 1:-1],
        u[1:-1, :-2, 1:-1],
        u[1:-1, 2:, 1:-1],
        u[1:-1, 1:-1, :-2],
        u[1:-1, 1:-1, 2:],
    ]
    m = nbrs[0]
    for nb in nbrs[1:]:
        m = np.maximum(m, nb)
    s = np.exp(nbrs[0] - m)
    for nb in nbrs[1:]:
        s = s + np.exp(nb - m)
    val = (m + np.log(s)) - _LOG2N_3D

    zz, yy, xx = np.meshgrid(
        np.arange(1, d - 1), np.arange(1, h - 1), np.arange(1, w - 1), indexing="ij"
    )
    parity_mask = ((zz + yy + xx) % 2) == (iteration % 2)
    update = parity_mask & ~locked[c]

    u_new = u.copy()
    u_new[c] = np.where(update, val, u[c])
    diffs = np.abs(u_new[c] - u[c])
    delta = np.float32(diffs.max(initial=np.float32(0.0), where=update))
    return u_new, delta


def sweep_scalar_nd(u: np.ndarray, locked: np.ndarray, iteration: int):
    """One red-black sweep in ANY dimension, literal scalar loop following the
    reference's loop-structure recursion.

    The reference implements 2D and 3D and stubs 4D out entirely
    (harmonic_cpu.cpp:193-195 — ``//harmonic_update_4d_cpu`` commented out).
    Its pattern, though, is mechanical: ``offset = (t % 2) != (x0 % 2)``
    (harmonic_cpu.cpp:49), negated once per *middle* coordinate that is even
    (the x1-even negation, harmonic_cpu.cpp:96-99), with the innermost loop
    running from ``1 + offset`` in steps of 2. This function applies that
    recursion verbatim for any rank — for n=2 and n=3 it reproduces
    harmonic_update_{2d,3d}_cpu exactly (tested), which pins down the natural
    n=4+ extension: cells with ``sum(coords) % 2 != t % 2`` update when n is
    even, ``== t % 2`` when n is odd.

    Returns (u_new, delta). float32 throughout. Slow; oracle use only.
    """
    u = np.array(u, dtype=np.float32)
    locked = np.asarray(locked)
    nd = u.ndim
    log2n = np.float32(np.log(np.float64(2.0 * nd)))
    delta = np.float32(0.0)
    lead_shape = u.shape[:-1]
    w = u.shape[-1]
    for lead in np.ndindex(*[s - 2 for s in lead_shape]):
        coords = tuple(c + 1 for c in lead)
        offset = int((iteration % 2) != (coords[0] % 2))
        for xj in coords[1:]:
            if xj % 2 == 0:
                offset = 1 - offset
        for xl in range(1 + offset, w - 1, 2):
            idx = coords + (xl,)
            if locked[idx]:
                continue
            prev = u[idx]
            nbrs = []
            for axis in range(nd):
                for d in (-1, 1):
                    j = list(idx)
                    j[axis] += d
                    nbrs.append(u[tuple(j)])
            m = nbrs[0]
            for nb in nbrs[1:]:
                m = max(m, nb)
            s = np.float32(np.exp(np.float32(nbrs[0] - m)))
            for nb in nbrs[1:]:
                s = np.float32(s + np.exp(np.float32(nb - m)))
            u[idx] = np.float32(m + np.float32(np.log(s)) - log2n)
            delta = max(delta, np.float32(abs(prev - u[idx])))
    return u, delta


def sweep_nd(u: np.ndarray, locked: np.ndarray, iteration: int):
    """One red-black sweep in ANY dimension, vectorized float32.

    Parity class per :func:`sweep_scalar_nd`'s recursion: iteration ``t``
    updates interior cells with ``sum(coords) % 2 != (t + n%2) % 2`` — the 2D
    convention for even ranks, the flipped 3D convention for odd ranks.
    Operation order matches the scalar oracle (max tree, left-associated
    exponential sum). Returns (u_new, delta).
    """
    u = np.asarray(u, dtype=np.float32)
    locked = np.asarray(locked)
    nd = u.ndim
    log2n = np.float32(np.log(np.float64(2.0 * nd)))
    c = (slice(1, -1),) * nd
    nbrs = []
    for axis in range(nd):
        lo = tuple(slice(0, -2) if a == axis else slice(1, -1) for a in range(nd))
        hi = tuple(slice(2, None) if a == axis else slice(1, -1) for a in range(nd))
        nbrs.append(u[lo])
        nbrs.append(u[hi])
    m = nbrs[0]
    for nb in nbrs[1:]:
        m = np.maximum(m, nb)
    s = np.exp(nbrs[0] - m)
    for nb in nbrs[1:]:
        s = s + np.exp(nb - m)
    val = (m + np.log(s)) - log2n

    grids = np.meshgrid(*[np.arange(1, n - 1) for n in u.shape], indexing="ij")
    total = grids[0]
    for g in grids[1:]:
        total = total + g
    parity_mask = (total % 2) != ((iteration + nd % 2) % 2)
    update = parity_mask & ~locked[c]

    u_new = u.copy()
    u_new[c] = np.where(update, val, u[c])
    diffs = np.abs(u_new[c] - u[c])
    delta = np.float32(diffs.max(initial=np.float32(0.0), where=update))
    return u_new, delta


def solve(
    u: np.ndarray,
    locked: np.ndarray,
    epsilon: float = C.DEFAULT_EPSILON,
    stagger: int = C.DEFAULT_STAGGER,
    max_iterations: int | None = None,
):
    """Drive to convergence; port of harmonic_complete_cpu
    (harmonic_cpu.cpp:136-184).

    Exit semantics (exact): the reference's ``result`` variable is overwritten
    by *every* iteration — plain (non-check) updates return SUCCESS, so a
    converged verdict is forgotten unless the loop exits immediately. The loop
    can therefore only terminate right after a staggered check at iteration
    ``c*stagger`` whose delta < epsilon AND where ``c*stagger + 1 >= max(shape)``
    (the information-propagation guard, harmonic_cpu.cpp:147-158). Total
    iteration counts are always ≡ 1 (mod stagger).

    Returns (u, iterations, delta).
    """
    u = np.array(u, dtype=np.float32)
    locked = np.asarray(locked)
    sweep_fn = {2: sweep, 3: sweep_3d}.get(u.ndim, sweep_nd)
    m_max = max(u.shape)
    iteration = 0
    delta = np.float32(epsilon + 1.0)
    converged = False
    while not (converged and iteration >= m_max):
        if iteration % stagger == 0:
            u, delta = sweep_fn(u, locked, iteration)
            converged = bool(delta < epsilon)
        else:
            u, _ = sweep_fn(u, locked, iteration)
            converged = False  # non-check sweeps reset the verdict (:166-172)
        iteration += 1
        if max_iterations is not None and iteration >= max_iterations:
            break
    return u, iteration, delta
