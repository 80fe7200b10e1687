"""The temporally blocked tile family in plain torch: the reference version
of the CUDA kernels in ``csrc/tile2d.cu``.

The counterpart of ``epic_tpu.solver.pallas_biggrid``, ``pallas_tiled2d``
and the 2D half of ``pallas_cycle``. Those stage row bands or row x column
slabs through TPU VMEM; here, as in the kernels, a grid is cut into
``tile = (TH, TW)`` centres of the unpadded ``H x W`` grid (the last row and
column of tiles ragged), and each centre is swept together with a ``k``-deep
halo. A sweep ``s`` of a chunk updates a halo-extended cell only if

- its local row and column lie in ``(s, ext - 1 - s)`` (the temporal-
  blocking trapezoid of ``pallas_biggrid.py:251-255``: after ``s + 1``
  sweeps a cell ``s + 1`` or more cells inside the halo edge holds exactly
  what ``s + 1`` global sweeps give);
- it is unlocked and in the grid interior ``1..H-2 x 1..W-2`` (cells
  outside the grid hold ``LOG_SPACE_OBSTACLE`` and never move);
- it is of the class ``(y + x) % 2 != (t0 + s) % 2`` in global coordinates.

A chunk of ``num_sweeps <= k`` sweeps writes the centres to a new grid (the
kernels ping-pong: neighbouring tiles read the source's halo), so it equals
``core.update_n`` bit for bit for any tile shape, ``k`` above the tile
height included. The delta is ``max |u1 - u0|`` over centre cells: over
every grid cell once, never over fill cells (ROADMAP R7), so it equals
core's delta of the chunk's first sweep.

Here the halo-extended tiles are gathered into one ``[tiles, TH + 2k,
TW + 2k]`` batch and swept together. The CPU tests use these functions, and
``chip_smoke.py`` holds the kernels against them on the card; the card's
main path never comes here.

The chunk schedules of the wrappers (``hopper_tile2d``, ``hopper_tile3d``)
live here too, so the plain and the kernel routes sweep the same chunks, and
so do the runners over a chunk function (``cycle``, ``tick``,
``protocol_solve``) that ``tiled3d`` shares. ``lanes_update_n`` and
``lanes_solve`` model the batched entries' tiled route (``hopper_batched``
on lanes past the clusters): the same tile sweep on each lane of a ``[B,
H, W]`` batch, in the kernels' chunks, gating and copies.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import constants as C
from ..grid import GridState
from ._sweep_body import lse4

calls = {"update_n": 0, "solve": 0, "lanes_update_n": 0, "lanes_solve": 0}


def spread(num_sweeps: int, n_chunks: int) -> list[int]:
    """``num_sweeps`` spread over ``n_chunks`` chunks, the earlier chunks
    one sweep deeper where it does not divide (the kernels' rule)."""
    q, r = divmod(num_sweeps, n_chunks)
    return [q + (c < r) for c in range(n_chunks)]


def tick_schedule(num_sweeps: int, k: int) -> tuple[int, int, int]:
    """How a tick of ``num_sweeps`` sweeps runs: ``(cycle_sweeps,
    cycle_chunks, tail_sweeps)``. ``ceil(n / k)`` chunks, the sweeps spread
    over them; an even count runs as one cycle, which ends in the caller's
    buffer; an odd count puts its last chunk through the chunk entry (the
    TPU's remainder chunk), whose output is then copied back."""
    n_chunks = -(-num_sweeps // k)
    per = spread(num_sweeps, n_chunks)
    if n_chunks % 2 == 0:
        return num_sweeps, n_chunks, 0
    return num_sweeps - per[-1], n_chunks - 1, per[-1]


def solve_schedule(stagger: int, k: int) -> tuple[int, list[int]]:
    """One stagger cycle of a solve: the checked chunk's depth
    ``min(k, stagger)``, then the rest spread over ``ceil(rest / k)``
    chunks."""
    depth = min(k, stagger)
    rest = stagger - depth
    return depth, (spread(rest, -(-rest // k)) if rest else [])


def _tile_grid(shape, tile) -> tuple[int, int]:
    (h, w), (th, tw) = shape, tile
    return -(-h // th), -(-w // tw)


def _blocks(x: torch.Tensor, fill, k: int, tile) -> torch.Tensor:
    """The halo-extended tiles of ``x`` as ``[tiles, TH + 2k, TW + 2k]``,
    ``fill`` outside the grid; tiles row-major."""
    h, w = x.shape
    th, tw = tile
    ny, nx = _tile_grid((h, w), tile)
    padded = x.new_full((ny * th + 2 * k, nx * tw + 2 * k), fill)
    padded[k:k + h, k:k + w] = x
    ext = padded.unfold(0, th + 2 * k, th).unfold(1, tw + 2 * k, tw)
    return ext.reshape(ny * nx, th + 2 * k, tw + 2 * k)


def _centres(blocks: torch.Tensor, shape, k: int, tile) -> torch.Tensor:
    """The tiles' centres reassembled into an ``H x W`` grid."""
    h, w = shape
    th, tw = tile
    ny, nx = _tile_grid(shape, tile)
    c = blocks[:, k:k + th, k:k + tw].reshape(ny, nx, th, tw)
    return c.permute(0, 2, 1, 3).reshape(ny * th, nx * tw)[:h, :w].contiguous()


def _check_layout(k: int, tile) -> None:
    if k < 1 or min(tile) < 1:
        raise ValueError(f"need k >= 1 and a tile of at least 1 x 1, got k={k}, tile={tile}")


def _frozen_and_parity(locked: torch.Tensor, k: int, tile):
    """Per tile: which cells never move (locked, the grid's ring, fill) and
    each cell's global class ``(y + x) % 2``."""
    h, w = locked.shape
    fixed = locked.clone()
    fixed[0, :] = True
    fixed[-1, :] = True
    fixed[:, 0] = True
    fixed[:, -1] = True
    frozen = _blocks(fixed, True, k, tile)
    ny, nx = _tile_grid((h, w), tile)
    th, tw = tile
    # Padded coordinates are global ones plus k on both axes, so the class
    # of (py, px) is (py + px) % 2.
    rows = torch.arange(ny * th + 2 * k, device=locked.device)
    cols = torch.arange(nx * tw + 2 * k, device=locked.device)
    cls = ((rows[:, None] + cols[None, :]) % 2).to(torch.uint8)
    ext = cls.unfold(0, th + 2 * k, th).unfold(1, tw + 2 * k, tw)
    return frozen, ext.reshape(ny * nx, th + 2 * k, tw + 2 * k)


def _sweep_blocks(u, frozen, parity, t, s: int) -> None:
    """Sweep ``s`` of a chunk, in place on the batch of tiles: the class
    of iteration ``t``, inside the trapezoid."""
    er, ec = u.shape[1], u.shape[2]
    win = u[:, s:er - s, s:ec - s]
    val = lse4(win[:, :-2, 1:-1], win[:, 2:, 1:-1], win[:, 1:-1, :-2], win[:, 1:-1, 2:])
    inner = (slice(None), slice(s + 1, er - 1 - s), slice(s + 1, ec - 1 - s))
    update = (parity[inner] != t % 2) & ~frozen[inner]
    u[inner] = torch.where(update, val, u[inner])


def sweep_chunk(src: torch.Tensor, locked: torch.Tensor, iteration, num_sweeps: int, *,
                k: int, tile, u1: bool = False):
    """``num_sweeps`` (1..k) sweeps from ``iteration`` (an int or a 0-d
    tensor), tile by tile. Returns ``(dst, delta, u1)``: the new grid, the
    delta of the first sweep, and with ``u1=True`` the grid after that
    sweep (else None). ``src`` is not modified."""
    _check_layout(k, tile)
    if not 1 <= num_sweeps <= k:
        raise ValueError(f"a chunk runs 1..k={k} sweeps, got {num_sweeps}")
    shape = tuple(src.shape)
    th, tw = tile
    frozen, parity = _frozen_and_parity(locked, k, tile)
    u = _blocks(src, float(C.LOG_SPACE_OBSTACLE), k, tile)
    u0 = u[:, k:k + th, k:k + tw].clone()
    _sweep_blocks(u, frozen, parity, iteration, 0)
    delta = (u[:, k:k + th, k:k + tw] - u0).abs().max()
    first = _centres(u, shape, k, tile) if u1 else None
    for s in range(1, num_sweeps):
        _sweep_blocks(u, frozen, parity, iteration + s, s)
    return _centres(u, shape, k, tile), delta, first


def sweep_cycle(a: torch.Tensor, b: torch.Tensor, locked: torch.Tensor, iteration,
                n_chunks: int, num_sweeps: int | None = None, *, k: int, tile):
    """``num_sweeps`` sweeps (default ``n_chunks * k``) spread over
    ``n_chunks`` chunks that ping-pong: chunk ``c`` reads ``a`` when ``c`` is
    even and ``b`` otherwise, and writes the other (``b``'s content is never
    read before chunk 0 writes it). Returns ``(a', b', deltas)``, with
    ``deltas[c]`` chunk ``c``'s first-sweep delta; the state ends in ``a'``
    when ``n_chunks`` is even, in ``b'`` otherwise (``pallas_cycle.
    sweep_cycle``'s contract)."""
    return cycle(sweep_chunk, a, b, locked, iteration, n_chunks, num_sweeps, k=k, tile=tile)


def update_n(state: GridState, num_steps: int, *, k: int, tile) -> GridState:
    """``num_steps`` sweeps in the wrapper's chunk schedule
    (:func:`tick_schedule`), delta from the first; equals
    ``core.update_n`` bit for bit."""
    calls["update_n"] += 1
    return tick(sweep_chunk, state, num_steps, k=k, tile=tile)


def solve(state: GridState, stagger: int = C.DEFAULT_STAGGER, max_iterations: int = 1_000_000,
          *, k: int, tile) -> GridState:
    """Relax to convergence with ``core.solve``'s protocol, a stagger cycle
    at a time in the kernels' chunks; equals ``core.solve`` bit for bit."""
    calls["solve"] += 1
    return protocol_solve(sweep_chunk, state, stagger, max_iterations, k=k, tile=tile)


def solve_segments(state: GridState, stagger: int = C.DEFAULT_STAGGER,
                   max_iterations: int = 1_000_000, segment_iterations: int = 5_000, *,
                   k: int, tile) -> GridState:
    """:func:`solve` as a sequence of segments (``pallas_biggrid.
    solve_segments``): each resumes the protocol where the last stopped, at
    :func:`segment_bounds`; bit-identical to one solve."""
    calls["solve"] += 1
    return protocol_solve(sweep_chunk, state, stagger, max_iterations, segment_iterations, k=k,
                          tile=tile)


# -- the schedules over a chunk function, shared with tiled3d -----------------------------

def cycle(chunk, a, b, locked, iteration, n_chunks: int, num_sweeps: int | None, *, k: int,
          tile):
    """:func:`sweep_cycle` over ``chunk`` (this module's or
    :func:`.tiled3d.sweep_chunk`)."""
    if n_chunks < 1:
        raise ValueError(f"a cycle runs at least one chunk, got {n_chunks}")
    if num_sweeps is None:
        num_sweeps = n_chunks * k
    per = spread(num_sweeps, n_chunks)
    if min(per) < 1 or max(per) > k:
        raise ValueError(f"{num_sweeps} sweeps over {n_chunks} chunks of at most {k}")
    bufs = [a, b]
    deltas = []
    t = iteration
    for c, ns in enumerate(per):
        bufs[1 - c % 2], d, _ = chunk(bufs[c % 2], locked, t, ns, k=k, tile=tile)
        deltas.append(d)
        t = t + ns
    return bufs[0], bufs[1], torch.stack(deltas)


def tick(chunk, state: GridState, num_steps: int, *, k: int, tile) -> GridState:
    """:func:`update_n` over ``chunk``."""
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    cycle_sweeps, n_chunks, tail = tick_schedule(num_steps, k)
    u, delta = state.u, None
    if n_chunks:
        u, _, deltas = cycle(chunk, u, u, state.locked, state.iteration, n_chunks, cycle_sweeps,
                             k=k, tile=tile)
        delta = deltas[0]
    if tail:
        u, d, _ = chunk(u, state.locked, state.iteration + cycle_sweeps, tail, k=k, tile=tile)
        delta = d if delta is None else delta
    return dataclasses.replace(
        state, u=u, iteration=state.iteration + num_steps, delta=delta,
        converged=(delta < state.epsilon) if num_steps == 1
        else torch.zeros((), dtype=torch.bool, device=u.device))


def _protocol(chunk, u, locked, epsilon, stagger: int, bound: int, it: int, delta, done: bool,
              *, k: int, tile):
    """Stagger cycles from iteration ``it`` while not ``done`` and ``it <
    bound``: the checked chunk (with u1), the exit decision, the rest of
    the cycle. The loop of ``epic_tile2d_solve``/``epic_tile3d_solve``,
    resumable."""
    m_max = max(u.shape)
    depth, rest = solve_schedule(stagger, k)
    while not done and it < bound:
        dst, delta, first = chunk(u, locked, it, depth, k=k, tile=tile, u1=True)
        if it + 1 >= m_max and bool(delta < epsilon):
            u, it, done = first, it + 1, True
            break
        u, t = dst, it + depth
        for ns in rest:
            u, _, _ = chunk(u, locked, t, ns, k=k, tile=tile)
            t += ns
        it += stagger
    return u, it, delta, done


def protocol_solve(chunk, state: GridState, stagger: int, max_iterations: int,
                   segment_iterations: int | None = None, *, k: int, tile) -> GridState:
    """``core.solve``'s protocol over ``chunk``: :func:`solve`, or with
    ``segment_iterations`` :func:`solve_segments`, each segment resuming
    the protocol where the last stopped, at :func:`segment_bounds`."""
    if stagger < 1:
        raise ValueError(f"stagger must be >= 1, got {stagger}")
    bounds = ([max_iterations] if segment_iterations is None
              else segment_bounds(stagger, max_iterations, segment_iterations))
    u, it, delta, done = state.u, 0, state.epsilon + 1.0, False
    for bound in bounds:
        u, it, delta, done = _protocol(chunk, u, state.locked, state.epsilon, stagger, bound, it,
                                       delta, done, k=k, tile=tile)
        if done:
            break
    dev = u.device
    return dataclasses.replace(
        state, u=u, iteration=torch.tensor(it, dtype=torch.int32, device=dev), delta=delta,
        converged=torch.tensor(done, dtype=torch.bool, device=dev))


def lanes_update_n(u: torch.Tensor, locked: torch.Tensor, iteration, num_sweeps: int,
                   active: torch.Tensor | None = None, *, k: int, tile):
    """The schedule of ``epic_lanes2d_chunk`` (the batched chunk's tiled
    route) on a ``[B, H, W]`` batch, each lane a grid of its own:
    ``ceil(num_sweeps / k)`` chunks spread as :func:`spread` spreads them,
    ping-pong between u and a twin, a lane's delta its chunk 0's; after an
    odd count the running lanes are copied back from the twin. A lane whose
    optional ``active`` flag is False is neither read nor written and
    reports delta 0. The twin starts as NaN, so a lane read from where the
    kernel never wrote shows. Returns ``(u, delta [B])``, equal to
    ``batched.update_n_batch`` bit for bit; ``u`` is not modified."""
    _check_layout(k, tile)
    if num_sweeps < 1:
        raise ValueError(f"num_sweeps must be >= 1, got {num_sweeps}")
    calls["lanes_update_n"] += 1
    runs = [lane for lane in range(u.shape[0]) if active is None or bool(active[lane])]
    bufs = [u.clone(), torch.full_like(u, float("nan"))]
    delta = torch.zeros(u.shape[0], dtype=u.dtype, device=u.device)
    per = spread(num_sweeps, -(-num_sweeps // k))
    t = iteration
    for c, ns in enumerate(per):
        src, dst = bufs[c % 2], bufs[1 - c % 2]
        for lane in runs:
            dst[lane], d, _ = sweep_chunk(src[lane], locked[lane], t, ns, k=k, tile=tile)
            if c == 0:
                delta[lane] = d
        t = t + ns
    if len(per) % 2:
        bufs[0][runs] = bufs[1][runs]
    return bufs[0], delta


def lanes_solve(u: torch.Tensor, locked: torch.Tensor, epsilon, stagger: int,
                max_iterations: int, *, k: int, tile):
    """The schedule of ``epic_lanes2d_solve`` (the batched solve's tiled
    route): every lane in lockstep on one iteration t. A cycle is the checked
    chunk of depth ``min(k, stagger)`` over the lanes not retired, which
    keeps each lane's state after sweep 0 in a u1 batch; each lane's
    verdict (retire when delta < eps and t + 1 >= max(H, W), its state its
    u1 slice, never written again); the rest of the cycle
    (:func:`solve_schedule`) over the lanes still active. At the end a
    retired lane is taken from u1, the others from u or the twin by the
    parity of the chunks run. The twin and u1 start as NaN. Returns ``(u,
    iterations int32[B], deltas float32[B], converged bool[B])``, equal to
    ``batched.solve_batch`` bit for bit; ``u`` is not modified."""
    _check_layout(k, tile)
    if stagger < 1:
        raise ValueError(f"stagger must be >= 1, got {stagger}")
    calls["lanes_solve"] += 1
    from .batched import epsilon_lanes

    b, h, w = u.shape
    m_max = max(h, w)
    eps = epsilon_lanes(epsilon, b, u.device)
    iters = torch.zeros(b, dtype=torch.int32, device=u.device)
    deltas = eps + 1.0
    retired = torch.zeros(b, dtype=torch.bool, device=u.device)
    bufs = [u.clone(), torch.full_like(u, float("nan"))]
    first = torch.full_like(u, float("nan"))
    depth, rest = solve_schedule(stagger, k)
    flips, t = 0, 0
    while t < max_iterations:
        live = [lane for lane in range(b) if not retired[lane]]
        src, dst = bufs[flips % 2], bufs[1 - flips % 2]
        for lane in live:
            dst[lane], d, first[lane] = sweep_chunk(src[lane], locked[lane], t, depth, k=k,
                                                    tile=tile, u1=True)
            done = bool(d < eps[lane]) and t + 1 >= m_max
            deltas[lane] = d
            iters[lane] = t + 1 if done else t + stagger
            retired[lane] = done
        flips += 1
        ts = t + depth
        live = [lane for lane in live if not retired[lane]]
        for ns in rest:
            src, dst = bufs[flips % 2], bufs[1 - flips % 2]
            for lane in live:
                dst[lane], _, _ = sweep_chunk(src[lane], locked[lane], ts, ns, k=k, tile=tile)
            flips += 1
            ts += ns
        if not live:
            break
        t += stagger
    return torch.where(retired.view(b, 1, 1), first, bufs[flips % 2]), iters, deltas, retired


def segment_bounds(stagger: int, max_iterations: int, segment_iterations: int) -> list[int]:
    """The iteration bounds of a segmented solve: multiples of
    ``segment_iterations`` rounded up to whole stagger cycles (ROADMAP R4:
    no segment is a no-op), the last one ``max_iterations``."""
    if segment_iterations < 1:
        raise ValueError(f"segment_iterations must be >= 1, got {segment_iterations}")
    step = -(-segment_iterations // stagger) * stagger
    return list(range(step, max_iterations, step)) + [max_iterations]
