"""The 3D volume on a device mesh: shards, K-deep halo exchange, two routes.

The counterpart of ``epic_tpu.parallel.sharded3d``. The volume is padded to
a multiple of the mesh (padding takes the obstacle value and is frozen) and
cut into ``d_loc x h_loc x w_loc`` shards: over a 2D ``("my", "mx")`` mesh
every shard holds the full depth of its plane tile; over a 3D
``("mz", "my", "mx")`` mesh (:func:`make_mesh3d`) the depth is cut too.
Each shard lives on its device as one extended block: its centre with a
halo of ``halo`` voxels on each side of the axes the mesh cuts (an axis
with one shard has none: its faces are the volume's frozen shell or
padding), and a frozen mask of that layout (``locked | shell | padding``;
halo voxels outside the mesh frozen).

Two routes run the sweeps, in place, with the same bits:

- The device route (:mod:`.hopper_resident3d`): one launch a device runs
  any number of sweeps over every shard's centre, reading a face
  neighbour's centre on the same device directly (a sweep's class reads
  only the other class, so that is race-free): K7's sweeps on the whole
  volume, with no halo, no recompute and no exchange. A solve runs its
  whole stagger loop in one more launch (per segment). It takes only a
  *whole* plan: one device of one process holds every shard, as on a
  virtual mesh of one card.
- The per-shard route: a chunk of ``ns <= K`` sweeps (1) exchanges the
  K-deep halos of the blocks in place, in three phases: z, then y, then x,
  each later phase moving strips of the already extended block, so edges
  and corners arrive through the later phases (``sharded3d.py:93-111``);
  (2) runs the per-shard chunk on each block, in place
  (``hopper_shard3d.chunk``). The halo voxels it leaves stale are
  rewritten by the next exchange; no twin is needed. It serves any mesh,
  and is the only route where a face neighbour lives on another device or
  process (the host copies its halo).

``kernel`` picks the route (:func:`_device_plan`, counted in ``routes``):
"auto" the device route on a whole plan except for large shards with
little halo recompute (:func:`prefers_device`, the rule ``tile_probe
--mesh3d`` measured, PERF.md), else the per-shard one; "resident" and, on the CPU,
"resident_interpret" the device route on a whole plan and the per-shard
one on a plan with a copied face; "pallas" and "pallas_banded" (a card)
and "xla", "pallas_interpret" and "pallas_banded_interpret" (the CPU) the
per-shard route. Each route runs its CUDA entries on a card and its plain
versions on the CPU; a name that says otherwise raises. "resident" is
refused on a mesh that cuts z and the planes, as ``epic_tpu`` refuses it
(``sharded3d.py:702-721``); it names :mod:`.resident3d` on plane meshes
and :mod:`.resident_z` on z-only ones.

The first sweep of a call carries the staggered check's delta, the max over
the shards (on the mesh's first device; across processes an
``all_reduce(MAX)``). K18/K19 take it over the block and K20/K21 over the
centre; the max is the same, since a chunk starts right after an exchange
(see :mod:`.hopper_shard3d`). The frozen mask's halos are exchanged once
per edit. Depth: ``min(chunk_depth, extents of the cut axes)``;
trajectories do not depend on it, so neither do results.

Solves follow ``core.solve``'s protocol: a check every ``stagger`` sweeps,
exit only right after a passing check with ``iteration + 1 >= max(D, H,
W)``, the checked sweep's state kept. The per-shard route runs it as a
host loop of stagger cycles (the checked chunk, depth ``min(K, stagger)``,
also writes u1, the centre after its first sweep, kept on exit); the
device route in one launch. With ``segment_iterations`` either pauses at
stagger-aligned bounds (``solver.tiled.segment_bounds``); the trajectory is
the same.

In place, like the rest of the port: the resident verbs change the
``ShardedVolume`` they are given and return it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from .. import constants as C
from .. import grid as G
from ..grid import GridState
from ..solver.tiled import segment_bounds
from . import hopper_resident3d, hopper_shard3d, multihost
from .hopper_resident3d import _extents, _zyx
from .sharded import _CARD_NAMES, FILL, Mesh, _pmax, _run_phase, local_devices, make_mesh, \
    make_mesh3d, near_square
from .sharded import _CPU_NAMES as _CPU_NAMES_2D

__all__ = ["ShardedVolume", "make_mesh3d", "choose_mesh3d", "padded_shape", "shard_state3d",
           "unshard3d", "set_cells_resident3d", "update_n_resident3d", "solve_resident3d",
           "update_n", "solve", "DEFAULT_CHUNK_DEPTH"]

# Sweeps per halo exchange (epic_tpu's sharded3d.DEFAULT_CHUNK_DEPTH).
DEFAULT_CHUNK_DEPTH = 8
# sweep_cost's price of a (z, y) row against one class slot of it, on each
# route, fitted to an H100's 100-sweep ticks of ten volumes on 8 x 1 x 1 and
# 2 x 4 virtual meshes (``python -m epic_tpu_torch.tile_probe --mesh3d``;
# PERF.md): the device route's on all ten, the per-shard route's on the six
# whose shards hold at least 4M voxels (below that the launches and the
# exchange the model leaves out set the pace).
ROW_COST = {"device": 4.5, "shard": 1.25}
# The rule "auto" follows on a whole plan (prefers_device): the device route,
# except for shards of more than DEVICE_MAX_SHARD_VOXELS whose per-shard
# chunks would recompute less than DEVICE_MIN_RECOMPUTE times their centre.
# On an H100 the per-shard route's tick measured faster there (2 x 4 shards
# of 16.8M voxels and more, recompute 1.03; 8 x 1 x 1 shards of 67M, 1.105),
# the device route's everywhere else (shards up to 8.4M voxels, and z shards
# up to 50M at a recompute of 1.14); tile_probe --mesh3d, PERF.md.
DEVICE_MAX_SHARD_VOXELS = 12_000_000
DEVICE_MIN_RECOMPUTE = 1.12

_CPU_NAMES = _CPU_NAMES_2D + ("resident_interpret",)
_RESIDENT = ("resident", "resident_interpret")
# The route of each tick and solve (_device_plan): the device entries, or the
# per-shard entry (a plan with a copied face, or a per-shard name).
routes = {"device": 0, "shard": 0}


def _has_z(mesh: Mesh) -> bool:
    return "mz" in mesh.shape


def sweep_cost(shape, extents, chunk_depth: int = DEFAULT_CHUNK_DEPTH,
               route: str = "shard") -> tuple[int, float]:
    """``(k, cost)``: the chunk depth of a volume of ``shape`` cut into
    ``extents`` (z, y, x) shards, and the modelled cost of one shard's sweep
    on ``route``. Both routes give a lane one class slot of a flat walk over
    the (z, y) rows' half-row slots, so a sweep costs one for each slot and
    ``ROW_COST[route]`` for each row, whose ends break the lanes' runs. The
    device route sweeps the centre; the per-shard route sweeps each sweep's
    trapezoid of the K-extended block (the halo recompute), averaged over a
    chunk. A chunk's fixed cost (launches, the exchange) is left out."""
    loc = [-(-s // n) for s, n in zip(shape, extents)]
    cut = [n > 1 for n in extents]
    k = _depth(loc, cut, chunk_depth)
    if route == "device":
        return k, loc[0] * loc[1] * (-(-loc[2] // 2) + ROW_COST[route])
    block = [n + 2 * k if c else n for n, c in zip(loc, cut)]
    cost = 0.0
    for s in range(k):
        spans = [e - 2 - 2 * s if c else e - 2 for e, c in zip(block, cut)]
        if min(spans) > 0:
            cost += spans[0] * spans[1] * (-(-spans[2] // 2) + ROW_COST[route])
    return k, cost / k


def _trapezoid(loc, cut, k: int) -> float:
    """The voxels a per-shard chunk of depth ``k`` sweeps, a sweep on
    average: each sweep's trapezoid of the K-extended block."""
    block = [n + 2 * k if c else n for n, c in zip(loc, cut)]
    total = 0
    for s in range(k):
        spans = [e - 2 - 2 * s if c else e - 2 for e, c in zip(block, cut)]
        total += max(0, spans[0]) * max(0, spans[1]) * max(0, spans[2])
    return total / k


def prefers_device(loc, cut, k: int) -> bool:
    """Whether "auto" sends a whole plan of ``loc`` shards (``cut`` axes,
    chunk depth ``k``) to the device route: a shard of at most
    ``DEVICE_MAX_SHARD_VOXELS``, or one whose per-shard chunks would sweep
    at least ``DEVICE_MIN_RECOMPUTE`` times its centre."""
    voxels = loc[0] * loc[1] * loc[2]
    return (voxels <= DEVICE_MAX_SHARD_VOXELS
            or _trapezoid(loc, cut, k) >= DEVICE_MIN_RECOMPUTE * voxels)


def whole_mesh(devices) -> bool:
    """Whether a mesh over ``devices`` (this process's) is one whole plan:
    one device of one process holds every shard."""
    return multihost.world()[0] == 1 and len({str(d) for d in devices}) == 1


def choose_mesh3d(shape: tuple[int, int, int], devices=None) -> Mesh:
    """The mesh orientation for a volume of ``shape`` over ``devices`` (by
    default every visible card; without one this raises): a z mesh
    ``make_mesh3d((n, 1, 1))`` where its sweeps cost less than the
    near-square plane mesh's (:func:`sweep_cost`: on the device route where
    one device of one process holds the mesh, else on the per-shard route,
    whose z chunks must also be as deep), else that plane mesh
    (:func:`make_mesh`). ``epic_tpu`` gates the z mesh on a VMEM budget
    (``resident_z.eligible``); the port's model is fitted to the card's
    times of both orientations on each route (PERF.md). On one card the
    device route's model favours the z mesh's long rows; where "auto" then
    takes the per-shard route instead (the largest volumes), the plane
    mesh's per-shard tick measured up to 8% faster (PERF.md)."""
    local = local_devices(devices, "choose_mesh3d")
    n = multihost.world()[0] * len(local)
    plane = near_square(n)
    route = "device" if whole_mesh(local) else "shard"
    kz, z = sweep_cost(shape, (n, 1, 1), route=route)
    kp, p = sweep_cost(shape, (1, *plane), route=route)
    if (route == "device" or kz >= kp) and z < p:
        return make_mesh3d((n, 1, 1), devices=local)
    return make_mesh(plane, devices=local)


def padded_shape(shape, mesh: Mesh) -> tuple[int, int, int]:
    return tuple(-(-s // n) * n for s, n in zip(shape, _extents(mesh)))


def _frozen_mask(state: GridState) -> torch.Tensor:
    """Voxels no sweep updates: locked, and the volume's boundary shell."""
    frozen = state.locked.clone()
    for axis in range(3):
        frozen.select(axis, 0).fill_(True)
        frozen.select(axis, -1).fill_(True)
    return frozen


def _pad_for_mesh(state: GridState, mesh: Mesh):
    """u and the frozen mask padded to a multiple of the mesh (padding: the
    obstacle value, frozen), on the state's device."""
    d, h, w = state.u.shape
    shape = padded_shape((d, h, w), mesh)
    u = torch.full(shape, FILL, dtype=torch.float32, device=state.u.device)
    u[:d, :h, :w] = state.u
    frozen = torch.ones(shape, dtype=torch.bool, device=state.u.device)
    frozen[:d, :h, :w] = _frozen_mask(state)
    return u, frozen


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------


class ShardedVolume:
    """A volume resident on a mesh: per local shard ``idx`` (the mesh's
    index), ``u_blocks[idx]`` (and, once a solve asks, ``u1_blocks[idx]``)
    is an f32 block of the shard's centre ``loc`` with a halo of ``halo``
    voxels on each cut axis, the centre at ``halo`` there (at 0 on the
    others), and ``frozen_blocks[idx]`` its bool frozen mask. ``cut`` says
    which of (z, y, x) the mesh cuts; ``frozen_halo`` is the depth to which
    the frozen halos are exchanged (0 after an edit). The scalars are 0-d
    tensors on the mesh's first device. ``u`` and ``frozen`` gather the
    padded ``[Dp, Hp, Wp]`` arrays there."""

    def __init__(self, mesh: Mesh, shape, halo: int, u_blocks: dict, frozen_blocks: dict,
                 iteration: torch.Tensor, delta: torch.Tensor, epsilon: torch.Tensor):
        self.mesh = mesh
        self.depth, self.height, self.width = shape
        self.halo = halo
        self.u_blocks, self.frozen_blocks = u_blocks, frozen_blocks
        self.u1_blocks: dict | None = None
        self.frozen_halo = 0
        self.iteration, self.delta, self.epsilon = iteration, delta, epsilon
        self.extents = _extents(mesh)
        self.loc = tuple(p // n for p, n in zip(padded_shape(shape, mesh), self.extents))
        self.cut = tuple(n > 1 for n in self.extents)
        self._phases: dict = {}

    @property
    def shape(self) -> tuple[int, int, int]:
        return self.depth, self.height, self.width

    def block_shape(self, halo: int) -> tuple[int, int, int]:
        return tuple(n + 2 * halo if c else n for n, c in zip(self.loc, self.cut))

    def halos(self, k: int) -> tuple[int, int, int]:
        """The halo of each axis in a depth-``k`` view."""
        return tuple(k if c else 0 for c in self.cut)

    def view(self, k: int) -> tuple:
        """The depth-``k`` extended block inside a block."""
        H = self.halo
        return tuple(slice(H - k, H + n + k) if c else slice(None)
                     for n, c in zip(self.loc, self.cut))

    def centre(self, blocks: dict, idx) -> torch.Tensor:
        return blocks[idx][self.view(0)]

    def offset(self, idx) -> tuple[int, int, int]:
        """Global (z, y, x) of the shard's first centre voxel."""
        return tuple(c * n for c, n in zip(_zyx(idx), self.loc))

    def par0(self, idx, k: int) -> int:
        """(z + y + x) & 1 of the depth-``k`` view's origin, global."""
        return (sum(self.offset(idx)) - k * sum(self.cut)) & 1

    @property
    def u(self) -> torch.Tensor:
        return _gather(self, self.u_blocks)

    @property
    def frozen(self) -> torch.Tensor:
        return _gather(self, self.frozen_blocks)


def _blank(mesh: Mesh, shape, fill, dtype) -> dict:
    return {idx: torch.full(shape, fill, dtype=dtype, device=mesh.devices[idx])
            for idx in mesh.local}


def _depth(loc, cut, chunk_depth: int) -> int:
    """The exchange depth: ``min(chunk_depth, extents of the cut axes)``."""
    if chunk_depth < 1:
        raise ValueError(f"chunk_depth must be >= 1, got {chunk_depth}")
    return min([chunk_depth] + [n for n, c in zip(loc, cut) if c])


def halo_for(shape, mesh: Mesh, chunk_depth: int) -> int:
    """The halo a volume of ``shape`` gets on ``mesh`` for chunks of
    ``chunk_depth`` sweeps."""
    ext = _extents(mesh)
    loc = [p // n for p, n in zip(padded_shape(shape, mesh), ext)]
    return _depth(loc, [n > 1 for n in ext], chunk_depth)


def shard_state3d(state: GridState, mesh: Mesh, halo: int | None = None) -> ShardedVolume:
    """Pad a 3D GridState and place its shards on the mesh once, with a
    halo of ``halo`` voxels (by default :func:`halo_for` at
    ``DEFAULT_CHUNK_DEPTH``; a deeper chunk later regrows it); later ticks
    and edits keep the blocks resident."""
    if state.u.ndim != 3:
        raise ValueError(f"the 3D mesh takes a volume, got a {state.u.ndim}D state")
    shape = tuple(state.u.shape)
    H = halo_for(shape, mesh, DEFAULT_CHUNK_DEPTH) if halo is None else halo
    if H < 1:
        raise ValueError(f"the halo must be at least 1 voxel, got {H}")
    u_pad, f_pad = _pad_for_mesh(state, mesh)
    first = mesh.first_device
    sv = ShardedVolume(mesh, shape, H, {}, {},
                       iteration=state.iteration.to(device=first, dtype=torch.int32),
                       delta=state.delta.to(device=first, dtype=torch.float32),
                       epsilon=state.epsilon.to(device=first, dtype=torch.float32))
    ext = sv.block_shape(H)
    sv.u_blocks = _blank(mesh, ext, FILL, torch.float32)
    sv.frozen_blocks = _blank(mesh, ext, True, torch.bool)
    for idx in mesh.local:
        src = tuple(slice(o, o + n) for o, n in zip(sv.offset(idx), sv.loc))
        sv.centre(sv.u_blocks, idx).copy_(u_pad[src])
        sv.centre(sv.frozen_blocks, idx).copy_(f_pad[src])
    return sv


def _regrow(sv: ShardedVolume, halo: int) -> None:
    """Re-lay the blocks with a deeper halo (the centres kept)."""
    ext = sv.block_shape(halo)
    old = sv.view(0)
    u_blocks = _blank(sv.mesh, ext, FILL, torch.float32)
    frozen_blocks = _blank(sv.mesh, ext, True, torch.bool)
    sv.halo = halo
    for idx in sv.mesh.local:
        sv.centre(u_blocks, idx).copy_(sv.u_blocks[idx][old])
        sv.centre(frozen_blocks, idx).copy_(sv.frozen_blocks[idx][old])
    sv.u_blocks, sv.frozen_blocks = u_blocks, frozen_blocks
    sv.u1_blocks = None
    sv.frozen_halo = 0


def _gather(sv: ShardedVolume, blocks: dict) -> torch.Tensor:
    """The shards' centres as one padded ``[Dp, Hp, Wp]`` tensor on the
    mesh's first device; across processes every process gathers all of
    them."""
    mesh = sv.mesh
    first = mesh.first_device
    nz, ny, nx = sv.extents
    if mesh.multi_process:
        local = torch.stack([sv.centre(blocks, idx).to(first) for idx in mesh.local])
        dtype = local.dtype
        if dtype == torch.bool:
            local = local.to(torch.uint8)
        parts = [torch.empty_like(local) for _ in range(int(mesh.ranks.max()) + 1)]
        dist.all_gather(parts, local.contiguous())
        centres = list(torch.cat(parts).to(dtype))
    else:
        centres = [sv.centre(blocks, idx).to(first) for idx in np.ndindex(*mesh.devices.shape)]
    rows = [torch.cat(centres[r * nx:(r + 1) * nx], dim=2) for r in range(nz * ny)]
    return torch.cat([torch.cat(rows[a * ny:(a + 1) * ny], dim=1) for a in range(nz)])


def unshard3d(sv: ShardedVolume) -> GridState:
    """Gather back to a GridState on the mesh's first device. The boundary
    shell comes back locked (the shards fold ``locked | shell`` into one
    mask)."""
    d, h, w = sv.shape
    return GridState(
        u=sv.u[:d, :h, :w].contiguous(),
        locked=sv.frozen[:d, :h, :w].contiguous(),
        iteration=sv.iteration,
        delta=sv.delta,
        converged=torch.zeros((), dtype=torch.bool, device=sv.mesh.first_device),
        epsilon=sv.epsilon,
    )


# ---------------------------------------------------------------------------
# Halo exchange
# ---------------------------------------------------------------------------


def _transfers(sv: ShardedVolume, k: int) -> list:
    """The exchange at depth k as one phase per cut axis (z, y, x) of
    ``(src shard, src index, dst shard, dst index)``: each shard's two halos
    on that axis from the neighbours' K edge layers of the centre, with the
    axes of the earlier phases extended by k (their halos already filled)."""
    key = (k, sv.halo)
    if key in sv._phases:
        return sv._phases[key]
    H, mesh = sv.halo, sv.mesh
    phases = []
    for axis, n_shards in enumerate(sv.extents):
        if n_shards == 1:
            continue
        base = [slice(None) if not c else slice(H - k, H + n + k) if a < axis
                else slice(H, H + n) for a, (n, c) in enumerate(zip(sv.loc, sv.cut))]
        n = sv.loc[axis]
        sides = ((-1, slice(H + n - k, H + n), slice(H - k, H)),      # from the lower neighbour
                 (+1, slice(H, H + k), slice(H + n, H + n + k)))      # from the upper one
        phase = []
        for zyx in np.ndindex(*sv.extents):
            for step, s_sl, d_sl in sides:
                if not 0 <= zyx[axis] + step < n_shards:
                    continue
                src = list(zyx)
                src[axis] += step
                s_idx, d_idx = list(base), list(base)
                s_idx[axis], d_idx[axis] = s_sl, d_sl
                phase.append((_mesh_idx(mesh, src), tuple(s_idx), _mesh_idx(mesh, zyx),
                              tuple(d_idx)))
        phases.append(phase)
    sv._phases[key] = phases
    return phases


def _mesh_idx(mesh: Mesh, zyx) -> tuple:
    return tuple(zyx) if _has_z(mesh) else tuple(zyx[1:])


def _exchange(sv: ShardedVolume, blocks: dict, k: int) -> None:
    """Fill the K-deep halos of ``blocks`` (u or frozen) from the
    neighbouring shards, in place; halos outside the mesh keep their fill."""
    for phase in _transfers(sv, k):
        _run_phase(sv.mesh, blocks, phase)


def _frozen_halos(sv: ShardedVolume, k: int) -> None:
    if sv.frozen_halo < k:
        _exchange(sv, sv.frozen_blocks, k)
        sv.frozen_halo = k


# ---------------------------------------------------------------------------
# Per-shard chunks and the loops over them
# ---------------------------------------------------------------------------


def check_kernel(kernel: str, mesh: Mesh) -> None:
    """Refuse a kernel name this mesh does not run: each route follows the
    device (the CUDA entries on a card, the plain versions on the CPU), and a
    name only picks the route and confirms the device."""
    on_card = mesh.device_type == "cuda"
    if kernel in _CARD_NAMES and not on_card:
        raise ValueError(f"kernel={kernel!r} runs the CUDA entry; this mesh lies on "
                         f"{mesh.device_type} (use 'auto' or 'resident')")
    if kernel in _CPU_NAMES and on_card:
        raise ValueError(f"kernel={kernel!r} names the plain version; this mesh lies on "
                         "cuda (use 'auto' or 'resident')")
    if kernel not in ("auto", "resident") + _CARD_NAMES + _CPU_NAMES:
        raise ValueError(f"unknown sharded 3D kernel {kernel!r}")


def _check_route(mesh: Mesh, kernel: str, shape) -> None:
    """Refuse ``kernel`` where it names a route this mesh does not take: a
    name of the other device (:func:`check_kernel`), or "resident" where
    neither :mod:`.resident3d` (plane meshes) nor :mod:`.resident_z`
    (z-only meshes) serves the volume."""
    check_kernel(kernel, mesh)
    if kernel not in _RESIDENT:
        return
    from . import resident3d, resident_z

    if not _has_z(mesh):
        resident3d.check_mesh(shape, mesh)
    elif mesh.shape["my"] == 1 and mesh.shape["mx"] == 1:
        resident_z.check_mesh(shape, mesh)
    else:
        raise ValueError("no resident 3D layout fits a mesh that cuts z and the planes "
                         f"({mesh}); use kernel='auto'")


def _on_devices(mesh: Mesh, t: torch.Tensor) -> dict:
    return {dev: t.to(dev) for dev in {mesh.devices[idx] for idx in mesh.local}}


def _device_plan(sv: ShardedVolume, kernel: str, k: int):
    """The route rule: the plan the device entries run for ``kernel`` at
    chunk depth ``k``, or None for the per-shard route. "resident" and
    "resident_interpret" take the device route where one plan covers the
    mesh (no face copied) and its centres fit the entries' index; "auto"
    does so where :func:`prefers_device` holds too; every other name, and
    every other plan, takes the per-shard route. Counted in ``routes``."""
    check_kernel(kernel, sv.mesh)
    plan = None
    if kernel in _RESIDENT or (kernel == "auto" and prefers_device(sv.loc, sv.cut, k)):
        found = hopper_resident3d.plans(sv.mesh)
        if len(found) == 1 and found[0].whole and hopper_resident3d.fits(sv, found[0]):
            plan = found[0]
    routes["device" if plan is not None else "shard"] += 1
    return plan


def _chunk(sv: ShardedVolume, k: int, its: dict, t_off: int, ns: int, *, delta: bool = False,
           u1: bool = False):
    """One exchange and ``ns`` sweeps in place on every local shard from
    iteration ``its[device] + t_off`` (after sweep 0 the centres go to the
    u1 blocks). Returns the pmax of sweep 0's delta when ``delta``."""
    _exchange(sv, sv.u_blocks, k)
    view, halo = sv.view(k), sv.halos(k)
    deltas = []
    for idx in sv.mesh.local:
        deltas.append(hopper_shard3d.chunk(
            sv.u_blocks[idx][view], sv.frozen_blocks[idx][view], halo=halo,
            par0=sv.par0(idx, k), iteration=its[sv.mesh.devices[idx]], ns=ns, t_off=t_off,
            u1=sv.u1_blocks[idx][view] if u1 else None, want_delta=delta))
    return _pmax(sv.mesh, deltas) if delta else None


def _prepare(sv: ShardedVolume, chunk_depth: int) -> int:
    """The depth of a call; regrow the halo and exchange the frozen halos as
    needed (either route: the layout does not depend on the route)."""
    k = _depth(sv.loc, sv.cut, chunk_depth)
    if k > sv.halo and any(sv.cut):
        _regrow(sv, k)
    _frozen_halos(sv, k)
    return k


def _update(sv: ShardedVolume, num_steps: int, chunk_depth: int, kernel: str) -> ShardedVolume:
    """``num_steps`` sweeps from ``sv.iteration``, in place: one launch of
    the device route, or ceil(num_steps / K) exchange rounds of the
    per-shard route (the first ``min(K, num_steps)`` deep, then full chunks,
    then the remainder); the delta is the first sweep's (pmax)."""
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    k = _prepare(sv, chunk_depth)
    plan = _device_plan(sv, kernel, k)
    if plan is not None:
        delta = hopper_resident3d.cycle(sv, plan, sv.iteration.to(plan.device), num_steps)
    else:
        its = _on_devices(sv.mesh, sv.iteration)
        d1 = min(k, num_steps)
        delta = _chunk(sv, k, its, 0, d1, delta=True)
        t = d1
        while t < num_steps:
            ns = min(k, num_steps - t)
            _chunk(sv, k, its, t, ns)
            t += ns
    sv.iteration = sv.iteration + num_steps
    sv.delta = delta
    return sv


def _solve(sv: ShardedVolume, stagger: int, max_iterations: int, chunk_depth: int,
           segment_iterations: int | None, kernel: str):
    """``core.solve``'s protocol on the resident blocks, in place (iteration
    reset to 0, a check every ``stagger`` sweeps, exit only right after a
    passing check with ``iteration >= max(D, H, W)``, the post-check-sweep
    state kept), paused at the segment bounds: the device route's solve
    entry once a segment, or the per-shard route's host loop. Returns
    ``(sv, converged)``."""
    if stagger < 1:
        raise ValueError(f"stagger must be >= 1, got {stagger}")
    k = _prepare(sv, chunk_depth)
    bounds = ([max_iterations] if segment_iterations is None
              else segment_bounds(stagger, max_iterations, segment_iterations))
    plan = _device_plan(sv, kernel, k)
    if plan is not None:
        return _solve_whole(sv, plan, stagger, bounds)
    mesh = sv.mesh
    if sv.u1_blocks is None:
        sv.u1_blocks = _blank(mesh, sv.block_shape(sv.halo), FILL, torch.float32)
    first = mesh.first_device
    zero = _on_devices(mesh, torch.zeros((), dtype=torch.int32, device=first))
    m_max = max(sv.shape)
    depth = min(k, stagger)
    it, delta, done = 0, sv.epsilon + 1.0, False
    for bound in bounds:
        while not done and it < bound:
            delta = _chunk(sv, k, zero, it, depth, delta=True, u1=True)
            if it + 1 >= m_max and bool(delta < sv.epsilon):
                sv.u_blocks, sv.u1_blocks = sv.u1_blocks, sv.u_blocks
                it, done = it + 1, True
                break
            t = it + depth
            while t < it + stagger:
                ns = min(k, it + stagger - t)
                _chunk(sv, k, zero, t, ns)
                t += ns
            it += stagger
        if done:
            break
    sv.iteration = torch.tensor(it, dtype=torch.int32, device=first)
    sv.delta = delta
    return sv, torch.tensor(done, dtype=torch.bool, device=first)


def _solve_whole(sv: ShardedVolume, plan, stagger: int, bounds: list):
    """The device route's solve: the solve entry once a segment, each
    resuming where the last stopped; the verdict read between segments."""
    dev = plan.device
    it = torch.zeros((), dtype=torch.int32, device=dev)
    delta = (sv.epsilon + 1.0).to(device=dev, dtype=torch.float32)
    done = torch.zeros((), dtype=torch.int32, device=dev)
    for bound in bounds:
        hopper_resident3d.solve(sv, plan, stagger, bound, it, delta, done)
        if len(bounds) > 1 and bool(done):
            break
    sv.iteration, sv.delta = it, delta
    return sv, done != 0


def _check_mesh(sv: ShardedVolume, mesh: Mesh | None) -> None:
    if mesh is not None and mesh != sv.mesh:
        raise ValueError(f"the volume lives on {sv.mesh}, not {mesh}")


# ---------------------------------------------------------------------------
# The resident verbs
# ---------------------------------------------------------------------------


def update_n_resident3d(sv: ShardedVolume, num_steps: int, mesh: Mesh | None = None,
                        chunk_depth: int = DEFAULT_CHUNK_DEPTH,
                        kernel: str = "auto") -> ShardedVolume:
    """Anytime chunk on a mesh-resident volume, in place: no re-pad, no
    re-upload; returns ``sv``, relaxed, its iteration advanced and its delta
    the first sweep's. ``kernel`` picks the route (:func:`_device_plan`) or
    refuses the name (:func:`_check_route`)."""
    _check_mesh(sv, mesh)
    _check_route(sv.mesh, kernel, sv.shape)
    return _update(sv, num_steps, chunk_depth, kernel)


def solve_resident3d(sv: ShardedVolume, mesh: Mesh | None = None,
                     stagger: int = C.DEFAULT_STAGGER, max_iterations: int = 1_000_000,
                     chunk_depth: int = DEFAULT_CHUNK_DEPTH, kernel: str = "auto",
                     segment_iterations: int | None = None):
    """Solve to convergence on the resident blocks, in place (the protocol
    of :func:`_solve`); ``kernel`` as in :func:`update_n_resident3d`.
    Returns ``(sv, converged)``."""
    _check_mesh(sv, mesh)
    _check_route(sv.mesh, kernel, sv.shape)
    return _solve(sv, stagger, max_iterations, chunk_depth, segment_iterations, kernel)


def set_cells_resident3d(sv: ShardedVolume, xyz, types) -> ShardedVolume:
    """SetCells on the resident blocks, in place (``grid.set_cells_3d``'s
    preprocessing: invalid entries skipped, duplicates last-wins): each
    owning shard takes its writes. Values on the boundary shell are
    written, but shell voxels stay frozen (``sharded3d.py:672-699``: no
    sweep updates them, and an unfrozen shell voxel would read out-of-mesh
    fill)."""
    xyz, u_vals, locked_vals = G.sanitize_cell_edits_3d(xyz, types, sv.width, sv.height,
                                                         sv.depth)
    if xyz.shape[0] == 0:
        return sv
    coords = (xyz[:, 2], xyz[:, 1], xyz[:, 0])
    on_shell = np.zeros(len(xyz), dtype=bool)
    for c, n in zip(coords, sv.shape):
        on_shell |= (c == 0) | (c == n - 1)
    f_vals = locked_vals | on_shell
    owner = [c // n for c, n in zip(coords, sv.loc)]
    centre = sv.view(0)
    for idx in sv.mesh.local:
        zyx = _zyx(idx)
        m = (owner[0] == zyx[0]) & (owner[1] == zyx[1]) & (owner[2] == zyx[2])
        if not m.any():
            continue
        dev = sv.mesh.devices[idx]
        index = tuple(torch.as_tensor(c[m] - o + (sl.start or 0), device=dev)
                      for c, o, sl in zip(coords, sv.offset(idx), centre))
        sv.u_blocks[idx][index] = torch.as_tensor(u_vals[m], device=dev)
        sv.frozen_blocks[idx][index] = torch.as_tensor(f_vals[m], device=dev)
    sv.frozen_halo = 0
    return sv


def reset_free_cells_resident3d(sv: ShardedVolume) -> ShardedVolume:
    """srvResetFreeCells on the resident blocks, in place, as
    ``grid.reset_free_cells``: every unfrozen voxel back to the FREE value,
    the iteration to 0, the delta to ``epsilon + 1``."""
    for idx in sv.mesh.local:
        sv.centre(sv.u_blocks, idx).masked_fill_(~sv.centre(sv.frozen_blocks, idx),
                                                 float(C.LOG_SPACE_FREE))
    sv.iteration = torch.zeros((), dtype=torch.int32, device=sv.mesh.first_device)
    sv.delta = sv.epsilon + 1.0
    return sv


def occupancy_resident3d(sv: ShardedVolume, data: np.ndarray) -> bool:
    """An occupancy volume (``VolumePlanner.update_occupancy``'s rule)
    applied to the resident blocks, in place and on the devices: interior
    voxels whose value is not OCCUPANCY_NO_CHANGE, and that are not goals,
    become OBSTACLE (value >= OCCUPANCY_OBSTACLE_THRESHOLD) or FREE. Returns
    whether any voxel changed (across processes, anywhere)."""
    data = np.asarray(data)
    if data.shape != sv.shape:
        raise ValueError(f"occupancy of shape {data.shape} for a {sv.shape} volume")
    changed = torch.zeros((), dtype=torch.bool, device=sv.mesh.first_device)
    for idx in sv.mesh.local:
        dev = sv.mesh.devices[idx]
        block = np.full(sv.loc, C.OCCUPANCY_NO_CHANGE, dtype=np.int16)
        src, dst = [], []
        for o, n, full in zip(sv.offset(idx), sv.loc, sv.shape):
            lo, hi = max(o, 1), min(o + n, full - 1)      # the shell never changes
            src.append(slice(lo, max(lo, hi)))
            dst.append(slice(lo - o, max(lo, hi) - o))
        block[tuple(dst)] = data[tuple(src)]
        d = torch.from_numpy(block).to(dev)
        u, f = sv.centre(sv.u_blocks, idx), sv.centre(sv.frozen_blocks, idx)
        goal = f & (u == float(C.LOG_SPACE_GOAL))
        change = (d != C.OCCUPANCY_NO_CHANGE) & ~goal
        obstacle = change & (d >= C.OCCUPANCY_OBSTACLE_THRESHOLD)
        # OBSTACLE and FREE both hold -1e6; locked for obstacles only.
        u.masked_fill_(change, float(C.LOG_SPACE_OBSTACLE))
        f.copy_((f & ~change) | obstacle)
        changed |= change.any().to(changed.device)
    sv.frozen_halo = 0
    if sv.mesh.multi_process:
        flag = changed.to(torch.int32).reshape(1)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        changed = flag[0] > 0
    return bool(changed)


def read_cell3d(sv: ShardedVolume, x: int, y: int, z: int) -> tuple[bool, float] | None:
    """(frozen, u) of one voxel from its shard: a 5-byte read. None when the
    shard belongs to another process."""
    zyx = tuple(c // n for c, n in zip((z, y, x), sv.loc))
    idx = _mesh_idx(sv.mesh, zyx)
    if sv.mesh.ranks[idx] != sv.mesh.rank:
        return None
    at = tuple(c - o + (sl.start or 0)
               for c, o, sl in zip((z, y, x), sv.offset(idx), sv.view(0)))
    return bool(sv.frozen_blocks[idx][at]), float(sv.u_blocks[idx][at])


# ---------------------------------------------------------------------------
# GridState entry points
# ---------------------------------------------------------------------------


def _result(state: GridState, sv: ShardedVolume, converged: torch.Tensor) -> GridState:
    """``state`` with the mesh's relaxed field cut back to ``d x h x w``, all
    on the mesh's first device."""
    d, h, w = state.u.shape
    first = sv.mesh.first_device
    return dataclasses.replace(state, u=sv.u[:d, :h, :w].contiguous(),
                               locked=state.locked.to(first), epsilon=state.epsilon.to(first),
                               iteration=sv.iteration, delta=sv.delta, converged=converged)


def update_entry(state: GridState, num_steps: int, mesh: Mesh, chunk_depth: int,
                 kernel: str) -> GridState:
    """``core.update_n``'s semantics on a mesh through the blocks, on the
    route ``kernel`` picks."""
    sv = shard_state3d(state, mesh, halo_for(tuple(state.u.shape), mesh, chunk_depth))
    _update(sv, num_steps, chunk_depth, kernel)
    converged = ((sv.delta < sv.epsilon) if num_steps == 1
                 else torch.zeros((), dtype=torch.bool, device=mesh.first_device))
    return _result(state, sv, converged)


def solve_entry(state: GridState, mesh: Mesh, stagger: int, max_iterations: int,
                chunk_depth: int, segment_iterations: int | None, kernel: str) -> GridState:
    """``core.solve`` on a mesh through the blocks (the protocol of
    :func:`_solve`), on the route ``kernel`` picks."""
    sv = shard_state3d(state, mesh, halo_for(tuple(state.u.shape), mesh, chunk_depth))
    sv, converged = _solve(sv, stagger, max_iterations, chunk_depth, segment_iterations, kernel)
    return _result(state, sv, converged)


def update_n(state: GridState, num_steps: int, mesh: Mesh,
             chunk_depth: int = DEFAULT_CHUNK_DEPTH, kernel: str = "auto") -> GridState:
    """``core.update_n``'s semantics on a mesh: ``num_steps`` sweeps, delta
    from the first, ``converged`` only for a single sweep. ``kernel`` picks
    the route or refuses the name (:func:`_check_route`). Returns a
    GridState on the mesh's first device."""
    _check_route(mesh, kernel, tuple(state.u.shape))
    return update_entry(state, num_steps, mesh, chunk_depth, kernel)


def solve(state: GridState, mesh: Mesh, stagger: int = C.DEFAULT_STAGGER,
          max_iterations: int = 1_000_000, kernel: str = "auto",
          segment_iterations: int | None = None) -> GridState:
    """``core.solve`` on a mesh at ``DEFAULT_CHUNK_DEPTH`` (the protocol of
    :func:`solve_resident3d`); ``kernel`` as in :func:`update_n`. Returns a
    GridState on the mesh's first device."""
    _check_route(mesh, kernel, tuple(state.u.shape))
    return solve_entry(state, mesh, stagger, max_iterations, DEFAULT_CHUNK_DEPTH,
                       segment_iterations, kernel)
