"""The 3D mesh's device route: every shard of a device in one launch.

The counterpart of ``epic_tpu.parallel``'s 3D mesh kernels (K18–K21: the
per-shard chunk of ``sharded3d``, ``resident3d._chunk_cycle`` and
``resident_z._resident_z_kernel``) and the solve loops that run them. All of
them compute ``ns`` guarded ``lse6`` sweeps of a shard, exact on its centre,
with sweep 0's delta. In the port a shard stays resident as its extended
block (:mod:`.sharded3d`); what this route adds is the rest: all of a
device's shards in one program, and the solve's loop inside it. Two CUDA
entries in ``csrc/shard3d.cu`` carry it: ``epic_resident3d_cycle`` (``ns``
sweeps, any ``ns``, in one cooperative launch over every shard's centre, a
grid barrier between sweeps) and ``epic_resident3d_solve`` (the stagger
protocol in one launch, resumable from ``(iteration, delta, done)`` up to a
bound).

The plan (:func:`plans`) is a pure function of the mesh: for each device of
this process, its local shards and, for each, the kind of each of its six
face neighbours, in ``lse6``'s order (z-, z+, y-, y+, x-, x+): ``DIRECT``
(the same device and process: a read across that face goes to the
neighbour's centre, in place), ``COPIED`` (another device or process) or
``OUTSIDE`` (the mesh's edge, or an axis the mesh does not cut: the own
block holds what lies there, the frozen fill or the volume's shell). A plan
is *whole* when no face is copied: one device of one process holds the
mesh. The entries take whole plans only. A lse6 reads only face
neighbours, and a sweep's class reads only the other class, so an in-place
sweep across the shards' faces is race-free and computes K7's sweeps on the
whole volume: no halo, no recompute, no exchange. A plan with a copied face
takes the per-shard entry after a halo exchange (:mod:`.hopper_shard3d`);
that is :mod:`.sharded3d`'s route rule, not a fallback.

The delta is sweep 0's ``max |u1 - u0|`` over the centres: the max over the
shards of K14–K21's (see :mod:`.hopper_shard3d`). The halos are neither
read (but across an outside face, where no updated voxel reads) nor
written; the per-shard route exchanges every halo before it reads one.

:func:`plain_cycle3d` and :func:`plain_solve3d` are the plain torch
versions: the same reads (the centre, direct faces from the neighbour's
block, outside faces from the own block) in ``core``'s ``lse6`` op order,
so they give ``core``'s bits. The wrappers :func:`cycle` and :func:`solve`
send a plan on the CPU to them and a plan on a card to the kernels, or
raise. ``launches`` counts the kernels' launches and ``calls`` the plain
versions' calls; nothing else changes them.
"""

from __future__ import annotations

import dataclasses

import torch

from ..solver import _build
from ..solver._sweep_body import lse6
from ..solver.hopper_sweep import _iteration, _stream
from .hopper_shard3d import MAX_VOXELS
from .sharded import FILL

DIRECT, COPIED, OUTSIDE = "direct", "copied", "outside"
# The six faces as (z, y, x) offsets on the mesh, in lse6's neighbour order;
# csrc/shard3d.cu's plan table uses this order.
FACES = ((-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1))
launches = {"epic_resident3d_cycle": 0, "epic_resident3d_solve": 0}
calls = {"cycle": 0, "solve": 0}


def _zyx(idx) -> tuple[int, int, int]:
    """A mesh index as (z, y, x) shard coordinates (z = 0 on a 2D mesh)."""
    return tuple(idx) if len(idx) == 3 else (0, *idx)


def _extents(mesh) -> tuple[int, int, int]:
    """Shards along (z, y, x); 1 along z on a 2D mesh."""
    return mesh.shape.get("mz", 1), mesh.shape["my"], mesh.shape["mx"]


def _neighbour(mesh, idx, face):
    """The mesh index across ``face`` of shard ``idx``, or None past the
    mesh's edge."""
    zyx = [a + b for a, b in zip(_zyx(idx), face)]
    if not all(0 <= a < n for a, n in zip(zyx, _extents(mesh))):
        return None
    return tuple(zyx) if len(idx) == 3 else tuple(zyx[1:])


@dataclasses.dataclass
class Plan:
    """One device's share of the route: ``slots``, its local shards in
    row-major order, and ``kinds[idx]``, the kind of each of shard
    ``idx``'s six faces in :data:`FACES` order."""

    device: torch.device
    slots: list
    kinds: dict

    @property
    def whole(self) -> bool:
        """No face is copied: the plan covers the whole mesh."""
        return all(k != COPIED for faces in self.kinds.values() for k in faces)


def _kind(mesh, idx, face) -> str:
    s = _neighbour(mesh, idx, face)
    if s is None:
        return OUTSIDE
    same = mesh.ranks[s] == mesh.rank and mesh.devices[s] == mesh.devices[idx]
    return DIRECT if same else COPIED


def plans(mesh) -> list[Plan]:
    """The plan of each of this process's devices, in the order of their
    first local shard."""
    out: dict = {}
    for idx in mesh.local:
        plan = out.setdefault(str(mesh.devices[idx]), Plan(mesh.devices[idx], [], {}))
        plan.slots.append(idx)
        plan.kinds[idx] = tuple(_kind(mesh, idx, f) for f in FACES)
    return list(out.values())


def fits(sv, plan: Plan) -> bool:
    """Whether the plan's centres stay inside the entries' 32-bit flat
    index (``hopper_shard3d.MAX_VOXELS``, the per-shard entry's bound)."""
    d, h, w = sv.loc
    return len(plan.slots) * d * h * w < MAX_VOXELS


# ---------------------------------------------------------------------------
# The plain versions
# ---------------------------------------------------------------------------


def _face_slab(axis: int, pos: int, base) -> tuple:
    """An index: position ``pos`` on ``axis``, ``base`` on the others."""
    out = list(base)
    out[axis] = pos
    return tuple(out)


def _sweep_shard(sv, plan: Plan, idx, t: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Shard ``idx``'s centre after sweep ``t`` and before it, as the entry
    reads it: the centre extended by one voxel on every axis, the faces from
    the DIRECT neighbour's centre or the own block (FILL past an uncut axis:
    the shell there is frozen, so no update reads it)."""
    d, h, w = sv.loc
    o = sv.halos(sv.halo)
    block = sv.u_blocks[idx]
    centre = block[sv.view(0)]
    ext = torch.full((d + 2, h + 2, w + 2), FILL, dtype=torch.float32, device=block.device)
    inner = (slice(1, d + 1), slice(1, h + 1), slice(1, w + 1))
    centre_idx = [slice(a, a + m) for a, m in zip(o, sv.loc)]
    ext[inner] = centre
    for f, (face, kind) in enumerate(zip(FACES, plan.kinds[idx])):
        axis, side = f // 2, f % 2
        n = sv.loc[axis]
        if not sv.cut[axis]:
            continue
        dst = _face_slab(axis, n + 1 if side else 0, inner)
        if kind == DIRECT:
            src_block = sv.u_blocks[_neighbour(sv.mesh, idx, face)]
            src = _face_slab(axis, o[axis] + (0 if side else n - 1), centre_idx)
        else:
            src_block = block
            src = _face_slab(axis, o[axis] + (n if side else -1), centre_idx)
        ext[dst] = src_block[src]
    val = lse6(ext[:-2, 1:-1, 1:-1], ext[2:, 1:-1, 1:-1], ext[1:-1, :-2, 1:-1],
               ext[1:-1, 2:, 1:-1], ext[1:-1, 1:-1, :-2], ext[1:-1, 1:-1, 2:])
    dev = block.device
    z, y, x = (torch.arange(n, device=dev) for n in sv.loc)
    par = sv.par0(idx, 0)
    cls = (par + z[:, None, None] + y[None, :, None] + x[None, None, :]) % 2 == t % 2
    update = cls & ~sv.frozen_blocks[idx][sv.view(0)]
    return torch.where(update, val, centre), centre.clone()


def plain_cycle3d(sv, plan: Plan, iteration, ns: int, *, t_off: int = 0,
                  u1: bool = False) -> torch.Tensor:
    """The plain version of :func:`cycle`, on any device: each sweep
    updates the shards one after another in place (a sweep's class reads
    only the other class, so the order does not matter)."""
    calls["cycle"] += 1
    _check_cycle(sv, plan, ns, u1)
    t0 = int(iteration) + t_off
    delta = torch.zeros((), dtype=torch.float32, device=plan.device)
    c = sv.view(0)
    for s in range(ns):
        for idx in plan.slots:
            new, old = _sweep_shard(sv, plan, idx, t0 + s)
            if s == 0:
                delta = torch.maximum(delta, (new - old).abs().max().to(delta.device))
            sv.u_blocks[idx][c] = new
        if s == 0 and u1:
            for idx in plan.slots:
                sv.u1_blocks[idx][c] = sv.u_blocks[idx][c]
    return delta


def plain_solve3d(sv, plan: Plan, stagger: int, bound: int, iteration: torch.Tensor,
                  delta: torch.Tensor, done: torch.Tensor) -> None:
    """The plain version of :func:`solve`, on any device: the entry's loop,
    a checked sweep and the rest of the cycle through
    :func:`plain_cycle3d`."""
    calls["solve"] += 1
    _check_solve(sv, plan, stagger)
    m_max = max(sv.shape)
    eps = sv.epsilon.to(device=plan.device, dtype=torch.float32)
    it, d, finished = int(iteration), delta.clone(), bool(done)
    while not finished and it < bound:
        d = plain_cycle3d(sv, plan, it, 1)
        if bool(d < eps) and it + 1 >= m_max:
            it, finished = it + 1, True
            break
        if stagger > 1:
            plain_cycle3d(sv, plan, it, stagger - 1, t_off=1)
        it += stagger
    iteration.fill_(it)
    delta.copy_(d)
    done.fill_(int(finished))


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


def _check_cycle(sv, plan: Plan, ns: int, u1: bool) -> None:
    if ns < 1:
        raise ValueError(f"a cycle runs at least one sweep, got {ns}")
    if not plan.whole:
        raise ValueError("the device entries need a whole plan (no face copied: one device of "
                         "one process holds the mesh); take the per-shard entry")
    if u1 and sv.u1_blocks is None:
        raise ValueError("u1 asked for, but the volume has no u1 blocks")


def _check_solve(sv, plan: Plan, stagger: int) -> None:
    if stagger < 1:
        raise ValueError(f"stagger must be >= 1, got {stagger}")
    if not plan.whole:
        raise ValueError("the device entries need a whole plan (no face copied: one device of "
                         "one process holds the mesh); take the per-shard entry")


def _check_blocks(sv, plan: Plan, u1: bool) -> None:
    """What the entries take: per shard float32 blocks (u, and u1 when
    asked) and a bool frozen block of one shape and one plane and row pitch,
    unit x stride, on the plan's device; centres inside the 32-bit index."""
    first = sv.u_blocks[plan.slots[0]]
    shape, stride = tuple(first.shape), first.stride()
    for idx in plan.slots:
        grids = [sv.u_blocks[idx]] + ([sv.u1_blocks[idx]] if u1 else [])
        for t in grids + [sv.frozen_blocks[idx]]:
            if tuple(t.shape) != shape or t.device != plan.device:
                raise ValueError(f"shard {idx}: need {shape} blocks on {plan.device}")
            if t.stride() != stride or t.stride(2) != 1:
                raise ValueError(f"shard {idx}: the blocks must share one plane and row pitch "
                                 "and a unit x stride")
        if any(t.dtype != torch.float32 for t in grids) or sv.frozen_blocks[idx].dtype != torch.bool:
            raise TypeError(f"shard {idx}: need float32 blocks and a bool frozen block")
        if len({t.data_ptr() for t in grids}) != len(grids):
            raise ValueError(f"shard {idx}: u and u1 must be distinct blocks")
    if tuple(n + 2 * h for n, h in zip(sv.loc, sv.halos(sv.halo))) != shape:
        raise ValueError(f"blocks of {shape} do not hold {sv.loc} centres with halos "
                         f"{sv.halos(sv.halo)}")
    if not fits(sv, plan):
        raise ValueError(f"{len(plan.slots)} centres of {sv.loc} pass the entries' 32-bit index")


_tables: dict = {}


def _table(sv, plan: Plan) -> torch.Tensor:
    """The plan as the entries read it (csrc/shard3d.cu's table), on the
    plan's device: a row of int64 a shard with its blocks' addresses (u, u1
    or 0, frozen), its centre's parity origin and each face's direct slot
    (-1: the own block). Kept per content, so a layout (halo regrow, u1
    allocated) is uploaded once."""
    slot = {idx: n for n, idx in enumerate(plan.slots)}
    rows = []
    for idx in plan.slots:
        faces = [slot[_neighbour(sv.mesh, idx, f)] if kind == DIRECT else -1
                 for f, kind in zip(FACES, plan.kinds[idx])]
        rows.append((sv.u_blocks[idx].data_ptr(),
                     0 if sv.u1_blocks is None else sv.u1_blocks[idx].data_ptr(),
                     sv.frozen_blocks[idx].data_ptr(), sv.par0(idx, 0), *faces))
    key = (str(plan.device), tuple(rows))
    table = _tables.get(key)
    if table is None:
        if len(_tables) >= 16:
            _tables.clear()
        table = _tables[key] = torch.tensor(rows, dtype=torch.int64).to(plan.device)
    return table


def _launch(entry: str, sv, plan: Plan, *args) -> None:
    dev = plan.device
    first = sv.u_blocks[plan.slots[0]]
    err = getattr(_build.load(), entry)(
        _table(sv, plan).data_ptr(), len(plan.slots), *sv.loc, *sv.halos(sv.halo), first.stride(0),
        first.stride(1), *args, _stream(dev), dev.index)
    _build.check(err, entry)
    launches[entry] += 1


def cycle(sv, plan: Plan, iteration, ns: int, *, t_off: int = 0, u1: bool = False) -> torch.Tensor:
    """``ns`` sweeps (any ``ns >= 1``) from ``iteration + t_off``
    (``iteration`` an int or a 0-d int32 tensor on the plan's device) on
    every shard's centre of a whole ``plan`` of the volume ``sv`` (a
    :class:`.sharded3d.ShardedVolume`), in place; with ``u1`` the centres
    after sweep 0 go to ``sv.u1_blocks``. Returns sweep 0's delta over the
    centres, a 0-d float32 tensor on the plan's device. On the CPU the plain
    version runs; on a card the kernel (one launch) or this raises."""
    if plan.device.type == "cpu":
        return plain_cycle3d(sv, plan, iteration, ns, t_off=t_off, u1=u1)
    _check_cycle(sv, plan, ns, u1)
    _check_blocks(sv, plan, u1)
    delta = torch.zeros((), dtype=torch.float32, device=plan.device)
    it = _iteration(iteration, plan.device)   # held until the launch is enqueued
    _launch("epic_resident3d_cycle", sv, plan, it.data_ptr(), int(t_off), ns, int(u1),
            delta.data_ptr())
    return delta


def solve(sv, plan: Plan, stagger: int, bound: int, iteration: torch.Tensor,
          delta: torch.Tensor, done: torch.Tensor) -> None:
    """``core.solve``'s protocol on every shard of a whole plan, resumed from
    ``iteration``, ``delta`` and ``done`` (0-d int32, float32 and int32
    tensors on the plan's device, updated in place) while not done and the
    iteration is below ``bound``: a check every ``stagger`` sweeps, exit
    right after a passing check with ``iteration + 1 >= max(D, H, W)``, the
    post-check-sweep state kept, in the centres. On the CPU the plain
    version runs; on a card the kernel (one launch) or this raises."""
    if plan.device.type == "cpu":
        return plain_solve3d(sv, plan, stagger, bound, iteration, delta, done)
    _check_solve(sv, plan, stagger)
    _check_blocks(sv, plan, False)
    dev = plan.device
    for t, dtype in ((iteration, torch.int32), (delta, torch.float32), (done, torch.int32)):
        if t.dtype != dtype or t.ndim != 0 or t.device != dev:
            raise ValueError(f"need 0-d {dtype} scalars on {dev}, got {t.dtype} on {t.device}")
    acc = torch.zeros(2, dtype=torch.int32, device=dev)
    eps = sv.epsilon.to(device=dev, dtype=torch.float32)
    _launch("epic_resident3d_solve", sv, plan, eps.data_ptr(), max(sv.shape),
            min(bound, 2**31 - 1 - stagger), stagger, acc.data_ptr(), iteration.data_ptr(),
            delta.data_ptr(), done.data_ptr())
