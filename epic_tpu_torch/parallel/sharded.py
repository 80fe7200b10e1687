"""The 2D grid on a device mesh: shards, K-deep halo exchange, per-shard chunks.

The counterpart of ``epic_tpu.parallel.sharded``. The grid is padded to a
multiple of the mesh (padding takes the obstacle value and is frozen) and
cut into ``h_loc x w_loc`` shards over a 2D ``("my", "mx")`` mesh. Each
shard lives on its device as a K-extended block (its centre with a halo of
``halo`` cells on every side) plus a twin of the same layout, with a frozen
mask of that layout (``locked | ring | padding``; halo cells outside the
mesh frozen). A chunk of ``ns <= K`` sweeps:

1. exchanges the K-deep halos of the blocks in place, in two phases: rows
   (the neighbours' K edge rows of the centre), then columns of the
   row-extended blocks, so the corners arrive through the second phase
   (``sharded.py:58-78``);
2. runs the per-shard chunk on each block (``hopper_shard2d.chunk``: the
   CUDA entry on a card, the plain version on the CPU), which reads the
   block and writes the twin's centre; then the two swap.

The first chunk of a call carries the staggered check's delta, the max over
the shards (on the mesh's first device; across processes an
``all_reduce(MAX)``). The frozen mask's halos are exchanged once per edit,
not per chunk. Depth: ``min(chunk_depth, h_loc, w_loc)``, and on a card no
deeper than the kernel's shared memory takes (``hopper_shard2d.max_depth``);
trajectories do not depend on it (the trapezoid makes each chunk exactly
``ns`` global sweeps), so neither do results.

Solves run stagger cycles with ``core.solve``'s protocol: the checked
chunk (depth ``min(K, stagger)``) also writes u1, the state after its first
sweep; the delta is read once an exit is possible (``iteration + 1 >=
max(H, W)``, the unpadded grid's) and u1 kept on exit; else the rest of the
cycle follows. The host runs that loop, except where the resident route
runs it in one launch.

Two routes run those chunks. The per-shard route (K14/K15) launches
``hopper_shard2d.chunk`` a shard a chunk after a full exchange. The
resident route (K16/K17, :mod:`.hopper_resident2d`) launches one program a
device for all of its shards: a tile reads a neighbour on the same device
straight from its block, and the host copies only the halos of neighbours
on other devices or processes; where one device holds the whole mesh, a
tick's chunks run in one launch and a solve's whole loop in one more.
Both give the same bits. ``kernel`` picks the route: "resident" (anywhere)
and "resident_interpret" (the CPU) the resident one; "pallas" and
"pallas_banded" (a card) and "xla", "pallas_interpret" and
"pallas_banded_interpret" (the CPU) the per-shard one; "auto" follows
:func:`prefers_resident`. Either route runs its CUDA entries on a card and
its plain versions on the CPU; a name that says otherwise raises.
``segment_iterations`` (a solve paused at stagger-aligned bounds,
``solver.tiled.segment_bounds``) needs the resident route, as in
``epic_tpu``.

In place, like the rest of the port: the resident verbs
(``update_n_resident``, ``solve_resident``, ``set_cells_resident``, ...)
change the ``ShardedGrid`` they are given and return it.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist

from .. import constants as C
from .. import grid as G
from ..grid import GridState
from ..solver.tiled import segment_bounds, spread
from . import hopper_resident2d, hopper_shard2d, multihost

# Sweeps per halo exchange (epic_tpu's DEFAULT_CHUNK_DEPTH).
DEFAULT_CHUNK_DEPTH = 16
# The fill of halo cells outside the mesh (and of fresh scratch blocks): the
# obstacle value, frozen. No updated cell reads it: the grid's frozen ring
# stands between.
FILL = float(C.LOG_SPACE_OBSTACLE)

# The names that hold only on a card (the per-shard route's CUDA entry) and
# only on the CPU (the plain versions); "auto" and "resident" run anywhere.
_CARD_NAMES = ("pallas", "pallas_banded")
_CPU_NAMES = ("xla", "pallas_interpret", "pallas_banded_interpret", "resident_interpret")
_RESIDENT = ("resident", "resident_interpret")
# The largest shard "auto" sends to the resident route: between the 8.4M
# cells where it measured faster on an H100 and the 18.9M where it measured
# slower (prefers_resident).
RESIDENT_MAX_SHARD_CELLS = 12_000_000


class Mesh:
    """A 2D ``("my", "mx")`` grid of shards, or with a leading ``"mz"`` axis
    a 3D one (:func:`make_mesh3d`, volumes only): ``devices[idx]`` holds
    shard ``idx`` and ``ranks[idx]`` is the process that owns it. ``shape``
    maps ``axis_names`` to extents. ``local`` lists this process's shards in
    row-major order; ``first_device`` is the first one's device, where the
    mesh's scalars and gathered arrays live."""

    def __init__(self, devices: np.ndarray, ranks: np.ndarray, rank: int = 0):
        if devices.ndim not in (2, 3) or ranks.shape != devices.shape:
            raise ValueError(f"need 2D or 3D devices and ranks of one shape, got {devices.shape} "
                             f"and {ranks.shape}")
        types = {d.type for d in devices.flat}
        if len(types) != 1:
            raise ValueError(f"a mesh lies on one device type, got {sorted(types)}")
        self.devices = devices
        self.ranks = ranks
        self.rank = rank
        self.axis_names = ("mz", "my", "mx")[3 - devices.ndim:]
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.device_type = types.pop()
        self.local = [idx for idx in np.ndindex(*devices.shape) if ranks[idx] == rank]
        if not self.local:
            raise ValueError(f"process {rank} owns no shard of this mesh")
        self.multi_process = bool((ranks != rank).any())

    @property
    def first_device(self) -> torch.device:
        return self.devices[self.local[0]]

    def _key(self):
        return (self.devices.shape, tuple(map(str, self.devices.flat)),
                tuple(self.ranks.flat), self.rank)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __repr__(self) -> str:
        return (f"Mesh({'x'.join(map(str, self.devices.shape))}, {self.device_type}, "
                f"local={len(self.local)})")


def local_devices(devices=None, what: str = "make_mesh") -> list[torch.device]:
    """This process's mesh devices: ``devices`` (a device may repeat), by
    default every visible CUDA device; without one this raises."""
    if devices is None:
        n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_cuda == 0:
            raise RuntimeError(f"{what}: no CUDA device is visible; a mesh on the CPU takes "
                               "devices=[torch.device('cpu')] * n")
        devices = [torch.device("cuda", i) for i in range(n_cuda)]
    local = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        local.append(d)
    if not local:
        raise ValueError(f"{what} needs at least one device")
    return local


def near_square(n: int) -> tuple[int, int]:
    """``(my, mx)`` with ``my * mx == n`` and ``my`` the largest divisor of
    ``n`` not above its square root."""
    my = int(np.floor(np.sqrt(n)))
    while n % my:
        my -= 1
    return my, n // my


def _global_mesh(shape, devices, default, what: str) -> Mesh:
    """The mesh of ``shape`` (``default(n)`` when None) over every process's
    ``devices``; each process owns a contiguous block of shards in
    row-major order, and shards of other processes are recorded with this
    process's layout."""
    local = local_devices(devices, what)
    world, rank = multihost.world()
    n = world * len(local)
    shape = default(n) if shape is None else tuple(shape)
    if int(np.prod(shape)) != n:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {int(np.prod(shape))} "
                         f"shards; {world} process(es) give {n}")
    devs = np.empty(n, dtype=object)
    for q in range(n):
        devs[q] = local[q % len(local)]
    ranks = np.arange(n) // len(local)
    return Mesh(devs.reshape(shape), ranks.reshape(shape), rank)


def make_mesh(shape: tuple[int, int] | None = None, devices=None) -> Mesh:
    """A 2D ("my", "mx") mesh; by default near-square. ``devices`` are this
    process's devices (a device may repeat: ``[cuda0] * 8`` is a virtual
    mesh of 8 shards on one card); by default every visible CUDA device, and
    without one this raises: a mesh on the CPU takes
    ``devices=[torch.device("cpu")] * n``. Across processes
    (:mod:`.multihost`) the mesh spans every process's devices, each
    process owning a contiguous block of shards in row-major order."""
    if shape is not None and len(shape) != 2:
        raise ValueError(f"make_mesh takes a 2D shape, got {shape}")
    return _global_mesh(shape, devices, near_square, "make_mesh")


def make_mesh3d(shape: tuple[int, int, int] | None = None, devices=None) -> Mesh:
    """A 3-axis ("mz", "my", "mx") mesh for volumes whose depth is cut too
    (``epic_tpu.parallel.sharded3d.make_mesh3d``); by default every shard on
    z. ``devices`` as in :func:`make_mesh`."""
    if shape is not None and len(shape) != 3:
        raise ValueError(f"make_mesh3d takes a 3D shape, got {shape}")
    return _global_mesh(shape, devices, lambda n: (n, 1, 1), "make_mesh3d")


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------


def padded_shape(shape: tuple[int, int], mesh: Mesh) -> tuple[int, int]:
    h, w = shape
    nmy, nmx = mesh.shape["my"], mesh.shape["mx"]
    return (-(-h // nmy) * nmy, -(-w // nmx) * nmx)


def _frozen_mask(state: GridState) -> torch.Tensor:
    """Cells no sweep updates: locked, and the grid's boundary ring."""
    frozen = state.locked.clone()
    frozen[0, :] = True
    frozen[-1, :] = True
    frozen[:, 0] = True
    frozen[:, -1] = True
    return frozen


def _pad_for_mesh(state: GridState, mesh: Mesh):
    """u and the frozen mask padded to a multiple of the mesh (padding: the
    obstacle value, frozen), on the state's device."""
    h, w = state.u.shape
    hp, wp = padded_shape((h, w), mesh)
    u = torch.full((hp, wp), FILL, dtype=torch.float32, device=state.u.device)
    u[:h, :w] = state.u
    frozen = torch.ones((hp, wp), dtype=torch.bool, device=state.u.device)
    frozen[:h, :w] = _frozen_mask(state)
    return u, frozen


class ShardedGrid:
    """A grid resident on a mesh: per local shard (i, j), ``u_blocks``,
    ``twin_blocks`` (and, once a solve asks, ``u1_blocks``) are f32 blocks
    of ``(h_loc + 2 halo) x (w_loc + 2 halo)`` cells, the centre at
    ``[halo:halo + h_loc, halo:halo + w_loc]``, and ``frozen_blocks`` their
    bool frozen masks. ``frozen_halo`` is the depth to which the frozen
    halos are exchanged (0 after an edit). The scalars are 0-d tensors on
    the mesh's first device. ``u`` and ``frozen`` gather the padded
    ``[Hp, Wp]`` arrays there."""

    def __init__(self, mesh: Mesh, height: int, width: int, halo: int, u_blocks: dict,
                 twin_blocks: dict, frozen_blocks: dict, iteration: torch.Tensor,
                 delta: torch.Tensor, epsilon: torch.Tensor):
        self.mesh = mesh
        self.height, self.width = height, width
        self.halo = halo
        self.u_blocks, self.twin_blocks, self.frozen_blocks = u_blocks, twin_blocks, frozen_blocks
        self.u1_blocks: dict | None = None
        self.frozen_halo = 0
        self.iteration, self.delta, self.epsilon = iteration, delta, epsilon
        hp, wp = padded_shape((height, width), mesh)
        self.h_loc, self.w_loc = hp // mesh.shape["my"], wp // mesh.shape["mx"]

    def par0(self, ij) -> int:
        """(row + column) & 1 of the shard's extended block origin in global
        coordinates, for any halo depth (the -2k it adds is even)."""
        i, j = ij
        return (i * self.h_loc + j * self.w_loc) & 1

    def centre(self, blocks: dict, ij) -> torch.Tensor:
        H = self.halo
        return blocks[ij][H:H + self.h_loc, H:H + self.w_loc]

    @property
    def u(self) -> torch.Tensor:
        return _gather(self, self.u_blocks)

    @property
    def frozen(self) -> torch.Tensor:
        return _gather(self, self.frozen_blocks)


def _blank(mesh: Mesh, shape, fill, dtype) -> dict:
    return {ij: torch.full(shape, fill, dtype=dtype, device=mesh.devices[ij]) for ij in mesh.local}


def shard_state(state: GridState, mesh: Mesh, halo: int | None = None) -> ShardedGrid:
    """Pad a 2D GridState and place its shards on the mesh once, with a
    halo of ``halo`` cells (by default ``min(DEFAULT_CHUNK_DEPTH, h_loc,
    w_loc)``; a deeper chunk later regrows it); later ticks and edits keep
    the blocks resident."""
    if state.u.ndim != 2 or "mz" in mesh.shape:
        raise ValueError(f"the 2D mesh takes a 2D grid, got a {state.u.ndim}D state on {mesh}")
    h, w = state.u.shape
    hp, wp = padded_shape((h, w), mesh)
    h_loc, w_loc = hp // mesh.shape["my"], wp // mesh.shape["mx"]
    H = min(DEFAULT_CHUNK_DEPTH, h_loc, w_loc) if halo is None else halo
    if H < 1:
        raise ValueError(f"the halo must be at least 1 cell, got {H}")
    u_pad, f_pad = _pad_for_mesh(state, mesh)
    ext = (h_loc + 2 * H, w_loc + 2 * H)
    u_blocks = _blank(mesh, ext, FILL, torch.float32)
    frozen_blocks = _blank(mesh, ext, True, torch.bool)
    for (i, j) in mesh.local:
        rows, cols = slice(i * h_loc, (i + 1) * h_loc), slice(j * w_loc, (j + 1) * w_loc)
        u_blocks[i, j][H:H + h_loc, H:H + w_loc] = u_pad[rows, cols]
        frozen_blocks[i, j][H:H + h_loc, H:H + w_loc] = f_pad[rows, cols]
    del u_pad, f_pad
    first = mesh.first_device
    return ShardedGrid(
        mesh, h, w, H, u_blocks, _blank(mesh, ext, FILL, torch.float32), frozen_blocks,
        iteration=state.iteration.to(device=first, dtype=torch.int32),
        delta=state.delta.to(device=first, dtype=torch.float32),
        epsilon=state.epsilon.to(device=first, dtype=torch.float32))


def _regrow(sh: ShardedGrid, halo: int) -> None:
    """Re-lay the blocks with a deeper halo (the centres kept)."""
    H, h, w = halo, sh.h_loc, sh.w_loc
    ext = (h + 2 * H, w + 2 * H)
    u_blocks = _blank(sh.mesh, ext, FILL, torch.float32)
    frozen_blocks = _blank(sh.mesh, ext, True, torch.bool)
    for ij in sh.mesh.local:
        u_blocks[ij][H:H + h, H:H + w] = sh.centre(sh.u_blocks, ij)
        frozen_blocks[ij][H:H + h, H:H + w] = sh.centre(sh.frozen_blocks, ij)
    sh.u_blocks, sh.frozen_blocks = u_blocks, frozen_blocks
    sh.twin_blocks = _blank(sh.mesh, ext, FILL, torch.float32)
    sh.u1_blocks = None
    sh.halo = H
    sh.frozen_halo = 0


def _gather(sh: ShardedGrid, blocks: dict) -> torch.Tensor:
    """The shards' centres as one padded ``[Hp, Wp]`` tensor on the mesh's
    first device; across processes every process gathers all of them."""
    mesh = sh.mesh
    first = mesh.first_device
    nmy, nmx = mesh.shape["my"], mesh.shape["mx"]
    if mesh.multi_process:
        local = torch.stack([sh.centre(blocks, ij).to(first) for ij in mesh.local])
        dtype = local.dtype
        if dtype == torch.bool:
            local = local.to(torch.uint8)
        parts = [torch.empty_like(local) for _ in range(int(mesh.ranks.max()) + 1)]
        dist.all_gather(parts, local.contiguous())
        centres = list(torch.cat(parts).to(dtype))
    else:
        centres = [sh.centre(blocks, (i, j)).to(first) for i in range(nmy) for j in range(nmx)]
    return torch.cat([torch.cat(centres[i * nmx:(i + 1) * nmx], dim=1) for i in range(nmy)])


def unshard(sh: ShardedGrid) -> GridState:
    """Gather back to a GridState on the mesh's first device. The boundary
    ring comes back locked (the shards fold ``locked | ring`` into one
    mask; the service plane forces the ring to walls anyway)."""
    h, w = sh.height, sh.width
    return GridState(
        u=sh.u[:h, :w].contiguous(),
        locked=sh.frozen[:h, :w].contiguous(),
        iteration=sh.iteration,
        delta=sh.delta,
        converged=torch.zeros((), dtype=torch.bool, device=sh.mesh.first_device),
        epsilon=sh.epsilon,
    )


# ---------------------------------------------------------------------------
# Halo exchange
# ---------------------------------------------------------------------------


def _transfers(mesh: Mesh, h: int, w: int, H: int, k: int):
    """The exchange at depth k as two phases of ``(src shard, src index, dst
    shard, dst index)``: rows (each shard's north and south halo from the
    neighbours' edge rows of the centre), then columns of the row-extended
    blocks (west and east halos, the corners included)."""
    nmy, nmx = mesh.shape["my"], mesh.shape["mx"]
    cc = slice(H, H + w)
    rr = slice(H - k, H + h + k)
    rows, cols = [], []
    for i in range(nmy):
        for j in range(nmx):
            if i > 0:
                rows.append(((i - 1, j), (slice(H + h - k, H + h), cc), (i, j), (slice(H - k, H), cc)))
            if i < nmy - 1:
                rows.append(((i + 1, j), (slice(H, H + k), cc), (i, j), (slice(H + h, H + h + k), cc)))
            if j > 0:
                cols.append(((i, j - 1), (rr, slice(H + w - k, H + w)), (i, j), (rr, slice(H - k, H))))
            if j < nmx - 1:
                cols.append(((i, j + 1), (rr, slice(H, H + k)), (i, j), (rr, slice(H + w, H + w + k))))
    return rows, cols


def _run_phase(mesh: Mesh, blocks: dict, transfers) -> None:
    """Copy each transfer; between processes as point-to-point sends, both
    sides listing the transfers in the same order."""
    ops, recvs = [], []
    for tag, (s, s_idx, d, d_idx) in enumerate(transfers):
        s_here, d_here = mesh.ranks[s] == mesh.rank, mesh.ranks[d] == mesh.rank
        if s_here and d_here:
            blocks[d][d_idx].copy_(blocks[s][s_idx])
        elif s_here:
            ops.append(dist.P2POp(dist.isend, blocks[s][s_idx].contiguous(), int(mesh.ranks[d]),
                                  tag=tag))
        elif d_here:
            buf = torch.empty_like(blocks[d][d_idx], memory_format=torch.contiguous_format)
            ops.append(dist.P2POp(dist.irecv, buf, int(mesh.ranks[s]), tag=tag))
            recvs.append((d, d_idx, buf))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for d, d_idx, buf in recvs:
        blocks[d][d_idx].copy_(buf)


def _exchange(sh: ShardedGrid, blocks: dict, k: int) -> None:
    """Fill the K-deep halos of ``blocks`` (u or frozen) from the
    neighbouring shards, in place; halos outside the mesh keep their fill."""
    for phase in _transfers(sh.mesh, sh.h_loc, sh.w_loc, sh.halo, k):
        _run_phase(sh.mesh, blocks, phase)


def _frozen_halos(sh: ShardedGrid, k: int) -> None:
    if sh.frozen_halo < k:
        _exchange(sh, sh.frozen_blocks, k)
        sh.frozen_halo = k


# ---------------------------------------------------------------------------
# Per-shard chunks
# ---------------------------------------------------------------------------


def check_kernel(kernel: str, mesh: Mesh) -> None:
    """Refuse a kernel name this mesh does not run: each route follows the
    device (the CUDA entries on a card, the plain versions on the CPU), and
    a name only picks the route and confirms the device."""
    on_card = mesh.device_type == "cuda"
    if kernel in _CARD_NAMES and not on_card:
        raise ValueError(f"kernel={kernel!r} runs the CUDA entry; this mesh lies on "
                         f"{mesh.device_type} (use 'auto')")
    if kernel in _CPU_NAMES and on_card:
        raise ValueError(f"kernel={kernel!r} names the plain version; this mesh lies on "
                         "cuda (use 'auto')")
    if kernel not in ("auto", "resident") + _CARD_NAMES + _CPU_NAMES:
        raise ValueError(f"unknown sharded kernel {kernel!r}")


def prefers_resident(mesh: Mesh, h_loc: int, w_loc: int) -> bool:
    """The route "auto" takes for ``h_loc x w_loc`` shards on ``mesh``: the
    resident one where one device holds the whole mesh and a shard has at
    most ``RESIDENT_MAX_SHARD_CELLS`` cells, else the per-shard one. On an
    H100 (``tile_probe --mesh2d``, PERF.md) the resident tick of a 2 x 4
    virtual mesh takes 0.13-0.91 of the per-shard tick's time up to shards
    of 4096 x 2048, where the host's launches weigh, and 1.07-1.12 from
    6144 x 3072, where the tile pass sets the pace. Across devices
    each device's launch carries one chunk on either route, so the resident
    route saves no launch where a device holds one shard; it is not
    measured there."""
    one_device = len({str(d) for d in mesh.devices.flat}) == 1 and not mesh.multi_process
    return one_device and h_loc * w_loc <= RESIDENT_MAX_SHARD_CELLS


def _resident(sh: ShardedGrid, kernel: str) -> bool:
    """Whether ``kernel`` sends this grid to the resident route."""
    check_kernel(kernel, sh.mesh)
    if kernel == "auto":
        return prefers_resident(sh.mesh, sh.h_loc, sh.w_loc)
    return kernel in _RESIDENT


def _depth(mesh: Mesh, h_loc: int, w_loc: int, chunk_depth: int) -> int:
    """The exchange depth: ``min(chunk_depth, h_loc, w_loc)``, and on a card
    no deeper than the kernel takes."""
    if chunk_depth < 1:
        raise ValueError(f"chunk_depth must be >= 1, got {chunk_depth}")
    k = min(chunk_depth, h_loc, w_loc)
    if mesh.device_type == "cuda":
        k = min(k, hopper_shard2d.max_depth(mesh.first_device))
    return k


def _on_devices(sh: ShardedGrid, t: torch.Tensor) -> dict:
    return {dev: t.to(dev) for dev in {sh.mesh.devices[ij] for ij in sh.mesh.local}}


def _pmax(mesh: Mesh, deltas: list) -> torch.Tensor:
    """The max of the shards' deltas, on the mesh's first device (across
    processes all-reduced)."""
    first = mesh.first_device
    d = torch.stack([x.to(first) for x in deltas]).amax()
    if mesh.multi_process:
        d = d.reshape(1)
        dist.all_reduce(d, op=dist.ReduceOp.MAX)
        d = d[0]
    return d


def _chunk(sh: ShardedGrid, k: int, its: dict, t_off: int, ns: int, *, delta: bool = False,
           u1: bool = False):
    """One exchange and ``ns`` sweeps on every local shard from iteration
    ``its[device] + t_off``: the blocks' centres go to the twins (and after
    sweep 0 to the u1 blocks), then blocks and twins swap. Returns the pmax
    of sweep 0's delta when ``delta``."""
    _exchange(sh, sh.u_blocks, k)
    H = sh.halo
    view = (slice(H - k, H + sh.h_loc + k), slice(H - k, H + sh.w_loc + k))
    deltas = []
    for ij in sh.mesh.local:
        deltas.append(hopper_shard2d.chunk(
            sh.u_blocks[ij][view], sh.twin_blocks[ij][view], sh.frozen_blocks[ij][view], k=k,
            par0=sh.par0(ij), iteration=its[sh.mesh.devices[ij]], ns=ns, t_off=t_off,
            u1=sh.u1_blocks[ij][view] if u1 else None, want_delta=delta))
    _swap(sh)
    return _pmax(sh.mesh, deltas) if delta else None


def _swap(sh: ShardedGrid) -> None:
    sh.u_blocks, sh.twin_blocks = sh.twin_blocks, sh.u_blocks


def _resident_chunk(sh: ShardedGrid, plans: list, transfers: list, k: int, its: dict, t_off: int,
                    ns: int, *, delta: bool = False, u1: bool = False):
    """One chunk of the resident route on a mesh whose plans copy halos:
    the host's copies, one launch a device, the swap. Returns the pmax of
    sweep 0's delta when ``delta``."""
    _run_phase(sh.mesh, sh.u_blocks, transfers)
    deltas = [hopper_resident2d.cycle(sh, p, k, its[p.device], ns, 1, t_off=t_off, u1=u1)[0]
              for p in plans]
    _swap(sh)
    return _pmax(sh.mesh, deltas) if delta else None


def _resident_plans(sh: ShardedGrid, k: int):
    """The mesh's plans, the host's copies at depth k, and whether one plan
    covers the whole mesh."""
    plans = hopper_resident2d.plans(sh.mesh)
    transfers = hopper_resident2d.copied_transfers(sh.mesh, plans, sh.h_loc, sh.w_loc, sh.halo, k)
    return plans, transfers, len(plans) == 1 and plans[0].whole


def _update_resident(sh: ShardedGrid, k: int, num_steps: int) -> torch.Tensor:
    """``num_steps`` sweeps on the resident route, spread over ceil(num_steps
    / K) chunks: one launch where one plan covers the mesh, else a chunk at
    a time. Returns the first sweep's delta (pmax)."""
    plans, transfers, whole = _resident_plans(sh, k)
    its = _on_devices(sh, sh.iteration)
    n_chunks = -(-num_steps // k)
    if whole:
        deltas = hopper_resident2d.cycle(sh, plans[0], k, its[plans[0].device], num_steps,
                                         n_chunks)
        if n_chunks % 2:
            _swap(sh)
        return deltas[0]
    delta, t = None, 0
    for ns in spread(num_steps, n_chunks):
        d = _resident_chunk(sh, plans, transfers, k, its, t, ns, delta=delta is None)
        delta = d if delta is None else delta
        t += ns
    return delta


def _prepare(sh: ShardedGrid, chunk_depth: int) -> int:
    """The depth of a call; regrow the halo and exchange the frozen halos as
    needed."""
    k = _depth(sh.mesh, sh.h_loc, sh.w_loc, chunk_depth)
    if k > sh.halo:
        _regrow(sh, k)
    _frozen_halos(sh, k)
    return k


def _update_n_sharded(sh: ShardedGrid, num_steps: int, chunk_depth: int = DEFAULT_CHUNK_DEPTH,
                      kernel: str = "auto") -> torch.Tensor:
    """``num_steps`` sweeps from ``sh.iteration``: on the resident route
    (:func:`_update_resident`), or on the per-shard route as ceil(num_steps
    / K) exchange rounds (the first ``min(K, num_steps)`` deep, then full
    chunks, then the remainder); returns the first sweep's delta (pmax)."""
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    resident = _resident(sh, kernel)
    k = _prepare(sh, chunk_depth)
    if resident:
        return _update_resident(sh, k, num_steps)
    its = _on_devices(sh, sh.iteration)
    d1 = min(k, num_steps)
    delta = _chunk(sh, k, its, 0, d1, delta=True)
    t = d1
    while t < num_steps:
        ns = min(k, num_steps - t)
        _chunk(sh, k, its, t, ns)
        t += ns
    return delta


def _check_mesh(sh: ShardedGrid, mesh: Mesh | None) -> None:
    if mesh is not None and mesh != sh.mesh:
        raise ValueError(f"the grid lives on {sh.mesh}, not {mesh}")


# ---------------------------------------------------------------------------
# The resident verbs
# ---------------------------------------------------------------------------


def update_n_resident(sh: ShardedGrid, num_steps: int, mesh: Mesh | None = None,
                      chunk_depth: int = DEFAULT_CHUNK_DEPTH, kernel: str = "auto") -> ShardedGrid:
    """Anytime chunk on a mesh-resident grid, in place: no re-pad, no
    re-upload; returns ``sh``, relaxed, its iteration advanced and its delta
    the first sweep's."""
    _check_mesh(sh, mesh)
    delta = _update_n_sharded(sh, num_steps, chunk_depth, kernel)
    sh.iteration = sh.iteration + num_steps
    sh.delta = delta
    return sh


def solve_resident(sh: ShardedGrid, mesh: Mesh | None = None, stagger: int = C.DEFAULT_STAGGER,
                   max_iterations: int = 1_000_000, chunk_depth: int = DEFAULT_CHUNK_DEPTH,
                   kernel: str = "auto", segment_iterations: int | None = None):
    """Solve to convergence on the resident blocks, in place, with the
    protocol of ``core.solve`` (iteration reset to 0, a check every
    ``stagger`` sweeps, exit only right after a passing check with
    ``iteration >= max(H, W)``, the post-check-sweep state kept), paused at
    the bounds of ``segment_iterations`` (the resident route only). Where
    one plan covers the mesh, the resident route runs each segment in one
    launch. Returns ``(sh, converged)``."""
    _check_mesh(sh, mesh)
    if stagger < 1:
        raise ValueError(f"stagger must be >= 1, got {stagger}")
    resident = _resident(sh, kernel)
    if segment_iterations is not None and not resident:
        raise ValueError("segment_iterations needs the resident route (kernel='resident', or "
                         "'auto' where it picks that route)")
    bounds = ([max_iterations] if segment_iterations is None
              else segment_bounds(stagger, max_iterations, segment_iterations))
    k = _prepare(sh, chunk_depth)
    if sh.u1_blocks is None:
        sh.u1_blocks = _blank(sh.mesh, sh.u_blocks[sh.mesh.local[0]].shape, FILL, torch.float32)
    first = sh.mesh.first_device
    zero = _on_devices(sh, torch.zeros((), dtype=torch.int32, device=first))
    if not resident:
        chunk = functools.partial(_chunk, sh, k, zero)
    else:
        plans, transfers, whole = _resident_plans(sh, k)
        if whole:
            return _solve_whole(sh, plans[0], k, stagger, bounds)
        chunk = functools.partial(_resident_chunk, sh, plans, transfers, k, zero)
    m_max = max(sh.height, sh.width)
    depth = min(k, stagger)
    it, delta, done = 0, sh.epsilon + 1.0, False
    for bound in bounds:
        while not done and it < bound:
            delta = chunk(it, depth, delta=True, u1=True)
            if it + 1 >= m_max and bool(delta < sh.epsilon):
                sh.u_blocks, sh.u1_blocks = sh.u1_blocks, sh.u_blocks
                it, done = it + 1, True
                break
            t = it + depth
            while t < it + stagger:
                ns = min(k, it + stagger - t)
                chunk(t, ns)
                t += ns
            it += stagger
        if done:
            break
    sh.iteration = torch.tensor(it, dtype=torch.int32, device=first)
    sh.delta = delta
    return sh, torch.tensor(done, dtype=torch.bool, device=first)


def _solve_whole(sh: ShardedGrid, plan, k: int, stagger: int, bounds: list):
    """The resident solve where one plan covers the mesh: the solve entry
    once a segment, each resuming where the last stopped; the verdict read
    between segments."""
    dev = plan.device
    it = torch.zeros((), dtype=torch.int32, device=dev)
    delta = (sh.epsilon + 1.0).to(device=dev, dtype=torch.float32)
    done = torch.zeros((), dtype=torch.int32, device=dev)
    for bound in bounds:
        hopper_resident2d.solve(sh, plan, k, stagger, bound, it, delta, done)
        if len(bounds) > 1 and bool(done):
            break
    sh.iteration, sh.delta = it, delta
    return sh, done != 0


def set_cells_resident(sh: ShardedGrid, xy, types) -> ShardedGrid:
    """SetCells on the resident blocks, in place (``grid.set_cells``'s
    preprocessing: invalid entries skipped, duplicates last-wins): each
    owning shard takes its writes, nothing is re-laid-out. Values on the
    boundary ring are written, but ring cells stay frozen: no sweep updates
    them (the reference loops x = 1..m-2, harmonic_cpu.cpp:46-51), and an
    unfrozen ring cell would read out-of-mesh fill."""
    xy, u_vals, locked_vals = G.sanitize_cell_edits(xy, types, sh.width, sh.height)
    if xy.shape[0] == 0:
        return sh
    xs, ys = xy[:, 0], xy[:, 1]
    on_ring = (xs == 0) | (xs == sh.width - 1) | (ys == 0) | (ys == sh.height - 1)
    f_vals = locked_vals | on_ring
    si, sj = ys // sh.h_loc, xs // sh.w_loc
    H = sh.halo
    for (i, j) in sh.mesh.local:
        m = (si == i) & (sj == j)
        if not m.any():
            continue
        dev = sh.mesh.devices[i, j]
        idx = (torch.as_tensor(H + ys[m] - i * sh.h_loc, device=dev),
               torch.as_tensor(H + xs[m] - j * sh.w_loc, device=dev))
        sh.u_blocks[i, j][idx] = torch.as_tensor(u_vals[m], device=dev)
        sh.frozen_blocks[i, j][idx] = torch.as_tensor(f_vals[m], device=dev)
    sh.frozen_halo = 0
    return sh


def reset_free_cells_resident(sh: ShardedGrid) -> ShardedGrid:
    """srvResetFreeCells on the resident blocks, in place, as
    ``grid.reset_free_cells``: every unfrozen cell back to the FREE value,
    the iteration to 0, the delta to ``epsilon + 1``."""
    for ij in sh.mesh.local:
        sh.centre(sh.u_blocks, ij).masked_fill_(~sh.centre(sh.frozen_blocks, ij),
                                                float(C.LOG_SPACE_FREE))
    sh.iteration = torch.zeros((), dtype=torch.int32, device=sh.mesh.first_device)
    sh.delta = sh.epsilon + 1.0
    return sh


def occupancy_resident(sh: ShardedGrid, data: np.ndarray) -> bool:
    """An occupancy grid (``Planner.update_occupancy``'s rule) applied to
    the resident blocks, in place and on the devices: interior cells whose
    value is not OCCUPANCY_NO_CHANGE, and that are not goals, become
    OBSTACLE (value >= OCCUPANCY_OBSTACLE_THRESHOLD) or FREE. Returns
    whether any cell changed (across processes, anywhere)."""
    data = np.asarray(data)
    h, w = sh.height, sh.width
    if data.shape != (h, w):
        raise ValueError(f"occupancy of shape {data.shape} for a {h}x{w} grid")
    H, hl, wl = sh.halo, sh.h_loc, sh.w_loc
    changed = torch.zeros((), dtype=torch.bool, device=sh.mesh.first_device)
    for (i, j) in sh.mesh.local:
        dev = sh.mesh.devices[i, j]
        block = np.full((hl, wl), C.OCCUPANCY_NO_CHANGE, dtype=np.int16)
        y0, x0 = i * hl, j * wl
        y1, x1 = min(y0 + hl, h - 1), min(x0 + wl, w - 1)   # the ring never changes
        y0c, x0c = max(y0, 1), max(x0, 1)
        if y1 > y0c and x1 > x0c:
            block[y0c - y0:y1 - y0, x0c - x0:x1 - x0] = data[y0c:y1, x0c:x1]
        d = torch.from_numpy(block).to(dev)
        u, f = sh.centre(sh.u_blocks, (i, j)), sh.centre(sh.frozen_blocks, (i, j))
        goal = f & (u == float(C.LOG_SPACE_GOAL))
        change = (d != C.OCCUPANCY_NO_CHANGE) & ~goal
        obstacle = change & (d >= C.OCCUPANCY_OBSTACLE_THRESHOLD)
        # OBSTACLE and FREE both hold -1e6; locked for obstacles only.
        u.masked_fill_(change, float(C.LOG_SPACE_OBSTACLE))
        f.copy_((f & ~change) | obstacle)
        changed |= change.any().to(changed.device)
    sh.frozen_halo = 0
    if sh.mesh.multi_process:
        flag = changed.to(torch.int32).reshape(1)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        changed = flag[0] > 0
    return bool(changed)


def read_cell(sh: ShardedGrid, x: int, y: int) -> tuple[bool, float] | None:
    """(frozen, u) of one cell from its shard: a 5-byte read. None when the
    shard belongs to another process."""
    i, j = y // sh.h_loc, x // sh.w_loc
    if sh.mesh.ranks[i, j] != sh.mesh.rank:
        return None
    H = sh.halo
    r, c = H + y - i * sh.h_loc, H + x - j * sh.w_loc
    return bool(sh.frozen_blocks[i, j][r, c]), float(sh.u_blocks[i, j][r, c])


# ---------------------------------------------------------------------------
# GridState entry points
# ---------------------------------------------------------------------------


def halo_for(shape: tuple[int, int], mesh: Mesh, chunk_depth: int) -> int:
    """The halo a grid of ``shape`` gets on ``mesh`` for chunks of
    ``chunk_depth`` sweeps."""
    hp, wp = padded_shape(shape, mesh)
    return _depth(mesh, hp // mesh.shape["my"], wp // mesh.shape["mx"], chunk_depth)


def _result(state: GridState, sh: ShardedGrid, **fields) -> GridState:
    """``state`` with the mesh's relaxed field cut back to ``h x w``, all on
    the mesh's first device."""
    h, w = state.u.shape
    first = sh.mesh.first_device
    return dataclasses.replace(state, u=sh.u[:h, :w].contiguous(), locked=state.locked.to(first),
                               epsilon=state.epsilon.to(first), **fields)


def update_n(state: GridState, num_steps: int, mesh: Mesh,
             chunk_depth: int = DEFAULT_CHUNK_DEPTH, kernel: str = "auto") -> GridState:
    """``core.update_n``'s semantics on a mesh: ``num_steps`` sweeps, delta
    from the first, ``converged`` only for a single sweep. Returns a
    GridState on the mesh's first device."""
    check_kernel(kernel, mesh)
    sh = shard_state(state, mesh, halo_for(tuple(state.u.shape), mesh, chunk_depth))
    update_n_resident(sh, num_steps, mesh, chunk_depth, kernel)
    converged = ((sh.delta < sh.epsilon) if num_steps == 1
                 else torch.zeros((), dtype=torch.bool, device=mesh.first_device))
    return _result(state, sh, iteration=sh.iteration, delta=sh.delta, converged=converged)


def solve(state: GridState, mesh: Mesh, stagger: int = C.DEFAULT_STAGGER,
          max_iterations: int = 1_000_000, chunk_depth: int = DEFAULT_CHUNK_DEPTH,
          kernel: str = "auto", segment_iterations: int | None = None) -> GridState:
    """``core.solve`` on a mesh (the protocol of :func:`solve_resident`, in
    segments with ``segment_iterations``). Returns a GridState on the
    mesh's first device."""
    check_kernel(kernel, mesh)
    sh = shard_state(state, mesh, halo_for(tuple(state.u.shape), mesh, chunk_depth))
    sh, converged = solve_resident(sh, mesh, stagger, max_iterations, chunk_depth, kernel,
                                   segment_iterations)
    return _result(state, sh, iteration=sh.iteration, delta=sh.delta, converged=converged)
