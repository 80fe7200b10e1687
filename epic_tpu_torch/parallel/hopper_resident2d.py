"""The 2D resident mesh route: every shard of a device in one launch.

The counterpart of ``epic_tpu.parallel.resident`` (``_resident_kernel``,
K16: a shard kept in a 128-lane guard layout, DMA row bands, src to an
aliased dst) and ``resident_tiled`` (K6's body through ``_chunk_cycle``,
K17, on the tiled guard layout), with the solve loop that runs them inside
``shard_map``. Both kernels compute one chunk of ``ns <= K`` guarded lse4
sweeps of a shard, exact on its centre, with sweep 0's delta: the function
of K14/K15 (:mod:`.hopper_shard2d`). In the port a shard already stays
resident as its K-extended block (:mod:`.sharded`), so what this route adds
is the rest of the TPU's: all of a device's shards in one program, and the
solve's loop inside it. Two CUDA entries in ``csrc/tile2d.cu`` carry it, on
the grid tiles' tile pass: ``epic_resident2d_cycle`` (chunks in one
cooperative launch over every (shard, tile) pair, a grid barrier between
chunks) and ``epic_resident2d_solve`` (the stagger protocol in one launch,
resumable from ``(iteration, delta, done)`` up to a bound).

The plan (:func:`plans`) is a pure function of the mesh: for each device of
this process, its local shards and, for each, the kind of each of its
eight neighbours: ``DIRECT`` (the same device and process: the tile reads
that neighbour's current centre, no copy), ``COPIED`` (another device or
process: the host copies its halo strip into the shard's own halo before
each launch, :func:`copied_transfers`) or ``OUTSIDE`` (the mesh's edge: the
own halo holds the fill, frozen). Frozen bytes always come from the own
block; their halos are exchanged once per edit. A plan without a copied
neighbour covers the whole mesh: only then may a launch run more than one
chunk, and only then does the solve entry run.

The sets. Chunk ``c`` of every shard reads set ``c & 1`` (``u_blocks`` at
``c = 0``, then ``twin_blocks``) and writes the other; the host swaps the
two dicts once after an odd count. A direct neighbour's halo in the own
block is not refreshed: :func:`.sharded._chunk` (K14/K15) exchanges every
halo before it reads one, and the gather, ``read_cell`` and the edits read
centres only.

The delta is taken over the shards' centres. Each chunk starts from the
neighbours' current values, so a halo cell repeats its owner's sweep-0
update: the max over the mesh's shards equals the block delta's (K14/K15)
and K16/K17's interior delta's. Only that max is held to the reference.

:func:`plain_cycle` and :func:`plain_solve` are the plain torch versions:
the same reads (direct regions from the neighbours' blocks, the rest from
the own block) and ``hopper_shard2d.sweep_k_local`` on each shard. The
wrappers :func:`cycle` and :func:`solve` send a plan on the CPU to them and
a plan on a card to the kernels, or raise. ``launches`` counts the kernels'
launches and ``calls`` the plain versions' calls; nothing else changes them.
"""

from __future__ import annotations

import dataclasses

import torch

from ..solver import _build, hopper_tile2d
from ..solver.hopper_sweep import _iteration, _stream
from ..solver.tiled import spread
from . import hopper_shard2d

DIRECT, COPIED, OUTSIDE = "direct", "copied", "outside"
# The nine regions of a shard's view as (di, dj) offsets on the mesh: rows
# above, within and below the centre x columns left, within and right,
# row-major; (0, 0), region 4, is the centre. csrc/tile2d.cu's plan uses
# this order.
REGIONS = tuple((di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1))
NEIGHBOURS = tuple(d for d in REGIONS if d != (0, 0))

# The static shared memory of csrc/tile2d.cu's Regions (nine pointers and
# nine int64 shifts), beside a tile's dynamic shared memory.
REGIONS_SMEM = 144

launches = {"epic_resident2d_cycle": 0, "epic_resident2d_solve": 0}
calls = {"cycle": 0, "solve": 0}


@dataclasses.dataclass
class Plan:
    """One device's share of the route: ``slots``, its local shards in
    row-major order, and ``kinds[ij][(di, dj)]``, the kind of each of shard
    ``ij``'s eight neighbours."""

    device: torch.device
    slots: list
    kinds: dict

    @property
    def whole(self) -> bool:
        """No neighbour is copied: the plan covers the whole mesh."""
        return all(k != COPIED for nb in self.kinds.values() for k in nb.values())


def _kind(mesh, ij, d) -> str:
    """The kind of the neighbour of local shard ``ij`` at mesh offset ``d``."""
    s = (ij[0] + d[0], ij[1] + d[1])
    if not (0 <= s[0] < mesh.shape["my"] and 0 <= s[1] < mesh.shape["mx"]):
        return OUTSIDE
    return DIRECT if mesh.ranks[s] == mesh.rank and mesh.devices[s] == mesh.devices[ij] else COPIED


def plans(mesh) -> list[Plan]:
    """The plan of each of this process's devices, in the order of their
    first local shard."""
    out: dict = {}
    for ij in mesh.local:
        plan = out.setdefault(str(mesh.devices[ij]), Plan(mesh.devices[ij], [], {}))
        plan.slots.append(ij)
        plan.kinds[ij] = {d: _kind(mesh, ij, d) for d in NEIGHBOURS}
    return list(out.values())


def _halo(n: int, H: int, k: int, d: int) -> slice:
    """Along one axis of a block (centre ``n`` cells at ``H``): the k-deep
    halo on side ``d`` (-1, +1), or the centre (0)."""
    return slice(H - k, H) if d < 0 else slice(H + n, H + n + k) if d > 0 else slice(H, H + n)


def _edge(n: int, H: int, k: int, d: int) -> slice:
    """Along one axis: the part of the neighbour on side ``d`` whose cells
    the halo of :func:`_halo` holds (its last k cells for -1, its first k
    for +1, its centre for 0)."""
    return slice(H + n - k, H + n) if d < 0 else slice(H, H + k) if d > 0 else slice(H, H + n)


def copied_transfers(mesh, plans_: list[Plan], h: int, w: int, H: int, k: int) -> list:
    """The host's copies before a launch, as ``(src shard, src index, dst
    shard, dst index)`` for :func:`.sharded._run_phase`: each copied
    neighbour's k-deep strip (corners from the diagonal neighbour itself)
    into the own halo. The mesh's transfers between processes come first, in
    one order on every process (their tags must agree), then this process's
    copies between its devices, from ``plans_``."""
    nmy, nmx = mesh.shape["my"], mesh.shape["mx"]
    between, within = [], []
    for i in range(nmy):
        for j in range(nmx):
            for di, dj in NEIGHBOURS:
                s = (i + di, j + dj)
                if 0 <= s[0] < nmy and 0 <= s[1] < nmx and mesh.ranks[s] != mesh.ranks[i, j]:
                    between.append((s, (_edge(h, H, k, di), _edge(w, H, k, dj)), (i, j),
                                    (_halo(h, H, k, di), _halo(w, H, k, dj))))
    for plan in plans_:
        for ij in plan.slots:
            for d, kind in plan.kinds[ij].items():
                s = (ij[0] + d[0], ij[1] + d[1])
                if kind == COPIED and mesh.ranks[s] == mesh.rank:
                    within.append((s, (_edge(h, H, k, d[0]), _edge(w, H, k, d[1])), ij,
                                   (_halo(h, H, k, d[0]), _halo(w, H, k, d[1]))))
    return between + within


# ---------------------------------------------------------------------------
# The plain versions
# ---------------------------------------------------------------------------


def _view(sh, plan: Plan, blocks: dict, ij, k: int) -> torch.Tensor:
    """Shard ``ij``'s k-deep view as a chunk reads it: a copy of its own
    block's view with each direct region taken from that neighbour's block
    in ``blocks``."""
    H, h, w = sh.halo, sh.h_loc, sh.w_loc
    view = blocks[ij][H - k:H + h + k, H - k:H + w + k].clone()
    for (di, dj), kind in plan.kinds[ij].items():
        if kind == DIRECT:
            s = (ij[0] + di, ij[1] + dj)
            view[_halo(h, k, k, di), _halo(w, k, k, dj)] = \
                blocks[s][_edge(h, H, k, di), _edge(w, H, k, dj)]
    return view


def plain_cycle(sh, plan: Plan, k: int, iteration, total: int, n_chunks: int, *,
                t_off: int = 0, u1: bool = False) -> torch.Tensor:
    """The plain version of :func:`cycle`, on any device."""
    calls["cycle"] += 1
    _check_chunks(sh, plan, k, total, n_chunks)
    H, h, w = sh.halo, sh.h_loc, sh.w_loc
    centre = (slice(H, H + h), slice(H, H + w))
    inner = (slice(k, k + h), slice(k, k + w))
    sets = (sh.u_blocks, sh.twin_blocks)
    deltas = []
    t = iteration + t_off
    for c, ns in enumerate(spread(total, n_chunks)):
        src, dst = sets[c % 2], sets[1 - c % 2]
        delta = None
        for ij in plan.slots:
            view = _view(sh, plan, src, ij, k)
            frozen = sh.frozen_blocks[ij][H - k:H + h + k, H - k:H + w + k]
            out, _, first = hopper_shard2d.sweep_k_local(view, frozen, sh.par0(ij), t, ns, u1=True)
            dst[ij][centre] = out[inner]
            if c == 0 and u1:
                sh.u1_blocks[ij][centre] = first[inner]
            d = (first[inner] - view[inner]).abs().max()
            delta = d if delta is None else torch.maximum(delta, d)
        deltas.append(delta)
        t = t + ns
    return torch.stack(deltas)


def plain_solve(sh, plan: Plan, k: int, stagger: int, bound: int, iteration: torch.Tensor,
                delta: torch.Tensor, done: torch.Tensor) -> None:
    """The plain version of :func:`solve`, on any device: the entry's loop
    over :func:`plain_cycle`, the rest of each cycle after its checked chunk
    in chunks of ``k`` and a last shorter one, as the entry runs it (any
    split gives the same field; this one leaves the twin and u1 blocks as
    the entry leaves them)."""
    calls["solve"] += 1
    _check_solve(sh, plan, stagger)
    home, other = sh.u_blocks, sh.twin_blocks
    m_max, depth = max(sh.height, sh.width), min(k, stagger)
    it, d, finished = int(iteration), delta.clone(), bool(done)
    final = home
    while not finished and it < bound:
        d = plain_cycle(sh, plan, k, it, depth, 1, u1=True)[0]
        if it + 1 >= m_max and bool(d < sh.epsilon.to(d.device)):
            it, finished, final = it + 1, True, sh.u1_blocks
            break
        sh.u_blocks, sh.twin_blocks = sh.twin_blocks, sh.u_blocks
        for t in range(it + depth, it + stagger, k):
            plain_cycle(sh, plan, k, t, min(k, it + stagger - t), 1)
            sh.u_blocks, sh.twin_blocks = sh.twin_blocks, sh.u_blocks
        it += stagger
        final = sh.u_blocks
    sh.u_blocks, sh.twin_blocks = home, other
    if final is not home:
        H, h, w = sh.halo, sh.h_loc, sh.w_loc
        for ij in plan.slots:
            home[ij][H:H + h, H:H + w] = final[ij][H:H + h, H:H + w]
    iteration.fill_(it)
    delta.copy_(d)
    done.fill_(int(finished))


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


def _check_chunks(sh, plan: Plan, k: int, total: int, n_chunks: int) -> None:
    if not 1 <= k <= min(sh.halo, sh.h_loc, sh.w_loc):
        raise ValueError(f"depth {k} outside 1..min(halo {sh.halo}, shard {sh.h_loc}x"
                         f"{sh.w_loc})")
    if n_chunks < 1 or not n_chunks <= total <= n_chunks * k:
        raise ValueError(f"{total} sweeps over {n_chunks} chunks of 1..{k} sweeps")
    if n_chunks > 1 and not plan.whole:
        raise ValueError("a plan with copied neighbours runs one chunk a launch (the host "
                         "copies their halos between chunks)")


def _check_solve(sh, plan: Plan, stagger: int) -> None:
    if stagger < 1:
        raise ValueError(f"stagger must be >= 1, got {stagger}")
    if not plan.whole:
        raise ValueError("the solve entry needs a plan that covers the whole mesh (one device, "
                         "one process)")
    if sh.u1_blocks is None:
        raise ValueError("a solve needs the u1 blocks")


def _check_blocks(sh, plan: Plan, k: int, u1: bool) -> None:
    """What the entries take: per shard contiguous float32 blocks (u, twin,
    and u1 when asked) and a bool frozen block of one shape on the plan's
    device, and a depth whose tile fits the shared memory."""
    H, h, w = sh.halo, sh.h_loc, sh.w_loc
    shape = (h + 2 * H, w + 2 * H)
    for ij in plan.slots:
        grids = [sh.u_blocks[ij], sh.twin_blocks[ij]] + ([sh.u1_blocks[ij]] if u1 else [])
        for t in grids + [sh.frozen_blocks[ij]]:
            if tuple(t.shape) != shape or not t.is_contiguous() or t.device != plan.device:
                raise ValueError(f"shard {ij}: need contiguous {shape} blocks on {plan.device}")
        if any(t.dtype != torch.float32 for t in grids) or sh.frozen_blocks[ij].dtype != torch.bool:
            raise TypeError(f"shard {ij}: need float32 blocks and a bool frozen block")
        if len({t.data_ptr() for t in grids}) != len(grids):
            raise ValueError(f"shard {ij}: u, twin and u1 must be distinct blocks")
    hopper_tile2d.check_depth(
        k, torch.cuda.get_device_properties(plan.device).shared_memory_per_block_optin
        - REGIONS_SMEM)


_tables: dict = {}


def _table(sh, plan: Plan) -> torch.Tensor:
    """The plan as the entries read it (csrc/tile2d.cu's ``Plan``), on the
    plan's device: a row of int64 a shard with its blocks' addresses (u,
    twin, u1 or 0, frozen), its parity origin and each region's direct slot
    (-1: the own block). Kept per content, so a layout (halo regrow, swap
    parity, u1 allocated) is uploaded once."""
    slot = {ij: n for n, ij in enumerate(plan.slots)}
    rows = []
    for ij in plan.slots:
        regions = [slot[(ij[0] + d[0], ij[1] + d[1])]
                   if d != (0, 0) and plan.kinds[ij][d] == DIRECT else -1 for d in REGIONS]
        rows.append((sh.u_blocks[ij].data_ptr(), sh.twin_blocks[ij].data_ptr(),
                     0 if sh.u1_blocks is None else sh.u1_blocks[ij].data_ptr(),
                     sh.frozen_blocks[ij].data_ptr(), sh.par0(ij), *regions))
    key = (str(plan.device), tuple(rows))
    table = _tables.get(key)
    if table is None:
        if len(_tables) >= 16:
            _tables.clear()
        table = _tables[key] = torch.tensor(rows, dtype=torch.int64).to(plan.device)
    return table


def _launch(entry: str, sh, plan: Plan, k: int, *args) -> None:
    dev = plan.device
    err = getattr(_build.load(), entry)(
        _table(sh, plan).data_ptr(), len(plan.slots), sh.h_loc, sh.w_loc, sh.halo,
        sh.u_blocks[plan.slots[0]].stride(0), k, *args, _stream(dev), dev.index)
    _build.check(err, entry)
    launches[entry] += 1


def cycle(sh, plan: Plan, k: int, iteration, total: int, n_chunks: int, *, t_off: int = 0,
          u1: bool = False) -> torch.Tensor:
    """``total`` sweeps from ``iteration + t_off`` (``iteration`` an int or
    a 0-d int32 tensor on the plan's device) over ``n_chunks`` chunks of at
    most ``k`` on every shard of ``plan`` of the mesh grid ``sh``: chunk
    ``c`` reads set ``c & 1`` and writes the other's centres (the host
    swaps ``u_blocks`` and ``twin_blocks`` after an odd count); with ``u1``
    chunk 0 writes the centres after sweep 0 to ``u1_blocks``. A plan with
    copied neighbours runs one chunk, after the host's copies. Returns each
    chunk's sweep-0 delta over the plan's centres, float32 ``[n_chunks]``.
    On the CPU the plain version runs; on a card the kernel or this
    raises."""
    if plan.device.type == "cpu":
        return plain_cycle(sh, plan, k, iteration, total, n_chunks, t_off=t_off, u1=u1)
    _check_chunks(sh, plan, k, total, n_chunks)
    if u1 and sh.u1_blocks is None:
        raise ValueError("u1 asked for, but the grid has no u1 blocks")
    _check_blocks(sh, plan, k, u1)
    deltas = torch.zeros(n_chunks, dtype=torch.float32, device=plan.device)
    it = _iteration(iteration, plan.device)   # held until the launch is enqueued
    _launch("epic_resident2d_cycle", sh, plan, k, it.data_ptr(),
            int(t_off), total, n_chunks, int(u1), deltas.data_ptr())
    return deltas


def solve(sh, plan: Plan, k: int, stagger: int, bound: int, iteration: torch.Tensor,
          delta: torch.Tensor, done: torch.Tensor) -> None:
    """``core.solve``'s protocol on every shard of a plan that covers the
    whole mesh, resumed from ``iteration``, ``delta`` and ``done`` (0-d
    int32, float32 and int32 tensors on the plan's device, updated in place)
    while not done and the iteration is below ``bound``: a check every
    ``stagger`` sweeps, exit right after a passing check with ``iteration +
    1 >= max(H, W)``, the post-check-sweep state kept. The state ends in
    ``u_blocks``. On the CPU the plain version runs; on a card the kernel
    (one launch) or this raises."""
    if plan.device.type == "cpu":
        return plain_solve(sh, plan, k, stagger, bound, iteration, delta, done)
    _check_solve(sh, plan, stagger)
    _check_blocks(sh, plan, k, True)
    dev = plan.device
    for t, dtype in ((iteration, torch.int32), (delta, torch.float32), (done, torch.int32)):
        if t.dtype != dtype or t.ndim != 0 or t.device != dev:
            raise ValueError(f"need 0-d {dtype} scalars on {dev}, got {t.dtype} on {t.device}")
    acc = torch.zeros(2, dtype=torch.int32, device=dev)
    eps = sh.epsilon.to(device=dev, dtype=torch.float32)
    _launch("epic_resident2d_solve", sh, plan, k, eps.data_ptr(), max(sh.height, sh.width),
            min(bound, 2**31 - 1 - stagger), stagger, acc.data_ptr(), iteration.data_ptr(),
            delta.data_ptr(), done.data_ptr())
