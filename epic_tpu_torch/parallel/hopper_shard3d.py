"""One shard's chunk of the 3D mesh solver: the CUDA entry and its plain
version.

The counterpart of the per-shard compute of ``epic_tpu.parallel``'s 3D
mesh: ``sharded3d._sweep_k_local`` (XLA), ``_sweep_k_local_kernel`` (K18,
the whole extended block in VMEM), ``_band_shard3d_kernel`` (K19, DMA
plane bands), ``resident3d._chunk_cycle`` (K20, K11's body on a
plane-guarded resident shard) and ``resident_z._resident_z_kernel`` (K21,
whole planes with guard planes). All of them compute one function, and one
CUDA entry answers the four kernels shard by shard: ``epic_shard3d_chunk``
in ``csrc/shard3d.cu``. It is :mod:`.sharded3d`'s per-shard route: the
route of any mesh with a face neighbour on another device or process, and
of the per-shard kernel names. Where one device holds the whole mesh,
:mod:`.hopper_resident3d`'s entries sweep every shard at once instead.

A chunk takes one shard's extended block after the halo exchange
(``de x he x we`` voxels: the centre and a halo of ``halo = (hz, hy, hx)``
voxels on each side of the axes the mesh cuts, 0 on the others) and runs
``ns`` guarded ``lse6`` sweeps in place: sweep ``s`` updates a voxel only
inside the block's trapezoid (``s+1 <= l < e-1-s`` on each cut axis,
``1 <= l <= e-2`` on the others, whose faces are the volume's frozen shell
or mesh padding), only if it is not frozen, and only of the 3D class
``(par0 + lz + ly + lx) % 2 == (t0 + s) % 2``, ``par0`` the parity of the
block's global origin. After ``ns <= min(cut halos)`` sweeps the centre is
exact; the halo voxels are stale until the next exchange rewrites them.
The delta is sweep 0's ``max |u1 - u0|`` over the whole block. K20/K21 take
it over the centre only; the max over the shards is the same, since every
chunk runs right after an exchange: at sweep 0 a halo voxel holds its
owner's values and gets its owner's update, and out-of-mesh halos and
padding are frozen.

:func:`sweep_k_local3d` is the plain torch version (the op order of
``solver/core.py``'s ``lse6``, so it gives core's bits); :func:`chunk` is the
wrapper: a CPU tensor goes to the plain version, a CUDA tensor to the kernel
or an exception. ``launches`` counts the kernel's launches and ``calls`` the
plain version's calls; nothing else changes them. The entry has no depth
limit: the block stays in device memory, so any halo the shard's extents
allow runs. A lane takes one class voxel of a flat walk over the sweep's
trapezoid, so short rows leave no lane idle; the walk's index is 32-bit,
which bounds a block below ``MAX_VOXELS``.
"""

from __future__ import annotations

import torch

from ..solver import _build
from ..solver._sweep_body import lse6
from ..solver.hopper_sweep import _iteration, _stream

# The entry's flat index is 32-bit: a block stays below it.
MAX_VOXELS = 2**31

launches = {"epic_shard3d_chunk": 0}
calls = {"sweep_k_local3d": 0}


def _max_sweeps(halo) -> int | None:
    """The deepest chunk a block with these halos takes (None: no cut axis,
    no limit)."""
    cut = [h for h in halo if h > 0]
    return min(cut) if cut else None


def _axis_mask(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Interior positions 1..n-2 of an axis that lie in ``[lo, hi)``."""
    pos = torch.arange(1, n - 1, device=device)
    return (pos >= lo) & (pos < hi)


def _box(shape, lo, hi, device) -> torch.Tensor:
    """The interior voxels inside the box ``[lo, hi)``, as a bool volume."""
    z, y, x = (_axis_mask(n, a, b, device) for n, a, b in zip(shape, lo, hi))
    return z[:, None, None] & y[None, :, None] & x[None, None, :]


def sweep_k_local3d(u_ext: torch.Tensor, frozen_ext: torch.Tensor, par0: int, iteration,
                    num_sweeps: int, *, halo, u1: bool = False):
    """The plain version: ``num_sweeps`` guarded sweeps of one shard's
    extended block from ``iteration`` (an int or a 0-d tensor), ``halo``
    the block's ``(hz, hy, hx)``. Returns ``(u_out, delta, first)``: the new
    block (a fresh tensor), sweep 0's delta over the block, and with
    ``u1=True`` the block after sweep 0 (else None). The inputs are not
    modified."""
    calls["sweep_k_local3d"] += 1
    shape = tuple(u_ext.shape)
    dev = u_ext.device
    u = u_ext.clone()
    z, y, x = (torch.arange(1, n - 1, device=dev) for n in shape)
    cls = ((par0 + z[:, None, None] + y[None, :, None] + x[None, None, :]) % 2).to(torch.uint8)
    free = ~frozen_ext[1:-1, 1:-1, 1:-1].bool()
    delta = torch.zeros((), dtype=torch.float32, device=dev)
    first = None
    for s in range(num_sweeps):
        inner = u[1:-1, 1:-1, 1:-1]
        val = lse6(u[:-2, 1:-1, 1:-1], u[2:, 1:-1, 1:-1], u[1:-1, :-2, 1:-1],
                   u[1:-1, 2:, 1:-1], u[1:-1, 1:-1, :-2], u[1:-1, 1:-1, 2:])
        valid = _box(shape, [s + 1 if h else 1 for h in halo],
                     [n - 1 - s if h else n - 1 for n, h in zip(shape, halo)], dev)
        update = (cls == (iteration + s) % 2) & free & valid
        new = torch.where(update, val, inner)
        if s == 0 and new.numel():
            delta = (new - inner).abs().max()
        u[1:-1, 1:-1, 1:-1] = new
        if s == 0 and u1:
            first = u.clone()
    return u, delta, first


def _check(u, frozen, u1, halo, ns: int) -> None:
    """What the entry takes: f32 views ``u`` (and ``u1``) and a bool
    ``frozen`` of one 3D shape and pitch, unit x stride, on one CUDA device,
    ``u1`` another buffer; halos that leave a centre; fewer than
    ``MAX_VOXELS`` voxels; 1 <= ns <= the shallowest cut halo."""
    if u.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got one on {u.device}")
    grids = [u] + ([u1] if u1 is not None else [])
    for t in grids:
        if t.dtype != torch.float32:
            raise TypeError(f"need float32 blocks, got {t.dtype}")
    if frozen.dtype != torch.bool:
        raise TypeError(f"need a bool frozen mask, got {frozen.dtype}")
    for t in grids + [frozen]:
        if t.ndim != 3 or t.shape != u.shape:
            raise ValueError(f"need 3D views of one shape, got {tuple(t.shape)}")
        if t.stride() != u.stride() or t.stride(2) != 1:
            raise ValueError("the views must share one plane and row pitch and a unit x stride")
        if t.device != u.device:
            raise ValueError(f"views on {t.device} and {u.device}")
    if u1 is not None and u1.data_ptr() == u.data_ptr():
        raise ValueError("u1 must be another buffer than u")
    if len(halo) != 3 or any(h < 0 or n - 2 * h < 1 for n, h in zip(u.shape, halo)):
        raise ValueError(f"a {tuple(u.shape)} block has no centre with halos {tuple(halo)}")
    if u.numel() >= MAX_VOXELS:
        raise ValueError(f"a {tuple(u.shape)} block passes the entry's 32-bit index")
    deepest = _max_sweeps(halo)
    if ns < 1 or (deepest is not None and ns > deepest):
        raise ValueError(f"a chunk runs 1..{deepest or 'any'} sweeps with halos {tuple(halo)}, "
                         f"got {ns}")


def chunk(u: torch.Tensor, frozen: torch.Tensor, *, halo, par0: int, iteration, ns: int,
          t_off: int = 0, u1: torch.Tensor | None = None, want_delta: bool = False):
    """One chunk on one shard, in place: ``ns`` sweeps of the extended block
    view ``u`` (halos ``halo``) from iteration ``iteration + t_off``
    (``iteration`` an int or a 0-d int32 tensor on u's device); when given,
    the centre after sweep 0 goes into ``u1`` (a view of u's shape and
    pitch). Returns sweep 0's delta as a 0-d float32 tensor when
    ``want_delta``, else None. On the CPU the plain version runs; on a CUDA
    device the kernel runs or this raises."""
    if u.device.type == "cpu":
        return _plain_chunk(u, frozen, halo=halo, par0=par0, iteration=iteration, ns=ns,
                            t_off=t_off, u1=u1, want_delta=want_delta)
    _check(u, frozen, u1, halo, ns)
    dev = u.device
    de, he, we = u.shape
    delta = torch.zeros((), dtype=torch.float32, device=dev) if want_delta else None
    it = _iteration(iteration, dev)   # held until the launch is enqueued
    err = _build.load().epic_shard3d_chunk(
        u.data_ptr(), None if u1 is None else u1.data_ptr(), frozen.data_ptr(), u.stride(0),
        u.stride(1), de, he, we, *map(int, halo), int(par0) & 1,
        it.data_ptr(), int(t_off), ns,
        None if delta is None else delta.data_ptr(), _stream(dev), dev.index)
    _build.check(err, "epic_shard3d_chunk")
    launches["epic_shard3d_chunk"] += 1
    return delta


def _plain_chunk(u, frozen, *, halo, par0: int, iteration, ns: int, t_off: int = 0, u1=None,
                 want_delta: bool = False):
    """:func:`chunk`'s contract through the plain version (the whole block
    written back, as the kernel leaves it)."""
    deepest = _max_sweeps(halo)
    if ns < 1 or (deepest is not None and ns > deepest):
        raise ValueError(f"a chunk runs 1..{deepest or 'any'} sweeps with halos {tuple(halo)}, "
                         f"got {ns}")
    out, delta, first = sweep_k_local3d(u, frozen, par0, iteration + t_off, ns, halo=halo,
                                        u1=u1 is not None)
    u.copy_(out)
    if u1 is not None:
        centre = tuple(slice(h, n - h) for n, h in zip(u.shape, halo))
        u1[centre] = first[centre]
    return delta if want_delta else None
