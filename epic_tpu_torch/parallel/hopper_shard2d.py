"""One shard's chunk of the 2D mesh solver: the CUDA entry and its plain
version.

The counterpart of ``epic_tpu.parallel.sharded``'s per-shard compute:
``_sweep_k_local`` (XLA), ``_sweep_k_local_kernel`` (K14, the whole
extended block in VMEM) and ``_band_shard_kernel`` (K15, DMA row bands for
shards beyond VMEM). All three compute one function, and one CUDA entry
answers both kernels: ``epic_shard2d_chunk`` in ``csrc/tile2d.cu``, the
tile pass of the 2D tile kernels on a shard's block.

A chunk takes one shard's K-extended block after the halo exchange (the
``h x w`` centre and a K-deep halo, ``he x we`` cells) and runs ``ns <= K``
guarded sweeps: sweep ``s`` updates a cell only inside the block's
trapezoid (``s+1 <= r < he-1-s``, the same for columns), only if it is not
frozen, and only of the 2D class ``(par0 + r + c) % 2 != (t0 + s) % 2``,
``par0`` the parity of the block's global origin. The delta is sweep 0's
``max |u1 - u0|`` over the whole block.

:func:`sweep_k_local` is the plain torch version (the op order of
``solver/core.py``, so it gives core's bits); :func:`chunk` is the wrapper:
a CPU tensor goes to the plain version, a CUDA tensor to the kernel or an
exception. ``launches`` counts the kernel's launches and ``calls`` the
plain version's calls; nothing else changes them.
"""

from __future__ import annotations

import functools

import torch

from ..solver import _build, hopper_tile2d
from ..solver._sweep_body import lse4
from ..solver.hopper_sweep import _iteration, _stream

launches = {"epic_shard2d_chunk": 0}
calls = {"sweep_k_local": 0}


def depth_limit(smem_limit: int) -> int:
    """The deepest halo whose extended tile (``hopper_tile2d.TILE``, the
    kernel's 96 x 160 centre) fits ``smem_limit`` bytes of shared memory."""
    k = 0
    while hopper_tile2d.smem_bytes(k + 1) <= smem_limit:
        k += 1
    return k


@functools.lru_cache(maxsize=None)
def _smem_limit(device: torch.device) -> int:
    """The shared memory a block may opt into on ``device``."""
    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin


def max_depth(device: torch.device) -> int:
    """The deepest halo the kernel takes on ``device`` (55 on an H100)."""
    return depth_limit(_smem_limit(device))


def sweep_k_local(u_ext: torch.Tensor, frozen_ext: torch.Tensor, par0: int, iteration,
                  num_sweeps: int, *, u1: bool = False):
    """The plain version: ``num_sweeps`` guarded sweeps of one shard's
    extended block from ``iteration`` (an int or a 0-d tensor). Returns
    ``(u_out, delta, first)``: the new block (a fresh tensor), sweep 0's
    delta over the block, and with ``u1=True`` the block after sweep 0 (else
    None). The inputs are not modified. Only the centre of ``u_out`` is
    exact after ``num_sweeps <= K`` sweeps."""
    calls["sweep_k_local"] += 1
    he, we = u_ext.shape
    u = u_ext.clone()
    rows = torch.arange(1, he - 1, device=u.device)
    cols = torch.arange(1, we - 1, device=u.device)
    cls = ((par0 + rows[:, None] + cols[None, :]) % 2).to(torch.uint8)
    free = ~frozen_ext[1:-1, 1:-1].bool()
    delta = torch.zeros((), dtype=torch.float32, device=u.device)
    first = None
    for s in range(num_sweeps):
        inner = u[1:-1, 1:-1]
        val = lse4(u[:-2, 1:-1], u[2:, 1:-1], u[1:-1, :-2], u[1:-1, 2:])
        valid = (((rows >= s + 1) & (rows < he - 1 - s))[:, None]
                 & ((cols >= s + 1) & (cols < we - 1 - s))[None, :])
        update = (cls != (iteration + s) % 2) & free & valid
        new = torch.where(update, val, inner)
        if s == 0 and new.numel():
            delta = (new - inner).abs().max()
        u[1:-1, 1:-1] = new
        if s == 0 and u1:
            first = u.clone()
    return u, delta, first


def _check(src, dst, frozen, u1, k: int, ns: int) -> None:
    """What the entry takes: f32 views ``src``, ``dst`` (and ``u1``) and a
    bool ``frozen`` of one shape and row pitch, unit column stride, on one
    CUDA device, no grid twice; a centre of at least one cell; 1 <= ns <= k."""
    if src.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got one on {src.device}")
    grids = [src, dst] + ([u1] if u1 is not None else [])
    for t in grids:
        if t.dtype != torch.float32:
            raise TypeError(f"need float32 blocks, got {t.dtype}")
    if frozen.dtype != torch.bool:
        raise TypeError(f"need a bool frozen mask, got {frozen.dtype}")
    for t in grids + [frozen]:
        if t.ndim != 2 or t.shape != src.shape:
            raise ValueError(f"need 2D views of one shape, got {tuple(t.shape)}")
        if t.stride() != src.stride() or t.stride(1) != 1:
            raise ValueError("the views must share one row pitch and a unit column stride")
        if t.device != src.device:
            raise ValueError(f"views on {t.device} and {src.device}")
    ptrs = [t.data_ptr() for t in grids]
    if len(set(ptrs)) != len(ptrs):
        raise ValueError("src, dst and u1 must be distinct buffers (neighbouring tiles read "
                         "the source's halo)")
    he, we = src.shape
    if k < 1 or he - 2 * k < 1 or we - 2 * k < 1:
        raise ValueError(f"a {he}x{we} block has no centre at halo depth {k}")
    if not 1 <= ns <= k:
        raise ValueError(f"a chunk runs 1..k={k} sweeps, got {ns}")


def chunk(src: torch.Tensor, dst: torch.Tensor, frozen: torch.Tensor, *, k: int, par0: int,
          iteration, ns: int, t_off: int = 0, u1: torch.Tensor | None = None,
          want_delta: bool = False):
    """One chunk on one shard: ``ns`` sweeps of the K-extended block view
    ``src`` from iteration ``iteration + t_off`` (``iteration`` an int or a
    0-d int32 tensor on src's device), the centre (rows and columns ``k ..
    end-k``) written into ``dst`` and, when given, the centre after sweep 0
    into ``u1`` (views of src's shape and pitch). Returns sweep 0's delta as a
    0-d float32 tensor when ``want_delta``, else None. On the CPU the plain
    version runs; on a CUDA device the kernel runs or this raises."""
    if src.device.type == "cpu":
        return _plain_chunk(src, dst, frozen, k=k, par0=par0, iteration=iteration, ns=ns,
                            t_off=t_off, u1=u1, want_delta=want_delta)
    _check(src, dst, frozen, u1, k, ns)
    dev = src.device
    hopper_tile2d.check_depth(k, _smem_limit(dev))
    he, we = src.shape
    delta = torch.zeros((), dtype=torch.float32, device=dev) if want_delta else None
    it = _iteration(iteration, dev)   # held until the launch is enqueued
    err = _build.load().epic_shard2d_chunk(
        src.data_ptr(), dst.data_ptr(), None if u1 is None else u1.data_ptr(),
        frozen.data_ptr(), src.stride(0), he, we, k, int(par0) & 1,
        it.data_ptr(), int(t_off), ns,
        None if delta is None else delta.data_ptr(), _stream(dev), dev.index)
    _build.check(err, "epic_shard2d_chunk")
    launches["epic_shard2d_chunk"] += 1
    return delta


def _plain_chunk(src, dst, frozen, *, k: int, par0: int, iteration, ns: int, t_off: int = 0,
                 u1=None, want_delta: bool = False):
    """:func:`chunk`'s contract through the plain version."""
    if not 1 <= ns <= k:
        raise ValueError(f"a chunk runs 1..k={k} sweeps, got {ns}")
    out, delta, first = sweep_k_local(src, frozen, par0, iteration + t_off, ns,
                                      u1=u1 is not None)
    centre = (slice(k, src.shape[0] - k), slice(k, src.shape[1] - k))
    dst[centre] = out[centre]
    if u1 is not None:
        u1[centre] = first[centre]
    return delta if want_delta else None
