"""Build the CUDA kernels at first use and load them with ctypes.

The sources in ``csrc/`` (``sweep2d.cu``, ``sweep3d.cu``, ``batched2d.cu``,
``tile2d.cu``, ``tile3d.cu``, ``shard3d.cu`` and the header they share)
have a plain C interface and include no PyTorch header. ``nvcc``
compiles each ``.cu`` file to an object, all at once in parallel, and links
them into one shared library under ``build/epic_tpu_torch/`` beside the
package, named by a hash of every source and the flags (an edited source is
rebuilt). Tensors cross as ``data_ptr()`` integers and the stream as
PyTorch's current stream handle.

A failed build raises with nvcc's output. Nothing here falls back to the
plain version: a CUDA tensor gets the kernel or an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
SOURCES = tuple(CSRC / f for f in ("sweep2d.cu", "sweep3d.cu", "batched2d.cu", "tile2d.cu",
                                    "tile3d.cu", "shard3d.cu"))
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "epic_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
COMPILE_FLAGS = (
    *ARCH_FLAGS, "-c", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",   # registers and spills of each kernel, kept in build_info
)
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

# What the last build in this process did: seconds, nvcc path, its output.
build_info: dict = {}
_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """nvcc on PATH, else in $CUDA_HOME/bin, else in /usr/local/cuda/bin."""
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels of epic_tpu_torch are built from csrc/ at first use")


def library_path() -> pathlib.Path:
    """The library's path, keyed on every file in csrc/ and the flags."""
    digest = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        digest.update(f.name.encode() + f.read_bytes())
    digest.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libepic_sweep-{digest.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> list[str]:
    """Run the commands at once; return each one's output (with
    ``-Xptxas -v``, its kernels' registers and spills); raise with nvcc's
    output if one fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}: {' '.join(cmd)}\n{out}")
    return outs


def build() -> pathlib.Path:
    """Compile the kernels unless this source set's library already exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [out.with_name(f"{tag}.{src.stem}.o") for src in SOURCES]
    tmp = out.with_name(f"{tag}.tmp")
    t0 = time.perf_counter()
    try:
        logs = _run([[nvcc, *COMPILE_FLAGS, "-o", str(o), str(s)] for o, s in zip(objs, SOURCES)])
        logs += _run([[nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]])
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    os.replace(tmp, out)   # atomic: a concurrent process never loads a half-written file
    build_info.update(seconds=seconds, nvcc=nvcc, log="".join(logs))
    return out


def set_tile3d_types(lib: ctypes.CDLL) -> None:
    """The argument and result types of ``csrc/tile3d.cu``'s entries in ``lib``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.epic_tile3d_chunk.argtypes = [p, p, p, p, i, i, i, i, p, i, i, p, i, p, i]
    lib.epic_tile3d_cycle.argtypes = [p, p, p, i, i, i, i, p, i, i, i, p, i, p, i]
    lib.epic_tile3d_solve.argtypes = [p, p, p, p, i, i, i, i, p, i, i, i, p, p, p, p, i, p, i]
    for fn in (lib.epic_tile3d_chunk, lib.epic_tile3d_cycle, lib.epic_tile3d_solve):
        fn.restype = i


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of every entry in ``lib`` (the
    library of :func:`build`, or a probe's variant of it); returns it."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.epic_sweep2d_chunk.argtypes = [p, p, i, i, p, i, p, p, i]
    lib.epic_sweep2d_solve.argtypes = [p, p, i, i, p, i, i, i, p, p, p, p, p, i]
    lib.epic_sweep3d_chunk.argtypes = [p, p, i, i, i, p, i, p, p, i]
    lib.epic_sweep3d_solve.argtypes = [p, p, i, i, i, p, i, i, i, p, p, p, p, p, i]
    lib.epic_batched2d_chunk.argtypes = [p, p, i, i, i, p, i, p, p, i, p, i]
    lib.epic_batched2d_solve.argtypes = [p, p, i, i, i, p, i, i, i, p, p, p, i, p, i]
    lib.epic_batched2d_smem_bytes.argtypes = [i, i]
    lib.epic_batched2d_smem_bytes.restype = ll
    lib.epic_batched2d_cluster_smem_bytes.argtypes = [i, i, i]
    lib.epic_batched2d_cluster_smem_bytes.restype = ll
    lib.epic_batched2d_max_cluster.argtypes = [i, p]
    lib.epic_batched2d_max_cluster.restype = i
    lib.epic_tile2d_chunk.argtypes = [p, p, p, p, i, i, p, i, i, p, i, p, i]
    lib.epic_tile2d_cycle.argtypes = [p, p, p, i, i, p, i, i, i, p, i, p, i]
    lib.epic_tile2d_solve.argtypes = [p, p, p, p, i, i, p, i, i, i, p, p, p, p, i, p, i]
    set_tile3d_types(lib)
    lib.epic_shard2d_chunk.argtypes = [p, p, p, p, ll, i, i, i, i, p, i, i, p, p, i]
    lib.epic_shard3d_chunk.argtypes = [p, p, p, ll, ll, i, i, i, i, i, i, i, p, i, i, p, p, i]
    lib.epic_resident2d_cycle.argtypes = [p, i, i, i, i, ll, i, p, i, i, i, i, p, p, i]
    lib.epic_resident2d_solve.argtypes = [p, i, i, i, i, ll, i, p, i, i, i, p, p, p, p, p, i]
    for fn in (lib.epic_sweep2d_chunk, lib.epic_sweep2d_solve,
               lib.epic_sweep3d_chunk, lib.epic_sweep3d_solve,
               lib.epic_batched2d_chunk, lib.epic_batched2d_solve,
               lib.epic_tile2d_chunk, lib.epic_tile2d_cycle, lib.epic_tile2d_solve,
               lib.epic_shard2d_chunk, lib.epic_shard3d_chunk,
               lib.epic_resident2d_cycle, lib.epic_resident2d_solve):
        fn.restype = i
    if hasattr(lib, "epic_sweep3d_plan"):   # an earlier sweep3d.cu lacks the plan entries
        lib.epic_sweep3d_plan.argtypes = [i, i, i, i, p]
        lib.epic_sweep3d_slots.argtypes = [i, p]
        lib.epic_sweep3d_plan.restype = i
        lib.epic_sweep3d_slots.restype = i
    if hasattr(lib, "epic_resident3d_cycle"):   # an earlier shard3d.cu lacks the device entries
        lib.epic_resident3d_cycle.argtypes = [p, i, i, i, i, i, i, i, ll, ll, p, i, i, i, p, p, i]
        lib.epic_resident3d_solve.argtypes = [p, i, i, i, i, i, i, i, ll, ll, p, i, i, i, p, p, p,
                                              p, p, i]
        lib.epic_resident3d_cycle.restype = i
        lib.epic_resident3d_solve.restype = i
    if hasattr(lib, "epic_lanes2d_chunk"):   # an earlier tile2d.cu lacks the batch entries
        lib.epic_lanes2d_chunk.argtypes = [p, p, p, i, i, i, p, i, p, p, i, p, i]
        lib.epic_lanes2d_solve.argtypes = [p, p, p, p, i, i, i, p, i, i, i, p, p, p, p, p, i, p,
                                           i]
        lib.epic_lanes2d_chunk.restype = i
        lib.epic_lanes2d_solve.restype = i
    for name in ("epic_tile2d_smem_bytes", "epic_tile3d_smem_bytes"):
        if hasattr(lib, name):   # an earlier design of a tile family may lack it
            getattr(lib, name).argtypes = [i]
            getattr(lib, name).restype = ll
    lib.epic_cuda_error_string.argtypes = [i]
    lib.epic_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first call and loaded once per process."""
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(build())))
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        msg = load().epic_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
