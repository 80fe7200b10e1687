"""Build the CUDA kernels at first use and load them with ctypes.

``csrc/sweep2d.cu`` has a plain C interface and includes no PyTorch header,
so ``nvcc`` builds it in seconds into a shared library under
``build/epic_tpu_torch/`` beside the package (named by a hash of the source
and the flags, so an edited source is rebuilt). Tensors cross as
``data_ptr()`` integers and the stream as PyTorch's current stream handle.

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

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "sweep2d.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "epic_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",   # registers and spills of each kernel, kept in build_info
)

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
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libsweep2d-{digest.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernels unless this source's library already exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}: {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent process never loads a half-written file
    build_info.update(seconds=seconds, nvcc=nvcc, log=proc.stdout + proc.stderr)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first call and loaded once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.epic_sweep2d_chunk.argtypes = [p, p, i, i, p, i, p, p, i]
        lib.epic_sweep2d_chunk.restype = i
        lib.epic_sweep2d_solve.argtypes = [p, p, i, i, p, i, i, i, p, p, p, p, p, i]
        lib.epic_sweep2d_solve.restype = i
        lib.epic_cuda_error_string.argtypes = [i]
        lib.epic_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        msg = load().epic_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
