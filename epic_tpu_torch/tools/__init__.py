"""The port's user-facing tools, each the twin of a tool of the JAX package's
``tools/`` with its flags and its output:

- ``batch_bench``: the reference's percent-valid battery (legacy SOR in
  float32 and float64, the native log-space solve, the plain torch solve,
  the CUDA kernels and the cascade, on the reference's domains), as a CSV;
- ``compare_precision``: the precision-collapse overlay of SOR f32, SOR f64
  and the log-space field, as a PNG and three region shares;
- ``anytime_demo``: the anytime replanning loop through the rviz verbs,
  rendered to a PNG;
- ``server_loadtest``: concurrent clients against the JSON/TCP server, one
  JSON line of per-verb latency percentiles and requests/s;
- ``scaling_bench``: sweeps/s of the sharded solver against the number of
  shards of a virtual mesh of the card.

Run each as ``python -m epic_tpu_torch.tools.<name> [flags]``. Each runs on
the card (``--device cuda``, the default) and stops with an error where
there is none; ``--device cpu`` runs it on the plain torch version. They
import torch, NumPy and this package, never JAX.
"""

from __future__ import annotations

import torch

__all__ = ["add_device_flag", "resolve_device", "synchronize"]


def add_device_flag(ap) -> None:
    """The ``--device`` flag every tool takes."""
    ap.add_argument("--device", default="cuda",
                    help="torch device: a CUDA device runs the kernels (the default), "
                         "'cpu' the plain torch version")


def resolve_device(name: str) -> torch.device:
    """``name`` as a torch device; a CUDA device where none is visible
    raises, so that a tool never falls back to the CPU unasked."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r}: no CUDA device is visible; pass --device cpu "
                           "to run on the plain torch version")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device``: the close of a host-clock
    time around work on a card."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
