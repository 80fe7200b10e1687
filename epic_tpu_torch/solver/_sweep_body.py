"""The pinned-op-order logsumexp stencil body, in plain torch.

The counterpart of ``epic_tpu.solver._sweep_body.lse4`` and of the CUDA
kernels' ``lse4`` in ``csrc/sweep2d.cu``. Float op order is load-bearing:
the max tree over ((N,S),(W,E)), then a left-associated sum of shifted
exponentials, log, add max, subtract log(4) — harmonic_cpu.cpp:59-70 /
harmonic_gpu.cu:51-61. With the same order, and PyTorch's accurate CUDA
``exp``/``log`` (the ``expf``/``logf`` the kernels call), the plain version
and the kernels give the same bits on the card.
"""

from __future__ import annotations

import numpy as np
import torch

# float32(log(4.0)); as a Python float it converts back to the same float32.
LOG2N_2D = float(np.float32(np.log(np.float64(4.0))))


def lse4(n: torch.Tensor, s: torch.Tensor, w: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """4-neighbour shifted logsumexp minus log(4), elementwise."""
    m = torch.maximum(torch.maximum(n, s), torch.maximum(w, e))
    t = ((torch.exp(n - m) + torch.exp(s - m)) + torch.exp(w - m)) + torch.exp(e - m)
    return (m + torch.log(t)) - LOG2N_2D
