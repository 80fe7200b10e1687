"""The pinned-op-order logsumexp stencil bodies, in plain torch.

The counterparts of ``epic_tpu.solver._sweep_body.lse4``/``lse6`` and of
the CUDA kernels' ``lse4`` (``csrc/sweep2d.cu``) and ``lse6``
(``csrc/sweep3d.cu``). Float op order is load-bearing. 2D: the max tree over
((N,S),(W,E)), then a left-associated sum of shifted exponentials, log, add
max, subtract log(4) — harmonic_cpu.cpp:59-70 / harmonic_gpu.cu:51-61. 3D:
the neighbours in the order (z-, z+, y-, y+, x-, x+), a left-to-right max
chain, the same left-associated sum, subtract log(6) (reference_np.sweep_3d).
With the same order, and PyTorch's accurate CUDA ``exp``/``log`` (the
``expf``/``logf`` the kernels call), the plain version and the kernels give
the same bits on the card.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

# float32(log(4.0)); as a Python float it converts back to the same float32.
LOG2N_2D = float(np.float32(np.log(np.float64(4.0))))
LOG2N_3D = float(np.float32(np.log(np.float64(6.0))))


def lse4(n: torch.Tensor, s: torch.Tensor, w: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """4-neighbour shifted logsumexp minus log(4), elementwise."""
    m = torch.maximum(torch.maximum(n, s), torch.maximum(w, e))
    t = ((torch.exp(n - m) + torch.exp(s - m)) + torch.exp(w - m)) + torch.exp(e - m)
    return (m + torch.log(t)) - LOG2N_2D


def lse2n(nbrs: Sequence[torch.Tensor], log2n: float) -> torch.Tensor:
    """Shifted logsumexp of 2n neighbours minus ``log2n``, elementwise: a
    left-to-right max chain, a left-associated sum of exponentials."""
    m = nbrs[0]
    for nb in nbrs[1:]:
        m = torch.maximum(m, nb)
    s = torch.exp(nbrs[0] - m)
    for nb in nbrs[1:]:
        s = s + torch.exp(nb - m)
    return (m + torch.log(s)) - log2n


def lse6(zm: torch.Tensor, zp: torch.Tensor, ym: torch.Tensor, yp: torch.Tensor,
         xm: torch.Tensor, xp: torch.Tensor) -> torch.Tensor:
    """6-neighbour shifted logsumexp minus log(6), elementwise, neighbours in
    the order (z-, z+, y-, y+, x-, x+)."""
    return lse2n((zm, zp, ym, yp, xm, xp), LOG2N_3D)
