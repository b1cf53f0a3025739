"""Plain PyTorch versions of the k-center distance kernels.

These are the semantics contracts of the port, as ``repro.kernels.ref`` is
for the JAX package: each CUDA kernel is held against them on the card, and
they run whenever a tensor lies on the CPU. Their arithmetic follows the
JAX oracles operation by operation, so on the CPU they agree with them
bitwise on exact-arithmetic inputs (and at d = 2 on any input).

All distances are *squared* Euclidean; indices are int32.
"""
from __future__ import annotations

import torch


def dist2_to_center(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared distances from every row of ``x (..., n, d)`` to the matching
    center ``c (..., d)``, by the direct form ``sum((x - c)^2)``."""
    diff = x - c.unsqueeze(-2)
    return (diff * diff).sum(-1)


def pairwise_dist2(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared distances ``(n, m)`` between rows of ``x (n, d)`` and
    ``c (m, d)`` by the clamped decomposition ``|x|^2 + |c|^2 - 2 x.c^T``."""
    xn = (x * x).sum(-1, keepdim=True)           # (n, 1)
    cn = (c * c).sum(-1, keepdim=True).T         # (1, m)
    d2 = xn + cn - 2.0 * (x @ c.T)
    return torch.clamp_min(d2, 0.0)


def fused_min_argmax(x: torch.Tensor, c: torch.Tensor, md: torch.Tensor):
    """One Gonzalez iteration on each of m machine blocks.

    ``x (m, per, d)``, the new centers ``c (m, d)`` and the running
    min-squared-distances ``md (m, per)``. Updates ``md`` in place to
    ``min(md, |x - c|^2)`` (as the CUDA kernel does) and returns
    ``(md, far_val (m,), far_idx (m,) int32)``: per machine, the farthest
    row under the updated distances, first occurrence on ties.
    """
    torch.minimum(md, dist2_to_center(x, c), out=md)
    idx = torch.argmax(md, dim=-1)
    val = md.gather(-1, idx.unsqueeze(-1)).squeeze(-1)
    return md, val, idx.to(torch.int32)


def assign_nearest(x: torch.Tensor, c: torch.Tensor):
    """Nearest center of every row: ``(idx (n,) int32, d2 (n,))``, first
    occurrence on ties."""
    d2 = pairwise_dist2(x, c)
    idx = torch.argmin(d2, dim=-1)
    return idx.to(torch.int32), d2.gather(-1, idx.unsqueeze(-1)).squeeze(-1)
