"""Dispatch between the hand-written CUDA kernels and their plain versions.

The in-memory half of ``repro.kernels.engine``. Every op takes ``impl``:

  * ``"auto"``   — the CUDA kernel for a CUDA tensor, the plain PyTorch
    version for a CPU tensor;
  * ``"kernel"`` — the CUDA kernel; raises on a CPU tensor;
  * ``"ref"``    — the plain version, on any device (the tests and the
    on-card comparisons ask for it explicitly).

The kernel route needs a CUDA tensor on a device of compute capability 9.x
(``_build.require_hopper``); it launches the kernel or raises, and never
falls back to the plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ref
from .assign import assign_nearest_cuda
from .fused_argfar import fused_min_argmax_cuda

# The JAX package's sentinels, bitwise: +-3.4e38 as float32.
_BIG = np.float32(3.4e38)
_NEG = np.float32(-3.4e38)

IMPLS = ("auto", "kernel", "ref")


def _resolve(impl: str, t: torch.Tensor) -> bool:
    """True when ``impl`` on tensor ``t`` takes the CUDA kernel."""
    if impl == "auto":
        return t.is_cuda
    if impl == "kernel":
        return True
    if impl == "ref":
        return False
    raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")


def _pad_rows(a: torch.Tensor, mult: int, fill: float):
    """Pad the rows of ``a`` to a multiple of ``mult`` with ``fill``.
    Returns ``(padded, n)`` with ``n`` the original row count."""
    n = a.shape[0]
    pad = (-n) % mult
    if pad == 0:
        return a, n
    tail = torch.full((pad,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                      device=a.device)
    return torch.cat([a, tail]), n


def dist2_to_center(x, c, *, impl: str = "auto"):
    """Squared distance of each row of ``x (..., n, d)`` to ``c (..., d)``.

    A single center has no (n, m) block to fuse away; the plain pass is the
    op on every device, as in the JAX engine."""
    _resolve(impl, x)
    return ref.dist2_to_center(x, c)


def fused_min_argmax(x, c, md, *, impl: str = "auto"):
    """Batched GON step: ``x (m, per, d)``, ``c (m, d)``, ``md (m, per)`` ->
    ``(md, far_val (m,), far_idx (m,) int32)``. ``md`` is updated in place
    on both routes. Rows whose ``md`` is -3.4e38 (padding, masked rows)
    stay so and never win unless every row of a machine is such a row."""
    if _resolve(impl, x):
        return fused_min_argmax_cuda(x, c, md)
    return ref.fused_min_argmax(x, c, md)


def assign_nearest(x, c, *, impl: str = "auto"):
    """Nearest-center assignment: ``(idx (n,) int32, d2 (n,))``."""
    if _resolve(impl, x):
        return assign_nearest_cuda(x, c)
    return ref.assign_nearest(x, c)
