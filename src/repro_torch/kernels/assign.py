"""Nearest-center assignment kernel (CUDA C++, ``csrc/assign.cu``) and its
plain version.

Replaces the TPU kernel ``src/repro/kernels/assign.py``
``assign_nearest_blocks``: per row, the (argmin, min) of the clamped
``|x|^2 + |c|^2 - 2 x.c`` over all centers, without the (n, k) matrix.

Bound on the card: operations at large k·d (each row-center pair costs
~2·d + 5 f32 operations against 4·d + 8 bytes a row). The kernel gives one
thread to a row, keeps the row in registers and walks centers staged in
shared memory; the TPU's sequential center-tile grid axis becomes a loop
inside the block. The source says how ties and rounding follow the plain
version.

``assign_nearest_batched_cuda`` is the same kernel over m machine blocks,
each against its own centers, the machine a second grid axis: the weighted
round-1 reducer's assign (the JAX package vmaps the kernel over machines).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import assign_nearest as assign_nearest_ref  # noqa: F401

_P, _I = ctypes.c_void_p, ctypes.c_int
# Centers a shared-memory tile holds: tile·(d + 1) floats within 32 KB.
_TILE_FLOATS = 8192


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.library("assign")
    lib.repro_assign_nearest.argtypes = [_P] * 4 + [_I] * 5 + [_P]
    lib.repro_assign_nearest.restype = _I
    lib.repro_assign_nearest_batched.argtypes = [_P] * 4 + [_I] * 6 + [_P]
    lib.repro_assign_nearest_batched.restype = _I
    return lib


def assign_nearest_cuda(x: torch.Tensor, c: torch.Tensor):
    """Launch the nearest-center kernel: same contract as
    ``assign_nearest_ref``. ``x (n, d)`` and ``c (k, d)`` are contiguous
    float32 tensors on one Hopper device; returns ``(idx (n,) int32,
    d2 (n,) f32)``."""
    dev = _build.require_hopper(x, c)
    if x.dim() != 2 or c.dim() != 2 or x.shape[1] != c.shape[1]:
        raise ValueError(f"x must be (n, d) and c (k, d), got "
                         f"{tuple(x.shape)} and {tuple(c.shape)}")
    for name, t in (("x", x), ("c", c)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got "
                             f"{t.dtype}, contiguous={t.is_contiguous()}")
    n, d = x.shape
    k = c.shape[0]
    if not (1 <= n < 2**31 - 2**8 and 1 <= k < 2**31 and 1 <= d < _TILE_FLOATS):
        raise ValueError(f"unsupported sizes n={n}, k={k}, d={d}")
    tc = min(k, _TILE_FLOATS // (d + 1))
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    d2 = torch.empty((n,), dtype=torch.float32, device=dev)
    lib = _lib()
    code = lib.repro_assign_nearest(
        x.data_ptr(), c.data_ptr(), idx.data_ptr(), d2.data_ptr(), n, k, d,
        tc, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "assign_nearest")
    assign_nearest_cuda.launches += 1
    return idx, d2


assign_nearest_cuda.launches = 0


def assign_nearest_batched_cuda(x: torch.Tensor, c: torch.Tensor):
    """Launch the nearest-center kernel over machine blocks: ``x (m, per,
    d)`` against each machine's own centers ``c (m, k, d)``, contiguous
    float32 on one Hopper device; returns ``(idx (m, per) int32, d2 (m,
    per) f32)``. One launch for all machines; a machine's results are
    bitwise ``assign_nearest_cuda`` on its rows and centers."""
    dev = _build.require_hopper(x, c)
    if x.dim() != 3 or c.dim() != 3 or x.shape[0] != c.shape[0] \
            or x.shape[2] != c.shape[2]:
        raise ValueError(f"x must be (m, per, d) and c (m, k, d), got "
                         f"{tuple(x.shape)} and {tuple(c.shape)}")
    for name, t in (("x", x), ("c", c)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got "
                             f"{t.dtype}, contiguous={t.is_contiguous()}")
    m, per, d = x.shape
    k = c.shape[1]
    if not (1 <= m <= 65535 and 1 <= per < 2**31 - 2**8 and 1 <= k < 2**31
            and 1 <= d < _TILE_FLOATS):
        raise ValueError(f"unsupported sizes m={m}, per={per}, k={k}, d={d}")
    tc = min(k, _TILE_FLOATS // (d + 1))
    idx = torch.empty((m, per), dtype=torch.int32, device=dev)
    d2 = torch.empty((m, per), dtype=torch.float32, device=dev)
    lib = _lib()
    code = lib.repro_assign_nearest_batched(
        x.data_ptr(), c.data_ptr(), idx.data_ptr(), d2.data_ptr(), m, per, k,
        d, tc, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "assign_nearest_batched")
    assign_nearest_batched_cuda.launches += 1
    return idx, d2


assign_nearest_batched_cuda.launches = 0
