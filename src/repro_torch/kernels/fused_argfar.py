"""GON step kernel (CUDA C++, ``csrc/gon_step.cu``) and its plain version.

Replaces the TPU kernel ``src/repro/kernels/fused_argfar.py``
``fused_min_argmax_blocks``: distance of every row to the new center,
running-min update and farthest row, fused into one pass over the points.
Here the pass is batched over a leading axis of m machine blocks, which the
JAX package maps with ``jax.vmap`` and a hand-written kernel cannot.

Bound on the card: bytes (x read once, md read and written once). The
kernel gives one thread to a row and merges per-tile (max, first argmax)
partials in a second, ordered reduction per machine; the source says how.
Unlike the JAX kernel it updates ``md`` in place.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import fused_min_argmax as fused_min_argmax_ref  # noqa: F401

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.library("gon_step")
    lib.repro_gon_step.argtypes = [_P] * 7 + [_I] * 4 + [_P]
    lib.repro_gon_step.restype = _I
    lib.repro_gon_tile_rows.restype = _I
    return lib


def fused_min_argmax_cuda(x: torch.Tensor, c: torch.Tensor,
                          md: torch.Tensor):
    """Launch the GON-step kernel: same contract as ``fused_min_argmax_ref``.

    ``x (m, per, d)``, ``c (m, d)`` and ``md (m, per)`` are contiguous
    float32 tensors on one Hopper device. ``md`` is updated in place and
    returned with ``far_val (m,) f32`` and ``far_idx (m,) int32``.
    """
    dev = _build.require_hopper(x, c, md)
    if x.dim() != 3:
        raise ValueError(f"x must be (m, per, d), got shape {tuple(x.shape)}")
    m, per, d = x.shape
    if tuple(c.shape) != (m, d) or tuple(md.shape) != (m, per):
        raise ValueError(f"shapes x {tuple(x.shape)}, c {tuple(c.shape)}, "
                         f"md {tuple(md.shape)} do not match")
    for name, t in (("x", x), ("c", c), ("md", md)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got "
                             f"{t.dtype}, contiguous={t.is_contiguous()}")
    if not (1 <= m <= 65535 and 1 <= per < 2**31 - 2**12 and d >= 1):
        raise ValueError(f"unsupported sizes m={m}, per={per}, d={d}")
    lib = _lib()
    tile = lib.repro_gon_tile_rows()
    ntiles = -(-per // tile)
    part_v = torch.empty((m, ntiles), dtype=torch.float32, device=dev)
    part_i = torch.empty((m, ntiles), dtype=torch.int32, device=dev)
    far_v = torch.empty((m,), dtype=torch.float32, device=dev)
    far_i = torch.empty((m,), dtype=torch.int32, device=dev)
    code = lib.repro_gon_step(
        x.data_ptr(), c.data_ptr(), md.data_ptr(), part_v.data_ptr(),
        part_i.data_ptr(), far_v.data_ptr(), far_i.data_ptr(), m, per, d,
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "gon_step")
    fused_min_argmax_cuda.launches += 1
    return md, far_v, far_i


fused_min_argmax_cuda.launches = 0
