"""Pairwise squared-distance kernel (CUDA C++, ``csrc/pairwise.cu``) and
its plain version.

Replaces the TPU kernel ``src/repro/kernels/pairwise.py``
``pairwise_dist2``: the full ``(n, m)`` matrix of clamped ``|x|^2 + |c|^2
- 2 x.c^T``, f16 or f32 inputs converted to f32 inside, f32 accumulation
and output. Its callers: ``engine.pairwise_dist2`` and the streaming
sketch's bootstrap (``core/streaming.py``).

Bound on the card: the output's ``4·n·m`` bytes against ``2·d·n·m``
operations outside the tensor cores (no TF32). The kernel gives a block a
64 x 64 output tile and a thread a 4 x 4 block of it, the dot products
accumulated with ``fmaf`` in j order as in ``csrc/dist2.cuh``; the source
says how.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_DTYPES = (torch.float32, torch.float16)


def pairwise_dist2_ref(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The plain version: cast to f32 first, as the TPU kernel's body does
    (``src/repro/kernels/pairwise.py``), then ``ref.pairwise_dist2``."""
    return ref.pairwise_dist2(x.to(torch.float32), c.to(torch.float32))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.library("pairwise")
    lib.repro_pairwise_dist2.argtypes = [_P] * 3 + [_I] * 5 + [_P]
    lib.repro_pairwise_dist2.restype = _I
    return lib


def pairwise_dist2_cuda(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Launch the pairwise kernel: same contract as ``pairwise_dist2_ref``.
    ``x (n, d)`` and ``c (m, d)`` are contiguous, both float32 or both
    float16, on one Hopper device; returns ``(n, m)`` float32."""
    dev = _build.require_hopper(x, c)
    if x.dim() != 2 or c.dim() != 2 or x.shape[1] != c.shape[1]:
        raise ValueError(f"x must be (n, d) and c (m, d), got "
                         f"{tuple(x.shape)} and {tuple(c.shape)}")
    if x.dtype not in _DTYPES or c.dtype != x.dtype:
        raise ValueError(f"x and c must both be float32 or both float16, "
                         f"got {x.dtype} and {c.dtype}")
    if not (x.is_contiguous() and c.is_contiguous()):
        raise ValueError("x and c must be contiguous")
    n, d = x.shape
    m = c.shape[0]
    if not (1 <= n < 2**31 - 64 and 1 <= m <= 65535 * 64 and d >= 1
            and n * m < 2**62):
        raise ValueError(f"unsupported sizes n={n}, m={m}, d={d}")
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    lib = _lib()
    code = lib.repro_pairwise_dist2(
        x.data_ptr(), c.data_ptr(), out.data_ptr(), n, m, d,
        int(x.dtype == torch.float16), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "pairwise_dist2")
    pairwise_dist2_cuda.launches += 1
    return out


pairwise_dist2_cuda.launches = 0
