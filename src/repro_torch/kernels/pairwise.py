"""Pairwise squared-distance kernel (CUDA C++, ``csrc/pairwise.cu``) and
its plain version.

Replaces the TPU kernel ``src/repro/kernels/pairwise.py``
``pairwise_dist2``: the full ``(n, m)`` matrix of clamped ``|x|^2 + |c|^2
- 2 x.c^T``, f16 or f32 inputs, f32 sums and output. Its callers:
``engine.pairwise_dist2`` and the streaming sketch's bootstrap
(``core/streaming.py``).

Bound on the card: the output's ``4·n·m`` bytes against ``2·d·n·m``
operations of the product. ``pairwise_plan`` picks one of three launches:
the large route, register-tiled f32 (128 × 128 output tiles, a thread 8 ×
8 outputs, the rows staged in double-buffered slabs); the small route, the
same kernel at 16 × 16 tiles for the streaming sketch's (k+1)² bootstrap;
and on f16 inputs past the small route, the product on the tensor cores
(``mma.sync``, f16 in, f32 sums). The f32 routes sum each dot
product with ``fmaf`` in j order as ``csrc/dist2.cuh`` does, so they agree
bitwise with each other and with the nearest-center kernels; the source
says how.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from . import ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_DTYPES = (torch.float32, torch.float16)
# csrc/pairwise.cu: the f16 kernel's 128 × 128 tile, staged in slabs of 64
# halves a row, 72 apart; its shared bytes (two x and two c stages, the 8
# warps' output staging of 16 rows of 72 floats, 256 norms).
_MMA_TILE = 128
_MMA_SLAB = 64
MMA_SMEM = 4 * _MMA_TILE * 72 * 2 + 8 * 16 * 72 * 4 + 2 * _MMA_TILE * 4
# Columns of d a slab stages, at most: the large route's two stages of
# LARGE_SLAB columns leave room for two CTAs a SM; the small route stages
# all of d where its two stages fit SMALL_WHOLE_BYTES, else slabs of
# SMALL_SLAB. d is cut into slabs of equal width.
LARGE_SLAB = 48
SMALL_WHOLE_BYTES = 48 * 1024
SMALL_SLAB = 64
# CTAs a SM of the register-tiled routes, at most (the large route's 8 × 8
# accumulators hold two: ~120 registers a thread).
LARGE_CTAS = 2
SMALL_CTAS = 3
# Persistent CTAs, each over a run of tiles with the x rows kept staged
# along a row of tiles, where d is one slab of at least PERSIST_MIN_D
# columns; else a CTA a tile, which measured faster at small d
# (chip_smoke.py's "pairwise grid" lines). Past one slab every tile copies
# its x rows anyway. The f16 kernel follows the same rule.
PERSIST_MIN_D = 16
# The boundary between the routes: the large route from this many of its
# 128 × 128 tiles, else 16 × 16 tiles; set from phase 2i's routing lines of
# chip_smoke.py (both sides timed).
LARGE_MIN_TILES = 16
MAX_TILES = 2**31 - 1      # the kernels count tiles in int


class PairwisePlan(NamedTuple):
    route: str       # "large", "small" or "mma"
    tr: int          # rows a thread (tile rows 16·tr)
    tc: int          # columns a thread (tile columns 16·tc)
    ks: int          # columns of d a staged slab (mma: 64 halves)
    tiles_m: int     # output tiles along m
    tiles: int       # output tiles
    grid: int        # CTAs, each over a run of tiles
    smem: int        # dynamic shared bytes


def _tiles(n: int, m: int, tr: int, tc: int) -> tuple[int, int]:
    """(tiles along m, all tiles) of an (n, m) output in 16·tr × 16·tc tiles."""
    tiles_m = -(-m // (16 * tc))
    return tiles_m, -(-n // (16 * tr)) * tiles_m


def _slab(d: int, most: int) -> int:
    """Columns of d a slab: d cut into equal slabs of at most ``most``."""
    return -(-d // -(-d // most))


@functools.lru_cache(maxsize=1024)
def pairwise_plan(n: int, m: int, d: int, half: bool, sms: int) -> PairwisePlan:
    """Launch shape of the pairwise kernel for ``x (n, d)`` against ``c (m,
    d)`` on ``sms`` SMs: the large route where its 128 × 128 tiles number
    at least ``LARGE_MIN_TILES`` (for f16 the tensor cores), else the small
    route at 16 × 16 tiles. A CTA takes a run of tiles, a row of tiles after another, with
    the next slab in flight: persistent CTAs (as many as fit the SMs, up to
    ``LARGE_CTAS`` or ``SMALL_CTAS`` a SM) where d is one slab of at least
    ``PERSIST_MIN_D`` columns, else a CTA a tile."""
    if _tiles(n, m, 8, 8)[1] >= LARGE_MIN_TILES:   # 8 × 8 outputs a thread
        route, tr, tc = ("mma" if half else "large"), 8, 8
    else:
        route, tr, tc = "small", 1, 1
    if route == "mma":
        tiles_m, tiles = _tiles(n, m, 8, 8)
        grid = tiles
        if PERSIST_MIN_D <= d <= _MMA_SLAB:
            grid = min(tiles, LARGE_CTAS * sms)
        return PairwisePlan(route, 8, 8, _MMA_SLAB, tiles_m, tiles, grid, MMA_SMEM)
    # floats of one stage column (the x rows', then the c rows', each padded
    # by 4) and of the norms
    col, norms = 16 * tr + 4 + 16 * tc + 4, 16 * (tr + tc)
    if route == "large":
        ks, most = _slab(d, LARGE_SLAB), LARGE_CTAS
    else:
        whole = 2 * 4 * col * d <= SMALL_WHOLE_BYTES
        ks, most = (d if whole else _slab(d, SMALL_SLAB)), SMALL_CTAS
    smem = 4 * (2 * ks * col + norms)
    tiles_m, tiles = _tiles(n, m, tr, tc)
    grid = tiles
    if ks == d >= PERSIST_MIN_D:
        ctas = max(1, min(most, _build.SMEM_PER_SM // (smem + 1024)))
        grid = min(tiles, ctas * sms)
    return PairwisePlan(route, tr, tc, ks, tiles_m, tiles, grid, smem)


def pairwise_dist2_ref(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The plain version: cast to f32 first, as the TPU kernel's body does
    (``src/repro/kernels/pairwise.py``), then ``ref.pairwise_dist2``."""
    return ref.pairwise_dist2(x.to(torch.float32), c.to(torch.float32))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.library("pairwise")
    lib.repro_pairwise_dist2.argtypes = [_P] * 3 + [_I] * 13 + [_P]
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
    half = x.dtype == torch.float16
    plan = (pairwise_plan(n, m, d, half, _build.sm_count(dev.index))
            if n >= 1 and m >= 1 and d >= 1 else None)
    if not (plan and n < 2**31 and m < 2**31 and d < 2**31
            and plan.tiles <= MAX_TILES):
        raise ValueError(f"unsupported sizes n={n}, m={m}, d={d}")
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    lib = _lib()
    code = lib.repro_pairwise_dist2(
        x.data_ptr(), c.data_ptr(), out.data_ptr(), n, m, d, int(half),
        int(plan.route == "mma"), plan.tr, plan.tc, plan.ks, plan.tiles_m,
        plan.tiles, plan.grid, plan.smem, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "pairwise_dist2")
    _build.count_launch(pairwise_dist2_cuda)
    return out


pairwise_dist2_cuda.launches = 0
