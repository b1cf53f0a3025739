"""Kernels of the streamed folds (CUDA C++) and their plain versions.

Replaces the TPU kernels of ``src/repro/kernels/fused_stream.py``, the
per-block passes of the source folds (``engine.fold_min_d2``,
``assign_nearest_source``, ``argmin_dist2_over_source``):

  * ``fused_filter_cuda`` (``csrc/fused_filter.cu``) for
    ``fused_filter_blocks``: ``new_ds = min(ds, min_j d2)`` and each tile's
    top-``rank`` of the masked ``new_ds``, at any rank (a 256-row tile
    gives at most 256 values; the wrapper fills the slots past them). At
    ``rank=1`` with no ``ds`` it is the covering-radius fold's block max
    of min-distances. ``filter_plan`` routes it to one of three kernels
    (register-tiled, small-d, one thread a row), all bitwise alike.
  * ``fused_filter_w_cuda`` (the same source's weighted entry) for
    ``fused_filter_blocks_w``: per-row weights ``w`` also gate candidacy
    (``w <= 0`` rows never enter the top-k; their ``ds`` still updates).
    It launches the same kernel, so with ``w > 0`` everywhere it is
    bitwise ``fused_filter_cuda``. The weighted folds
    (``engine.fold_top_k_min_d2(weighted=True)``) launch it.
  * ``fused_assign_cuda`` for ``fused_assign_blocks``: per row the nearest
    center, exactly kernel #2's function, so it launches
    ``csrc/assign.cu``'s kernel (the TPU needed a second kernel only
    because its assign tiles the centers over a sequential grid axis). A
    source's per-cluster counts or weight sums take the assign's sums entry
    instead (``engine.assign_sums_source``), one (k,) tensor for all
    blocks.
  * ``fused_argmin_cuda`` (``csrc/argmin_rows.cu``) for
    ``fused_argmin_blocks``: per center the nearest row, folded into a
    packed (d2, row) carry across blocks; register-tiled (8 rows × up to 8
    centers a thread), its launch shape from ``argmin_plan``.

All of them share ``csrc/dist2.cuh``, so every (row, center) pair rounds as in
``assign.cu`` and a streamed radius equals the in-memory one bitwise. The
plain versions are in ``ref.py``. Each wrapper counts its launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .assign import _ROWS, _TILE_FLOATS, assign_outputs
from .ref import BIG, FILTER_TILE_ROWS, NEG
from .ref import assign_nearest as fused_assign_ref  # noqa: F401
from .ref import fused_argmin as fused_argmin_ref  # noqa: F401
from .ref import fused_filter as fused_filter_ref  # noqa: F401

_P, _I = ctypes.c_void_p, ctypes.c_int
# The argmin carry before any row: (+3.4e38, row 0), packed as
# float bits << 32 | row; every finite d2 >= +0 packs below it.
_CARRY_INIT = int(np.array(BIG, np.float32).view(np.uint32)) << 32


@functools.lru_cache(maxsize=None)
def _filter_lib():
    lib = _build.library("fused_filter")
    lib.repro_fused_filter.argtypes = [_P] * 5 + [_I] * 11 + [_P]
    lib.repro_fused_filter.restype = _I
    lib.repro_fused_filter_w.argtypes = [_P] * 6 + [_I] * 11 + [_P]
    lib.repro_fused_filter_w.restype = _I
    lib.repro_filter_tile_rows.restype = _I
    if lib.repro_filter_tile_rows() != FILTER_TILE_ROWS:
        raise RuntimeError("csrc/fused_filter.cu disagrees with "
                           "FILTER_TILE_ROWS")
    return lib


@functools.lru_cache(maxsize=None)
def _argmin_lib():
    lib = _build.library("argmin_rows")
    lib.repro_argmin_rows.argtypes = [_P] * 3 + [_I] * 9 + [_P]
    lib.repro_argmin_rows.restype = _I
    lib.repro_argmin_ctas_per_sm.argtypes = [_I, _I]
    lib.repro_argmin_ctas_per_sm.restype = _I
    return lib


def argmin_ctas_per_sm(tc: int, smem: int) -> int:
    """CTAs of the tiled argmin kernel (``tc`` centers a thread) that one SM
    of the current device holds at ``smem`` dynamic bytes (``argmin_plan``
    counts on 2)."""
    ctas = _argmin_lib().repro_argmin_ctas_per_sm(tc, smem)
    if ctas < 0:
        _build.check(_argmin_lib(), -ctas, "argmin_rows occupancy")
    return ctas


class ArgminPlan(NamedTuple):
    tc: int          # centers a thread (16·tc a CTA); 0: the wide kernel
    sub: int         # 128-row sub-tiles of a stage
    ctiles: int      # center tiles (the grid's second axis)
    grid_x: int      # CTAs along the rows
    smem: int        # dynamic shared bytes (the tiled kernel)


_ARGMIN_ROWS = 128              # csrc/argmin_rows.cu kRows
_ARGMIN_STAGE_BYTES = 16 * 1024
_ARGMIN_KEYS_BYTES = 4 * 128 * 8  # the tiled kernel's static shared keys


@functools.lru_cache(maxsize=1024)
def argmin_plan(n: int, m: int, d: int, sms: int) -> ArgminPlan:
    """Launch shape of the per-center argmin on ``sms`` SMs. A stage holds
    128·sub rows (sub = 1..8, about 16 KB). The centers split into tiles of
    16·tc (tc = 1..8): ceil(m / 128) tiles, as even as they allow, or more
    and smaller tiles where two row stages and the center tile would not
    fit a block's shared memory. The CTAs along the rows fill the SMs (two
    a SM, one where the shared memory holds no more). Where not even 16
    centers fit (d past 202), tc = 0 takes the wide kernel (4 CTAs a SM,
    tiles of up to 1,024 rows and 32 KB)."""
    sub = max(1, min(8, _ARGMIN_STAGE_BYTES // (_ARGMIN_ROWS * 4 * d)))
    rows_stage = _ARGMIN_ROWS * sub
    for most in range(8, 0, -1):       # centers a thread, at most
        ctiles = -(-m // (16 * most))
        tc = -(-(-(-m // ctiles)) // 16)
        smem = 4 * (2 * d * (rows_stage + 4) + rows_stage + d * (16 * tc + 1)
                    + 16 * tc)
        if smem + _ARGMIN_KEYS_BYTES <= _build.SMEM_LIMIT:
            fit = 2 * (smem + _ARGMIN_KEYS_BYTES + 1024) <= _build.SMEM_PER_SM
            ctas = 2 if fit else 1
            stages = -(-n // rows_stage)
            return ArgminPlan(tc, sub, ctiles,
                              min(stages, -(-ctas * sms // ctiles)), smem)
    tile = min(1024, _TILE_FLOATS // (d + 1))
    return ArgminPlan(0, 0, 1, min(-(-n // tile), 4 * sms), 0)


class FilterPlan(NamedTuple):
    route: int       # ROUTE_TILED, ROUTE_SMALL or ROUTE_WIDE
    tc: int          # tiled: centers a thread (tiles of 16·tc); small: the
                     # register width D (2, 4 or 8); wide: 0
    sub: int         # tiled: 128-row sub-tiles of a stage (2: a stage is a
                     # tile; 1: a tile is two stages); else 0
    chunk: int       # tiled: center tiles resident at once; small: centers
                     # a shared chunk; wide: centers a shared tile
    grid_x: int      # CTAs
    smem: int        # dynamic shared bytes


ROUTE_WIDE, ROUTE_SMALL, ROUTE_TILED = 0, 1, 2
_SMALL_TILES = 4            # csrc/fused_filter.cu kSmallTiles: tiles a CTA
_SMALL_CENTER_F4 = 2048     # float4 of centers a small-d chunk, 32 KB
# Where each filter kernel is the faster one, measured on an H100 80GB
# HBM3 (700 W) by chip_smoke.py's filter routing lines (phase 2c) at 1e6
# rows, rank 1: the small-d kernel up to d = SMALL_MAX_D (it takes up to
# 8; k = 25, d = 8: 30 us against 46 for the one-thread-a-row kernel and
# 64 for the tiled one), past it the tiled kernel from k·d = TILED_MIN_KD
# (k = 25, d = 16: 86 against 98 us; k = 100, d = 12: 138 against 238)
# and the one-thread-a-row kernel below it (k = 25, d = 12: 73 against
# 75 us) and where a 16-center tile does not fit (d past ~200).
SMALL_MAX_D = 8
TILED_MIN_KD = 400


def _filter_tiled(n: int, k: int, d: int, sms: int, sub: int):
    """The tiled filter kernel's plan at 128·sub-row stages, or None where
    not even one 16-center tile fits beside two stages. Its shared memory:
    two row stages and their norms, the tile's 256 candidates, as many
    center tiles (j-major floats and norms) as fit, in chunks with each
    row's min so far carried where not all do."""
    rows_stage = _ROWS * sub
    fixed = 4 * (2 * d * (rows_stage + 4) + rows_stage + FILTER_TILE_ROWS + d)
    for most in range(8, 0, -1):       # centers a thread, at most
        ctiles = -(-k // (16 * most))
        tc = -(-(-(-k // ctiles)) // 16)
        tile_bytes = 4 * 16 * tc * (d + 1)
        if fixed + ctiles * tile_bytes <= _build.SMEM_LIMIT:
            chunk, carried = ctiles, 0
        else:
            carried = 4 * rows_stage
            chunk = (_build.SMEM_LIMIT - fixed - carried) // tile_bytes
        if chunk >= 1:
            smem = fixed + chunk * tile_bytes + carried
            ctas = 2 if 2 * (smem + 1024) <= _build.SMEM_PER_SM else 1
            tiles = -(-n // FILTER_TILE_ROWS)
            return FilterPlan(ROUTE_TILED, tc, sub, chunk,
                              min(tiles, ctas * sms), smem)
    return None


@functools.lru_cache(maxsize=1024)
def filter_plan(n: int, k: int, d: int, sms: int) -> FilterPlan:
    """Launch shape of the filter over ``n`` rows and ``k`` centers on
    ``sms`` SMs. Up to d = ``SMALL_MAX_D``, the small-d kernel: a CTA holds
    4 tiles, a row of each a thread, and stages the centers once as float4
    (coordinates padded with zeros to D, then the norm; chunks of up to 32
    KB). From k·d = ``TILED_MIN_KD``, the tiled kernel: 256-row stages (a
    stage a tile) where two of them, all the centers and the candidates fit
    two CTAs a SM, else 128-row stages (a tile two stages of one CTA); the
    CTAs (two a SM, one where the shared memory holds no more) grid-stride
    over tiles. Elsewhere, and where not even a 16-center tile fits (d past
    ~200), the one-thread-a-row kernel, a tile a CTA."""
    tiles = -(-n // FILTER_TILE_ROWS)
    if d <= SMALL_MAX_D:
        width = 2 if d <= 2 else 4 if d <= 4 else 8
        per = width // 4 + 1                   # float4 a center
        kc = min(k, _SMALL_CENTER_F4 // per)
        return FilterPlan(ROUTE_SMALL, width, 0, kc,
                          -(-tiles // _SMALL_TILES), 16 * per * kc)
    if k * d >= TILED_MIN_KD:
        plan = _filter_tiled(n, k, d, sms, 2)
        if (plan is None or 2 * (plan.smem + 1024) > _build.SMEM_PER_SM
                or 16 * plan.tc * plan.chunk < k):
            plan = _filter_tiled(n, k, d, sms, 1)
        if plan is not None:
            return plan
    tc = min(k, _TILE_FLOATS // (d + 1))
    return FilterPlan(ROUTE_WIDE, 0, 0, tc, tiles, 4 * tc * (d + 1))


def _check_points(x: torch.Tensor, c: torch.Tensor):
    """Points ``x (n, d)`` and centers ``c (k, d)``: contiguous float32
    matrices of one width. Returns ``(n, d, k)``."""
    for name, t in (("x", x), ("c", c)):
        if t.dim() != 2 or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 matrix, "
                             f"got {t.dtype} {tuple(t.shape)}, "
                             f"contiguous={t.is_contiguous()}")
    if c.shape[1] != x.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and c {tuple(c.shape)} differ in d")
    return x.shape[0], x.shape[1], c.shape[0]


def _filter_launch(entry: str, x, c, ds, hm, w, rank: int):
    """Checks, outputs and the launch shared by the filter entries."""
    dev = _build.require_hopper(
        x, c, *(t for t in (ds, hm, w) if t is not None))
    n, d, k = _check_points(x, c)
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    if not (1 <= n < 2**31 - FILTER_TILE_ROWS and 1 <= k < 2**31
            and 1 <= d < _TILE_FLOATS):
        raise ValueError(f"unsupported sizes n={n}, k={k}, d={d}")
    for name, t, dtype in (("ds", ds, torch.float32), ("hm", hm, torch.bool),
                           ("w", w, torch.float32)):
        if t is not None and (t.shape != (n,) or t.dtype != dtype
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {dtype} ({n},)")
    plan = filter_plan(n, k, d, _build.sm_count(dev.index))
    ntiles = -(-n // FILTER_TILE_ROWS)
    tops = torch.empty((ntiles, rank), dtype=torch.float32, device=dev)
    if rank > FILTER_TILE_ROWS:
        # a tile has FILTER_TILE_ROWS candidates; the kernel writes as many
        tops[:, FILTER_TILE_ROWS:] = NEG
    lib = _filter_lib()
    ptrs = [x.data_ptr(), c.data_ptr(), None if ds is None else ds.data_ptr(),
            None if hm is None else hm.data_ptr()]
    if w is not None:
        ptrs.append(w.data_ptr())
    code = getattr(lib, entry)(
        *ptrs, tops.data_ptr(), n, k, d, rank, *plan, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, entry)
    return ds, tops


def fused_filter_cuda(x: torch.Tensor, c: torch.Tensor, ds=None, hm=None, *,
                      rank: int):
    """Launch the filter kernel: same contract as ``fused_filter_ref``.

    ``x (n, d)`` and ``c (k, d)`` contiguous float32; ``ds (n,)`` float32,
    updated in place, or ``None`` (+3.4e38, and no ``ds`` is written);
    ``hm (n,)`` bool or ``None`` (every row a candidate); any ``rank >=
    1``. Returns ``(ds, tops (ceil(n / 256), rank))``."""
    out = _filter_launch("repro_fused_filter", x, c, ds, hm, None, rank)
    _build.count_launch(fused_filter_cuda)
    return out


fused_filter_cuda.launches = 0


def fused_filter_w_cuda(x: torch.Tensor, c: torch.Tensor, ds=None, hm=None,
                        *, w: torch.Tensor, rank: int):
    """Launch the weighted filter kernel: ``fused_filter_cuda`` whose
    candidates are also gated by the row weights ``w (n,)`` contiguous
    float32 (``w > 0``); same contract as ``fused_filter_ref(..., w=w)``.
    Counted apart from ``fused_filter_cuda``."""
    if w is None:
        raise ValueError("the weighted filter needs w")
    out = _filter_launch("repro_fused_filter_w", x, c, ds, hm, w, rank)
    _build.count_launch(fused_filter_w_cuda)
    return out


fused_filter_w_cuda.launches = 0


def fused_assign_cuda(x: torch.Tensor, c: torch.Tensor):
    """Launch the nearest-center kernel of ``csrc/assign.cu`` for a
    streamed block: ``(idx (n,) int32, d2 (n,) f32)``, same contract as
    ``fused_assign_ref``. Counted apart from ``assign_nearest_cuda``."""
    if x.dim() != 2:
        raise ValueError(f"x must be (n, d), got {tuple(x.shape)}")
    out = assign_outputs(x, c, batched=False, what="fused_assign")
    _build.count_launch(fused_assign_cuda)
    return out


fused_assign_cuda.launches = 0


def argmin_carry(m: int, device) -> torch.Tensor:
    """A fresh (m,) argmin carry: (d2 = +3.4e38, row 0), packed in int64
    as float bits << 32 | row."""
    return torch.full((m,), _CARRY_INIT, dtype=torch.int64, device=device)


def unpack_argmin(carry: torch.Tensor):
    """``(best_d (m,) f32, best_i (m,) int32)`` of a packed carry."""
    best_d = (carry >> 32).to(torch.int32).view(torch.float32)
    return best_d, (carry & 0xFFFFFFFF).to(torch.int32)


def fused_argmin_cuda(x: torch.Tensor, c: torch.Tensor, carry: torch.Tensor,
                      off: int = 0) -> torch.Tensor:
    """Launch the per-center argmin kernel over the rows of ``x (n, d)``,
    numbered from ``off``, folded into ``carry`` (``argmin_carry``) in
    place: a row takes a center's slot when its (d2, global row) is smaller,
    so over any blocks in any order the carry ends at the first nearest
    row. Returns ``carry``."""
    dev = _build.require_hopper(x, c, carry)
    n, d, m = _check_points(x, c)
    if (carry.shape != (m,) or carry.dtype != torch.int64
            or not carry.is_contiguous()):
        raise ValueError(f"carry must be contiguous int64 ({m},)")
    if not (0 <= off and off + n < 2**31 and 1 <= m < 2**31
            and 1 <= d < _TILE_FLOATS):
        raise ValueError(f"unsupported sizes off={off}, n={n}, m={m}, d={d}")
    if n == 0:
        return carry
    plan = argmin_plan(n, m, d, _build.sm_count(dev.index))
    lib = _argmin_lib()
    code = lib.repro_argmin_rows(
        x.data_ptr(), c.data_ptr(), carry.data_ptr(), n, m, d, off, plan.tc,
        plan.sub, plan.grid_x, plan.smem, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "argmin_rows")
    _build.count_launch(fused_argmin_cuda)
    return carry


fused_argmin_cuda.launches = 0
