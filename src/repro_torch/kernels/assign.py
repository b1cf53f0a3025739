"""Nearest-center assignment kernel (CUDA C++, ``csrc/assign.cu``), with the
per-cluster sums folded in, and its plain versions.

Replaces the TPU kernel ``src/repro/kernels/assign.py``
``assign_nearest_blocks``: per row, the (argmin, min) of the clamped
``|x|^2 + |c|^2 - 2 x.c`` over all centers, without the (n, k) matrix.

Bound on the card: operations at large k·d (each row-center pair costs
~2·d + 5 f32 operations against 4·d + 8 bytes a row). The kernel is
register-tiled: a CTA walks stages of rows against centers staged once in
shared memory, a thread holds 8 rows × up to 8 centers of dot products,
and the center lanes of a row merge by (d2, center); its launch shape comes
from ``assign_plan``. The source says how ties and rounding follow the
plain version.

``assign_nearest_batched_cuda`` is the same kernel over m machine blocks,
each against its own centers, the machine a second grid axis: the weighted
round-1 reducer's assign (the JAX package vmaps the kernel over machines).

``assign_sums_cuda`` is the sums entry: the same pass, adding each row's
weight (or 1, into int32 counts) into its nearest center's slot in shared
memory, then one atomic a non-zero slot and CTA into the caller's sums. It
replaces the plain assign followed by ``index_add_`` (``ref.assign_sums``,
the JAX package's ``.at[idx].add``); ``engine.assign_sums`` takes it on
the kernel route. Each wrapper counts the launches it makes, and only
those.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .ref import assign_nearest as assign_nearest_ref  # noqa: F401
from .ref import assign_sums as assign_sums_ref  # noqa: F401

_P, _I = ctypes.c_void_p, ctypes.c_int
# Centers a shared-memory tile of the wide kernel holds: tile·(d + 1)
# floats within 32 KB.
_TILE_FLOATS = 8192
_ROWS = 128                # csrc/assign.cu kRows: rows of a sub-tile
_WIDE_THREADS = 128        # csrc/assign.cu kWideThreads: rows of a wide CTA
_STAGE_BYTES = 16 * 1024   # a row stage, about
# The sums' slots a CTA keeps in shared memory, at most; past them rows add
# into the global sums directly.
MAX_SMEM_BINS = 8192
# Largest row count a launch takes (int32 row arithmetic, stage rounding).
MAX_ROWS = 2**31 - 2**10
# Where the wide kernel is the faster one, measured on an H100 80GB HBM3
# (700 W) in one run of chip_smoke.py (phase 2b's routing lines) at 1e6
# rows: d <= 4 at every k (d = 2: 26 against 58 us at k = 25, 72 against
# 93 at k = 100), and small k·d (k = 25: up to d = 12, 73 against 87 us;
# the tiled kernel ahead from d = 16, and at k = 100 from d = 6). There
# the tiled kernel's fixed cost a row (norms, the merge of 16 center
# lanes) outweighs its pairs.
WIDE_MAX_D = 4
WIDE_MAX_KD = 400


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.library("assign")
    lib.repro_assign_nearest.argtypes = [_P] * 4 + [_I] * 9 + [_P]
    lib.repro_assign_nearest.restype = _I
    lib.repro_assign_nearest_batched.argtypes = [_P] * 4 + [_I] * 10 + [_P]
    lib.repro_assign_nearest_batched.restype = _I
    lib.repro_assign_sums.argtypes = [_P] * 6 + [_I] * 11 + [_P]
    lib.repro_assign_sums.restype = _I
    return lib


class AssignPlan(NamedTuple):
    tc: int          # centers a thread (tiles of 16·tc); 0: the wide kernel
    sub: int         # 128-row sub-tiles of a stage (the wide kernel: 0)
    chunk: int       # center tiles resident at once (wide: centers a tile)
    grid_x: int      # CTAs along a machine's rows
    smem: int        # dynamic shared bytes
    bins: bool       # the sums' k slots in shared memory


@functools.lru_cache(maxsize=1024)
def assign_plan(n: int, k: int, d: int, sms: int, m: int = 1,
                sums: bool = False) -> AssignPlan:
    """Launch shape of the nearest-center pass over ``m`` machines of ``n``
    rows and ``k`` centers on ``sms`` SMs. A stage holds 128·sub rows (sub =
    1..8, about 16 KB). The centers split into tiles of 16·tc (tc = 1..8):
    ceil(k / 128) tiles, as even as they allow; as many tiles stay resident
    in shared memory beside two row stages as fit (all where they fit, else
    chunks, restaged for each stage, with each row's best so far kept in
    shared memory), or smaller tiles where not one fits. With ``sums`` the
    k slots take shared memory too (up to ``MAX_SMEM_BINS``). The CTAs
    along the rows fill the SMs (two a SM, one where the shared memory
    holds no more). Where not even 16 centers fit (d past ~200), and where
    it was measured faster (d <= ``WIDE_MAX_D`` or k·d < ``WIDE_MAX_KD``),
    tc = 0 takes the wide kernel (one thread a row, tiles of up to 32 KB of
    centers)."""
    bins = sums and k <= MAX_SMEM_BINS
    bin_bytes = 4 * k if bins else 0
    sub = max(1, min(8, _STAGE_BYTES // (_ROWS * 4 * d)))
    rows_stage = _ROWS * sub
    # two row stages, their norms and the slots; a center tile's j-major
    # floats and norms; the centers' padding word a dim
    fixed = 4 * (2 * d * (rows_stage + 4) + rows_stage + d) + bin_bytes
    stages = -(-n // rows_stage)
    tiled = d > WIDE_MAX_D and k * d >= WIDE_MAX_KD
    for most in range(8 if tiled else 0, 0, -1):   # centers a thread, at most
        ctiles = -(-k // (16 * most))
        tc = -(-(-(-k // ctiles)) // 16)
        tile_bytes = 4 * 16 * tc * (d + 1)
        if fixed + ctiles * tile_bytes <= _build.SMEM_LIMIT:
            chunk, carried = ctiles, 0
        else:      # chunks of tiles, and each row's (d2, center) carried
            carried = 8 * rows_stage
            chunk = (_build.SMEM_LIMIT - fixed - carried) // tile_bytes
        if chunk >= 1:
            smem = fixed + chunk * tile_bytes + carried
            ctas = 2 if 2 * (smem + 1024) <= _build.SMEM_PER_SM else 1
            return AssignPlan(tc, sub, chunk,
                              max(1, min(stages, ctas * sms // m)), smem, bins)
    tile = min(k, _TILE_FLOATS // (d + 1))
    return AssignPlan(0, 0, tile, -(-n // _WIDE_THREADS),
                      4 * tile * (d + 1) + bin_bytes, bins)


def _check(x: torch.Tensor, c: torch.Tensor, batched: bool):
    """``x (n, d)`` and ``c (k, d)``, or ``x (m, per, d)`` and ``c (m, k,
    d)``: contiguous float32 of one width on one Hopper device. Returns
    ``(device, m, n, k, d)``."""
    dev = _build.require_hopper(x, c)
    dims = 3 if batched else 2
    if (x.dim() != dims or c.dim() != dims or x.shape[-1] != c.shape[-1]
            or (batched and x.shape[0] != c.shape[0])):
        want = "(m, per, d) and c (m, k, d)" if batched else "(n, d) and c (k, d)"
        raise ValueError(f"x must be {want}, got {tuple(x.shape)} and "
                         f"{tuple(c.shape)}")
    for name, t in (("x", x), ("c", c)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got "
                             f"{t.dtype}, contiguous={t.is_contiguous()}")
    m = x.shape[0] if batched else 1
    n, d = x.shape[-2], x.shape[-1]
    k = c.shape[-2]
    if not (1 <= m <= 65535 and 1 <= n < MAX_ROWS and 1 <= k < 2**31
            and 1 <= d < _TILE_FLOATS):
        raise ValueError(f"unsupported sizes m={m}, n={n}, k={k}, d={d}")
    return dev, m, n, k, d


def _plan(dev, m, n, k, d, sums: bool) -> AssignPlan:
    return assign_plan(n, k, d, _build.sm_count(dev.index), m, sums)


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def assign_sums_cuda(x: torch.Tensor, c: torch.Tensor, sums: torch.Tensor,
                     w: torch.Tensor | None = None, *, idx=None, d2=None):
    """Launch the sums entry: ``ref.assign_sums``'s contract. ``x (n, d)``
    against ``c (k, d)``, or machine blocks ``x (m, per, d)`` against their
    own ``c (m, k, d)``; adds each row's weight ``w`` (``(n,)`` / ``(m,
    per)`` float32) into ``sums (k,)`` / ``(m, k)`` float32, or, with no
    ``w``, 1 into int32 counts, at its nearest center, in place. ``idx``
    (int32) and ``d2`` (float32), each ``x``'s shape without ``d`` or
    ``None``, receive the assignment where given. Returns ``sums``."""
    batched = x.dim() == 3
    dev, m, n, k, d = _check(x, c, batched)
    rows, slots = ((m, n), (m, k)) if batched else ((n,), (k,))
    dtype = torch.int32 if w is None else torch.float32
    for name, t, shape, dt in (("sums", sums, slots, dtype),
                               ("w", w, rows, torch.float32),
                               ("idx", idx, rows, torch.int32),
                               ("d2", d2, rows, torch.float32)):
        if t is None:
            continue
        if (tuple(t.shape) != shape or t.dtype != dt or not t.is_contiguous()
                or t.device != dev):
            raise ValueError(f"{name} must be contiguous {dt} {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    plan = _plan(dev, m, n, k, d, True)
    lib = _lib()
    ptr = [None if t is None else t.data_ptr() for t in (w, idx, d2)]
    code = lib.repro_assign_sums(
        x.data_ptr(), c.data_ptr(), *ptr, sums.data_ptr(), m, n, k, d,
        int(plan.bins), plan.tc, plan.sub, plan.chunk, plan.grid_x, plan.smem,
        dev.index, _stream(dev))
    _build.check(lib, code, "assign_sums")
    _build.count_launch(assign_sums_cuda)
    return sums


assign_sums_cuda.launches = 0


def assign_outputs(x: torch.Tensor, c: torch.Tensor, *, batched: bool,
                   what: str):
    """One launch of the 2-D or batched entry: ``(idx, d2)`` of x's shape
    without ``d``. The wrappers below count it."""
    dev, m, n, k, d = _check(x, c, batched)
    idx = torch.empty(x.shape[:-1], dtype=torch.int32, device=dev)
    d2 = torch.empty(x.shape[:-1], dtype=torch.float32, device=dev)
    plan = _plan(dev, m, n, k, d, False)
    lib = _lib()
    ptrs = (x.data_ptr(), c.data_ptr(), idx.data_ptr(), d2.data_ptr())
    if batched:
        code = lib.repro_assign_nearest_batched(
            *ptrs, m, n, k, d, *plan[:5], dev.index, _stream(dev))
    else:
        code = lib.repro_assign_nearest(*ptrs, n, k, d, *plan[:5], dev.index,
                                        _stream(dev))
    _build.check(lib, code, what)
    return idx, d2


def assign_nearest_cuda(x: torch.Tensor, c: torch.Tensor):
    """Launch the nearest-center kernel: same contract as
    ``assign_nearest_ref``. ``x (n, d)`` and ``c (k, d)`` are contiguous
    float32 tensors on one Hopper device; returns ``(idx (n,) int32,
    d2 (n,) f32)``."""
    if x.dim() != 2:
        raise ValueError(f"x must be (n, d), got {tuple(x.shape)}")
    out = assign_outputs(x, c, batched=False, what="assign_nearest")
    _build.count_launch(assign_nearest_cuda)
    return out


assign_nearest_cuda.launches = 0


def assign_nearest_batched_cuda(x: torch.Tensor, c: torch.Tensor):
    """Launch the nearest-center kernel over machine blocks: ``x (m, per,
    d)`` against each machine's own centers ``c (m, k, d)``, contiguous
    float32 on one Hopper device; returns ``(idx (m, per) int32, d2 (m,
    per) f32)``. One launch for all machines; a machine's results are
    bitwise ``assign_nearest_cuda`` on its rows and centers."""
    if x.dim() != 3:
        raise ValueError(f"x must be (m, per, d), got {tuple(x.shape)}")
    out = assign_outputs(x, c, batched=True, what="assign_nearest_batched")
    _build.count_launch(assign_nearest_batched_cuda)
    return out


assign_nearest_batched_cuda.launches = 0
