"""Dispatch between the hand-written CUDA kernels and their plain versions,
and the streamed folds over point sources (port of ``repro.kernels.engine``).

Every op takes ``impl``:

  * ``"auto"``   — the CUDA kernel for a CUDA tensor, the plain PyTorch
    version for a CPU tensor;
  * ``"kernel"`` — the CUDA kernel; raises on a CPU tensor;
  * ``"ref"``    — the plain version, on any device (the tests and the
    on-card comparisons ask for it explicitly).

The kernel route needs a CUDA tensor on a device of compute capability 9.x
(``_build.require_hopper``); it launches the kernel or raises, and never
falls back to the plain version.

The source folds (``fold_min_d2``, ``fold_top_k_min_d2``,
``assign_nearest_source``, ``assign_sums_source``,
``argmin_dist2_over_source``) stream a point
source in super-shards of ``block_rows`` rows through its upload ring, so
at most ``1 + prefetch`` blocks are device-resident (``resolve_block_rows``'
residency model), and fold each block into O(m)- or O(rank)-sized state on
the device: no per-block value is read back to the host. The weighted
folds take each block's row weights from the same ring slot as its points
(``_weighted_source_blocks``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import as_points, resolve_device, upload

from . import ref
from .assign import (assign_nearest_batched_cuda, assign_nearest_cuda,
                     assign_sums_cuda)
from .fused_argfar import GonWorkspace, fused_min_argmax_cuda
from .fused_stream import (argmin_carry, fused_argmin_cuda, fused_assign_cuda,
                           fused_filter_cuda, fused_filter_w_cuda,
                           unpack_argmin)
from .pairwise import pairwise_dist2_cuda, pairwise_dist2_ref

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


def pairwise_dist2(x, c, *, impl: str = "auto", chunk: int | None = None):
    """``(n, d), (m, d) -> (n, m)`` squared distances, f32 or f16 inputs
    computed in f32 (see ``pairwise.pairwise_dist2_ref``). ``chunk`` is not
    ported yet and raises."""
    if chunk is not None:
        raise NotImplementedError("chunk (row-chunked passes) is not ported yet")
    if _resolve(impl, x):
        return pairwise_dist2_cuda(x, c)
    return pairwise_dist2_ref(x, c)


def gon_workspace(m: int, x, *, impl: str = "auto"):
    """Scratch for a GON run of ``m`` machines over ``x``: a
    ``GonWorkspace`` on the kernel route (made once a run, so that a step
    allocates nothing), ``None`` on the plain one."""
    return GonWorkspace(m, x.device) if _resolve(impl, x) else None


def fused_min_argmax(x, c, md, *, impl: str = "auto", ws=None, centers=None,
                     indices=None, slot: int = -1, carry=None, off: int = 0,
                     reset: bool = False):
    """Batched GON step: ``x (m, per, d)``, ``c (m, d)``, ``md (m, per)`` ->
    ``(md, far_val (m,), far_idx (m,) int32)``. ``md`` is updated in place
    on both routes. Rows whose ``md`` is -3.4e38 (padding, masked rows)
    stay so and never win unless every row of a machine is such a row.
    The next center goes to a ``centers``/``indices`` slot and a streamed
    pass's ``carry`` on the device (see ``ref.fused_min_argmax``); ``ws``
    is the run's ``gon_workspace``, whose buffers hold the kernel route's
    ``far_val``/``far_idx`` until its next step."""
    out = dict(centers=centers, indices=indices, slot=slot, carry=carry,
               off=off, reset=reset)
    if _resolve(impl, x):
        return fused_min_argmax_cuda(x, c, md, ws=ws, **out)
    return ref.fused_min_argmax(x, c, md, **out)


def assign_nearest(x, c, *, impl: str = "auto"):
    """Nearest-center assignment: ``(idx (n,) int32, d2 (n,))``."""
    if _resolve(impl, x):
        return assign_nearest_cuda(x, c)
    return ref.assign_nearest(x, c)


def assign_nearest_batched(x, c, *, impl: str = "auto"):
    """Nearest-center assignment of machine blocks ``x (m, per, d)``, each
    against its own centers ``c (m, k, d)``: ``(idx (m, per) int32, d2
    (m, per))``, one launch for all machines on the card."""
    if _resolve(impl, x):
        return assign_nearest_batched_cuda(x, c)
    return ref.assign_nearest(x, c)


def assign_sums(x, c, sums, w=None, *, impl: str = "auto"):
    """Add each row's weight ``w`` (f32 sums), or 1 (int32 counts,
    ``w=None``), into the slot of its nearest center, in place: ``x (n,
    d)`` against ``c (k, d)`` into ``sums (k,)``, or machine blocks ``x (m,
    per, d)`` against their own ``c (m, k, d)`` into ``sums (m, k)``.
    Returns ``sums``. One launch of the assign's sums entry on the card;
    the plain route is the assign, then ``index_add_``
    (``ref.assign_sums``)."""
    if _resolve(impl, x):
        return assign_sums_cuda(x, c, sums, w)
    return ref.assign_sums(x, c, sums, w)


def argmin_dist2_over_rows(x, c, *, impl: str = "auto"):
    """For each center row of ``c (m, d)``, the index of the nearest row of
    ``x (n, d)``, first row on ties. The kernel route is the per-center
    argmin on one block from a fresh carry (many rows against few
    centers); the plain route ``assign_nearest(c, x)[0]``. Each pair rounds
    as in the assign (``csrc/dist2.cuh``), so the two kernels agree."""
    if _resolve(impl, x):
        return fused_argmin(x, c, impl="kernel")[1]
    return ref.assign_nearest(c, x)[0]


def fused_filter(x, c, ds=None, hm=None, *, rank: int, w=None,
                 impl: str = "auto"):
    """The streamed filter step on one block: ``(ds, tops (tiles, rank))``
    (see ``ref.fused_filter``); ``ds`` is updated in place. With row
    weights ``w`` the weighted kernel runs: ``w <= 0`` rows are out of
    top-k candidacy."""
    if _resolve(impl, x):
        if w is None:
            return fused_filter_cuda(x, c, ds, hm, rank=rank)
        return fused_filter_w_cuda(x, c, ds, hm, w=w, rank=rank)
    return ref.fused_filter(x, c, ds, hm, rank=rank, w=w)


def fused_assign(x, c, *, impl: str = "auto"):
    """Nearest center of every row of a streamed block: ``(idx (n,) int32,
    d2 (n,))`` (the streamed kernel; ``assign_nearest``'s function)."""
    if _resolve(impl, x):
        return fused_assign_cuda(x, c)
    return ref.assign_nearest(x, c)


def fused_argmin(x, c, *, impl: str = "auto"):
    """For each center, the nearest row of one block: ``(best_d (m,),
    best_i (m,) int32)``, first row on ties (see ``ref.fused_argmin``)."""
    if _resolve(impl, x):
        carry = fused_argmin_cuda(x, c, argmin_carry(c.shape[0], x.device))
        return unpack_argmin(carry)
    return ref.fused_argmin(x, c)


# ---------------------------------------------------------------------------
# streamed folds over a point source
# ---------------------------------------------------------------------------

DEFAULT_BLOCK_ROWS = 1 << 16
# Lookahead of the sources' upload ring (repro_torch/data/source.py); at
# the peak 1 + DEFAULT_PREFETCH blocks are device-resident.
DEFAULT_PREFETCH = 2


def resolve_block_rows(n: int, d: int, *, block_rows: int | None = None,
                       memory_budget: int | None = None,
                       default: int = DEFAULT_BLOCK_ROWS,
                       prefetch: int = DEFAULT_PREFETCH) -> int:
    """Super-shard size for streaming an ``(n, d)`` source.

    Explicit ``block_rows`` wins (clipped to ``[1, n]``). Otherwise a
    ``memory_budget`` in bytes is solved against the f32 residency model
    ``(1 + prefetch) · 4·rows·(d + 1)``: the consumed block and up to
    ``prefetch`` blocks in flight, each with one per-row carry. Falls back
    to ``DEFAULT_BLOCK_ROWS``."""
    if block_rows is not None:
        if block_rows < 1:
            raise ValueError(f"block_rows must be >= 1, got {block_rows}")
        return min(int(block_rows), max(n, 1))
    if prefetch < 1:
        raise ValueError(f"prefetch must be >= 1, got {prefetch}")
    if memory_budget is not None:
        rows = memory_budget // (4 * (1 + prefetch) * (d + 1))
        if rows < 1:
            raise ValueError(
                f"memory_budget={memory_budget} cannot hold even one "
                f"{d}-dim row per buffer ({4 * (1 + prefetch) * (d + 1)} "
                f"bytes/row across {1 + prefetch} ring slots)")
        return min(int(rows), max(n, 1))
    return min(default, max(n, 1))


def host_blocks_of(source, rows: int):
    """Numpy host blocks of any source: its ``host_blocks`` where it has
    them, else its blocks on the CPU."""
    if hasattr(source, "host_blocks"):
        for blk in source.host_blocks(rows):
            yield np.asarray(blk, np.float32)
        return
    for blk in source.blocks(rows, device="cpu"):
        yield blk.numpy()


def _source_blocks(source, rows: int, prefetch: int | None, device):
    """``source.blocks(rows)`` on ``device`` through a ring ``prefetch``
    blocks deep (``None``: the default depth)."""
    return source.blocks(rows, prefetch=prefetch or DEFAULT_PREFETCH,
                         device=device)


def top_k_init(k: int, device=None) -> torch.Tensor:
    """Identity carry of ``merge_top_k``: k slots at -3.4e38."""
    return torch.full((k,), ref.NEG, dtype=torch.float32,
                      device=resolve_device(device))


def merge_top_k(carry: torch.Tensor, vals: torch.Tensor, k: int):
    """Merge a block's values into a running descending top-k. Top-k
    values of a multiset do not depend on the blocking. ``carry`` holds k
    values, so the merged set never has fewer than k (``torch.topk`` on
    CUDA raises past the input's length)."""
    return torch.topk(torch.cat([carry, vals.reshape(-1)]), k).values


def fold_top_k(value_blocks, k: int, device=None) -> torch.Tensor:
    """Top-k values over an iterable of value blocks (descending, padded
    with -3.4e38 when fewer than k values exist)."""
    top = top_k_init(k, device)
    for v in value_blocks:
        top = merge_top_k(top, torch.as_tensor(v, device=top.device), k)
    return top


def _fold_setup(source, c, block_rows, memory_budget, prefetch, device):
    dev = resolve_device(device)
    rows = resolve_block_rows(source.n, source.d, block_rows=block_rows,
                              memory_budget=memory_budget,
                              prefetch=prefetch or DEFAULT_PREFETCH)
    return dev, rows, as_points(c, dev)


def _source_weights(source, start: int, rows: int) -> np.ndarray:
    """Per-row f32 weights of rows ``[start, start + rows)``, duck-typed:
    a source without a ``weights_of`` method has unit weights.
    ``repro_torch.data.source.weights_of`` is the public form of the same
    contract."""
    fn = getattr(source, "weights_of", None)
    if fn is None:
        return np.ones((int(rows),), np.float32)
    w = np.asarray(fn(start, rows), np.float32).reshape(-1)
    if w.shape[0] != rows:
        raise ValueError(
            f"weights_of({start}, {rows}) returned {w.shape[0]} weights")
    return w


def _weighted_source_blocks(source, rows: int, prefetch: int | None, device):
    """``(points, weights)`` blocks of a source on ``device``: a
    ``WeightedSource``'s ``weighted_blocks`` (the weights ride in the
    points' ring slot); another source's blocks with its ``weights_of``
    uploaded block by block through pinned memory; unit weights made on
    the device for a source without weights."""
    if hasattr(source, "weighted_blocks"):
        yield from source.weighted_blocks(
            rows, prefetch=prefetch or DEFAULT_PREFETCH, device=device)
        return
    weighted = hasattr(source, "weights_of")
    off = 0
    for blk in _source_blocks(source, rows, prefetch, device):
        nb = blk.shape[0]
        if weighted:
            w = upload(_source_weights(source, off, nb), blk.device)
        else:
            w = torch.ones((nb,), dtype=torch.float32, device=blk.device)
        yield blk, w
        off += nb


def fold_min_d2(source, c, *, impl: str = "auto",
                block_rows: int | None = None,
                memory_budget: int | None = None,
                prefetch: int | None = None, weighted: bool = False,
                device=None) -> torch.Tensor:
    """Max over all source points of the min squared distance to ``c``:
    the squared covering radius as a streamed fold, equal to the
    in-memory ``max(assign_nearest(x, c)[1])`` for any blocking.

    Each block is one filter step at ``rank=1`` with no ``ds`` carry, and
    the block maxima combine by ``torch.maximum`` on the device.
    ``weighted=True`` restricts the max to rows of weight > 0 (the rank-1
    case of ``fold_top_k_min_d2``; with all weights positive, the same
    value). ``device=None`` means ``"cuda"``."""
    if weighted:
        top = fold_top_k_min_d2(source, c, 1, impl=impl,
                                block_rows=block_rows,
                                memory_budget=memory_budget,
                                prefetch=prefetch, weighted=True,
                                device=device)
        # an empty support leaves the -3.4e38 sentinel: radius 0
        return torch.clamp_min(top[0], 0.0)
    dev, rows, c = _fold_setup(source, c, block_rows, memory_budget,
                               prefetch, device)
    best = None
    for blk in _source_blocks(source, rows, prefetch, dev):
        _, tops = fused_filter(blk, c, rank=1, impl=impl)
        bmax = tops.amax()
        best = bmax if best is None else torch.maximum(best, bmax)
    if best is None:
        return torch.zeros((), dtype=torch.float32, device=dev)
    return best


def fold_top_k_min_d2(source, c, rank: int, *, impl: str = "auto",
                      block_rows: int | None = None,
                      memory_budget: int | None = None,
                      prefetch: int | None = None, weighted: bool = False,
                      device=None) -> torch.Tensor:
    """Descending top-``rank`` of the min squared distances to ``c`` over
    all source points: with ``rank = z + 1``, slot ``z`` is the squared
    covering radius after excluding the ``z`` farthest points (the
    outlier objective's evaluation fold).

    Each block is one filter step at ``rank`` with no ``ds`` carry; its
    per-tile tops merge into the running top-``rank`` on the device. Top-k
    values do not depend on the blocking, so the result equals the
    in-memory top-k of ``assign_nearest(x, c)[1]``; slots past the
    support hold -3.4e38. ``weighted=True`` runs the weighted filter with
    each block's row weights: rows of weight <= 0 are out of candidacy.
    ``device=None`` means ``"cuda"``."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    dev, rows, c = _fold_setup(source, c, block_rows, memory_budget,
                               prefetch, device)
    top = top_k_init(rank, dev)
    if weighted:
        for blk, w in _weighted_source_blocks(source, rows, prefetch, dev):
            _, tops = fused_filter(blk, c, rank=rank, w=w, impl=impl)
            top = merge_top_k(top, tops, rank)
        return top
    for blk in _source_blocks(source, rows, prefetch, dev):
        _, tops = fused_filter(blk, c, rank=rank, impl=impl)
        top = merge_top_k(top, tops, rank)
    return top


def assign_nearest_source(source, c, *, impl: str = "auto",
                          block_rows: int | None = None,
                          memory_budget: int | None = None,
                          prefetch: int | None = None, device=None):
    """Streaming nearest-center assignment over a source: yields ``(idx
    (rows,) int32, d2 (rows,))`` per block, in row order; the yields
    concatenated equal the in-memory ``assign_nearest``. The yields are
    fresh tensors, not views of the upload ring. ``device=None`` means
    ``"cuda"``."""
    dev, rows, c = _fold_setup(source, c, block_rows, memory_budget,
                               prefetch, device)
    for blk in _source_blocks(source, rows, prefetch, dev):
        yield fused_assign(blk, c, impl=impl)


def assign_sums_source(source, c, *, impl: str = "auto",
                       block_rows: int | None = None,
                       memory_budget: int | None = None,
                       prefetch: int | None = None, weighted: bool = False,
                       device=None) -> torch.Tensor:
    """Per-cluster sums over a source, streamed: for each center of ``c (k,
    d)``, the count of source rows nearest to it (int32), or with
    ``weighted=True`` the sum of their row weights (f32; unit weights for a
    source without them). Every block adds into one (k,) tensor on the
    device (``assign_sums``). ``device=None`` means
    ``"cuda"``."""
    dev, rows, c = _fold_setup(source, c, block_rows, memory_budget,
                               prefetch, device)
    if weighted:
        sums = torch.zeros((c.shape[0],), dtype=torch.float32, device=dev)
        for blk, w in _weighted_source_blocks(source, rows, prefetch, dev):
            assign_sums(blk, c, sums, w, impl=impl)
        return sums
    sums = torch.zeros((c.shape[0],), dtype=torch.int32, device=dev)
    for blk in _source_blocks(source, rows, prefetch, dev):
        assign_sums(blk, c, sums, impl=impl)
    return sums


def argmin_dist2_over_source(source, c, *, impl: str = "auto",
                             block_rows: int | None = None,
                             memory_budget: int | None = None,
                             prefetch: int | None = None,
                             device=None) -> torch.Tensor:
    """For each center row of ``c (m, d)``, the global row index (int32) of
    the nearest source point, first row on ties.

    The kernel route folds every block into one packed (d2, row) carry
    inside the kernel; the plain route merges each block's (min, argmin)
    into the running one on strict ``<``, so the earliest block keeps a
    tie. ``device=None`` means ``"cuda"``."""
    if source.n >= 2**31:
        raise ValueError(f"row indices are int32; n={source.n} is too large")
    dev, rows, c = _fold_setup(source, c, block_rows, memory_budget,
                               prefetch, device)
    m = c.shape[0]
    off = 0
    if _resolve(impl, c):
        carry = argmin_carry(m, dev)
        for blk in _source_blocks(source, rows, prefetch, dev):
            fused_argmin_cuda(blk, c, carry, off)
            off += blk.shape[0]
        return unpack_argmin(carry)[1]
    best_d = torch.full((m,), ref.BIG, dtype=torch.float32, device=dev)
    best_i = torch.zeros((m,), dtype=torch.int32, device=dev)
    for blk in _source_blocks(source, rows, prefetch, dev):
        bd, bi = ref.fused_argmin(blk, c)
        take = bd < best_d
        best_d = torch.where(take, bd, best_d)
        best_i = torch.where(take, bi + off, best_i)
        off += blk.shape[0]
    return best_i
