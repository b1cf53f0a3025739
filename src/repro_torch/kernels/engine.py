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

The mesh's lockstep steps over its shards' host streams are
``zip_shard_blocks``. The source folds (``fold_min_d2``, ``fold_top_k_min_d2``,
``assign_nearest_source``, ``assign_sums_source``,
``argmin_dist2_over_source``) stream a point
source in super-shards of ``block_rows`` rows through its upload ring, so
at most ``1 + prefetch`` blocks are device-resident (``resolve_block_rows``'
residency model), and fold each block into O(m)- or O(rank)-sized state on
the device: no per-block value is read back to the host. The weighted
folds take each block's row weights from the same ring slot as its points
(``_weighted_source_blocks``).

Row-chunked passes: every distance op takes ``chunk`` (rows);
``assign_nearest``, ``fused_min_argmax``, ``pairwise_dist2`` and
``argmin_dist2_over_rows`` also take ``memory_budget`` (bytes, solved by
``resolve_chunk`` against the working set ``4·chunk·(m + d) + 4·m·d``). On the plain route the (n, m) distance
block is then built ``chunk`` rows at a time, as the JAX engine's
``lax.scan`` does, so n is bounded by the points' memory, not the
matrix's; the arg-reductions merge across chunks on strict ``<`` / ``>``,
so the earliest chunk keeps a tie and the results are bitwise the
unchunked ones. On the kernel route ``chunk`` is accepted and changes
nothing: the kernels stream rows and never build (n, m).

EIM's pieces (paper §4): the counter-based per-row samplers
(Philox-4x32-10 keyed by the absolute row index, ``uniform_rows`` and its
forms), the key split (``split_key``, threefry-2x32 on the host) and one
block's filter step (``filter_tile_update``, ``eim_filter_block``).
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


def resolve_chunk(n: int, m: int, d: int, *, chunk: int | None = None,
                  memory_budget: int | None = None) -> int | None:
    """Row-chunk size for an ``(n, d) × (m, d)`` distance op.

    An explicit ``chunk`` wins (clipped to ``[1, n]``; ``chunk >= n`` is one
    chunk). Otherwise a ``memory_budget`` in bytes is solved against the
    f32 working set ``4·chunk·(m + d) + 4·m·d``: the streamed tile and the
    resident centers. ``None`` when neither is given (unchunked)."""
    if chunk is not None:
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        return min(int(chunk), max(n, 1))
    if memory_budget is not None:
        avail = memory_budget - 4 * m * d
        rows = avail // (4 * (m + d)) if avail > 0 else 0
        if rows < 1:
            raise ValueError(
                f"memory_budget={memory_budget} cannot hold even one row "
                f"(centers alone need {4 * m * d} bytes + {4 * (m + d)}/row)")
        return min(int(rows), max(n, 1))
    return None


def _blocks(a: torch.Tensor, chunk: int, fill: float):
    """Pad the rows of ``a`` to a chunk multiple with ``fill`` and view them
    as ``(nb, chunk, ...)``. Returns ``(blocks, n)``."""
    ap, n = _pad_rows(a, chunk, fill)
    return ap.view((ap.shape[0] // chunk, chunk) + tuple(ap.shape[1:])), n


def _chunk_of(x, c, chunk, memory_budget):
    """``resolve_chunk`` for rows ``x (..., n, d)`` against ``c (..., m,
    d)``: ``None`` where one chunk holds every row. A chunk holds two rows
    at least: on the card the plain distances are one matrix product, and
    PyTorch takes a one-row product to its matrix-vector routine, which
    rounds otherwise than the matrix product of the unchunked pass."""
    n, d, m = x.shape[-2], x.shape[-1], c.shape[-2]
    rows = resolve_chunk(n, m, d, chunk=chunk, memory_budget=memory_budget)
    return None if rows is None or rows >= n else max(rows, 2)


def dist2_to_center(x, c, *, impl: str = "auto"):
    """Squared distance of each row of ``x (..., n, d)`` to ``c (..., d)``.

    A single center has no (n, m) block to fuse away; the plain pass is the
    op on every device, as in the JAX engine."""
    _resolve(impl, x)
    return ref.dist2_to_center(x, c)


def pairwise_dist2(x, c, *, impl: str = "auto", chunk: int | None = None,
                   memory_budget: int | None = None):
    """``(n, d), (m, d) -> (n, m)`` squared distances, f32 or f16 inputs
    computed in f32 (see ``pairwise.pairwise_dist2_ref``). The output is
    (n, m) whatever the chunk; the plain route's chunks bound its
    temporaries."""
    rows = _chunk_of(x, c, chunk, memory_budget)
    if _resolve(impl, x):
        return pairwise_dist2_cuda(x, c)
    if rows is None:
        return pairwise_dist2_ref(x, c)
    xb, n = _blocks(x, rows, 0.0)
    out = torch.empty((n, c.shape[0]), dtype=torch.float32, device=x.device)
    for i, blk in enumerate(xb):
        s = i * rows
        out[s:s + rows] = pairwise_dist2_ref(blk, c)[:n - s]
    return out


def gon_workspace(m: int, x, *, impl: str = "auto"):
    """Scratch for a GON run of ``m`` machines over ``x``: a
    ``GonWorkspace`` on the kernel route (made once a run, so that a step
    allocates nothing), ``None`` on the plain one."""
    return GonWorkspace(m, x.device) if _resolve(impl, x) else None


def fused_min_argmax(x, c, md, *, impl: str = "auto", ws=None, centers=None,
                     indices=None, slot: int = -1, carry=None, off: int = 0,
                     reset: bool = False, chunk: int | None = None,
                     memory_budget: int | None = None):
    """Batched GON step: ``x (m, per, d)``, ``c (m, d)``, ``md (m, per)`` ->
    ``(md, far_val (m,), far_idx (m,) int32)``. ``md`` is updated in place
    on both routes. Rows whose ``md`` is -3.4e38 (padding, masked rows)
    stay so and never win unless every row of a machine is such a row.
    The next center goes to a ``centers``/``indices`` slot and a streamed
    pass's ``carry`` on the device (see ``ref.fused_min_argmax``); ``ws``
    is the run's ``gon_workspace``, whose buffers hold the kernel route's
    ``far_val``/``far_idx`` until its next step.

    ``chunk`` rows at a time on the plain route (slices of ``per``, so the
    last is short and no padded row is made): each chunk's far point
    replaces the running one on strict ``>``, so the earliest chunk keeps
    a tie, as the unchunked argmax does."""
    rows = resolve_chunk(x.shape[1], 1, x.shape[2], chunk=chunk,
                         memory_budget=memory_budget)
    out = dict(centers=centers, indices=indices, slot=slot, carry=carry,
               off=off, reset=reset)
    if _resolve(impl, x):
        return fused_min_argmax_cuda(x, c, md, ws=ws, **out)
    if rows is None or rows >= x.shape[1]:
        return ref.fused_min_argmax(x, c, md, **out)
    val = idx = None
    for s in range(0, x.shape[1], rows):
        mdc = md[:, s:s + rows]
        torch.minimum(mdc, ref.dist2_to_center(x[:, s:s + rows], c), out=mdc)
        i = torch.argmax(mdc, dim=-1)
        v = mdc.gather(-1, i.unsqueeze(-1)).squeeze(-1)
        if val is None:
            val, idx = v, i + s
        else:
            take = v > val
            val = torch.where(take, v, val)
            idx = torch.where(take, i + s, idx)
    return ref.gon_write(x, md, val, idx, **out)


def _assign_chunked(x, c, rows: int):
    """The plain assign, ``rows`` rows at a time (padded with 0 to whole
    chunks, the padding's results dropped)."""
    xb, n = _blocks(x, rows, 0.0)
    idx = torch.empty((n,), dtype=torch.int32, device=x.device)
    d2 = torch.empty((n,), dtype=torch.float32, device=x.device)
    for i, blk in enumerate(xb):
        s = i * rows
        bi, bd = ref.assign_nearest(blk, c)
        idx[s:s + rows], d2[s:s + rows] = bi[:n - s], bd[:n - s]
    return idx, d2


def assign_nearest(x, c, *, impl: str = "auto", chunk: int | None = None,
                   memory_budget: int | None = None):
    """Nearest-center assignment: ``(idx (n,) int32, d2 (n,))``. With
    ``chunk``/``memory_budget`` the plain route reduces each (chunk, m)
    tile to its rows' (argmin, min), so (n, m) is never built."""
    rows = _chunk_of(x, c, chunk, memory_budget)
    if _resolve(impl, x):
        return assign_nearest_cuda(x, c)
    if rows is None:
        return ref.assign_nearest(x, c)
    return _assign_chunked(x, c, rows)


# Coordinate-space far sentinel of invalid center rows: a row at 1e18 in
# every coordinate lies ~1e36·d away from any point, so it never wins a
# nearest reduction (the JAX engine's ``_FAR_CENTER``).
_FAR_CENTER = 1e18


def _host_mask(cmask, rows: int) -> np.ndarray:
    """``cmask`` (numpy or a CPU tensor, 0/1 or bool) as a host bool array
    of ``rows`` entries. A device mask raises: reading it would make every
    call a synchronising one."""
    if isinstance(cmask, torch.Tensor):
        if cmask.device.type != "cpu":
            raise ValueError(
                f"cmask must lie on the host (a numpy array or a CPU tensor), "
                f"got one on {cmask.device}: reading it would synchronise "
                "every call")
        cmask = cmask.numpy()
    live = np.asarray(cmask) > 0
    if live.shape != (rows,):
        raise ValueError(f"cmask must have shape ({rows},) to match the center "
                         f"bucket, got {live.shape}")
    return live


def assign_bucketed(q, c, cmask, *, impl: str = "auto",
                    chunk: int | None = None):
    """Nearest-center assignment against a bucketed center set: the online
    service's query op (``repro_torch/serve/kcenter.py``).

    ``c (m_cap, d)`` is a fixed bucket holding the live centers that
    ``cmask (m_cap,)`` marks (0/1 or bool, on the host: numpy or a CPU
    tensor); ``q`` is a padded query block. Returns ``(idx (n,) int32, d2
    (n,))``, ``idx`` a row of the bucket. Rows the mask marks invalid never
    win. Where the ``m`` live rows lead the bucket (the service's layout),
    the result of every query row is bitwise ``assign_nearest(q[:b],
    c[:m])``: on the kernel route, and on the plain route on the CPU, a
    row's result does not depend on the padding rows.

    The live count is read from the host mask, so a call adds no
    synchronising read. Where the live rows form one run ``[lo, lo + m)``
    (a prefix, or a single center), the assign runs on that view, one
    launch on the card, planned on the live count (so the route of
    ``assign.assign_plan`` is the one the offline call takes) and ``lo`` is
    added back; a single center thereby runs on its true one-row set, as
    the JAX engine special-cases it. Otherwise the invalid rows are pushed
    to ``_FAR_CENTER``, as the JAX engine does on every call."""
    live = _host_mask(cmask, c.shape[0])
    rows = np.flatnonzero(live)
    if rows.size == 0:
        raise ValueError("cmask marks no live center")
    lo, m = int(rows[0]), int(rows.size)
    if int(rows[-1]) - lo + 1 == m:
        idx, d2 = assign_nearest(q, c[lo:lo + m], impl=impl, chunk=chunk)
        return (idx + lo if lo else idx), d2
    keep = upload(live, c.device)
    c = torch.where(keep[:, None], c, _FAR_CENTER)
    return assign_nearest(q, c, impl=impl, chunk=chunk)


def assign_nearest_batched(x, c, *, impl: str = "auto"):
    """Nearest-center assignment of machine blocks ``x (m, per, d)``, each
    against its own centers ``c (m, k, d)``: ``(idx (m, per) int32, d2
    (m, per))``, one launch for all machines on the card."""
    if _resolve(impl, x):
        return assign_nearest_batched_cuda(x, c)
    return ref.assign_nearest(x, c)


def assign_sums(x, c, sums, w=None, *, impl: str = "auto",
                chunk: int | None = None):
    """Add each row's weight ``w`` (f32 sums), or 1 (int32 counts,
    ``w=None``), into the slot of its nearest center, in place: ``x (n,
    d)`` against ``c (k, d)`` into ``sums (k,)``, or machine blocks ``x (m,
    per, d)`` against their own ``c (m, k, d)`` into ``sums (m, k)``.
    Returns ``sums``. One launch of the assign's sums entry on the card;
    the plain route is the assign, then ``index_add_``
    (``ref.assign_sums``), ``chunk`` rows of each machine at a time (a
    slot's adds keep their row order)."""
    rows = _chunk_of(x, c, chunk, None)
    if _resolve(impl, x):
        return assign_sums_cuda(x, c, sums, w)
    if rows is None:
        return ref.assign_sums(x, c, sums, w)
    for s in range(0, x.shape[-2], rows):
        ref.assign_sums(x[..., s:s + rows, :], c, sums,
                        None if w is None else w[..., s:s + rows])
    return sums


def _argmin_chunked(x, c, rows: int):
    """For each center of ``c``, the nearest row of ``x``, ``rows`` rows at
    a time: the rows padded at 1e18 (never nearest), each chunk's (min,
    argmin) taking a center's slot on strict ``<`` so the earliest chunk
    keeps a tie. Returns ``(best_d, best_i int32)``."""
    xb, _ = _blocks(x, rows, 1e18)
    best_d = best_i = None
    for i, blk in enumerate(xb):
        bd, bi = ref.fused_argmin(blk, c)
        if best_d is None:
            best_d, best_i = bd, bi + i * rows
        else:
            take = bd < best_d
            best_d = torch.where(take, bd, best_d)
            best_i = torch.where(take, bi + i * rows, best_i)
    return best_d, best_i


def argmin_dist2_over_rows(x, c, *, impl: str = "auto",
                           chunk: int | None = None,
                           memory_budget: int | None = None):
    """For each center row of ``c (m, d)``, the index of the nearest row of
    ``x (n, d)``, first row on ties. The kernel route is the per-center
    argmin on one block from a fresh carry (many rows against few
    centers); the plain route ``assign_nearest(c, x)[0]``, or with
    ``chunk``/``memory_budget`` the (chunk, m) tiles of x's rows merged on
    strict ``<``. Each pair rounds as in the assign (``csrc/dist2.cuh``),
    so the two kernels agree."""
    rows = _chunk_of(x, c, chunk, memory_budget)
    if _resolve(impl, x):
        return fused_argmin(x, c, impl="kernel")[1]
    if rows is None:
        return ref.assign_nearest(c, x)[0]
    return _argmin_chunked(x, c, rows)[1]


def fused_filter(x, c, ds=None, hm=None, *, rank: int, w=None,
                 impl: str = "auto", chunk: int | None = None):
    """The streamed filter step on one block: ``(ds, tops (tiles, rank))``
    (see ``ref.fused_filter``); ``ds`` is updated in place. With row
    weights ``w`` the weighted kernel runs: ``w <= 0`` rows are out of
    top-k candidacy. The plain route's chunks are whole filter tiles
    (``chunk`` floored to a multiple of ``ref.FILTER_TILE_ROWS``, one tile
    at least), so a tile's top-k is the same."""
    rows = _chunk_of(x, c, chunk, None)
    if _resolve(impl, x):
        if w is None:
            return fused_filter_cuda(x, c, ds, hm, rank=rank)
        return fused_filter_w_cuda(x, c, ds, hm, w=w, rank=rank)
    if rows is None:
        return ref.fused_filter(x, c, ds, hm, rank=rank, w=w)
    tile = ref.FILTER_TILE_ROWS
    step = max(tile, rows // tile * tile)
    tops = []
    for s in range(0, x.shape[0], step):
        part = [None if t is None else t[s:s + step] for t in (ds, hm, w)]
        tops.append(ref.fused_filter(x[s:s + step], c, part[0], part[1],
                                     rank=rank, w=part[2])[1])
    return ds, torch.cat(tops)


def fused_assign(x, c, *, impl: str = "auto", chunk: int | None = None):
    """Nearest center of every row of a streamed block: ``(idx (n,) int32,
    d2 (n,))`` (the streamed kernel; ``assign_nearest``'s function)."""
    rows = _chunk_of(x, c, chunk, None)
    if _resolve(impl, x):
        return fused_assign_cuda(x, c)
    if rows is None:
        return ref.assign_nearest(x, c)
    return _assign_chunked(x, c, rows)


def fused_argmin(x, c, *, impl: str = "auto", chunk: int | None = None):
    """For each center, the nearest row of one block: ``(best_d (m,),
    best_i (m,) int32)``, first row on ties (see ``ref.fused_argmin``)."""
    if _resolve(impl, x):
        carry = fused_argmin_cuda(x, c, argmin_carry(c.shape[0], x.device))
        return unpack_argmin(carry)
    rows = _chunk_of(x, c, chunk, None) if x.shape[0] else None
    if rows is None:
        return ref.fused_argmin(x, c)
    return _argmin_chunked(x, c, rows)


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


def zip_shard_blocks(shards, rows: int, *, with_weights: bool = False,
                     local_ids=None):
    """The mesh's per-shard streams in lockstep, on the host.

    Yields ``(pts (S, rows, d) f32, counts (S,) int64)`` a step: each
    shard's next block, zero-padded to the common ``rows`` (the executor
    makes masks from ``counts``), until every shard is exhausted. A shard
    that runs out early contributes all-padding steps with ``counts == 0``.
    The host working set is one step, ``S·rows·d`` floats, never a shard.

    ``with_weights=True`` puts each shard's per-row f32 weights between the
    points and the counts, ``(pts, w (S, rows), counts)``, padded rows at
    weight 0, taken per shard from its ``weights_of`` (ones where it has
    none) at a per-shard row cursor.

    ``local_ids`` (shard indices, or ``None`` for all) is the multi-process
    form: ``pts`` holds only those shards, ``(S_l, rows, d)`` in ascending
    shard order, a shard not in it is never read, and its ``counts`` still
    follow from its size and a cursor, so every process sees the same
    steps.

    >>> import numpy as np
    >>> from repro_torch.data.source import HostSource
    >>> a = HostSource(np.ones((3, 1), np.float32))
    >>> b = HostSource(np.ones((1, 1), np.float32))
    >>> [c.tolist() for _, c in zip_shard_blocks([a, b], 2)]
    [[2, 1], [1, 0]]
    """
    if rows < 1:
        raise ValueError(f"rows must be >= 1, got {rows}")
    shards = list(shards)
    if not shards:
        raise ValueError("zip_shard_blocks needs at least one shard")
    local = (list(range(len(shards))) if local_ids is None
             else sorted({int(i) for i in local_ids}))
    slot = {s: j for j, s in enumerate(local)}
    if local_ids is not None and with_weights:
        raise NotImplementedError(
            "weighted lockstep steps are not supported with non-local "
            "shards (no weighted multi-process caller exists)")
    d = shards[0].d
    its = [host_blocks_of(s, rows) if i in slot else None
           for i, s in enumerate(shards)]
    pos = [0] * len(shards)
    while True:
        pts = np.zeros((len(local), rows, d), np.float32)
        w = np.zeros((len(shards), rows), np.float32) if with_weights else None
        counts = np.zeros((len(shards),), np.int64)
        any_rows = False
        for s, it in enumerate(its):
            if it is None:
                # a shard of another process: its counts without a read
                nb = min(rows, shards[s].n - pos[s])
                if nb <= 0:
                    continue
                pos[s] += nb
                counts[s] = nb
                any_rows = True
                continue
            blk = next(it, None)
            if blk is None:
                continue
            nb = blk.shape[0]
            if nb > rows:
                raise ValueError(
                    f"shard {s} yielded a {nb}-row block for "
                    f"block_rows={rows}")
            pts[slot[s], :nb] = blk
            if with_weights:
                w[s, :nb] = _source_weights(shards[s], pos[s], nb)
            pos[s] += nb
            counts[s] = nb
            if nb:
                any_rows = True
        if not any_rows:
            return
        if with_weights:
            yield pts, w, counts
        else:
            yield pts, counts


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


def fold_min_d2(source, c, *, impl: str = "auto", chunk: int | None = None,
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
    value). ``chunk`` bounds the plain route's (chunk, k) tiles within a
    block. ``device=None`` means ``"cuda"``."""
    if weighted:
        top = fold_top_k_min_d2(source, c, 1, impl=impl, chunk=chunk,
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
        _, tops = fused_filter(blk, c, rank=1, impl=impl, chunk=chunk)
        bmax = tops.amax()
        best = bmax if best is None else torch.maximum(best, bmax)
    if best is None:
        return torch.zeros((), dtype=torch.float32, device=dev)
    return best


def fold_top_k_min_d2(source, c, rank: int, *, impl: str = "auto",
                      chunk: int | None = None,
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
            _, tops = fused_filter(blk, c, rank=rank, w=w, impl=impl,
                                   chunk=chunk)
            top = merge_top_k(top, tops, rank)
        return top
    for blk in _source_blocks(source, rows, prefetch, dev):
        _, tops = fused_filter(blk, c, rank=rank, impl=impl, chunk=chunk)
        top = merge_top_k(top, tops, rank)
    return top


def assign_nearest_source(source, c, *, impl: str = "auto",
                          chunk: int | None = None,
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
        yield fused_assign(blk, c, impl=impl, chunk=chunk)


def assign_sums_source(source, c, *, impl: str = "auto",
                       chunk: int | None = None,
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
            assign_sums(blk, c, sums, w, impl=impl, chunk=chunk)
        return sums
    sums = torch.zeros((c.shape[0],), dtype=torch.int32, device=dev)
    for blk in _source_blocks(source, rows, prefetch, dev):
        assign_sums(blk, c, sums, impl=impl, chunk=chunk)
    return sums


def argmin_dist2_over_source(source, c, *, impl: str = "auto",
                             chunk: int | None = None,
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
        bd, bi = fused_argmin(blk, c, impl="ref", chunk=chunk)
        take = bd < best_d
        best_d = torch.where(take, bd, best_d)
        best_i = torch.where(take, bi + off, best_i)
        off += blk.shape[0]
    return best_i


# ---------------------------------------------------------------------------
# EIM's keys: threefry-2x32, as the JAX package splits its PRNG keys
# ---------------------------------------------------------------------------
#
# EIM splits its key each iteration (``jax.random.split(key, 3)`` in the
# JAX package). With jax's partitionable threefry (the default of the jax
# versions the tests run), ``split(key, num)[i]`` is the threefry-2x32 hash
# of the counter pair (0, i) under the key. The port computes it on the
# host, in Python integers: a few dozen operations an iteration.

_M32 = 0xFFFFFFFF
_THREEFRY_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl32(v: int, r: int) -> int:
    return ((v << r) | (v >> (32 - r))) & _M32


def _threefry2x32(k0: int, k1: int, x0: int, x1: int) -> tuple[int, int]:
    """Threefry-2x32, 20 rounds, of the counter words ``(x0, x1)``."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
    for g in range(5):
        for r in _THREEFRY_ROT[g % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _M32
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & _M32
    return x0, x1


def key_words(key) -> tuple[int, int]:
    """The two uint32 words of a key: an int seed maps to ``(0, seed mod
    2^32)``, as ``jax.random.PRNGKey(seed)`` does with 64-bit types off;
    anything else is two words, such as ``np.asarray(jax.random.PRNGKey(s))``
    or ``jax.random.key_data(k)`` of a typed key."""
    if isinstance(key, (int, np.integer)):
        return 0, int(key) & _M32
    words = np.asarray(key).reshape(-1)
    if words.size != 2 or not np.issubdtype(words.dtype, np.integer):
        raise ValueError(
            f"a key is an int seed or two uint32 words, got {words.dtype} "
            f"{tuple(np.shape(key))}")
    return int(words[0]) & _M32, int(words[1]) & _M32


def split_key(key, num: int = 2) -> np.ndarray:
    """``num`` new keys from ``key``, as ``(num, 2)`` uint32 words: bitwise
    ``jax.random.split(key, num)`` (partitionable threefry)."""
    k0, k1 = key_words(key)
    return np.array([_threefry2x32(k0, k1, 0, i) for i in range(num)],
                    dtype=np.uint32).reshape(num, 2)


# ---------------------------------------------------------------------------
# counter-based per-row sampling: Philox-4x32-10 keyed by absolute row index
# ---------------------------------------------------------------------------
#
# EIM's Round-1 Bernoulli draws must not depend on the blocking: the
# streamed path sees the input in super-shards and, once compacted, as a
# view of surviving rows, and the decision for global row i may depend on
# (key, i) only. The port's generator is the JAX package's: one Philox
# output word a row, counter (row lo, row hi, 0, 0), its top 24 bits scaled
# to [0, 1). PyTorch has no usable uint32 arithmetic, so the words are int64
# tensors held in [0, 2^32); a 32 x 32 product would overflow int64, so it
# is taken in 16-bit limbs, as the reference takes it. The draws run on any
# device, as plain eager ops (about 400 of them a draw).

_PHILOX_M0 = 0xD2511F53
_PHILOX_M1 = 0xCD9E8D57
_PHILOX_W0 = 0x9E3779B9
_PHILOX_W1 = 0xBB67AE85


def _mulhilo32(a: int, b: torch.Tensor):
    """``a · b`` as its (hi, lo) 32-bit words, for words ``b`` in [0,
    2^32): 16-bit limbs keep every partial product below 2^33."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    ll = b_lo * a_lo
    t = b_lo * a_hi + (ll >> 16)
    u = (t & 0xFFFF) + b_hi * a_lo
    hi = b_hi * a_hi + (t >> 16) + (u >> 16)
    return hi, ((u & 0xFFFF) << 16) | (ll & 0xFFFF)


def _philox_rows(k0: int, k1: int, c0: torch.Tensor, c1: torch.Tensor):
    """One Philox-4x32-10 output word per counter (c0 = row lo, c1 = row
    hi)."""
    x0, x1 = c0, c1
    x2 = x3 = torch.zeros_like(c0)
    for _ in range(10):
        hi0, lo0 = _mulhilo32(_PHILOX_M0, x0)
        hi1, lo1 = _mulhilo32(_PHILOX_M1, x2)
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & _M32
        k1 = (k1 + _PHILOX_W1) & _M32
    return x0


def _uniform_words(key, c0: torch.Tensor, c1: torch.Tensor) -> torch.Tensor:
    """U[0, 1) in f32 from the counter words: the 24 high bits of the
    Philox word, scaled exactly."""
    k0, k1 = key_words(key)
    bits = _philox_rows(k0, k1, c0, c1)
    return (bits >> 8).to(torch.float32) * (2.0 ** -24)


def _uniform_block(key, start_lo: int, start_hi: int, rows: int,
                   device) -> torch.Tensor:
    if rows < 0:
        raise ValueError(f"rows must be >= 0, got {rows}")
    dev = resolve_device(device)
    c0 = torch.arange(rows, dtype=torch.int64, device=dev) + int(start_lo)
    c1 = (c0 >> 32) + int(start_hi)            # the carry into the high word
    return _uniform_words(key, c0 & _M32, c1 & _M32)


def _uniform_at(key, idx_lo, idx_hi, device) -> torch.Tensor:
    dev = resolve_device(device)
    return _uniform_words(key, _words_on(idx_lo, dev), _words_on(idx_hi, dev))


def _words_on(words, dev: torch.device) -> torch.Tensor:
    return upload(np.asarray(words, np.uint32).astype(np.int64), dev)


def _below(u: torch.Tensor, p) -> torch.Tensor:
    """``u < p`` in f32."""
    return u < float(np.float32(p))


def uniform_rows(key, start: int, rows: int, device=None) -> torch.Tensor:
    """Counter-based U[0, 1) for the absolute rows ``[start, start +
    rows)``, f32 on ``device`` (``None`` means ``"cuda"``).

    Row i's value depends on ``(key, i)`` only, so the draws of any
    partition of ``[0, n)`` concatenate to one full-range draw, bitwise;
    they are bitwise the JAX package's ``engine.uniform_rows``. The start is
    split into two 32-bit counter words with an explicit carry, so a block
    may cross row 2^32."""
    return _uniform_block(key, start & _M32, (start >> 32) & _M32, rows,
                          device)


def bernoulli_rows(key, start: int, rows: int, p, device=None) -> torch.Tensor:
    """Per-row Bernoulli(p) draws for the absolute rows ``[start, start +
    rows)``: ``uniform_rows(...) < p`` in f32, so callers that feed the
    same f32 ``p`` agree bitwise."""
    return _below(uniform_rows(key, start, rows, device), p)


def bernoulli_rows_block(key, start_lo: int, start_hi: int, rows: int, p,
                         device=None) -> torch.Tensor:
    """``bernoulli_rows`` with the 64-bit start given as its two 32-bit
    words (the form the streamed EIM's block loop uses)."""
    return _below(_uniform_block(key, start_lo, start_hi, rows, device), p)


def split_index_words(indices) -> tuple[np.ndarray, np.ndarray]:
    """Host split of 64-bit absolute row indices into their 32-bit counter
    words ``(lo, hi)``, uint32 numpy: the operands of
    ``bernoulli_rows_at_block``."""
    idx = np.asarray(indices, np.uint64).reshape(-1)
    return ((idx & np.uint64(_M32)).astype(np.uint32),
            (idx >> np.uint64(32)).astype(np.uint32))


def uniform_rows_at(key, indices, device=None) -> torch.Tensor:
    """Gather form of ``uniform_rows``: the draws at arbitrary absolute row
    ``indices`` (host integers), so ``uniform_rows_at(key, idx) ==
    uniform_rows(key, 0, n)[idx]`` bitwise. A compacted view's survivors
    keep the draws of their original rows."""
    return _uniform_at(key, *split_index_words(indices), device)


def bernoulli_rows_at(key, indices, p, device=None) -> torch.Tensor:
    """Per-row Bernoulli(p) draws at arbitrary absolute row ``indices``:
    bitwise ``bernoulli_rows(key, 0, n, p)[indices]`` for the same f32
    ``p``."""
    return _below(uniform_rows_at(key, indices, device), p)


def bernoulli_rows_at_block(key, idx_lo, idx_hi, p, device=None) -> torch.Tensor:
    """The gather form with the index words given (``split_index_words``;
    callers may pad them to one block length)."""
    return _below(_uniform_at(key, idx_lo, idx_hi, device), p)


# ---------------------------------------------------------------------------
# EIM's filter step on one block (paper §4, Rounds 2-3)
# ---------------------------------------------------------------------------

def filter_tile_update(blk, c, d_blk, h_blk, *, rank: int, impl: str = "auto",
                       chunk: int | None = None):
    """One block's share of EIM Rounds 2-3: ``d_blk = min(d_blk, d(blk,
    c)^2)`` in place, and the block's descending top-``min(rank, rows)`` of
    ``where(h_blk, d_blk, -3.4e38)``. Returns ``(d_blk, top)``.

    The kernel route is one filter launch (kernel #3) and the top-k of its
    tile tops; the plain route the assign (``chunk`` rows at a time) and
    the top-k of the masked values. Top-k values do not depend on the
    tiling, so the two agree bitwise where the distances do."""
    r = min(rank, d_blk.shape[0])
    if _resolve(impl, blk):
        _, tops = fused_filter(blk, c, d_blk, h_blk, rank=rank, impl=impl)
        return d_blk, torch.topk(tops.reshape(-1), r).values
    _, dn = assign_nearest(blk, c, impl=impl, chunk=chunk)
    torch.minimum(d_blk, dn, out=d_blk)
    cand = torch.where(h_blk, d_blk, ref.NEG)
    return d_blk, torch.topk(cand, r).values


def eim_filter_block(blk, c, d_blk, h_blk, top, *, rank: int,
                     impl: str = "auto", chunk: int | None = None):
    """``filter_tile_update`` with the block's top merged into the running
    top-``rank`` carry ``top``: one super-shard's share of the streamed
    filter round. Returns ``(d_blk, top)``."""
    d_blk, tops = filter_tile_update(blk, c, d_blk, h_blk, rank=rank,
                                     impl=impl, chunk=chunk)
    return d_blk, merge_top_k(top, tops, rank)
