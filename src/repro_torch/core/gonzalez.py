"""Gonzalez's greedy 2-approximation for k-center (paper §3.1, "GON").

Port of ``repro.core.gonzalez``. Pick the first (valid) point, then
repeatedly the point farthest from the chosen set, k times. Each iteration
is one fused pass over the points: the GON-step kernel
(``kernels/fused_argfar.py``) on the card, its plain version on the CPU.
Over a host, disk or generator point source each pass streams the source
block by block (``_gonzalez_source``).

The JAX package maps GON over machine blocks with ``jax.vmap``; a
hand-written kernel cannot be vmapped, so ``_gonzalez_device`` runs m
machine blocks as a leading axis of one batched GON, and ``gonzalez`` on
one ``(n, d)`` array is its m = 1 case. The k-loop never reads a tensor
back to the host: each step writes the next center into the run's output
on the device, and on the card each iteration is one kernel launch.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.data.source import ArraySource, is_source
from repro_torch.device import as_points, resolve_device
from repro_torch.kernels import engine, ops

_NEG = np.float32(-3.4e38)  # sentinel: masked-out points can never be farthest
_BIG = np.float32(3.4e38)   # initial md of valid rows: min(_BIG, d2) == d2


class GonzalezResult(NamedTuple):
    centers: torch.Tensor   # (k, d) selected center coordinates
    indices: torch.Tensor   # (k,)  int32 indices into the input
    radius2: torch.Tensor   # ()    squared covering radius over valid points
    min_d2: torch.Tensor    # (n,)  final per-point squared distance to centers
                            #       (on the host for a streamed source)


def gonzalez(points, k: int, *, mask=None, first: int = 0,
             impl: str = "auto", chunk: int | None = None,
             block_rows: int | None = None, memory_budget: int | None = None,
             device=None) -> GonzalezResult:
    """Run GON on ``points (n, d)``; optionally restricted to ``mask (n,)``.

    ``points`` may be a point source: an ``ArraySource`` runs the in-memory
    algorithm, a host, disk or generator source the streamed one, whose
    k passes each stream the source in blocks of ``block_rows`` rows (or
    as ``memory_budget`` bytes allow, ``engine.resolve_block_rows``); it
    picks the same centers. ``mask`` is not supported for streamed
    sources.

    With a mask, invalid points are never selected and are excluded from
    the covering radius, and the first center is the first valid point
    (``first`` is then ignored). If fewer than ``k`` valid points exist,
    the remaining slots repeat covered points. ``radius2`` is the exact
    squared fold ``max(min_d2)``.

    ``device=None`` means ``"cuda"``. ``chunk`` (rows) streams each pass's
    plain route in row chunks (``engine.fused_min_argmax``); the centers
    do not change. On the kernel route it changes nothing.

    >>> import numpy as np
    >>> x = np.asarray([[0, 0], [1, 0], [10, 0], [10, 1]], np.float32)
    >>> res = gonzalez(x, 2, device="cpu")
    >>> [int(i) for i in res.indices]
    [0, 3]
    >>> float(res.radius2)
    1.0
    """
    dev = resolve_device(device)
    if is_source(points) and not isinstance(points, ArraySource):
        if mask is not None:
            raise ValueError("mask is not supported for streamed PointSources")
        return _gonzalez_source(points, k, first=int(first), impl=impl,
                                chunk=chunk, block_rows=block_rows,
                                memory_budget=memory_budget, device=dev)
    x = as_points(points, dev)
    if mask is not None:
        mask = torch.as_tensor(mask, device=dev).to(torch.bool)[None]
    res = _gonzalez_device(x[None], k, mask=mask, first=first, impl=impl,
                           chunk=chunk)
    return GonzalezResult(*(t[0] for t in res))


def _gonzalez_device(points: torch.Tensor, k: int, *, mask=None,
                     first: int = 0, impl: str = "auto",
                     chunk: int | None = None) -> GonzalezResult:
    """Batched GON over machine blocks ``points (m, per, d)`` with an
    optional ``mask (m, per)``. Returns a ``GonzalezResult`` whose fields
    carry the machine axis in front: ``centers (m, k, d)``, ``indices
    (m, k)``, ``radius2 (m,)``, ``min_d2 (m, per)``.

    Step i reads its centers from slot i of the output and writes the far
    points into slot i + 1: on the card each iteration is one launch, and
    the run's outputs and scratch are allocated once, before the loop."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    m, per, d = points.shape
    points = points.to(torch.float32).contiguous()
    dev = points.device
    md = torch.full((m, per), float(_BIG), dtype=torch.float32, device=dev)
    centers = torch.empty((m, k, d), dtype=torch.float32, device=dev)
    indices = torch.empty((m, k), dtype=torch.int32, device=dev)
    if mask is None:
        if not -per <= first < per:
            raise IndexError(f"first={first} out of range for {per} points")
        centers[:, 0] = points[:, first % per]
        indices[:, 0] = first % per
    else:
        # first valid point (ignores `first` when a mask is given)
        first_idx = torch.argmax(mask.to(torch.uint8), dim=1).to(torch.int32)
        centers[:, 0] = points[torch.arange(m, device=dev), first_idx]
        indices[:, 0] = first_idx
        md.masked_fill_(~mask, float(_NEG))

    # The initial pass is a GON step from md = +BIG (valid) / _NEG (masked):
    # it leaves md = d2 to the first center on valid rows, _NEG elsewhere.
    ws = ops.gon_workspace(m, points, impl=impl)
    for i in range(k):
        # the far point of step i is argmax(md), the center the reference
        # picks next; step k - 1's slot k is past the end and not written
        md, far_v, _ = ops.fused_min_argmax(points, centers[:, i], md, impl=impl,
                                            ws=ws, centers=centers,
                                            indices=indices, slot=i + 1,
                                            chunk=chunk)
    # far_v = max(md): the covering radius, or _NEG on a machine with no
    # valid row; masked-out points carry _NEG, clamped to 0 in the
    # covered-distance vector we hand back.
    return GonzalezResult(centers, indices, far_v.clamp_min(0.0),
                          md.clamp_min(0.0))


def _source_row(source, idx: int, rows: int) -> np.ndarray:
    """Row ``idx`` of a source: random access where the source offers it
    (every built-in source does), else by streaming host blocks up to it."""
    if not 0 <= idx < source.n:
        raise IndexError(f"row {idx} out of range for n={source.n}")
    if hasattr(source, "row"):
        return np.asarray(source.row(idx), np.float32)
    off = 0
    for blk in ops.host_blocks_of(source, rows):
        if idx < off + blk.shape[0]:
            return blk[idx - off]
        off += blk.shape[0]
    raise IndexError(f"source exhausted before row {idx}")  # pragma: no cover


def _gonzalez_source(source, k: int, *, first: int = 0, impl: str = "auto",
                     chunk: int | None = None, block_rows: int | None = None,
                     memory_budget: int | None = None,
                     device=None) -> GonzalezResult:
    """Out-of-core GON: k streamed passes over a point source.

    Each pass folds the GON step over the source's blocks: the running
    min-distance update and the search for the next center happen in the
    same pass. The running (value, global row, coordinates) of the farthest
    point is a carry on the device that the step itself folds, taking a
    block's far point on strict ``>`` (or unconditionally on the pass's
    first block), so the earliest block keeps a tie, as the in-memory
    argmax does; every block also copies the carry into the next center's
    slot, which no block of the pass reads (the pass reads its own slot).
    So a block is one launch, and no value is read back to the host in the
    loop. The per-point distances (n floats) live in host memory, pinned
    where the device is CUDA, and move through one block-sized device
    buffer with each block on the current stream, so the device holds only
    the ring's blocks and one block's distances.
    """
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    dev = resolve_device(device)
    n, d = source.n, source.d
    rows = ops.resolve_block_rows(n, d, block_rows=block_rows,
                                  memory_budget=memory_budget)
    # +BIG before the first pass: its GON step leaves md = d2 to the first center
    md_host = torch.full((n,), float(_BIG), dtype=torch.float32,
                         pin_memory=dev.type == "cuda")
    md = torch.empty((1, rows), dtype=torch.float32, device=dev)
    centers = torch.empty((1, k, d), dtype=torch.float32, device=dev)
    indices = torch.empty((1, k), dtype=torch.int32, device=dev)
    row = torch.from_numpy(_source_row(source, first, rows))
    if dev.type == "cuda":
        row = row.pin_memory()      # so that the upload does not wait
    centers[0, 0].copy_(row, non_blocking=True)
    indices[:, 0] = first
    carry = (torch.empty((1,), dtype=torch.float32, device=dev),
             torch.empty((1,), dtype=torch.int64, device=dev),
             torch.empty((1, d), dtype=torch.float32, device=dev))
    ws = ops.gon_workspace(1, md, impl=impl)
    for i in range(k):
        off = 0
        for blk in engine._source_blocks(source, rows, None, dev):
            nb = blk.shape[0]
            mdb = md[:, :nb]
            mdb[0].copy_(md_host[off:off + nb], non_blocking=True)
            ops.fused_min_argmax(blk[None], centers[:, i], mdb, impl=impl, ws=ws,
                                 centers=centers, indices=indices, slot=i + 1,
                                 carry=carry, off=off, reset=off == 0,
                                 chunk=chunk)
            md_host[off:off + nb].copy_(mdb[0], non_blocking=True)
            off += nb
    if dev.type == "cuda":
        # the host reads md_host below: wait for the last block's copy back
        torch.cuda.current_stream(dev).synchronize()
    return GonzalezResult(centers[0], indices[0], torch.clamp_min(carry[0][0], 0.0),
                          md_host.clamp_min(0.0))


def covering_radius(points, centers, *, mask=None, impl: str = "auto",
                    chunk: int | None = None, block_rows: int | None = None,
                    memory_budget: int | None = None,
                    device=None) -> torch.Tensor:
    """Euclidean covering radius of ``centers`` over (masked) ``points``.

    ``points`` may be a point source; a host, disk or generator source
    folds the radius block by block (``ops.fold_min_d2``) so the input is
    never whole on the device. ``mask`` is not supported for streamed
    sources. ``chunk`` bounds the plain route's (chunk, k) tiles.
    ``device=None`` means ``"cuda"``."""
    dev = resolve_device(device)
    if is_source(points) and not isinstance(points, ArraySource):
        if mask is not None:
            raise ValueError("mask is not supported for streamed PointSources")
        return torch.sqrt(ops.fold_min_d2(points, centers, impl=impl,
                                          chunk=chunk, block_rows=block_rows,
                                          memory_budget=memory_budget,
                                          device=dev))
    _, d2 = ops.assign_nearest(as_points(points, dev), as_points(centers, dev),
                               impl=impl, chunk=chunk)
    if mask is not None:
        d2 = torch.where(torch.as_tensor(mask, device=dev), d2, 0.0)
    return torch.sqrt(d2.max())
