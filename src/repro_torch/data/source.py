"""Out-of-core point sources (port of ``repro.data.source``).

A ``PointSource`` says where points live (device memory, host RAM, on-disk
shards, a generator program) apart from how the algorithms consume them:
whole, or as a stream of blocks bounded by a memory budget. Executors
(``repro_torch.core.executor``) impose the machine blocking on top.

Sources:

  * ``ArraySource``     — a tensor on its device; slicing is zero-copy.
  * ``HostSource``      — host numpy, streamed to the card block by block.
  * ``MemmapSource``    — on-disk ``.npy`` shards opened with
                          ``mmap_mode="r"``; blocks are global row ranges,
                          so a block may span a shard boundary.
  * ``SyntheticSource`` — a generator program; each block is made on
                          demand, so the full set is never held anywhere
                          (``synthetic_source`` builds one from the
                          ``pointsets`` families).

``blocks(block_rows)`` yields float32 tensors of at most ``block_rows``
rows covering ``[0, n)`` in order and may be called any number of times.
Host-backed sources upload through ``stream_device``: a ring of pinned host
buffers copied to device slots on a CUDA side stream, ``prefetch`` blocks
ahead of the consumed one, so ``1 + prefetch`` blocks are device-resident at
the peak — the engine's residency model ``(1+prefetch)·4·rows·(d+1)``.
A yielded block is valid until the consumer asks for the next one: the
slot is then refilled, so a consumer keeps a copy of any row it needs
later. On the CPU, ``blocks`` yields plain tensors.

``row(idx)`` and ``take(indices)`` are host-side random access (numpy
results). ``synthetic_source("unif", ...)`` reproduces ``pointsets.unif``
bitwise under any blocking; ``gau``/``unb`` share the monolithic cluster
centers and draw per-block noise from child seeds.

``WeightedSource`` attaches host-resident per-row f32 weights to any
source: a weighted instance. Its ``weighted_blocks`` yields each block with
its weights, which ride in the unused ``+1`` column of the block's ring
slot (the residency model's per-row carry), so a block and its weights are
copied and released together. ``has_weights``, ``weights_of`` and
``take_weights`` give unit weights for every other source.

``IndexedSource`` is a view of a parent source through sorted global row
indices: the compacted relation of the streamed EIM. The other view
sources (slice, sharded, process-sharded) are not ported yet.
"""
from __future__ import annotations

import os
from collections import deque
from typing import Callable, Iterator, Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from repro_torch.device import resolve_device, upload
# the ring depth's one home is the engine's residency model
from repro_torch.kernels.engine import DEFAULT_PREFETCH

from . import pointsets


@runtime_checkable
class PointSource(Protocol):
    """Anything with ``n``, ``d`` and restartable block iteration."""

    @property
    def n(self) -> int: ...

    @property
    def d(self) -> int: ...

    def blocks(self, block_rows: int) -> Iterator[torch.Tensor]: ...


def is_source(x) -> bool:
    """Duck-typed source check, safe on tensors and numpy arrays."""
    return hasattr(x, "blocks") and hasattr(x, "n") and hasattr(x, "d")


def as_source(x) -> "PointSource":
    """Coerce to a PointSource: sources pass through, host numpy becomes a
    ``HostSource``, a tensor an ``ArraySource`` on its own device."""
    if is_source(x):
        return x
    if isinstance(x, np.ndarray):
        return HostSource(x)
    return ArraySource(x)


def _check_rows(block_rows: int) -> int:
    if block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    return int(block_rows)


def has_weights(source) -> bool:
    """True iff ``source`` carries per-row weights (a ``WeightedSource``).
    Duck-typed, so the check is safe on any source."""
    return bool(getattr(source, "has_weights", False))


def weights_of(source, start: int, rows: int) -> np.ndarray:
    """f32 weights of rows ``[start, start + rows)`` of ``source``: ones for
    a source without weights, so every weighted fold runs on every source
    and, with unit weights, computes the plain objective. A source that says
    it has weights but has no ``weights_of`` method raises."""
    fn = getattr(source, "weights_of", None)
    if fn is None:
        if has_weights(source):
            raise NotImplementedError(
                f"{type(source).__name__} says it has weights but has no "
                "weights_of: a weighted source must give its row weights")
        return np.ones((int(rows),), np.float32)
    w = np.asarray(fn(start, rows), np.float32).reshape(-1)
    if w.shape[0] != rows:
        raise ValueError(
            f"weights_of({start}, {rows}) returned {w.shape[0]} weights")
    return w


def take_weights(source, indices) -> np.ndarray:
    """f32 weights of the gathered rows ``indices`` (ones when unweighted:
    the gather-side sibling of ``weights_of``)."""
    fn = getattr(source, "take_weights", None)
    idx = np.asarray(indices, np.int64).reshape(-1)
    if fn is None:
        return np.ones((idx.size,), np.float32)
    w = np.asarray(fn(idx), np.float32).reshape(-1)
    if w.shape[0] != idx.size:
        raise ValueError(
            f"take_weights returned {w.shape[0]} weights for "
            f"{idx.size} indices")
    return w


def _check_take_indices(indices, n: int) -> np.ndarray:
    idx = np.asarray(indices, np.int64).reshape(-1)
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise IndexError(
            f"take indices out of range [0, {n}): "
            f"min={idx.min()}, max={idx.max()}")
    return idx


def stream_device(host_blocks: Iterator[np.ndarray],
                  prefetch: int = DEFAULT_PREFETCH,
                  device=None, weights: np.ndarray | None = None
                  ) -> Iterator[torch.Tensor]:
    """Upload numpy blocks to ``device`` (``None`` means ``"cuda"``) and
    yield them as float32 tensors, in order. With ``weights`` (the f32 row
    weights of the whole stream, on the host) it yields ``(block, block's
    weights)`` pairs instead.

    On a CUDA device the blocks go through a ring of ``1 + prefetch``
    slots, each a pinned host buffer and a device buffer. A block is copied
    into its slot's pinned buffer on the host, then to the device buffer
    with ``non_blocking=True`` on a side stream, up to ``prefetch`` blocks
    ahead of the one the consumer holds. A block's weights sit in the same
    slot right after its points (``rows·d`` floats, then ``rows``: the
    residency model's ``+1`` column), so one copy carries both. Two events
    per slot order it:

      * ``copied`` (side stream, after the copy): the consumer's stream
        waits on it before the block is handed over, and the host waits on
        it before it writes the pinned buffer again;
      * ``consumed`` (consumer's stream, recorded when the consumer asks
        for the next block, so after every kernel it launched on this
        block): the side stream waits on it before it overwrites the
        device buffer.

    No step waits for the device except the host's wait for a pinned
    buffer's previous copy. On the CPU the blocks are copied into plain
    tensors. ``stream_device.uploads`` counts the blocks uploaded to a CUDA
    device."""
    if prefetch < 1:
        raise ValueError(f"prefetch must be >= 1, got {prefetch}")
    dev = resolve_device(device)
    if dev.type != "cuda":
        return _cpu_blocks(host_blocks, dev, weights)
    return _cuda_ring(iter(host_blocks), prefetch, dev, weights)


stream_device.uploads = 0


def _cpu_blocks(host_blocks, dev: torch.device, weights):
    off = 0
    for blk in host_blocks:
        x = torch.from_numpy(np.array(blk, np.float32)).to(dev)
        if weights is None:
            yield x
        else:
            nb = x.shape[0]
            yield x, torch.from_numpy(np.array(weights[off:off + nb],
                                               np.float32)).to(dev)
            off += nb


class _Slot:
    """One ring slot: pinned host buffer, device buffer and their events,
    flat, holding a block's ``rows·d`` points and, when weighted, its
    ``rows`` weights after them."""

    def __init__(self, size: int, consumer, side):
        self.pinned = torch.empty((size,), dtype=torch.float32,
                                  pin_memory=True)
        self.buf = torch.empty((size,), dtype=torch.float32,
                               device=consumer.device)
        # The allocator handed out memory ordered on the consumer's stream
        # only: the side stream writes it after the consumer's queued work,
        # and the allocator reuses it after the side stream's copies.
        self.buf.record_stream(side)
        side.wait_stream(consumer)
        self.copied = torch.cuda.Event()
        self.consumed = torch.cuda.Event()
        self.used = False     # events recorded at least once


def _cuda_ring(it, prefetch: int, dev: torch.device, weights):
    consumer = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    slots: list[_Slot | None] = [None] * (1 + prefetch)
    ring: deque = deque()       # (slot, rows, d) in flight, in order
    count = 0
    off = 0                     # the next block's first row

    def put(blk: np.ndarray) -> None:
        nonlocal count, off
        blk = np.asarray(blk, np.float32)
        if blk.ndim != 2:
            raise ValueError(f"expected a (rows, d) block, got {blk.shape}")
        nb, d = blk.shape
        size = nb * (d + (weights is not None))
        s = count % len(slots)
        count += 1
        slot = slots[s]
        if slot is not None and slot.used:
            slot.copied.synchronize()      # the pinned buffer is free again
        if slot is None or slot.buf.shape[0] < size:
            slot = slots[s] = _Slot(size, consumer, side)
        host = slot.pinned[:size].numpy()
        host[:nb * d].reshape(nb, d)[...] = blk
        if weights is not None:
            w = weights[off:off + nb]
            if w.shape[0] != nb:
                raise ValueError(f"weights end before row {off + nb}")
            host[nb * d:] = w
        off += nb
        with torch.cuda.stream(side):
            if slot.used:
                side.wait_event(slot.consumed)
            slot.buf[:size].copy_(slot.pinned[:size], non_blocking=True)
            slot.copied.record(side)
        slot.used = True
        stream_device.uploads += 1
        ring.append((slot, nb, d))

    def fill() -> None:
        while len(ring) < prefetch:
            blk = next(it, None)
            if blk is None:
                return
            put(blk)

    fill()
    while ring:
        slot, nb, d = ring.popleft()
        consumer.wait_event(slot.copied)
        fill()          # the next blocks' copies start before this one is used
        x = slot.buf[:nb * d].view(nb, d)
        yield x if weights is None else (x, slot.buf[nb * d:nb * (d + 1)])
        slot.consumed.record(consumer)


class ArraySource:
    """An ``(n, d)`` tensor on a device (or a numpy array uploaded to
    ``device``, ``None`` meaning ``"cuda"``; a tensor given without a
    device stays where it is)."""

    def __init__(self, array, *, device=None):
        if isinstance(array, torch.Tensor) and device is None:
            dev = array.device
        else:
            dev = resolve_device(device)
        if isinstance(array, np.ndarray):
            array = torch.from_numpy(np.array(array, np.float32))
        self._x = array.to(device=dev, dtype=torch.float32).contiguous()
        if self._x.dim() != 2:
            raise ValueError(
                f"expected (n, d) points, got shape {tuple(self._x.shape)}")

    @property
    def n(self) -> int:
        return self._x.shape[0]

    @property
    def d(self) -> int:
        return self._x.shape[1]

    @property
    def device(self) -> torch.device:
        return self._x.device

    def blocks(self, block_rows: int, *, prefetch: int = DEFAULT_PREFETCH,
               device=None) -> Iterator[torch.Tensor]:
        """Zero-copy row slices (moved to ``device`` when one is given and
        differs from the tensor's own)."""
        del prefetch  # already resident
        rows = _check_rows(block_rows)
        for start in range(0, self.n, rows):
            blk = self._x[start:start + rows]
            yield blk if device is None else blk.to(device)

    def row(self, idx: int) -> np.ndarray:
        return self._x[idx].cpu().numpy()

    def take(self, indices) -> np.ndarray:
        """Gather rows ``indices`` (host numpy result)."""
        idx = _check_take_indices(indices, self.n)
        sel = torch.from_numpy(idx).to(self._x.device)
        return self._x.index_select(0, sel).cpu().numpy()

    def materialize(self, device=None) -> torch.Tensor:
        return self._x if device is None else self._x.to(device)


class _HostBacked:
    """Shared stream and materialize of the host-side sources, built on
    their ``host_blocks``."""

    def blocks(self, block_rows: int, *, prefetch: int = DEFAULT_PREFETCH,
               device=None) -> Iterator[torch.Tensor]:
        """Blocks uploaded to ``device`` (``None`` means ``"cuda"``)
        through the pinned ring of ``stream_device``."""
        return stream_device(self.host_blocks(block_rows), prefetch, device)

    def materialize(self, device=None) -> torch.Tensor:
        """The whole set as one tensor on ``device`` (for consumers that
        need random access, as ``SimExecutor`` does)."""
        dev = resolve_device(device)
        return torch.cat([torch.from_numpy(np.array(b, np.float32))
                          for b in self.host_blocks(1 << 20)]).to(dev)


class HostSource(_HostBacked):
    """Host-resident numpy points streamed to the device block by block."""

    def __init__(self, array: np.ndarray):
        self._x = np.asarray(array, np.float32)
        if self._x.ndim != 2:
            raise ValueError(f"expected (n, d) points, got shape {self._x.shape}")

    @property
    def n(self) -> int:
        return self._x.shape[0]

    @property
    def d(self) -> int:
        return self._x.shape[1]

    def host_blocks(self, block_rows: int) -> Iterator[np.ndarray]:
        """Numpy blocks with no device transfer."""
        rows = _check_rows(block_rows)
        for start in range(0, self.n, rows):
            yield self._x[start:start + rows]

    def row(self, idx: int) -> np.ndarray:
        return self._x[idx]

    def take(self, indices) -> np.ndarray:
        """Gather rows ``indices`` — a plain numpy fancy index."""
        return self._x[_check_take_indices(indices, self.n)]


class MemmapSource(_HostBacked):
    """On-disk ``.npy`` shards, memory-mapped; n is bounded by disk.

    ``paths`` is one path or an ordered sequence of shard paths,
    concatenated along rows. Blocks are global row ranges, so a block may
    span a shard boundary (the pieces are joined on the host before the
    upload)."""

    def __init__(self, paths: str | os.PathLike | Sequence[str | os.PathLike]):
        if isinstance(paths, (str, os.PathLike)):
            paths = [paths]
        if not paths:
            raise ValueError("MemmapSource needs at least one shard path")
        self._paths = [str(p) for p in paths]
        self._maps = [np.load(p, mmap_mode="r") for p in self._paths]
        d = self._maps[0].shape[1]
        for p, m in zip(self._paths, self._maps):
            if m.ndim != 2 or m.shape[1] != d:
                raise ValueError(
                    f"shard {p} has shape {m.shape}, expected (rows, {d})")
        self._offsets = np.cumsum([0] + [m.shape[0] for m in self._maps])

    @property
    def n(self) -> int:
        return int(self._offsets[-1])

    @property
    def d(self) -> int:
        return int(self._maps[0].shape[1])

    @property
    def num_shards(self) -> int:
        return len(self._paths)

    def _slice(self, start: int, stop: int) -> np.ndarray:
        """Rows ``[start, stop)`` of the concatenation, as f32. Only the
        shards overlapping the range are touched, found by
        ``np.searchsorted`` on the cumulative offsets."""
        if stop <= start:
            return np.zeros((0, self.d), np.float32)
        first = int(np.searchsorted(self._offsets, start, side="right")) - 1
        last = int(np.searchsorted(self._offsets, stop, side="left"))
        pieces = []
        for s in range(max(first, 0), last):
            off = int(self._offsets[s])
            m = self._maps[s]
            lo = max(start - off, 0)
            hi = min(stop - off, m.shape[0])
            if lo < hi:
                pieces.append(np.asarray(m[lo:hi], np.float32))
        if len(pieces) == 1:
            return pieces[0]
        return np.concatenate(pieces, axis=0)

    def host_blocks(self, block_rows: int) -> Iterator[np.ndarray]:
        """Numpy blocks with no device transfer."""
        rows = _check_rows(block_rows)
        for start in range(0, self.n, rows):
            yield self._slice(start, min(start + rows, self.n))

    def row(self, idx: int) -> np.ndarray:
        return self._slice(idx, idx + 1)[0]

    def take(self, indices) -> np.ndarray:
        """Gather rows ``indices`` across shards: each shard is
        fancy-indexed once with its share of the indices."""
        idx = _check_take_indices(indices, self.n)
        out = np.empty((idx.size, self.d), np.float32)
        shard = np.searchsorted(self._offsets, idx, side="right") - 1
        for s in np.unique(shard):
            sel = shard == s
            out[sel] = np.asarray(
                self._maps[s][idx[sel] - self._offsets[s]], np.float32)
        return out

    @classmethod
    def save_shards(cls, array: np.ndarray, dirpath: str | os.PathLike, *,
                    rows_per_shard: int) -> "MemmapSource":
        """Write ``array`` as numbered ``.npy`` shards under ``dirpath``."""
        rows_per_shard = _check_rows(rows_per_shard)
        array = np.asarray(array, np.float32)
        os.makedirs(dirpath, exist_ok=True)
        paths = []
        for i, start in enumerate(range(0, array.shape[0], rows_per_shard)):
            p = os.path.join(str(dirpath), f"shard_{i:05d}.npy")
            np.save(p, array[start:start + rows_per_shard])
            paths.append(p)
        return cls(paths)


class SyntheticSource(_HostBacked):
    """Blocks computed on demand by ``block_fn(start, rows) -> (rows, d)``,
    which must be deterministic in ``(start, rows)`` so that the stream can
    restart. The full set is never held anywhere."""

    def __init__(self, block_fn: Callable[[int, int], np.ndarray], n: int,
                 d: int | None = None, *, name: str = "synthetic"):
        self._fn = block_fn
        self._n = int(n)
        if d is None:
            d = int(np.asarray(block_fn(0, 1)).shape[1])
        self._d = int(d)
        self.name = name

    @property
    def n(self) -> int:
        return self._n

    @property
    def d(self) -> int:
        return self._d

    def host_blocks(self, block_rows: int) -> Iterator[np.ndarray]:
        """Numpy blocks with no device transfer."""
        rows = _check_rows(block_rows)
        for start in range(0, self._n, rows):
            yield np.asarray(self._fn(start, min(rows, self._n - start)),
                             np.float32)

    def row(self, idx: int) -> np.ndarray:
        return np.asarray(self._fn(idx, 1), np.float32)[0]

    def take(self, indices) -> np.ndarray:
        """Gather rows ``indices`` by regeneration: each maximal run of
        consecutive indices costs one ``block_fn`` call."""
        idx = _check_take_indices(indices, self.n)
        out = np.empty((idx.size, self._d), np.float32)
        i = 0
        while i < idx.size:
            j = i + 1
            while j < idx.size and idx[j] == idx[j - 1] + 1:
                j += 1
            out[i:j] = np.asarray(self._fn(int(idx[i]), int(j - i)),
                                  np.float32)
            i = j
        return out


class IndexedSource(_HostBacked):
    """A view of a parent source through sorted global row indices.

    View row ``j`` is parent row ``indices[j]``: the streamed EIM compacts
    its shrinking relation into such a view, so a fold touches only the
    surviving rows, while every row keeps the parent's absolute index (the
    Philox counter the Round-1 sampler keys on). ``indices`` must be
    strictly increasing, so the view keeps global row order (value folds
    stay bitwise the uncompacted pass) and ``take`` meets maximal runs of
    consecutive rows in the parent. Views of views compose:
    ``IndexedSource(IndexedSource(p, a), b)`` is ``IndexedSource(p,
    a[b])``. Blocks are gathered on the host by the parent's ``take`` and
    uploaded through the pinned ring.

    >>> import numpy as np
    >>> v = IndexedSource(HostSource(np.arange(10, dtype=np.float32)[:, None]),
    ...                   [1, 4, 7])
    >>> v.n, v.take([2]).tolist(), IndexedSource(v, [0, 2]).indices.tolist()
    (3, [[7.0]], [1, 7])
    """

    def __init__(self, parent, indices):
        idx = np.asarray(indices, np.int64).reshape(-1)
        if idx.size:
            if idx.min() < 0 or idx.max() >= parent.n:
                raise IndexError(
                    f"view indices out of range [0, {parent.n}): "
                    f"min={idx.min()}, max={idx.max()}")
            if idx.size > 1 and (np.diff(idx) <= 0).any():
                raise ValueError(
                    "IndexedSource indices must be strictly increasing "
                    "(sorted, no duplicates): the view keeps global row order")
        if isinstance(parent, IndexedSource):
            idx = parent._idx[idx]
            parent = parent._parent
        self._parent = parent
        self._idx = idx

    @property
    def parent(self):
        return self._parent

    @property
    def indices(self) -> np.ndarray:
        """The root-composed global row indices of the view."""
        return self._idx

    @property
    def n(self) -> int:
        return int(self._idx.size)

    @property
    def d(self) -> int:
        return self._parent.d

    def host_blocks(self, block_rows: int) -> Iterator[np.ndarray]:
        """Numpy blocks gathered from the parent, no device transfer."""
        rows = _check_rows(block_rows)
        for start in range(0, self.n, rows):
            yield self._parent.take(self._idx[start:start + rows])

    def row(self, idx: int) -> np.ndarray:
        if not 0 <= idx < self.n:
            raise IndexError(f"row {idx} out of range for n={self.n}")
        return self._parent.row(int(self._idx[idx]))

    def take(self, indices) -> np.ndarray:
        """Gather view rows: composed through to the parent's indices."""
        return self._parent.take(self._idx[_check_take_indices(indices,
                                                               self.n)])

    @property
    def has_weights(self) -> bool:
        return has_weights(self._parent)

    def weights_of(self, start: int, rows: int) -> np.ndarray:
        return take_weights(self._parent, self._idx[start:start + rows])

    def take_weights(self, indices) -> np.ndarray:
        return take_weights(self._parent,
                            self._idx[_check_take_indices(indices, self.n)])

    def materialize(self, device=None) -> torch.Tensor:
        """The view's rows as one tensor on ``device`` (``None`` means
        ``"cuda"``): one gather from the parent."""
        return upload(self._parent.take(self._idx), resolve_device(device))


class WeightedSource:
    """Any source plus per-row f32 weights: a weighted instance.

    The weighted objectives (Ceccarello et al., arXiv 1802.09205) work on
    points that carry multiplicities, such as coreset points standing in
    for their clusters. The points are the parent's, untouched (same
    blocks, same bits); the ``(n,)`` weights stay on the host, 4 bytes a
    row, and reach the device block by block with the points
    (``weighted_blocks``). Weights must be finite and non-negative;
    ``w == 0`` marks a row as absent from the instance (the weighted folds
    gate it out of candidacy).

    >>> import numpy as np
    >>> src = WeightedSource(HostSource(np.zeros((4, 2), np.float32)),
    ...                      [1, 0, 2, 1])
    >>> src.has_weights, src.n, weights_of(src, 1, 2).tolist()
    (True, 4, [0.0, 2.0])
    """

    def __init__(self, parent, weights):
        parent = as_source(parent)
        w = np.asarray(weights, np.float32).reshape(-1)
        if w.shape[0] != parent.n:
            raise ValueError(
                f"weights have {w.shape[0]} rows, source has {parent.n}")
        if w.size and (not np.all(np.isfinite(w)) or w.min() < 0):
            raise ValueError("weights must be finite and non-negative")
        self._parent = parent
        self._w = w

    @property
    def parent(self):
        return self._parent

    @property
    def has_weights(self) -> bool:
        return True

    @property
    def n(self) -> int:
        return self._parent.n

    @property
    def d(self) -> int:
        return self._parent.d

    def weights_of(self, start: int, rows: int) -> np.ndarray:
        return self._w[start:start + rows]

    def take_weights(self, indices) -> np.ndarray:
        return self._w[_check_take_indices(indices, self.n)]

    def host_blocks(self, block_rows: int) -> Iterator[np.ndarray]:
        if hasattr(self._parent, "host_blocks"):
            yield from self._parent.host_blocks(block_rows)
        else:
            for blk in self._parent.blocks(block_rows, device="cpu"):
                yield blk.numpy()

    def blocks(self, block_rows: int, *, prefetch: int = DEFAULT_PREFETCH,
               device=None) -> Iterator[torch.Tensor]:
        """The parent's blocks (the weights are not needed)."""
        return self._parent.blocks(block_rows, prefetch=prefetch,
                                   device=device)

    def weighted_blocks(self, block_rows: int, *,
                        prefetch: int = DEFAULT_PREFETCH, device=None):
        """``(points, weights)`` blocks on ``device`` (``None`` means
        ``"cuda"``). A host-backed parent's blocks carry their weights in
        the same ring slot (``stream_device``); a device-resident parent's
        zero-copy slices come with slices of the weights, uploaded once."""
        if hasattr(self._parent, "host_blocks"):
            return stream_device(self._parent.host_blocks(block_rows),
                                 prefetch, device, weights=self._w)
        return self._resident_weighted_blocks(block_rows, prefetch, device)

    def _resident_weighted_blocks(self, block_rows, prefetch, device):
        w_dev, off = None, 0
        for blk in self._parent.blocks(block_rows, prefetch=prefetch,
                                       device=device):
            if w_dev is None:
                w_dev = upload(self._w, blk.device)
            yield blk, w_dev[off:off + blk.shape[0]]
            off += blk.shape[0]

    def row(self, idx: int) -> np.ndarray:
        return self._parent.row(idx)

    def take(self, indices) -> np.ndarray:
        return self._parent.take(indices)

    def materialize(self, device=None) -> torch.Tensor:
        return self._parent.materialize(device)


def _philox_at(seed: int, offset: int) -> np.random.Generator:
    """Generator positioned at double-draw ``offset`` of the Philox stream.

    ``Philox.advance(delta)`` moves in whole 4x64 counter blocks (4 doubles
    each), so advance to the containing block and discard the remainder."""
    bg = np.random.Philox(key=np.uint64(seed))
    bg.advance(offset // 4)
    g = np.random.Generator(bg)
    if offset % 4:
        g.random(offset % 4)
    return g


def _child_seed(seed: int, start: int) -> np.random.Generator:
    ss = np.random.SeedSequence(entropy=[np.uint64(seed), np.uint64(start)])
    return np.random.Generator(np.random.Philox(ss))


def synthetic_source(name: str, n: int, *, seed: int = 0,
                     **kwargs) -> SyntheticSource:
    """Out-of-core view of a ``pointsets`` family (paper §7.3).

    ``unif`` is bitwise ``pointsets.unif(n, ...)`` under any blocking.
    ``gau``/``unb`` share the monolithic generator's cluster centers but
    draw per-block assignments and noise from child seeds. Other families
    use per-block child seeds.

    >>> s = synthetic_source("unif", 100, d=2, seed=0)
    >>> s.n, s.d
    (100, 2)
    >>> s.take([0, 1]).shape        # regenerated, never stored
    (2, 2)
    """
    if name == "unif":
        d = int(kwargs.get("d", 2))
        side = float(kwargs.get("side", 100.0))

        def block_fn(start: int, rows: int) -> np.ndarray:
            g = _philox_at(seed, start * d)
            return (g.random((rows, d)) * side).astype(np.float32)

        return SyntheticSource(block_fn, n, d, name=name)

    if name in ("gau", "unb"):
        gen = pointsets.GENERATORS[name]
        k_prime = int(kwargs.get("k_prime", 25))
        d = int(kwargs.get("d", 2))
        side = float(kwargs.get("side", 100.0))
        # the monolithic generator's first draw, shared by every block
        centers = (pointsets._rng(seed).random((k_prime, d)) * side
                   ).astype(np.float32)

        def block_fn(start: int, rows: int) -> np.ndarray:
            child = int(_child_seed(seed, start).integers(0, 2 ** 63))
            return gen(rows, k_prime, d, seed=child, centers=centers,
                       **{k: v for k, v in kwargs.items()
                          if k not in ("k_prime", "d", "side")})

        return SyntheticSource(block_fn, n, d, name=name)

    if name in pointsets.GENERATORS:
        gen = pointsets.GENERATORS[name]

        def block_fn(start: int, rows: int) -> np.ndarray:
            child = int(_child_seed(seed, start).integers(0, 2 ** 63))
            return gen(rows, seed=child, **kwargs)

        return SyntheticSource(block_fn, n, name=name)

    raise ValueError(f"unknown generator {name!r}; "
                     f"have {sorted(pointsets.GENERATORS)}")
