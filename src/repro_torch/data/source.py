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
indices: the compacted relation of the streamed EIM. ``SliceSource`` is a
contiguous row range of a parent, and ``ShardedSource`` one source per
machine shard, the paper's partitioned input (``shard_source`` splits one
source into the paper's contiguous machine ranges); the mesh executor
streams each shard's blocks in lockstep. In a multi-process run
(``repro_torch.launch.cluster``) each process holds a
``ProcessShardedSource``: its own shards, and a ``RemoteShard`` (sizes
only, any data access raises) for each shard of another process; its
``take`` is a collective, the paper's O(k) candidate exchange.
"""
from __future__ import annotations

import os
from collections import deque
from typing import Callable, Iterator, Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from repro_torch import compat
from repro_torch.device import resolve_device, upload
# the ring depth's one home is the engine's residency model
from repro_torch.kernels.engine import DEFAULT_PREFETCH, host_blocks_of

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
                  device=None, *, paired: bool = False
                  ) -> Iterator[torch.Tensor]:
    """Upload numpy blocks to ``device`` (``None`` means ``"cuda"``) and
    yield them as float32 tensors, in order. With ``paired=True`` each host
    item is a ``(block, per-row f32 column)`` pair (the block's weights) and
    it yields ``(block, column)`` pairs.

    On a CUDA device the blocks go through a ring of ``1 + prefetch``
    slots, each a pinned host buffer and a device buffer. A block is copied
    into its slot's pinned buffer on the host, then to the device buffer
    with ``non_blocking=True`` on a side stream, up to ``prefetch`` blocks
    ahead of the one the consumer holds. A block's column sits in the same
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
        return _cpu_blocks(host_blocks, dev, paired)
    return _cuda_ring(iter(host_blocks), prefetch, dev, paired)


stream_device.uploads = 0


def _split_item(item, paired: bool):
    """``(points, column or None)`` of one host item of ``stream_device``."""
    blk, col = item if paired else (item, None)
    blk = np.asarray(blk, np.float32)
    if blk.ndim != 2:
        raise ValueError(f"expected a (rows, d) block, got {blk.shape}")
    if col is not None:
        col = np.asarray(col, np.float32).reshape(-1)
        if col.shape[0] != blk.shape[0]:
            raise ValueError(f"a block of {blk.shape[0]} rows came with "
                             f"{col.shape[0]} weights")
    return blk, col


def _cpu_blocks(host_blocks, dev: torch.device, paired: bool):
    for item in host_blocks:
        blk, col = _split_item(item, paired)
        x = torch.from_numpy(np.array(blk)).to(dev)
        yield x if col is None else (x, torch.from_numpy(np.array(col)).to(dev))


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


def _cuda_ring(it, prefetch: int, dev: torch.device, paired: bool):
    consumer = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    slots: list[_Slot | None] = [None] * (1 + prefetch)
    ring: deque = deque()       # (slot, rows, d) in flight, in order
    count = 0

    def put(item) -> None:
        nonlocal count
        blk, col = _split_item(item, paired)
        nb, d = blk.shape
        size = nb * (d + paired)
        s = count % len(slots)
        count += 1
        slot = slots[s]
        if slot is not None and slot.used:
            slot.copied.synchronize()      # the pinned buffer is free again
        if slot is None or slot.buf.shape[0] < size:
            slot = slots[s] = _Slot(size, consumer, side)
        host = slot.pinned[:size].numpy()
        host[:nb * d].reshape(nb, d)[...] = blk
        if paired:
            host[nb * d:] = col
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
        yield (x, slot.buf[nb * d:nb * (d + 1)]) if paired else x
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
        if idx.size == 0:
            return out
        # where each maximal run starts, found in one pass (a slice of a
        # million rows is one run: one block_fn call, no per-row loop)
        cuts = np.concatenate([[0], np.flatnonzero(np.diff(idx) != 1) + 1,
                               [idx.size]])
        for a, b in zip(cuts[:-1].tolist(), cuts[1:].tolist()):
            out[a:b] = np.asarray(self._fn(int(idx[a]), b - a), np.float32)
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


class SliceSource(_HostBacked):
    """Contiguous-row view ``[start, stop)`` of a parent source.

    The machine-shard sibling of ``IndexedSource``: a slice view is three
    integers, so ``shard_source`` splits an n-row source into per-machine
    shards without any O(n) structure on the host. Blocks are gathered by
    the parent's ``take`` (a maximal run of consecutive rows, which every
    built-in source serves cheaply) and uploaded through the pinned ring,
    so streaming a shard costs O(block_rows) working memory. Nested slices
    compose: ``SliceSource(SliceSource(p, a, b), c, d)`` points at ``p``
    through ``[a + c, a + d)``.

    >>> import numpy as np
    >>> v = SliceSource(HostSource(np.arange(10, dtype=np.float32)[:, None]),
    ...                 2, 6)
    >>> v.n, v.take([0, 3]).ravel().tolist(), SliceSource(v, 1, 3).start
    (4, [2.0, 5.0], 3)
    """

    def __init__(self, parent, start: int, stop: int):
        start, stop = int(start), int(stop)
        if not hasattr(parent, "take"):
            raise TypeError(
                f"SliceSource needs a parent with take() for run gathers; "
                f"{type(parent).__name__} does not provide it")
        if not 0 <= start <= stop <= parent.n:
            raise ValueError(
                f"slice [{start}, {stop}) out of range for n={parent.n}")
        if isinstance(parent, SliceSource):
            start += parent._start
            stop += parent._start
            parent = parent._parent
        self._parent = parent
        self._start = start
        self._stop = stop

    @property
    def parent(self):
        return self._parent

    @property
    def start(self) -> int:
        """First (root-composed) parent row of the view."""
        return self._start

    @property
    def stop(self) -> int:
        """One past the last parent row of the view."""
        return self._stop

    @property
    def n(self) -> int:
        return self._stop - self._start

    @property
    def d(self) -> int:
        return self._parent.d

    def host_blocks(self, block_rows: int) -> Iterator[np.ndarray]:
        """Numpy blocks gathered from the parent run by run, no device
        transfer."""
        rows = _check_rows(block_rows)
        for a in range(self._start, self._stop, rows):
            yield self._parent.take(np.arange(a, min(a + rows, self._stop),
                                              dtype=np.int64))

    def row(self, idx: int) -> np.ndarray:
        if not 0 <= idx < self.n:
            raise IndexError(f"row {idx} out of range for n={self.n}")
        return self._parent.row(self._start + idx)

    def take(self, indices) -> np.ndarray:
        """Gather view rows: offset through to the parent."""
        return self._parent.take(_check_take_indices(indices, self.n)
                                 + self._start)

    @property
    def has_weights(self) -> bool:
        return has_weights(self._parent)

    def weights_of(self, start: int, rows: int) -> np.ndarray:
        stop = min(start + rows, self.n)
        return weights_of(self._parent, self._start + start,
                          max(stop - start, 0))

    def take_weights(self, indices) -> np.ndarray:
        return take_weights(self._parent,
                            _check_take_indices(indices, self.n) + self._start)

    def materialize(self, device=None) -> torch.Tensor:
        """The view's rows as one tensor on ``device`` (``None`` means
        ``"cuda"``): one gather from the parent."""
        return upload(self._parent.take(np.arange(self._start, self._stop,
                                                  dtype=np.int64)),
                      resolve_device(device))


class ShardedSource:
    """One point source per machine shard: the paper's input model.

    The MapReduce formulation (§3) assumes the input is already partitioned
    across machines. Shard ``s`` is a source of its own (host numpy, a disk
    shard, a generator, or a ``SliceSource`` of a common parent), and the
    global row order is the shards' concatenation. ``MeshExecutor`` streams
    every shard's blocks in lockstep (``engine.zip_shard_blocks``), so no
    host buffer holds all n rows.

    Build it with ``shard_source(source, shards)`` (zero-copy contiguous
    views of one source) or ``ShardedSource.from_per_host_shards([...])``
    (shards that exist apart). As a plain source it is the concatenation:
    ``blocks`` streams shard after shard, so a block never crosses a shard
    boundary and each shard's last block may be short (value folds do not
    depend on the blocking); ``take`` and ``row`` dispatch on the shard
    offsets; ``materialize`` concatenates (for tests and small n, never on
    the streamed paths).

    >>> import numpy as np
    >>> sh = ShardedSource([HostSource(np.zeros((3, 2), np.float32)),
    ...                     HostSource(np.ones((2, 2), np.float32))])
    >>> sh.n, sh.offsets.tolist(), sh.take([2, 3]).tolist()
    (5, [0, 3, 5], [[0.0, 0.0], [1.0, 1.0]])
    """

    def __init__(self, shards: Sequence):
        shards = list(shards)
        if not shards:
            raise ValueError("ShardedSource needs at least one shard")
        for i, s in enumerate(shards):
            if not is_source(s):
                raise TypeError(
                    f"shard {i} ({type(s).__name__}) is not a PointSource")
        d = shards[0].d
        for i, s in enumerate(shards):
            if s.d != d:
                raise ValueError(
                    f"shard {i} has d={s.d}, expected d={d} (all shards "
                    "must share one point dimension)")
        self._shards = tuple(shards)
        self._offsets = np.cumsum([0] + [s.n for s in shards])

    @classmethod
    def from_per_host_shards(cls, shards: Sequence) -> "ShardedSource":
        """Wrap inputs that are already apart, one source per machine
        (e.g. a ``MemmapSource`` over each machine's ``.npy`` shards). Shard
        order is the global row order. No data moves."""
        return cls(shards)

    @property
    def shards(self) -> tuple:
        return self._shards

    @property
    def num_shards(self) -> int:
        return len(self._shards)

    @property
    def offsets(self) -> np.ndarray:
        """Global first row of each shard, then n: ``(num_shards + 1,)``."""
        return self._offsets.copy()

    @property
    def max_shard_rows(self) -> int:
        """Rows of the largest shard: the per-machine n that the residency
        model (``engine.resolve_block_rows``) is solved against."""
        return max(s.n for s in self._shards)

    @property
    def n(self) -> int:
        return int(self._offsets[-1])

    @property
    def d(self) -> int:
        return self._shards[0].d

    def host_blocks(self, block_rows: int) -> Iterator[np.ndarray]:
        """Numpy blocks, no device transfer: each shard's stream in shard
        order (the global row order)."""
        rows = _check_rows(block_rows)
        for s in self._shards:
            yield from host_blocks_of(s, rows)

    def blocks(self, block_rows: int, *, prefetch: int = DEFAULT_PREFETCH,
               device=None) -> Iterator[torch.Tensor]:
        """Blocks uploaded to ``device`` (``None`` means ``"cuda"``) through
        the pinned ring, shard after shard."""
        return stream_device(self.host_blocks(block_rows), prefetch, device)

    def weighted_blocks(self, block_rows: int, *,
                        prefetch: int = DEFAULT_PREFETCH, device=None):
        """``(points, weights)`` blocks on ``device``, each block's weights
        (its shard's ``weights_of``, ones where a shard has none) in the
        points' ring slot."""
        rows = _check_rows(block_rows)

        def pairs():
            for s in self._shards:
                pos = 0
                for blk in host_blocks_of(s, rows):
                    nb = blk.shape[0]
                    yield blk, weights_of(s, pos, nb)
                    pos += nb

        return stream_device(pairs(), prefetch, device, paired=True)

    def _locate(self, idx: np.ndarray) -> np.ndarray:
        return np.searchsorted(self._offsets, idx, side="right") - 1

    def row(self, idx: int) -> np.ndarray:
        if not 0 <= idx < self.n:
            raise IndexError(f"row {idx} out of range for n={self.n}")
        s = int(self._locate(np.asarray([idx]))[0])
        return np.asarray(self._shards[s].row(int(idx - self._offsets[s])),
                          np.float32)

    def take(self, indices) -> np.ndarray:
        """Gather rows across shards: each shard's ``take`` is called once
        with its share of the indices, in order."""
        idx = _check_take_indices(indices, self.n)
        out = np.empty((idx.size, self.d), np.float32)
        shard = self._locate(idx)
        for s in np.unique(shard):
            sel = shard == s
            out[sel] = np.asarray(
                self._shards[s].take(idx[sel] - self._offsets[s]),
                np.float32)
        return out

    @property
    def has_weights(self) -> bool:
        return any(has_weights(s) for s in self._shards)

    def weights_of(self, start: int, rows: int) -> np.ndarray:
        stop = min(start + rows, self.n)
        out = np.ones((max(stop - start, 0),), np.float32)
        pos = start
        while pos < stop:
            s = int(self._locate(np.asarray([pos]))[0])
            off = int(self._offsets[s])
            hi = min(stop, int(self._offsets[s + 1]))
            out[pos - start:hi - start] = weights_of(
                self._shards[s], pos - off, hi - pos)
            pos = hi
        return out

    def take_weights(self, indices) -> np.ndarray:
        idx = _check_take_indices(indices, self.n)
        out = np.ones((idx.size,), np.float32)
        shard = self._locate(idx)
        for s in np.unique(shard):
            sel = shard == s
            out[sel] = take_weights(self._shards[s],
                                    idx[sel] - self._offsets[s])
        return out

    def materialize(self, device=None) -> torch.Tensor:
        """All rows as one tensor on ``device`` (``None`` means
        ``"cuda"``)."""
        return torch.cat([torch.from_numpy(np.array(b, np.float32))
                          for b in self.host_blocks(1 << 20)]).to(
                              resolve_device(device))


class RemoteShard:
    """The stand-in for a shard whose rows live in another process.

    In a multi-process run no process can read another machine's shard,
    but every process must know the global partition (shard sizes give the
    global row ids, the masks' shapes and the lockstep step count).
    ``RemoteShard`` carries ``n`` and ``d`` and raises on any data access,
    so that no code path can pull a remote row onto this host.

    >>> RemoteShard(5, 2, process=1).take([0])
    Traceback (most recent call last):
    ...
    RuntimeError: shard data lives on process 1; take() cannot run here — multi-process folds read only local shards, and rows move between processes only through the O(k) candidate exchange (ProcessShardedSource.take)
    """

    is_remote = True

    def __init__(self, n: int, d: int, *, process: int = 0):
        if n < 0:
            raise ValueError(f"n must be >= 0, got {n}")
        if d < 1:
            raise ValueError(f"d must be >= 1, got {d}")
        self._n = int(n)
        self._d = int(d)
        self._process = int(process)

    @property
    def n(self) -> int:
        return self._n

    @property
    def d(self) -> int:
        return self._d

    @property
    def process(self) -> int:
        """The process that owns (and feeds) this shard."""
        return self._process

    def _no_data(self, op: str):
        raise RuntimeError(
            f"shard data lives on process {self._process}; {op} cannot run "
            "here — multi-process folds read only local shards, and rows "
            "move between processes only through the O(k) candidate "
            "exchange (ProcessShardedSource.take)")

    def blocks(self, block_rows: int, **kwargs):
        self._no_data("blocks()")

    def host_blocks(self, block_rows: int):
        self._no_data("host_blocks()")

    def row(self, idx: int):
        self._no_data("row()")

    def take(self, indices):
        self._no_data("take()")

    def materialize(self, device=None):
        self._no_data("materialize()")


class ProcessShardedSource(ShardedSource):
    """A ``ShardedSource`` whose remote shards are ``RemoteShard`` stand-ins:
    the input of a multi-process run.

    Every process builds the same global partition (the same shard sizes in
    the same order, so global row ids agree everywhere) but holds data only
    for its own shards. The mesh executor streams the local shards and
    skips the stand-ins. Random access (``take``, ``row``) is the paper's
    O(k) candidate exchange: each process gathers its own rows into a
    zero-filled buffer, the buffers are all-gathered
    (``compat.exchange_host``), and each row is taken from its owner's
    buffer: data movement only, bitwise exact, O(|indices|·d) bytes a
    process and never a shard.

    ``take`` is a collective: every process calls it with the same indices
    (the drivers do: their host state is the same on every process), and a
    call whose indices differ between processes raises on all of them.
    ``materialize`` raises.
    """

    def __init__(self, shards: Sequence):
        super().__init__(shards)
        self._local_ids = tuple(
            i for i, s in enumerate(self.shards)
            if not getattr(s, "is_remote", False))
        if not self._local_ids:
            raise ValueError(
                "ProcessShardedSource needs at least one local shard on "
                "this process")

    @classmethod
    def for_process(cls, local, sizes: Sequence[int],
                    process_id: int) -> "ProcessShardedSource":
        """The layout of ``make_cluster_mesh``: ``sizes`` are the global
        per-shard row counts (one list on every process), and ``local`` is
        this process's source, or a sequence of its sources for
        ``len(local)`` shards a process (process p owns shards
        ``[p·len(local), (p+1)·len(local))``). Every other shard becomes a
        ``RemoteShard`` of its owner."""
        many = isinstance(local, (list, tuple))
        local = [as_source(s) for s in (local if many else [local])]
        sizes = [int(s) for s in sizes]
        per = len(local)
        if per == 0 or len(sizes) % per:
            raise ValueError(
                f"{len(sizes)} shards do not split into {per} shards a "
                "process")
        first = process_id * per
        if not 0 <= first < len(sizes):
            raise ValueError(
                f"process_id {process_id} out of range for "
                f"{len(sizes)} shards")
        for j, s in enumerate(local):
            if s.n != sizes[first + j]:
                raise ValueError(
                    f"local shard has {s.n} rows but sizes[{first + j}] "
                    f"says {sizes[first + j]} — the global partition must "
                    "agree across processes")
        d = local[0].d
        shards = [local[i - first] if first <= i < first + per
                  else RemoteShard(sizes[i], d, process=i // per)
                  for i in range(len(sizes))]
        return cls(shards)

    @property
    def local_shard_ids(self) -> tuple:
        """Indices of the shards whose data lives on this process."""
        return self._local_ids

    def _owner_process(self, shard: np.ndarray) -> np.ndarray:
        me = compat.process_index()
        owners = np.asarray(
            [getattr(s, "process", me) if getattr(s, "is_remote", False)
             else me for s in self.shards], np.int64)
        return owners[shard]

    def take(self, indices) -> np.ndarray:
        idx = _check_take_indices(indices, self.n)
        shard = self._locate(idx)
        vals = np.zeros((idx.size, self.d), np.float32)
        for s in self._local_ids:
            sel = shard == s
            if sel.any():
                vals[sel] = np.asarray(
                    self.shards[s].take(idx[sel] - self._offsets[s]),
                    np.float32)
        if compat.process_count() == 1:
            remote = ~np.isin(shard, np.asarray(self._local_ids))
            if remote.any():
                raise RuntimeError(
                    "take() hit a remote shard but the runtime is "
                    "single-process — nobody can contribute those rows")
            return vals
        compat.same_on_every_process("ProcessShardedSource.take", idx)
        gathered = compat.exchange_host(vals)        # (P, |idx|, d)
        owner = self._owner_process(shard)
        return gathered[owner, np.arange(idx.size)]

    def row(self, idx: int) -> np.ndarray:
        if not 0 <= idx < self.n:
            raise IndexError(f"row {idx} out of range for n={self.n}")
        return self.take(np.asarray([idx]))[0]


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
            return stream_device(self._host_pairs(block_rows), prefetch,
                                 device, paired=True)
        return self._resident_weighted_blocks(block_rows, prefetch, device)

    def _host_pairs(self, block_rows: int):
        off = 0
        for blk in self._parent.host_blocks(block_rows):
            nb = blk.shape[0]
            yield blk, self._w[off:off + nb]
            off += nb

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


def _shard_count(shards, shard_axes=None) -> int:
    """Shard count from an int, a ``Mesh`` (the product of the
    ``shard_axes`` sizes; default: every axis), or anything with
    ``num_shards`` (a ``MeshExecutor``, a ``ShardedSource``)."""
    if isinstance(shards, (int, np.integer)):
        return int(shards)
    if hasattr(shards, "num_shards"):
        return int(shards.num_shards)
    if hasattr(shards, "shape") and hasattr(shards, "axis_names"):   # Mesh
        axes = (tuple(shard_axes) if shard_axes is not None
                else tuple(shards.axis_names))
        count = 1
        for ax in axes:
            count *= int(shards.shape[ax])
        return count
    raise TypeError(
        f"shards must be an int, a Mesh, or expose num_shards; got "
        f"{type(shards).__name__}")


def shard_source(source, shards, *, shard_axes=None) -> ShardedSource:
    """Split ``source`` into a ``ShardedSource`` of contiguous row views.

    ``shards`` is a shard count, a ``Mesh`` (the product of the
    ``shard_axes`` sizes; default: every axis) or a ``MeshExecutor``. The
    split is the paper's: ``per = ceil(n / S)`` rows a machine, machine
    ``i`` holding rows ``[i·per, min((i+1)·per, n))``, which is
    ``SimExecutor``'s blocking, so sharded runs compare bitwise with the
    simulated machines. Each shard is a ``SliceSource``: nothing is copied.
    A ``ShardedSource`` passes through when its shard count matches and
    raises when it does not (a mis-sharded input re-split in silence would
    hide a partitioning fault).

    >>> import numpy as np
    >>> sh = shard_source(HostSource(np.zeros((10, 2), np.float32)), 4)
    >>> [s.n for s in sh.shards], sh.num_shards
    ([3, 3, 3, 1], 4)
    """
    src = as_source(source)
    count = _shard_count(shards, shard_axes)
    if count < 1:
        raise ValueError(f"need at least one shard, got {count}")
    if isinstance(src, ShardedSource):
        if src.num_shards != count:
            raise ValueError(
                f"source is already sharded {src.num_shards} ways, "
                f"expected {count} — re-shard explicitly if intended")
        return src
    per = -(-src.n // count)
    return ShardedSource([
        SliceSource(src, min(i * per, src.n), min((i + 1) * per, src.n))
        for i in range(count)])


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
