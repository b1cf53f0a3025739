"""Online k-center serving: batched nearest-center queries over a live
streamed sketch (port of ``repro.serve.kcenter``).

The service answers ``assign(queries)`` from many client threads while an
ingest thread folds new points into the doubling sketch
(``core/streaming.py``). Three mechanisms, as in the JAX package:

  * **ingest / query separation** — ``submit_points`` enqueues point
    batches (or whole point sources) for an ingest thread that folds them
    in with ``stream_update``; queries wait on ingest only for the snapshot
    lock (a few loads).
  * **an epoch-versioned center cache on the device** — the sketch's live
    centers publish under an epoch that bumps only when the center set
    changes, so covered points (the steady state) invalidate nothing. The
    dispatch thread keeps the centers on the device in a power-of-two
    bucket; a new epoch copies into the same bucket, and only a count past
    a power of two allocates a new one.
  * **micro-batching** — concurrent ``assign`` calls coalesce into one
    dispatch (what piled up while the previous one ran), padded to a
    power-of-two row bucket, so every dispatch has one of O(log max_batch)
    query shapes, each with its buffers made once.

The query op is ``ops.assign_bucketed``: kernel #2 on the card, so a served
answer is bitwise the offline ``ops.assign_nearest`` on the centers of its
epoch (the plain version on the CPU holds the same property).

On the card each of the two threads runs on a side stream of its own, set
when the thread starts, so a query never queues behind an ingested block's
coverage pass. The snapshot crosses threads as host numpy, and the center
cache is written and read on the dispatch stream only. A dispatch slice
copies its padded queries up from pinned memory, launches once and copies
``idx`` and ``d2`` back into pinned memory without blocking, then waits on
its own stream: one synchronising call a slice, and none of them
device-wide.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.streaming import stream_init, stream_update
from repro_torch.data.source import is_source
from repro_torch.device import resolve_device
from repro_torch.kernels import engine, ops

_SHUTDOWN = object()


def _pow2_at_least(n: int, floor: int) -> int:
    """Smallest power of two >= max(n, floor)."""
    b = max(int(floor), 1)
    while b < n:
        b *= 2
    return b


class AssignResult(NamedTuple):
    """One served assignment: nearest-center index + squared distance per
    query row, tagged with the center-set epoch that answered it."""
    idx: np.ndarray     # (b,) int32
    d2: np.ndarray      # (b,) float32
    epoch: int


class AssignTicket:
    """Handle for an in-flight ``assign_async`` request; ``result()``
    blocks until the dispatch thread answers (or raises its error).
    ``t_submit``/``t_done`` are ``time.monotonic`` stamps for load-gen
    latency accounting."""

    __slots__ = ("q", "t_submit", "t_done", "_event", "_idx", "_d2",
                 "_epoch", "_err")

    def __init__(self, q: np.ndarray):
        self.q = q
        self.t_submit = time.monotonic()
        self.t_done = 0.0
        self._event = threading.Event()
        self._err: Optional[BaseException] = None

    def _resolve(self, idx, d2, epoch) -> None:
        self._idx, self._d2, self._epoch = idx, d2, epoch
        self.t_done = time.monotonic()
        self._event.set()

    def _fail(self, err: BaseException) -> None:
        self._err = err
        self.t_done = time.monotonic()
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> AssignResult:
        if not self._event.wait(timeout):
            raise TimeoutError("assign timed out")
        if self._err is not None:
            raise self._err
        return AssignResult(self._idx, self._d2, self._epoch)


class _Slot(NamedTuple):
    """The buffers of one query row bucket: the padded queries on the host
    and on the device, and the results on the host (pinned on the card)."""
    q_host: torch.Tensor
    q_dev: torch.Tensor
    idx_host: torch.Tensor
    d2_host: torch.Tensor


class KCenterService:
    """Online k-center service: live ingest + batched assignment queries.

    ::

        svc = KCenterService(k=16, d=8)    # device=None: the card
        svc.submit_points(points)          # async: any (b, d) array or
        svc.drain()                        #        any point source
        res = svc.assign(queries)          # (idx, d2, epoch) — blocking
        epoch, centers, r = svc.snapshot() # the live sketch at `epoch`
        svc.close()

    ``assign`` is thread-safe and meant to be called from many client
    threads at once — concurrent calls coalesce into micro-batches.
    Contracts (tests/test_torch_serve.py):

      * every result is bitwise ``ops.assign_nearest(queries, centers)``
        for the snapshot centers of ``result.epoch``;
      * the operand shapes of a dispatch are a function of the (query
        bucket, center bucket) pair only;
      * ingest that leaves the center set unchanged (covered points — the
        steady state) bumps no epoch and refreshes no cache.

    Knobs: ``batching=False`` dispatches every request alone;
    ``max_batch`` caps coalesced rows per dispatch; ``batch_wait_s``
    optionally lingers for stragglers (default 0 — purely opportunistic
    coalescing); ``impl``/``chunk`` thread through to the query op;
    ``snapshot_history=True`` retains every epoch's centers (tests;
    O(epochs · k · d) host bytes); ``device`` (``None`` means ``"cuda"``,
    which raises without a GPU) is where the sketch's passes and the
    queries run.
    """

    def __init__(self, k: int, d: int, *, impl: str = "auto",
                 chunk: Optional[int] = None, max_batch: int = 256,
                 min_bucket: int = 8, center_bucket_min: int = 8,
                 batching: bool = True, batch_wait_s: float = 0.0,
                 ingest_tail: str = "host",
                 ingest_block_rows: Optional[int] = None,
                 ingest_memory_budget: Optional[int] = None,
                 snapshot_history: bool = False, device=None):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._dev = resolve_device(device)
        self._k, self._d = int(k), int(d)
        self._impl, self._chunk = impl, chunk
        self._max_batch = int(max_batch)
        self._min_bucket = _pow2_at_least(min_bucket, 1)
        self._center_bucket_min = _pow2_at_least(center_bucket_min, 1)
        self._batching = bool(batching)
        self._batch_wait_s = float(batch_wait_s)
        self._ingest_tail = ingest_tail
        self._ingest_block_rows = ingest_block_rows
        self._ingest_memory_budget = ingest_memory_budget

        # -- sketch + published snapshot (epoch-versioned) ---------------
        self._state = stream_init(k, d)         # ingest-thread private
        self._mu = threading.Lock()
        self._epoch = 0                         # 0 = empty center set
        self._centers = np.zeros((0, d), np.float32)
        self._r = 0.0
        self._history: Optional[Dict[int, np.ndarray]] = (
            {} if snapshot_history else None)
        self._stats = {"queries": 0, "batches": 0, "batched_rows": 0,
                       "epochs": 0, "cache_refreshes": 0,
                       "bucket_growths": 0}

        # -- center cache and query buffers (dispatch-thread private) ----
        self._cache_epoch = -1
        self._cache_host = None      # (m_cap, d) staging, pinned on the card
        self._cache_buf = None       # (m_cap, d) on the device
        self._cache_live = None      # (m_cap,) host bool: the live rows
        self._slots: Dict[int, _Slot] = {}      # query row bucket -> buffers

        # -- ingest queue + admission queue ------------------------------
        self._ingest_q: queue.Queue = queue.Queue()
        self._req_q: queue.Queue = queue.Queue()
        self._ingest_cv = threading.Condition()
        self._ingest_pending = 0
        self._ingest_err: Optional[BaseException] = None
        self._closed = False

        self._ingest_thread = threading.Thread(
            target=self._ingest_loop, name="kcenter-ingest", daemon=True)
        self._dispatch_thread = threading.Thread(
            target=self._dispatch_loop, name="kcenter-dispatch", daemon=True)
        self._ingest_thread.start()
        self._dispatch_thread.start()

    # -- lifecycle --------------------------------------------------------
    def __enter__(self) -> "KCenterService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Stop both threads; outstanding requests fail with RuntimeError."""
        if self._closed:
            return
        self._closed = True
        self._ingest_q.put(_SHUTDOWN)
        self._req_q.put(_SHUTDOWN)
        self._ingest_thread.join()
        self._dispatch_thread.join()
        while True:                 # fail anything admitted after shutdown
            try:
                item = self._req_q.get_nowait()
            except queue.Empty:
                break
            if item is not _SHUTDOWN:
                item._fail(RuntimeError("KCenterService closed"))

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("KCenterService is closed")

    def _own_stream(self):
        """For a thread's loop: a side stream of its own as the thread's
        current stream on the card (every wrapper launches on the current
        stream); nothing on the CPU."""
        if self._dev.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.stream(torch.cuda.Stream(self._dev))

    # -- ingest side ------------------------------------------------------
    def submit_points(self, points) -> None:
        """Asynchronously fold ``points`` — a (b, d) array or any point
        source — into the sketch. Returns immediately; ``drain`` waits for
        completion (and surfaces ingest errors)."""
        self._check_open()
        self._raise_ingest_err()
        if not is_source(points):
            points = np.asarray(points, np.float32)
            if points.ndim != 2 or points.shape[1] != self._d:
                raise ValueError(
                    f"expected (b, {self._d}) points, got {points.shape}")
        with self._ingest_cv:
            self._ingest_pending += 1
        self._ingest_q.put(points)

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted batch has been folded in."""
        with self._ingest_cv:
            if not self._ingest_cv.wait_for(
                    lambda: self._ingest_pending == 0, timeout):
                raise TimeoutError("ingest queue did not drain")
        self._raise_ingest_err()

    def _raise_ingest_err(self) -> None:
        with self._mu:
            err = self._ingest_err
        if err is not None:
            raise RuntimeError("ingest thread failed") from err

    def _ingest_loop(self) -> None:
        with self._own_stream():
            while True:
                item = self._ingest_q.get()
                if item is _SHUTDOWN:
                    return
                try:
                    self._ingest(item)
                except BaseException as e:  # noqa: BLE001 — surfaced via drain
                    with self._mu:
                        self._ingest_err = e
                finally:
                    with self._ingest_cv:
                        self._ingest_pending -= 1
                        self._ingest_cv.notify_all()

    def _ingest(self, item) -> None:
        old = self._state
        new = stream_update(
            old, item, chunk=self._chunk, block_rows=self._ingest_block_rows,
            memory_budget=self._ingest_memory_budget, tail=self._ingest_tail,
            device=self._dev)
        self._state = new
        # Epoch bumps ONLY on a real center-set change — covered points
        # (the steady state) publish nothing.
        changed = (new.count != old.count or new.r != old.r
                   or not np.array_equal(new.centers[:new.count],
                                         old.centers[:old.count]))
        if changed:
            snap = np.array(new.centers[:new.count], np.float32)
            with self._mu:
                self._epoch += 1
                self._centers = snap
                self._r = new.r
                self._stats["epochs"] += 1
                if self._history is not None:
                    self._history[self._epoch] = snap

    # -- snapshots --------------------------------------------------------
    def snapshot(self) -> Tuple[int, np.ndarray, float]:
        """-> (epoch, centers (count, d), radius lower bound r). The
        centers array is the published copy — treat it as read-only."""
        with self._mu:
            return self._epoch, self._centers, self._r

    def snapshot_at(self, epoch: int) -> np.ndarray:
        """Centers of a historical epoch (requires snapshot_history)."""
        if self._history is None:
            raise RuntimeError(
                "snapshot_at needs KCenterService(snapshot_history=True)")
        with self._mu:
            return self._history[epoch]

    @property
    def stats(self) -> Dict[str, int]:
        with self._mu:
            return dict(self._stats)

    # -- query side -------------------------------------------------------
    def assign_async(self, queries) -> AssignTicket:
        """Submit a query batch (b, d); returns an ``AssignTicket`` whose
        ``result()`` blocks until the answer is dispatched."""
        self._check_open()
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.ndim != 2 or q.shape[1] != self._d:
            raise ValueError(
                f"expected (b, {self._d}) queries, got {np.shape(queries)}")
        if q.shape[0] == 0:
            raise ValueError("empty query batch")
        ticket = AssignTicket(q)
        self._req_q.put(ticket)
        return ticket

    def assign(self, queries, timeout: Optional[float] = None) -> AssignResult:
        """Blocking ``assign_async(...).result()`` — the client call."""
        return self.assign_async(queries).result(timeout)

    # -- dispatch thread --------------------------------------------------
    def _dispatch_loop(self) -> None:
        with self._own_stream():
            while True:
                first = self._req_q.get()
                if first is _SHUTDOWN:
                    return
                batch: List[AssignTicket] = [first]
                rows = first.q.shape[0]
                stop = False
                if self._batching:
                    # Opportunistic coalescing: drain whatever piled up
                    # while the previous dispatch was in flight; optionally
                    # linger batch_wait_s for more.
                    deadline = None
                    if self._batch_wait_s > 0:
                        deadline = time.monotonic() + self._batch_wait_s
                    while rows < self._max_batch:
                        try:
                            if deadline is None:
                                nxt = self._req_q.get_nowait()
                            else:
                                left = deadline - time.monotonic()
                                if left <= 0:
                                    break
                                nxt = self._req_q.get(timeout=left)
                        except queue.Empty:
                            break
                        if nxt is _SHUTDOWN:
                            stop = True
                            break
                        batch.append(nxt)
                        rows += nxt.q.shape[0]
                self._run_batch(batch)
                if stop:
                    return

    def _run_batch(self, batch: List[AssignTicket]) -> None:
        try:
            if len(batch) == 1:
                qcat = batch[0].q
            else:
                qcat = np.concatenate([t.q for t in batch], axis=0)
            idx, d2, epoch = self._dispatch(qcat)
            off = 0
            for t in batch:
                b = t.q.shape[0]
                t._resolve(idx[off:off + b], d2[off:off + b], epoch)
                off += b
            with self._mu:
                self._stats["queries"] += len(batch)
                self._stats["batches"] += 1
                self._stats["batched_rows"] += qcat.shape[0]
        except BaseException as e:  # noqa: BLE001 — propagate per ticket
            for t in batch:
                t._fail(e)

    def _host_buffer(self, shape, dtype) -> torch.Tensor:
        """A host tensor, pinned where the device is the card (so copies to
        and from it need not block)."""
        return torch.empty(shape, dtype=dtype,
                           pin_memory=self._dev.type == "cuda")

    def _refresh_cache(self):
        """The epoch-versioned center cache (dispatch-thread private). A
        new epoch is copied into the same bucket, the rows past the live
        count at ``engine._FAR_CENTER``; only a count past the bucket's
        power of two allocates a new one. The staging buffer is rewritten
        only after the previous dispatch's stream sync, so its copy is
        done."""
        with self._mu:
            epoch, centers = self._epoch, self._centers
        if epoch != self._cache_epoch:
            count = centers.shape[0]
            if count == 0:
                raise RuntimeError(
                    "no centers yet — submit_points + drain before assign")
            mcap = _pow2_at_least(count, self._center_bucket_min)
            grew = self._cache_buf is None or self._cache_buf.shape[0] != mcap
            if grew:
                self._cache_host = self._host_buffer((mcap, self._d),
                                                     torch.float32)
                self._cache_buf = torch.empty((mcap, self._d),
                                              dtype=torch.float32,
                                              device=self._dev)
            host = self._cache_host.numpy()
            host[:count] = centers
            host[count:] = engine._FAR_CENTER
            live = np.zeros((mcap,), bool)
            live[:count] = True
            self._cache_buf.copy_(self._cache_host, non_blocking=True)
            self._cache_live, self._cache_epoch = live, epoch
            with self._mu:
                self._stats["cache_refreshes"] += 1
                if grew:
                    self._stats["bucket_growths"] += 1
        return self._cache_buf, self._cache_live, self._cache_epoch

    def _dispatch(self, q: np.ndarray):
        """Run one coalesced micro-batch through the bucketed query op: pad
        to the power-of-two row bucket (max_batch-sized slices for
        oversized requests), one upload, one ``ops.assign_bucketed`` call
        and one read a slice, results sliced back to the real rows."""
        buf, live, epoch = self._refresh_cache()
        b = q.shape[0]
        out_i = np.empty((b,), np.int32)
        out_d = np.empty((b,), np.float32)
        for start in range(0, b, self._max_batch):
            blk = q[start:start + self._max_batch]
            nb = blk.shape[0]
            # pow2 bucket, capped at max_batch (itself a fixed shape even
            # when not a power of two) — O(log max_batch) shapes in all
            bq = min(_pow2_at_least(nb, self._min_bucket), self._max_batch)
            slot = self._upload(blk, bq)
            idx, d2 = self._launch(slot, buf, live)
            out_i[start:start + nb], out_d[start:start + nb] = self._read(
                slot, idx, d2, nb)
        return out_i, out_d, epoch

    def _upload(self, blk: np.ndarray, bq: int) -> _Slot:
        """Pad ``blk`` into the ``bq``-row bucket's host buffer (zeros past
        it) and copy it to the device without blocking."""
        slot = self._slots.get(bq)
        if slot is None:
            slot = _Slot(self._host_buffer((bq, self._d), torch.float32),
                         torch.empty((bq, self._d), dtype=torch.float32,
                                     device=self._dev),
                         self._host_buffer((bq,), torch.int32),
                         self._host_buffer((bq,), torch.float32))
            self._slots[bq] = slot
        host = slot.q_host.numpy()
        nb = blk.shape[0]
        host[:nb] = blk
        host[nb:] = 0.0
        slot.q_dev.copy_(slot.q_host, non_blocking=True)
        return slot

    def _launch(self, slot: _Slot, buf: torch.Tensor, live: np.ndarray):
        return ops.assign_bucketed(slot.q_dev, buf, live, impl=self._impl,
                                   chunk=self._chunk)

    def _read(self, slot: _Slot, idx: torch.Tensor, d2: torch.Tensor,
              nb: int):
        """Copy the slice's results into the host buffers without blocking,
        then wait on this thread's stream: the slice's one synchronising
        call. Returns copies of the first ``nb`` rows."""
        slot.idx_host.copy_(idx, non_blocking=True)
        slot.d2_host.copy_(d2, non_blocking=True)
        if self._dev.type == "cuda":
            torch.cuda.current_stream(self._dev).synchronize()
        return slot.idx_host.numpy()[:nb].copy(), slot.d2_host.numpy()[:nb].copy()
