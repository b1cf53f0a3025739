"""Streaming k-center: the doubling sketch (port of ``repro.core.streaming``).

For unbounded streams (every training batch produces new embeddings), the
classic doubling algorithm of Charikar, Chekuri, Feder & Motwani (1997): an
8-approximation that sees each point once and keeps only k+1 points.

    state = stream_init(k, d)
    state = stream_update(state, batch)     # any number of times
    centers, radius_lb = stream_result(state)

Invariants:
  * at most k centers are kept, pairwise separation > lower bound ``r``;
  * every streamed point is within 8·OPT of some kept center.

The state lives on the host (numpy), as in the JAX package. Each batch
first drops the points already covered by the current centers: one
nearest-center pass on the device (``ops.assign_nearest``, kernel #2 on the
card) whose per-row distances are read back to the host, because the
sequential insertion tail that follows runs there. The bootstrap's
(k+1, k+1) distance block is ``ops.pairwise_dist2`` (kernel #7 on the
card), read back the same way. ``stream_update.coverage_passes`` counts the
coverage passes and ``stream_update.host_reads`` every read of the device
(the passes and the bootstraps); a run makes no other.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.data.source import is_source
from repro_torch.device import resolve_device, upload
from repro_torch.kernels import ops


class StreamState(NamedTuple):
    centers: np.ndarray    # (k+1, d) — rows beyond `count` are undefined
    count: int             # live centers
    r: float               # current lower-bound radius (doubling)
    k: int


def stream_init(k: int, d: int) -> StreamState:
    return StreamState(np.zeros((k + 1, d), np.float32), 0, 0.0, k)


def _read(t) -> np.ndarray:
    """A device result on the host: the sketch's one kind of device read."""
    stream_update.host_reads += 1
    return t.cpu().numpy()


def _min_d2(x: np.ndarray, centers: np.ndarray, impl: str, dev,
            chunk: int | None = None) -> np.ndarray:
    """The coverage pass: each row's squared distance to its nearest
    center, computed on ``dev`` and read back."""
    _, d2 = ops.assign_nearest(upload(x, dev), upload(centers, dev),
                               impl=impl, chunk=chunk)
    stream_update.coverage_passes += 1
    return _read(d2)


def stream_update(state: StreamState, batch, *, chunk: int | None = None,
                  block_rows: int | None = None,
                  memory_budget: int | None = None, tail: str = "host",
                  impl: str = "auto", device=None) -> StreamState:
    """Fold one batch of points (b, d) into the sketch.

    ``batch`` may also be any point source (host numpy, on-disk shards, or
    a generator program): its host blocks are folded in order, so an entire
    out-of-core dataset can be sketched without being materialized;
    ``block_rows`` / ``memory_budget`` set that blocking (the engine's
    residency model).

    ``tail`` picks the sequential-insertion tail: ``"host"`` (default)
    checks insertion candidates against only the centers added since the
    batch's coverage pass — one device pass per doubling instead of one per
    insertion; ``"device"`` re-runs the pass after every insertion.

    ``impl`` and ``device`` (``None`` means ``"cuda"``) are the distance
    passes', as for every entry point of the port; ``chunk`` (rows) bounds
    the coverage pass's plain-route tiles."""
    if tail not in ("host", "device"):
        raise ValueError(f"tail must be 'host' or 'device', got {tail!r}")
    dev = resolve_device(device)
    if is_source(batch):
        rows = ops.resolve_block_rows(batch.n, batch.d,
                                      block_rows=block_rows,
                                      memory_budget=memory_budget)
        # The sketch's fold runs on the host, so take the source's numpy
        # blocks (a device-resident source's blocks are pulled down).
        for blk in ops.host_blocks_of(batch, rows):
            state = stream_update(state, blk, chunk=chunk, tail=tail,
                                  impl=impl, device=dev)
        return state
    centers, count, r, k = (np.array(state.centers), state.count,
                            state.r, state.k)
    batch = np.asarray(batch, np.float32)

    # bootstrap (only before the first doubling): the first k+1 points
    # define the initial r; afterwards insertion always requires > 4r.
    while r == 0.0 and count <= k and batch.size:
        centers[count] = batch[0]
        batch = batch[1:]
        count += 1
        if count == k + 1:
            # the (k+1, k+1) block of the k+1 first points
            c = upload(centers, dev)
            d2 = _read(ops.pairwise_dist2(c, c, impl=impl))
            np.fill_diagonal(d2, np.inf)
            r = float(np.sqrt(d2.min())) / 2.0
            centers, count = _merge(centers, count, r, k)
    if not batch.size:
        return StreamState(centers, count, r, k)

    while batch.size:
        # vectorized drop of covered points (≤ 4r of a center: the
        # doubling invariant allows absorbing them) — ONE device pass
        d2 = _min_d2(batch, centers[:count], impl, dev, chunk)
        dist = np.sqrt(d2)
        keep = dist > 4.0 * r
        batch, dist = batch[keep], dist[keep]
        if batch.size == 0:
            break
        batch, centers, count, r = _insert_tail(
            batch, dist, centers, count, r, k,
            one_per_pass=(tail == "device"))
    return StreamState(centers, count, r, k)


stream_update.coverage_passes = 0
stream_update.host_reads = 0


def _insert_tail(batch: np.ndarray, dist: np.ndarray, centers: np.ndarray,
                 count: int, r: float, k: int, *, one_per_pass: bool):
    """Sequential-insertion tail of one ``stream_update`` coverage pass.

    A verbatim copy of ``repro.core.streaming._insert_tail`` (numpy only).
    Every row of ``batch`` already failed the ≤4r coverage test against the
    pass-time center set; ``dist`` caches those pass-time min-distances.
    Insertion candidates are re-checked host-side against only the centers
    *added since the pass* — O(b·new) flops, no per-point host↔device
    round-trip. A doubling+merge shrinks the center set to a subset of the
    pass-time centers, so the cached distances survive only as lower
    bounds; the tail hands the unconsumed rows back for a fresh vectorized
    pass instead of consuming stale bounds (that keeps ``_merge``'s
    coverage rebuild on the vectorized device path). A center inserted
    this tail is at true distance > 4r from every live center (cached
    distance ≤ true distance), so the doubling separation invariant holds
    exactly as in the legacy tail.

    ``one_per_pass=True`` reproduces the legacy device tail bit-for-bit:
    return after the first insertion so every candidate is re-screened by
    a fresh ``assign_nearest`` pass.
    """
    added: list = []                    # centers inserted since the pass
    for i in range(batch.shape[0]):
        x = batch[i]
        cd = float(dist[i])
        for c in added:
            diff = x - c
            cd = min(cd, float(np.sqrt(np.dot(diff, diff))))
        if cd <= 4.0 * r:
            continue                    # covered by a center added mid-tail
        if count < k + 1:
            centers[count] = x
            count += 1
            if count == k + 1:
                # classic doubling: never rest with more than k centers
                r *= 2.0
                centers, count = _merge(centers, count, r, k)
                return batch[i + 1:], centers, count, r
            added.append(x.copy())
            if one_per_pass:
                return batch[i + 1:], centers, count, r
        else:
            r *= 2.0
            centers, count = _merge(centers, count, r, k)
            return batch[i:], centers, count, r
    return batch[:0], centers, count, r


def _merge(centers: np.ndarray, count: int, r: float, k: int):
    """Greedy re-cluster of the kept centers at scale 4r: keep a maximal
    subset with pairwise distance > 4r. A verbatim copy of
    ``repro.core.streaming._merge`` (numpy only): one (count, count)
    distance block (count ≤ k+1) plus a masked greedy scan."""
    live = centers[:count]
    diff = live[:, None, :] - live[None, :, :]
    d2 = np.einsum("ijk,ijk->ij", diff, diff)
    thr = (4.0 * r) ** 2
    ok = np.ones(count, bool)
    kept = []
    for i in range(count):
        if ok[i]:
            kept.append(i)
            ok &= d2[i] > thr
    new = np.zeros_like(centers)
    new[: len(kept)] = live[kept]
    return new, len(kept)


def stream_result(state: StreamState):
    """-> (centers (count, d), radius lower bound r)."""
    return state.centers[: state.count], state.r
