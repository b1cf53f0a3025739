"""Executors — the paper's "machines" (port of ``repro.core.executor``).

  * ``SimExecutor`` — the paper's experiments: m simulated machines on one
    device; a point source is materialized and blocked into m shards.
  * ``HostStreamExecutor`` — out of core: sequential super-shards streamed
    from a point source through its pinned upload ring, under
    ``memory_budget`` (the paper's machine capacity c, in bytes), so n is
    bounded by host RAM or disk and not by device memory.
  * ``MeshExecutor`` — the machines are the shards of a named mesh
    (``repro_torch.launch.mesh``). An in-memory input runs the fused path:
    GON on every shard, the center sets gathered along the shard axes (one
    axis at a time with a GON a level when ``hierarchical``), the final
    GON and the radius. A point source is split into the paper's
    contiguous machine ranges (``ShardedSource``) and streamed shard by
    shard in lockstep, under a per-shard ``memory_budget``. Under several
    processes (``repro_torch.launch.cluster``) each process streams its own
    shards, and the processes exchange host values
    (``repro_torch.compat``).

Their interface is the JAX package's:

  * ``run_blocks(fn, source)`` — round 1 [map]: the per-machine reducer
    ``fn(points (m, per, d), mask (m, per) or None) -> (m, k, d)`` over
    the machine blocks (the JAX package vmaps a per-block ``fn``; here the
    machine axis is a leading batch axis of the kernels);
  * ``combine(centers, valid, k, capacity)`` — rounds 2+ [reduce]: while
    the union exceeds ``capacity``, re-block and reduce again (Lemma 3),
    then the final single-machine GON;
  * ``combine_weighted(centers, valid, weights, k, capacity)`` — the same
    reduction carrying per-cluster weights;
  * ``radius2(source, centers)`` — the squared covering radius over all
    points, a streamed fold (``SimExecutor``: one in-memory pass);
  * ``mrg(source, k)`` — the three in order;
  * ``run_filter_round(source, s_new, d_s, h_mask, rank)`` — one iteration
    of EIM's Rounds 2-3 (paper §4, Algorithm 2): update the host-resident
    ``d(x, S)`` against the newly sampled centers and reduce Select's
    pivot (the ``rank``-th largest ``d(x, S)`` over H, Algorithm 3) in the
    same pass. ``HostStreamExecutor`` folds it over super-shards,
    ``SimExecutor`` over its machine blocks (one launch of the filter for
    all machines on the card); both give bitwise the same ``d_s`` and
    pivot, as top-k values do not depend on the blocking.

An ``Objective`` generalises the rounds: ``weighted`` runs the weighted
reducer (``weighted_gon_block_fn``: GON, then each row's weight summed onto
its nearest center) and the weighted combine, so the k centers arrive with
their cluster weights; ``outliers=z`` scores ``radius2`` as the top-(z+1)
fold. ``chunk`` bounds every distance pass's plain-route tiles
(``engine.resolve_chunk``). Outside the filter rounds nothing here reads a
tensor back to the host: the ``combine`` loops read only shapes; a filter
round reads its pivot, once.
"""
from __future__ import annotations

import functools
import warnings
import weakref
from collections import deque
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch import compat
from repro_torch.data.source import (ArraySource, ShardedSource, as_source,
                                     has_weights, shard_source, stream_device,
                                     weights_of)
from repro_torch.device import as_points, resolve_device, upload
from repro_torch.kernels import engine, ops, ref
from repro_torch.launch.mesh import all_gather, all_max

from .gonzalez import _gonzalez_device

BlockFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# Weighted round-1 reducer: (points (m, per, d), mask (m, per) or None,
# w (m, per)) -> (centers (m, k, d), cluster weights (m, k)).
WeightedBlockFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                           tuple[torch.Tensor, torch.Tensor]]


@dataclass(frozen=True)
class Objective:
    """The fold objective over the source × executor substrate.

    * ``weighted`` — round 1 reduces weighted instances: the per-machine
      reducer also emits per-cluster weight sums (the coreset outputs of
      Ceccarello et al., arXiv 1802.09205), carried through the Lemma-3
      combine so the final k centers arrive with their cluster weights.
    * ``outliers`` — z: ``radius2`` becomes the top-(z+1) fold, the squared
      covering radius after excluding the z farthest points.

    ``Objective()`` (or ``objective=None``) is plain k-center and takes the
    plain code paths. Center selection never looks at the weights, so
    unit-weight weighted runs are bitwise the plain runs.
    """

    name: str = "kcenter"
    weighted: bool = False
    outliers: int = 0

    def __post_init__(self):
        if self.outliers < 0:
            raise ValueError(f"outliers must be >= 0, got {self.outliers}")


def _is_plain(objective) -> bool:
    """True for the plain objective; raises for anything that is neither
    ``None`` nor an ``Objective`` (no other objective kind exists)."""
    if objective is None:
        return True
    if not isinstance(objective, Objective):
        raise NotImplementedError(
            f"objective must be None or an Objective, got "
            f"{type(objective).__name__}: no other objective kind is "
            "implemented")
    return not objective.weighted and objective.outliers == 0


_NEG = np.float32(ref.NEG)   # Select's empty-slot sentinel
_BIG = np.float32(ref.BIG)   # d(x, S) of a row no center has reached


def _eim_pivot_block(d_blk, h_blk, top, *, rank: int):
    """Pivot-only block step of a zero-sample iteration: the distance state
    stays untouched (the device path's ``any(s_valid)`` gate)."""
    return engine.merge_top_k(top, torch.where(h_blk, d_blk, ref.NEG), rank)


def _pivot_from_top(top: torch.Tensor, rank: int) -> np.float32:
    """Algorithm 3's pivot from a merged descending top-``rank``: the
    rank-th largest d(·, S)^2, or -1.0 where H held fewer than ``rank``
    points (an empty slot survived the merge), so that no row is removed
    by distance: the device path's ``where(pivot <= _NEG / 2, -1, pivot)``.
    The read of the round: it also orders the copies queued before it."""
    pivot = np.float32(top[rank - 1].item())
    if pivot <= _NEG / np.float32(2):
        return np.float32(-1.0)
    return pivot


class _HostCopy:
    """Per-row f32 results on their way back to the host: each block's
    rows copied into one buffer (pinned, by non-blocking copies, on a CUDA
    device), read after the round's synchronising pivot read."""

    def __init__(self, n: int, dev: torch.device):
        self.buf = torch.empty((n,), dtype=torch.float32,
                               pin_memory=dev.type == "cuda")

    def put(self, off: int, t: torch.Tensor) -> None:
        self.buf[off:off + t.shape[0]].copy_(t, non_blocking=True)

    def into(self, out: np.ndarray) -> np.ndarray:
        out[:] = self.buf.numpy()
        return out


@functools.lru_cache(maxsize=None)
def gon_block_fn(k: int, impl: str = "auto",
                 chunk: int | None = None) -> BlockFn:
    """The per-machine reducer: GON restricted to each (masked) block,
    batched over the leading machine axis (``mask=None``: every row)."""
    def fn(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return _gonzalez_device(points, k, mask=mask, impl=impl,
                                chunk=chunk).centers
    return fn


@functools.lru_cache(maxsize=None)
def weighted_gon_block_fn(k: int, impl: str = "auto",
                          chunk: int | None = None, *,
                          mask_zero: bool = True) -> WeightedBlockFn:
    """The weighted per-machine reducer, batched over the machine axis:
    masked GON, then each selected row's weight summed onto its nearest
    center (one machine's share of a weighted coreset, Ceccarello et al.).

    Selection is ``gon_block_fn``'s GON (k-center's objective does not
    depend on the weights); the assign and the sums are one launch for all
    machines (``ops.assign_sums``). ``mask_zero``
    also drops ``w <= 0`` rows from selection (they are absent from the
    instance): round 1 wants that; the combine levels pass
    ``mask_zero=False`` so that their selection mask is exactly the plain
    ``combine``'s. On the card the sums' atomics add in no fixed order, so
    a sum is bitwise only where every partial sum is exact — integer
    weights with sums below 2^24, as cluster counts are; float weights
    agree to f32 rounding of the sum."""
    def fn(points: torch.Tensor, mask, w: torch.Tensor):
        if mask_zero:
            sel = w > 0 if mask is None else mask & (w > 0)
        else:
            sel = mask
        centers = _gonzalez_device(points, k, mask=sel, impl=impl,
                                   chunk=chunk).centers
        wsel = w if sel is None else torch.where(sel, w, 0.0)
        cw = torch.zeros((points.shape[0], k), dtype=torch.float32,
                         device=points.device)
        return centers, ops.assign_sums(points, centers, cw, wsel, impl=impl,
                                        chunk=chunk)
    return fn


def _block(points: torch.Tensor, m: int):
    """Pad & reshape (n,d) -> (m, ceil(n/m), d) plus validity mask."""
    n, d = points.shape
    per = -(-n // m)
    pts, _ = engine._pad_rows(points, per * m, 0.0)
    mask = torch.arange(per * m, device=points.device) < n
    return pts.reshape(m, per, d), mask.reshape(m, per)


def _run_round(points_blocked: torch.Tensor, mask_blocked: torch.Tensor,
               fn: BlockFn):
    """``fn`` over m blocks -> (m*k, d) center union + validity."""
    centers = fn(points_blocked, mask_blocked)             # (m, k, d)
    m, k = centers.shape[0], centers.shape[1]
    centers = centers.reshape(m * k, -1)
    # a block with zero valid points still emits k (zero) rows; mark validity
    any_valid = mask_blocked.any(dim=1)                    # (m,)
    valid = any_valid[:, None].expand(m, k).reshape(m * k)
    return centers, valid


def _run_round_w(points_blocked: torch.Tensor, mask_blocked: torch.Tensor,
                 w_blocked: torch.Tensor, fn: WeightedBlockFn):
    """Weighted ``_run_round``: also flattens the per-block cluster-weight
    sums -> ``(centers (m*k, d), valid (m*k,), weights (m*k,))``."""
    centers, cw = fn(points_blocked, mask_blocked, w_blocked)
    m, k = centers.shape[0], centers.shape[1]
    valid = mask_blocked.any(dim=1)[:, None].expand(m, k).reshape(m * k)
    return centers.reshape(m * k, -1), valid, cw.reshape(-1)


def _mrg_round(points_blocked: torch.Tensor, mask_blocked: torch.Tensor,
               k: int, m: int, impl: str, chunk: int | None = None):
    """One round of per-machine GON (the JAX package's round entry)."""
    del m  # implied by the blocking
    return _run_round(points_blocked, mask_blocked,
                      gon_block_fn(k, impl, chunk))


_DIVERGED_MSG = ("combine diverged (k too close to capacity; "
                 "paper §3.3 requires 2k < c)")


def check_combine_capacity(k: int, capacity: int, *,
                           warn: bool = True) -> None:
    """Feasibility of the Lemma-3 reduction under machine capacity ``c``:
    ``capacity <= k`` never shrinks the union and raises; ``k < capacity <
    2k`` may stall on the ceil (§3.3 requires 2k < c) and warns."""
    if capacity <= k:
        raise ValueError(
            f"infeasible: k={k} needs single-machine capacity > k, got "
            f"{capacity} — every combine level re-blocks M rows into "
            "ceil(M/capacity) machines of k centers each, so the center "
            "union never shrinks")
    if warn and capacity < 2 * k:
        warnings.warn(
            f"capacity={capacity} < 2k={2 * k}: paper §3.3 requires "
            "2k < c for the round recurrence to converge; combine may "
            "stall and raise", RuntimeWarning, stacklevel=3)


def _resident_radius2(x: torch.Tensor, centers: torch.Tensor, weights, *,
                      impl: str, chunk: int | None, objective):
    """The squared covering radius over device-resident points ``x``: one
    pass of the nearest-center kernel (#2) over all rows, then the max
    itself (a sqrt -> square round trip is lossy). A non-plain objective
    changes only the reduction (the top-(z+1), over the rows whose
    ``weights()`` are positive when weighted): the top-1 of a multiset is
    its max, so unit-weight runs keep the bits."""
    _, d2 = ops.assign_nearest(x, centers, impl=impl, chunk=chunk)
    if _is_plain(objective):
        return d2.max()
    if objective.weighted:
        d2 = torch.where(weights() > 0, d2, ref.NEG)
    r = objective.outliers + 1
    top = engine.merge_top_k(engine.top_k_init(r, x.device), d2, r)
    return torch.clamp_min(top[r - 1], 0.0)


class Executor:
    """Base: block-mapped round 1 + shared Lemma-3 reduction."""

    device: torch.device

    def run_blocks(self, fn, source, *, objective=None):
        """Round 1: map ``fn`` over the machine blocks of ``source``.
        Returns ``(centers (M·k, d), valid (M·k,) bool)``; with a weighted
        ``objective``, ``fn`` is a ``WeightedBlockFn`` and the return gains
        the per-cluster weight sums ``weights (M·k,) f32``."""
        raise NotImplementedError

    def default_capacity(self, source, k: int) -> int:
        """The paper's machine capacity ``c`` implied by this executor's
        blocking (rows per machine, floored at 2k)."""
        return 2 * k

    def combine(self, centers: torch.Tensor, valid: torch.Tensor, k: int,
                capacity: int, *, impl: str = "auto",
                chunk: int | None = None):
        """Rounds 2+: reduce the center union to k centers.

        While the union exceeds ``capacity``, re-block and run another GON
        level (paper §3.3 — each extra level adds +2 to the approximation
        factor), then the final single-machine GON. Returns
        ``(centers (k, d), extra_rounds)``. Raises if a level fails to
        shrink the union or more than 64 levels accumulate.
        """
        check_combine_capacity(k, capacity)
        extra = 0
        while centers.shape[0] > capacity and centers.shape[0] > k:
            m2 = -(-centers.shape[0] // capacity)  # >= 2 since rows > capacity
            if m2 * k >= centers.shape[0] or extra >= 64:
                raise ValueError(_DIVERGED_MSG)
            blocked, bmask = _block(centers, m2)
            vpad, _ = engine._pad_rows(valid, bmask.numel(), False)
            bmask = bmask & vpad.reshape(bmask.shape)
            centers, valid = _mrg_round(blocked, bmask, k, m2, impl, chunk)
            extra += 1
        final = _gonzalez_device(centers[None], k, mask=valid[None], impl=impl,
                                 chunk=chunk)
        return final.centers[0], extra

    def combine_weighted(self, centers: torch.Tensor, valid: torch.Tensor,
                         weights: torch.Tensor, k: int, capacity: int, *,
                         impl: str = "auto", chunk: int | None = None,
                         final_gon: bool = True):
        """Lemma-3 reduction carrying cluster weights: every level's output
        stays a weighted instance.

        Each level re-blocks the weighted union, picks per-block GON
        centers with exactly ``combine``'s selection mask (validity only,
        so on unit weights the unions are bitwise the plain ``combine``'s)
        and re-aggregates every row's weight onto its nearest new center.
        With ``final_gon=False`` the reduction stops as soon as the union
        fits ``capacity`` (the weighted coreset ``core.outliers.kz_center``
        solves on the host); otherwise the final single-machine GON runs
        and the weights are re-aggregated onto the k winners.

        Returns ``(centers, weights, valid, extra_rounds)``; after a final
        GON, ``centers`` is (k, d) and ``valid`` all True."""
        check_combine_capacity(k, capacity)
        w = weights.to(torch.float32)
        fn = weighted_gon_block_fn(k, impl, chunk, mask_zero=False)
        extra = 0
        while centers.shape[0] > capacity and centers.shape[0] > k:
            m2 = -(-centers.shape[0] // capacity)
            if m2 * k >= centers.shape[0] or extra >= 64:
                raise ValueError(_DIVERGED_MSG)
            blocked, bmask = _block(centers, m2)
            vpad, _ = engine._pad_rows(valid, bmask.numel(), False)
            bmask = bmask & vpad.reshape(bmask.shape)
            wpad, _ = engine._pad_rows(w, bmask.numel(), 0.0)
            centers, valid, w = _run_round_w(blocked, bmask,
                                             wpad.reshape(bmask.shape), fn)
            extra += 1
        if not final_gon:
            return centers, w, valid, extra
        final = _gonzalez_device(centers[None], k, mask=valid[None],
                                 impl=impl, chunk=chunk).centers[0]
        w_out = torch.zeros((k,), dtype=torch.float32, device=w.device)
        ops.assign_sums(centers, final, w_out, torch.where(valid, w, 0.0),
                        impl=impl, chunk=chunk)
        return (final, w_out,
                torch.ones((k,), dtype=torch.bool, device=w.device), extra)

    def radius2(self, source, centers: torch.Tensor, *, impl: str = "auto",
                chunk: int | None = None, objective=None) -> torch.Tensor:
        """Squared covering radius over ALL source points, streamed
        (``engine.fold_min_d2``). Returns ``max(min_d2)`` itself: a
        ``sqrt`` → square round trip is lossy in f32, and every executor
        returns the same exact value. A non-plain ``objective`` takes the
        top-(z+1) fold (``outliers=z``: the radius after excluding the z
        farthest points), over the positive-weight rows when weighted."""
        if not _is_plain(objective):
            top = engine.fold_top_k_min_d2(
                source, centers, objective.outliers + 1, impl=impl,
                chunk=chunk, weighted=objective.weighted, device=self.device)
            return torch.clamp_min(top[objective.outliers], 0.0)
        return engine.fold_min_d2(source, centers, impl=impl, chunk=chunk,
                                  device=self.device)

    def run_filter_round(self, source, s_new, d_s: np.ndarray,
                         h_mask: np.ndarray, rank: int, *,
                         impl: str = "auto", chunk: int | None = None):
        """One EIM iteration's Rounds 2-3 over this executor's machines.

        ``s_new`` is the iteration's newly sampled centers ``(m_new, d)``
        (host numpy, padded to a fixed capacity with ``1e18`` rows, which
        never win the distance min), or ``None``/empty for an iteration
        that sampled nothing: the distances then stay untouched, like the
        device path's ``any(s_valid)`` gate. ``d_s (n,) f32`` and ``h_mask
        (n,) bool`` are the host-resident per-row state of ``source`` (a
        compacted view's slices). Updates ``d_s`` in place to ``min(d_s,
        d(x, S_new)^2)`` and reduces Select's pivot, the ``rank``-th
        largest updated ``d_s`` over H, in the same pass.

        Returns ``(d_s, pivot)``, ``pivot`` an ``np.float32`` (-1.0 where
        H held fewer than ``rank`` rows)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement EIM's "
            "run_filter_round; use HostStreamExecutor (streamed), "
            "SimExecutor (simulated machines) or MeshExecutor (sharded)")

    def end_filter_rounds(self, source) -> None:
        """Called when an EIM run's loop is done with ``source``: the hook
        to release per-source state kept across ``run_filter_round``
        calls. Nothing to release by default."""

    def mrg(self, source, k: int, *, capacity: int | None = None,
            impl: str = "auto", chunk: int | None = None, objective=None):
        """Full MRG on this executor over ``source`` (anything
        ``as_source`` takes). Returns ``(centers (k, d), radius2 (),
        rounds)``; with a weighted ``objective``, ``(centers, radius2,
        rounds, weights (k,))``: the same rounds run weighted, so the k
        centers arrive with their cluster weights. An ``outliers=z``
        objective scores ``radius2`` with the top-(z+1) fold."""
        plain = _is_plain(objective)
        source = as_source(source)
        if capacity is None:
            capacity = self.default_capacity(source, k)
        # Fail on an infeasible capacity *before* the round-1 pass over all
        # of n (warn=False: combine's own check owns the §3.3 warning).
        check_combine_capacity(k, capacity, warn=False)
        if not plain and objective.weighted:
            centers, valid, cw = self.run_blocks(
                weighted_gon_block_fn(k, impl, chunk), source,
                objective=objective)
            centers, w, _, extra = self.combine_weighted(
                centers, valid, cw, k, capacity, impl=impl, chunk=chunk)
            r2 = self.radius2(source, centers, impl=impl, chunk=chunk,
                              objective=objective)
            return centers, r2, 2 + extra, w
        centers, valid = self.run_blocks(gon_block_fn(k, impl, chunk), source)
        centers, extra = self.combine(centers, valid, k, capacity, impl=impl,
                                      chunk=chunk)
        r2 = self.radius2(source, centers, impl=impl, chunk=chunk,
                          objective=objective)
        return centers, r2, 2 + extra


class SimExecutor(Executor):
    """The paper's experimental setup (§7.1): ``m`` simulated machines on
    one device — the points (an array, or any source, materialized) are
    blocked into m shards, and GON runs on all shards at once, the machines
    a leading batch axis of the kernels.

    ``device=None`` means ``"cuda"`` and raises where there is none."""

    def __init__(self, m: int = 50, *, device=None):
        if m < 1:
            raise ValueError(f"need at least one machine, got m={m}")
        self.m = m
        self.device = resolve_device(device)
        self._eim_blocked_cache = None

    def run_blocks(self, fn, source, *, objective=None):
        blocked, mask = _block(as_points(source, self.device), self.m)
        if not _is_plain(objective) and objective.weighted:
            w = self._weights(source)
            wb, _ = engine._pad_rows(w, mask.numel(), 0.0)
            return _run_round_w(blocked, mask, wb.reshape(mask.shape), fn)
        return _run_round(blocked, mask, fn)

    def _weights(self, source) -> torch.Tensor:
        """The source's row weights on the device: uploaded once, or made
        there (unit weights) for a source without weights."""
        source = as_source(source)
        if not has_weights(source):
            return torch.ones((source.n,), dtype=torch.float32,
                              device=self.device)
        return upload(weights_of(source, 0, source.n), self.device)

    def default_capacity(self, source, k: int) -> int:
        return max(-(-source.n // self.m), 2 * k)

    def radius2(self, source, centers, *, impl="auto", chunk=None,
                objective=None):
        return _resident_radius2(as_points(source, self.device), centers,
                                 lambda: self._weights(source), impl=impl,
                                 chunk=chunk, objective=objective)

    def _blocked_for(self, source):
        """``(n, points blocked (m, per, d))`` of ``source`` on the device,
        made once a source: EIM calls the filter round every iteration with
        the same source. Cached by a weak reference, so another source
        object never meets a stale copy, and dropped by
        ``end_filter_rounds``; a source that takes no weak reference is not
        cached."""
        cache = self._eim_blocked_cache
        if cache is not None and cache[0]() is source:
            return cache[1]
        x = as_points(source, self.device)
        blocked, _ = _block(x, self.m)
        try:
            self._eim_blocked_cache = (weakref.ref(source),
                                       (x.shape[0], blocked))
        except TypeError:
            pass
        return x.shape[0], blocked

    def end_filter_rounds(self, source) -> None:
        self._eim_blocked_cache = None

    def run_filter_round(self, source, s_new, d_s, h_mask, rank, *,
                         impl="auto", chunk=None):
        """EIM's round on the m simulated machines: each machine updates its
        rows' ``d(x, S)`` against ``S_new`` and takes its own top-k, and the
        merge of those tops is the simulated shuffle. The machine axis is
        flattened into one ``engine.eim_filter_block`` over all blocks (one
        filter launch on the kernel route), as the JAX package's Pallas
        branch does: a row's update does not depend on its machine, and
        top-k values do not depend on the blocking. Padded rows carry
        ``d = 3.4e38`` and ``H = False``."""
        n, blocked = self._blocked_for(source)              # (m, per, d)
        m, per = blocked.shape[0], blocked.shape[1]
        dev = self.device
        d_np = np.full((m * per,), _BIG, np.float32)
        d_np[:n] = d_s
        h_np = np.zeros((m * per,), bool)
        h_np[:n] = h_mask
        d_b, h_b = upload(d_np, dev), upload(h_np, dev)
        top = engine.top_k_init(rank, dev)
        if s_new is None or len(s_new) == 0:
            top = _eim_pivot_block(d_b, h_b, top, rank=rank)
            return d_s, _pivot_from_top(top, rank)
        c = upload(np.asarray(s_new, np.float32), dev)
        d_b, top = engine.eim_filter_block(blocked.view(m * per, -1), c, d_b,
                                           h_b, top, rank=rank, impl=impl,
                                           chunk=chunk)
        back = _HostCopy(n, dev)
        back.put(0, d_b[:n])
        pivot = _pivot_from_top(top, rank)
        back.into(d_s)
        return d_s, pivot


class HostStreamExecutor(Executor):
    """Out-of-core machines: sequential super-shards streamed from the
    source.

    Round 1 is a host-driven fold: each super-shard is uploaded through
    the source's pinned ring, reduced to k centers by GON (the port's
    batched GON as a one-machine batch), and released; at most
    ``1 + prefetch`` shards and the accumulated union are on the device.
    ``memory_budget`` (bytes) bounds them through the engine's
    ``(1+prefetch)·4·rows·(d+1)`` model — the paper's machine capacity
    ``c``; ``block_rows`` sets the shard size directly. The ragged last
    shard is passed short, without padding: its masked and unmasked GON
    pick the same centers (the first center is row 0 either way, and
    padded rows could never be selected).

    ``device=None`` means ``"cuda"`` and raises where there is none."""

    def __init__(self, block_rows: int | None = None,
                 memory_budget: int | None = None,
                 prefetch: int = engine.DEFAULT_PREFETCH, *, device=None):
        if prefetch < 1:
            raise ValueError(f"prefetch must be >= 1, got {prefetch}")
        self.block_rows = block_rows
        self.memory_budget = memory_budget
        self.prefetch = prefetch
        self.device = resolve_device(device)

    def rows_for(self, source) -> int:
        return engine.resolve_block_rows(source.n, source.d,
                                         block_rows=self.block_rows,
                                         memory_budget=self.memory_budget,
                                         prefetch=self.prefetch)

    def _blocks(self, source, rows: int):
        return engine._source_blocks(source, rows, self.prefetch, self.device)

    def run_blocks(self, fn, source, *, objective=None):
        source = as_source(source)
        rows = self.rows_for(source)
        if not _is_plain(objective) and objective.weighted:
            # each block comes with its weights from the same ring slot
            outs, wouts = [], []
            for blk, w in engine._weighted_source_blocks(
                    source, rows, self.prefetch, self.device):
                c, cw = fn(blk[None], None, w[None])
                outs.append(c[0])
                wouts.append(cw[0])
            centers = torch.cat(outs)
            return (centers, torch.ones((centers.shape[0],), dtype=torch.bool,
                                        device=centers.device),
                    torch.cat(wouts))
        # each block's centers are a fresh tensor (the GON run's output, which
        # its steps write), so nothing outlives the ring slot it came from
        outs = [fn(blk[None], None)[0] for blk in self._blocks(source, rows)]
        centers = torch.cat(outs)                            # (M*k, d)
        return centers, torch.ones((centers.shape[0],), dtype=torch.bool,
                                   device=centers.device)

    def default_capacity(self, source, k: int) -> int:
        return max(self.rows_for(source), 2 * k)

    def radius2(self, source, centers, *, impl="auto", chunk=None,
                objective=None):
        if not _is_plain(objective):
            top = engine.fold_top_k_min_d2(
                source, centers, objective.outliers + 1, impl=impl,
                chunk=chunk, block_rows=self.rows_for(source),
                prefetch=self.prefetch, weighted=objective.weighted,
                device=self.device)
            return torch.clamp_min(top[objective.outliers], 0.0)
        return engine.fold_min_d2(source, centers, impl=impl, chunk=chunk,
                                  block_rows=self.rows_for(source),
                                  prefetch=self.prefetch, device=self.device)

    def run_filter_round(self, source, s_new, d_s, h_mask, rank, *,
                         impl="auto", chunk=None):
        """EIM's Rounds 2-3 as one out-of-core fold: each super-shard's
        ``d(x, S_new)`` update and its share of Select's top-k happen while
        the shard is on the device (``engine.eim_filter_block``); only the
        shard ring, ``S_new`` and the (rank,) running top-k are there. The
        per-row state stays on the host: each block's ``d_s`` and ``h_mask``
        go up through pinned memory and its updated ``d_s`` comes back by a
        non-blocking copy, which the pivot read, the round's one
        synchronising call, orders. Every block is padded to ``rows``
        (padded lanes: ``d = 3.4e38``, ``H = False``), so every launch of a
        round has one shape."""
        rows = self.rows_for(source)
        dev = self.device
        have_s = s_new is not None and len(s_new) > 0
        c = upload(np.asarray(s_new, np.float32), dev) if have_s else None
        back = _HostCopy(source.n, dev) if have_s else None
        top = engine.top_k_init(rank, dev)
        off = 0
        for blk in self._blocks(source, rows):
            nb = blk.shape[0]
            d_np = np.full((rows,), _BIG, np.float32)
            d_np[:nb] = d_s[off:off + nb]
            h_np = np.zeros((rows,), bool)
            h_np[:nb] = h_mask[off:off + nb]
            if nb < rows:
                blk = engine._pad_rows(blk, rows, 0.0)[0]
            d_blk, h_blk = upload(d_np, dev), upload(h_np, dev)
            if have_s:
                d_blk, top = engine.eim_filter_block(
                    blk, c, d_blk, h_blk, top, rank=rank, impl=impl,
                    chunk=chunk)
                back.put(off, d_blk[:nb])
            else:
                top = _eim_pivot_block(d_blk, h_blk, top, rank=rank)
            off += nb
        pivot = _pivot_from_top(top, rank)
        if have_s:
            back.into(d_s)
        return d_s, pivot


class MeshExecutor(Executor):
    """The machines are the shards of a named mesh (``launch.mesh.Mesh``).

    The shards are the positions along ``shard_axes``; shard ``i`` is the
    row-major index over those axes as listed (the JAX package's
    ``P(shard_axes)``) and holds rows ``[i·per, (i+1)·per)``. Positions
    along the other mesh axes are replicas that would compute the same
    values, so each shard is computed once. In one process every shard
    lies on the mesh's one device: the machine axis is a leading batch axis
    of the kernels, as in ``SimExecutor``.

    Two input regimes share the executor:

    * **In memory** (a tensor, numpy array or ``ArraySource`` given to
      ``mrg``): the fused path. GON runs on every shard (kernel #1, one
      launch an iteration for all shards), the center sets are gathered
      along the shard axes (``launch.mesh.all_gather``; with
      ``hierarchical`` and more than one axis, one gather and one GON a
      level per axis, Lemma 3), the final GON runs on the union, and the
      radius is one nearest-center pass (#2) over all rows with the max
      over the shards (``all_max``). n must divide by the shard count.
      ``capacity=`` raises: the mesh fixes the machine capacity here.
    * **Streamed** (any point source, split by ``shard_source`` into the
      paper's contiguous machine ranges, or a ``ShardedSource`` whose
      shard count matches): round 1 takes one block of every shard a step
      (``engine.zip_shard_blocks``), uploaded as one ``(S, rows, d)``
      block through the sources' pinned ring, and runs GON on the S blocks
      at once; the union is ordered shard-major (the global row order).
      Rounds 2+ are the shared Lemma-3 ``combine`` (``capacity`` is
      honoured), the radius is the streamed fold over the shards' blocks,
      and EIM's ``run_filter_round`` streams the same steps.
      ``memory_budget`` is per shard: ``rows`` is solved against the
      ``(1+prefetch)·4·rows·(d+1)`` model of one shard, so the ring holds
      S budgets at once. ``mrg`` and ``eim`` over a ``ShardedSource`` are
      bitwise ``HostStreamExecutor`` at the same ``block_rows`` where each
      shard's rows are a multiple of it, and with one block a shard bitwise
      ``mrg_sim(m=S)``.

    No step reads a value back to the host except EIM's pivot, once a
    filter round, as on ``HostStreamExecutor``. The executor runs where the
    mesh's device is; a mesh on ``"cuda"`` raises where there is none.

    **Several processes** (``launch.cluster``, a mesh from
    ``make_cluster_mesh``, each process's shards a ``ProcessShardedSource``):
    the streamed path only. Each process streams and reduces its own shards
    on its own device, every process runs the same steps (the counts of
    every shard follow from the partition), and the processes exchange host
    values: round 1's union once (O(k·S) rows), each radius's per-process
    max, each filter round's top-``rank`` and its updated ``d_s`` slices
    (an all-gather of n floats a round, as the JAX package replicates
    ``d_s``; each process also stages its slices in an n-float pinned
    buffer of which it writes only its own rows).
    So the same calls give every process the bits of the one-process run
    over the same shards and ``block_rows``, at one synchronising read an
    exchange. The fused path and the weighted steps raise there.
    """

    def __init__(self, mesh, shard_axes: Sequence[str] = ("data",),
                 hierarchical: bool = False, *,
                 block_rows: int | None = None,
                 memory_budget: int | None = None,
                 prefetch: int = engine.DEFAULT_PREFETCH):
        if prefetch < 1:
            raise ValueError(f"prefetch must be >= 1, got {prefetch}")
        self.mesh = mesh
        self.shard_axes = tuple(shard_axes)
        if not self.shard_axes:
            raise ValueError("shard_axes must name at least one mesh axis")
        missing = [a for a in self.shard_axes if a not in mesh.shape]
        if missing:
            raise ValueError(f"shard axes {missing} are not axes of the mesh "
                             f"{tuple(mesh.axis_names)}")
        self.hierarchical = hierarchical
        self.block_rows = block_rows
        self.memory_budget = memory_budget
        self.prefetch = prefetch
        self.device = resolve_device(mesh.device)

    # -- the machine blocking the mesh implies ------------------------------

    @property
    def grid(self) -> tuple:
        """The shard axes' sizes, in ``shard_axes`` order: shard ``i`` is
        the row-major index over this grid."""
        return tuple(int(self.mesh.shape[a]) for a in self.shard_axes)

    @property
    def num_shards(self) -> int:
        """Machines: the product of the shard axes' sizes."""
        count = 1
        for size in self.grid:
            count *= size
        return count

    def _sharded(self, source) -> ShardedSource:
        """The per-shard view of ``source``: a ``ShardedSource`` passes
        through when its shard count is the mesh's (a mismatch is a
        partitioning fault and raises); anything else is split into the
        paper's contiguous machine ranges (``SliceSource`` views)."""
        src = as_source(source)
        if isinstance(src, ShardedSource):
            if src.num_shards != self.num_shards:
                raise ValueError(
                    f"ShardedSource has {src.num_shards} shards but the "
                    f"mesh blocking over {self.shard_axes} has "
                    f"{self.num_shards} — re-shard the input or change "
                    "shard_axes")
            return src
        return shard_source(src, self.num_shards)

    def rows_for(self, source) -> int:
        """Per-shard block rows: ``block_rows``, or ``memory_budget``
        (bytes, a shard's) solved against the ring's residency model for
        the largest shard, as ``HostStreamExecutor`` does for the whole
        source."""
        sh = self._sharded(source)
        return engine.resolve_block_rows(max(sh.max_shard_rows, 1), sh.d,
                                         block_rows=self.block_rows,
                                         memory_budget=self.memory_budget,
                                         prefetch=self.prefetch)

    def default_capacity(self, source, k: int) -> int:
        return max(self.rows_for(source), 2 * k)

    def _local_ids(self, sh: ShardedSource):
        """The shards this process feeds: ``None`` (all of them) in one
        process, where a source that holds data for fewer shards than it
        has (shards of other processes) raises, as no other process exists
        to feed them.

        Under several processes (``compat.process_count() > 1``), the
        shards of the mesh that this process owns
        (``compat.local_shard_indices``). The mesh must span the run's
        processes (``make_cluster_mesh``), and a source with
        ``local_shard_ids`` (a ``ProcessShardedSource``) must hold data for
        all of them: a data partition that disagrees with the mesh raises
        here, not as a ``RemoteShard`` read deep in a fold."""
        src_local = getattr(sh, "local_shard_ids", None)
        if compat.process_count() == 1:
            if src_local is not None and len(src_local) < sh.num_shards:
                raise ValueError(
                    "source has remote shards but the runtime is "
                    "single-process — no other process exists to feed them")
            return None
        if self.mesh.processes != compat.process_count():
            raise ValueError(
                f"the mesh spans {self.mesh.processes} process(es) but the "
                f"run has {compat.process_count()}; build it with "
                "launch.mesh.make_cluster_mesh on every process")
        lids = compat.local_shard_indices(self.mesh, sh.num_shards)
        if src_local is not None:
            missing = sorted(set(lids) - set(src_local))
            if missing:
                raise ValueError(
                    f"process {compat.process_index()} owns mesh shards "
                    f"{lids} but the source holds no data for shards "
                    f"{missing} — align the data partition with the mesh "
                    "(ProcessShardedSource.for_process with the launch "
                    "process id)")
        return lids

    # -- per-step sharded streaming -----------------------------------------

    def _stream_steps(self, sh: ShardedSource, rows: int, local, *,
                      weighted: bool = False, masks: bool = True):
        """Round 1's and the filter rounds' steps on the device, over the
        shards this process feeds (``local``, from ``_local_ids``; ``None``
        is all S): yields ``(pts (S_l, rows, d), mask (S_l, rows) bool or
        None, counts (S,) np)``, with ``weighted`` ``(pts, mask, w (S_l,
        rows), counts)``. A step is one ``(S_l·rows, d)`` block of the fed
        shards through the sources' pinned ring (its weights in the same
        slot), up to ``prefetch`` steps ahead. ``counts`` covers every
        shard, the other processes' too (from the partition, without a
        read), so every process runs the same steps. The mask (rows below
        each fed shard's count; ``masks=False`` skips it) is made on the
        device from the uploaded counts, and is ``None`` for a full step,
        whose every row is valid."""
        S, d, dev = sh.num_shards, sh.d, self.device
        ids = np.arange(S) if local is None else np.unique(local)
        counts_q: deque = deque()

        def host():
            for step in engine.zip_shard_blocks(sh.shards, rows,
                                                with_weights=weighted,
                                                local_ids=local):
                counts_q.append(step[-1])
                pts = step[0].reshape(ids.size * rows, d)
                yield (pts, step[1].reshape(-1)) if weighted else pts

        lanes = torch.arange(rows, device=dev)
        for item in stream_device(host(), self.prefetch, dev,
                                  paired=weighted):
            counts = counts_q.popleft()
            fed = counts[ids]
            blk = item[0] if weighted else item
            pts = blk.view(ids.size, rows, d)
            mask = None
            if masks and bool((fed < rows).any()):
                mask = lanes[None, :] < upload(fed, dev)[:, None]
            if weighted:
                yield pts, mask, item[1].view(ids.size, rows), counts
            else:
                yield pts, mask, counts

    # -- the Executor interface, sharded ------------------------------------

    def run_blocks(self, fn, source, *, objective=None):
        """Round 1 over the mesh machines: a step's S blocks (padded,
        masked where short) go through ``fn`` at once, the machine axis
        leading (one GON launch an iteration for all shards). The union is
        ordered shard-major (shard 0's blocks first): the global row order,
        ``HostStreamExecutor``'s union for the same blocking. A step where a
        shard has run out gives that shard k invalid rows.

        Under several processes each runs ``fn`` on its own shards' blocks
        (one launch an iteration for its S_l shards), and the local unions
        are exchanged once, after the last step (``compat.fetch_global``,
        one read of the local union: O(k·S) values), into the same
        shard-major union on every process. Weighted steps raise there
        (``zip_shard_blocks``)."""
        sh = self._sharded(source)
        rows = self.rows_for(sh)
        local = self._local_ids(sh)
        weighted = not _is_plain(objective) and objective.weighted
        cs, ws, vs = [], [], []
        for step in self._stream_steps(sh, rows, local, weighted=weighted):
            counts = step[-1]
            if weighted:
                c, cw = fn(step[0], step[1], step[2])      # (S,k,d), (S,k)
                ws.append(cw)
            else:
                c = fn(step[0], step[1])                    # (S, k, d)
            cs.append(c)
            vs.append(counts > 0)
        if not cs:
            raise ValueError("cannot run round 1 over an empty source")
        k, d = cs[0].shape[1], cs[0].shape[2]
        centers = torch.stack(cs, dim=1).reshape(-1, d)    # (S·B·k, d)
        if local is not None:
            # this process's shards' unions, each (B·k, d), in shard order
            mine = centers.cpu().numpy().reshape(len(local), -1, d)
            pieces = [None] * sh.num_shards
            for j, s in enumerate(local):
                pieces[s] = mine[j]
            centers = upload(compat.fetch_global(pieces), self.device)
        valid = upload(np.repeat(np.stack(vs, axis=1).reshape(-1), k),
                       self.device)
        if weighted:
            return centers, valid, torch.stack(ws, dim=1).reshape(-1)
        return centers, valid

    def radius2(self, source, centers, *, impl="auto", chunk=None,
                objective=None):
        """Squared covering radius: over an ``ArraySource``, one
        nearest-center pass over all rows (#2) and the max (or the
        objective's top-(z+1)); over a sharded or host-backed source, the
        streamed fold over the ``ShardedSource``'s blocks, which never
        cross a shard boundary (#3; #6 when weighted), at the per-shard
        ``rows``. Both give the bits of the other executors' radius.

        Under several processes (plain objective only; another raises, as
        in the JAX package) each process folds its own shards' blocks, the
        same blocks at the same ``rows``, reads its max (one read) and
        exchanges it; the max of the maxima is the one fold's max, bitwise,
        on every process."""
        src = as_source(source)
        if isinstance(src, ArraySource):
            return _resident_radius2(
                as_points(src, self.device), centers,
                lambda: torch.ones((src.n,), dtype=torch.float32,
                                   device=self.device),
                impl=impl, chunk=chunk, objective=objective)
        sh = self._sharded(src)
        local = self._local_ids(sh)
        rows = self.rows_for(sh)
        if local is not None:
            if not _is_plain(objective):
                raise NotImplementedError(
                    "multi-process radius2 supports only the plain "
                    "objective (a top-(z+1) cross-process merge is a "
                    "value fold too, but no caller exists yet)")
            mine = ShardedSource([sh.shards[s] for s in local])
            part = engine.fold_min_d2(mine, centers, impl=impl, chunk=chunk,
                                      block_rows=rows, prefetch=self.prefetch,
                                      device=self.device)
            parts = compat.exchange_host(part.cpu().numpy())
            return upload(parts.max().reshape(1), self.device)[0]
        if not _is_plain(objective):
            top = engine.fold_top_k_min_d2(
                sh, centers, objective.outliers + 1, impl=impl, chunk=chunk,
                block_rows=rows, prefetch=self.prefetch,
                weighted=objective.weighted, device=self.device)
            return torch.clamp_min(top[objective.outliers], 0.0)
        return engine.fold_min_d2(sh, centers, impl=impl, chunk=chunk,
                                  block_rows=rows, prefetch=self.prefetch,
                                  device=self.device)

    def run_filter_round(self, source, s_new, d_s, h_mask, rank, *,
                         impl="auto", chunk=None, weights=None):
        """EIM's Rounds 2-3 over the mesh machines: each step updates every
        shard's slice of ``d(x, S_new)`` and takes its top-k (one filter
        launch over the step's S blocks; a row's update does not depend on
        its shard, and top-k values do not depend on the blocking), merged
        into the pivot. ``source`` may be a compacted ``IndexedSource``
        view: it is split into contiguous machine ranges on the fly, and
        ``d_s``/``h_mask`` hold its slices, read and updated at per-shard
        cursors. Padded lanes carry ``d = 3.4e38`` and ``H = False``. The
        updated ``d_s`` comes back by non-blocking copies, which the pivot
        read (the round's one synchronising call) orders. ``weights``
        raises, as in the JAX package: no weighted caller exists.

        Under several processes each process streams its own shards (one
        filter launch a step for its S_l blocks) and reads its top-``rank``
        once, the round's one synchronising call; the processes exchange
        their tops, and each merges them into the pivot (top-k values do
        not depend on the blocking). They then exchange their shards'
        updated ``d_s`` slices (``compat.fetch_global``), so every process
        holds the same host ``d_s``: EIM's host state stays the same
        everywhere, so every process makes the same calls."""
        if weights is not None:
            raise NotImplementedError(
                "MeshExecutor.run_filter_round does not support weights "
                "yet — use SimExecutor or HostStreamExecutor for weighted "
                "filter rounds")
        sh = self._sharded(source)
        rows = self.rows_for(sh)
        local = self._local_ids(sh)
        S, d, dev = sh.num_shards, sh.d, self.device
        ids = range(S) if local is None else local
        have_s = s_new is not None and len(s_new) > 0
        c = upload(np.asarray(s_new, np.float32), dev) if have_s else None
        back = _HostCopy(sh.n, dev) if have_s else None
        top = engine.top_k_init(rank, dev)
        pos = sh.offsets[:-1].astype(np.int64)       # per-shard view cursor
        for pts, _, counts in self._stream_steps(sh, rows, local,
                                                 masks=False):
            d_np = np.full((len(ids), rows), _BIG, np.float32)
            h_np = np.zeros((len(ids), rows), bool)
            for j, s in enumerate(ids):
                a, nb = int(pos[s]), int(counts[s])
                d_np[j, :nb] = d_s[a:a + nb]
                h_np[j, :nb] = h_mask[a:a + nb]
            d_blk = upload(d_np.reshape(-1), dev)
            h_blk = upload(h_np.reshape(-1), dev)
            if have_s:
                d_blk, top = engine.eim_filter_block(
                    pts.view(len(ids) * rows, d), c, d_blk, h_blk, top,
                    rank=rank, impl=impl, chunk=chunk)
                for j, s in enumerate(ids):
                    if counts[s]:
                        back.put(int(pos[s]),
                                 d_blk[j * rows:j * rows + int(counts[s])])
            else:
                top = _eim_pivot_block(d_blk, h_blk, top, rank=rank)
            pos += counts
        if local is not None:
            # the read of the round (it orders the copies back), then the
            # exchange of the tops and of the updated d_s slices
            tops = compat.exchange_host(top.cpu().numpy())   # (P, rank)
            top = engine.merge_top_k(engine.top_k_init(rank, "cpu"),
                                     torch.from_numpy(tops), rank)
        pivot = _pivot_from_top(top, rank)
        if have_s and local is None:
            back.into(d_s)
        elif have_s:
            buf, offs = back.buf.numpy(), sh.offsets
            d_s[:] = compat.fetch_global(
                [buf[offs[s]:offs[s + 1]] if s in local else None
                 for s in range(S)])
        return d_s, pivot

    # -- MRG: the fused path, or the streamed sharded rounds ----------------

    def mrg(self, source, k: int, *, capacity: int | None = None,
            impl: str = "auto", chunk: int | None = None, objective=None):
        """MRG on the mesh. An ``ArraySource`` runs the fused path
        (``capacity=`` raises: the mesh blocking fixes the capacity there);
        any other source runs the streamed sharded rounds with the shared
        Lemma-3 ``combine`` (``capacity`` honoured). Non-plain objectives
        always take the streamed rounds, as in the JAX package."""
        src = as_source(source)
        if isinstance(src, ArraySource) and _is_plain(objective):
            if compat.process_count() > 1:
                raise NotImplementedError(
                    "the fused in-memory mesh path runs in one process; "
                    "under several processes pass each process's shards as "
                    "a ProcessShardedSource (the streamed path)")
            if capacity is not None:
                raise ValueError(
                    "MeshExecutor's machine capacity on the device path is "
                    "fixed by the mesh blocking (shard size / gather "
                    "tree); capacity= is not supported — use shard_axes/"
                    "hierarchical, or pass a ShardedSource / host-backed "
                    "source for the streamed path")
            return self._mrg_fused(src, k, impl=impl, chunk=chunk)
        return super().mrg(src, k, capacity=capacity, impl=impl, chunk=chunk,
                           objective=objective)

    def _mrg_fused(self, source, k: int, *, impl: str = "auto",
                   chunk: int | None = None):
        """The fused path: ``(centers (k, d), radius2 (), rounds)``.

        GON on every shard, unmasked (the S shards one batch); then the
        flat gather along every shard axis in order and one GON over the
        union, or with ``hierarchical`` and more than one axis a gather
        and a GON a level, each level's groups one batch; then the radius
        as one nearest-center pass over all n rows against the final
        centers and the max over the shards (d² is computed per row, so
        these are the bits of per-shard maxima and their max)."""
        x = as_points(source, self.device)
        n, d = x.shape
        S, grid = self.num_shards, self.grid
        if n % S:
            raise ValueError(
                f"the fused mesh path splits the n={n} rows evenly over the "
                f"{S} shards of {self.shard_axes}; n must be a multiple of "
                f"{S} — pad the input, or pass a point source for the "
                "streamed path")
        per = n // S
        centers = _gonzalez_device(x.view(S, per, d), k, impl=impl,
                                   chunk=chunk).centers.view(*grid, k, d)
        levels = self.hierarchical and len(grid) > 1
        for a in range(len(grid)):
            centers = all_gather(centers, a)
            if levels:
                g = centers.shape[:-2]
                centers = _gonzalez_device(
                    centers.reshape(-1, centers.shape[-2], d), k, impl=impl,
                    chunk=chunk).centers.view(*g, k, d)
        if not levels:
            centers = _gonzalez_device(centers.reshape(1, -1, d), k,
                                       impl=impl, chunk=chunk).centers
        final = centers.reshape(k, d)
        _, d2 = ops.assign_nearest(x, final, impl=impl, chunk=chunk)
        r2 = all_max(d2.view(*grid, per).amax(dim=-1))
        rounds = 1 + (len(grid) if levels else 1)
        return final, r2, rounds
