"""Executors — the paper's "machines" (port of ``repro.core.executor``).

  * ``SimExecutor`` — the paper's experiments: m simulated machines on one
    device; a point source is materialized and blocked into m shards.
  * ``HostStreamExecutor`` — out of core: sequential super-shards streamed
    from a point source through its pinned upload ring, under
    ``memory_budget`` (the paper's machine capacity c, in bytes), so n is
    bounded by host RAM or disk and not by device memory.

Their interface is the JAX package's:

  * ``run_blocks(fn, source)`` — round 1 [map]: the per-machine reducer
    ``fn(points (m, per, d), mask (m, per) or None) -> (m, k, d)`` over
    the machine blocks (the JAX package vmaps a per-block ``fn``; here the
    machine axis is a leading batch axis of the kernels);
  * ``combine(centers, valid, k, capacity)`` — rounds 2+ [reduce]: while
    the union exceeds ``capacity``, re-block and reduce again (Lemma 3),
    then the final single-machine GON;
  * ``radius2(source, centers)`` — the squared covering radius over all
    points, a streamed fold (``SimExecutor``: one in-memory pass);
  * ``mrg(source, k)`` — the three in order.

Only the plain k-center objective is ported; ``objective`` other than
``None`` raises. Nothing here reads a tensor back to the host: the
``combine`` loop reads only shapes.
"""
from __future__ import annotations

import functools
import warnings
from typing import Callable

import torch

from repro_torch.data.source import as_source
from repro_torch.device import as_points, resolve_device
from repro_torch.kernels import engine, ops

from .gonzalez import _gonzalez_device

BlockFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@functools.lru_cache(maxsize=None)
def gon_block_fn(k: int, impl: str = "auto") -> BlockFn:
    """The per-machine reducer: GON restricted to each (masked) block,
    batched over the leading machine axis (``mask=None``: every row)."""
    def fn(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return _gonzalez_device(points, k, mask=mask, impl=impl).centers
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


def _mrg_round(points_blocked: torch.Tensor, mask_blocked: torch.Tensor,
               k: int, m: int, impl: str):
    """One round of per-machine GON (the JAX package's round entry)."""
    del m  # implied by the blocking
    return _run_round(points_blocked, mask_blocked, gon_block_fn(k, impl))


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


def _plain_only(objective) -> None:
    if objective is not None:
        raise NotImplementedError(
            "only the plain k-center objective (objective=None) is ported")


class Executor:
    """Base: block-mapped round 1 + shared Lemma-3 reduction."""

    device: torch.device

    def run_blocks(self, fn, source, *, objective=None):
        """Round 1: map ``fn`` over the machine blocks of ``source``.
        Returns ``(centers (M·k, d), valid (M·k,) bool)``."""
        raise NotImplementedError

    def default_capacity(self, source, k: int) -> int:
        """The paper's machine capacity ``c`` implied by this executor's
        blocking (rows per machine, floored at 2k)."""
        return 2 * k

    def combine(self, centers: torch.Tensor, valid: torch.Tensor, k: int,
                capacity: int, *, impl: str = "auto"):
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
            centers, valid = _mrg_round(blocked, bmask, k, m2, impl)
            extra += 1
        final = _gonzalez_device(centers[None], k, mask=valid[None], impl=impl)
        return final.centers[0], extra

    def radius2(self, source, centers: torch.Tensor, *, impl: str = "auto",
                objective=None) -> torch.Tensor:
        """Squared covering radius over ALL source points, streamed
        (``engine.fold_min_d2``). Returns ``max(min_d2)`` itself: a
        ``sqrt`` → square round trip is lossy in f32, and every executor
        returns the same exact value."""
        _plain_only(objective)
        return engine.fold_min_d2(source, centers, impl=impl,
                                  device=self.device)

    def mrg(self, source, k: int, *, capacity: int | None = None,
            impl: str = "auto", objective=None):
        """Full MRG on this executor over ``source`` (anything
        ``as_source`` takes). Returns ``(centers (k, d), radius2 (),
        rounds)``."""
        _plain_only(objective)
        source = as_source(source)
        if capacity is None:
            capacity = self.default_capacity(source, k)
        # Fail on an infeasible capacity *before* the round-1 pass over all
        # of n (warn=False: combine's own check owns the §3.3 warning).
        check_combine_capacity(k, capacity, warn=False)
        centers, valid = self.run_blocks(gon_block_fn(k, impl), source)
        centers, extra = self.combine(centers, valid, k, capacity, impl=impl)
        return centers, self.radius2(source, centers, impl=impl), 2 + extra


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

    def run_blocks(self, fn, source, *, objective=None):
        _plain_only(objective)
        blocked, mask = _block(as_points(source, self.device), self.m)
        return _run_round(blocked, mask, fn)

    def default_capacity(self, source, k: int) -> int:
        return max(-(-source.n // self.m), 2 * k)

    def radius2(self, source, centers, *, impl="auto", objective=None):
        # One pass of the nearest-center kernel over all n points; returns
        # the squared max directly (a sqrt -> square round trip is lossy).
        _plain_only(objective)
        _, d2 = ops.assign_nearest(as_points(source, self.device), centers,
                                   impl=impl)
        return d2.max()


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
        _plain_only(objective)
        source = as_source(source)
        # each block's centers are a fresh tensor (GON gathers them), so
        # nothing outlives the ring slot it came from
        outs = [fn(blk[None], None)[0]
                for blk in self._blocks(source, self.rows_for(source))]
        centers = torch.cat(outs)                            # (M*k, d)
        return centers, torch.ones((centers.shape[0],), dtype=torch.bool,
                                   device=centers.device)

    def default_capacity(self, source, k: int) -> int:
        return max(self.rows_for(source), 2 * k)

    def radius2(self, source, centers, *, impl="auto", objective=None):
        _plain_only(objective)
        return engine.fold_min_d2(source, centers, impl=impl,
                                  block_rows=self.rows_for(source),
                                  prefetch=self.prefetch, device=self.device)
