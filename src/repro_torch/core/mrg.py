"""MRG — "MapReduce Gonzalez" (paper §3, Algorithm 1).

Port of ``repro.core.mrg``: round 1 runs GON on each of the executor's
machine blocks, rounds 2+ reduce the k·m center union under the capacity
``c`` (Lemma 2 for 2 rounds ⇒ 4-approximation; Lemma 3's multi-round
generalization adds +2 per extra level), and the covering radius is one
pass over all points.

Inputs are numpy arrays, tensors or point sources: raw arrays run in
memory on ``SimExecutor``, a host, disk or generator source streams on
``HostStreamExecutor``; on a ``MeshExecutor`` the machines are mesh shards
(``mrg_distributed``). An ``Objective`` makes the run weighted (the
cluster weights in ``MRGResult.weights``) or scores the radius without the
z farthest points. ``chunk`` streams every distance pass's plain route in
row chunks (the centers do not change).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from repro_torch.data.source import ArraySource, as_source, is_source

from .executor import (Executor, HostStreamExecutor, MeshExecutor,  # noqa: F401
                       Objective, SimExecutor, _block, _is_plain, _mrg_round)


class MRGResult(NamedTuple):
    centers: torch.Tensor   # (k, d)
    radius2: torch.Tensor   # () squared covering radius over ALL points
    rounds: int             # number of GON levels used (2 = classic MRG)
    # (k,) per-cluster weight sums of a weighted objective, else None
    weights: torch.Tensor | None = None


def plan_rounds(n: int, m: int, k: int, capacity: int) -> int:
    """Number of GON levels needed so the final instance fits ``capacity``.

    Implements the machine-count recurrence m^(i) <= m (k/c)^i + (1-(k/c)^i)
    / (1-k/c): run first-round style reductions until fewer than 2 machines
    are needed. Returns total levels (>= 2). Raises if k > capacity (the
    paper's hard feasibility requirement: a k-point instance must fit on one
    machine).
    """
    if k > capacity:
        raise ValueError(f"infeasible: k={k} exceeds single-machine capacity {capacity}")
    levels = 1
    machines = m
    while machines * k > capacity:
        machines = math.ceil(machines * k / capacity)
        levels += 1
        if levels > 64:
            raise ValueError("round planning diverged (k too close to capacity; paper §3.3 requires 2k < c)")
    return levels + 1  # +1 for the final single-machine GON


def mrg(points, k: int, *, executor: Executor | None = None, m: int = 50,
        capacity: int | None = None, impl: str = "auto",
        chunk: int | None = None, objective=None, device=None) -> MRGResult:
    """Paper Algorithm 1 on ``points (n, d)``: a numpy array, a tensor or
    a point source.

    Without an ``executor``, raw arrays and ``ArraySource`` run on
    ``SimExecutor(m, device=device)`` and an explicit host, disk or
    generator source on ``HostStreamExecutor(device=device)``: only passing
    a ``PointSource`` opts into streaming (a numpy array is wrapped in an
    ``ArraySource``, not in the ``HostSource`` that ``as_source`` would
    make). ``device=None`` means ``"cuda"`` and raises where there is none.
    ``capacity`` (rows; default: the machine size) triggers the multi-round
    path when the k·m center union would not fit on one machine.
    ``objective`` (an ``Objective``; ``None`` is plain k-center):
    ``weighted=True`` threads the source's row weights through every round
    and fills ``MRGResult.weights`` with the per-cluster sums;
    ``outliers=z`` scores ``radius2`` with the top-(z+1) fold. ``chunk``
    (rows) bounds every distance pass's plain-route tiles
    (``engine.resolve_chunk``); on the kernel route it changes nothing.

    >>> import numpy as np
    >>> x = np.random.default_rng(0).normal(size=(256, 2)).astype(np.float32)
    >>> res = mrg(x, 4, m=8, device="cpu")
    >>> tuple(res.centers.shape), res.rounds
    ((4, 2), 2)
    """
    plain = _is_plain(objective)
    streamed = is_source(points) and not isinstance(points, ArraySource)
    if executor is None:
        executor = (HostStreamExecutor(device=device) if streamed
                    else SimExecutor(m=m, device=device))
    elif device is not None:
        raise ValueError("pass device= to the executor, not to mrg()")
    if streamed:
        source = as_source(points)
    else:
        source = (points if isinstance(points, ArraySource)
                  else ArraySource(points, device=executor.device))
    if not plain and objective.weighted:
        centers, r2, rounds, w = executor.mrg(
            source, k, capacity=capacity, impl=impl, chunk=chunk,
            objective=objective)
        return MRGResult(centers, r2, rounds, w)
    centers, r2, rounds = executor.mrg(source, k, capacity=capacity,
                                       impl=impl, chunk=chunk,
                                       objective=objective)
    return MRGResult(centers, r2, rounds)


def mrg_sim(points, k: int, m: int = 50, *, capacity: int | None = None,
            impl: str = "auto", chunk: int | None = None,
            device=None) -> MRGResult:
    """Paper Algorithm 1 with m simulated machines on one device."""
    return mrg(points, k, m=m, capacity=capacity, impl=impl, chunk=chunk,
               device=device)


def mrg_distributed(points, k: int, mesh, *,
                    shard_axes: Sequence[str] = ("data",),
                    hierarchical: bool = False, impl: str = "auto",
                    chunk: int | None = None):
    """MRG on the shards of ``mesh`` (a ``launch.mesh.Mesh``): a thin shim
    over ``MeshExecutor``.

    ``points (n, d)`` (a numpy array or a tensor: the fused path, n a
    multiple of the shard count; a point source streams shard by shard) is
    split along ``shard_axes``. Round 1: GON on every shard. Round 2(+):
    the center sets gathered along the shard axes; with ``hierarchical``,
    one axis at a time with a GON a level (Lemma 3's multi-round form, +2
    to the approximation factor a level). ``chunk`` bounds the plain
    route's distance tiles. Returns ``(centers (k, d), radius2 ())``.

    >>> import numpy as np
    >>> from repro_torch.launch import make_mesh
    >>> mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    >>> x = np.random.default_rng(0).normal(size=(800, 4)).astype(np.float32)
    >>> c, r2 = mrg_distributed(x, 6, mesh)
    >>> tuple(c.shape)
    (6, 4)
    """
    ex = MeshExecutor(mesh, shard_axes=shard_axes, hierarchical=hierarchical)
    source = (points if is_source(points)
              else ArraySource(points, device=ex.device))
    centers, r2, _ = ex.mrg(source, k, impl=impl, chunk=chunk)
    return centers, r2
