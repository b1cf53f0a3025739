"""k-center coreset selection — the framework use of the paper (port of
``repro.core.coreset``).

Data curation by diversity: run MRG (or GON) on an embedding cloud, keep
the k selected examples and their cluster sizes as importance weights.
Over a host, disk or generator point source every pass streams, so the
cloud is bounded by host RAM or disk, not by device memory.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from repro_torch.data.source import ArraySource, has_weights, is_source
from repro_torch.device import as_points, resolve_device
from repro_torch.kernels import ops

from .executor import Executor
from .gonzalez import gonzalez
from .mrg import mrg, mrg_distributed


class Coreset(NamedTuple):
    indices: torch.Tensor    # (k,)  selected example indices, int32
    centers: torch.Tensor    # (k,d) embedding-space centers
    weights: torch.Tensor    # (k,)  cluster sizes (importance weights)
    radius2: torch.Tensor    # ()    squared covering radius


def select_coreset(embeddings, k: int, *, mesh=None,
                   shard_axes: Sequence[str] = ("data",),
                   executor: Executor | None = None, impl: str = "auto",
                   chunk: int | None = None, block_rows: int | None = None,
                   memory_budget: int | None = None,
                   device=None) -> Coreset:
    """Pick k maximally diverse examples from ``embeddings (n, d)``.

    With a ``mesh`` (``launch.mesh.Mesh``), runs the paper's MRG across
    its ``shard_axes`` (``mrg_distributed``, the fused path: 2 rounds,
    4-approximation); with an ``executor``, runs MRG on it (e.g.
    ``HostStreamExecutor`` for an out-of-core cloud); without either, runs
    GON (2-approximation),
    streamed if ``embeddings`` is a host, disk or generator
    ``PointSource``. The reverse passes — cluster sizes and each center's
    example index — stream too for such a source, and inherit the
    executor's ``block_rows``/``memory_budget`` unless given. Cluster sizes
    are counted in int32 and returned as float32 (exact below 2^24). A
    ``WeightedSource`` (always streamed) sums its row weights per cluster
    instead of counting rows, so the coreset's importance weights stay a
    weighted instance; selection and the radius are the plain ones, as in
    the JAX package. The weights' sums on the card add in no fixed order:
    bitwise for integer weights whose sums stay below 2^24.

    ``chunk`` (rows) bounds every distance pass's plain-route tiles, the
    reverse passes' included. ``device=None`` means the mesh's or the
    executor's device, else ``"cuda"``.

    >>> import numpy as np
    >>> emb = np.random.default_rng(0).normal(size=(100, 8)).astype(np.float32)
    >>> cs = select_coreset(emb, 10, device="cpu")
    >>> tuple(cs.indices.shape), tuple(cs.centers.shape)
    ((10,), (10, 8))
    >>> int(cs.weights.sum())      # every example lands in one cluster
    100
    """
    runner = mesh if mesh is not None else executor
    if runner is not None:
        if device is not None:
            raise ValueError("pass device= to the mesh or the executor, "
                             "not to select_coreset()")
        dev = runner.device
    else:
        dev = resolve_device(device)
    if is_source(embeddings):
        src = embeddings
        streamed = not isinstance(src, ArraySource)
    else:
        # raw arrays (numpy included) stay in memory: only an explicit
        # PointSource opts into streaming
        src = ArraySource(embeddings, device=dev)
        streamed = False
    if block_rows is None and memory_budget is None and executor is not None:
        block_rows = getattr(executor, "block_rows", None)
        memory_budget = getattr(executor, "memory_budget", None)
    if mesh is not None:
        # the fused mesh path shards a device-resident copy
        centers, r2 = mrg_distributed(as_points(src, dev), k, mesh,
                                      shard_axes=shard_axes, impl=impl,
                                      chunk=chunk)
    else:
        if executor is not None:
            res = mrg(src, k, executor=executor, impl=impl, chunk=chunk)
        else:
            res = gonzalez(src, k, impl=impl, chunk=chunk,
                           block_rows=block_rows,
                           memory_budget=memory_budget, device=dev)
        centers, r2 = res.centers, res.radius2
    # int32 counts are exact (n < 2^31); a weighted source's f32 weight sums
    # are exact below 2^24 for integer weights. One pass of the assign with
    # the sums folded in, every block adding into the same (k,) tensor.
    if streamed:
        weighted = has_weights(src)
        sums = ops.assign_sums_source(
            src, centers, impl=impl, chunk=chunk, block_rows=block_rows,
            memory_budget=memory_budget, weighted=weighted, device=dev)
        cidx = ops.argmin_dist2_over_source(
            src, centers, impl=impl, chunk=chunk, block_rows=block_rows,
            memory_budget=memory_budget, device=dev)
    else:
        emb = as_points(src, dev)
        sums = ops.assign_sums(emb, centers,
                               torch.zeros((k,), dtype=torch.int32,
                                           device=dev), impl=impl,
                               chunk=chunk)
        cidx = ops.argmin_dist2_over_rows(emb, centers, impl=impl,
                                          chunk=chunk)
    return Coreset(cidx, centers, sums.to(torch.float32), r2)


def embed_batches(apply_fn: Callable[[object], torch.Tensor],
                  token_batches: Sequence) -> torch.Tensor:
    """Mean-pooled final hidden states per example, stacked over batches.

    ``apply_fn(tokens (b,s)) -> hidden (b,s,d)``; returns ``(n,d)`` in the
    hidden states' dtype (the mean accumulates in f32)."""
    return torch.cat([apply_fn(tb).mean(dim=1) for tb in token_batches], dim=0)
