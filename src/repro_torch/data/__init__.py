"""Point sets and point sources.

  pipeline.py  — the LM's synthetic token batches (a copy of
                 ``repro.data.pipeline``: ``token_batch``, ``model_batch``,
                 ``host_slice``)
  pointsets.py — the paper's generators (a verbatim copy of
                 ``repro.data.pointsets``: numpy Philox, so both packages
                 draw bitwise the same inputs from a seed; the JAX package
                 reaches its copy through ``repro.data``, which imports jax)
  source.py    — out-of-core point sources, the sharded input of the mesh
                 (``ShardedSource``, ``shard_source``), the per-process
                 input of a multi-process run (``ProcessShardedSource``,
                 ``RemoteShard``) and the pinned upload ring
"""
from .pipeline import host_slice, model_batch, token_batch  # noqa: F401
from .pointsets import GENERATORS, gau, kddlike, pokerlike, unb, unif  # noqa: F401
from .source import (  # noqa: F401
    ArraySource,
    HostSource,
    IndexedSource,
    MemmapSource,
    PointSource,
    ProcessShardedSource,
    RemoteShard,
    ShardedSource,
    SliceSource,
    SyntheticSource,
    WeightedSource,
    as_source,
    has_weights,
    is_source,
    shard_source,
    stream_device,
    synthetic_source,
    take_weights,
    weights_of,
)
