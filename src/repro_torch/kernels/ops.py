"""Public kernel API of the port: a thin façade over ``engine``, with the
names of ``repro.kernels.ops`` that the port has so far."""
from __future__ import annotations

from . import engine, ref  # noqa: F401  (ops.ref is public API)

dist2_to_center = engine.dist2_to_center
pairwise_dist2 = engine.pairwise_dist2
fused_min_argmax = engine.fused_min_argmax
gon_workspace = engine.gon_workspace
assign_nearest = engine.assign_nearest
assign_nearest_batched = engine.assign_nearest_batched
assign_bucketed = engine.assign_bucketed
assign_sums = engine.assign_sums
argmin_dist2_over_rows = engine.argmin_dist2_over_rows
fused_filter = engine.fused_filter
fused_assign = engine.fused_assign
fused_argmin = engine.fused_argmin

# streamed folds over a point source
DEFAULT_BLOCK_ROWS = engine.DEFAULT_BLOCK_ROWS
DEFAULT_PREFETCH = engine.DEFAULT_PREFETCH
resolve_block_rows = engine.resolve_block_rows
host_blocks_of = engine.host_blocks_of
fold_min_d2 = engine.fold_min_d2
fold_top_k_min_d2 = engine.fold_top_k_min_d2
assign_nearest_source = engine.assign_nearest_source
assign_sums_source = engine.assign_sums_source
argmin_dist2_over_source = engine.argmin_dist2_over_source
top_k_init = engine.top_k_init
merge_top_k = engine.merge_top_k
fold_top_k = engine.fold_top_k
