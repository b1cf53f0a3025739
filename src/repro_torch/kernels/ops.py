"""Public kernel API of the port: a thin façade over ``engine``, with the
names of ``repro.kernels.ops`` that this part of the port has."""
from __future__ import annotations

from . import engine, ref  # noqa: F401  (ops.ref is public API)

dist2_to_center = engine.dist2_to_center
fused_min_argmax = engine.fused_min_argmax
assign_nearest = engine.assign_nearest
