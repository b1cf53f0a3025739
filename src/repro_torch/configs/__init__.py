"""Assigned-architecture configs (+ reduced smoke variants)."""
from .common import (  # noqa: F401
    ARCH_IDS,
    LONG_CONTEXT_ARCHS,
    SHAPES,
    ShapeSpec,
    get_config,
    live_cells,
    schedule_for,
    shape_applicable,
)
