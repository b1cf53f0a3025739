"""Checkpoints (port of ``repro.checkpoint``): atomic saves of a train
state, a ``latest`` pointer, retention, restore into a template by name."""
from .manager import (  # noqa: F401
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
