"""Optimizers and learning-rate schedules (port of ``repro.optim``).

  optimizers.py — AdamW and Adafactor, their state keyed by the JAX
                  package's param leaves (``leaf_groups``), the global-norm
                  clip
  schedules.py  — warmup, cosine, WSD and constant, on the host in float32
"""
from .optimizers import (  # noqa: F401
    Optimizer,
    adafactor,
    adamw,
    clip_by_global_norm,
    global_norm,
    leaf_groups,
    make_optimizer,
)
from .schedules import SCHEDULES, constant, cosine, make_schedule, wsd  # noqa: F401
