"""Training (port of ``repro.train``).

  step.py    — the loss (a chunked softmax cross-entropy, the MoE's aux
               term), the train step (microbatches, the optimizer), the
               train state, the serve closures
  metrics.py — the JSONL metrics logger and the held-out evaluation
"""
from .metrics import MetricsLogger, make_eval_fn  # noqa: F401
from .step import (  # noqa: F401
    chunked_softmax_xent,
    cross_entropy,
    init_train_state,
    make_loss_fn,
    make_serve_steps,
    make_train_step,
)
