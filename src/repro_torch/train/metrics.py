"""Training metrics: JSONL logger + evaluation (held-out perplexity)
(port of ``repro.train.metrics``).

The logger is append-only JSONL (one dict per line) — trivially tailable,
restart-safe (append mode), and aggregation-friendly. ``make_eval_fn``
computes the mean token NLL and perplexity over a deterministic held-out
stream (separate seed space from training — the pipeline is counter-based
so train/eval never overlap).
"""
from __future__ import annotations

import json
import math
import time
from typing import Dict, Optional

import torch

from repro_torch.data import model_batch
from repro_torch.models.config import ModelConfig

from .step import make_loss_fn

EVAL_SEED_OFFSET = 0x0EA1


class MetricsLogger:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = open(path, "a") if path else None
        self.history = []

    def log(self, step: int, **metrics):
        rec = {"step": step, "t": time.time()}
        rec.update({k: (float(v) if hasattr(v, "item") or
                        isinstance(v, (int, float)) else v)
                    for k, v in metrics.items()})
        self.history.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()


def make_eval_fn(cfg: ModelConfig, *, batch_size: int, seq_len: int,
                 batches: int = 4, seed: int = 0):
    """Returns eval_fn(params) -> {"eval_loss", "eval_ppl"}; no graph is
    recorded."""
    loss_fn = make_loss_fn(cfg)

    @torch.no_grad()
    def eval_fn(params) -> Dict[str, float]:
        tot = 0.0
        for i in range(batches):
            b = model_batch(cfg, batch_size, seq_len,
                            seed=seed ^ EVAL_SEED_OFFSET, step=i)
            tot += float(loss_fn(params, b)[0])
        loss = tot / batches
        return {"eval_loss": loss, "eval_ppl": math.exp(min(loss, 30.0))}

    return eval_fn
