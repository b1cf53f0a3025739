"""Family-dispatching model API (port of ``repro.models.api``).

One uniform surface for the serving code:

  init_params(cfg, seed=, device=)   -> the model (an ``nn.Module``)
  forward(params, batch, cfg)        -> (logits, aux)
  prefill(params, batch, cfg, S_max) -> (last_logits, cache)
  decode_step(params, cache, token, cfg)
  init_cache(cfg, B, S_max, device=)

``batch`` is a dict with ``tokens`` (B,S), a numpy array or a tensor. The
port runs the ``dense`` family; for ``moe``, ``ssm``, ``hybrid``,
``encdec`` and ``vlm`` every entry point raises ``NotImplementedError``
naming the family. Everything runs under ``torch.inference_mode()``:
training is not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from . import lm
from .config import ModelConfig


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> lm.LM:
    lm.require_dense(cfg)
    return lm.init_params(cfg, seed=seed, device=device)


@torch.inference_mode()
def forward(params, batch: Dict[str, Any], cfg: ModelConfig,
            *, return_hidden: bool = False):
    return lm.forward(params, batch["tokens"], cfg, return_hidden=return_hidden)


def head_weights(params, cfg: ModelConfig):
    lm.require_dense(cfg)
    return lm.head_weights(params, cfg)


@torch.inference_mode()
def prefill(params, batch: Dict[str, Any], cfg: ModelConfig, S_max: int):
    return lm.prefill(params, batch["tokens"], cfg, S_max)


@torch.inference_mode()
def decode_step(params, cache, token, cfg: ModelConfig):
    return lm.decode_step(params, cache, token, cfg)


@torch.inference_mode()
def init_cache(cfg: ModelConfig, B: int, S_max: int, *, device=None):
    return lm.init_cache(cfg, B, S_max, device=device)
