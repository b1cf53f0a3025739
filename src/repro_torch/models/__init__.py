"""The LM of the port: the dense decoder-only family (port of
``repro.models``).

  config.py — ``ModelConfig`` (a copy of the JAX package's: pure data)
  layers.py — norms, RoPE, chunked GQA attention, the MLPs
  lm.py     — ``LM`` (its state_dict keys are the JAX param paths, the
              layers unstacked), forward, prefill, decode_step, the cache
  api.py    — the family-dispatching surface; families other than
              ``dense`` raise ``NotImplementedError``
"""
from .api import (  # noqa: F401
    decode_step,
    forward,
    head_weights,
    init_cache,
    init_params,
    prefill,
)
from .config import ModelConfig  # noqa: F401
from .lm import LM  # noqa: F401
