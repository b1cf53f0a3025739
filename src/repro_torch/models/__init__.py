"""The LM of the port: every architecture family — dense, moe, ssm,
hybrid, vlm (decoder-only) and encdec (port of ``repro.models``).

  config.py — ``ModelConfig`` (a copy of the JAX package's: pure data)
  layers.py — norms, RoPE and M-RoPE, sinusoidal positions, chunked GQA
              attention (causal, windowed, bidirectional, cross), the MLPs,
              the MoE and the Mamba2 SSD block
  lm.py     — ``LM`` (its state_dict keys are the JAX param paths, the
              layers unstacked), forward, prefill, decode_step, the cache
  encdec.py — ``EncDec`` (whisper): encode, forward, prefill, decode_step
  api.py    — the family-dispatching surface
"""
from .api import (  # noqa: F401
    build_mrope_positions,
    decode_step,
    extra_params,
    forward,
    head_weights,
    init_cache,
    init_params,
    prefill,
    train_forward,
)
from .config import ModelConfig  # noqa: F401
from .encdec import EncDec  # noqa: F401
from .lm import LM  # noqa: F401
