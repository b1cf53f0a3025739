"""Shared shape table + config registry (a copy of ``repro.configs``).

Every architecture id maps to:
  full()  — the exact assigned configuration (its shapes; the weights are
            drawn from a seed: no checkpoint is read)
  smoke() — a reduced same-family config for CPU smoke tests

The port's model API runs every architecture; kimi-k2's full() only
sharded over cards (``repro_torch.sharding``): one card holds neither its
weights nor, with its training state, one layer's experts.

Shapes (assigned to every LM arch):
  train_4k    : seq 4096,   global batch 256   -> train_step
  prefill_32k : seq 32768,  global batch 32    -> prefill
  decode_32k  : seq 32768,  global batch 128   -> decode_step (1 new token)
  long_500k   : seq 524288, global batch 1     -> decode_step (sub-quadratic
                archs only: mamba2, hymba; full-attention archs skip)
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "qwen2_0_5b",
    "olmo_1b",
    "minicpm_2b",
    "granite_3_2b",
    "whisper_large_v3",
    "qwen2_vl_2b",
    "hymba_1_5b",
    "mamba2_370m",
    "kimi_k2_1t_a32b",
    "dbrx_132b",
]

# archs able to run the 500k-decode cell (sub-quadratic / windowed+SSM)
LONG_CONTEXT_ARCHS = {"hymba_1_5b", "mamba2_370m"}


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True


def get_config(arch: str, *, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.smoke() if smoke else mod.full()


def schedule_for(arch: str) -> str:
    """The learning-rate schedule ``arch`` trains with (a name of
    ``repro_torch.optim.SCHEDULES``): its module's ``SCHEDULE``, else
    cosine."""
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return getattr(mod, "SCHEDULE", "cosine")


def live_cells():
    """All (arch, shape) dry-run cells after documented skips."""
    return [(a, s) for a in ARCH_IDS for s in SHAPES if shape_applicable(a, s)]
