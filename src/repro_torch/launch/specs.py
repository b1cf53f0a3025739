"""Abstract inputs for every (arch × shape) cell (port of
``repro.launch.specs``).

No allocation anywhere: every tensor here is on the meta device (shape
and dtype only), the stand-ins the dry-run places and runs under
``FakeTensorMode``. Modality frontends are stubs: frames / patch
embeddings arrive as precomputed float arrays. Every shape is a *global*
shape (``B`` is the global batch); the mesh layer partitions them
(``repro_torch.sharding``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs import ShapeSpec, get_config
from repro_torch.models import encdec, lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import make_optimizer, make_schedule

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, B: int, S: int, *, train: bool) -> Dict[str, Any]:
    s: Dict[str, Any] = {"tokens": _meta((B, S), torch.int32)}
    if train:
        s["labels"] = _meta((B, S), torch.int32)
    if cfg.family == "encdec":
        s["frames"] = _meta((B, cfg.enc_seq, cfg.d_model), torch.float32)
    if cfg.family == "vlm":
        s["patch_embeds"] = _meta((B, cfg.num_patches, cfg.d_model), torch.float32)
    return s


def params_specs(cfg: ModelConfig, device=META):
    """The model with its parameters uninitialised on ``device`` (the meta
    device: shapes only)."""
    cls = encdec.EncDec if cfg.family == "encdec" else lm.LM
    return cls(cfg, device=device)


def make_opt(cfg: ModelConfig, total_steps: int = 10_000):
    sched = "wsd" if cfg.name.startswith("minicpm") else "cosine"
    lr_fn = make_schedule(sched, peak=3e-4, warmup=200, total=total_steps)
    return make_optimizer(cfg.optimizer, lr_fn)


def state_specs(cfg: ModelConfig):
    params = params_specs(cfg)
    return {"params": params, "opt": make_opt(cfg).init(params), "step": 0}


def cache_specs(cfg: ModelConfig, B: int, S_max: int, device=META):
    mod = encdec if cfg.family == "encdec" else lm
    return mod.init_cache(cfg, B, S_max, device=device)


def input_specs(arch: str, shape: ShapeSpec,
                *, smoke: bool = False) -> Tuple[ModelConfig, Dict[str, Any]]:
    """Everything the step function for this cell consumes, as abstract
    specs: (cfg, {kind-specific inputs})."""
    cfg = get_config(arch, smoke=smoke)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return cfg, {"state": state_specs(cfg),
                     "batch": batch_specs(cfg, B, S, train=True)}
    if shape.kind == "prefill":
        return cfg, {"params": params_specs(cfg),
                     "batch": batch_specs(cfg, B, S, train=False)}
    # decode: one new token against an S-long cache
    return cfg, {"params": params_specs(cfg),
                 "cache": cache_specs(cfg, B, S),
                 "token": _meta((B, 1), torch.int32)}
