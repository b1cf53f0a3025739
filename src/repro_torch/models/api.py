"""Family-dispatching model API (port of ``repro.models.api``).

One uniform surface for the serving code:

  init_params(cfg, seed=, device=)   -> the model (an ``nn.Module``)
  forward(params, batch, cfg)        -> (logits, aux)
  train_forward(params, batch, cfg)  -> the same, recording the graph
  prefill(params, batch, cfg, S_max) -> (last_logits, cache)
  decode_step(params, cache, token, cfg)
  init_cache(cfg, B, S_max, device=)
  extra_params(cfg)                  -> parameters beyond cfg.param_counts()

``batch`` is a dict: ``tokens`` (B,S) always; ``frames`` (B,Se,D) for
encdec; ``patch_embeds`` (B,P,D) for vlm (optional: without them the
first P positions are still on the patch grid of ``build_mrope_positions``).
Each a numpy array or a tensor. Modality frontends are stubs: the model
takes precomputed embeddings. The serving surface (``forward``,
``prefill``, ``decode_step``, ``init_cache``) runs under
``torch.inference_mode()``: it records no graph, and its tensors carry
none. The trainer's loss goes through ``train_forward``, the same
forward where autograd records, with the config's remat.

Under an installed mesh (``repro_torch.sharding.use_mesh``) each entry
point takes the global batch and runs on this process's data-parallel
rows of it; ``forward``, ``prefill`` and ``decode_step`` return the
logits as a DTensor of the global result (vocab over tp, as the
reference constrains them) and the cache as this process's local
tensors.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.sharding import runtime as _sr

from . import encdec, lm
from .config import ModelConfig


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None):
    if cfg.family == "encdec":
        return encdec.init_params(cfg, seed=seed, device=device)
    return lm.init_params(cfg, seed=seed, device=device)


def extra_params(cfg: ModelConfig) -> int:
    """Parameters the model holds beyond ``cfg.param_counts()["total"]``:
    the norm scales (and layernorm biases), the SSM's ``dt_bias`` and gated
    norm (its ``A_log`` and ``D`` are counted there), hybrid's branch
    norms, vlm's ``patch_proj``, encdec's MLP biases, less the
    cross-attention biases counted there that it does not have."""
    D, L = cfg.d_model, cfg.num_layers
    per_norm = {"rmsnorm": D, "layernorm": 2 * D, "layernorm_np": 0}[cfg.norm]
    ssm = L * (cfg.ssm_heads + cfg.d_inner)
    if cfg.family == "ssm":
        return (L + 1) * per_norm + ssm
    if cfg.family == "hybrid":
        return (2 * L + 1) * per_norm + ssm + 2 * L * D
    if cfg.family == "encdec":
        hd, H, KV, Le = (cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads,
                         cfg.enc_layers)
        return ((2 * Le + 1 + 3 * L + 1) * per_norm + (Le + L) * (cfg.d_ff + D)
                - (L * (H + 2 * KV) * hd if cfg.qkv_bias else 0))
    return (2 * L + 1) * per_norm + (D * D if cfg.frontend == "vision_stub" else 0)


def build_mrope_positions(cfg: ModelConfig, B: int, S: int, device=None):
    """qwen2-vl M-RoPE positions (3, B, S): a (t, h, w) grid on the first
    ``num_patches`` positions (t = 0, a square of side ``int(sqrt(P))``),
    sequential text after it, all three components ``idx - P + 1``."""
    P = cfg.num_patches
    side = max(1, int(P ** 0.5)) if P else 1
    idx = torch.arange(S, device=device)
    in_patch = idx < P
    text = idx - P + 1
    grid = torch.stack([torch.where(in_patch, 0, text),
                        torch.where(in_patch, idx // side, text),
                        torch.where(in_patch, idx % side, text)])   # (3, S)
    return grid[:, None, :].expand(3, B, S)


def _vlm_kw(params, batch, cfg: ModelConfig) -> Dict[str, Any]:
    B, S = batch["tokens"].shape
    return dict(positions=build_mrope_positions(cfg, B, S, params.device),
                patch_embeds=batch.get("patch_embeds"))


def train_forward(params, batch: Dict[str, Any], cfg: ModelConfig,
                  *, return_hidden: bool = False):
    """Local results: this process's rows under a mesh."""
    batch = _sr.local_batch(batch)
    if cfg.family == "encdec":
        return encdec.forward(params, batch["frames"], batch["tokens"], cfg,
                              return_hidden=return_hidden)
    kw = _vlm_kw(params, batch, cfg) if cfg.family == "vlm" else {}
    return lm.forward(params, batch["tokens"], cfg,
                      return_hidden=return_hidden, **kw)


@torch.inference_mode()
def forward(params, batch: Dict[str, Any], cfg: ModelConfig,
            *, return_hidden: bool = False):
    out, aux = train_forward(params, batch, cfg, return_hidden=return_hidden)
    return _sr.as_global(out, "dp", None, None if return_hidden else "tp"), aux


def head_weights(params, cfg: ModelConfig):
    if cfg.family == "encdec":
        return params.embed.T
    return lm.head_weights(params, cfg)


@torch.inference_mode()
def prefill(params, batch: Dict[str, Any], cfg: ModelConfig, S_max: int):
    batch = _sr.local_batch(batch)
    if cfg.family == "encdec":
        logits, cache = encdec.prefill(params, batch["frames"], batch["tokens"],
                                       cfg, S_max)
    else:
        kw = _vlm_kw(params, batch, cfg) if cfg.family == "vlm" else {}
        logits, cache = lm.prefill(params, batch["tokens"], cfg, S_max, **kw)
    return _sr.as_global(logits, "dp", None, "tp"), cache


@torch.inference_mode()
def decode_step(params, cache, token, cfg: ModelConfig):
    token = _sr.local_batch({"token": token})["token"]
    if cfg.family == "encdec":
        logits, cache = encdec.decode_step(params, cache, token, cfg)
    else:
        logits, cache = lm.decode_step(params, cache, token, cfg)
    return _sr.as_global(logits, "dp", None, "tp"), cache


@torch.inference_mode()
def init_cache(cfg: ModelConfig, B: int, S_max: int, *, device=None):
    if cfg.family == "encdec":
        return encdec.init_cache(cfg, B, S_max, device=device)
    return lm.init_cache(cfg, B, S_max, device=device)
