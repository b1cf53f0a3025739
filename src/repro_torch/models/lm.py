"""Decoder-only LM, the dense family (port of ``repro.models.lm``).

``LM`` holds the parameters under the JAX package's paths: the state_dict
key ``layers.{i}.attn.wq`` is ``params["layers"]["attn"]["wq"][i]`` there
(the reference stacks its layers on a leading L axis and scans them; here
they are a ``ModuleList``, applied in a Python loop).

Entry points
  init_params(cfg, seed=, device=)          -> LM
  forward(params, tokens, cfg, ...)         -> (logits, aux)
  prefill(params, tokens, cfg, S_max)       -> (last_logits, cache)
  decode_step(params, cache, token, cfg)    -> (logits, cache)

The decode cache is a dict: ``k``/``v`` (L, B, S_max, KV, hd) in the
compute dtype and ``pos`` (B,) int32. ``decode_step`` writes its k/v rows
into the cache's buffers in place and returns the cache with ``pos + 1``.
Rematerialisation and sharding constraints only matter for training and
meshes; they are not here.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device, upload

from . import layers as L
from .config import ModelConfig


def require_dense(cfg: ModelConfig) -> None:
    """Raise for a family the port does not run yet."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; the "
            "port runs 'dense', and a later slice of ROADMAP.md ports "
            f"{cfg.family!r}")


# ---------------------------------------------------------------------------
# Modules and init
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One dense transformer block: ``ln1``, ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, gen=None, *, device=None):
        super().__init__()
        self.ln1 = L.init_norm(cfg, device=device)
        self.attn = L.init_attention(cfg, gen, device=device)
        self.ln2 = L.init_norm(cfg, device=device)
        self.mlp = L.init_mlp(cfg, gen, device=device)


class LM(nn.Module):
    """``embed (V, D)``, ``layers``, ``final_norm`` and, untied,
    ``lm_head (D, V)``. Drawn from ``gen`` (a ``torch.Generator`` on the
    target device) in that order, or left uninitialised on ``device`` for
    weights carried in (``interop.params_from_jax``)."""

    def __init__(self, cfg: ModelConfig, gen=None, *, device=None):
        super().__init__()
        require_dense(cfg)
        self.cfg = cfg
        if gen is not None:
            device = gen.device
        V, D = cfg.vocab_size, cfg.d_model
        self.embed = L._param(L._dense_init(gen, (V, D), 1.0, L.pdt(cfg), device))
        self.layers = nn.ModuleList(_init_layer(cfg, gen, device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = L.init_norm(cfg, device=device)
        self.lm_head = None
        if not cfg.tie_embeddings:
            self.lm_head = L._param(L._dense_init(gen, (D, V), 1.0, L.pdt(cfg),
                                                  device))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _init_layer(cfg: ModelConfig, gen, device) -> Block:
    return Block(cfg, gen, device=device)


@torch.no_grad()
def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> LM:
    """The model with weights drawn from ``torch.Generator(device)`` seeded
    ``seed``: N(0, 1) in f32 times ``1 / sqrt(fan_in)``, cast to the param
    dtype; norm scales 1, biases 0. ``device=None`` is the card (raises
    without one). Not bitwise the JAX package's init: carry its weights
    with ``interop.params_from_jax`` for that."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return LM(cfg, gen)


def _layer_flags(cfg: ModelConfig) -> list:
    """(L,) bool — True where the layer uses *global* attention."""
    if cfg.window and cfg.global_every:
        return [i % cfg.global_every == 0 for i in range(cfg.num_layers)]
    return [not cfg.window] * cfg.num_layers


def _window(cfg: ModelConfig) -> int:
    return cfg.window if not cfg.global_every else 0


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _residual(x, rs: float, out):
    return x + out if rs == 1.0 else x + rs * out


def _block_fwd(x, lp: Block, is_global, cfg: ModelConfig, positions,
               cos_sin=None):
    """One transformer block over the full sequence. Returns (x', (k,v))."""
    rs = cfg.residual_scale
    h = L.apply_norm(lp.ln1, x, cfg)
    attn_out, kv = L.attention_block(lp.attn, h, cfg, positions=positions,
                                     window=_window(cfg), cos_sin=cos_sin)
    x = _residual(x, rs, attn_out)
    h2 = L.apply_norm(lp.ln2, x, cfg)
    return _residual(x, rs, L.apply_mlp(lp.mlp, h2, cfg)), kv


def _block_decode(x, lp: Block, cache_l, is_global, pos, cfg: ModelConfig,
                  cos_sin=None):
    """One block, single-token decode. ``cache_l``: the layer's ``k``/``v``
    views, written in place."""
    rs = cfg.residual_scale
    h = L.apply_norm(lp.ln1, x, cfg)
    attn_out, ck, cv = L.attention_decode(
        lp.attn, h, cache_l["k"], cache_l["v"], pos, cfg, window=_window(cfg),
        cos_sin=cos_sin)
    x = _residual(x, rs, attn_out)
    h2 = L.apply_norm(lp.ln2, x, cfg)
    return _residual(x, rs, L.apply_mlp(lp.mlp, h2, cfg)), {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def as_tokens(tokens, device) -> torch.Tensor:
    """Token ids (a numpy array or a tensor) as an int32 tensor on
    ``device``; a host array goes up through pinned memory, queued without
    a wait."""
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device=device, dtype=torch.int32)
    return upload(np.asarray(tokens, np.int32), torch.device(device))


def _embed(params: LM, tokens, cfg: ModelConfig):
    return F.embedding(tokens, params.embed).to(L.dt(cfg))


def head_weights(params: LM, cfg: ModelConfig):
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def apply_head(w, x, cfg: ModelConfig):
    """hidden (B,S,D) x head (D,V) -> f32 logits, with arch scaling."""
    logits = L.matmul(x, w)
    if cfg.logit_scale != 1.0:
        logits = logits * cfg.logit_scale
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _logits(params: LM, x, cfg: ModelConfig):
    x = L.apply_norm(params.final_norm, x, cfg)
    return apply_head(head_weights(params, cfg), x, cfg)


def default_positions(cfg: ModelConfig, B: int, S: int, device=None):
    if cfg.rope_type == "mrope":
        raise NotImplementedError("M-RoPE is not ported yet (the vlm family)")
    return torch.arange(S, device=device)[None, :].expand(B, S)


def _cos_sin(cfg: ModelConfig, positions):
    """RoPE's cos/sin at ``positions``, once for all layers."""
    if cfg.rope_type != "rope":
        return None
    return L.rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def forward(params: LM, tokens, cfg: ModelConfig, *, positions=None,
            return_hidden: bool = False):
    """tokens (B,S) -> (logits (B,S,V) f32, aux dict).

    ``return_hidden=True`` yields the final-norm'd hidden states (B,S,D) in
    the compute dtype instead of logits."""
    require_dense(cfg)
    tokens = as_tokens(tokens, params.device)
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    if positions is None:
        positions = default_positions(cfg, B, S, tokens.device)
    cos_sin = _cos_sin(cfg, positions)
    for lp, flag in zip(params.layers, _layer_flags(cfg)):
        x, _ = _block_fwd(x, lp, flag, cfg, positions, cos_sin)
    aux = {"moe_aux": 0.0}
    if return_hidden:
        return L.apply_norm(params.final_norm, x, cfg), aux
    return _logits(params, x, cfg), aux


# ---------------------------------------------------------------------------
# KV cache, prefill, decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, B: int, S_max: int, dtype=None, *,
               device=None) -> Dict[str, Any]:
    require_dense(cfg)
    dev = resolve_device(device)
    dtype = dtype or L.dt(cfg)
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (cfg.num_layers, B, S_max, KV, hd)
    return {"pos": torch.zeros((B,), dtype=torch.int32, device=dev),
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def prefill(params: LM, tokens, cfg: ModelConfig, S_max: int, *,
            positions=None):
    """Run the full prompt, build the decode cache. Returns (last_logits
    (B,1,V), cache)."""
    require_dense(cfg)
    tokens = as_tokens(tokens, params.device)
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    if positions is None:
        positions = default_positions(cfg, B, S, tokens.device)
    cos_sin = _cos_sin(cfg, positions)
    cache = init_cache(cfg, B, S_max, device=tokens.device)
    cache["pos"].fill_(S)
    for i, (lp, flag) in enumerate(zip(params.layers, _layer_flags(cfg))):
        x, (k, v) = _block_fwd(x, lp, flag, cfg, positions, cos_sin)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    return _logits(params, x[:, -1:, :], cfg), cache


def decode_step(params: LM, cache, token, cfg: ModelConfig):
    """token (B,1) int32 -> (logits (B,1,V), cache). pos = cache['pos'];
    the k/v buffers take the new rows in place, and the returned cache's
    ``pos`` is ``pos + 1``."""
    require_dense(cfg)
    token = as_tokens(token, params.device)
    pos = cache["pos"]
    x = _embed(params, token, cfg)
    cos_sin = _cos_sin(cfg, pos[:, None])
    for i, (lp, flag) in enumerate(zip(params.layers, _layer_flags(cfg))):
        x, _ = _block_decode(x, lp, {"k": cache["k"][i], "v": cache["v"][i]},
                             flag, pos, cfg, cos_sin=cos_sin)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return _logits(params, x, cfg), new_cache
