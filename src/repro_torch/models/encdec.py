"""Encoder-decoder backbone, whisper-large-v3 (port of
``repro.models.encdec``).

The audio conv frontend is a stub, as in the reference: the model takes
precomputed frame embeddings (B, enc_seq, d_model). Positions are
sinusoidal in both stacks: the encoder adds the ``sinusoidal_embed``
table, the decoder ``sinusoidal_at`` its token positions; self-attention
has no rotary embedding.

Encoder layers: pre-norm bidirectional self-attention + GELU MLP. Decoder
layers: pre-norm causal self-attention + cross-attention over the encoder's
states (no biases, every frame visible) + GELU MLP. The head is
``embed.T``, in f32.

``EncDec``'s state_dict keys are the JAX param paths with the stacks
unstacked: ``enc_layers.{i}.attn.wq`` is
``params["enc_layers"]["attn"]["wq"][i]`` there.

Where autograd records, ``remat="full"`` checkpoints each encoder and
decoder layer, as the reference does (it has no other scheme for this
family).

The decode cache: ``pos`` (B,) int32, ``k``/``v`` (L, B, S_max, KV, hd)
and the cross-attention's ``xk``/``xv`` (L, B, enc_seq, KV, hd), in the
compute dtype.

Under a mesh, as ``lm``: the parameters are placed as they are drawn, each
layer reads its weights through a ``LocalView`` made inside its
rematerialised region, and the ``constrain`` calls stand at the
reference's sites.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.sharding import runtime as _sr
from repro_torch.sharding.api import active_mesh, constrain, constrain_seq

from . import layers as L
from .config import ModelConfig
from .lm import as_embeds, as_tokens, remat


class EncBlock(nn.Module):
    """``ln1``, ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, gen=None, *, device=None):
        super().__init__()
        self.ln1 = L.init_norm(cfg, device=device)
        self.attn = L.init_attention(cfg, gen, device=device)
        self.ln2 = L.init_norm(cfg, device=device)
        self.mlp = L.init_mlp(cfg, gen, device=device)


class DecBlock(nn.Module):
    """``ln1``, ``attn``, ``ln2``, ``xattn`` (cross, no biases), ``ln3``,
    ``mlp``."""

    def __init__(self, cfg: ModelConfig, gen=None, *, device=None):
        super().__init__()
        self.ln1 = L.init_norm(cfg, device=device)
        self.attn = L.init_attention(cfg, gen, device=device)
        self.ln2 = L.init_norm(cfg, device=device)
        self.xattn = L.init_attention(cfg, gen, cross=True, device=device)
        self.ln3 = L.init_norm(cfg, device=device)
        self.mlp = L.init_mlp(cfg, gen, device=device)


class EncDec(nn.Module):
    """``enc_layers``, ``enc_norm``, ``embed (V, D)``, ``dec_layers``,
    ``dec_norm``: drawn from ``gen`` or left uninitialised on ``device``
    for weights carried in."""

    def __init__(self, cfg: ModelConfig, gen=None, *, device=None):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name}: EncDec runs the encdec family, "
                             f"not {cfg.family!r}")
        self.cfg = cfg
        if gen is not None:
            device = gen.device
        self.enc_layers = nn.ModuleList(EncBlock(cfg, gen, device=device)
                                        for _ in range(cfg.enc_layers))
        self.enc_norm = L.init_norm(cfg, device=device)
        self.embed = L._param(L._dense_init(
            gen, (cfg.vocab_size, cfg.d_model), 1.0, L.pdt(cfg), device))
        self.dec_layers = nn.ModuleList(DecBlock(cfg, gen, device=device)
                                        for _ in range(cfg.num_layers))
        self.dec_norm = L.init_norm(cfg, device=device)

    @property
    def device(self) -> torch.device:
        return self.embed.device


@torch.no_grad()
def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> EncDec:
    """As ``lm.init_params``: weights from ``torch.Generator(device)``
    seeded ``seed``; ``device=None`` is the card."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    mesh = active_mesh()
    if mesh is None:
        return EncDec(cfg, gen)
    with _sr.placing(lambda: EncDec(cfg, device="meta"), mesh):
        return EncDec(cfg, gen)


def _remat(body, cfg: ModelConfig):
    """A layer checkpointed under ``remat="full"``, the one scheme the
    reference has for this family."""
    return remat(body, "full" if cfg.remat == "full" else "none")


def encode(params: EncDec, frames, cfg: ModelConfig):
    """frames (B, Se, D) precomputed embeddings -> encoder states."""
    frames = as_embeds(frames, params.device)
    B, Se, D = frames.shape
    x = frames.to(L.dt(cfg)) + L.sinusoidal_embed(Se, D, frames.device).to(L.dt(cfg))
    x = constrain(x, "dp", None, None)

    def body(x, lp):
        lp = _sr.local_view(lp)
        x = constrain_seq(x)
        h = L.apply_norm(lp.ln1, x, cfg)
        a, _ = L.attention_block(lp.attn, h, cfg, positions=None, bidir=True)
        x = constrain_seq(x + a)
        return constrain_seq(x + L.apply_mlp(lp.mlp, L.apply_norm(lp.ln2, x, cfg),
                                             cfg))
    body = _remat(body, cfg)
    for lp in params.enc_layers:
        x = body(x, lp)
    return L.apply_norm(_sr.local_view(params).enc_norm, x, cfg)


def _dec_embed(params: EncDec, tokens, cfg: ModelConfig, pos0):
    """Token embeddings + sinusoidal positions starting at ``pos0`` (B,)."""
    S = tokens.shape[1]
    x = F.embedding(tokens, _sr.local_view(params).embed).to(L.dt(cfg))
    posmat = pos0[:, None] + torch.arange(S, device=tokens.device)[None, :]
    return constrain(x + L.sinusoidal_at(posmat, cfg.d_model).to(L.dt(cfg)),
                     "dp", None, None)


def _head(params: EncDec, x, cfg: ModelConfig):
    top = _sr.local_view(params)
    return L.matmul(L.apply_norm(top.dec_norm, x, cfg), top.embed.T)


def _dec_layer(x, lp: DecBlock, enc_out, cfg: ModelConfig):
    """One decoder layer over the whole sequence. Returns (x', its self
    k/v, its cross k/v)."""
    lp = _sr.local_view(lp)
    h = L.apply_norm(lp.ln1, x, cfg)
    a, kv = L.attention_block(lp.attn, h, cfg, positions=None)
    x = constrain_seq(x + a)
    xkv = L.encode_kv(lp.xattn, enc_out, cfg)
    x = constrain_seq(x + L.cross_attention_block(
        lp.xattn, L.apply_norm(lp.ln2, x, cfg), xkv, cfg))
    return (constrain_seq(x + L.apply_mlp(lp.mlp, L.apply_norm(lp.ln3, x, cfg), cfg)),
            kv, xkv)


def _dec_inputs(params: EncDec, frames, tokens, cfg: ModelConfig):
    """The encoder's states and the decoder's embedded tokens from
    position 0."""
    enc_out = encode(params, frames, cfg)
    B = tokens.shape[0]
    return enc_out, _dec_embed(params, tokens, cfg, torch.zeros(
        (B,), dtype=torch.int32, device=tokens.device))


def forward(params: EncDec, frames, tokens, cfg: ModelConfig, *,
            return_hidden: bool = False):
    """Teacher-forced forward. Returns (logits (B,S,V) f32 | hidden, {})."""
    tokens = as_tokens(tokens, params.device)
    enc_out, x = _dec_inputs(params, frames, tokens, cfg)
    body = _remat(lambda x, lp: _dec_layer(x, lp, enc_out, cfg)[0], cfg)
    for lp in params.dec_layers:
        x = body(x, lp)
    if return_hidden:
        return constrain(L.apply_norm(_sr.local_view(params).dec_norm, x, cfg),
                         "dp", None, None), {}
    return _head(params, x, cfg), {}


def init_cache(cfg: ModelConfig, B: int, S_max: int, *,
               device=None) -> Dict[str, Any]:
    dev = resolve_device(device)
    KV, hd, Ld = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_layers

    def zeros(S):
        return torch.zeros((Ld, B, S, KV, hd), dtype=L.dt(cfg), device=dev)
    return {"pos": torch.zeros((B,), dtype=torch.int32, device=dev),
            "k": zeros(S_max), "v": zeros(S_max),
            "xk": zeros(cfg.enc_seq), "xv": zeros(cfg.enc_seq)}


def prefill(params: EncDec, frames, tokens, cfg: ModelConfig, S_max: int):
    """Encode and run the prompt through the decoder, building the cache.
    Returns (last_logits (B,1,V), cache)."""
    tokens = as_tokens(tokens, params.device)
    B, S = tokens.shape
    cache = init_cache(cfg, B, S_max, device=tokens.device)
    cache["pos"].fill_(S)
    enc_out, x = _dec_inputs(params, frames, tokens, cfg)
    for i, lp in enumerate(params.dec_layers):
        x, (k, v), (xk, xv) = _dec_layer(x, lp, enc_out, cfg)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
        cache["xk"][i] = xk
        cache["xv"][i] = xv
    return _head(params, x[:, -1:], cfg), cache


def decode_step(params: EncDec, cache, token, cfg: ModelConfig):
    """One decoder token against the (self, cross) caches; the self-attention
    rows are written in place. Returns (logits (B,1,V), cache with
    ``pos + 1``)."""
    token = as_tokens(token, params.device)
    pos = cache["pos"]
    x = _dec_embed(params, token, cfg, pos)
    for i, lp in enumerate(params.dec_layers):
        lp = _sr.local_view(lp)
        h = L.apply_norm(lp.ln1, x, cfg)
        a, _, _ = L.attention_decode(lp.attn, h, cache["k"][i], cache["v"][i],
                                     pos, cfg)
        x = constrain_seq(x + a)
        x = constrain_seq(x + L.cross_attention_block(
            lp.xattn, L.apply_norm(lp.ln2, x, cfg),
            (cache["xk"][i], cache["xv"][i]), cfg))
        x = constrain_seq(x + L.apply_mlp(lp.mlp, L.apply_norm(lp.ln3, x, cfg), cfg))
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return _head(params, x, cfg), new_cache
