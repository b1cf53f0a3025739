"""Decoder-only LM covering the dense / MoE / SSM / hybrid / VLM families
(port of ``repro.models.lm``).

``LM`` holds the parameters under the JAX package's paths: the state_dict
key ``layers.{i}.attn.wq`` is ``params["layers"]["attn"]["wq"][i]`` there
(the reference stacks its layers on a leading L axis and scans them; here
they are a ``ModuleList``, applied in a Python loop). A layer's modules
follow the family: ``ssm`` alone (ssm); attention and an SSM side by side
with their branch norms ``bnorm_a``/``bnorm_s`` (hybrid); attention and
``moe`` (moe); attention and ``mlp`` (dense, vlm). The vlm family adds
``patch_proj``, which projects precomputed patch embeddings onto the
first positions.

Entry points
  init_params(cfg, seed=, device=)          -> LM
  forward(params, tokens, cfg, ...)         -> (logits, aux)
  prefill(params, tokens, cfg, S_max)       -> (last_logits, cache)
  decode_step(params, cache, token, cfg)    -> (logits, cache)

The decode cache is a dict: ``pos`` (B,) int32; ``k``/``v`` (L, B, S_max,
KV, hd) in the compute dtype where the family has attention; ``state`` (L,
B, nh, N, P) f32 and ``conv`` (L, B, K-1, din + 2N) in the compute dtype
where it has an SSM. ``decode_step`` writes the new rows and states into
the cache's buffers in place and returns the cache with ``pos + 1``.
``prefill`` takes the SSM states from the same pass over the layers (the
reference runs the blocks a second time for them; the states are the
same). Where autograd records (training), ``forward`` rematerialises the
layers as the config says (``run_layers``: ``remat`` and
``remat_block``, the reference's ``_run_layers``); serving records
nothing and checkpoints nothing.

Under an installed mesh (``repro_torch.sharding``) the entry points take
this process's data-parallel rows (``models.api`` slices the batch),
``init_params`` places each parameter as it is drawn, and each block
reads its layer through a ``LocalView`` made inside the block's
rematerialised region, so a layer's weights are gathered where it runs
and again in its backward. The ``constrain``/``constrain_seq`` calls
stand at the reference's sites.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.device import resolve_device, upload
from repro_torch.sharding import runtime as _sr
from repro_torch.sharding.api import active_mesh, constrain, constrain_seq

from . import layers as L
from .config import ModelConfig

ATTN_FAMILIES = ("dense", "moe", "vlm", "hybrid")
SSM_FAMILIES = ("ssm", "hybrid")


def require_decoder(cfg: ModelConfig) -> None:
    """Raise for the encoder-decoder family, which ``models.encdec`` runs."""
    if cfg.family == "encdec":
        raise ValueError(f"{cfg.name}: the encdec family runs through "
                         "repro_torch.models.encdec (or models.api), not lm")


# ---------------------------------------------------------------------------
# Modules and init
# ---------------------------------------------------------------------------

def _ones(d: int, device) -> nn.Parameter:
    return L._param(torch.ones((d,), dtype=torch.float32, device=device))


class Block(nn.Module):
    """One layer of the family: ``ln1`` and ``ssm`` (ssm); ``ln1``,
    ``attn``, ``ssm``, ``bnorm_a``, ``bnorm_s``, ``ln2``, ``mlp``
    (hybrid); ``ln1``, ``attn``, ``ln2`` and ``moe`` (moe) or ``mlp``."""

    def __init__(self, cfg: ModelConfig, gen=None, *, device=None):
        super().__init__()
        fam = cfg.family
        if gen is not None:
            device = gen.device
        self.ln1 = L.init_norm(cfg, device=device)
        if fam == "ssm":
            self.ssm = L.init_ssm(cfg, gen, device=device)
            return
        self.attn = L.init_attention(cfg, gen, device=device)
        if fam == "hybrid":
            self.ssm = L.init_ssm(cfg, gen, device=device)
            self.bnorm_a = _ones(cfg.d_model, device)
            self.bnorm_s = _ones(cfg.d_model, device)
        self.ln2 = L.init_norm(cfg, device=device)
        if fam == "moe":
            self.moe = L.init_moe(cfg, gen, device=device)
        else:
            self.mlp = L.init_mlp(cfg, gen, device=device)


class LM(nn.Module):
    """``embed (V, D)``, ``layers``, ``final_norm``, ``lm_head (D, V)``
    where untied, and ``patch_proj (D, D)`` where the config has a vision
    frontend. Drawn from ``gen`` (a ``torch.Generator`` on the target
    device) in that order, or left uninitialised on ``device`` for weights
    carried in (``interop.params_from_jax``)."""

    def __init__(self, cfg: ModelConfig, gen=None, *, device=None):
        super().__init__()
        require_decoder(cfg)
        self.cfg = cfg
        if gen is not None:
            device = gen.device
        V, D = cfg.vocab_size, cfg.d_model
        self.embed = L._param(L._dense_init(gen, (V, D), 1.0, L.pdt(cfg), device))
        self.layers = nn.ModuleList(Block(cfg, gen, device=device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = L.init_norm(cfg, device=device)
        self.lm_head = self.patch_proj = None
        if not cfg.tie_embeddings:
            self.lm_head = L._param(L._dense_init(gen, (D, V), 1.0, L.pdt(cfg),
                                                  device))
        if cfg.frontend == "vision_stub":
            self.patch_proj = L._param(L._dense_init(gen, (D, D), 1.0,
                                                     L.pdt(cfg), device))

    @property
    def device(self) -> torch.device:
        return self.embed.device


@torch.no_grad()
def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> LM:
    """The model with weights drawn from ``torch.Generator(device)`` seeded
    ``seed``: N(0, 1) in f32 times ``1 / sqrt(fan_in)``, cast to the param
    dtype (the router stays f32); norm scales 1, biases 0, the SSM's
    ``A_log`` and ``dt_bias`` 0 and ``D`` 1. ``device=None`` is the card
    (raises without one). Not bitwise the JAX package's init: carry its
    weights with ``interop.params_from_jax`` for that. Under a mesh, each
    parameter is drawn whole, in the same order, and placed at once: each
    process keeps its shard of the same weights."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    mesh = active_mesh()
    if mesh is None:
        return LM(cfg, gen)
    with _sr.placing(lambda: LM(cfg, device="meta"), mesh):
        return LM(cfg, gen)


def _layer_flags(cfg: ModelConfig) -> list:
    """(L,) bool — True where the layer uses *global* attention."""
    if cfg.window and cfg.global_every:
        return [i % cfg.global_every == 0 for i in range(cfg.num_layers)]
    return [not cfg.window] * cfg.num_layers


def _window(cfg: ModelConfig, is_global: bool) -> int:
    """The attention window of a layer: hybrid's is 0 on its global layers
    and ``cfg.window`` on the others."""
    if cfg.family == "hybrid":
        return 0 if is_global else cfg.window
    return cfg.window if not cfg.global_every else 0


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _residual(x, rs: float, out):
    return x + out if rs == 1.0 else x + rs * out


def _branch_norm(out, scale, cfg: ModelConfig):
    """Hybrid's per-branch RMS norm, in f32."""
    return out * torch.rsqrt(out.to(torch.float32).square().mean(-1, keepdim=True)
                             + cfg.norm_eps) * scale


def _mix(x, lp: Block, attn_out, ssm_out, cfg: ModelConfig):
    """Hybrid: the mean of the two normed branches, in ``x``'s dtype."""
    na = _branch_norm(attn_out, lp.bnorm_a, cfg)
    ns = _branch_norm(ssm_out, lp.bnorm_s, cfg)
    return _residual(x, cfg.residual_scale, (0.5 * (na + ns)).to(x.dtype))


def _ffn(x, lp: Block, cfg: ModelConfig, extra: dict):
    """The second half of a block: ``ln2``, then the MLP or the MoE (its
    aux loss into ``extra``)."""
    h2 = L.apply_norm(lp.ln2, x, cfg)
    if cfg.family == "moe":
        out, extra["aux"] = L.apply_moe(lp.moe, h2, cfg)
    else:
        out = L.apply_mlp(lp.mlp, h2, cfg)
    return _residual(x, cfg.residual_scale, out)


def _block_fwd(x, lp: Block, is_global, cfg: ModelConfig, positions,
               cos_sin=None):
    """One block over the full sequence. Returns (x', extra): the layer's
    ``k``/``v``, its SSM ``state``/``conv`` caches and the MoE ``aux``, as
    the family has them."""
    fam = cfg.family
    lp = _sr.local_view(lp)
    x = constrain_seq(x)
    h = L.apply_norm(lp.ln1, x, cfg)
    extra: Dict[str, Any] = {}
    if fam == "ssm":
        out, extra["state"], extra["conv"] = L.ssm_block(lp.ssm, h, cfg)
        return constrain_seq(_residual(x, cfg.residual_scale, out)), extra
    attn_out, (extra["k"], extra["v"]) = L.attention_block(
        lp.attn, h, cfg, positions=positions, window=_window(cfg, is_global),
        cos_sin=cos_sin)
    if fam == "hybrid":
        ssm_out, extra["state"], extra["conv"] = L.ssm_block(lp.ssm, h, cfg)
        x = constrain_seq(_mix(x, lp, attn_out, ssm_out, cfg))
    else:
        x = constrain_seq(_residual(x, cfg.residual_scale, attn_out))
    return constrain_seq(_ffn(x, lp, cfg, extra)), extra


def _block_decode(x, lp: Block, cache_l, is_global, pos, cfg: ModelConfig,
                  cos_sin=None):
    """One block, single-token decode. ``cache_l``: the layer's cache views
    (``k``/``v`` written in place); returns (x', the SSM's new ``state``
    and ``conv``, for the caller to write)."""
    fam = cfg.family
    lp = _sr.local_view(lp)
    h = L.apply_norm(lp.ln1, x, cfg)
    new: Dict[str, Any] = {}
    if fam in SSM_FAMILIES:
        ssm_out, new["state"], new["conv"] = L.ssm_block(
            lp.ssm, h, cfg, state=cache_l["state"], conv_cache=cache_l["conv"])
        if fam == "ssm":
            return _residual(x, cfg.residual_scale, ssm_out), new
    attn_out, _, _ = L.attention_decode(
        lp.attn, h, cache_l["k"], cache_l["v"], pos, cfg,
        window=_window(cfg, is_global), cos_sin=cos_sin)
    if fam == "hybrid":
        x = _mix(x, lp, attn_out, ssm_out, cfg)
    else:
        x = _residual(x, cfg.residual_scale, attn_out)
    return _ffn(x, lp, cfg, {}), new


# ---------------------------------------------------------------------------
# Rematerialisation
# ---------------------------------------------------------------------------

# ``dots_with_no_batch_dims_saveable``: the products without batch
# dimensions (the weight products, ``torch.mm``) are saved, everything
# else (the attention's, the experts' and the SSD's batched products
# included) is recomputed
_DOTS = functools.partial(create_selective_checkpoint_contexts,
                          [torch.ops.aten.mm.default, torch.ops.aten.mm.dtype])


def remat(fn, policy: str):
    """``fn`` checkpointed as ``policy`` says (``full``: nothing saved
    inside; ``dots``: the weight products saved; else ``fn`` itself), where
    autograd records: in inference or under ``no_grad`` there is nothing to
    save, so ``fn`` runs as it is."""
    if not torch.is_grad_enabled() or policy not in ("full", "dots"):
        return fn
    context = {"context_fn": _DOTS} if policy == "dots" else {}
    return functools.partial(checkpoint, fn, use_reentrant=False, **context)


def run_layers(body, x, layers, cfg: ModelConfig):
    """Apply ``body(x, *layer) -> (x, aux)`` over ``layers`` with the
    configured remat scheme (the reference's ``_run_layers``).

    ``remat_block = k > 1`` (with at least 2k layers) checkpoints blocks of
    k layers, each layer inside checkpointed again: only the block
    boundaries are saved, and a block's recompute keeps only each layer's
    input. The L mod k remaining layers, and every layer otherwise, are
    checkpointed one by one as ``cfg.remat`` says. Returns (x, aux summed
    as the reference sums it: within each block, then over the blocks and
    the rest), or (x, None) where ``body`` returns no aux."""
    k, Lh = cfg.remat_block, len(layers)
    sums = []
    if k > 1 and Lh >= 2 * k:
        nb = Lh // k
        inner = remat(body, "full")

        def run_block(x, blk):
            auxs = []
            for layer in blk:
                x, aux = inner(x, *layer)
                auxs.append(aux)
            return x, _total(auxs)

        for b in range(nb):
            x, aux = remat(run_block, "full")(x, layers[b * k:(b + 1) * k])
            sums.append(aux)
        layers = layers[nb * k:]
    if layers:
        step, auxs = remat(body, cfg.remat), []
        for layer in layers:
            x, aux = step(x, *layer)
            auxs.append(aux)
        sums.append(_total(auxs))
    return x, _total(sums)


def _total(auxs):
    return None if not auxs or auxs[0] is None else torch.stack(auxs).sum()


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


def as_embeds(a, device) -> torch.Tensor:
    """Precomputed embeddings (a numpy array or a tensor) as a tensor on
    ``device``, queued without a wait."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return upload(np.asarray(a), torch.device(device))


def _embed(params: LM, tokens, cfg: ModelConfig, patch_embeds=None):
    """Token embeddings; with ``patch_embeds`` (B, P, D) their projection
    through ``patch_proj`` takes the first P positions."""
    x = F.embedding(tokens, params.embed).to(L.dt(cfg))
    if patch_embeds is not None:
        pe = L.matmul(as_embeds(patch_embeds, x.device).to(L.dt(cfg)),
                      params.patch_proj).to(L.dt(cfg))
        x = torch.cat([pe, x[:, pe.shape[1]:]], 1)
    return constrain(x, "dp", None, None)


def head_weights(params: LM, cfg: ModelConfig):
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def apply_head(w, x, cfg: ModelConfig):
    """hidden (B,S,D) x head (D,V) -> f32 logits, with arch scaling."""
    logits = L.matmul(x, w)
    if cfg.logit_scale != 1.0:
        logits = logits * cfg.logit_scale
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return constrain(logits, "dp", None, "tp")


def _logits(params: LM, x, cfg: ModelConfig):
    x = L.apply_norm(params.final_norm, x, cfg)
    return apply_head(head_weights(params, cfg), x, cfg)


def default_positions(cfg: ModelConfig, B: int, S: int, device=None):
    """arange(S) for each row: (B, S), or (3, B, S) for M-RoPE (all three
    components equal)."""
    pos = torch.arange(S, device=device)[None, :].expand(B, S)
    return pos[None].expand(3, B, S) if cfg.rope_type == "mrope" else pos


def _inputs(params: LM, tokens, cfg: ModelConfig, positions, patch_embeds):
    """The embedded tokens, the positions (default ones where None) and
    their rotary cos/sin."""
    B, S = tokens.shape
    x = _embed(params, tokens, cfg, patch_embeds)
    if positions is None:
        positions = default_positions(cfg, B, S, tokens.device)
    return x, positions, L.rope_for(cfg, positions)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def forward(params: LM, tokens, cfg: ModelConfig, *, positions=None,
            patch_embeds=None, return_hidden: bool = False):
    """tokens (B,S) -> (logits (B,S,V) f32, aux dict).

    ``positions`` default to arange ((3,B,S) for M-RoPE); ``patch_embeds``
    (B,P,D) take the first P positions (vlm). ``aux["moe_aux"]`` is the
    MoE load-balancing loss summed over the layers (an f32 scalar tensor),
    0.0 for other families. ``return_hidden=True`` yields the final-norm'd
    hidden states (B,S,D) in the compute dtype instead of logits. Where
    autograd records, the layers are rematerialised as the config says
    (``run_layers``)."""
    tokens = as_tokens(tokens, params.device)
    top = _sr.local_view(params)
    x, positions, cos_sin = _inputs(top, tokens, cfg, positions, patch_embeds)

    def body(x, lp, flag):
        x, extra = _block_fwd(x, lp, flag, cfg, positions, cos_sin)
        return x, extra.get("aux")
    x, moe_aux = run_layers(body, x, list(zip(params.layers, _layer_flags(cfg))),
                            cfg)
    aux = {"moe_aux": moe_aux if cfg.family == "moe" else 0.0}
    if return_hidden:
        return constrain(L.apply_norm(top.final_norm, x, cfg), "dp", None, None), aux
    return _logits(top, x, cfg), aux


# ---------------------------------------------------------------------------
# KV / state cache, prefill, decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, B: int, S_max: int, dtype=None, *,
               device=None) -> Dict[str, Any]:
    require_decoder(cfg)
    dev = resolve_device(device)
    dtype = dtype or L.dt(cfg)
    Lh = cfg.num_layers
    c: Dict[str, Any] = {"pos": torch.zeros((B,), dtype=torch.int32, device=dev)}
    if cfg.family in ATTN_FAMILIES:
        shape = (Lh, B, S_max, cfg.num_kv_heads, cfg.resolved_head_dim)
        c["k"] = torch.zeros(shape, dtype=dtype, device=dev)
        c["v"] = torch.zeros(shape, dtype=dtype, device=dev)
    if cfg.family in SSM_FAMILIES:
        c["state"] = torch.zeros((Lh, B, cfg.ssm_heads, cfg.ssm_state,
                                  cfg.ssm_head_dim), dtype=torch.float32,
                                 device=dev)
        c["conv"] = torch.zeros((Lh, B, cfg.ssm_conv - 1,
                                 cfg.d_inner + 2 * cfg.ssm_state),
                                dtype=dtype, device=dev)
    return c


def prefill(params: LM, tokens, cfg: ModelConfig, S_max: int, *,
            positions=None, patch_embeds=None):
    """Run the full prompt, build the decode cache (the attention rows and
    the SSM states of the same pass). Returns (last_logits (B,1,V),
    cache)."""
    tokens = as_tokens(tokens, params.device)
    B, S = tokens.shape
    cache = init_cache(cfg, B, S_max, device=tokens.device)
    cache["pos"].fill_(S)
    top = _sr.local_view(params)
    x, positions, cos_sin = _inputs(top, tokens, cfg, positions, patch_embeds)
    for i, (lp, flag) in enumerate(zip(params.layers, _layer_flags(cfg))):
        x, extra = _block_fwd(x, lp, flag, cfg, positions, cos_sin)
        for name in ("k", "v"):
            if name in extra:
                cache[name][i, :, :S] = extra[name]
        for name in ("state", "conv"):
            if name in extra:
                cache[name][i] = extra[name]
    return _logits(top, x[:, -1:, :], cfg), cache


def decode_step(params: LM, cache, token, cfg: ModelConfig):
    """token (B,1) int32 -> (logits (B,1,V), cache). pos = cache['pos'];
    the buffers take the new rows and states in place, and the returned
    cache's ``pos`` is ``pos + 1``. M-RoPE text tokens take the rotary
    position ``pos - (num_patches - 1)``: the patch grid occupies one
    temporal step."""
    token = as_tokens(token, params.device)
    pos = cache["pos"]
    top = _sr.local_view(params)
    x = _embed(top, token, cfg)
    rope_pos = pos - (cfg.num_patches - 1) \
        if cfg.rope_type == "mrope" and cfg.num_patches else pos
    cos_sin = L.decode_rope(cfg, rope_pos)
    for i, (lp, flag) in enumerate(zip(params.layers, _layer_flags(cfg))):
        x, new = _block_decode(
            x, lp, {name: buf[i] for name, buf in cache.items() if name != "pos"},
            flag, pos, cfg, cos_sin=cos_sin)
        for name, value in new.items():
            cache[name][i] = value
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return _logits(top, x, cfg), new_cache
