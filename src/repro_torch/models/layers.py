"""Building-block layers for every architecture family (port of
``repro.models.layers``).

The parameters live in ``nn.Module``s (``Norm``, ``Attention``, ``MLP``,
``MoE``, ``SSM``) under the JAX package's names (``scale``, ``wq``, ``bq``,
``w_gate``, ``router``, ``A_log``, ...),
and the ``apply``-style functions take such a module where the JAX
functions take a param dict. Weights keep JAX's ``(in, out)`` orientation,
so every product is ``x @ w`` and nothing is transposed on the way across.

Numerics follow the reference op by op:
  * ``matmul`` accumulates in f32 and returns f32; ``matmul_c`` and
    ``matmul_rp`` return the compute dtype when ``cfg.tp_reduce_bf16`` (f32
    accumulation, one rounding), else f32. Low-precision operands into an
    f32 output are upcast (each bf16 product is exact in f32), or, on the
    card, go to one cuBLAS product with an f32 output. A bf16 product into
    bf16 accumulates in f32 within cuBLAS; with
    ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    off, its split-K sums do too. The card's product into f32 has no
    autograd formula of its own (``torch.mm(..., out_dtype=f32)`` raises
    in backward): ``_MatmulF32`` gives it one, as the CPU path's upcast
    product has.
  * a bias add promotes to f32 (bf16 + f32), as jnp does; a residual
    ``x + rs * out`` stays in the activation's dtype.
  * norms, RoPE, attention scores and softmax run in f32; masked scores
    take ``finfo(f32).min``; the softmax weights are cast to the compute
    dtype before the PV product, which accumulates in f32.
  * attention, the MoE dispatch and the SSD scan are plain torch ops, as
    the reference's are plain jnp outside any Pallas kernel. A fused
    attention kernel would round otherwise.
  * the MoE combines each token's K expert outputs by a gather and a sum
    over K, never a scatter-add: CUDA's float atomics would make the sums,
    and so the served tokens, vary between runs.
  * ``jax.nn.softplus`` is ``logaddexp(x, 0)`` with no threshold; the SSM
    computes that formula (``F.softplus`` returns ``x`` past 20: ~2e-9
    apart there, below f32's rounding of x).

Sharding (``repro_torch.sharding``): the ``constrain`` calls stand at the
reference's sites and pass local tensors through (a no-op without a mesh,
adding no kernel). Under a mesh the layer functions take ``LocalView``s of
their modules, whose parameters are gathered on use, and ``apply_moe``
takes the reference's expert-parallel branch: each process computes its
tp shard's experts on its data-parallel rows (``_moe_math``'s ``e_start``,
``E_loc``) and the partial outputs are summed over tp.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import upload
from repro_torch.sharding import runtime as _sr
from repro_torch.sharding.api import TP_AXIS, active_mesh, constrain

from .config import ModelConfig

F32 = torch.float32
NEG = torch.finfo(torch.float32).min
ATTN_CHUNK = 512  # q-block size of the chunked attend

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dt(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.compute_dtype]


def pdt(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def _dense_init(gen: torch.Generator | None, shape, scale: float, dtype,
                device=None) -> torch.Tensor:
    """A weight of ``shape``: N(0, 1) drawn in f32 from ``gen`` times
    ``scale / sqrt(fan_in)``, then cast to ``dtype``; uninitialised on
    ``device`` where ``gen`` is None (the weights are carried in)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = scale / math.sqrt(fan_in)
    # scaled in place: one f32 buffer of the shape (kimi-k2's expert stacks
    # are 22.5 GB in f32), the same values as ``randn(...) * std``
    return torch.randn(shape, generator=gen, dtype=F32, device=device
                       ).mul_(std).to(dtype)


# set by ``sharding.runtime.placing``: places each parameter as it is made
_PLACE = None


def _param(t: torch.Tensor) -> nn.Parameter:
    # off while serving; the trainer switches it on (train.step)
    p = nn.Parameter(t, requires_grad=False)
    return p if _PLACE is None else _PLACE(p)


class _MatmulF32(torch.autograd.Function):
    """The card's low-precision product into f32: ``torch.mm`` (``x``
    flattened to rows) or ``torch.bmm`` with ``out_dtype=f32``, whose
    overload has no autograd formula. Backward: the f32 cotangent against
    the other operand upcast, f32 products, each gradient rounded once to
    its input's dtype, as JAX transposes ``dot_general(...,
    preferred_element_type=f32)`` and as autograd differentiates the CPU
    path's upcast product."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if w.dim() == 3:
            return torch.bmm(x, w, out_dtype=F32)
        out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=F32)
        return out.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.matmul(g, w.to(F32).mT).to(x.dtype)
        if ctx.needs_input_grad[1]:
            if w.dim() == 3:
                gw = torch.bmm(x.to(F32).mT, g)
            else:
                gw = x.reshape(-1, x.shape[-1]).to(F32).T @ g.reshape(-1, g.shape[-1])
            gw = gw.to(w.dtype)
        return gx, gw


def _mm(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype):
    """``x @ w`` with f32 accumulation and an ``out_dtype`` result; ``w``
    (in, out), or (E, in, out) against ``x`` (E, rows, in): one product an
    expert."""
    if x.dtype == w.dtype == out_dtype:
        return x @ w
    if (x.is_cuda and x.dtype == w.dtype and out_dtype == F32
            and x.dtype in (torch.bfloat16, torch.float16)):
        return _MatmulF32.apply(x, w)
    return (x.to(F32) @ w.to(F32)).to(out_dtype)


def matmul(x, w):
    """Product with f32 accumulation and an f32 result."""
    return _mm(x, w, F32)


def _tp_dtype(cfg: ModelConfig) -> torch.dtype:
    return dt(cfg) if cfg.tp_reduce_bf16 else F32


def matmul_c(x, w, cfg: ModelConfig):
    """Column-parallel product: compute-dtype result when
    ``cfg.tp_reduce_bf16`` (one device: no collective, the rounding
    stays)."""
    return _mm(x, w, _tp_dtype(cfg))


def matmul_rp(x, w, cfg: ModelConfig):
    """Row-parallel product: rounded to the compute dtype when
    ``cfg.tp_reduce_bf16``, as the reference rounds its partials."""
    return _mm(x, w, _tp_dtype(cfg))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """rmsnorm (``scale``), layernorm (``scale``, ``bias``) or layernorm_np
    (no parameters: olmo)."""

    def __init__(self, cfg: ModelConfig, d: int | None = None, *, device=None):
        super().__init__()
        d = d or cfg.d_model
        if cfg.norm not in ("rmsnorm", "layernorm", "layernorm_np"):
            raise ValueError(cfg.norm)
        self.scale = self.bias = None
        if cfg.norm != "layernorm_np":
            self.scale = _param(torch.ones((d,), dtype=F32, device=device))
        if cfg.norm == "layernorm":
            self.bias = _param(torch.zeros((d,), dtype=F32, device=device))


def init_norm(cfg: ModelConfig, d: int | None = None, *, device=None) -> Norm:
    return Norm(cfg, d, device=device)


def apply_norm(params: Norm, x, cfg: ModelConfig):
    x32 = x.to(F32)
    if cfg.norm == "rmsnorm":
        x32 = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + cfg.norm_eps)
        return (x32 * params.scale).to(x.dtype)
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    x32 = (x32 - mu) * torch.rsqrt(var + cfg.norm_eps)
    if cfg.norm == "layernorm":
        x32 = x32 * params.scale + params.bias
    return x32.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def _rope_freqs_host(hd: int, theta: float) -> np.ndarray:
    return (np.float32(1.0) / (np.float32(theta) ** (
        np.arange(0, hd, 2, dtype=np.float32) / np.float32(hd))))


@functools.lru_cache(maxsize=None)
def _rope_freqs(hd: int, theta: float, device: torch.device) -> torch.Tensor:
    """``1 / theta ** (arange(0, hd, 2) / hd)`` in f32, computed once on the
    host (so that every device rotates by the same frequencies) and kept
    on ``device``."""
    return upload(_rope_freqs_host(hd, theta), device)


def rope_cos_sin(positions, hd: int, theta: float):
    """positions (..., S) -> cos/sin (..., S, hd/2), f32."""
    ang = positions[..., None].to(F32) * _rope_freqs(hd, theta, positions.device)
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions3, sections, hd: int, theta: float):
    """M-RoPE (qwen2-vl): positions3 (3, B, S); the half-dims split into
    (temporal, height, width) sections of sizes ``sections`` (half-dim
    units, sum hd/2), each rotated by its own position component.
    Returns cos/sin (B, S, hd/2), f32."""
    cos_t, sin_t = rope_cos_sin(positions3, hd, theta)   # (3,B,S,hd/2)
    bounds = np.cumsum((0,) + tuple(sections))

    def pick(t):
        return torch.cat([t[comp, ..., lo:hi] for comp, (lo, hi)
                          in enumerate(zip(bounds[:-1], bounds[1:]))], -1)
    return pick(cos_t), pick(sin_t)


def apply_rope(x, cos, sin):
    """x (B,S,H,hd); cos/sin (B,S,hd/2) — rotate-half convention, in f32."""
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)


def rope_for(cfg: ModelConfig, positions):
    """cos/sin of the config's rotary embedding at ``positions`` ((B,S);
    (3,B,S) for M-RoPE), or None where it has none."""
    if cfg.rope_type == "rope":
        return rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)
    if cfg.rope_type == "mrope":
        return mrope_cos_sin(positions, cfg.mrope_sections,
                             cfg.resolved_head_dim, cfg.rope_theta)
    return None


@functools.lru_cache(maxsize=None)
def _sinusoid_div(d: int, device: torch.device) -> torch.Tensor:
    """``10000 ** (arange(0, d, 2) / d)`` in f32, computed once on the host
    and kept on ``device``."""
    dim = np.arange(0, d, 2, dtype=np.float32)
    return upload(np.power(np.float32(10000.0), dim / np.float32(d)), device)


def sinusoidal_at(positions, d: int):
    """Sinusoidal embeddings (B, S, d), f32, at ``positions (B, S)``: sin
    at the even features, cos at the odd, of ``position / 10000 ** (2i /
    d)``."""
    ang = positions[..., None].to(F32) / _sinusoid_div(d, positions.device)
    return torch.stack([torch.sin(ang), torch.cos(ang)], -1).flatten(-2)


def sinusoidal_embed(S: int, d: int, device=None):
    """The (S, d) table of ``sinusoidal_at`` at positions 0..S-1."""
    return sinusoidal_at(torch.arange(S, device=device)[None], d)[0]


# ---------------------------------------------------------------------------
# Attention (GQA; causal / window / bidirectional / cross; cached decode)
# ---------------------------------------------------------------------------

def _zeros(n: int, device) -> nn.Parameter:
    return _param(torch.zeros((n,), dtype=F32, device=device))


class Attention(nn.Module):
    """``wq (D, H·hd)``, ``wk``/``wv (D, KV·hd)``, ``wo (H·hd, D)`` in the
    param dtype; ``bq``/``bk``/``bv`` f32 where ``cfg.qkv_bias``, except in
    cross-attention (``cross=True``), which has no biases."""

    def __init__(self, cfg: ModelConfig, gen=None, *, cross: bool = False,
                 device=None):
        super().__init__()
        D, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        hd = cfg.resolved_head_dim
        device = gen.device if gen is not None else device

        def w(shape):
            return _param(_dense_init(gen, shape, 1.0, pdt(cfg), device))
        self.wq, self.wk = w((D, H * hd)), w((D, KV * hd))
        self.wv, self.wo = w((D, KV * hd)), w((H * hd, D))
        self.bq = self.bk = self.bv = None
        if cfg.qkv_bias and not cross:
            self.bq, self.bk, self.bv = (_zeros(H * hd, device),
                                         _zeros(KV * hd, device),
                                         _zeros(KV * hd, device))


def init_attention(cfg: ModelConfig, gen=None, *, cross: bool = False,
                   device=None) -> Attention:
    return Attention(cfg, gen, cross=cross, device=device)


def _qkv(params: Attention, x, xkv, cfg: ModelConfig):
    B = x.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = matmul_c(x, params.wq, cfg)
    k = matmul_c(xkv, params.wk, cfg)
    v = matmul_c(xkv, params.wv, cfg)
    if params.bq is not None:      # promotes to f32, as jnp does
        q, k, v = q + params.bq, k + params.bk, v + params.bv
    q = q.reshape(B, x.shape[1], H, hd).to(dt(cfg))
    k = k.reshape(B, xkv.shape[1], KV, hd).to(dt(cfg))
    v = v.reshape(B, xkv.shape[1], KV, hd).to(dt(cfg))
    return q, k, v


def _mask_block(q_pos, k_idx, window: int):
    """Causal visibility mask (B, bq, Sk) from per-token query positions
    ``q_pos (B, bq)`` and key indices ``k_idx (Sk,)``; ``window`` 0 is
    unbounded lookback. (A bidirectional attend masks nothing.)"""
    m = k_idx[None, None, :] <= q_pos[:, :, None]
    if window > 0:
        m &= k_idx[None, None, :] > q_pos[:, :, None] - window
    return m


def _attend_block(qc, k, v, q_pos_c, k_idx, window, bidir, cfg: ModelConfig):
    """One q-chunk of attention. qc (B,bq,KV,G,hd); k/v (B,Sk,KV,hd).
    Returns (B,bq,KV,G,hd) f32."""
    B, bq, KV, G, hd = qc.shape
    Sk = k.shape[1]
    q32 = qc.to(F32).permute(0, 2, 3, 1, 4).reshape(B, KV, G * bq, hd)
    k32 = k.to(F32).permute(0, 2, 3, 1)                       # (B,KV,hd,Sk)
    scores = torch.matmul(q32, k32).view(B, KV, G, bq, Sk) / math.sqrt(hd)
    if cfg.logit_softcap > 0:
        scores = cfg.logit_softcap * torch.tanh(scores / cfg.logit_softcap)
    if not bidir:
        mask = _mask_block(q_pos_c, k_idx, window)             # (B,bq,Sk)
        scores = torch.where(mask[:, None, None, :, :], scores, NEG)
    w = torch.softmax(scores, dim=-1).to(dt(cfg))
    out = torch.matmul(w.to(F32).reshape(B, KV, G * bq, Sk),
                       v.to(F32).permute(0, 2, 1, 3))         # (B,KV,G·bq,hd)
    return out.view(B, KV, G, bq, hd).permute(0, 3, 1, 2, 4)


def attend(q, k, v, cfg: ModelConfig, *, q_pos, window: int = 0,
           bidir: bool = False, chunk: int = ATTN_CHUNK):
    """Attention of q (B,Sq,H,hd) over k/v (B,Sk,KV,hd), GQA by a (KV,
    group) reshape; every key visible where ``bidir``. Past ``chunk``
    queries it goes chunk by chunk: the queries are padded to a chunk
    multiple, the padded rows at ``q_pos`` 0 (they see key 0 alone), and
    sliced away. Returns (B,Sq,H·hd) in the compute dtype."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    q = q.reshape(B, Sq, KV, G, hd)
    k_idx = torch.arange(k.shape[1], dtype=torch.int32, device=q.device)
    if Sq <= chunk:
        out = _attend_block(q, k, v, q_pos, k_idx, window, bidir, cfg)
    else:
        pad = -Sq % chunk
        if pad:
            q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pad))
            q_pos = F.pad(q_pos, (0, pad))
        out = torch.cat([
            _attend_block(q[:, i:i + chunk], k, v, q_pos[:, i:i + chunk],
                          k_idx, window, bidir, cfg)
            for i in range(0, Sq + pad, chunk)], dim=1)[:, :Sq]
    return constrain(out.reshape(B, Sq, H * hd).to(dt(cfg)), "dp", None, "tp")


def attention_block(params: Attention, x, cfg: ModelConfig, *, positions,
                    q_pos=None, window: int = 0, bidir: bool = False,
                    cos_sin=None):
    """Self-attention over the whole sequence (forward and prefill).

    ``positions`` feed the config's rotary embedding ((B,S), or (3,B,S)
    for M-RoPE; ``cos_sin``, their cos/sin, may be passed in computed;
    none for a sinusoidal or absent one); ``q_pos`` the visibility mask
    (default arange). K/V are repeated to the full head count for the
    attend; the cache keeps the compact KV heads. Returns (out, (k, v))."""
    B, S = x.shape[:2]
    q, k, v = _qkv(params, x, x, cfg)
    cs = cos_sin if cos_sin is not None else rope_for(cfg, positions)
    if cs is not None:
        q, k = apply_rope(q, *cs), apply_rope(k, *cs)
    if q_pos is None:
        q_pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    kv_cache = (k, v)
    G = cfg.num_heads // max(cfg.num_kv_heads, 1)
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    k = constrain(k, "dp", None, "tp", None)
    v = constrain(v, "dp", None, "tp", None)
    q = constrain(q, "dp", None, "tp", None)
    out = attend(q, k, v, cfg, q_pos=q_pos, window=window, bidir=bidir)
    return matmul_rp(out, params.wo, cfg).to(dt(cfg)), kv_cache


def _write_at(cache, pos, new):
    """``cache[b, pos[b]] = new[b]`` in place; a position past the cache
    drops its write, as jax's scatter does."""
    B, S = cache.shape[:2]
    bidx = torch.arange(B, device=cache.device)
    at = pos.to(torch.int64).clamp(max=S - 1)
    inside = (pos < S)[:, None, None]
    cache[bidx, at] = torch.where(inside, new, cache[bidx, at])


def decode_rope(cfg: ModelConfig, rope_pos):
    """cos/sin of one decode token at ``rope_pos (B,)``: for M-RoPE all
    three components take ``rope_pos``."""
    if cfg.rope_type == "mrope":
        return rope_for(cfg, rope_pos[None, :, None].expand(3, -1, 1))
    return rope_for(cfg, rope_pos[:, None])


def attention_decode(params: Attention, x, cache_k, cache_v, pos,
                     cfg: ModelConfig, *, window: int = 0, cos_sin=None):
    """One-token decode. x (B,1,D); cache (B,S_max,KV,hd), updated in
    place; pos (B,) int32 indexes the cache slot and the mask, and feeds
    the rotary embedding unless ``cos_sin`` is passed in computed (M-RoPE
    text tokens take a position shifted by the patch grid: ``decode_rope``
    of it). Returns (out (B,1,D), cache_k, cache_v)."""
    q, k, v = _qkv(params, x, x, cfg)
    cs = cos_sin if cos_sin is not None else decode_rope(cfg, pos)
    if cs is not None:
        q, k = apply_rope(q, *cs), apply_rope(k, *cs)
    _write_at(cache_k, pos, k[:, 0])
    _write_at(cache_v, pos, v[:, 0])
    cache_k = constrain(cache_k, "dp", "tp", None, None)
    cache_v = constrain(cache_v, "dp", "tp", None, None)
    out = attend(q, cache_k, cache_v, cfg, q_pos=pos[:, None], window=window)
    return matmul_rp(out, params.wo, cfg).to(dt(cfg)), cache_k, cache_v


def cross_attention_block(params: Attention, x, enc_kv, cfg: ModelConfig):
    """Decoder cross-attention over ``enc_kv = (k, v)``, precomputed from
    the encoder (``encode_kv``): no biases, every key visible."""
    B, Sq = x.shape[:2]
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    q = matmul(x, params.wq).reshape(B, Sq, H, hd).to(dt(cfg))
    k, v = enc_kv
    q_pos = torch.zeros((B, Sq), dtype=torch.int32, device=x.device)
    out = attend(q, k, v, cfg, q_pos=q_pos, bidir=True)
    return matmul_rp(out, params.wo, cfg).to(dt(cfg))


def encode_kv(params: Attention, enc_out, cfg: ModelConfig):
    """Cross-attention k/v (B, Se, KV, hd) of the encoder's states."""
    B, Se = enc_out.shape[:2]
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    k = matmul(enc_out, params.wk).reshape(B, Se, KV, hd).to(dt(cfg))
    v = matmul(enc_out, params.wv).reshape(B, Se, KV, hd).to(dt(cfg))
    return k, v


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU (``w_gate``, ``w_up``, ``w_down``) where ``cfg.act`` is silu,
    else a GELU MLP (``w_up``, ``b_up``, ``w_down``, ``b_down``)."""

    def __init__(self, cfg: ModelConfig, gen=None, *, device=None):
        super().__init__()
        D, Fd = cfg.d_model, cfg.d_ff
        device = gen.device if gen is not None else device

        def w(shape):
            return _param(_dense_init(gen, shape, 1.0, pdt(cfg), device))
        self.w_gate = self.b_up = self.b_down = None
        if cfg.act == "silu":
            self.w_gate = w((D, Fd))
            self.w_up, self.w_down = w((D, Fd)), w((Fd, D))
        else:
            self.w_up, self.b_up = w((D, Fd)), _zeros(Fd, device)
            self.w_down, self.b_down = w((Fd, D)), _zeros(D, device)


def init_mlp(cfg: ModelConfig, gen=None, *, device=None) -> MLP:
    return MLP(cfg, gen, device=device)


def apply_mlp(params: MLP, x, cfg: ModelConfig):
    if cfg.act == "silu":
        h = F.silu(matmul_c(x, params.w_gate, cfg)) * matmul_c(x, params.w_up, cfg)
        h = constrain(h.to(dt(cfg)), "dp", None, "tp")
        return matmul_rp(h, params.w_down, cfg).to(dt(cfg))
    # jax.nn.gelu is the tanh approximation
    h = F.gelu(matmul_c(x, params.w_up, cfg) + params.b_up, approximate="tanh")
    h = constrain(h.to(dt(cfg)), "dp", None, "tp")
    return (matmul_rp(h, params.w_down, cfg) + params.b_down).to(dt(cfg))


# ---------------------------------------------------------------------------
# Mixture of Experts (capacity-based dispatch, GShard-style)
# ---------------------------------------------------------------------------

class MoE(nn.Module):
    """``router (D, E)`` f32; ``w_gate``/``w_up (E, D, F)`` and ``w_down
    (E, F, D)`` in the param dtype."""

    def __init__(self, cfg: ModelConfig, gen=None, *, device=None):
        super().__init__()
        D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
        device = gen.device if gen is not None else device

        def w(shape, dtype):
            return _param(_dense_init(gen, shape, 1.0, dtype, device))
        self.router = w((D, E), F32)
        self.w_gate, self.w_up = w((E, D, Fd), pdt(cfg)), w((E, D, Fd), pdt(cfg))
        self.w_down = w((E, Fd, D), pdt(cfg))


def init_moe(cfg: ModelConfig, gen=None, *, device=None) -> MoE:
    return MoE(cfg, gen, device=device)


def moe_capacity(N: int, cfg: ModelConfig, capacity_factor: float) -> int:
    """Slots an expert: the cf-scaled expected load, and at least
    ``min(64, N·K)``, so that small batches (decode) drop nothing."""
    K = cfg.top_k
    C = max(1, int(math.ceil(N * K / cfg.num_experts * capacity_factor)))
    return max(C, min(64, N * K))


def _moe_route(xf, router, cfg: ModelConfig, capacity_factor: float):
    """The router and the slot assignment of ``_moe_math``.

    Returns (probs (N,E) f32, gate (N,K) renormalised, eidx (N,K), order
    (N·K,): a stable sort of the flat expert ids, slot (N,K): each
    assignment's rank among its expert's in that order, starts (E,) and
    ends (E,): each expert's run in it, C)."""
    N = xf.shape[0]
    E, K = cfg.num_experts, cfg.top_k
    logits = matmul(xf, router.to(dt(cfg)))                   # (N,E) f32
    probs = torch.softmax(logits, -1)
    # jax.lax.top_k: descending, ties to the lower index
    gate, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = gate[:, :K], eidx[:, :K]
    gate = gate / gate.sum(-1, keepdim=True)
    C = moe_capacity(N, cfg, capacity_factor)
    flat_e = eidx.reshape(-1)                                 # (NK,)
    sorted_e, order = torch.sort(flat_e, stable=True)
    experts = torch.arange(E, device=xf.device)
    starts = torch.searchsorted(sorted_e, experts)
    ends = torch.searchsorted(sorted_e, experts, right=True)
    rank = torch.argsort(order)                     # the inverse permutation
    slot = (rank - starts[flat_e]).reshape(N, K)
    return probs, gate, eidx, order, slot, starts, ends, C


def _moe_math(xf, router, wg, wu, wd, cfg: ModelConfig,
              capacity_factor: float, e_start: int = 0, E_loc: int | None = None):
    """Top-k routed experts with a fixed capacity C an expert, on a local
    token shard xf (N, D) in the compute dtype, against the local expert
    range ``[e_start, e_start + E_loc)`` (default: every expert), whose
    weights ``wg``/``wu``/``wd`` hold those E_loc experts.

    An expert's queue takes its assignments in the order of a stable sort
    of the flat (token, k) *global* expert ids (so the capacity matches the
    single-device run); past C they are dropped (they add nothing). Only
    the local experts' queues are gathered (a row of each expert's (C, D)
    block, zero past its count), and each token's K outputs are gathered
    back and summed over K in f32: a fixed order, no scatter-add; an
    assignment to another shard's expert adds zero. Returns (partial out
    (N, D) f32, aux), aux the Switch-style load-balancing loss of these
    tokens."""
    N, D = xf.shape
    E, K = cfg.num_experts, cfg.top_k
    E_loc = E if E_loc is None else E_loc
    probs, gate, eidx, order, slot, starts, ends, C = _moe_route(
        xf, router, cfg, capacity_factor)
    starts, ends = starts[e_start:e_start + E_loc], ends[e_start:e_start + E_loc]
    c = torch.arange(C, device=xf.device)
    src = (starts[:, None] + c).clamp(max=N * K - 1)          # (E_loc, C)
    filled = c < (ends - starts)[:, None]
    xe = torch.where(filled[..., None], xf[order[src] // K],
                     torch.zeros((), dtype=xf.dtype, device=xf.device))
    h = F.silu(_mm(xe, wg, F32)) * _mm(xe, wu, F32)
    ye = _mm(h.to(dt(cfg)), wd, F32).to(dt(cfg))              # (E_loc, C, D)
    keep = slot < C
    if E_loc < E:       # this shard's experts only
        local_e = eidx - e_start
        keep = keep & (local_e >= 0) & (local_e < E_loc)
        at = local_e.clamp(0, E_loc - 1) * C + slot.clamp(max=C - 1)
    else:
        at = eidx * C + slot.clamp(max=C - 1)
    rows = ye.reshape(E_loc * C, D)[at.reshape(-1)]
    contrib = torch.where(keep, gate, 0.0)                    # (N, K)
    out = (rows.reshape(N, K, D) * contrib[..., None]).sum(1)
    me = probs.mean(0)
    # one_hot of the top expert, by comparison (F.one_hot checks its
    # range with a synchronising read on the card)
    ce = (eidx[:, :1] == torch.arange(E, device=xf.device)).to(F32).mean(0)
    aux = E * (me * ce).sum()
    return out, aux


def apply_moe(params: MoE, x, cfg: ModelConfig, *,
              capacity_factor: float = 1.25):
    """Top-k routed MoE with fixed expert capacity (token-dropping).
    Returns (out (B,S,D), aux).

    Under a mesh with a tp axis whose size divides the experts, the
    reference's expert-parallel branch: tokens stay dp-local (``x`` is
    this process's rows, the same on every tp process), each tp process
    computes only its ``E / tp`` experts (their weights gathered over dp),
    the partial outputs are summed over tp, and the aux loss is the mean
    over tp, then over dp, of each shard's local aux. The capacity comes
    from the local token count, so with dp > 1 and drops the result
    differs from one device's by design, and the aux is not the global
    one. Otherwise the single-device branch."""
    B, S, D = x.shape
    E = cfg.num_experts
    mesh = active_mesh()
    if mesh is None or TP_AXIS not in mesh.axis_names or E % mesh.shape[TP_AXIS]:
        if mesh is not None and _sr.split_over_dp():
            raise NotImplementedError(
                "the MoE's single-device branch routes the global batch; with "
                f"{E} experts the tp axis must divide them on a mesh that "
                "splits the batch over dp")
        out, aux = _moe_math(x.reshape(B * S, D), params.router, params.w_gate,
                             params.w_up, params.w_down, cfg, capacity_factor)
        return out.reshape(B, S, D).to(dt(cfg)), aux
    tp = (TP_AXIS,)
    E_loc = E // mesh.shape[TP_AXIS]
    e_start = _sr.axis_index(mesh, tp) * E_loc
    m = _sr.raw(params)

    def local(w):   # this tp shard's experts, gathered over dp
        w = _sr.gather(w, keep=tp)
        return w if w.shape[0] == E_loc else w[e_start:e_start + E_loc]
    out, aux = _moe_math(_sr.pcopy(x, tp).reshape(B * S, D),
                         _sr.pcopy(params.router, tp), local(m.w_gate),
                         local(m.w_up), local(m.w_down), cfg, capacity_factor,
                         e_start, E_loc)
    out = _sr.psum(out, tp)                     # combine expert shards
    aux = _sr.pmean(aux, tp)
    if _sr.split_over_dp():
        aux = _sr.pmean(aux, _sr.dp_axes(mesh))
    return out.reshape(B, S, D).to(dt(cfg)), aux


# ---------------------------------------------------------------------------
# Mamba2 (SSD — state-space duality, chunked scan)
# ---------------------------------------------------------------------------

class SSM(nn.Module):
    """``w_in (D, 2·din + 2·N + nh)`` (the fused in-projection: z, x, B, C,
    dt), ``w_out (din, D)``, ``conv (K, din + 2·N)`` in the param dtype;
    ``A_log``, ``D``, ``dt_bias`` (nh,) and the gated norm's ``norm``
    (din,) f32."""

    def __init__(self, cfg: ModelConfig, gen=None, *, device=None):
        super().__init__()
        D = cfg.d_model
        din, N, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        device = gen.device if gen is not None else device

        def w(shape):
            return _param(_dense_init(gen, shape, 1.0, pdt(cfg), device))
        self.w_in = w((D, 2 * din + 2 * N + nh))
        self.w_out = w((din, D))
        self.conv = w((cfg.ssm_conv, din + 2 * N))
        self.A_log = _zeros(nh, device)           # A = -exp(A_log) in (-1, 0)
        self.D = _param(torch.ones((nh,), dtype=F32, device=device))
        self.dt_bias = _zeros(nh, device)
        self.norm = _param(torch.ones((din,), dtype=F32, device=device))


def init_ssm(cfg: ModelConfig, gen=None, *, device=None) -> SSM:
    return SSM(cfg, gen, device=device)


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no threshold."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def _ssm_split(params: SSM, x, cfg: ModelConfig):
    din, N = cfg.d_inner, cfg.ssm_state
    zxbcdt = matmul_c(x, params.w_in, cfg)
    z, xs, Bc, Cc, dtp = torch.split(
        zxbcdt, [din, din, N, N, zxbcdt.shape[-1] - 2 * din - 2 * N], -1)
    return z, xs, Bc, Cc, softplus(dtp + params.dt_bias)   # (B,S,nh) f32 > 0


def _causal_conv(xbc, conv_w, cache=None):
    """Depthwise causal conv1d, then SiLU. xbc (B,S,ch); conv_w (K,ch); the
    K taps summed in order 0..K-1.

    With ``cache`` (B,K-1,ch) one streaming step (S == 1). Returns (out,
    new_cache): the last K-1 inputs."""
    K = conv_w.shape[0]
    if cache is None:
        S = xbc.shape[1]
        pad = F.pad(xbc, (0, 0, K - 1, 0))
        out = sum(pad[:, i:i + S] * conv_w[i] for i in range(K))
        return F.silu(out), pad[:, pad.shape[1] - (K - 1):] if K > 1 else None
    full = torch.cat([cache, xbc], 1)                     # (B,K,ch)
    out = sum(full[:, i].to(F32) * conv_w[i].to(F32) for i in range(K))
    return F.silu(out.to(xbc.dtype))[:, None], full[:, 1:]


def ssd_chunked(xh, dtp, A, Bc, Cc, cfg: ModelConfig, h0=None):
    """Chunked SSD scan (Dao & Gu 2024, §6).

    xh  (B,S,nh,P)  per-head inputs
    dtp (B,S,nh)    positive timestep
    A   (nh,)       negative scalar per head
    Bc/Cc (B,S,N)   shared-across-heads input/output projections
    h0  (B,nh,N,P)  initial state, optional
    Padding to a chunk multiple takes dt = 0 rows (decay 1, input 0: the
    state does not move). The differences of the cumulative sums are masked
    to -inf above the diagonal before the ``exp``: there they are positive,
    and past ~88 (a chunk's sum of dt·|A|) ``exp`` overflows to inf. The
    reference masks after the ``exp``; its forward is the same, but its
    gradient multiplies 0 by inf there (NaN at the configs' chunk of 256).
    The chunk states run through a sequential scan from ``h0``.
    Returns (y (B,S,nh,P) f32, h_last (B,nh,N,P) f32)."""
    B, S, nh, P = xh.shape
    N = Bc.shape[-1]
    Q = min(cfg.ssm_chunk, S)
    S0 = S
    pad = -S % Q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dtp = F.pad(dtp, (0, 0, 0, pad))
        Bc = F.pad(Bc, (0, 0, 0, pad))
        Cc = F.pad(Cc, (0, 0, 0, pad))
        S += pad
    nc = S // Q
    xb = xh.reshape(B, nc, Q, nh, P).to(F32)
    dtb = dtp.reshape(B, nc, Q, nh).to(F32)
    Bb = Bc.reshape(B, nc, Q, N).to(F32)
    Cb = Cc.reshape(B, nc, Q, N).to(F32)

    dA = dtb * A                                           # (B,nc,Q,nh) <= 0
    cums = torch.cumsum(dA, 2)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()
    seg = torch.exp(torch.where(causal[None, None, :, :, None],
                                cums[:, :, :, None, :] - cums[:, :, None, :, :],
                                -math.inf))                     # (B,nc,Qq,Qs,nh)

    # intra-chunk (quadratic within a chunk)
    G = torch.einsum("bcqn,bcsn->bcqs", Cb, Bb)
    M = G[..., None] * seg * dtb[:, :, None, :, :]
    y = torch.einsum("bcqsh,bcshp->bcqhp", M, xb)

    # each chunk's input -> state contribution, and its decay
    decay_suf = torch.exp(cums[:, :, -1:, :] - cums)       # (B,nc,Q,nh)
    dx = xb * dtb[..., None]
    chunk_state = torch.einsum("bcqn,bcqhp->bchnp", Bb, decay_suf[..., None] * dx)
    chunk_decay = torch.exp(cums[:, :, -1, :])             # (B,nc,nh)

    h = torch.zeros((B, nh, N, P), dtype=F32, device=xh.device) if h0 is None \
        else h0.to(F32)
    h_enter = []
    for c in range(nc):
        h_enter.append(h)
        h = h * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    h_enter = torch.stack(h_enter, 1)                      # (B,nc,nh,N,P)

    # inter-chunk: y += C_t · (decay_prefix_t · h_enter)
    y = y + torch.einsum("bcqn,bchnp->bcqhp", Cb, h_enter) * torch.exp(cums)[..., None]
    return y.reshape(B, S, nh, P)[:, :S0], h


def ssm_block(params: SSM, x, cfg: ModelConfig, state=None, conv_cache=None):
    """The mamba2 block. x (B,S,D); with ``state`` (B,nh,N,P) and
    ``conv_cache`` (B,K-1,ch) and S == 1, one streaming decode step.
    Returns (out (B,S,D), new_state, new_conv_cache)."""
    B, S, D = x.shape
    din, N, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    P = cfg.ssm_head_dim
    z, xs, Bc, Cc, dtp = _ssm_split(params, x, cfg)
    xbc = torch.cat([xs, Bc, Cc], -1).to(dt(cfg))
    conv_out, new_conv = _causal_conv(xbc, params.conv.to(dt(cfg)), conv_cache)
    xs, Bc, Cc = torch.split(conv_out, [din, N, N], -1)
    A = -torch.exp(params.A_log)
    xh = xs.reshape(B, S, nh, P)
    if S == 1 and state is not None:
        # streaming decode: h' = exp(A dt) h + dt B x ; y = C h
        dtp1 = dtp[:, 0].to(F32)                           # (B,nh)
        da = torch.exp(dtp1 * A)
        bx = torch.einsum("bn,bhp->bhnp", Bc[:, 0].to(F32),
                          xh[:, 0].to(F32) * dtp1[..., None])
        h = state * da[:, :, None, None] + bx
        y = torch.einsum("bn,bhnp->bhp", Cc[:, 0].to(F32), h)[:, None]
        new_state = h
    else:
        y, new_state = ssd_chunked(xh, dtp, A, Bc, Cc, cfg, h0=state)
    y = y + params.D[:, None] * xh.to(F32)
    y = y.reshape(B, S, din)
    # gated RMSNorm (mamba2), in f32
    y = y * F.silu(z.to(F32))
    y = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + cfg.norm_eps)
    y = (y * params.norm).to(dt(cfg))
    out = matmul_rp(y, params.w_out, cfg).to(dt(cfg))
    return out, new_state, new_conv
