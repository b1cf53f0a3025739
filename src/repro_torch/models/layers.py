"""Building blocks of the dense decoder-only LM (port of the dense subset of
``repro.models.layers``).

The parameters live in ``nn.Module``s (``Norm``, ``Attention``, ``MLP``)
under the JAX package's names (``scale``, ``wq``, ``bq``, ``w_gate``, ...),
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
    off, its split-K sums do too.
  * a bias add promotes to f32 (bf16 + f32), as jnp does; a residual
    ``x + rs * out`` stays in the activation's dtype.
  * norms, RoPE, attention scores and softmax run in f32; masked scores
    take ``finfo(f32).min``; the softmax weights are cast to the compute
    dtype before the PV product, which accumulates in f32.
  * attention is plain torch ops, as the reference's is plain jnp outside
    any Pallas kernel. A fused attention kernel would round otherwise.

M-RoPE, sinusoidal positions, cross-attention, MoE and the SSM are not
here yet: ``ROADMAP.md`` queues them for later slices.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import upload

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
    return (torch.randn(shape, generator=gen, dtype=F32, device=device)
            * std).to(dtype)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)   # the port serves only


def _mm(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype):
    """``x @ w`` with f32 accumulation and an ``out_dtype`` result."""
    if x.dtype == w.dtype == out_dtype:
        return x @ w
    if (x.is_cuda and x.dtype == w.dtype and out_dtype == F32
            and x.dtype in (torch.bfloat16, torch.float16)):
        out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=F32)
        return out.reshape(*x.shape[:-1], w.shape[-1])
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


def apply_rope(x, cos, sin):
    """x (B,S,H,hd); cos/sin (B,S,hd/2) — rotate-half convention, in f32."""
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA; causal / window; cached decode)
# ---------------------------------------------------------------------------

def _zeros(n: int, device) -> nn.Parameter:
    return _param(torch.zeros((n,), dtype=F32, device=device))


class Attention(nn.Module):
    """``wq (D, H·hd)``, ``wk``/``wv (D, KV·hd)``, ``wo (H·hd, D)`` in the
    param dtype; ``bq``/``bk``/``bv`` f32 where ``cfg.qkv_bias``."""

    def __init__(self, cfg: ModelConfig, gen=None, *, device=None):
        super().__init__()
        D, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        hd = cfg.resolved_head_dim
        device = gen.device if gen is not None else device

        def w(shape):
            return _param(_dense_init(gen, shape, 1.0, pdt(cfg), device))
        self.wq, self.wk = w((D, H * hd)), w((D, KV * hd))
        self.wv, self.wo = w((D, KV * hd)), w((H * hd, D))
        self.bq = self.bk = self.bv = None
        if cfg.qkv_bias:
            self.bq, self.bk, self.bv = (_zeros(H * hd, device),
                                         _zeros(KV * hd, device),
                                         _zeros(KV * hd, device))


def init_attention(cfg: ModelConfig, gen=None, *, device=None) -> Attention:
    return Attention(cfg, gen, device=device)


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
    unbounded lookback."""
    m = k_idx[None, None, :] <= q_pos[:, :, None]
    if window > 0:
        m &= k_idx[None, None, :] > q_pos[:, :, None] - window
    return m


def _attend_block(qc, k, v, q_pos_c, k_idx, window, cfg: ModelConfig):
    """One q-chunk of attention. qc (B,bq,KV,G,hd); k/v (B,Sk,KV,hd).
    Returns (B,bq,KV,G,hd) f32."""
    B, bq, KV, G, hd = qc.shape
    Sk = k.shape[1]
    q32 = qc.to(F32).permute(0, 2, 3, 1, 4).reshape(B, KV, G * bq, hd)
    k32 = k.to(F32).permute(0, 2, 3, 1)                       # (B,KV,hd,Sk)
    scores = torch.matmul(q32, k32).view(B, KV, G, bq, Sk) / math.sqrt(hd)
    if cfg.logit_softcap > 0:
        scores = cfg.logit_softcap * torch.tanh(scores / cfg.logit_softcap)
    mask = _mask_block(q_pos_c, k_idx, window)                 # (B,bq,Sk)
    scores = torch.where(mask[:, None, None, :, :], scores, NEG)
    w = torch.softmax(scores, dim=-1).to(dt(cfg))
    out = torch.matmul(w.to(F32).reshape(B, KV, G * bq, Sk),
                       v.to(F32).permute(0, 2, 1, 3))         # (B,KV,G·bq,hd)
    return out.view(B, KV, G, bq, hd).permute(0, 3, 1, 2, 4)


def attend(q, k, v, cfg: ModelConfig, *, q_pos, window: int = 0,
           chunk: int = ATTN_CHUNK):
    """Attention of q (B,Sq,H,hd) over k/v (B,Sk,KV,hd), GQA by a (KV,
    group) reshape. Past ``chunk`` queries it goes chunk by chunk: the
    queries are padded to a chunk multiple, the padded rows at ``q_pos`` 0
    (they see key 0 alone), and sliced away. Returns (B,Sq,H·hd) in the
    compute dtype."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    q = q.reshape(B, Sq, KV, G, hd)
    k_idx = torch.arange(k.shape[1], dtype=torch.int32, device=q.device)
    if Sq <= chunk:
        out = _attend_block(q, k, v, q_pos, k_idx, window, cfg)
    else:
        pad = -Sq % chunk
        if pad:
            q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pad))
            q_pos = F.pad(q_pos, (0, pad))
        out = torch.cat([
            _attend_block(q[:, i:i + chunk], k, v, q_pos[:, i:i + chunk],
                          k_idx, window, cfg)
            for i in range(0, Sq + pad, chunk)], dim=1)[:, :Sq]
    return out.reshape(B, Sq, H * hd).to(dt(cfg))


def attention_block(params: Attention, x, cfg: ModelConfig, *, positions,
                    q_pos=None, window: int = 0, cos_sin=None):
    """Self-attention over the whole sequence (forward and prefill).

    ``positions (B,S)`` feed RoPE (``cos_sin``, their cos/sin, may be
    passed in computed); ``q_pos`` the visibility mask (default arange).
    K/V are repeated to the full head count for the attend; the cache keeps
    the compact KV heads. Returns (out, (k, v))."""
    B, S = x.shape[:2]
    q, k, v = _qkv(params, x, x, cfg)
    if cfg.rope_type == "rope":
        cos, sin = cos_sin if cos_sin is not None else rope_cos_sin(
            positions, cfg.resolved_head_dim, cfg.rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    elif cfg.rope_type == "mrope":
        raise NotImplementedError("M-RoPE is not ported yet (the vlm family)")
    if q_pos is None:
        q_pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    kv_cache = (k, v)
    G = cfg.num_heads // max(cfg.num_kv_heads, 1)
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    out = attend(q, k, v, cfg, q_pos=q_pos, window=window)
    return matmul_rp(out, params.wo, cfg).to(dt(cfg)), kv_cache


def _write_at(cache, pos, new):
    """``cache[b, pos[b]] = new[b]`` in place; a position past the cache
    drops its write, as jax's scatter does."""
    B, S = cache.shape[:2]
    bidx = torch.arange(B, device=cache.device)
    at = pos.to(torch.int64).clamp(max=S - 1)
    inside = (pos < S)[:, None, None]
    cache[bidx, at] = torch.where(inside, new, cache[bidx, at])


def attention_decode(params: Attention, x, cache_k, cache_v, pos,
                     cfg: ModelConfig, *, window: int = 0, cos_sin=None):
    """One-token decode. x (B,1,D); cache (B,S_max,KV,hd), updated in
    place; pos (B,) int32 indexes the cache slot and the mask, and feeds
    RoPE (``cos_sin``, its cos/sin, may be passed in computed).
    Returns (out (B,1,D), cache_k, cache_v)."""
    q, k, v = _qkv(params, x, x, cfg)
    if cfg.rope_type == "rope":
        cos, sin = cos_sin if cos_sin is not None else rope_cos_sin(
            pos[:, None], cfg.resolved_head_dim, cfg.rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    elif cfg.rope_type == "mrope":
        raise NotImplementedError("M-RoPE is not ported yet (the vlm family)")
    _write_at(cache_k, pos, k[:, 0])
    _write_at(cache_v, pos, v[:, 0])
    out = attend(q, cache_k, cache_v, cfg, q_pos=pos[:, None], window=window)
    return matmul_rp(out, params.wo, cfg).to(dt(cfg)), cache_k, cache_v


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
        return matmul_rp(h.to(dt(cfg)), params.w_down, cfg).to(dt(cfg))
    # jax.nn.gelu is the tanh approximation
    h = F.gelu(matmul_c(x, params.w_up, cfg) + params.b_up, approximate="tanh")
    return (matmul_rp(h.to(dt(cfg)), params.w_down, cfg)
            + params.b_down).to(dt(cfg))
