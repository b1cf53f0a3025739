"""Token sampling: greedy / temperature / top-k / top-p (port of
``repro.serve.sampler``).

``sample(logits (B,V), key)`` draws as ``jax.random.categorical(key,
logits, -1)`` does (jax's default "low" Gumbel mode): Gumbel noise
``-log(-log(u))`` from uniforms whose bits are threefry-2x32 under jax's
partitionable scheme — element i of the flattened (B, V) draw hashes the
counter words ``(i >> 32, i & 0xffffffff)`` under the key and xors the
two output words — so the uniforms are bitwise jax's, on any device. The
logs are the device's own and may differ from XLA's in the last place.
A key is an int seed or two uint32 words (``kernels.engine.key_words``);
``kernels.engine.split_key`` splits it as ``jax.random.split`` does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.engine import key_words

F32 = torch.float32
NEG = torch.finfo(F32).min
TINY = float(np.finfo(np.float32).tiny)
_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)``, int64
    tensors holding values in [0, 2^32), under the key words ``(k0,
    k1)``: the tensor form of ``kernels.engine._threefry2x32``. Every sum
    is masked back to 32 bits; a rotation's shift stays below 2^63."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
    for g in range(5):
        for r in _ROT[g % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _M32
        x1 = (x1 + (ks[(g + 2) % 3] + g + 1)) & _M32
    return x0, x1


def random_bits(key, shape, device) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int64 values."""
    k0, k1 = key_words(key)
    count = torch.arange(int(np.prod(shape)), dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(k0, k1, count >> 32, count & _M32)
    return (x0 ^ x1).reshape(shape)


def uniform(key, shape, device, minval: float = 0.0):
    """``jax.random.uniform(key, shape, f32, minval, 1.0)``: the top 23
    bits as the mantissa of a float in [1, 2), minus 1, scaled by ``1 -
    minval`` and shifted by ``minval`` in f32, held at ``minval`` or
    above."""
    bits = random_bits(key, shape, device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(F32) - 1.0
    lo, span = np.float32(minval), np.float32(1.0) - np.float32(minval)
    return torch.clamp_min(f * float(span) + float(lo), float(lo))


def gumbel(key, shape, device) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, f32)`` in its default ("low") mode."""
    return -torch.log(-torch.log(uniform(key, shape, device, minval=TINY)))


def _apply_top_k(logits, k: int):
    if k <= 0:
        return logits
    # the k-th largest value: an ascending sort's [..., -k]
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG, logits)


def _apply_top_p(logits, p: float):
    if p >= 1.0:
        return logits
    sort_idx = torch.sort(-logits, dim=-1, stable=True).indices  # jnp.argsort's
    sorted_logits = torch.gather(logits, -1, sort_idx)
    cum = torch.cumsum(torch.softmax(sorted_logits, -1), -1)
    # keep tokens until cumulative prob exceeds p (always keep the first)
    keep_sorted = torch.roll(cum, 1, dims=-1) < p
    keep_sorted[..., 0] = True
    keep = torch.zeros_like(keep_sorted).scatter_(-1, sort_idx, keep_sorted)
    return torch.where(keep, logits, NEG)


def sample(logits, key, *, temperature: float = 0.0, top_k: int = 0,
           top_p: float = 1.0) -> torch.Tensor:
    """logits (B,V) -> token ids (B,) int32, on the logits' device. Greedy
    (``temperature <= 0``) is the first index of the maximum and reads no
    key."""
    logits = logits.to(F32)
    if temperature <= 0.0:
        return torch.argmax(logits, -1).to(torch.int32)
    logits = logits / temperature
    logits = _apply_top_k(logits, top_k)
    logits = _apply_top_p(logits, top_p)
    noise = gumbel(key, tuple(logits.shape), logits.device)
    return torch.argmax(noise + logits, -1).to(torch.int32)
