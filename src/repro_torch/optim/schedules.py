"""Learning-rate schedules (port of ``repro.optim.schedules``): pure
functions of the step, computed on the host in float32 as jnp computes
them, so that the optimizer reads no value back from the card.

Includes WSD (warmup-stable-decay) used by MiniCPM [arXiv:2404.06395]:
linear warmup, long stable plateau, short (typically 10%) decay tail.
"""
from __future__ import annotations

import numpy as np

F = np.float32


def linear_warmup(step, warmup: int, peak: float):
    return F(peak) * np.minimum(F(1.0), F(step + 1) / F(max(warmup, 1)))


def cosine(step, *, peak: float, warmup: int, total: int, floor: float = 0.0):
    warm = linear_warmup(step, warmup, peak)
    t = np.clip(F(step - warmup) / F(max(total - warmup, 1)), F(0.0), F(1.0))
    cos = F(floor) + F(0.5 * (peak - floor)) * (F(1.0) + np.cos(F(np.pi) * t))
    return warm if step < warmup else F(cos)


def wsd(step, *, peak: float, warmup: int, total: int,
        decay_frac: float = 0.1, floor: float = 0.0):
    """Warmup-Stable-Decay (MiniCPM): plateau at peak, decay in the last
    ``decay_frac`` of training (exponential-style cosine tail)."""
    warm = linear_warmup(step, warmup, peak)
    decay_start = int(total * (1.0 - decay_frac))
    t = np.clip(F(step - decay_start) / F(max(total - decay_start, 1)),
                F(0.0), F(1.0))
    tail = F(floor) + F((peak - floor) * 0.5) * (F(1.0) + np.cos(F(np.pi) * t))
    stable = F(peak) if step < decay_start else F(tail)
    return warm if step < warmup else stable


def constant(step, *, peak: float, warmup: int = 0, **_):
    return linear_warmup(step, warmup, peak)


SCHEDULES = {"cosine": cosine, "wsd": wsd, "constant": constant}


def make_schedule(name: str, **kw):
    fn = SCHEDULES[name]
    return lambda step: fn(step, **kw)
