"""Point-set generators for the paper's experiment families (§7.3).

UNIF — uniform in a 2-D square (side 100, matching the paper's value
scale, e.g. Table 3's radii ~91 at k=2).
GAU  — k' cluster centers uniform in a cube of side 100; points assigned
uniformly to clusters; Gaussian offset with σ = 1/10 (the paper's σ; the
tight σ is why GAU radii collapse from ~40 to ~1 once k >= k').
UNB  — like GAU but ~half of all points in one cluster.

All generators are counter-based (Philox) — fully deterministic in
(seed, size), independent of call order; the paper generates 3 graphs per
(type, size) and averages over repeated runs, which benchmarks mirror.
"""
from __future__ import annotations

import numpy as np


def _rng(seed: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=np.uint64(seed)))


def unif(n: int, d: int = 2, *, seed: int = 0, side: float = 100.0):
    return (_rng(seed).random((n, d)) * side).astype(np.float32)


def gau(n: int, k_prime: int = 25, d: int = 2, *, seed: int = 0,
        side: float = 100.0, sigma: float = 0.1, centers=None):
    """``centers`` (k', d) overrides the drawn cluster centers — used by
    ``data/source.synthetic_source`` so every block shares one set."""
    r = _rng(seed)
    if centers is None:
        centers = r.random((k_prime, d)) * side
    assign = r.integers(0, k_prime, n)
    pts = centers[assign] + r.normal(0.0, sigma, (n, d))
    return pts.astype(np.float32)


def unb(n: int, k_prime: int = 25, d: int = 2, *, seed: int = 0,
        side: float = 100.0, sigma: float = 0.1, big_frac: float = 0.5,
        centers=None):
    """See ``gau`` for the ``centers`` override."""
    r = _rng(seed)
    if centers is None:
        centers = r.random((k_prime, d)) * side
    n_big = int(n * big_frac)
    assign = np.concatenate([
        np.zeros(n_big, np.int64),
        r.integers(1, k_prime, n - n_big),
    ])
    pts = centers[assign] + r.normal(0.0, sigma, (n, d))
    return pts.astype(np.float32)


def kddlike(n: int, d: int = 38, *, seed: int = 0):
    """High-dimensional heavy-tailed proxy for the KDD CUP 1999 sample
    (UCI data unavailable offline; DESIGN.md §9)."""
    r = _rng(seed)
    base = r.lognormal(0.0, 1.5, (n, d))
    mask = r.random((n, d)) < 0.7          # many near-zero features
    return (base * mask).astype(np.float32)


def pokerlike(n: int, *, seed: int = 0):
    """Integer-grid proxy for the POKER HAND set (10 categorical-ish dims)."""
    r = _rng(seed)
    suits = r.integers(1, 5, (n, 5)).astype(np.float32)
    ranks = r.integers(1, 14, (n, 5)).astype(np.float32)
    return np.concatenate([suits, ranks], axis=1)


GENERATORS = {"unif": unif, "gau": gau, "unb": unb, "kddlike": kddlike,
              "pokerlike": pokerlike}
