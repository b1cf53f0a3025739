"""Clustering quality metrics + exact baselines for tests (port of
``repro.core.metrics``).

``brute_force_opt`` enumerates all k-subsets (tiny n only) to give the true
optimum that the approximation-factor tests compare against (GON <= 2·OPT,
2-round MRG <= 4·OPT); ``brute_force_opt_z`` does the same for the
(k,z)-center objective.
"""
from __future__ import annotations

import itertools

import numpy as np

from repro_torch.device import as_points, resolve_device
from repro_torch.kernels import ops


def covering_radius2(points, centers, *, impl: str = "auto", device=None):
    """Max over points of squared distance to the nearest center.
    ``device=None`` means ``"cuda"``."""
    dev = resolve_device(device)
    _, d2 = ops.assign_nearest(as_points(points, dev), as_points(centers, dev),
                               impl=impl)
    return d2.max()


def assignment(points, centers, *, impl: str = "auto", device=None):
    """Per-point nearest center index (int32). ``device=None`` means
    ``"cuda"``."""
    dev = resolve_device(device)
    idx, _ = ops.assign_nearest(as_points(points, dev),
                                as_points(centers, dev), impl=impl)
    return idx


def brute_force_opt(points: np.ndarray, k: int) -> float:
    """Exact k-center optimum (center set ⊆ points) by enumeration.

    O(C(n,k) · n · k) — only for n <~ 20 in tests. Returns the Euclidean
    (not squared) optimal covering radius.
    """
    pts = np.asarray(points, np.float64)
    n = pts.shape[0]
    if k >= n:
        return 0.0
    d2 = np.maximum(
        ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1), 0.0
    )
    best = np.inf
    for combo in itertools.combinations(range(n), k):
        r = d2[:, combo].min(axis=1).max()
        if r < best:
            best = r
    return float(np.sqrt(best))


def brute_force_opt_z(points: np.ndarray, k: int, z: int) -> float:
    """Exact (k,z)-center optimum (centers ⊆ points) by enumeration.

    A verbatim copy of ``repro.core.metrics.brute_force_opt_z`` (numpy
    only). For every k-subset, the objective is the covering radius after
    dropping the z farthest points — the (n-z-1)-th order statistic of
    the per-point min distances. O(C(n,k) · n · k); tiny n only. Returns
    the Euclidean optimum the outlier approximation-ratio tests divide by.
    """
    pts = np.asarray(points, np.float64)
    n = pts.shape[0]
    if k >= n or z >= n:
        return 0.0
    d2 = np.maximum(
        ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1), 0.0
    )
    best = np.inf
    for combo in itertools.combinations(range(n), k):
        md = d2[:, combo].min(axis=1)
        r = np.partition(md, n - z - 1)[n - z - 1]
        if r < best:
            best = r
    return float(np.sqrt(best))
