"""(k,z)-center — k-center with z outliers over the weighted-fold substrate
(port of ``repro.core.outliers``).

The MapReduce form follows Ceccarello–Pietracaprina–Pucci (arXiv
1802.09205): round 1 builds a weighted coreset — every machine block is
reduced by GON to ``t = k + z`` centers, each carrying the total weight of
the rows it absorbed (``weighted_gon_block_fn``); the reducer then solves
the sequential outlier problem on the coreset only (Charikar et al.'s
greedy disk cover, weighted), on the host in float64, O(coreset²) and never
O(n). The radius of the result excludes the z farthest points, by the
streamed top-(z+1) fold (``engine.fold_top_k_min_d2``, the weighted filter
kernel on the card), so no step materializes a streamed source.

The coreset (centers, weights, validity) crosses to the host in one read,
for the solve; ``kz_center.host_reads`` counts such reads. Nothing else
in a run reads the device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.data.source import ArraySource, as_source, has_weights, is_source
from repro_torch.device import resolve_device, upload
from repro_torch.kernels import ops

from .executor import (Executor, HostStreamExecutor, Objective, SimExecutor,
                       weighted_gon_block_fn)


class KZResult(NamedTuple):
    centers: torch.Tensor    # (k, d) the outlier-aware centers
    radius2: torch.Tensor    # ()     squared radius excluding the z farthest
    coreset_size: int        # weighted-coreset rows the host solve saw
    rounds: int              # MapReduce rounds (2 = one coreset level)


# ---------------------------------------------------------------------------
# The sequential weighted solve (host, O(coreset²))
# ---------------------------------------------------------------------------

def _weighted_charikar(pts: np.ndarray, w: np.ndarray, k: int, z: float):
    """Charikar et al.'s greedy disk cover on a *weighted* instance.

    A verbatim copy of ``repro.core.outliers._weighted_charikar`` (numpy
    only). Binary-searches the candidate radii (the pairwise distances —
    OPT is one of them): at guess r, greedily pick the point whose r-ball
    covers the most uncovered weight, remove the 3r-ball, k times;
    feasible iff the uncovered weight is <= z. For any r >= OPT the greedy
    is feasible (the classical disk argument, weights included — each
    optimal ball is wiped by some chosen 3r-ball), so the search converges
    to a feasible guess <= the smallest candidate >= OPT and the chosen
    centers cover all but weight z within 3·OPT.

    Returns ``(sel (k,) indices into pts, r2)`` with ``r2`` the squared
    feasible guess. All float64 — the instance is coreset-sized.
    """
    c = pts.shape[0]
    if k >= c:
        return np.arange(c, dtype=np.int64), 0.0
    pts = np.asarray(pts, np.float64)
    w = np.asarray(w, np.float64)
    diff = pts[:, None, :] - pts[None, :, :]
    d2 = np.maximum((diff * diff).sum(-1), 0.0)       # (c, c)
    cand = np.unique(d2)

    def greedy(r2):
        sel = np.empty((k,), np.int64)
        uncovered = w.copy()
        for i in range(k):
            cover = (d2 <= r2) @ uncovered            # weight in each r-ball
            j = int(np.argmax(cover))
            sel[i] = j
            uncovered[d2[j] <= 9.0 * r2] = 0.0        # wipe the 3r-ball
        return sel, float(uncovered.sum())

    lo, hi = 0, cand.size - 1                         # hi: one ball covers all
    while lo < hi:
        mid = (lo + hi) // 2
        _, left = greedy(cand[mid])
        if left <= z + 1e-6:
            hi = mid
        else:
            lo = mid + 1
    sel, _ = greedy(cand[lo])
    return sel, float(cand[lo])


# ---------------------------------------------------------------------------
# The MapReduce algorithm
# ---------------------------------------------------------------------------

def _coreset_to_host(centers: torch.Tensor, cw: torch.Tensor,
                     valid: torch.Tensor):
    """The weighted coreset on the host, in one read: centers, weights and
    validity packed into one float32 tensor (validity as 0/1) and copied
    back together."""
    n, d = centers.shape
    packed = torch.cat([centers.reshape(-1), cw.to(torch.float32),
                        valid.to(torch.float32)]).cpu().numpy()
    kz_center.host_reads += 1
    return (packed[:n * d].reshape(n, d), packed[n * d:n * (d + 1)],
            packed[n * (d + 1):] > 0)


def kz_center(points, k: int, z: int, *, t: int | None = None,
              executor: Executor | None = None, m: int = 50,
              solve_capacity: int | None = None, impl: str = "auto",
              chunk: int | None = None, device=None) -> KZResult:
    """k-center with z outliers (Ceccarello et al. 1802.09205, streamed).

    ``points`` is anything ``as_source`` accepts, a ``WeightedSource``
    included (its row weights seed the coreset weights; ``z`` then bounds
    the excluded weight, counted in source rows). Without an
    ``executor``, raw arrays and ``ArraySource`` run on
    ``SimExecutor(m, device=device)`` and a host, disk or generator source
    streams on ``HostStreamExecutor(device=device)``; ``device=None``
    means ``"cuda"``.

    ``t`` (default ``k + z``) is the per-machine coreset size. If the
    round-1 union exceeds ``solve_capacity`` (default ``max(2048, 2·t)``),
    weighted Lemma-3 levels (``combine_weighted(..., final_gon=False)``)
    shrink it first. The coreset is read to the host once for the float64
    solve. ``chunk`` (rows) bounds every distance pass's plain-route tiles.

    Returns ``KZResult``: k centers, the squared covering radius excluding
    the z farthest points (a streamed top-(z+1) fold over the original
    source), the coreset size the host solve saw, and the round count.

    >>> import numpy as np
    >>> rng = np.random.default_rng(0)
    >>> x = rng.normal(size=(500, 2)).astype(np.float32)
    >>> x[:3] += 100.0                          # 3 far outliers
    >>> res = kz_center(x, 4, 3, m=5, device="cpu")
    >>> tuple(res.centers.shape)
    (4, 2)
    >>> float(res.radius2) < 100.0              # outliers excluded
    True
    """
    if k < 1:
        raise ValueError(f"need k >= 1, got k={k}")
    if z < 0:
        raise ValueError(f"need z >= 0, got z={z}")
    t = int(k + z) if t is None else int(t)
    if t < k:
        raise ValueError(f"coreset size t={t} must be >= k={k}")
    streamed = is_source(points) and not isinstance(points, ArraySource)
    if executor is None:
        executor = (HostStreamExecutor(device=device) if streamed
                    else SimExecutor(m=m, device=device))
    elif device is not None:
        raise ValueError("pass device= to the executor, not to kz_center()")
    if streamed:
        source = as_source(points)
    else:
        source = (points if isinstance(points, ArraySource)
                  else ArraySource(points, device=executor.device))
    objective = Objective(name="kz_center", weighted=True, outliers=int(z))

    # Round 1: per-machine weighted GON — t centers per block, each
    # carrying the weight of the rows it absorbed.
    fn = weighted_gon_block_fn(t, impl, chunk)
    centers, valid, cw = executor.run_blocks(fn, source, objective=objective)

    # Optional intermediate levels: shrink the union to the host-solve
    # capacity, weights re-aggregated per level (Lemma 3, weighted).
    if solve_capacity is None:
        solve_capacity = max(2048, 2 * t)
    extra = 0
    if centers.shape[0] > solve_capacity:
        centers, cw, valid, extra = executor.combine_weighted(
            centers, valid, cw, t, solve_capacity, impl=impl, chunk=chunk,
            final_gon=False)

    # The sequential outlier-aware solve on the weighted coreset (host,
    # float64). Zero-weight rows absorbed no points and carry no objective
    # mass; drop them with the invalid ones.
    cn, wn, vn = _coreset_to_host(centers, cw, valid)
    cn, wn = np.asarray(cn, np.float64), np.asarray(wn, np.float64)
    keep = vn & (wn > 0)
    cpts, cwts = cn[keep], wn[keep]
    if cpts.shape[0] == 0:
        raise ValueError("empty coreset — source has no positive-weight rows")
    sel, _ = _weighted_charikar(cpts, cwts, k, float(z))
    if sel.size < k:                        # coreset smaller than k: repeat
        sel = np.concatenate([sel, np.full(k - sel.size, sel[0], np.int64)])
    kcenters = upload(cpts[sel].astype(np.float32), executor.device)

    # The (k,z) objective value over the ORIGINAL source: streamed
    # top-(z+1) fold — slot z is the radius after excluding the z farthest.
    r2 = executor.radius2(source, kcenters, impl=impl, chunk=chunk,
                          objective=objective)
    return KZResult(kcenters, r2, int(cpts.shape[0]), 2 + extra)


kz_center.host_reads = 0


def covering_radius_excluding(points, centers, z: int, *, impl: str = "auto",
                              block_rows: int | None = None,
                              memory_budget: int | None = None,
                              device=None) -> torch.Tensor:
    """Euclidean covering radius of ``centers`` excluding the z farthest
    points — the (k,z) objective any center set scores under.

    One streamed top-(z+1) fold over the source (``fold_top_k_min_d2``):
    device residency is one block (plus the upload ring) and the
    (z+1,)-slot running top-k; weighted sources restrict candidacy to
    their positive-weight support. ``z=0`` is the plain covering radius.
    ``device=None`` means ``"cuda"``.
    """
    if z < 0:
        raise ValueError(f"need z >= 0, got z={z}")
    dev = resolve_device(device)
    src = as_source(points)
    top = ops.fold_top_k_min_d2(src, centers, int(z) + 1, impl=impl,
                                block_rows=block_rows,
                                memory_budget=memory_budget,
                                weighted=has_weights(src), device=dev)
    return torch.sqrt(torch.clamp_min(top[int(z)], 0.0))
