"""EIM — parameterized iterative-sampling k-center (paper §4, Algorithms 2–3).

Port of ``repro.core.eim``: Ene, Im and Moseley's MapReduce sampling scheme
with the paper's two changes. Points sampled into S always leave R, and the
removal test is ``d(x, S) <= d(v, S)`` (ties removed), so |R| shrinks every
iteration (§4.1). The pivot v is the ``φ·log n``-th farthest point of H from
S (§4.2, Algorithm 3; φ = 8 is the original scheme).

Two forms of one algorithm, bitwise alike on the plain route for one key:

  * **Device path** (arrays, tensors, ``ArraySource``): R, S and H are masks
    over the (n, d) points on the device, and ``d(x, S)`` an (n,) tensor
    there. A host loop drives it; the loop condition is its one read an
    iteration. Each iteration's new members of S go into a buffer of fixed
    capacity ``s_cap`` (positions from a cumulative sum, first row first;
    samples past the capacity are dropped and counted in ``overflow``,
    empty slots at ``1e18``), and ``d(x, S)`` is updated against that
    buffer by the nearest-center assign (kernel #2).
  * **Streamed loop** (host, disk or generator sources, or any call with an
    ``executor=``): R, S and ``d(x, S)`` live on the host, and every pass is
    the executor's ``run_filter_round`` over the source (kernel #3 on the
    card). Round 1 needs no pass over the data: the Bernoulli draws are
    counter-based (``engine.bernoulli_rows``, Philox keyed by the absolute
    row), drawn on the device and copied back; the sampled rows are fetched
    by ``source.take``. When the survivors fall under ``compact_threshold``
    of the current view, later passes run over an ``IndexedSource`` of them.

The loop runs while ``|R| > (4/ε)·k·n^ε·log n`` (and under ``max_iters``).
Both forms evaluate that condition, the sampling probabilities and every
distance comparison in f32 with the same expressions, and split the key as
``jax.random.split(key, 3)`` does (``engine.split_key``), so they draw the
JAX package's samples. The final "send C to one machine" round is GON
(kernel #1) over the compacted sample, padded to a power of two.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import compat
from repro_torch.data.source import (ArraySource, IndexedSource, as_source,
                                     is_source)
from repro_torch.device import as_points, resolve_device, upload
from repro_torch.kernels import engine, ops

from .executor import Executor, HostStreamExecutor
from .gonzalez import gonzalez

_NEG = np.float32(-3.4e38)
_BIG = np.float32(3.4e38)
# Rows of one sampler draw on the streamed path, at most: a draw's int64
# words (about ten live at once) take ~80 bytes a row on the device.
SAMPLE_ROWS = 1 << 18


class EIMSample(NamedTuple):
    sample_mask: torch.Tensor  # (n,) bool: C = S ∪ R_final (host tensor on
                               #     the streamed path: host relations)
    s_mask: torch.Tensor       # (n,) bool: the sampled centers S
    iters: torch.Tensor        # () int32: loop iterations used (host)
    overflow: torch.Tensor     # () int32: samples dropped by the S buffer
    sampled: torch.Tensor      # () bool: False => the loop never ran (host)


class EIMResult(NamedTuple):
    centers: torch.Tensor      # (k, d)
    radius2: torch.Tensor      # () squared covering radius over all points
    sample: EIMSample


def _expected_caps(n: int, k: int, eps: float, slack: float = 3.0):
    """Fixed buffer capacities with Poisson 3σ-ish headroom."""
    ln_n = math.log(max(n, 2))
    es = 9.0 * k * (n ** eps) * ln_n
    eh = 4.0 * (n ** eps) * ln_n
    s_cap = int(min(n, math.ceil(es + slack * math.sqrt(es) + 16)))
    h_cap = int(min(n, math.ceil(eh + slack * math.sqrt(eh) + 16)))
    return s_cap, h_cap


def _params(n: int, k: int, eps: float, phi: float):
    """Shared schedule: (ln n, |R| threshold, s_cap, h_cap, pivot rank,
    S-sample numerator, H-sample numerator)."""
    ln_n = math.log(max(n, 2))
    threshold = (4.0 / eps) * k * (n ** eps) * ln_n
    s_cap, h_cap = _expected_caps(n, k, eps)
    # Select(): pivot rank φ·log n (>= 1), clipped to the H buffer.
    rank = max(1, min(h_cap, int(round(phi * ln_n))))
    num_s = 9.0 * k * (n ** eps) * ln_n
    num_h = 4.0 * (n ** eps) * ln_n
    return ln_n, threshold, s_cap, h_cap, rank, num_s, num_h


def _sample_cap(n: int, k: int, eps: float, s_count: int) -> int:
    """The §4 bound on the compacted sample: |C| = |R_final| + |S| with
    |R_final| <= (4/ε)k·n^ε·log n at loop exit."""
    ln_n = math.log(max(n, 2))
    return int(min(n, math.ceil((4.0 / eps) * k * (n ** eps) * ln_n)
                   + s_count))


def _check_sample_cap(pop: int, s_count: int, n: int, k: int, eps: float,
                      max_iters: int) -> None:
    cap = _sample_cap(n, k, eps, s_count)
    if pop > cap:
        raise RuntimeError(
            f"EIM sample overflow: |C| = {pop} exceeds the paper-§4 bound "
            f"(4/ε)k·n^ε·log n + |S| = {cap} — the sampling loop hit "
            f"max_iters={max_iters} before |R| fell under the threshold. "
            f"Raise max_iters (or φ) instead of truncating the sample.")


def _compact_cap(pop: int, n: int) -> int:
    """Rows of the final GON: |C| rounded up to a power of two (at most n),
    so that repeated calls meet a few launch shapes, not one per |C|."""
    cap = 1
    while cap < pop:
        cap <<= 1
    return min(cap, n)


def _compact_gonzalez(pts: torch.Tensor, pop: int, cap: int, k: int, *,
                      impl: str, chunk: int | None):
    """GON over the compacted sample ``pts (pop, d)`` on its device, padded
    to ``cap`` rows with a validity mask: padding is never selected and is
    out of the radius, so both EIM forms pick the same centers from the
    same rows."""
    dev = pts.device
    if cap > pop:
        pts = torch.cat([pts, torch.zeros((cap - pop, pts.shape[1]),
                                          dtype=torch.float32, device=dev)])
    valid = torch.arange(cap, device=dev) < pop
    return gonzalez(pts, k, mask=valid, impl=impl, chunk=chunk, device=dev)


def _check_compact_threshold(compact_threshold: float) -> float:
    if not 0.0 <= compact_threshold <= 1.0:
        raise ValueError(
            f"compact_threshold must be in [0, 1], got {compact_threshold} "
            "(0 = never compact, 1 = compact whenever R shrank)")
    return float(compact_threshold)


def _streamed(points, executor) -> bool:
    """Only an explicit host, disk or generator source, or an explicit
    executor, takes the streamed loop (``mrg``'s rule)."""
    return executor is not None or (is_source(points)
                                    and not isinstance(points, ArraySource))


def _stream_setup(points, executor, device):
    source = as_source(points)
    if executor is None:
        executor = HostStreamExecutor(device=device)
    elif device is not None:
        raise ValueError("pass device= to the executor, not to eim()")
    return source, executor


def eim_sample(points, k: int, key, *, eps: float = 0.1, phi: float = 8.0,
               max_iters: int = 64, impl: str = "auto",
               chunk: int | None = None, executor: Executor | None = None,
               compact_threshold: float = 0.5, device=None) -> EIMSample:
    """Algorithm 2 (EIM-MapReduce-Sample) with the φ-parameterized Select.

    ``key`` is an int seed or two uint32 words (``np.asarray(
    jax.random.PRNGKey(s))``, or ``jax.random.key_data`` of a typed key);
    an int seed ``s`` is the words ``(0, s mod 2^32)``, as
    ``jax.random.PRNGKey(s)`` makes them. Arrays, tensors and
    ``ArraySource`` run the device path on ``device`` (``None`` means
    ``"cuda"``); a host, disk or generator source, or any call with an
    ``executor=``, the streamed loop (``HostStreamExecutor(device=device)``
    by default). Both draw from the same counter-based sampler, so for one
    key the sample is the same on either form and any blocking, and the JAX
    package's.

    ``compact_threshold`` (streamed loop only): when the surviving |R|
    falls under this fraction of the current view, the fold is re-pointed
    at an ``IndexedSource`` of the survivors. 0 never compacts, 1 compacts
    after every shrinking iteration; the sample does not depend on it. A
    run of several processes never compacts.

    ``chunk`` (rows) bounds the plain route's (chunk, s_cap) distance
    tiles (``engine.resolve_chunk``); the sample does not change.
    """
    compact_threshold = _check_compact_threshold(compact_threshold)
    if not _streamed(points, executor):
        return _eim_sample_device(as_points(points, resolve_device(device)),
                                  k, key, eps=eps, phi=phi,
                                  max_iters=max_iters, impl=impl, chunk=chunk)
    source, executor = _stream_setup(points, executor, device)
    return _eim_sample_stream(source, k, key, eps=eps, phi=phi,
                              max_iters=max_iters, executor=executor,
                              impl=impl, chunk=chunk,
                              compact_threshold=compact_threshold)


def eim(points, k: int, key, *, eps: float = 0.1, phi: float = 8.0,
        max_iters: int = 64, impl: str = "auto", chunk: int | None = None,
        compact: bool = True, executor: Executor | None = None,
        compact_threshold: float = 0.5, device=None) -> EIMResult:
    """Full EIM: sample, then GON on the sample (the final MapReduce round).

    With ``compact=True`` the sample C is gathered into a dense buffer
    before the final GON, the "send S ∪ R to one machine" round, so that it
    costs O(k·|C|) and not O(k·n). |C| is checked against the §4 bound
    ``(4/ε)k·n^ε·log n + |S|``: past it (the loop hit ``max_iters``) a
    ``RuntimeError`` is raised, never a silent truncation. Streamed sources
    compact through ``source.take``, so all of n is never on the device;
    ``compact=False`` (GON over the masked full array) is device-path only.
    ``radius2`` is the squared covering radius over all points (the
    executor's streamed fold on the streamed loop). Keys, forms, ``chunk``
    and ``device`` are ``eim_sample``'s.

    Returns ``EIMResult(centers (k, d), radius2 (), sample)``;
    ``sample.sampled`` is False where n is too small for the loop to engage
    (EIM is then GON):

    >>> import numpy as np
    >>> x = np.random.default_rng(0).normal(size=(512, 3)).astype(np.float32)
    >>> res = eim(x, 8, 1, device="cpu")
    >>> tuple(res.centers.shape), bool(res.sample.sampled)
    ((8, 3), False)
    """
    compact_threshold = _check_compact_threshold(compact_threshold)
    if not _streamed(points, executor):
        return _eim_device(as_points(points, resolve_device(device)), k, key,
                           eps=eps, phi=phi, max_iters=max_iters, impl=impl,
                           chunk=chunk, compact=compact)
    if not compact:
        raise ValueError(
            "compact=False runs GON over the masked full array and needs "
            "it on the device; streamed EIM always compacts via "
            "source.take")
    source, executor = _stream_setup(points, executor, device)
    sample = _eim_sample_stream(source, k, key, eps=eps, phi=phi,
                                max_iters=max_iters, executor=executor,
                                impl=impl, chunk=chunk,
                                compact_threshold=compact_threshold)
    idx = np.nonzero(sample.sample_mask.numpy())[0]
    pop = len(idx)
    _check_sample_cap(pop, int(sample.s_mask.sum()), source.n, k, eps,
                      max_iters)
    if pop == source.n:
        # EIM is GON (the loop never engaged): stream GON over the source
        # rather than gather all of n
        res = gonzalez(source, k, impl=impl, chunk=chunk,
                       block_rows=(executor.rows_for(source)
                                   if hasattr(executor, "rows_for")
                                   else None),
                       device=executor.device)
    else:
        # the final round: C gathered to one machine, O(|C|) rows moved
        pts = upload(source.take(idx), executor.device)
        res = _compact_gonzalez(pts, pop, _compact_cap(pop, source.n), k,
                                impl=impl, chunk=chunk)
    r2 = executor.radius2(source, res.centers, impl=impl, chunk=chunk)
    return EIMResult(res.centers, r2, sample)


# ---------------------------------------------------------------------------
# device path: masks over the (n, d) points on the device, a host loop
# ---------------------------------------------------------------------------

def _s_buffer(new_s: torch.Tensor, s_cap: int):
    """The fixed S buffer of an iteration, without a synchronising
    ``nonzero``: ``(s_idx (s_cap,) int64, dropped () int32)``.

    Sampled row i goes to slot ``cumsum(new_s)[i] - 1``, so the first
    sampled rows fill the buffer in order; rows past ``s_cap`` are dropped
    and counted, empty slots hold ``n``. Bitwise the JAX package's
    ``jnp.nonzero(new_s, size=s_cap, fill_value=n)``. Rows that take no
    slot are written to slots of their own past the buffer, so no two
    writes meet."""
    n = new_s.shape[0]
    dev = new_s.device
    rows = torch.arange(n, device=dev)
    pos = torch.cumsum(new_s, 0) - 1
    keep = new_s & (pos < s_cap)
    buf = torch.full((s_cap + n,), n, dtype=torch.int64, device=dev)
    buf.scatter_(0, torch.where(keep, pos, s_cap + rows), rows)
    dropped = (new_s.sum() - keep.sum()).to(torch.int32)
    return buf[:s_cap], dropped


def _eim_sample_device(points: torch.Tensor, k: int, key, *, eps: float,
                       phi: float, max_iters: int, impl: str,
                       chunk: int | None) -> EIMSample:
    """The device path: ``r_mask``, ``s_mask``, ``d_s`` and the overflow
    count stay on the device; the host holds the key, the iteration count
    and ``|R|``, read once an iteration for the loop condition."""
    n = points.shape[0]
    dev = points.device
    points = points.to(torch.float32)
    _, threshold, s_cap, _, rank, num_s, num_h = _params(n, k, eps, phi)
    r_mask = torch.ones((n,), dtype=torch.bool, device=dev)
    s_mask = torch.zeros((n,), dtype=torch.bool, device=dev)
    d_s = torch.full((n,), float(_BIG), dtype=torch.float32, device=dev)
    ovf = torch.zeros((), dtype=torch.int32, device=dev)
    key = engine.key_words(key)
    it = 0
    while True:
        # the loop condition in f32, as the JAX package's while_loop has it
        r_size = np.float32(int(r_mask.sum().item()))
        if not (r_size > np.float32(threshold) and it < max_iters):
            break
        key, k_s, k_h = engine.split_key(key, 3)

        # --- Round 1: independent sampling within R (Alg. 2, lines 3-4) ---
        p_s = np.minimum(np.float32(num_s) / r_size, np.float32(1.0))
        p_h = np.minimum(np.float32(num_h) / r_size, np.float32(1.0))
        new_s = engine.bernoulli_rows(k_s, 0, n, p_s, dev) & r_mask
        h_mask = engine.bernoulli_rows(k_h, 0, n, p_h, dev) & r_mask
        s_idx, dropped = _s_buffer(new_s, s_cap)
        ovf += dropped
        s_valid = s_idx < n
        s_pts = points[s_idx.clamp_max(n - 1)]                # (s_cap, d)

        # Incremental d(x, S) against the new members only (the paper's
        # Round-3 O(|R|·|S|/m) term); empty slots sit at a far coordinate
        # and never win. An iteration that sampled nothing leaves d_s as
        # it was (the JAX package's any(s_valid) gate).
        far_pts = torch.where(s_valid[:, None], s_pts, 1e18)
        _, d_new = ops.assign_nearest(points, far_pts, impl=impl, chunk=chunk)
        d_s = torch.where(s_valid.any(), torch.minimum(d_s, d_new), d_s)

        s_mask |= new_s
        r_mask &= ~new_s         # §4.1: sampled points always leave R

        # --- Round 2: Select(H, S) (Alg. 3) ----------------------------
        top = torch.topk(torch.where(h_mask, d_s, float(_NEG)), rank).values
        pivot = top[rank - 1]                                # d(v, S)^2
        # fewer than `rank` rows in H: no removal by distance this time
        pivot = torch.where(pivot <= float(_NEG / np.float32(2)), -1.0, pivot)

        # --- Round 3: filter R (Alg. 2, lines 7-8) ----------------------
        r_mask &= ~(d_s <= pivot)
        it += 1
    return EIMSample(r_mask | s_mask, s_mask, torch.tensor(it, dtype=torch.int32),
                     ovf, torch.tensor(bool(n > threshold)))


def _eim_device(points: torch.Tensor, k: int, key, *, eps, phi, max_iters,
                impl, chunk, compact) -> EIMResult:
    """Device-path ``eim``: the sample, one read of its masks for the
    compaction, the final GON and the radius on the device."""
    n = points.shape[0]
    dev = points.device
    sample = _eim_sample_device(points, k, key, eps=eps, phi=phi,
                                max_iters=max_iters, impl=impl, chunk=chunk)
    if compact:
        masks = torch.stack([sample.sample_mask, sample.s_mask]).cpu().numpy()
        idx = np.nonzero(masks[0])[0]
        pop = len(idx)
        _check_sample_cap(pop, int(masks[1].sum()), n, k, eps, max_iters)
        pts = points.index_select(0, upload(idx, dev))
        res = _compact_gonzalez(pts, pop, _compact_cap(pop, n), k,
                                impl=impl, chunk=chunk)
    else:
        res = gonzalez(points, k, mask=sample.sample_mask, impl=impl,
                       chunk=chunk, device=dev)
    # the squared fold itself: a sqrt -> square round trip is lossy in f32
    _, d2 = ops.assign_nearest(points, res.centers, impl=impl, chunk=chunk)
    return EIMResult(res.centers, d2.max(), sample)


# ---------------------------------------------------------------------------
# streamed loop: host-resident relations, Executor.run_filter_round
# ---------------------------------------------------------------------------

def _eim_sample_stream(source, k: int, key, *, eps: float, phi: float,
                       max_iters: int, executor: Executor,
                       impl: str = "auto", chunk: int | None = None,
                       compact_threshold: float = 0.5) -> EIMSample:
    """Out-of-core Algorithm 2, the MapReduce form.

    The relations live on the host (``r_mask``, ``s_mask`` bools and
    ``d_s`` f32: O(n) bytes); the (n, d) points stay where the source keeps
    them. An iteration is Round 1, the counter-based draws on the device
    copied back with one wait, and only the |S_new| sampled rows fetched by
    ``source.take``; then Rounds 2-3, one fold (``run_filter_round``) over
    the current view, whose pivot read is its one synchronising call; the
    Round-3 filter is a host mask update."""
    if type(executor).run_filter_round is Executor.run_filter_round:
        # fail before the loop does any work
        raise NotImplementedError(
            f"{type(executor).__name__} does not implement EIM's "
            "run_filter_round; use HostStreamExecutor (streamed), "
            "SimExecutor (simulated machines) or MeshExecutor (sharded)")
    n = source.n
    _, threshold, s_cap, _, rank, num_s, num_h = _params(n, k, eps, phi)
    rows = (executor.rows_for(source) if hasattr(executor, "rows_for")
            else engine.resolve_block_rows(n, source.d))
    r_mask = np.ones(n, bool)
    s_mask = np.zeros(n, bool)
    d_s = np.full(n, _BIG, np.float32)
    try:
        iters, overflow = _stream_loop(
            source, executor, engine.key_words(key), r_mask, s_mask, d_s,
            threshold, s_cap, rank, num_s, num_h, rows, max_iters, impl,
            chunk, compact_threshold)
    finally:
        # release per-source state kept across the rounds (SimExecutor's
        # blocked copy)
        executor.end_filter_rounds(source)
    return EIMSample(torch.from_numpy(r_mask | s_mask),
                     torch.from_numpy(s_mask),
                     torch.tensor(iters, dtype=torch.int32),
                     torch.tensor(overflow, dtype=torch.int32),
                     torch.tensor(bool(n > threshold)))


def _stream_loop(source, executor, key, r_mask, s_mask, d_s, threshold,
                 s_cap, rank, num_s, num_h, rows, max_iters, impl, chunk,
                 compact_threshold):
    """The loop of ``_eim_sample_stream`` (updates the host relations in
    place; returns ``(iterations, overflow)``).

    ``view_idx`` is ``None`` for the identity view (every pass touches all
    n rows), else the sorted original rows of the current
    ``IndexedSource`` view, with ``d_view`` the matching slice of ``d_s``.
    R is always a subset of the view (views are made from R, and R only
    shrinks), so sampling, H and the filter see the rows a full pass
    would."""
    n = source.n
    dev = executor.device
    overflow = 0
    it = 0
    view = source
    view_idx = None
    d_view = d_s
    while (np.float32(int(r_mask.sum())) > np.float32(threshold)
           and it < max_iters):
        key, k_s, k_h = engine.split_key(key, 3)
        r_size = np.float32(int(r_mask.sum()))
        p_s = np.minimum(np.float32(num_s) / r_size, np.float32(1.0))
        p_h = np.minimum(np.float32(num_h) / r_size, np.float32(1.0))

        # --- Round 1: counter-based sampling, no data pass --------------
        # keyed by the original row, so compaction does not change a draw
        if view_idx is None:
            masks = _bernoulli_masks(((k_s, p_s), (k_h, p_h)), n, None, rows,
                                     dev)
            new_s = masks[0] & r_mask
            h_view = masks[1] & r_mask
            s_idx = np.nonzero(new_s)[0]
        else:
            sub_r = r_mask[view_idx]
            masks = _bernoulli_masks(((k_s, p_s), (k_h, p_h)), view_idx.size,
                                     view_idx, rows, dev)
            new_s = masks[0] & sub_r
            h_view = masks[1] & sub_r
            s_idx = view_idx[new_s]
        # The device path's S buffer drops samples past s_cap, first row
        # first; the same here, counted. The gathered rows are padded to
        # s_cap with the far sentinel (never nearest), so every round's
        # centers have one shape.
        overflow += max(0, len(s_idx) - s_cap)
        s_new = None
        if len(s_idx):
            taken = source.take(s_idx[:s_cap])
            pad = s_cap - taken.shape[0]
            s_new = (taken if pad == 0 else np.concatenate(
                [taken, np.full((pad, taken.shape[1]), 1e18, np.float32)]))
        # §4.1: sampled points always leave R
        if view_idx is None:
            s_mask |= new_s
            r_mask &= ~new_s
        else:
            s_mask[s_idx] = True
            r_mask[s_idx] = False

        # --- Rounds 2-3: d(x, S) update and the pivot, one fold ---------
        d_view, pivot = executor.run_filter_round(view, s_new, d_view,
                                                  h_view, rank, impl=impl,
                                                  chunk=chunk)
        if view_idx is None:
            r_mask &= ~(d_s <= pivot)      # d_view is d_s here
        else:
            r_mask[view_idx[d_view <= pivot]] = False
        it += 1

        # --- compact the relation between iterations (§4's shrinking R) -
        live = int(r_mask.sum())
        if np.float32(live) <= np.float32(threshold):
            break                          # the loop is over
        cur = n if view_idx is None else len(view_idx)
        # Several processes never compact: an IndexedSource view would read
        # its blocks through the collective ProcessShardedSource.take with
        # different rows on each process. The sample does not depend on it.
        if (live < compact_threshold * cur and live < cur
                and compat.process_count() == 1):
            if view is not source:
                executor.end_filter_rounds(view)
            if view_idx is not None:
                d_s[view_idx] = d_view     # the view's state back first
            view_idx = np.nonzero(r_mask)[0]
            view = IndexedSource(source, view_idx)
            d_view = d_s[view_idx]
    if view is not source:
        executor.end_filter_rounds(view)
    return it, overflow


def _bernoulli_masks(draws, size: int, idx, rows: int,
                     device: torch.device) -> np.ndarray:
    """Host masks ``(len(draws), size)`` of per-row Bernoulli(p) draws, one
    row per ``(key, p)`` of ``draws``: over the rows ``[0, size)``
    (``idx=None``, ``_bernoulli_mask``) or at the original rows ``idx``
    (``_bernoulli_mask_at``). Drawn on ``device`` in blocks of at most
    ``min(rows, SAMPLE_ROWS)`` rows, each copied back into one pinned
    buffer without a wait; the one wait is at the end."""
    out = torch.empty((len(draws), size), dtype=torch.bool,
                      pin_memory=device.type == "cuda")
    step = max(1, min(rows, SAMPLE_ROWS))
    for j, (key, p) in enumerate(draws):
        if idx is None:
            _bernoulli_mask(key, size, p, step, device, out[j])
        else:
            _bernoulli_mask_at(key, idx, p, step, device, out[j])
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return out.numpy()


def _bernoulli_mask(key, n: int, p: np.float32, rows: int, device,
                    out: torch.Tensor) -> None:
    """Bernoulli(p) draws of the rows ``[0, n)`` into ``out (n,)``, in
    ``rows``-row blocks on ``device``."""
    for start in range(0, n, rows):
        nb = min(rows, n - start)
        out[start:start + nb].copy_(engine.bernoulli_rows_block(
            key, start & 0xFFFFFFFF, start >> 32, nb, p, device),
            non_blocking=True)


def _bernoulli_mask_at(key, idx: np.ndarray, p: np.float32, rows: int,
                       device, out: torch.Tensor) -> None:
    """Bernoulli(p) draws at the original rows ``idx`` (a compacted view's
    survivors) into ``out (idx.size,)``: draw i is bitwise the full-range
    draw of row ``idx[i]``."""
    for start in range(0, idx.size, rows):
        lo, hi = engine.split_index_words(idx[start:start + rows])
        out[start:start + lo.size].copy_(engine.bernoulli_rows_at_block(
            key, lo, hi, p, device), non_blocking=True)
