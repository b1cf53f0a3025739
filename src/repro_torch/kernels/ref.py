"""Plain PyTorch versions of the k-center distance kernels.

These are the semantics contracts of the port, as ``repro.kernels.ref`` is
for the JAX package: each CUDA kernel is held against them on the card, and
they run whenever a tensor lies on the CPU. Their arithmetic follows the
JAX oracles operation by operation, so on the CPU they agree with them
bitwise on exact-arithmetic inputs. On the CPU the clamped decomposition
is computed pair by pair (``_per_pair_dist2``), so a row's distances do not
depend on the other rows and centers of the call.

All distances are *squared* Euclidean; indices are int32.
"""
from __future__ import annotations

import numpy as np
import torch

# The JAX package's sentinels, bitwise: +-3.4e38 as float32.
BIG = float(np.float32(3.4e38))
NEG = float(np.float32(-3.4e38))
# Rows per tile of the fused filter (csrc/fused_filter.cu: one CUDA block).
# Per-tile top-k values depend on it; their merge over tiles does not.
FILTER_TILE_ROWS = 256


def dist2_to_center(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared distances from every row of ``x (..., n, d)`` to the matching
    center ``c (..., d)``, by the direct form ``sum((x - c)^2)``."""
    diff = x - c.unsqueeze(-2)
    return (diff * diff).sum(-1)


def pairwise_dist2(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared distances ``(..., n, m)`` between rows of ``x (..., n, d)``
    and ``c (..., m, d)`` by the clamped decomposition ``|x|^2 + |c|^2 -
    2 x.c^T`` (leading axes are machines, matched pairwise): pair by pair
    on the CPU, one matrix product on the card."""
    if not x.is_cuda:
        return _per_pair_dist2(x, c)
    xn = (x * x).sum(-1, keepdim=True)                       # (..., n, 1)
    cn = (c * c).sum(-1, keepdim=True).transpose(-1, -2)     # (..., 1, m)
    d2 = xn + cn - 2.0 * (x @ c.transpose(-1, -2))
    return torch.clamp_min(d2, 0.0)


def fused_min_argmax(x: torch.Tensor, c: torch.Tensor, md: torch.Tensor, *,
                     centers=None, indices=None, slot: int = -1, carry=None,
                     off: int = 0, reset: bool = False):
    """One Gonzalez iteration on each of m machine blocks.

    ``x (m, per, d)``, the new centers ``c (m, d)`` and the running
    min-squared-distances ``md (m, per)``. Updates ``md`` in place to
    ``min(md, |x - c|^2)`` (as the CUDA kernel does) and returns
    ``(md, far_val (m,), far_idx (m,) int32)``: per machine, the farthest
    row under the updated distances, first occurrence on ties.

    The next center is written on the device, as the kernel writes it:
    with a ``carry = (best_v (m,), best_i (m,) int64, best_row (m, d))``
    (a streamed pass over blocks whose row 0 is global row ``off``) the far
    point replaces the carry when ``reset`` (the pass's first block) or
    on strict ``far_val > best_v``, so the earliest block keeps a tie; with
    ``centers (m, k, d)`` and ``indices (m, k)`` int32, slot ``slot`` (when
    ``0 <= slot < k``) gets the far row ``x[b, far_idx]`` and its index
    ``off + far_idx``, or the carry's after the fold. ``c`` must not alias
    that slot.
    """
    torch.minimum(md, dist2_to_center(x, c), out=md)
    idx = torch.argmax(md, dim=-1)
    val = md.gather(-1, idx.unsqueeze(-1)).squeeze(-1)
    return gon_write(x, md, val, idx, centers=centers, indices=indices,
                     slot=slot, carry=carry, off=off, reset=reset)


def gon_write(x: torch.Tensor, md: torch.Tensor, val: torch.Tensor,
              idx: torch.Tensor, *, centers=None, indices=None, slot: int = -1,
              carry=None, off: int = 0, reset: bool = False):
    """The write half of ``fused_min_argmax``: given each machine's far
    point ``(val, idx)`` under the updated ``md``, fold it into ``carry``
    and write the next center into ``centers``/``indices`` as described
    there. Returns ``(md, val, idx int32)``."""
    write = centers is not None and 0 <= slot < centers.shape[1]
    if carry is not None or write:
        row = x.gather(1, idx.view(-1, 1, 1).expand(-1, 1, x.shape[2]))[:, 0]
        gidx = idx + off
    if carry is not None:
        best_v, best_i, best_row = carry
        take = torch.ones_like(val, dtype=torch.bool) if reset else val > best_v
        best_v.copy_(torch.where(take, val, best_v))
        best_i.copy_(torch.where(take, gidx, best_i))
        best_row.copy_(torch.where(take[:, None], row, best_row))
        row, gidx = best_row, best_i
    if write:
        centers[:, slot] = row
        indices[:, slot] = gidx.to(torch.int32)
    return md, val, idx.to(torch.int32)


def _per_pair_dist2(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``pairwise_dist2`` with each entry computed from its row and center
    alone, in the order of the CUDA kernels' ``csrc/dist2.cuh``: the norms
    summed in j order, the dot product a chain of ``addcmul_`` in j order
    from 0, then ``max((|x|^2 + |c|^2) - 2 x.c, 0)``. A matrix product on
    the CPU rounds as the BLAS kernel that its shape selects (a
    matrix-vector routine at one row or one center, others at few
    centers), so a row's distances would depend on how many rows and
    centers share the call: a served query would round otherwise alone
    than coalesced with others."""
    xn = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    cn = torch.zeros(c.shape[:-1], dtype=c.dtype, device=c.device)
    dot = torch.zeros(x.shape[:-1] + c.shape[-2:-1], dtype=x.dtype,
                      device=x.device)
    for j in range(x.shape[-1]):
        xj, cj = x[..., j], c[..., j]
        xn = xn + xj * xj
        cn = cn + cj * cj
        dot.addcmul_(xj.unsqueeze(-1), cj.unsqueeze(-2))
    return torch.clamp_min(xn.unsqueeze(-1) + cn.unsqueeze(-2) - 2.0 * dot, 0.0)


def assign_nearest(x: torch.Tensor, c: torch.Tensor):
    """Nearest center of every row: ``(idx (n,) int32, d2 (n,))``, first
    occurrence on ties. Batched, ``x (m, per, d)`` against each machine's
    own centers ``c (m, k, d)`` gives ``(m, per)`` results. On the CPU a
    row's result is bitwise the same whatever other rows share the call
    (padded and coalesced query batches, row chunks), as the CUDA kernel's
    is on the card."""
    d2 = pairwise_dist2(x, c)
    idx = torch.argmin(d2, dim=-1)
    return idx.to(torch.int32), d2.gather(-1, idx.unsqueeze(-1)).squeeze(-1)


def assign_sums(x: torch.Tensor, c: torch.Tensor, sums: torch.Tensor,
                w: torch.Tensor | None = None) -> torch.Tensor:
    """Add each row's weight into the slot of its nearest center, in place:
    ``sums (k,)`` f32 with row weights ``w (n,)``, or int32 counts (1 a
    row) with ``w=None``; machine blocks ``x (m, per, d)`` against their own
    ``c (m, k, d)`` add into ``sums (m, k)``. Returns ``sums``. The plain
    assign, then ``index_add_`` (the JAX package's ``.at[idx].add``), which
    adds in order on the CPU and by atomics on the card: bitwise wherever
    every partial sum is exact, as integer weights below 2^24 and counts
    are."""
    idx = assign_nearest(x, c)[0]
    if idx.dim() == 2:       # machine b's slots are [b·k, (b+1)·k)
        m, k = sums.shape
        idx = idx + torch.arange(0, m * k, k, dtype=torch.int32,
                                 device=idx.device)[:, None]
    vals = torch.ones_like(idx) if w is None else w
    # int32 indices: no int64 copy of a super-shard's assignment
    sums.view(-1).index_add_(0, idx.reshape(-1), vals.reshape(-1))
    return sums


def fused_filter(x: torch.Tensor, c: torch.Tensor, ds=None, hm=None, *,
                 rank: int, w=None):
    """The streamed filter step on one block ``x (n, d)`` against the
    centers ``c (m, d)``: ``new_ds = min(ds, min_j d2(x, c_j))`` and, for
    each tile of ``FILTER_TILE_ROWS`` rows, the descending top-``rank`` of
    ``where(hm & (w > 0), new_ds, -3.4e38)``.

    ``ds (n,)`` is updated in place and returned; ``ds=None`` stands for
    +3.4e38 everywhere and returns ``None``. ``hm (n,)`` bool and the row
    weights ``w (n,)`` f32 gate top-k candidacy only (a row with ``w <= 0``
    is absent from the weighted instance, but its ``ds`` still updates);
    ``None`` means every row. Returns ``(ds, tops (ceil(n /
    FILTER_TILE_ROWS), rank))``; slots past a tile's candidates hold
    -3.4e38, so any ``rank >= 1`` is taken."""
    n = x.shape[0]
    d2 = pairwise_dist2(x, c).amin(-1)
    if ds is None:
        new = torch.minimum(torch.full_like(d2, BIG), d2)
    else:
        new = torch.minimum(ds, d2, out=ds)
    sel = hm
    if w is not None:
        sel = w > 0 if sel is None else sel & (w > 0)
    cand = new if sel is None else torch.where(sel, new, NEG)
    tile = FILTER_TILE_ROWS
    ntiles = -(-n // tile)
    pad = torch.full((ntiles * tile - n,), NEG, dtype=cand.dtype,
                     device=cand.device)
    cand = torch.cat([cand, pad]).view(ntiles, tile)
    r = min(rank, tile)
    tops = torch.topk(cand, r, dim=1).values
    if rank > r:
        fill = torch.full((ntiles, rank - r), NEG, dtype=tops.dtype,
                          device=tops.device)
        tops = torch.cat([tops, fill], dim=1)
    return ds, tops


def fused_argmin(x: torch.Tensor, c: torch.Tensor):
    """For each center of ``c (m, d)``, the nearest row of ``x (n, d)``:
    ``(best_d (m,), best_i (m,) int32)``, first row on ties, ``(3.4e38,
    0)`` when ``x`` has no row."""
    if x.shape[0] == 0:
        return (torch.full((c.shape[0],), BIG, dtype=torch.float32,
                           device=c.device),
                torch.zeros((c.shape[0],), dtype=torch.int32, device=c.device))
    d2 = pairwise_dist2(x, c)                               # (n, m)
    idx = torch.argmin(d2, dim=0)
    return d2.gather(0, idx.unsqueeze(0)).squeeze(0), idx.to(torch.int32)
