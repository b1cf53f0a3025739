"""Gonzalez's greedy 2-approximation for k-center (paper §3.1, "GON").

Port of ``repro.core.gonzalez`` (in-memory form). Pick the first (valid)
point, then repeatedly the point farthest from the chosen set, k times.
Each iteration is one fused pass over the points: the GON-step kernel
(``kernels/fused_argfar.py``) on the card, its plain version on the CPU.

The JAX package maps GON over machine blocks with ``jax.vmap``; a
hand-written kernel cannot be vmapped, so ``_gonzalez_device`` runs m
machine blocks as a leading axis of one batched GON, and ``gonzalez`` on
one ``(n, d)`` array is its m = 1 case. The k-loop never reads a tensor
back to the host: the next center comes from the step's far index on the
device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import as_points, resolve_device
from repro_torch.kernels import ops

_NEG = np.float32(-3.4e38)  # sentinel: masked-out points can never be farthest
_BIG = np.float32(3.4e38)   # initial md of valid rows: min(_BIG, d2) == d2


class GonzalezResult(NamedTuple):
    centers: torch.Tensor   # (k, d) selected center coordinates
    indices: torch.Tensor   # (k,)  int32 indices into the input
    radius2: torch.Tensor   # ()    squared covering radius over valid points
    min_d2: torch.Tensor    # (n,)  final per-point squared distance to centers


def gonzalez(points, k: int, *, mask=None, first: int = 0,
             impl: str = "auto", chunk: int | None = None,
             device=None) -> GonzalezResult:
    """Run GON on ``points (n, d)``; optionally restricted to ``mask (n,)``.

    With a mask, invalid points are never selected and are excluded from
    the covering radius, and the first center is the first valid point
    (``first`` is then ignored). If fewer than ``k`` valid points exist,
    the remaining slots repeat covered points. ``radius2`` is the exact
    squared fold ``max(min_d2)``.

    ``device=None`` means ``"cuda"``; ``chunk`` (row-chunked passes) is not
    ported yet and raises.

    >>> import numpy as np
    >>> x = np.asarray([[0, 0], [1, 0], [10, 0], [10, 1]], np.float32)
    >>> res = gonzalez(x, 2, device="cpu")
    >>> [int(i) for i in res.indices]
    [0, 3]
    >>> float(res.radius2)
    1.0
    """
    if chunk is not None:
        raise NotImplementedError("chunk (row-chunked passes) is not ported yet")
    dev = resolve_device(device)
    x = as_points(points, dev)
    if mask is not None:
        mask = torch.as_tensor(mask, device=dev).to(torch.bool)[None]
    res = _gonzalez_device(x[None], k, mask=mask, first=first, impl=impl)
    return GonzalezResult(*(t[0] for t in res))


def _gonzalez_device(points: torch.Tensor, k: int, *, mask=None,
                     first: int = 0, impl: str = "auto") -> GonzalezResult:
    """Batched GON over machine blocks ``points (m, per, d)`` with an
    optional ``mask (m, per)``. Returns a ``GonzalezResult`` whose fields
    carry the machine axis in front: ``centers (m, k, d)``, ``indices
    (m, k)``, ``radius2 (m,)``, ``min_d2 (m, per)``."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    m, per, _ = points.shape
    points = points.to(torch.float32).contiguous()
    dev = points.device
    rows = torch.arange(m, device=dev)
    md = torch.full((m, per), float(_BIG), dtype=torch.float32, device=dev)
    if mask is None:
        if not -per <= first < per:
            raise IndexError(f"first={first} out of range for {per} points")
        first_idx = torch.full((m,), first % per, dtype=torch.int32, device=dev)
    else:
        # first valid point (ignores `first` when a mask is given)
        first_idx = torch.argmax(mask.to(torch.uint8), dim=1).to(torch.int32)
        md.masked_fill_(~mask, float(_NEG))

    # The initial pass is a GON step from md = +BIG (valid) / _NEG (masked):
    # it leaves md = d2 to the first center on valid rows, _NEG elsewhere.
    c = points[rows, first_idx]
    centers, indices = [c], [first_idx]
    md, _, far = ops.fused_min_argmax(points, c, md, impl=impl)
    for _ in range(1, k):
        # far == argmax(md), the index the reference recomputes here
        c = points[rows, far]
        centers.append(c)
        indices.append(far)
        md, _, far = ops.fused_min_argmax(points, c, md, impl=impl)

    radius2 = torch.where(md <= float(_NEG) / 2, 0.0, md).amax(dim=1)
    # masked-out points carry _NEG; clamp them to 0 for the covered-distance
    # vector we hand back.
    return GonzalezResult(torch.stack(centers, 1), torch.stack(indices, 1),
                          radius2, md.clamp_min(0.0))
