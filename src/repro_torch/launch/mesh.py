"""The machine mesh (port of ``repro.launch.mesh.make_mesh`` and the mesh
half of ``repro.compat``).

A ``Mesh`` names the paper's machines: an ordered mapping of axis names to
sizes, and the device of every position. In one process every position is
the same ``torch.device`` — the card by default, or ``"cpu"`` when asked —
so 50 machines on one H100 are 50 shards on ``cuda:0``, as the JAX package's
CPU tests put 8 shards on 8 forced host devices. Several GPUs are one
process each (PyTorch's idiom), which this module does not cover yet.

The executors exchange values between positions through two collectives,
kept here as small functions so that a multi-process mesh can replace them
with ``all_gather_into_tensor`` and ``all_reduce(MAX)``:

  * ``all_gather(parts, axis)`` — the tiled all-gather along one mesh axis;
  * ``all_max(parts)`` — the max over every position.

Their operands are values held per position, stacked: a leading ``grid``
of one dim per shard axis (size 1 along an axis whose members already hold
the same value, so each distinct value is computed once), then the value.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device


class Mesh:
    """``shape`` (axis → size, in ``axis_names`` order), ``axis_names`` and
    ``device``, every position's device (``devices``, an object array of the
    mesh's shape). ``device=None`` means ``"cuda"`` and raises where there
    is none.

    >>> m = Mesh((2, 3), ("pod", "data"), device="cpu")
    >>> dict(m.shape), m.devices.shape
    ({'pod': 2, 'data': 3}, (2, 3))
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 device=None):
        sizes = tuple(int(s) for s in shape)
        axes = tuple(str(a) for a in axis_names)
        if len(sizes) != len(axes):
            raise ValueError(f"mesh shape {sizes} has {len(sizes)} axes but "
                             f"{len(axes)} names were given: {axes}")
        if len(set(axes)) != len(axes):
            raise ValueError(f"mesh axis names repeat: {axes}")
        if any(s < 1 for s in sizes):
            raise ValueError(f"mesh axis sizes must be >= 1, got {sizes}")
        self.axis_names = axes
        self.shape = OrderedDict(zip(axes, sizes))
        self.device = resolve_device(device)

    @property
    def devices(self) -> np.ndarray:
        """The device of each position, shaped like the mesh."""
        out = np.empty(tuple(self.shape.values()), dtype=object)
        out.fill(self.device)
        return out


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device=None) -> Mesh:
    """A mesh of ``shape`` over the named ``axes``, every position on
    ``device`` (``None`` means ``"cuda"``; raises where there is none).

    >>> make_mesh((4, 2), ("data", "model"), device="cpu").shape["data"]
    4
    """
    return Mesh(shape, axes, device=device)


def all_gather(parts: torch.Tensor, axis: int) -> torch.Tensor:
    """Tiled all-gather along grid dim ``axis`` of per-position row sets
    ``parts (*grid, rows, d)``: every member of a group of positions that
    differ only along ``axis`` gets the concatenation of the group's rows
    in the axis's index order. The members then hold one value, so the
    result keeps that dim at size 1: ``(*grid[:axis], 1, *grid[axis+1:],
    grid[axis]·rows, d)``."""
    g = parts.dim() - 2
    if not 0 <= axis < g:
        raise ValueError(f"axis {axis} out of range for a {g}-dim grid")
    size, rows, d = parts.shape[axis], parts.shape[-2], parts.shape[-1]
    # the gathered dim next to the rows, the other grid dims in order
    moved = parts.movedim(axis, g - 1)
    out = moved.reshape(*moved.shape[:g - 1], size * rows, d)
    return out.unsqueeze(axis)


def all_max(parts: torch.Tensor) -> torch.Tensor:
    """The max over every position of per-position values ``parts
    (*grid)``, as a 0-d tensor (``pmax`` over every shard axis)."""
    return parts.amax()
