"""The machine mesh (port of ``repro.launch.mesh`` and the mesh half of
``repro.compat``).

A ``Mesh`` names the paper's machines: an ordered mapping of axis names to
sizes, the process that owns each position (``owners``) and this process's
device. ``make_mesh`` builds a mesh of one process: every position is the
same ``torch.device`` — the card by default, or ``"cpu"`` when asked — so
50 machines on one H100 are 50 shards on ``cuda:0``, as the JAX package's
CPU tests put 8 shards on 8 forced host devices.

``make_cluster_mesh`` builds the mesh of a multi-process run
(``repro_torch.launch.cluster``, ``repro_torch.compat``): one shard axis
over every process's positions, process-major, so shard ``s`` belongs to
process ``s // shards_per_process``. Each process keeps its own positions
on its own device (``cuda:{rank % device_count}``; processes may share one
card) and reads only its own shards; the mesh executor exchanges host
values between the processes.

In one process the executors exchange values between positions through two
collectives, kept here as small functions:

  * ``all_gather(parts, axis)`` — the tiled all-gather along one mesh axis;
  * ``all_max(parts)`` — the max over every position.

Their operands are values held per position, stacked: a leading ``grid``
of one dim per shard axis (size 1 along an axis whose members already hold
the same value, so each distinct value is computed once), then the value.

The LM's meshes (``make_production_mesh``, ``make_elastic_mesh``,
``make_process_mesh``) are the same ``Mesh`` with one process a position:
``owners`` is the process-group rank at each position, row-major. Such a
mesh carries a ``torch.distributed`` ``DeviceMesh`` over those ranks with
the same axis names (``device_mesh``, built on first use), on which
``repro_torch.sharding`` places DTensors; ``use_mesh`` and ``MeshExecutor``
both take the one object. The production shapes are the reference's, so
that the port's placements compare one to one with its specs; a dry-run
builds them over a fake process group of 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg``).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import compat
from repro_torch.device import resolve_device


class Mesh:
    """``shape`` (axis → size, in ``axis_names`` order), ``axis_names``,
    ``device`` (this process's), ``owners`` (the process of every position,
    an int array of the mesh's shape; all 0 by default, a mesh of one
    process) and ``devices`` (every position's device, ``None`` at the
    positions of other processes). ``device=None`` means ``"cuda"`` and
    raises where there is none.

    >>> m = Mesh((2, 3), ("pod", "data"), device="cpu")
    >>> dict(m.shape), m.devices.shape, m.processes
    ({'pod': 2, 'data': 3}, (2, 3), 1)
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 device=None, owners=None):
        sizes = tuple(int(s) for s in shape)
        axes = tuple(str(a) for a in axis_names)
        if len(sizes) != len(axes):
            raise ValueError(f"mesh shape {sizes} has {len(sizes)} axes but "
                             f"{len(axes)} names were given: {axes}")
        if len(set(axes)) != len(axes):
            raise ValueError(f"mesh axis names repeat: {axes}")
        if any(s < 1 for s in sizes):
            raise ValueError(f"mesh axis sizes must be >= 1, got {sizes}")
        if owners is None:
            owners = np.zeros(sizes, np.int64)
        owners = np.asarray(owners, np.int64)
        if owners.shape != sizes or owners.min() < 0:
            raise ValueError(f"owners must be process ids of the mesh's shape "
                             f"{sizes}, got shape {owners.shape}")
        self.axis_names = axes
        self.shape = OrderedDict(zip(axes, sizes))
        self.owners = owners
        self.device = resolve_device(device)
        self._device_mesh = None

    @property
    def size(self) -> int:
        """Positions in the mesh."""
        return int(self.owners.size)

    @property
    def device_mesh(self):
        """The ``DeviceMesh`` over the ranks in ``owners`` (one process a
        position), with the mesh's axis names; built on first use, by every
        process of the group (a collective)."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh
            if len(np.unique(self.owners)) != self.size:
                raise ValueError("a DeviceMesh needs one process a position; "
                                 f"this mesh's owners are {self.owners.tolist()}")
            self._device_mesh = DeviceMesh(self.device.type,
                                           torch.from_numpy(self.owners),
                                           mesh_dim_names=self.axis_names)
        return self._device_mesh

    @property
    def coordinate(self) -> tuple:
        """This process's position in the mesh (one index an axis)."""
        at = np.argwhere(self.owners == compat.process_index())
        if not len(at):
            raise ValueError(f"process {compat.process_index()} holds no "
                             "position of this mesh")
        return tuple(int(i) for i in at[0])

    @property
    def processes(self) -> int:
        """Processes the mesh spans."""
        return int(self.owners.max()) + 1

    @property
    def devices(self) -> np.ndarray:
        """The device of each position, shaped like the mesh: this
        process's device at its own positions, ``None`` at other
        processes'."""
        out = np.empty(tuple(self.shape.values()), dtype=object)
        out[self.owners == compat.process_index()] = self.device
        return out


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device=None) -> Mesh:
    """A mesh of one process, ``shape`` over the named ``axes``, every
    position on ``device`` (``None`` means ``"cuda"``; raises where there is
    none).

    >>> make_mesh((4, 2), ("data", "model"), device="cpu").shape["data"]
    4
    """
    return Mesh(shape, axes, device=device)


def make_process_mesh(shape: Sequence[int], axes: Sequence[str], *,
                      ranks: Optional[Sequence[int]] = None,
                      device=None) -> Mesh:
    """A mesh of one process a position: ``shape`` over the first
    prod(shape) of ``ranks`` (default: every rank of the process group, in
    order), row-major. ``device`` is this process's (``None``: its card,
    ``cuda:{rank % device_count}``). In one process without a group, a
    mesh of shape (1, ...) on that device.

    >>> make_process_mesh((1, 1), ("data", "model"), device="cpu").size
    1
    """
    n = int(np.prod(shape))
    ranks = list(range(compat.process_count())) if ranks is None else list(ranks)
    if len(ranks) < n:
        raise ValueError(f"need {n} processes, have {len(ranks)}")
    owners = np.asarray(ranks[:n], np.int64).reshape(tuple(shape))
    return Mesh(shape, axes, device=_cluster_device(device), owners=owners)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The 16×16 production mesh ``("data", "model")``, or 2×16×16
    ``("pod", "data", "model")`` across two pods, over the first 256 or
    512 ranks (so a 256-position mesh builds on a 512-rank dry-run
    group)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_process_mesh(shape, axes, device=device)


def make_elastic_mesh(model_parallel: int = 16,
                      devices: Optional[Sequence[int]] = None, *,
                      device=None) -> Mesh:
    """Largest (data, model) grid over the *live* ranks (``devices``:
    default every rank of the process group) — the elastic restart path: a
    degraded pod (e.g. 448 of 512) still yields a valid mesh; mp =
    min(model_parallel, n), lowered until it divides n, and the
    data-parallel size shrinks to fit. One process: (1, 1)."""
    ranks = list(range(compat.process_count())) if devices is None else list(devices)
    n = len(ranks)
    mp = min(model_parallel, n)
    while n % mp:
        mp -= 1
    return make_process_mesh((n // mp, mp), ("data", "model"), ranks=ranks,
                             device=device)


def _cluster_device(device=None) -> torch.device:
    """This process's device in a multi-process run: ``None`` means its
    card, ``cuda:{rank % device_count}`` (raises where there is none), made
    the current CUDA device; anything else as ``resolve_device`` takes it."""
    if device is None and torch.cuda.is_available():
        device = f"cuda:{compat.process_index() % torch.cuda.device_count()}"
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    return dev


def make_cluster_mesh(axes: Sequence[str] = ("data",), *,
                      shards_per_process: int = 1, device=None) -> Mesh:
    """The mesh of a multi-process run: one shard axis over
    ``process_count() × shards_per_process`` positions, process-major, so
    process p owns shards ``[p·spp, (p+1)·spp)`` (the layout
    ``ProcessShardedSource.for_process`` builds). ``device`` is this
    process's: ``None`` is its card, ``cuda:{rank % device_count}``, made
    the current CUDA device.

    Every process must call it, with the same ``shards_per_process``: the
    processes check that they build one mesh (a collective), so a partition
    fault fails here and not as processes that diverge later. One axis
    only. In one process it is a mesh of ``shards_per_process`` positions,
    as ``make_mesh`` builds it.

    >>> m = make_cluster_mesh(shards_per_process=2, device="cpu")
    >>> m.shape["data"], m.owners.tolist()
    (2, [0, 0])
    """
    axes = tuple(axes)
    if len(axes) != 1:
        raise ValueError(
            f"make_cluster_mesh builds a single sharding axis, got {axes}")
    spp = int(shards_per_process)
    if spp < 1:
        raise ValueError(f"shards_per_process must be >= 1, got {spp}")
    every = compat.exchange_host(np.asarray([spp], np.int64))[:, 0]
    if (every != spp).any():
        raise ValueError(
            f"the processes ask for different meshes: shards_per_process "
            f"{every.tolist()} by process; the mesh must cover every process "
            "with one layout")
    count = compat.process_count()
    owners = np.repeat(np.arange(count, dtype=np.int64), spp)
    return Mesh((count * spp,), axes, device=_cluster_device(device),
                owners=owners)


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
