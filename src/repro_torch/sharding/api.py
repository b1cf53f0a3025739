"""Mesh-context sharding API (port of ``repro.sharding.api``).

Model code calls ``constrain(x, *spec)`` at layout-relevant points; the
constraint is a no-op unless a mesh of more than one position has been
installed via ``use_mesh`` (so single-device runs execute the exact same
model code, and add no kernel). Axis *logical names* are fixed:

  dp    — batch/data parallel axes, ("pod","data") on the multi-pod mesh
  tp    — tensor-parallel axis, "model"
  none  — replicated

A logical spec resolves to DTensor placements, one per mesh dimension
(``spec``): a mesh dimension that shards tensor dim ``i`` is ``Shard(i)``,
every other ``Replicate()``; logical axes the mesh lacks are dropped (a
single-pod mesh has no "pod"). ``constrain`` redistributes a DTensor to
those placements. The model itself runs on local tensors (each process
holds its data-parallel rows, whole; ``sharding.runtime``), which pass
through ``constrain`` unchanged: the calls mark where the reference lays
out its activations, and act on the DTensors the entry points return.
"""
from __future__ import annotations

import contextlib
import types
from typing import NamedTuple, Optional

# Process-wide, not a thread's: autograd runs a CUDA backward (and so each
# rematerialised layer's recompute, which reads the mesh) on a thread of
# its own.
_state = types.SimpleNamespace(mesh=None)

DP_AXES = ("pod", "data")
TP_AXIS = "model"


def current_mesh():
    """The installed mesh (a ``launch.mesh.Mesh``), or None."""
    return _state.mesh


@contextlib.contextmanager
def use_mesh(mesh):
    """Install ``mesh`` for the duration; model sharding constraints apply."""
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def active_mesh():
    """The installed mesh where it has more than one position, else None:
    the condition under which the port shards anything."""
    mesh = current_mesh()
    return mesh if mesh is not None and mesh.size > 1 else None


def _resolve_axis(mesh, logical) -> Optional[object]:
    """logical axis entry -> physical mesh axis name(s) or None."""
    if logical is None:
        return None
    if logical == "dp":
        axes = tuple(a for a in DP_AXES if a in mesh.axis_names)
        if not axes:
            return None
        return axes if len(axes) > 1 else axes[0]
    if logical == "tp":
        return TP_AXIS if TP_AXIS in mesh.axis_names else None
    # already-physical name or tuple of names
    if isinstance(logical, (tuple, list)):
        axes = tuple(a for a in logical if a in mesh.axis_names)
        return axes or None
    return logical if logical in mesh.axis_names else None


def resolve(mesh, *logical) -> tuple:
    """The physical spec: one entry per tensor dim, a mesh axis name, a
    tuple of them or None (the reference's ``PartitionSpec`` entries)."""
    return tuple(_resolve_axis(mesh, entry) for entry in logical)


def placements(mesh, resolved) -> tuple:
    """A physical spec as DTensor placements, one per mesh dimension: the
    dimension that shards tensor dim ``i`` is ``Shard(i)``, every other
    ``Replicate()``. A tensor dim sharded over several axes is split over
    them in mesh order, as the reference's ``("pod", "data")``."""
    from torch.distributed.tensor import Replicate, Shard
    owner = {}
    for i, entry in enumerate(resolved):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                owner[axis] = i
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in mesh.axis_names)


def spec(mesh, *logical) -> tuple:
    """Logical ``dp``/``tp``/None entries -> placements on ``mesh``."""
    return placements(mesh, resolve(mesh, *logical))


class NamedSharding(NamedTuple):
    """Placements on a mesh: the counterpart of ``jax.sharding.NamedSharding``."""
    mesh: object
    placements: tuple


def named_sharding(mesh, *logical) -> NamedSharding:
    return NamedSharding(mesh, spec(mesh, *logical))


def constrain(x, *logical):
    """Redistribute a DTensor to the logical spec under the installed mesh;
    a no-op without a mesh, on a mesh of one position, or on a local
    tensor."""
    mesh = active_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    want = spec(mesh, *logical)
    return x if tuple(x.placements) == want else x.redistribute(
        mesh.device_mesh, want)


def constrain_seq(x, seq_axis: int = 1):
    """Sequence-parallel residual constraint: shard the sequence dim over
    tp between layer regions (Megatron-SP). No-op when the mesh lacks tp
    or the sequence doesn't divide (decode S=1)."""
    mesh = active_mesh()
    if mesh is None or TP_AXIS not in mesh.axis_names:
        return x
    tp = mesh.shape[TP_AXIS]
    if tp <= 1 or x.shape[seq_axis] % tp != 0 or x.shape[seq_axis] < tp:
        return x
    logical = [None] * x.dim()
    logical[0] = "dp"
    logical[seq_axis] = "tp"
    return constrain(x, *logical)
