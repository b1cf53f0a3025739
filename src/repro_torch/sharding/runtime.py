"""Running the LM on a mesh of processes (one process a position).

The layout, for every family:
  * parameters and optimizer state are DTensors placed by the rules of
    ``specs`` (vocab and heads over tp, rows over dp: FSDP), so each
    process holds its shard only;
  * a layer gathers the parameters it uses where it uses them
    (``LocalView``: an all-gather over the mesh), inside the layer's
    rematerialised region, so its backward gathers them again. The
    gradient comes back through the gather's transpose, a reduce-scatter
    onto the parameter's shard;
  * activations are local tensors: each process holds its data-parallel
    rows of the batch (``local_batch``), whole, and the processes of one
    dp row compute the same dense layers;
  * the MoE splits its experts over tp (``layers.apply_moe``): each process
    computes its experts on its rows and the partial outputs are summed
    over tp (``psum``), as the reference's ``shard_map``.

So the gradient of a parameter is a partial sum over the dp axes (each
process's rows; the loss is scaled to the global batch), the same on
every tp process; ``gather`` declares exactly that. A batch that the dp
axes do not divide (long_500k: B = 1) is taken whole by every process, and
its gradients are then the same on every process.

Everything here is a no-op without an installed mesh of more than one
position: the model then runs as on one device, with no collective and no
extra kernel.
"""
from __future__ import annotations

import contextlib
import types
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from .api import DP_AXES, active_mesh

# whether the last ``local_batch`` split its rows over dp: process-wide,
# as the installed mesh is (``api._state``)
_state = types.SimpleNamespace(dp_split=False)


def dp_axes(mesh) -> tuple:
    return tuple(a for a in DP_AXES if a in mesh.axis_names)


def axis_size(mesh, axes) -> int:
    return int(np.prod([mesh.shape[a] for a in axes], dtype=np.int64))


def dp_size(mesh) -> int:
    return axis_size(mesh, dp_axes(mesh))


def axis_index(mesh, axes) -> int:
    """This process's index along ``axes`` (row-major over them)."""
    coord = dict(zip(mesh.axis_names, mesh.coordinate))
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + coord[a]
    return idx


# ---------------------------------------------------------------------------
# Collectives (functional, so CommDebugMode and the fake group see them)
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol
    dm = mesh.device_mesh
    for a in axes:
        if mesh.shape[a] > 1:
            x = funcol.wait_tensor(funcol.all_reduce(
                x, "sum", (dm, mesh.axis_names.index(a))))
    return x


class _Psum(torch.autograd.Function):
    """Sum over ``axes``; the result is the same on every member, so its
    cotangent is too, and passes back unchanged (``jax.lax.psum`` of a
    value whose output is replicated)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Pcopy(torch.autograd.Function):
    """The identity, whose cotangent is summed over ``axes``: the entry of
    a value replicated over ``axes`` into a region where each member
    computes a part of its uses (the transpose of an unmapped input)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.mesh, ctx.axes), None, None


def psum(x, axes, mesh=None):
    mesh = mesh or active_mesh()
    if mesh is None or axis_size(mesh, axes) == 1:
        return x
    return _Psum.apply(x, mesh, tuple(axes))


def pmean(x, axes, mesh=None):
    mesh = mesh or active_mesh()
    if mesh is None or axis_size(mesh, axes) == 1:
        return x
    return psum(x / axis_size(mesh, axes), axes, mesh)


def pcopy(x, axes, mesh=None):
    mesh = mesh or active_mesh()
    if mesh is None or axis_size(mesh, axes) == 1 or not torch.is_grad_enabled():
        return x
    return _Pcopy.apply(x, mesh, tuple(axes))


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def _piece(t: torch.Tensor, device_mesh, placements) -> torch.Tensor:
    """This process's piece of the full tensor ``t`` placed ``placements``
    on ``device_mesh`` (mesh dims in order, as DTensor splits a dim over
    several), a copy."""
    from torch.distributed.tensor import Shard
    for axis, (pl, c) in enumerate(zip(placements, device_mesh.get_coordinate())):
        if isinstance(pl, Shard):
            n = device_mesh.size(axis)
            if t.shape[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} ({t.shape[pl.dim]}) does not "
                                 f"divide over mesh dim {axis} ({n})")
            t = t.chunk(n, dim=pl.dim)[c]
    return t.clone(memory_format=torch.contiguous_format)


def shard_of(t: torch.Tensor, like) -> torch.Tensor:
    """This process's piece of the full tensor ``t``, placed as the
    DTensor ``like``."""
    return _piece(t, like.device_mesh, like.placements)


def distribute(t: torch.Tensor, mesh, placements):
    """A full tensor, the same on every process, as a DTensor holding
    this process's shard (no communication)."""
    from torch.distributed.tensor import DTensor
    dm = mesh.device_mesh
    return DTensor.from_local(_piece(t, dm, placements), dm, placements,
                              run_check=False, shape=t.shape, stride=t.stride())


def full(x):
    """A DTensor gathered whole on every process; anything else as is."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


@contextlib.contextmanager
def placing(make_meta, mesh):
    """Within, each parameter that ``models.layers._param`` makes is
    placed on ``mesh`` by the rules as soon as it is drawn, so a model is
    never whole on one process. ``make_meta()`` builds the same model on
    the meta device, which gives the parameters' names in the order they
    are made."""
    from repro_torch.models import layers
    from .specs import param_placements
    order = []
    prev, layers._PLACE = layers._PLACE, lambda p: order.append(p) or p
    try:
        meta = make_meta()
    finally:
        layers._PLACE = prev
    pl = param_placements(meta, mesh)
    name_of = {id(p): n for n, p in meta.named_parameters()}
    queue = [(name_of[id(p)], tuple(p.shape), pl[name_of[id(p)]]) for p in order]
    made = []

    def place(p: nn.Parameter) -> nn.Parameter:
        name, shape, want = queue[len(made)]
        if tuple(p.shape) != shape:
            raise RuntimeError(f"parameter {len(made)} ({name}) made with "
                               f"shape {tuple(p.shape)}, expected {shape}")
        made.append(name)
        return nn.Parameter(distribute(p.data, mesh, want), requires_grad=False)

    prev, layers._PLACE = layers._PLACE, place
    try:
        yield
    finally:
        layers._PLACE = prev
    if len(made) != len(queue):
        raise RuntimeError(f"{len(made)} of {len(queue)} parameters placed")


def place_tree(tree: Dict[str, Any], specs: Dict[str, tuple], mesh,
               prefix: str = ""):
    """The tensors of a nested dict placed by ``specs`` (``{JAX path:
    placements}``, ``specs.leaf_shapes``'s paths); other leaves as they
    are."""
    from .specs import leaf_shapes
    paths = iter(leaf_shapes(tree, prefix))

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        path = next(paths)
        if isinstance(node, torch.Tensor):
            return distribute(node, mesh, specs[path])
        return node
    return walk(tree)


# ---------------------------------------------------------------------------
# Use
# ---------------------------------------------------------------------------

def gather(p, keep=()):
    """A DTensor parameter as a local tensor, gathered over every mesh axis
    but those in ``keep`` (which keep their shard), differentiably: the
    gradient is a partial sum over the dp axes where the batch is split
    over them (each process's rows), the same on every other axis."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(p, DTensor):
        return p
    mesh = active_mesh()
    split = _state.dp_split
    target, grads = [], []
    for axis, pl in zip(mesh.axis_names, p.placements):
        if axis in keep:
            target.append(pl)
            grads.append(pl)
        else:
            target.append(Replicate())
            grads.append(Partial() if split and axis in DP_AXES else Replicate())
    return p.redistribute(mesh.device_mesh, target).to_local(
        grad_placements=grads)


class LocalView:
    """A module seen through ``gather``: each DTensor attribute is gathered
    on first access (and kept for the view's life), each submodule is a
    view of its own; ``raw`` is the module itself."""

    def __init__(self, module: nn.Module):
        object.__setattr__(self, "raw", module)
        object.__setattr__(self, "_seen", {})

    def __getattr__(self, name):
        seen = self._seen
        if name not in seen:
            value = getattr(self.raw, name)
            if isinstance(value, nn.Module):
                value = LocalView(value)
            elif isinstance(value, torch.Tensor):
                value = gather(value)
            seen[name] = value
        return seen[name]


def local_view(module):
    """``module`` as the layer functions read it: a ``LocalView`` under a
    mesh, the module itself otherwise (or where it is a view already)."""
    if active_mesh() is None or module is None or isinstance(module, LocalView):
        return module
    return LocalView(module)


def raw(module):
    """The module behind a ``LocalView`` (or the module itself)."""
    return module.raw if isinstance(module, LocalView) else module


def dp_rows(n: int):
    """(start, stop) of this process's rows of a batch of ``n`` rows, or
    None where the dp axes do not divide it (every process takes it
    whole), or where no mesh is installed."""
    mesh = active_mesh()
    if mesh is None:
        return None
    dp = dp_size(mesh)
    if dp <= 1 or n % dp:
        return None
    per = n // dp
    i = axis_index(mesh, dp_axes(mesh))
    return i * per, (i + 1) * per


class LocalBatch(dict):
    """A batch already cut to this process's rows."""


def local_batch(batch: Dict[str, Any]) -> Dict[str, Any]:
    """This process's rows of a global batch (leading axis), as
    ``specs.batch_pspecs`` places them; records whether the rows are split
    over dp (``gather``'s gradient, ``split_over_dp``). A ``LocalBatch``
    is returned as it is."""
    if active_mesh() is None or isinstance(batch, LocalBatch):
        return batch
    n = len(next(iter(batch.values())))
    rows = dp_rows(n)
    _state.dp_split = rows is not None
    if rows is None:
        return LocalBatch(batch)
    return LocalBatch({k: v[rows[0]:rows[1]] for k, v in batch.items()})


def split_over_dp() -> bool:
    """Whether the last ``local_batch`` split its rows over dp."""
    return active_mesh() is not None and _state.dp_split


def as_global(x: torch.Tensor, *logical):
    """A local result (this process's rows where ``local_batch`` split the
    batch) as the DTensor of the global result, constrained to
    ``logical`` (``api.constrain``); as it is without a mesh."""
    mesh = active_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from .api import constrain
    split = split_over_dp()
    pl = tuple(Shard(0) if split and a in DP_AXES else Replicate()
               for a in mesh.axis_names)
    shape = (x.shape[0] * (dp_size(mesh) if split else 1),) + tuple(x.shape[1:])
    g = DTensor.from_local(x, mesh.device_mesh, pl, run_check=False,
                           shape=torch.Size(shape),
                           stride=torch.empty(shape, device="meta").stride())
    return constrain(g, *logical)




# ---------------------------------------------------------------------------
# Reductions over sharded leaves (the optimizers)
# ---------------------------------------------------------------------------

def local(x):
    """A DTensor's local shard; anything else as is."""
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def replication(x) -> int:
    """How many processes hold each element of the DTensor ``x`` (1 for a
    local tensor): the product of its replicated mesh axes' sizes."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return 1
    dm = x.device_mesh
    return int(np.prod([dm.size(i) for i, p in enumerate(x.placements)
                        if isinstance(p, Replicate)], dtype=np.int64))


def sum_everywhere(t: torch.Tensor) -> torch.Tensor:
    """A local value summed over every process of the installed mesh."""
    mesh = active_mesh()
    return t if mesh is None else _all_reduce(t, mesh, mesh.axis_names)


def stacked_placements(pl: tuple) -> tuple:
    """A layer's placements as its stacked leaf's (every shard dim one
    higher)."""
    from torch.distributed.tensor import Shard
    return tuple(Shard(p.dim + 1) if isinstance(p, Shard) else p for p in pl)


def like_layout(pl: tuple, ndim: int, drop: int) -> tuple:
    """Placements of a reduction of a tensor placed ``pl`` (``ndim`` dims)
    over its dim ``drop``: the axes that sharded it replicate, the dims
    after it move down one."""
    from torch.distributed.tensor import Replicate, Shard
    drop %= ndim
    out = []
    for p in pl:
        if isinstance(p, Shard) and p.dim == drop:
            out.append(Replicate())
        elif isinstance(p, Shard) and p.dim > drop:
            out.append(Shard(p.dim - 1))
        else:
            out.append(p)
    return tuple(out)


def to_layout(x, pl: tuple) -> torch.Tensor:
    """The local shard of the DTensor ``x`` redistributed to ``pl``."""
    if tuple(x.placements) == tuple(pl):
        return x.to_local()
    return x.redistribute(x.device_mesh, pl).to_local()


def store(x, value: torch.Tensor, pl: tuple) -> None:
    """Write a local shard ``value`` laid out ``pl`` into the DTensor
    ``x`` (redistributed to ``x``'s placements)."""
    from torch.distributed.tensor import DTensor
    if tuple(x.placements) != tuple(pl):
        value = DTensor.from_local(value, x.device_mesh, pl, run_check=False,
                                   shape=x.shape, stride=x.stride()
                                   ).redistribute(x.device_mesh, x.placements
                                                  ).to_local()
    x.to_local().copy_(value)


class LeafLayout:
    """The layout of a leaf whose per-layer tensors are placed like the
    DTensor ``p`` (``stacked``: a leading L axis in front): its global
    ``shape``, and ``sum(t, dims)``, a local partial sum over the leaf's
    ``dims`` completed across the processes that shard them."""

    def __init__(self, p, stacked: bool, layers: int = 1):
        from torch.distributed.tensor import DTensor
        self.pl = stacked_placements(p.placements) if stacked else tuple(p.placements)
        self.shape = ((layers,) if stacked else ()) + tuple(p.shape)
        self.mesh = active_mesh()
        self.names = p.device_mesh.mesh_dim_names if isinstance(p, DTensor) else ()

    def sum(self, t: torch.Tensor, dims) -> torch.Tensor:
        from torch.distributed.tensor import Shard
        nd = len(self.shape)
        want = {d % nd for d in dims}
        axes = tuple(a for a, p in zip(self.names, self.pl)
                     if isinstance(p, Shard) and p.dim in want)
        return _all_reduce(t, self.mesh, axes) if axes else t
