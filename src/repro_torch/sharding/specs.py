"""Placements for parameters, optimizer state, batches and KV caches
(port of ``repro.sharding.specs``: the same rules, as DTensor placements).

Scheme (logical axes; dp = ("pod","data") where present, tp = "model"):

  embeddings   (V, D)        -> (tp, dp)      vocab TP + FSDP
  lm_head      (D, V)        -> (dp, tp)
  attn wq/wk/wv(D, H·hd)     -> (dp, tp)      head-dim TP, FSDP rows
  attn wo      (H·hd, D)     -> (tp, dp)
  mlp up/gate  (D, F)        -> (dp, tp)
  mlp down     (F, D)        -> (tp, dp)
  moe experts  (E, D, F)     -> (tp, dp, ·)   EP on experts + FSDP
  moe router   (D, E)        -> (dp, ·)
  ssm w_in     (D, ·)        -> (dp, tp)
  ssm w_out    (din, D)      -> (tp, dp)
  1-D params                 -> replicated
  tokens/labels(B, S)        -> (dp, ·)
  KV cache  (L,B,S,KV,hd)    -> (·, dp, tp, ·, ·)   sequence-parallel KV
  ssm state (L,B,nh,N,P)     -> (·, dp, tp, ·, ·)

The rules read the JAX package's leaves: a tree is keyed by the JAX leaf
path (``layers/attn/wq``), and a layer-stacked leaf carries its leading L
axis, which is never sharded. The port's model holds one tensor a layer,
so ``leaf_shapes`` groups its parameters into those stacked leaves
(``optim.leaf_groups``) and its optimizer state, already keyed by leaf,
onto the reference's paths (Adafactor's factored state is a list there,
aligned with the flattened leaves: ``opt/v/3/vr``). Divisibility is judged
on the stacked shape. ``param_placements`` gives each per-layer parameter
its stacked leaf's placements without the L axis.

Every ``*_pspecs`` returns ``{path: placements}``: one DTensor placement
per mesh dimension (``api.spec``).
"""
from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
from torch import nn

from .api import DP_AXES, TP_AXIS, NamedSharding, spec as resolve_spec

# (path regex, logical spec for the *trailing* dims of the unstacked param)
_RULES = [
    (r"(embed)$", ("tp", "dp")),
    (r"(lm_head)$", ("dp", "tp")),
    (r"(patch_proj)$", ("dp", "tp")),
    (r"(wq|wk|wv)$", ("dp", "tp")),
    (r"(wo)$", ("tp", "dp")),
    (r"(bq|bk|bv)$", ("tp",)),
    (r"(w_gate|w_up)$", None),   # disambiguated by ndim below (moe vs mlp)
    (r"(w_down)$", None),
    (r"(router)$", ("dp", None)),
    (r"(w_in)$", ("dp", "tp")),
    (r"(w_out)$", ("tp", "dp")),
    (r"(conv)$", (None, "tp")),
]


def _mesh_sizes(mesh):
    dp = int(np.prod([mesh.shape[a] for a in DP_AXES if a in mesh.axis_names]))
    tp = mesh.shape.get(TP_AXIS, 1)
    return dp, tp


def _fit_logical(logical, shape, mesh):
    """Drop sharding on dims the mesh axes don't divide (e.g. vocab 50280
    on a 16-way axis): such a dim stays replicated."""
    dp, tp = _mesh_sizes(mesh)
    size = {"dp": dp, "tp": tp}
    out = []
    for dim, entry in zip(shape, logical):
        if entry in ("dp", "tp") and (size[entry] <= 1 or dim % size[entry] != 0):
            out.append(None)
        else:
            out.append(entry)
    return tuple(out)


def auto_spec(shape, mesh):
    """Fallback: shard the largest dp-divisible axis on dp, then the
    largest remaining tp-divisible axis on tp."""
    dp, tp = _mesh_sizes(mesh)
    entries = [None] * len(shape)
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    dp_done = tp_done = False
    for i in order:
        if not dp_done and shape[i] % dp == 0 and shape[i] >= dp:
            entries[i] = "dp"
            dp_done = True
        elif not tp_done and shape[i] % tp == 0 and shape[i] >= tp:
            entries[i] = "tp"
            tp_done = True
    return tuple(entries)


def _param_logical(path_name: str, shape, stacked: bool):
    trailing = shape[1:] if stacked else shape
    for rx, logical in _RULES:
        if re.search(rx, path_name):
            if logical is None:  # w_gate/w_up/w_down: mlp (2-D) vs moe (3-D)
                if path_name.endswith("w_down"):
                    logical = ("tp", None, "dp") if len(trailing) == 3 \
                        else ("tp", "dp")
                else:
                    logical = ("tp", "dp", None) if len(trailing) == 3 \
                        else ("dp", "tp")
            if len(logical) != len(trailing):
                break  # fall through to auto
            return ((None,) + tuple(logical)) if stacked else tuple(logical)
    if len(trailing) <= 1:
        return (None,) * len(shape)
    return None  # signal: use auto_spec


# ---------------------------------------------------------------------------
# The port's trees as JAX leaf paths
# ---------------------------------------------------------------------------

def _shape(leaf) -> tuple:
    if isinstance(leaf, (int, float)):
        return ()
    return tuple(int(s) for s in leaf.shape)


def _itemsize(leaf) -> int:
    return leaf.element_size() if hasattr(leaf, "element_size") else 0


def _module_walk(model: nn.Module, prefix: str):
    from repro_torch.optim.optimizers import leaf_groups, is_stacked
    params = dict(model.named_parameters())
    for key, names in leaf_groups(params).items():
        p = params[names[0]]
        shape = _shape(p)
        yield (prefix + key.replace(".", "/"),
               (len(names),) + shape if is_stacked(key) else shape, _itemsize(p))


def _walk(tree: Any, prefix: str = ""):
    """(JAX leaf path, shape, bytes an element; 0 for a non-tensor) of a
    port tree, in order."""
    if isinstance(tree, nn.Module):
        yield from _module_walk(tree, prefix)
    elif isinstance(tree, dict):
        if prefix.endswith("opt/") and isinstance(tree.get("v"), dict) and \
                all(isinstance(v, dict) for v in tree["v"].values()):
            # Adafactor: the reference's list aligned with the leaves
            tree = dict(tree, v=list(tree["v"].values()))
        for key, child in tree.items():
            yield from _walk(child, prefix + str(key).replace(".", "/") + "/")
    elif isinstance(tree, list):
        for i, child in enumerate(tree):
            yield from _walk(child, f"{prefix}{i}/")
    elif isinstance(tree, tuple):
        yield prefix.rstrip("/"), tuple(int(s) for s in tree), 0
    else:
        yield prefix.rstrip("/"), _shape(tree), _itemsize(tree)


def leaf_shapes(tree: Any, prefix: str = "") -> Dict[str, tuple]:
    """``{JAX leaf path: shape}`` of a port tree: a model (its stacked
    leaves), a train state (``params``, the optimizer's leaf-keyed state,
    ints as scalars), a cache or a batch (dicts of tensors or arrays), or
    such a dict already keyed by path with shapes (tuples) as values."""
    return {path: shape for path, shape, _ in _walk(tree, prefix)}


# ---------------------------------------------------------------------------
# Placements
# ---------------------------------------------------------------------------

def _rule_specs(tree, mesh, stacked_of) -> Dict[str, tuple]:
    specs = {}
    for name, shape in leaf_shapes(tree).items():
        logical = _param_logical(name, shape, stacked_of(name))
        if logical is None:
            logical = auto_spec(shape, mesh)
        specs[name] = resolve_spec(mesh, *_fit_logical(logical, shape, mesh))
    return specs


def params_pspecs(params_shapes: Any, mesh) -> Dict[str, tuple]:
    """Placements of every param leaf (a model, or ``{path: shape}``).
    Layer-stacked leaves are detected by path ('layers' / 'enc_layers' /
    'dec_layers')."""
    return _rule_specs(
        params_shapes, mesh,
        lambda name: bool(re.search(r"(^|/)(layers|enc_layers|dec_layers)/",
                                    name + "/") or "layers/" in name))


def state_pspecs(state_shapes: Any, mesh) -> Dict[str, tuple]:
    """Optimizer/train-state tree: param-mirroring moments reuse the param
    rules; factored/scalar leaves use the auto rule."""
    return _rule_specs(state_shapes, mesh, lambda name: "layers/" in name)


def batch_pspecs(batch_shapes: Any, mesh) -> Dict[str, tuple]:
    """tokens/labels (B,S) -> (dp, None); frames/patches (B,X,D) likewise.
    Batches smaller than the dp axes (long_500k: B=1) stay replicated."""
    out = {}
    for name, shape in leaf_shapes(batch_shapes).items():
        logical = _fit_logical(("dp",) + (None,) * (len(shape) - 1), shape, mesh)
        out[name] = resolve_spec(mesh, *logical)
    return out


def cache_pspecs(cache_shapes: Any, mesh) -> Dict[str, tuple]:
    """KV caches (L,B,S,KV,hd) -> (None, dp, tp, ...): batch over dp,
    sequence over tp. SSM states (L,B,nh,N,P): heads over tp."""
    out = {}
    for name, shape in leaf_shapes(cache_shapes).items():
        nd = len(shape)
        if name.endswith("pos"):
            logical = _fit_logical(("dp",), shape, mesh)
        elif name in ("k", "v", "xk", "xv") or name.endswith("/k") \
                or name.endswith("/v") or name.endswith("xk") \
                or name.endswith("xv"):
            logical = _fit_logical((None, "dp", "tp", None, None), shape, mesh)
        elif name.endswith("state"):
            logical = _fit_logical((None, "dp", "tp", None, None), shape, mesh)
        elif name.endswith("conv"):
            logical = _fit_logical((None, "dp", None, "tp"), shape, mesh)
        else:
            logical = (None,) * nd
        out[name] = resolve_spec(mesh, *logical)
    return out


def shardings(tree_specs: Dict[str, tuple], mesh) -> Dict[str, NamedSharding]:
    return {name: NamedSharding(mesh, pl) for name, pl in tree_specs.items()}


def unstacked(pl: tuple) -> tuple:
    """A stacked leaf's placements for one layer's tensor: every shard
    dim one lower (the L axis is never sharded)."""
    from torch.distributed.tensor import Shard
    return tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p for p in pl)


def param_placements(model: nn.Module, mesh) -> Dict[str, tuple]:
    """``{parameter name: placements}`` of a model's own tensors: a
    stacked leaf's placements without its L axis for each layer's."""
    from repro_torch.optim.optimizers import is_stacked, leaf_groups
    leaf = params_pspecs(model, mesh)
    out = {}
    for key, names in leaf_groups(dict(model.named_parameters())).items():
        pl = leaf[key.replace(".", "/")]
        for n in names:
            out[n] = unstacked(pl) if is_stacked(key) else pl
    return out


def placed_bytes(tree: Any, pspecs: Dict[str, tuple], mesh) -> int:
    """Bytes one position holds of the tensors of a port tree placed by
    ``pspecs`` (a ``*_pspecs`` result for it)."""
    return sum(shard_bytes(shape, size, pspecs[path], mesh)
               for path, shape, size in _walk(tree) if size)


def shard_bytes(shape, dtype_bytes: int, pl: tuple, mesh) -> int:
    """Bytes of one position's shard of a tensor of ``shape`` placed
    ``pl`` on ``mesh``."""
    from torch.distributed.tensor import Shard
    n = int(np.prod(shape, dtype=np.int64)) * dtype_bytes
    for axis, p in zip(mesh.axis_names, pl):
        if isinstance(p, Shard):
            n //= mesh.shape[axis]
    return n

