"""Checkpointing: atomic, bitwise, restore-by-name (port of
``repro.checkpoint.manager``).

  * Tensors are saved logically, copied to the host; a restore puts each
    on its template tensor's device, so the caller names the device by
    the template it builds there.
  * Atomicity: write to a temporary file, then ``os.replace`` — a killed
    writer never corrupts the latest checkpoint.
  * ``latest`` is a one-line pointer file, also atomically replaced.
  * Retention: keep the newest ``keep`` checkpoints.
  * Restore takes a template tree (from init) and fills its leaves by
    name, so a change in the model's or the optimizer's structure fails
    loudly instead of loading silently into the wrong place.

Sharded state (DTensors, ``repro_torch.sharding``) is saved logically:
each leaf is gathered whole to the host (a collective: every process
saves, process 0 writes the file). A restore places each leaf as its
template's is placed, so the template built on a restart's mesh, larger
or smaller, reshards the checkpoint onto it: the elastic restore.

A tree is nested dicts and lists of tensors, numpy arrays, ints and
floats; an ``nn.Module`` in it stands for its ``state_dict``. bfloat16
tensors are stored through a 16-bit integer view with their dtype
recorded, so a round trip is bitwise, with no pickle and no ``ml_dtypes``.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch import nn

_VIEWS = {torch.bfloat16: torch.int16}


def _walk(tree, path=""):
    """Yield (name, leaf) in a fixed order: dict keys as given, list items
    by index, a module's state_dict entries; names as ``jax.tree_util``'s
    key strings (``['opt']['mu']['embed']``)."""
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        for key, child in tree.items():
            yield from _walk(child, f"{path}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, child in enumerate(tree):
            yield from _walk(child, f"{path}[{i}]")
    else:
        yield path, tree


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a numpy array and the dtype name it comes back as."""
    if isinstance(leaf, torch.Tensor):
        from torch.distributed.tensor import DTensor
        t = leaf.detach()
        if isinstance(t, DTensor):
            t = t.full_tensor()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype in _VIEWS:
            t = t.view(_VIEWS[t.dtype])
        return t.cpu().numpy(), name
    if isinstance(leaf, bool) or leaf is None:
        raise TypeError(f"cannot checkpoint a leaf of type {type(leaf).__name__}")
    if isinstance(leaf, int):
        return np.int64(leaf), "int"
    if isinstance(leaf, float):
        return np.float64(leaf), "float"
    return np.asarray(leaf), "numpy"


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3):
    """Atomically persist ``tree`` at ``step``. Returns the file path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    names, dtypes, arrays = [], [], {}
    for i, (name, leaf) in enumerate(_walk(tree)):
        arrays[f"a{i}"], dt = _host(leaf)
        names.append(name)
        dtypes.append(dt)
    final = os.path.join(ckpt_dir, f"ckpt_{step:010d}.npz")
    from repro_torch import compat
    if compat.process_index() != 0:
        _barrier()          # process 0 writes; the others wait for it
        return final
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, __names__=np.array(json.dumps(names)),
                 __dtypes__=np.array(json.dumps(dtypes)),
                 __step__=np.int64(step), **arrays)
    os.replace(tmp, final)
    # atomic latest pointer
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        f.write(os.path.basename(final))
    os.replace(tmp, os.path.join(ckpt_dir, "latest"))
    _prune(ckpt_dir, keep)
    _barrier()
    return final


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def _prune(ckpt_dir: str, keep: int):
    ckpts = sorted(f for f in os.listdir(ckpt_dir)
                   if f.startswith("ckpt_") and f.endswith(".npz"))
    for f in ckpts[:-keep] if keep > 0 else []:
        try:
            os.remove(os.path.join(ckpt_dir, f))
        except OSError:
            pass


def latest_step(ckpt_dir: str) -> Optional[int]:
    ptr = os.path.join(ckpt_dir, "latest")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    path = os.path.join(ckpt_dir, name)
    if not os.path.exists(path):
        return None
    return int(name.split("_")[1].split(".")[0])


def _leaf(a: np.ndarray, dtype: str, like):
    """The saved array as the template leaf's kind: a tensor on the
    template tensor's device, an int, a float or a numpy array."""
    if dtype == "int":
        return int(a)
    if dtype == "float":
        return float(a)
    if dtype == "numpy":
        return np.array(a)
    t = torch.from_numpy(np.array(a))
    want = getattr(torch, dtype)
    if want in _VIEWS:
        t = t.view(want)
    from torch.distributed.tensor import DTensor
    if isinstance(like, DTensor):     # this process's shard, as placed there
        from repro_torch.sharding.runtime import shard_of
        return DTensor.from_local(shard_of(t, like).to(like.device),
                                  like.device_mesh, like.placements,
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
    return t.to(like.device)


def _fill(template, get, path=""):
    """``template``'s structure with each leaf ``get(name, template
    leaf)``; a module's parameters and buffers are copied into it in
    place."""
    if isinstance(template, nn.Module):
        from repro_torch.sharding.runtime import local
        with torch.no_grad():
            for key, t in template.state_dict().items():
                local(t).copy_(local(get(f"{path}[{key!r}]", t)))
        return template
    if isinstance(template, dict):
        return {key: _fill(child, get, f"{path}[{key!r}]")
                for key, child in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_fill(child, get, f"{path}[{i}]")
                              for i, child in enumerate(template))
    return get(path, template)


def restore_checkpoint(ckpt_dir: str, template: Any,
                       step: Optional[int] = None) -> Tuple[int, Any]:
    """Restore into the structure of ``template``. Returns (step, tree).

    Each tensor comes back with its saved dtype on its template tensor's
    device; a module in the template takes its saved parameters in place.
    Raises ``ValueError`` where the
    checkpoint's leaf names differ from the template's."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"ckpt_{step:010d}.npz")
    t_names = [name for name, _ in _walk(template)]
    with np.load(path, allow_pickle=False) as z:
        names = json.loads(str(z["__names__"]))
        if names != t_names:
            missing = set(t_names) - set(names)
            extra = set(names) - set(t_names)
            raise ValueError(
                f"checkpoint/template structure mismatch: missing={sorted(missing)[:5]} "
                f"extra={sorted(extra)[:5]}")
        index = {name: i for i, name in enumerate(names)}
        dtypes = json.loads(str(z["__dtypes__"]))

        def get(name, like):
            i = index[name]
            return _leaf(z[f"a{i}"], dtypes[i], like)
        return step, _fill(template, get)
