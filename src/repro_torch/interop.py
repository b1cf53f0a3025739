"""Carry state between the JAX package and the port.

What crosses over is state — points, masks, running ``min_d2``, a round-1
center union and its ``valid`` mask, cluster weights, a streaming sketch —
the LM's weights (``params_from_jax``) and its train state
(``train_state_from_jax``). Both directions go through numpy, so neither
package imports the other.
"""
from __future__ import annotations

import numpy as np
import torch

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.int32): torch.int32,
           np.dtype(np.bool_): torch.bool}


def state_from_jax(arrays: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """The JAX package's arrays, read out as numpy, as the port's tensors on
    ``device``. float32, int32 and bool map exactly; any other dtype
    raises rather than being converted silently."""
    out = {}
    for name, a in arrays.items():
        a = np.asarray(a)
        if a.dtype not in _DTYPES:
            raise TypeError(f"{name}: dtype {a.dtype} has no exact "
                            "counterpart (expected float32, int32 or bool)")
        out[name] = torch.from_numpy(np.array(a)).to(device)
    return out


def result_to_numpy(result):
    """A port result (a tensor, or a NamedTuple such as ``MRGResult`` with
    its cluster ``weights``, ``KZResult``, ``Coreset`` or ``EIMResult``) as
    numpy: tensors become arrays, a NamedTuple a dict of its fields, nested
    ones (``EIMResult.sample``) included; other values (``rounds``,
    ``coreset_size``, ``None``) pass through."""
    if isinstance(result, torch.Tensor):
        return result.detach().cpu().numpy()
    if isinstance(result, tuple) and hasattr(result, "_fields"):
        return {f: result_to_numpy(getattr(result, f)) for f in result._fields}
    return result


def stream_state_from_jax(state):
    """The JAX package's ``StreamState`` (host numpy already) as the
    port's, so that a sketch fed its first batches there goes on here.
    The centers are copied as float32; ``count``, ``r`` and ``k`` keep
    their values."""
    from repro_torch.core.streaming import StreamState
    centers = np.asarray(state.centers)
    if centers.dtype != np.float32:
        raise TypeError(f"centers: dtype {centers.dtype}, expected float32")
    return StreamState(np.array(centers), int(state.count), float(state.r),
                       int(state.k))


def _exact_tensor(name: str, a) -> torch.Tensor:
    """float32 as is; bfloat16 (``ml_dtypes.bfloat16``, as jax reads out)
    bit for bit through a 16-bit integer view; anything else raises."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.float32:
        return torch.from_numpy(np.array(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    raise TypeError(f"{name}: dtype {a.dtype} has no exact counterpart "
                    "(expected float32 or bfloat16)")


STACKED = ("layers", "enc_layers", "dec_layers")   # leading L axis in JAX


def _flatten(tree: dict) -> dict:
    """A nested dict's leaves by path tuple, in jax's flatten order (each
    dict's keys sorted)."""
    flat = {}

    def walk(path, node):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(path + (key,), node[key])
        else:
            flat[path] = node
    walk((), tree)
    return flat


def params_from_jax(params: dict, cfg, device):
    """The JAX package's model param pytree, read out as numpy (e.g.
    ``jax.tree.map(np.asarray, params)``), as the port's model on
    ``device``: an ``LM``, or an ``EncDec`` for the encdec family. The
    leading L axis of each stacked group (``layers``; ``enc_layers`` and
    ``dec_layers``) is unstacked into ``{group}.{i}``; every other path
    keeps its name (``embed``, ``final_norm.scale``, ``lm_head``,
    ``patch_proj``, ``enc_norm.bias``, ``layers.{i}.moe.router``,
    ``layers.{i}.ssm.A_log``, ``layers.{i}.bnorm_a``, ...). Each array must
    match the port's parameter in shape and dtype, and the two sets of
    names must be equal."""
    from repro_torch.device import resolve_device
    from repro_torch.models.encdec import EncDec
    from repro_torch.models.lm import LM
    arrays = {}
    for path, a in _flatten(params).items():
        if path[0] in STACKED:
            for i in range(np.shape(a)[0]):
                arrays[".".join((path[0], str(i)) + path[1:])] = np.asarray(a)[i]
        else:
            arrays[".".join(path)] = a
    cls = EncDec if cfg.family == "encdec" else LM
    model = cls(cfg, device=resolve_device(device))
    own = model.state_dict()
    if set(own) != set(arrays):
        raise KeyError(f"param names differ: missing {sorted(set(own) - set(arrays))}, "
                       f"unexpected {sorted(set(arrays) - set(own))}")
    with torch.no_grad():
        for name, a in arrays.items():
            t = _exact_tensor(name, a)
            if t.shape != own[name].shape or t.dtype != own[name].dtype:
                raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, the port "
                                 f"holds {own[name].dtype} {tuple(own[name].shape)}")
            own[name].copy_(t)
    return model


def train_state_from_jax(state: dict, cfg, device):
    """The JAX package's train state (``init_train_state`` and its train
    steps), read out as numpy, as the port's on ``device``: the params
    through ``params_from_jax`` (switched to require grad), the optimizer's
    state onto the port's leaf-keyed state (AdamW's ``mu``/``nu`` trees;
    Adafactor's ``v`` list, aligned with the flattened param leaves), and
    the steps as ints. The moments keep their stacked (L, ...) shapes and
    their float32."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    model = params_from_jax(state["params"], cfg, dev)
    model.requires_grad_(True)
    leaves = [".".join(path) for path in _flatten(state["params"])]

    def tensors(tree):
        if isinstance(tree, dict):
            return {k: tensors(v) for k, v in tree.items()}
        return _exact_tensor("opt", tree).to(dev)
    jopt = state["opt"]
    opt = {"step": int(np.asarray(jopt["step"]))}
    if "mu" in jopt:
        for name in ("mu", "nu"):
            opt[name] = {".".join(path): tensors(a)
                         for path, a in _flatten(jopt[name]).items()}
    else:
        if len(jopt["v"]) != len(leaves):
            raise ValueError(f"{len(jopt['v'])} Adafactor states for "
                             f"{len(leaves)} param leaves")
        opt["v"] = {key: tensors(v) for key, v in zip(leaves, jopt["v"])}
    return {"params": model, "opt": opt, "step": int(np.asarray(state["step"]))}
