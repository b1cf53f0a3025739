"""Optimizers (port of ``repro.optim.optimizers``): AdamW and Adafactor.

Interface (as the reference's, on a model in place of a param pytree):
  opt = adamw(lr_fn, ...) / adafactor(lr_fn, ...)
  state = opt.init(model)
  model, state = opt.update(grads, state, model)

``grads`` maps the model's parameter names (its state_dict keys, such as
``layers.3.attn.wq``) to gradients; ``update`` writes the new values into
the model's parameters and returns the model with the new state.

The state is the reference's, leaf for leaf. The JAX package stacks each
layer group on a leading L axis (``layers``, ``enc_layers``,
``dec_layers``) where the port holds one tensor a layer, and its rules
read the stacked leaf: AdamW decays and Adafactor factors every leaf of
``ndim >= 2`` (so also the stacked norm scales, biases and ``A_log``,
1-D a layer here), and Adafactor clips its update by the RMS over the
whole stacked leaf. So the state is keyed by the JAX leaf path
(``layers.attn.wq``, ``embed``; ``leaf_groups``), a stacked leaf's moments
carry the L axis, and each rule is applied to the stacked leaf. One leaf
at a time, so that the f32 temporaries peak at the largest leaf. The
step, the learning rate and the bias corrections are host values
(float32, as jnp computes them), so an update reads nothing back from the
card.

  * Weight decay is decoupled (AdamW) and applied only to >=2-D leaves.
  * Adafactor keeps factored second moments (row + col instead of full)
    for every leaf of ndim >= 2; its first moment is off, as in the
    original.

On a mesh (``repro_torch.sharding``) the parameters, their gradients and
the state are DTensors, and an update works on each process's shards:
AdamW elementwise (a stacked moment's layer slice is placed as that
layer's parameter), Adafactor with its row and column means, its RMS
clip and the global norm summed across the shards of the whole stacked
leaf (its factored state brought to the gradient's layout and back).
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple

import numpy as np
import torch

from repro_torch.sharding import runtime as _sr

F32 = torch.float32
STACKED = ("layers", "enc_layers", "dec_layers")   # leading L axis in JAX


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def is_stacked(key: str) -> bool:
    return key.split(".")[0] in STACKED


def leaf_groups(names) -> Dict[str, List[str]]:
    """The JAX param leaves of the parameter ``names``: each leaf path
    (``layers.attn.wq``, ``final_norm.scale``) with its parameters' names,
    one a layer in layer order where the leaf is stacked. In the
    reference's flatten order: paths sorted key by key, as jax sorts a
    dict's keys."""
    groups: Dict[str, List[str]] = {}
    for name in names:
        parts = name.split(".")
        key = ".".join(parts[:1] + parts[2:]) if parts[0] in STACKED else name
        groups.setdefault(key, []).append(name)
    for key, members in groups.items():
        if is_stacked(key):
            members.sort(key=lambda n: int(n.split(".")[1]))
    return {key: groups[key] for key in sorted(groups, key=lambda k: k.split("."))}


def leaf_tensor(key: str, tensors: List[torch.Tensor]) -> torch.Tensor:
    """The JAX leaf from its per-layer tensors: stacked on a leading axis
    where the leaf is (one layer: a view), else the tensor itself."""
    if not is_stacked(key):
        return tensors[0]
    return tensors[0][None] if len(tensors) == 1 else torch.stack(tensors)


def _params(model) -> Dict[str, torch.Tensor]:
    return dict(model.named_parameters())


def _leaf_shape(key: str, tensors) -> tuple:
    shape = tuple(tensors[0].shape)
    return (len(tensors),) + shape if is_stacked(key) else shape


def _sharded(tensors) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(next(iter(tensors)), DTensor)


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares in f32, leaf by leaf in the reference's
    order (a 0-d tensor on the grads' device). Sharded: each process's
    shards, an element counted once, summed over every process."""
    sharded = _sharded(grads.values())
    total = None
    for key, names in leaf_groups(grads).items():
        if sharded:
            leaf = sum(_sr.local(grads[n]).to(F32).square().sum()
                       / _sr.replication(grads[n]) for n in names)
        else:
            leaf = sum(grads[n].to(F32).square().sum() for n in names)
        total = leaf if total is None else total + leaf
    return torch.sqrt(_sr.sum_everywhere(total) if sharded else total)


def clip_scale(grads: Dict[str, torch.Tensor], max_norm: float):
    """(scale, norm): ``clip_by_global_norm``'s factor min(1, max_norm /
    (norm + 1e-9)) as a 0-d f32 tensor, and the norm."""
    norm = global_norm(grads)
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0), norm


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # norm in f32, but grads keep their dtype, as the reference's
    return (g.to(F32) * scale).to(g.dtype)


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    scale, norm = clip_scale(grads, max_norm)
    return {n: _clipped(g, scale) for n, g in grads.items()}, norm


def adamw(lr_fn, *, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip_norm: float = 1.0) -> Optimizer:
    def init(model):
        mu, nu = {}, {}
        params = _params(model)
        for key, names in leaf_groups(params).items():
            shape = _leaf_shape(key, [params[n] for n in names])
            dev = params[names[0]].device
            mu[key] = torch.zeros(shape, dtype=F32, device=dev)
            nu[key] = torch.zeros(shape, dtype=F32, device=dev)
        return {"mu": mu, "nu": nu, "step": 0}

    def update(grads, state, model):
        scale, gnorm = clip_scale(grads, clip_norm)
        step = state["step"] + 1
        lr = float(lr_fn(step))
        b1c = float(np.float32(1) - np.float32(b1) ** np.float32(step))
        b2c = float(np.float32(1) - np.float32(b2) ** np.float32(step))
        params = _params(model)

        @torch.no_grad()
        def upd(g, mu, nu, p, decay: bool):
            # elementwise, so one layer's slice of a stacked leaf at a time
            g = _clipped(g, scale)
            new_mu = b1 * mu + (1 - b1) * g
            new_nu = b2 * nu + (1 - b2) * g * g
            delta = (new_mu / b1c) / (torch.sqrt(new_nu / b2c) + eps)
            if weight_decay and decay:
                delta = delta + weight_decay * p.to(F32)
            p.copy_((p.to(F32) - lr * delta).to(p.dtype))
            mu.copy_(new_mu)
            nu.copy_(new_nu)

        loc = _sr.local  # a process's shards on a mesh (elementwise)
        with torch.no_grad():
            for key, names in leaf_groups(params).items():
                mu, nu = state["mu"][key], state["nu"][key]
                decay = mu.dim() >= 2
                if is_stacked(key):
                    for i, n in enumerate(names):
                        upd(loc(grads[n]), loc(mu)[i], loc(nu)[i],
                            loc(params[n]), decay)
                else:
                    upd(loc(grads[names[0]]), loc(mu), loc(nu),
                        loc(params[names[0]]), decay)
        return model, {"mu": state["mu"], "nu": state["nu"], "step": step,
                       "grad_norm": gnorm, "lr": lr}

    return Optimizer(init, update)


def adafactor(lr_fn, *, decay: float = 0.8, eps: float = 1e-30,
              clip_norm: float = 1.0, clip_rms: float = 1.0,
              weight_decay: float = 0.0,
              chunked_update: bool = False) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern 2018), the
    state-memory-frugal choice for the >=100B-param archs."""

    def _state_for(shape, dev):
        if len(shape) >= 2:
            # factor over the two trailing dims; keep leading dims (e.g.
            # the stacked-layer axis) unfactored
            return {"vr": torch.zeros(shape[:-1], dtype=F32, device=dev),
                    "vc": torch.zeros(shape[:-2] + shape[-1:], dtype=F32,
                                      device=dev)}
        return {"v": torch.zeros(shape, dtype=F32, device=dev)}

    def init(model):
        params = _params(model)
        return {"v": {key: _state_for(_leaf_shape(key, [params[n] for n in names]),
                                      params[names[0]].device)
                      for key, names in leaf_groups(params).items()},
                "step": 0}

    def update(grads, state, model):
        scale, gnorm = clip_scale(grads, clip_norm)
        step = state["step"] + 1
        lr = float(lr_fn(step))
        beta = float(np.float32(1) - (np.float32(step) + np.float32(1))
                     ** np.float32(-decay))
        params = _params(model)

        def upd(g, v, p):
            """One leaf (or one layer's slice of it): new param values and
            writes the new moments into ``v``."""
            g2 = g * g + eps
            if p.dim() >= 2:
                vr = beta * v["vr"] + (1 - beta) * g2.mean(-1).to(F32)
                vc = beta * v["vc"] + (1 - beta) * g2.mean(-2).to(F32)
                denom = vr.mean(-1, keepdim=True)
                rfac = (vr / torch.clamp(denom, min=eps))[..., None]
                prec = torch.rsqrt(torch.clamp(rfac * vc[..., None, :], min=eps))
                u = g * prec
                v["vr"].copy_(vr)
                v["vc"].copy_(vc)
            else:
                nv = beta * v["v"] + (1 - beta) * g2.to(F32)
                u = g * torch.rsqrt(torch.clamp(nv, min=eps))
                v["v"].copy_(nv)
            # update clipping by RMS (Adafactor's d=1 rule)
            rms = torch.sqrt((u * u).mean() + 1e-12)
            u = u / torch.clamp(rms / clip_rms, min=1.0)
            if weight_decay and p.dim() >= 2:
                u = u + weight_decay * p.to(F32)
            return (p.to(F32) - lr * u).to(p.dtype)

        with torch.no_grad():
            for key, names in leaf_groups(params).items():
                v, ps = state["v"][key], [params[n] for n in names]
                if _sharded(ps):
                    _sharded_update(key, [_clipped(_sr.local(grads[n]), scale)
                                          for n in names], v, ps, beta, lr)
                    continue
                if chunked_update and is_stacked(key) and ps[0].dim() >= 2 \
                        and len(ps) >= 8:
                    # a layer's slice at a time, as the reference's lax.map
                    for i, (n, p) in enumerate(zip(names, ps)):
                        p.copy_(upd(_clipped(grads[n], scale),
                                    {k: t[i] for k, t in v.items()}, p))
                    continue
                new = upd(leaf_tensor(key, [_clipped(grads[n], scale) for n in names]),
                          v, leaf_tensor(key, ps))
                for i, p in enumerate(ps):
                    p.copy_(new[i] if is_stacked(key) else new)
        return model, {"v": state["v"], "step": step, "grad_norm": gnorm,
                       "lr": lr}

    def _sharded_update(key, gs, v, ps, beta, lr):
        """``upd`` on a stacked leaf's shards: ``gs`` each layer's clipped
        local gradient, ``v`` the leaf's state and ``ps`` its parameters
        (DTensors). The means, and the RMS, sum over the whole leaf."""
        stacked = is_stacked(key)
        pl = (_sr.stacked_placements if stacked else tuple)(ps[0].placements)
        like = _sr.LeafLayout(ps[0], stacked, len(ps))
        g = torch.stack(gs) if stacked else gs[0]
        p = torch.stack([_sr.local(q) for q in ps]) if stacked else _sr.local(ps[0])
        full = like.shape
        g2 = g * g + eps
        if len(full) >= 2:
            row_pl = _sr.like_layout(pl, len(full), -1)
            col_pl = _sr.like_layout(pl, len(full), -2)
            vr0, vc0 = _sr.to_layout(v["vr"], row_pl), _sr.to_layout(v["vc"], col_pl)
            rows = like.sum(g2.sum(-1), (-1,)) / full[-1]
            cols = like.sum(g2.sum(-2), (-2,)) / full[-2]
            vr = beta * vr0 + (1 - beta) * rows.to(F32)
            vc = beta * vc0 + (1 - beta) * cols.to(F32)
            denom = like.sum(vr.sum(-1, keepdim=True), (-2,)) / full[-2]
            rfac = (vr / torch.clamp(denom, min=eps))[..., None]
            u = g * torch.rsqrt(torch.clamp(rfac * vc[..., None, :], min=eps))
            _sr.store(v["vr"], vr, row_pl)
            _sr.store(v["vc"], vc, col_pl)
        else:
            nv = beta * _sr.to_layout(v["v"], pl) + (1 - beta) * g2.to(F32)
            u = g * torch.rsqrt(torch.clamp(nv, min=eps))
            _sr.store(v["v"], nv, pl)
        n = float(np.prod(full))
        rms = torch.sqrt(like.sum((u * u).sum(), range(len(full))) / n + 1e-12)
        u = u / torch.clamp(rms / clip_rms, min=1.0)
        if weight_decay and len(full) >= 2:
            u = u + weight_decay * p.to(F32)
        new = (p.to(F32) - lr * u).to(p.dtype)
        for i, q in enumerate(ps):
            _sr.local(q).copy_(new[i] if stacked else new)

    return Optimizer(init, update)


def make_optimizer(name: str, lr_fn, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr_fn, **kw)
    if name == "adafactor":
        return adafactor(lr_fn, **kw)
    raise ValueError(name)
