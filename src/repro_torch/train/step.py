"""The train and serve steps (port of ``repro.train.step``).

``make_train_step``: loss -> grad -> clip -> optimizer, optionally with
gradient accumulation over microbatches for global batches beyond memory.
The loss never materialises the (B, S, V) logits: ``chunked_softmax_xent``
takes them a checkpointed chunk of positions at a time.

The train state is ``{"params": model, "opt": optimizer state, "step":
int}``. The model's parameters require grad (``init_train_state`` and
every step switch it on; a model made for serving has it off), and the
step updates them in place. The loss reaches the model through
``models.train_forward``, which records the graph and rematerialises the
layers as the config says; ``models.forward`` stays inference-only for
serving.

``make_serve_steps``: prefill / decode closures.

Under an installed mesh (``repro_torch.sharding.use_mesh``) the state is
placed by the rules (``init_train_state``: the parameters per
``params_pspecs``, the optimizer's state per ``state_pspecs``), each
process takes its data-parallel rows of the batch, its loss is the mean
over the global batch (a mean over dp of the local means), and the
gradients arrive on the parameters' shards (``sharding.runtime``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _DTYPES
from repro_torch.models.lm import apply_head, as_embeds, as_tokens
from repro_torch.optim import Optimizer
from repro_torch.sharding import runtime as _sr
from repro_torch.sharding.api import active_mesh

F32 = torch.float32


def cross_entropy(logits, labels, mask=None):
    """logits (B,S,V) f32, labels (B,S) int -> mean token NLL."""
    lse = torch.logsumexp(logits, -1)
    lab = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - lab
    if mask is None:
        return nll.mean()
    mask = mask.to(F32)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


CE_CHUNK = 512  # sequence positions per logits chunk


def _chunk_nll(hc, lc, w, cfg: ModelConfig):
    logits = apply_head(w, hc, cfg)                    # (B,c,V) f32
    lse = torch.logsumexp(logits, -1)
    lab = logits.gather(-1, lc[..., None])[..., 0]
    return (lse - lab).sum()


def chunked_softmax_xent(hidden, head_w, labels, cfg: ModelConfig,
                         chunk: int = CE_CHUNK):
    """Mean token NLL without materialising (B,S,V) logits.

    Takes S in chunks; each chunk (checkpointed where autograd records)
    computes its logits, logsumexp and label logit, and adds its NLL sum.
    Backward recomputes one chunk's logits at a time, so peak logits memory
    is O(B·chunk·V). Where ``chunk`` does not divide S, one chunk of S."""
    B, S, D = hidden.shape
    c = min(chunk, S)
    if S % c:
        c = S  # fallback: no chunking for odd sizes
    labels = as_tokens(labels, hidden.device).long()
    nll = _chunk_nll
    if torch.is_grad_enabled():
        def nll(hc, lc, w, cfg):
            return checkpoint(_chunk_nll, hc, lc, w, cfg, use_reentrant=False)
    total = torch.zeros((), dtype=F32, device=hidden.device)
    for i in range(0, S, c):
        total = total + nll(hidden[:, i:i + c], labels[:, i:i + c], head_w, cfg)
    return total / (B * S)


def make_loss_fn(cfg: ModelConfig, *, moe_aux_weight: float = 0.01,
                 ce_chunk: int = CE_CHUNK):
    def loss_fn(params, batch):
        batch = _sr.local_batch(batch)
        hidden, aux = api.train_forward(params, batch, cfg, return_hidden=True)
        loss = chunked_softmax_xent(hidden, api.head_weights(
            _sr.local_view(params), cfg), batch["labels"], cfg, chunk=ce_chunk)
        if _sr.split_over_dp():
            loss = _sr.pmean(loss, _sr.dp_axes(active_mesh()))
        if cfg.family == "moe":
            loss = loss + moe_aux_weight * aux["moe_aux"]
        return loss, {"loss": loss}
    return loss_fn


def init_train_state(cfg: ModelConfig, opt: Optimizer, *, seed: int = 0,
                     device=None) -> Dict[str, Any]:
    """A model from ``seed`` (``models.init_params``; ``device=None`` is the
    card), its parameters switched to require grad, and the optimizer's
    state; placed by the rules under a mesh."""
    params = api.init_params(cfg, seed=seed, device=device)
    params.requires_grad_(True)
    state = opt.init(params)
    mesh = active_mesh()
    if mesh is not None:
        from repro_torch.sharding.specs import state_pspecs
        specs = state_pspecs({"opt": state}, mesh)
        state = _sr.place_tree(state, specs, mesh, prefix="opt/")
    return {"params": params, "opt": state, "step": 0}


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors on ``device``: integer arrays
    (tokens, labels) as int32, the rest (frames, patch embeddings) as they
    are."""
    out = {}
    for name, a in batch.items():
        integer = not (a.is_floating_point() if isinstance(a, torch.Tensor)
                       else a.dtype.kind == "f")
        out[name] = as_tokens(a, device) if integer else as_embeds(a, device)
    return out


def make_train_step(cfg: ModelConfig, opt: Optimizer, *,
                    num_microbatches: int = 0,
                    moe_aux_weight: float = 0.01):
    """Returns train_step(state, batch) -> (state, metrics).

    ``num_microbatches`` (default: cfg.microbatches) splits the global
    batch on the leading axis, as the reference does (microbatch i takes
    rows i, i + A, i + 2A, ...), and accumulates the gradients in
    ``cfg.accum_dtype``, ``acc + g / A`` microbatch by microbatch. A f32
    accumulator is a full param-sized buffer, so the largest configs
    accumulate in bf16."""
    A = num_microbatches or cfg.microbatches
    acc_dt = _DTYPES[cfg.accum_dtype]
    loss_fn = make_loss_fn(cfg, moe_aux_weight=moe_aux_weight)

    def grads_of(model, batch):
        names, params = zip(*model.named_parameters())
        loss, _ = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, params, allow_unused=True,
                                    materialize_grads=True)
        return dict(zip(names, grads)), loss.detach()

    def accumulated(model, batch):
        acc = {n: torch.zeros_like(p, dtype=acc_dt)
               for n, p in model.named_parameters()}
        tot = 0.0
        for i in range(A):
            grads, loss = grads_of(model, {k: v[i::A] for k, v in batch.items()})
            for n, g in grads.items():
                acc[n].add_(g.to(acc_dt) / A)
            del grads
            tot = tot + loss
        return acc, tot / A

    def train_step(state, batch):
        model = state["params"]
        model.requires_grad_(True)
        batch = to_device(batch, model.device)
        grads, loss = (grads_of if A == 1 else accumulated)(model, batch)
        model, opt_state = opt.update(grads, state["opt"], model)
        del grads
        metrics = {"loss": loss,
                   "grad_norm": opt_state.pop("grad_norm", 0.0),
                   "lr": opt_state.pop("lr", 0.0)}
        return ({"params": model, "opt": opt_state,
                 "step": state["step"] + 1}, metrics)

    return train_step


def make_serve_steps(cfg: ModelConfig, S_max: int):
    """Returns (prefill_fn, decode_fn), through the serving surface."""
    def prefill_fn(params, batch):
        return api.prefill(params, batch, cfg, S_max)

    def decode_fn(params, cache, token):
        return api.decode_step(params, cache, token, cfg)

    return prefill_fn, decode_fn
