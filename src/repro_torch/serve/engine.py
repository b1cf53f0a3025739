"""Continuous-batching LM serving engine (port of ``repro.serve.engine``).

A slot scheduler over a fixed B×S_max cache ("slots": the attention rows
and, for the ssm and hybrid families, the SSM states): requests are
admitted into free slots, every step decodes *all* slots in one
``decode_step``, and a finished request (EOS, ``max_new`` tokens or a full
cache) frees its slot at once — no head-of-line blocking on the longest
sequence in the batch.

The reference's scheduling is kept as it is: admission in submission
order into the lowest free slot; each prompt left-padded with token 0 to
its length bucket (8, doubling, capped at ``s_max - 1``) and prefilled
pads and all; one key, ``PRNGKey(0)``, split once an admission, once a
step and once a stochastic slot a step, in that order, so that the tokens
are the JAX engine's.

The slots' positions are mirrored on the host (``pos``): the reference
reads ``cache["pos"][slot]`` per slot, which on the card would be a
synchronising read each. The host reads the card once a step (the sampled
tokens) and once an admission (the request's first token); ``reads``
counts them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from repro_torch.device import upload
from repro_torch.kernels.engine import split_key
from repro_torch.models import decode_step, init_cache, prefill
from repro_torch.models.config import ModelConfig

from .sampler import sample


@dataclass
class Request:
    uid: int
    tokens: np.ndarray                  # prompt (p,)
    max_new: int = 32
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: int = -1                    # -1: never stops on token
    # filled by the engine
    out: List[int] = field(default_factory=list)
    slot: int = -1
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


class Engine:
    """Fixed-slot continuous-batching engine over one decoder-only model
    (an ``LM`` of any family but encdec, on its device). A vlm request's
    prompt takes no patch embeddings: its first ``num_patches`` positions
    are on the patch grid all the same, as in the reference."""

    def __init__(self, params, cfg: ModelConfig, *, slots: int = 8,
                 s_max: int = 512):
        if cfg.family == "encdec":
            raise ValueError(
                f"{cfg.name}: the Engine serves decoder-only families; an "
                "encdec prompt needs its frames (run models.api's prefill "
                "and decode_step)")
        self.params = params
        self.cfg = cfg
        self.B = slots
        self.S = s_max
        self.device = params.device
        self.cache = init_cache(cfg, slots, s_max, device=self.device)
        self.pos = np.zeros(slots, np.int64)        # cache["pos"], mirrored
        self.alive = np.zeros(slots, bool)
        self.reqs: Dict[int, Request] = {}
        self.slot_req = [None] * slots
        self.pending: List[Request] = []
        self.done: List[Request] = []
        self.key = np.zeros(2, np.uint32)           # jax.random.PRNGKey(0)
        self._next_tok = np.zeros(slots, np.int32)
        self.reads = 0                              # synchronising reads

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        req.t_submit = time.time()
        self.pending.append(req)
        self.reqs[req.uid] = req

    def _split(self) -> np.ndarray:
        """``self.key, sub = jax.random.split(self.key)``; returns sub."""
        self.key, sub = split_key(self.key, 2)
        return sub

    def _read(self, tokens: torch.Tensor) -> np.ndarray:
        self.reads += 1
        return tokens.cpu().numpy()

    def _bucket(self, plen: int) -> int:
        b = 8
        while b < plen:
            b *= 2
        return min(b, self.S - 1)

    @torch.inference_mode()
    def _admit(self):
        """Move pending requests into free slots (prefill + cache splice)."""
        free = [i for i in range(self.B) if not self.alive[i]]
        while free and self.pending:
            slot = free.pop(0)
            req = self.pending.pop(0)
            plen = self._bucket(len(req.tokens))
            toks = np.zeros((1, plen), np.int32)
            toks[0, -len(req.tokens):] = req.tokens  # left-pad
            logits, rcache = prefill(self.params, {"tokens": toks}, self.cfg,
                                     self.S)
            _splice(self.cache, rcache, slot, self.cfg)
            self.cache["pos"][slot:slot + 1].fill_(plen)  # no host copy
            self.pos[slot] = plen
            tok = int(self._read(sample(
                logits[:, -1], self._split(), temperature=req.temperature,
                top_k=req.top_k, top_p=req.top_p))[0])
            req.out.append(tok)
            req.t_first = time.time()
            req.slot = slot
            self.alive[slot] = True
            self.slot_req[slot] = req
            self._next_tok[slot] = tok

    def _retire(self, slot: int):
        req = self.slot_req[slot]
        req.t_done = time.time()
        self.alive[slot] = False
        self.slot_req[slot] = None
        self.done.append(req)

    @torch.inference_mode()
    def step(self):
        """One engine step: admit, decode all slots, sample, retire."""
        self._admit()
        if not self.alive.any():
            return False
        toks = upload(self._next_tok[:, None], self.device)
        logits, self.cache = decode_step(self.params, self.cache, toks, self.cfg)
        self.pos += 1
        # every slot greedy in one shot, then the stochastic slots one by
        # one, each with a key of its own; all on the device, read once
        nxt = sample(logits[:, -1], self._split())
        for slot in range(self.B):
            req = self.slot_req[slot]
            if self.alive[slot] and req.temperature > 0:
                nxt[slot] = sample(
                    logits[slot:slot + 1, -1], self._split(),
                    temperature=req.temperature, top_k=req.top_k,
                    top_p=req.top_p)[0]
        nxt = self._read(nxt)
        for slot in range(self.B):
            if not self.alive[slot]:
                continue
            req = self.slot_req[slot]
            tok = int(nxt[slot])
            req.out.append(tok)
            self._next_tok[slot] = tok
            if len(req.out) >= req.max_new or tok == req.eos_id:
                self._retire(slot)
            elif self.pos[slot] >= self.S - 1:
                self._retire(slot)  # out of cache
        return True

    def run(self, max_steps: int = 10_000):
        steps = 0
        while (self.pending or self.alive.any()) and steps < max_steps:
            self.step()
            steps += 1
        return self.done


def _splice(cache, rcache, slot: int, cfg: ModelConfig):
    """Copy a request's cache (B=1: its ``k``/``v`` rows, its SSM
    ``state`` and ``conv``, as the family has them) into engine-cache slot
    ``slot``, in place."""
    for k, v in cache.items():
        if k != "pos":
            v[:, slot:slot + 1].copy_(rcache[k])   # layer-stacked: axis 1 is batch
    return cache
