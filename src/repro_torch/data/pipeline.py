"""Deterministic, resumable synthetic token pipeline (a copy of
``repro.data.pipeline``: numpy Philox, so both packages draw bitwise the
same batches from a seed).

Every batch is a pure function of (seed, step) via counter-based Philox
keys — restart-exactness for the fault-tolerance path (DESIGN.md §6):
resuming from a checkpoint at step s replays batch s identically, with no
stream state to persist.

The synthetic language is a noisy affine bigram chain
``x[t+1] = (a·x[t] + b) mod V`` with p=0.2 uniform noise — enough learnable
structure that training-loss decrease is a meaningful integration test.

For multi-host data loading each host materializes only its shard
(``host_slice``): batches are generated shard-locally from the same
(seed, step), so no host reads another host's slice — the standard
per-host data-loading pattern at pod scale.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.models.config import ModelConfig


def _rng(seed: int, step: int) -> np.random.Generator:
    # Philox key is 2×64-bit: (salted seed, step) — counter-based, so a
    # batch is a pure function of (seed, step).
    key = np.array([(seed ^ 0x5EED_DA7A) & 0xFFFFFFFFFFFFFFFF, step],
                   dtype=np.uint64)
    return np.random.Generator(np.random.Philox(key=key))


def token_batch(vocab: int, batch: int, seq: int, *, seed: int = 0,
                step: int = 0, noise: float = 0.2) -> Dict[str, np.ndarray]:
    """(tokens, labels) of shape (batch, seq); labels are next-tokens."""
    r = _rng(seed, step)
    a = 31337 % vocab or 1
    b = 17
    x0 = r.integers(0, vocab, (batch, 1))
    cols = [x0]
    for _ in range(seq):
        nxt = (cols[-1] * a + b) % vocab
        flip = r.random((batch, 1)) < noise
        rnd = r.integers(0, vocab, (batch, 1))
        cols.append(np.where(flip, rnd, nxt))
    stream = np.concatenate(cols, axis=1)
    return {"tokens": stream[:, :seq].astype(np.int32),
            "labels": stream[:, 1 : seq + 1].astype(np.int32)}


def model_batch(cfg: ModelConfig, batch: int, seq: int, *, seed: int = 0,
                step: int = 0) -> Dict[str, np.ndarray]:
    """Full input dict for any family (frames/patches stubs included)."""
    out = token_batch(cfg.vocab_size, batch, seq, seed=seed, step=step)
    r = _rng(seed ^ 0xF00D, step)
    if cfg.family == "encdec":
        out["frames"] = r.normal(0, 1, (batch, cfg.enc_seq, cfg.d_model)
                                 ).astype(np.float32)
    if cfg.family == "vlm":
        out["patch_embeds"] = r.normal(
            0, 1, (batch, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


def host_slice(batch_dict: Dict[str, np.ndarray], host_id: int,
               num_hosts: int) -> Dict[str, np.ndarray]:
    """This host's slice of the global batch (leading-axis shard)."""
    def sl(x):
        per = x.shape[0] // num_hosts
        return x[host_id * per : (host_id + 1) * per]
    return {k: sl(v) for k, v in batch_dict.items()}
