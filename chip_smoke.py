#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of MRG (paper Algorithm 1), coreset
selection, the weighted and outlier objectives, the streaming sketch, EIM
(paper §4), the online k-center service, the paper's machines as mesh
shards and as separate processes, and the LM of every family (serving,
training, and curating the dense model's embeddings by k-center) on one
GPU, in memory and out of core.

    python3 chip_smoke.py        # from the root of a checkout, one Hopper card

Phases, each of which raises on failure (nothing is caught):
  1. build  — compile every CUDA kernel from src/repro_torch/kernels/csrc
              with nvcc, one process per source, in parallel;
  2. kernels — each kernel against its plain PyTorch version on the card at
              its path's shapes: bitwise on exact-arithmetic inputs (integer
              coordinates), within tolerance on float inputs; times from
              CUDA events with the device queue backed up, so they are
              device times and not host enqueue times. 2a GON step (in
              memory and on the streamed super-shards, in the path's form:
              a run's workspace, the next center into a slot; edge cases:
              a misaligned machine stride, a masked machine, a tie across
              CTAs, two runs on one workspace, the streamed carry over 3
              blocks), 2b assign (in-memory path; both assign kernels
              timed at shapes on each side of the plan's routing); 2c
              filter (ranks 1, 17 and 129; its three kernels timed at
              shapes on each side of the plan's routing), 2d streamed
              assign and the assign's edge cases (d
              up to 1000, k up to
              2,000, n = 1 and below a stage, equidistant centers across
              center lanes and tiles, the sums entry's counts and integer
              weights against the plain assign and index_add_, a machine
              of zero weights), 2e per-center argmin (streamed path, at the
              super-shards that HostStreamExecutor(memory_budget=...)
              resolves; edge cases: m up to 300, d up to 1000 (smaller
              center tiles at 200, the wide kernel at 1000), n below a
              tile and 0, planted ties); 2f the sources' pinned upload ring
              against a lagging consumer;
  3. mrg    — ``repro_torch.core.mrg`` in memory at paper scale (UNIF/GAU/
              UNB at n = 1e6, kddlike, pokerlike) with impl="auto": launch
              counts (reset just before each run, read just after),
              synchronising calls reported by torch.cuda.set_sync_debug_mode,
              wall time, host time per GON iteration, and agreement with
              the same call at impl="ref" on the card and, on a small
              input, with the CPU;
  4. a profile of one in-memory mrg run (device busy share, time by kernel;
              one device kernel per GON iteration);
  5. the streamed path — ``mrg`` and ``select_coreset`` over point sources
              on HostStreamExecutor (a 1e7-point generator source, 608 MB of
              host points, on-disk shards), each against impl="ref" on the
              card, with launch counts, synchronising calls, blocks
              streamed, wall time, host time per GON iteration and the
              peak device memory against the
              stated budget; the streamed radius against the in-memory one
              (bitwise), and a small exact input against the CPU;
  6. a profile of one streamed mrg run (kernels against the ring's copies);
  2g, 2h, 2i (run with phase 2) — the weighted filter (fused_filter.cu's
              weighted entry) at ranks 1, 101 and 300 with integer weights,
              unit weights against the plain kernel, and the plain filter
              at rank 300; the filter's edge cases (n = 1 and below a
              tile, ranks 1 to 300 around 32 and 256, every row masked or
              weightless, duplicate values, extreme ds, center chunks, d
              up to 1000, both sides of the routing), both entries; the
              batched assign against the 2-D entry, and its
              sums entry (the weighted reducer's cluster weights) against the
              plain assign and index_add_; the pairwise kernel in f32 and f16
              at the sketch's bootstraps, a large block and the JAX repo's
              kernel-benchmark shapes (with the f32 product alone,
              torch.mm, as a yardstick), both routes timed on both sides
              of its plan's boundary, both grids of the large route, and
              its edge cases, each on its planned route (n or m of 1 and
              off every tile, d from 1 to 1,000 with odd widths on the
              tensor cores, x and c one tensor, m past 65,535 · 64, views
              off alignment);
  7. the weighted objective and (k,z)-center: kz_center in memory and out
              of core (a weighted host source with planted outliers, a
              1e7-point generator, an exact-tier input), weighted mrg and
              weighted select_coreset, against impl="ref" on the card, with
              launches, synchronising calls (kz_center: exactly its one
              coreset read), wall time, host time per GON iteration and
              peak device memory; weighted mrg and kz_center run twice
              with non-integer weights (are the float cluster sums the
              same?); select_coreset in memory (kddlike n = 400,000, k =
              100) against impl="ref";
  8. the streaming sketch over the 1e7-point generator and the kddlike host
              source, both insertion tails, against impl="ref" on the card:
              coverage passes, launches, synchronising calls, host time of
              the insertion tail apart from the coverage passes;
  9. profiles of one streamed kz_center run (no index_add_ or scatter
              kernel: the cluster weights are summed inside the assign) and
              one sketch run;
  2j (run with phase 2) — the assign (#2) at the device EIM path's S
              buffer (s_cap centers, empty slots at 1e18: 1e6 x 12,725 x 2
              and 400,000 x 10,867 x 38) and the filter (#3) at the streamed
              path's super-shards (1,864,135 x 18,597 x 2 at rank 129,
              573,580 x 16,033 x 38 at rank 122, ds and a 40 % H mask),
              each against its plain version run in row chunks of ~1 GB,
              every kernel of each plan timed; whether #2 and #3 round each
              pair's d2 alike on float inputs;
  10. EIM: ``eim(x, k, 1)`` (the key is the int seed 1, i.e.
              jax.random.PRNGKey(1)) — 10a the device path on UNIF/GAU/UNB
              at n = 1e6 (k = 25, 100) and kddlike n = 400,000, with
              launches, synchronising calls (exactly iterations + 2),
              iterations, |S|, |C| and overflow, against impl="ref" run with
              chunk= from a 1 GB tile, against SimExecutor(m=50), and beside
              mrg's radius and wall on the same input; 10b out of core on
              HostStreamExecutor (the 1e7-point generator at 64 MiB, kddlike
              n = 4e6 from host RAM at 256 MiB; exactly 2 synchronising calls
              an iteration; peak device memory within a stated allowance),
              against impl="ref" and the device path; 10c the exact tier
              (integer grids at n = 1e6, d = 2, and n = 5e5, d = 38): the
              device path on the kernels and on the plain route,
              SimExecutor and HostStreamExecutor, all bitwise; 10d profiles
              of one run of each form (device busy and idle share, time by
              kernel, host time enqueueing the sampler's draws).
  11. the online k-center service (``repro_torch.serve.KCenterService``,
              its query op ``engine.assign_bucketed`` on kernel #2): 11a the
              op at every query row bucket (1 row padded to 8, up to 256)
              against 11b's and 11c's center buckets, one live center, and
              50 live centers in 64 slots at d = 7 (the live set on the
              wide kernel, the bucket on the tiled one), exact and float:
              bitwise the kernel on the live rows and on the whole bucket,
              against the plain version bitwise (exact) or within
              tolerance, one launch a call, and times at 8 x 16 x 16, 256
              x 16 x 16 and 256 rows against the kddlike bucket; 11b the
              service at benchmarks/serve_bench.py's configuration (k=16,
              d=16, a gau bootstrap of 4096, 64 closed-loop clients of one
              row, 3 s a run): batched, unbatched, under live ingest (512
              rows every 2 ms) and open loop at 0.3 x the batched QPS,
              with QPS, latency percentiles, dispatches, mean batch,
              epochs, cache refreshes, host time a dispatch (pad and
              upload, launch, read), every answer bitwise the kernel assign
              on its epoch's centers, and exactly one synchronising call a
              dispatch slice; 11c the service at the sketch's kddlike
              configuration: phase 8's source ingested through
              ``submit_points`` (its sketch bitwise phase 8's), then the
              closed loop on held-out kddlike rows with no ingest and while
              the source is ingested again.
  12. the mesh (``MeshExecutor``, ``mrg_distributed``, ``ShardedSource``;
              every shard on the one card), each run with its wall after
              a warm-up (none for EIM), synchronising calls and launches:
              12a the fused path over a (50,) mesh, the paper's m = 50 as
              shards (unif n = 1e6, k = 25; kddlike n = 400,000, k = 100):
              rounds 2, 2k GON launches and one assign, bitwise
              SimExecutor(m=50), radius2 within rtol 1e-4 of impl="ref"
              and bitwise it on an exact-tier input of the same shape,
              the radius at most 4x GON's; 12b hierarchical over (2, 5, 5)
              (kddlike): rounds 4, 4k GON launches, at most 8x GON's
              radius; 12c the streamed path, shard_source of phase 5's
              unif generator (S = 8, 64 MiB a shard) and kddlike n = 4e6
              (S = 4, 256 MiB a shard): bitwise HostStreamExecutor over the
              same shards at the same block_rows, k x (steps + levels) GON
              launches (one batch of the S blocks a step), no synchronising
              call, peak device memory within S budgets + 2 unions + 16
              MiB; 12d over 4 shards at 256 MiB a shard: weighted mrg and
              kz_center (z = 100) on phase 7's kind of weighted kddlike,
              eim on kddlike n = 4e6 (key 1), each bitwise
              HostStreamExecutor's, and select_coreset(mesh=) on kddlike
              n = 400,000, k = 100 against impl="ref".
  13. the machines as separate processes (``repro_torch.launch.cluster``:
              worker processes over one gloo group, every worker on the
              card, each with only its own shards, a ProcessShardedSource
              of SliceSources): 13a 12c's unif generator over 2 processes
              of 4 shards (S = 8, 64 MiB a shard), mrg k = 25 and eim (key
              1); 13b kddlike n = 4e6 written once to a .npy file, each of
              4 processes memory-mapping its own rows (256 MiB a shard),
              mrg k = 100. Each worker checks its own runs (synchronising
              calls exactly 2 in mrg and 2 an iteration + 1 in eim; GON
              launches k x (steps + levels); peak device memory within its
              shards' budgets + 2 unions + 16 MiB; every local row read
              once a pass, no other; no jax) and prints its device,
              launches, syncs, peak, rows read and walls on a line of its
              own; the parent holds every process's centers, radius2,
              rounds and EIM sample bitwise against the one-process
              MeshExecutor over the same shards (12c's run for 13a's mrg).
              A failed worker fails the phase.
  14. the dense LM at qwen2-0.5b's full width (``repro_torch.models``,
              ``serve.Engine``; random weights from a seed): 14a the bf16
              model built on the card (494,032,768 parameters: param_counts
              and the norm scales), its bytes and peak memory; 14b the same
              architecture in f32 (TF32 off): forward on the card against
              forward on the CPU (B = 2, S = 16), and prefill over 600
              tokens (the chunked attend, queries padded) then 8 decode
              steps against forward over the 608 (logits within 1e-3 of the
              largest |logit|, greedy tokens equal wherever the top-2 margin
              exceeds twice that); 14c examples/serve_lm.py's loop (B = 4,
              16-token prompts, 32 greedy decode steps: tokens/s, ms a step,
              a profile of 8 steps) and Engine(slots=8, s_max=512) over 16
              requests of 4-200 prompt tokens (buckets 8-256), 32 tokens
              each, half greedy, half at temperature 0.7 with top-k 40 (one
              with top-p 0.9), run twice from the seed: every request its 32
              tokens in the vocabulary, the same tokens both runs,
              synchronising calls exactly one a step and one an admission;
              tokens/s, TTFT mean and p99, steps, peak memory; 14d
              curation: 4,096 sequences x 128 tokens embedded by bf16
              forward(return_hidden=True) through embed_batches (mean
              pooled in f32), select_coreset(emb, 64) against impl="ref"
              (check_coreset), and kernels #1, #2s and #5 alone at (1 x
              4,096 x 896, k = 64) against their plain versions, with
              times, bounds and the library's time.
  15. every other LM family at full width, one model at a time
              (configs/*.py full(), random weights from a seed):
              qwen2-vl-2b (vlm, M-RoPE), mamba2-370m (ssm), hymba-1.5b
              (hybrid), whisper-large-v3 (encdec) at full depth, dbrx-132b
              (moe) at 2 of its 40 layers (printed as a reduction: 40
              layers of experts are past one card). 15a the bf16 model
              built on the card, its parameters against param_counts plus
              the extra scales, bytes, build seconds, peak memory; 15b the
              architecture at depth 1 in f32 (whisper: 1 encoder + 1
              decoder layer over frames (2, 1500, 1280); qwen2-vl 272
              positions with patch embeddings): forward on the card against
              the CPU's, within 1e-3 of the largest |logit|, greedy tokens
              equal past twice that (MoE: tokens whose K-th and (K+1)-th
              router probabilities lie within 1e-3 left out and counted);
              15c prefill of 600 tokens (hymba 1,100, past its window) then
              8 decode steps against forward, at full depth, in f32 (within
              1e-3 of the largest |logit|) and in bf16 (within 5e-2; the
              ssm and hybrid families' steps printed, their prefill held:
              their bf16 decode drifts from forward in the JAX package too;
              MoE at a drop-free capacity, positions whose routing flipped
              left out and counted); 15d the Engine over 14c's 16 requests
              for the four decoder-only models, twice from one key, the
              same tokens, synchronising calls exactly one a step and one
              an admission, tokens/s, TTFT mean and p99, peak memory, a
              profile of 4 decode steps (kernels a step, idle share);
              whisper a B = 4 prefill and 32 greedy decode steps through
              models.api, twice, no synchronising call in the loop.
  16. LM training at full width (``repro_torch.optim``, ``.train``,
              ``.checkpoint``, ``.launch.train``; random weights from a
              seed; no kernel of the seven: the LM's products are cuBLAS):
              16a the bf16 product into f32 (the head's and the experts'
              cuBLAS call under an autograd Function) against the CPU's
              upcast product, its gradients within one bf16 step and few
              of them differing at all (a bf16-cotangent backward differs
              at many); then one f32 train step (TF32 off) of qwen2-0.5b
              (B = 2, S = 64) and mamba2-370m (B = 2, S = 256: SSD's chunk
              of 256) at full width and 2 layers, and one bf16 step of
              dbrx-132b at 1 layer (Adafactor, 2 microbatches, a bf16
              accumulator), card against CPU on the same weights: the
              loss, each gradient leaf against its largest |g|, the params
              after the step wherever the gradient element (and, for
              Adafactor, its row's and column's means of g^2) is resolved
              (elsewhere left out, counted, bounded by 2 lr, their share
              capped; sign flips counted); 16b train_loop,
              8 steps of 4 x 512 tokens in bf16 as each config has it
              (remat "full"; minicpm's WSD schedule from its config
              module; dbrx Adafactor, 2
              microbatches, a bf16 accumulator) for qwen2-0.5b,
              minicpm-2b, qwen2-vl-2b, mamba2-370m, hymba-1.5b,
              whisper-large-v3 at full depth and dbrx-132b at 1 of its 40
              layers: every loss and grad norm finite; ms a step, tokens a
              second, peak memory against the bytes reckoned from the
              shapes, the loss curve; one more step of qwen2 and dbrx
              profiled (kernels a step, idle share); the trained qwen2 serves 4
              requests through the Engine, no cache tensor with a graph;
              16c qwen2 at one batch under remat none, full, dots and
              blocks of 8 (3 blocks): the gradients bitwise alike, each
              setting's peak memory and ms; 16d qwen2 under train_loop with
              a checkpoint every 2 steps and a fault at step 3: the restart
              from step 2's checkpoint, run to step 6, bitwise an
              uninterrupted run's state; the checkpoint's bytes and its
              save and restore seconds. The whole run's seconds are
              printed before the kernels line.

Prints the card's name and power limit, one JSON line describing every
kernel, and as its last line ``{"ok": true, "device": {...}}``. Exits non-zero
without a CUDA device, and where the repository's package is missing.

    python3 chip_smoke.py --times SRC [SRC ...]

times the GON step, the per-center argmin, the assign (2-D, streamed and
batched, alone and with the cluster sums), in-memory select_coreset's
representative pass, the filter (#3 and #6 at the super-shards, the
covering-radius fold, EIM's form and the weighted form), the per-block
top-k merge at their path shapes, the pairwise kernel at phase 2i's shapes
in f32 and f16, and an empty kernel (the timing floor), in call forms that
every version of the kernels takes, for the ``repro_torch`` under each
``SRC`` directory in turn (one process each, in the order given), and
prints them side by side with a SHA-1 digest of each form's outputs, so
that equal digests show bitwise equal results. To compare a change with
its parent on one card, unpack the parent with ``git archive`` into a
git-ignored directory and name the trees parent, change, change, parent.

    python3 chip_smoke.py --cluster nccl     # on a host with 4 cards

runs the build and phase 13's cases alone with ``backend="nccl"``, a card
a worker (``cuda:{rank}``), each process's results held bitwise against
the one-process MeshExecutor as in phase 13.
"""
from __future__ import annotations

import functools
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
F16_TC_OPS_PER_S = 989e12      # H100 SXM f16 tensor cores, dense (data sheet)
GON_TOL = dict(rtol=1e-5, atol=0.0)        # tests/test_kernels.py
ASSIGN_TOL = dict(rtol=1e-4, atol=1e-4)    # tests/test_kernels.py
NEG = float(np.float32(-3.4e38))

# The path's shapes: GON step on m=50 machine blocks of per=20000 rows
# (n = 1e6, paper Fig. 4), on one super-shard of the streamed runs
# (HostStreamExecutor's round 1: kddlike at 256 MiB, unif n=1e7 at 64
# MiB) and on the final GON's union of 50 × 25 centers (one machine, a
# small launch), and pokerlike's round 1 (n = 25,010 on 50 machines, d =
# 10), and EIM's final GON over its compacted sample (one machine of 2^17
# rows, |C| padded to a power of two: unif n=1e6 and kddlike n=400,000 at
# k=25); assign over all n points (SimExecutor.radius2).
GON_SHAPES = [(50, 20_000, 2, "unif"), (50, 20_000, 38, "kddlike"),
              (1, 573_580, 38, "kddlike"), (1, 1_864_135, 2, "unif"),
              (1, 1_250, 2, "unif"), (50, 501, 10, "pokerlike"),
              (1, 131_072, 2, "unif"), (1, 131_072, 38, "kddlike")]
ASSIGN_SHAPES = [(1_000_000, 25, 2, "unif"), (1_000_000, 100, 2, "unif"),
                 (400_000, 100, 38, "kddlike")]
MRG_CONFIGS = [("unif", 1_000_000, 2, 25), ("unif", 1_000_000, 2, 100),
               ("gau", 1_000_000, 2, 25), ("gau", 1_000_000, 2, 100),
               ("unb", 1_000_000, 2, 25), ("unb", 1_000_000, 2, 100),
               ("kddlike", 400_000, 38, 25), ("pokerlike", 25_010, 10, 25)]
PROFILE_CONFIGS = [("unif", 1_000_000, 2, 25), ("kddlike", 400_000, 38, 25)]

# The streamed path's shapes: the super-shards that HostStreamExecutor(
# memory_budget=...) resolves — 1,864,135 rows for unif n = 1e7, d = 2 at
# 64 MiB; 573,580 rows for kddlike n = 4e6, d = 38 at 256 MiB — with the
# path's k. Filter rank 1 is the covering-radius fold (no ds, no mask),
# rank 17 EIM's form (phi * ln n at n = 1e7, with ds and an H mask), rank
# 129 the same at a larger phi.
SHARDS = [(1_864_135, 2, "unif"), (573_580, 38, "kddlike")]
FILTER_SHAPES = [(n, k, d, rank, gen) for n, d, gen in SHARDS
                 for k in (25, 100) for rank in (1, 17, 129)]
STREAM_ASSIGN_SHAPES = [(1_864_135, 25, 2, "unif"), (1_864_135, 100, 2, "unif"),
                        (573_580, 100, 38, "kddlike")]
ARGMIN_SHAPES = STREAM_ASSIGN_SHAPES
MiB = 1 << 20
# Device memory a streamed run may take beyond its memory_budget: the
# center union (added per run) plus this slack for the allocator's rounding
# of each live allocation (under 1 MiB each) and the kernels' small carries.
PEAK_SLACK = 16 * MiB


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def device_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` launches, after warm-up.

    A spin kernel first backs up the stream, so every launch is enqueued
    before the device reaches it and the events between launches measure
    device time only (not the host's enqueue time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(200_000_000)     # ~0.1 s of device time
    events[0].record()
    for i in range(reps):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1])
                             for i in range(reps))


def fmt(ms) -> str:
    """A time in ms as printed, or "None" where it was not measured."""
    return "None" if ms is None else f"{ms:.5f}"


def bound(nbytes: float, ops: float, tc_ops: float = 0.0):
    """(least ms, what bounds it): the bytes at the HBM rate against the
    operations, ``ops`` on the f32 units and ``tc_ops`` on the f16 tensor
    cores, each at its own peak. A kernel that runs its product on the
    tensor cores is held to their rate for it (at the f32 rate its bound
    would be slower than the kernel can run); its epilogue stays on the f32
    units, so the two times add."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S + tc_ops / F16_TC_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def generated(P, gen, n, d, seed):
    """n points of generator ``gen`` at width d (pokerlike's is fixed, 10)."""
    if gen == "pokerlike":
        return P.pokerlike(n, seed=seed)
    return P.GENERATORS[gen](n, d=d, seed=seed)


def exact_points(rng, shape):
    # small integers: every f32 sum of the kernels is exact in any order
    return np.floor(rng.random(shape) * 50).astype(np.float32)


def gon_step_pair(torch, engine, xt, c_slot, md, k=2, slot=1):
    """The GON step in the path's form (a workspace, the next center into
    ``slot`` of an (m, k, d) output) on the kernel and on the plain version,
    from the same inputs. Returns ``(kernel outputs, plain outputs)``, each
    ``(md, far_v, far_i, centers, indices)``."""
    m, _, d = xt.shape
    outs = []
    for impl in ("kernel", "ref"):
        centers = torch.full((m, k, d), -1.0, device=xt.device)
        indices = torch.full((m, k), -1, dtype=torch.int32, device=xt.device)
        ws = engine.gon_workspace(m, xt, impl=impl)
        got = engine.fused_min_argmax(xt, c_slot, md.clone(), impl=impl, ws=ws,
                                      centers=centers, indices=indices, slot=slot)
        outs.append((got[0], got[1].clone(), got[2].clone(), centers, indices))
    return outs


def phase_gon_step(torch, engine, P, rng, results):
    print("== phase 2a: GON step (gon_step.cu) against its plain version", flush=True)
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.fused_argfar import ctas_per_sm, gon_plan
    floor = device_ms(torch, lambda: torch.cuda._sleep(1))
    print(f"timing floor: an empty kernel takes {floor:.5f} ms by device_ms",
          flush=True)
    for m, per, d, gen in GON_SHAPES:
        for tier in ("exact", "float"):
            if tier == "exact":
                x = exact_points(rng, (m, per, d))
                md0 = np.floor(rng.random((m, per)) * 5000).astype(np.float32)
            else:
                x = generated(P, gen, m * per, d, 3).reshape(m, per, d)
                md0 = (rng.random((m, per)) * 1e4).astype(np.float32)
            md0[:, ::7] = NEG                  # masked rows
            xt = torch.from_numpy(x).cuda()
            ct = xt[:, 11].contiguous()
            md_t = torch.from_numpy(md0).cuda()
            got, want = gon_step_pair(torch, engine, xt, ct, md_t)
            torch.cuda.synchronize()
            err = (got[0] - want[0]).abs().max().item()
            if tier == "exact":
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"gon_step d={d} exact tier: not bitwise equal")
            else:
                check(torch.allclose(got[0], want[0], **GON_TOL),
                      f"gon_step d={d}: md beyond rtol 1e-5 (max err {err})")
                check(torch.allclose(got[1], want[1], **GON_TOL),
                      f"gon_step d={d}: far value beyond rtol 1e-5")
                top = torch.topk(want[0], 2, dim=1).values
                unique = (top[:, 0] - top[:, 1]) > 1e-5 * top[:, 0].abs()
                check(torch.equal(got[2][unique], want[2][unique]),
                      f"gon_step d={d}: far index differs where unique")
            # the next center is x[b, far] in slot 1, the index beside it
            rows = torch.arange(m, device=xt.device)
            check(torch.equal(got[3][:, 1], xt[rows, got[2].long()])
                  and torch.equal(got[4][:, 1], got[2]),
                  f"gon_step d={d} {tier}: slot 1 is not x[b, far]")
            ws = engine.gon_workspace(m, xt, impl="kernel")
            centers = torch.zeros((m, 2, d), device=xt.device)
            indices = torch.zeros((m, 2), dtype=torch.int32, device=xt.device)
            ms = device_ms(torch, lambda: engine.fused_min_argmax(
                xt, ct, md_t, impl="kernel", ws=ws, centers=centers,
                indices=indices, slot=1))
            plain = device_ms(torch, lambda: engine.fused_min_argmax(
                xt, ct, md_t, impl="ref", centers=centers, indices=indices,
                slot=1))
            read = device_ms(torch, lambda: xt.amax())
            nbytes = 4 * (m * per * d + m * d + 2 * m * per + 2 * m)
            b_ms, b_by = bound(nbytes, m * per * (3 * d + 2))
            plan = gon_plan(m, per, d, sm_count(0))
            print(f"gon_step m={m} per={per} d={d} {tier}: ok "
                  f"max_abs_err={err:.3g} kernel_ms={ms:.5f} plain_ms={plain:.5f} "
                  f"bound_ms={b_ms:.5f} ({b_by}) x_read_ms={read:.5f} (torch.amax(x), "
                  f"a yardstick of reading x once) plan={tuple(plan)} "
                  f"ctas_per_sm={ctas_per_sm(d, plan.smem)}", flush=True)
            results.append(dict(kernel="gon_step", shape=(m, per, d, gen),
                                tier=tier, err=err,
                                ms=ms, plain_ms=plain, bound_ms=b_ms,
                                bound_by=b_by, library_ms=None))
    gon_edge_cases(torch, engine, rng)


def gon_edge_cases(torch, engine, rng):
    """The GON kernel's edge cases, bitwise on the exact tier: a misaligned
    machine stride with a fully masked machine and equal maxima in two
    CTAs' tiles; two GON runs back to back on one workspace (its counters
    reset); the streamed carry over 3 blocks against one pass."""
    from repro_torch.core import gonzalez
    from repro_torch.core.gonzalez import _gonzalez_device
    from repro_torch.data.source import HostSource
    m, per, d = 3, 20_001, 3          # machine b starts at b·60,003 floats
    x = exact_points(rng, (m, per, d))
    md0 = np.floor(rng.random((m, per)) * 5000).astype(np.float32)
    md0[:, ::7] = NEG
    md0[m - 1] = NEG                  # a machine with no valid row
    x[0, 1_000] = x[0, 19_000] = 500.0    # equal maxima in two CTAs' tiles
    md0[0, 1_000] = md0[0, 19_000] = 1e9
    xt = torch.from_numpy(x).cuda()
    got, want = gon_step_pair(torch, engine, xt, xt[:, 5].contiguous(),
                              torch.from_numpy(md0).cuda())
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "gon_step per=20001 d=3: not bitwise the plain version")
    check(got[2].tolist() == [1_000, got[2][1].item(), 0]
          and got[1][2].item() == NEG,
          f"gon_step per=20001 d=3: far {got[2].tolist()} (tie or masked machine)")
    # a GON run of 25 steps on 50 machines, twice on one workspace
    x = exact_points(rng, (50, 20_000, 2))
    xt = torch.from_numpy(x).cuda()
    ws = engine.gon_workspace(50, xt, impl="kernel")
    runs = []
    for _ in range(2):
        centers = torch.empty((50, 25, 2), device=xt.device)
        indices = torch.empty((50, 25), dtype=torch.int32, device=xt.device)
        centers[:, 0] = xt[:, 0]
        indices[:, 0] = 0
        md = torch.full((50, 20_000), float(np.float32(3.4e38)), device=xt.device)
        for i in range(25):
            engine.fused_min_argmax(xt, centers[:, i], md, impl="kernel", ws=ws,
                                    centers=centers, indices=indices, slot=i + 1)
        runs.append((centers, indices, md))
    want = _gonzalez_device(xt, 25, impl="ref")
    torch.cuda.synchronize()
    check(all(torch.equal(r[0], want.centers) and torch.equal(r[1], want.indices)
              and torch.equal(r[2].clamp_min(0.0), want.min_d2) for r in runs),
          "GON twice on one workspace: differs from the plain version")
    check(int(ws.counter.abs().sum()) == 0, "GON workspace counters not reset")
    # the streamed carry: 3 blocks, a tie planted across blocks 0 and 2
    x = exact_points(rng, (30_000, 3))
    x[4_000] = x[25_000] = 400.0
    src = HostSource(x)
    streamed = gonzalez(src, 12, block_rows=10_000)
    one_pass = gonzalez(torch.from_numpy(x).cuda(), 12)
    plain = gonzalez(src, 12, block_rows=10_000, impl="ref")
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(streamed[:3], one_pass[:3]))
          and torch.equal(streamed.min_d2, one_pass.min_d2.cpu())
          and all(torch.equal(a, b) for a, b in zip(streamed, plain)),
          "streamed GON over 3 blocks differs from one pass or from the plain version")
    check(int(streamed.indices[1]) == 4_000,
          f"streamed GON: tie across blocks went to row {int(streamed.indices[1])}")
    print("gon_step edge cases: per=20001 d=3 (misaligned machines, a masked "
          "machine, a tie across two CTAs) bitwise; 2 runs of 25 steps on one "
          "workspace bitwise the plain GON, counters back to 0; streamed carry "
          "over 3 blocks == one pass == plain (tie across blocks kept by the "
          "first)", flush=True)


def phase_assign(torch, P, rng, results, name, op, shapes, title, seed):
    """Assign-shaped kernels — ``op(x, c, impl=...) -> (idx, d2)`` — against
    their plain versions: bitwise on integer inputs; on floats d2 within
    tolerance and the index equal where the nearest center is unique."""
    print(title, flush=True)
    from repro_torch.kernels import ref
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.assign import assign_plan
    for n, k, d, gen in shapes:
        for tier in ("exact", "float"):
            x = (exact_points(rng, (n, d)) if tier == "exact"
                 else P.GENERATORS[gen](n, d=d, seed=seed))
            xt = torch.from_numpy(x).cuda()
            ct = xt[torch.from_numpy(rng.choice(n, k, replace=False)).cuda()]
            got = op(xt, ct, impl="kernel")
            want = op(xt, ct, impl="ref")
            torch.cuda.synchronize()
            err = (got[1] - want[1]).abs().max().item()
            note = ""
            if tier == "exact":
                check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                      f"{name} n={n} k={k} d={d} exact tier: not bitwise equal")
            else:
                # rtol applies to |x|^2 + |c|^2, the terms that cancel: the
                # clamped decomposition's rounding error scales with them, so
                # near a center d2 carries ~eps·|x|^2 in either version
                tol = dist2_tol(xt, ct[want[0].long()])
                check(bool(((got[1] - want[1]).abs() <= tol).all()),
                      f"{name} n={n} k={k} d={d}: d2 beyond tolerance ({err})")
                strict = int((~torch.isclose(got[1], want[1], **ASSIGN_TOL)).sum())
                two = torch.topk(ref.pairwise_dist2(xt, ct), 2, dim=1,
                                 largest=False).values
                unique = (two[:, 1] - two[:, 0]) > 2 * tol
                check(torch.equal(got[0][unique], want[0][unique]),
                      f"{name} n={n} k={k} d={d}: index differs where unique")
                note = (f" rows_beyond_rtol_atol_1e-4_of_d2={strict}"
                        f" rows_index_compared={int(unique.sum())}")
            ms = device_ms(torch, lambda: op(xt, ct, impl="kernel"))
            plain = device_ms(torch, lambda: op(xt, ct, impl="ref"))
            lib = device_ms(torch, lambda: torch.cdist(xt, ct).min(1))
            nbytes = 4 * (n * d + k * d + 2 * n)
            b_ms, b_by = bound(nbytes, n * k * (2 * d + 5) + 2 * d * (n + k))
            plan = assign_plan(n, k, d, sm_count(0))
            print(f"{name} n={n} k={k} d={d} {tier}: ok max_abs_err={err:.3g} "
                  f"kernel_ms={ms:.5f} plain_ms={plain:.5f} library_ms={lib:.5f} "
                  f"(torch.cdist(x, c).min(1)) bound_ms={b_ms:.5f} ({b_by}){note} "
                  f"plan={tuple(plan)}", flush=True)
            results.append(dict(kernel=name, shape=(n, k, d, gen),
                                tier=tier, err=err,
                                ms=ms, plain_ms=plain, bound_ms=b_ms,
                                bound_by=b_by, library_ms=lib))


# The assign plan's routing (assign.WIDE_MAX_D, WIDE_MAX_KD): shapes on
# both sides of it, 1e6 rows of unif at each (k, d), a unif super-shard and
# the in-memory weighted reducer's batch.
ROUTING_SHAPES = ([(1, 1_000_000, 25, d) for d in (2, 4, 8, 12, 16, 24)]
                  + [(1, 1_000_000, 100, d) for d in (2, 4, 6, 8)]
                  + [(1, 1_864_135, 25, 2), (50, 20_000, 125, 2)])


def assign_routing(torch, engine, P, rng):
    """Times the assign as the plan routes it against the other kernel at
    ``ROUTING_SHAPES``, alone and with the sums (integer weights), each pair
    in one call: the evidence for the plan's routing of small widths and
    small k·d to the wide kernel. The other kernel is the plan with the
    routing thresholds set to 0 (the tiled kernel) or taken from the wide
    side; both give bitwise the same outputs, checked here."""
    from repro_torch.kernels import assign
    from repro_torch.kernels._build import sm_count
    print("assign routing (kernel_ms as planned / the other kernel; "
          "with the sums):", flush=True)

    def forced(tiled: bool):
        assign.assign_plan.cache_clear()
        assign.WIDE_MAX_D, assign.WIDE_MAX_KD = (0, 0) if tiled else (1 << 30, 1 << 30)

    saved = assign.WIDE_MAX_D, assign.WIDE_MAX_KD
    try:
        for m, n, k, d in ROUTING_SHAPES:
            x = P.unif(m * n, d=d, seed=7).reshape(m, n, d)
            xt = cuda_t(torch, x)
            ct = xt[:, :k].contiguous()
            wt = cuda_t(torch, int_weights(rng, m * n).reshape(m, n))
            acc = torch.zeros((m, k), device="cuda")
            times, outs = {}, {}
            for tiled in (True, False):
                forced(tiled)
                outs[tiled] = engine.assign_nearest_batched(xt, ct, impl="kernel")
                times[tiled] = (
                    device_ms(torch, lambda: engine.assign_nearest_batched(
                        xt, ct, impl="kernel")),
                    device_ms(torch, lambda: engine.assign_sums(
                        xt, ct, acc, wt, impl="kernel")))
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(outs[True], outs[False])),
                  f"assign routing m={m} n={n} k={k} d={d}: the kernels differ")
            assign.WIDE_MAX_D, assign.WIDE_MAX_KD = saved
            assign.assign_plan.cache_clear()
            chosen = assign.assign_plan(n, k, d, sm_count(0), m).tc > 0
            t, o = times[chosen], times[not chosen]
            print(f"  m={m} n={n} k={k} d={d}: planned={'tiled' if chosen else 'wide'} "
                  f"kernel_ms={t[0]:.5f} other_ms={o[0]:.5f} sums_ms={t[1]:.5f} "
                  f"other_sums_ms={o[1]:.5f} (bitwise equal)", flush=True)
    finally:
        assign.WIDE_MAX_D, assign.WIDE_MAX_KD = saved
        assign.assign_plan.cache_clear()


def assign_edge_cases(torch, engine, rng):
    """The assign kernel's edge cases, bitwise on the exact tier through the
    2-D, streamed and batched entries and the sums entry: widths past the
    register limit, smaller center tiles (d = 200) and the wide kernel (d =
    1000); k from 1 to 2,000 (several center tiles, chunks of them past the
    shared memory); n = 1 and n below one stage; two centers planted
    equidistant from a row, in two center lanes of one tile and in two
    tiles (or chunks), where the first must win; the sums (counts and
    integer weights) against the plain assign and index_add_, with and
    without the idx and d2 outputs; a batch with a machine of zero
    weights."""
    from repro_torch.kernels import ref
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.assign import assign_plan, assign_sums_cuda
    cases = [(50_000, k, d) for k in (1, 17, 129, 300) for d in (65, 130)]
    cases += [(50_000, 17, 200), (20_000, 300, 200), (20_000, 2_000, 38),
              (20_000, 129, 3), (5_000, 17, 1000), (2_000, 300, 1000),
              (1, 5, 3), (1, 300, 38), (100, 25, 2), (90, 7, 38), (1_000, 129, 38)]
    seen = []
    for n, k, d in cases:
        x = exact_points(rng, (n, d))
        c = exact_points(rng, (k, d))
        plan = assign_plan(n, k, d, sm_count(0), 1, True)
        # off the grid of [0, 50): only the planted centers lie near; (3, 4)
        # are two center lanes of a tile, (1, k - 1) two tiles where k
        # passes one (two chunks at k = 2,000, d = 38)
        planted = []
        if k >= 6 and n >= 6:
            planted = [(5, 60.0, 3, 4), (n - 1, 70.0, 1, k - 1)]
        elif k >= 2:
            planted = [(0, 60.0, 0, 1)]
        for r, v, a, b in planted:
            x[r] = v
            c[a], c[b] = v, v
            c[a, 0], c[b, 0] = v + 1.0, v - 1.0      # d2 = 1 from row r, both
        xt, ct = cuda_t(torch, x), cuda_t(torch, c)
        w = cuda_t(torch, rng.integers(0, 5, n).astype(np.float32))
        want = engine.assign_nearest(xt, ct, impl="ref")
        got = [engine.assign_nearest(xt, ct, impl="kernel"),
               engine.fused_assign(xt, ct, impl="kernel"),
               [t[0] for t in engine.assign_nearest_batched(xt[None], ct[None],
                                                            impl="kernel")]]
        sums = []
        for ww in (None, w):
            dtype = torch.int32 if ww is None else torch.float32
            plain = ref.assign_sums(xt, ct, torch.zeros(k, dtype=dtype, device="cuda"), ww)
            outs = (torch.empty(n, dtype=torch.int32, device="cuda"),
                    torch.empty(n, device="cuda"))
            sums += [(engine.assign_sums(xt, ct, torch.zeros_like(plain), ww,
                                         impl="kernel"), plain),
                     (engine.assign_sums(xt[None], ct[None], torch.zeros_like(plain)[None],
                                         None if ww is None else ww[None],
                                         impl="kernel")[0], plain),
                     (assign_sums_cuda(xt, ct, torch.zeros_like(plain), ww, idx=outs[0],
                                       d2=outs[1]), plain)]
            got.append(outs)
        torch.cuda.synchronize()
        check(all(torch.equal(g[0], want[0]) and torch.equal(g[1], want[1]) for g in got),
              f"assign edge n={n} k={k} d={d}: not bitwise the plain version")
        check(all(torch.equal(a, b) for a, b in sums),
              f"assign edge n={n} k={k} d={d}: sums not bitwise the plain assign + index_add_")
        for r, _, a, _ in planted:
            check(int(got[0][0][r]) == a,
                  f"assign edge n={n} k={k} d={d}: equidistant centers, row {r} took "
                  f"{int(got[0][0][r])}, not the first, {a}")
        seen.append((n, k, d, tuple(plan)[:3]))
    # a batch whose machine 1 weighs nothing: its sums stay 0
    for m, per, t, d in ((3, 5_000, 17, 38), (3, 20_001, 125, 2)):
        x = exact_points(rng, (m, per, d))
        xt = cuda_t(torch, x)
        ct = xt[:, :t].contiguous()
        w = cuda_t(torch, rng.integers(0, 5, (m, per)).astype(np.float32))
        w[1] = 0.0
        plain = ref.assign_sums(xt, ct, torch.zeros((m, t), device="cuda"), w)
        got = engine.assign_sums(xt, ct, torch.zeros_like(plain), w, impl="kernel")
        counts = engine.assign_sums(
            xt, ct, torch.zeros((m, t), dtype=torch.int32, device="cuda"), impl="kernel")
        torch.cuda.synchronize()
        check(torch.equal(got, plain) and not bool(got[1].any())
              and bool((counts.sum(1) == per).all()),
              f"assign sums batch m={m} per={per} t={t} d={d}: not the plain sums")
    print(f"assign edge cases (n, k, d, plan tc/sub/chunk): {seen} bitwise through "
          "the 2-D, streamed, batched and sums entries; equidistant centers across "
          "lanes and tiles go to the first; counts and integer weight sums bitwise "
          "the plain assign + index_add_; a machine of zero weights sums to 0",
          flush=True)


def dist2_tol(x, c):
    """Per-pair tolerance of a clamped d2 on float inputs, for the rows of
    ``x`` against the matching rows of ``c`` (or all of ``c``'s, by their
    largest norm): atol + rtol times |x|^2 + |c|^2, the terms that cancel
    (rounding in either version scales with them)."""
    cn = (c * c).sum(1)
    scale = (x * x).sum(1) + (cn if c.shape[0] == x.shape[0] else cn.max())
    return ASSIGN_TOL["atol"] + ASSIGN_TOL["rtol"] * scale


def shard_points(P, rng, n, d, gen, tier):
    if tier == "exact":
        return exact_points(rng, (n, d))
    return P.GENERATORS[gen](n, d=d, seed=5)


def phase_filter(torch, engine, P, rng, results):
    print("== phase 2c: filter (fused_filter.cu) against its plain version", flush=True)
    for n, k, d, rank, gen in FILTER_SHAPES:
        for tier in ("exact", "float"):
            xt = torch.from_numpy(shard_points(P, rng, n, d, gen, tier)).cuda()
            ct = xt[torch.from_numpy(rng.choice(n, k, replace=False)).cuda()]
            eim = rank > 1      # EIM's form carries ds and the H mask
            ds = (torch.from_numpy(np.floor(rng.random(n) * 5000).astype(np.float32)).cuda()
                  if eim else None)
            hm = torch.from_numpy(rng.random(n) < 0.7).cuda() if eim else None

            def run(impl, ds_in):
                return engine.fused_filter(xt, ct, ds_in, hm, rank=rank, impl=impl)

            got = run("kernel", None if ds is None else ds.clone())
            want = run("ref", None if ds is None else ds.clone())
            top_k = [engine.merge_top_k(engine.top_k_init(rank), r[1], rank)
                     for r in (got, want)]
            torch.cuda.synchronize()
            err = (got[1] - want[1]).abs().max().item()
            if eim:
                err = max(err, (got[0] - want[0]).abs().max().item())
            if tier == "exact":
                check(torch.equal(got[1], want[1])
                      and (not eim or torch.equal(got[0], want[0])),
                      f"filter n={n} k={k} d={d} rank={rank} exact tier: not bitwise")
            else:
                check(torch.allclose(top_k[0], top_k[1], rtol=1e-4, atol=1e-4),
                      f"filter n={n} k={k} d={d} rank={rank}: merged top beyond rtol 1e-4")
                if eim:
                    tol = dist2_tol(xt, ct)
                    check(bool(((got[0] - want[0]).abs() <= tol).all()),
                          f"filter n={n} k={k} d={d}: ds beyond tolerance ({err})")
            scratch = None if ds is None else ds.clone()
            ms = device_ms(torch, lambda: engine.fused_filter(
                xt, ct, scratch, hm, rank=rank, impl="kernel"))
            plain = device_ms(torch, lambda: engine.fused_filter(
                xt, ct, scratch, hm, rank=rank, impl="ref"), reps=5)
            ntiles = -(-n // engine.ref.FILTER_TILE_ROWS)
            nbytes = 4 * (n * d + k * d + ntiles * rank) + (9 * n if eim else 0)
            b_ms, b_by = bound(nbytes, n * k * (2 * d + 5) + 2 * d * (n + k))
            print(f"filter n={n} k={k} d={d} rank={rank} {'eim' if eim else 'fold'} "
                  f"{tier}: ok max_abs_err={err:.3g} kernel_ms={ms:.5f} "
                  f"plain_ms={plain:.5f} bound_ms={b_ms:.5f} ({b_by})", flush=True)
            results.append(dict(kernel="fused_filter", shape=(n, k, d, rank, gen),
                                tier=tier, err=err, ms=ms, plain_ms=plain,
                                bound_ms=b_ms, bound_by=b_by, library_ms=None))
    filter_routing(torch, engine, P)


# The filter plan's routing (fused_stream.SMALL_MAX_D, TILED_MIN_KD):
# shapes on both sides of it, unif at each (k, d), and the super-shards.
FILTER_ROUTING_SHAPES = ([(1_000_000, 25, d) for d in (2, 4, 8, 12, 16, 24)]
                         + [(1_000_000, 100, d) for d in (2, 4, 6, 8, 12)]
                         + [(1_864_135, 25, 2), (573_580, 25, 38)])
# Each route's thresholds that force it.
FILTER_ROUTES = {"small": (8, 1 << 30), "tiled": (0, 0), "wide": (0, 1 << 30)}


def forced_filter_route(fs, route):
    """Set ``fused_stream``'s routing thresholds so that ``filter_plan``
    takes ``route`` where that kernel takes the shape."""
    fs.SMALL_MAX_D, fs.TILED_MIN_KD = FILTER_ROUTES[route]
    fs.filter_plan.cache_clear()


def filter_routing(torch, engine, P):
    """Times the filter (rank 1, no ds; rank 17 with ds and a 70 % H mask)
    on each of its kernels that takes the shape, at ``FILTER_ROUTING_SHAPES``,
    in one call: the evidence for the plan's routing. Every kernel's outputs
    are checked bitwise equal."""
    from repro_torch.kernels import fused_stream as fs
    from repro_torch.kernels._build import sm_count
    print("filter routing (kernel_ms of each kernel at rank 1 / rank 17 with ds "
          "and mask; * = planned):", flush=True)
    saved = fs.SMALL_MAX_D, fs.TILED_MIN_KD
    rng = np.random.default_rng(11)
    try:
        for n, k, d in FILTER_ROUTING_SHAPES:
            xt = cuda_t(torch, P.unif(n, d=d, seed=7))
            ct = xt[:k].contiguous()
            ds0 = cuda_t(torch, np.floor(rng.random(n) * 5000).astype(np.float32))
            hm = cuda_t(torch, rng.random(n) < 0.7)
            fs.SMALL_MAX_D, fs.TILED_MIN_KD = saved
            fs.filter_plan.cache_clear()
            planned = fs.filter_plan(n, k, d, sm_count(0)).route
            times, outs = {}, {}
            for route in ("small", "tiled", "wide"):
                if route == "small" and d > 8:
                    continue
                forced_filter_route(fs, route)
                if fs.filter_plan(n, k, d, sm_count(0)).route != getattr(
                        fs, f"ROUTE_{route.upper()}"):
                    continue
                ds = ds0.clone()
                outs[route] = (engine.fused_filter(xt, ct, rank=1, impl="kernel")[1],
                               *engine.fused_filter(xt, ct, ds, hm, rank=17,
                                                    impl="kernel"))
                scratch = ds0.clone()
                times[route] = (
                    device_ms(torch, lambda: engine.fused_filter(xt, ct, rank=1,
                                                                 impl="kernel")),
                    device_ms(torch, lambda: engine.fused_filter(
                        xt, ct, scratch, hm, rank=17, impl="kernel")))
            torch.cuda.synchronize()
            first = next(iter(outs.values()))
            check(all(torch.equal(a, b) for o in outs.values() for a, b in zip(o, first)),
                  f"filter routing n={n} k={k} d={d}: the kernels differ")
            names = {fs.ROUTE_SMALL: "small", fs.ROUTE_TILED: "tiled",
                     fs.ROUTE_WIDE: "wide"}
            print(f"  n={n} k={k} d={d}: " + " ".join(
                f"{r}{'*' if names[planned] == r else ''}={t[0]:.5f}/{t[1]:.5f}"
                for r, t in times.items()) + " (bitwise equal)", flush=True)
    finally:
        fs.SMALL_MAX_D, fs.TILED_MIN_KD = saved
        fs.filter_plan.cache_clear()


def filter_edge_cases(torch, engine, rng):
    """The filter's edge cases, bitwise the plain version on the exact tier,
    through the plain and the weighted entry (unit weights bitwise the plain
    kernel): n = 1, below one tile and not a multiple of a tile or a stage;
    ranks 1, 2, 31, 32, 255, 256, 257 and 300; every candidate masked by
    hm, every weight <= 0; duplicate values across warps and tiles; ds at
    +3.4e38 and ds below every d2; k = 2,000 at d = 38 (center chunks); d
    = 200 (the tiled kernel's 128-row stages) and 1,000 (the wide kernel);
    widths on both sides of the small-d routing."""
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.fused_stream import filter_plan
    shapes = [(1, 5, 3), (100, 25, 2), (1_000, 7, 38), (50_001, 25, 2),
              (50_001, 100, 38), (20_000, 2_000, 38), (5_000, 17, 200),
              (2_000, 300, 1000), (30_000, 25, 8), (30_000, 25, 12),
              (30_000, 100, 8), (30_000, 100, 12), (30_000, 125, 16)]
    ranks = (1, 2, 31, 32, 255, 256, 257, 300)
    seen = []
    for n, k, d in shapes:
        x = exact_points(rng, (n, d))
        c = exact_points(rng, (k, d))
        dups = np.floor(rng.random((n, d)) * 3).astype(np.float32)
        w = rng.integers(0, 5, n).astype(np.float32)
        ds = np.floor(rng.random(n) * 5000).astype(np.float32)
        hm = rng.random(n) < 0.7
        variants = [("plain", x, None, None, None),
                    ("eim", x, ds, hm, w),
                    ("dups", dups, ds, None, None),
                    ("masked", x, ds, np.zeros(n, bool), w),
                    ("weightless", x, ds, hm, -rng.integers(0, 3, n).astype(np.float32)),
                    ("ds_big", x, np.full(n, np.float32(3.4e38)), hm, None),
                    ("ds_below", x, np.full(n, np.float32(-1.0)), hm, w)]
        for name, xv, dv, hv, wv in variants:
            xt, ct = cuda_t(torch, xv), cuda_t(torch, c)
            ht = None if hv is None else cuda_t(torch, hv)
            wt = None if wv is None else cuda_t(torch, wv)
            for rank in ranks:
                def run(impl, w_in):
                    dt = None if dv is None else cuda_t(torch, dv)
                    return engine.fused_filter(xt, ct, dt, ht, rank=rank, w=w_in,
                                               impl=impl)
                want = run("ref", wt)
                got = run("kernel", wt)
                outs = [(got, want)]
                if wt is None:    # unit weights: bitwise the plain kernel
                    outs.append((run("kernel", torch.ones(n, device="cuda")), got))
                torch.cuda.synchronize()
                for g, h in outs:
                    check(torch.equal(g[1], h[1])
                          and (dv is None or torch.equal(g[0], h[0])),
                          f"filter edge n={n} k={k} d={d} {name} rank={rank}: not "
                          "bitwise the plain version")
        seen.append((n, k, d, tuple(filter_plan(n, k, d, sm_count(0)))[:4]))
    print(f"filter edge cases (n, k, d, plan route/tc/sub/chunk): {seen} at ranks "
          f"{list(ranks)}, each plain, EIM's form (ds, mask, weights), duplicate "
          "values, every row masked, every weight <= 0, ds at +3.4e38 and below "
          "every d2: bitwise the plain version; unit weights bitwise the plain "
          "kernel", flush=True)


def phase_argmin(torch, engine, P, rng, results):
    print("== phase 2e: per-center argmin (argmin_rows.cu) against its plain "
          "version", flush=True)
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.fused_stream import (argmin_carry, argmin_ctas_per_sm,
                                                  argmin_plan, fused_argmin_cuda,
                                                  unpack_argmin)
    for n, m, d, gen in ARGMIN_SHAPES:
        for tier in ("exact", "float"):
            xt = torch.from_numpy(shard_points(P, rng, n, d, gen, tier)).cuda()
            ct = xt[torch.from_numpy(rng.choice(n, m, replace=False)).cuda()]
            if tier == "exact":     # exact ties: a center's duplicates further on
                xt[n - 1] = ct[0]
                xt[n // 2] = ct[1]
            got = engine.fused_argmin(xt, ct, impl="kernel")
            want = engine.fused_argmin(xt, ct, impl="ref")
            # the carry across two blocks with a row offset equals one pass
            h = n // 3
            carry = argmin_carry(m, xt.device)
            fused_argmin_cuda(xt[:h], ct, carry, 0)
            fused_argmin_cuda(xt[h:], ct, carry, h)
            split = unpack_argmin(carry)
            torch.cuda.synchronize()
            err = (got[0] - want[0]).abs().max().item()
            check(torch.equal(split[0], got[0]) and torch.equal(split[1], got[1]),
                  f"argmin n={n} m={m} d={d} {tier}: two blocks differ from one pass")
            if tier == "exact":
                check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                      f"argmin n={n} m={m} d={d} exact tier: not bitwise")
            else:
                two = torch.topk(engine.ref.pairwise_dist2(ct, xt), 2, dim=1,
                                 largest=False).values
                tol = dist2_tol(ct, xt[want[1].long()])
                check(bool(((got[0] - want[0]).abs() <= tol).all()),
                      f"argmin n={n} m={m} d={d}: d2 beyond tolerance ({err})")
                unique = (two[:, 1] - two[:, 0]) > 2 * tol
                check(torch.equal(got[1][unique], want[1][unique]),
                      f"argmin n={n} m={m} d={d}: row differs where unique")
            # the path's call on a source's first block: every timed launch
            # folds into a fresh carry, so its atomicMins run
            fresh = iter([argmin_carry(m, xt.device) for _ in range(23)])
            ms = device_ms(torch, lambda: fused_argmin_cuda(xt, ct, next(fresh)),
                           reps=20, warmup=3)
            plain = device_ms(torch, lambda: engine.fused_argmin(xt, ct, impl="ref"),
                              reps=5)
            lib = device_ms(torch, lambda: torch.cdist(ct, xt).min(1), reps=5)
            nbytes = 4 * (n * d + m * d) + 16 * m
            b_ms, b_by = bound(nbytes, n * m * (2 * d + 5) + 2 * d * (n + m))
            plan = argmin_plan(n, m, d, sm_count(0))
            print(f"argmin n={n} m={m} d={d} {tier}: ok max_abs_err={err:.3g} "
                  f"kernel_ms={ms:.5f} plain_ms={plain:.5f} library_ms={lib:.5f} "
                  f"(torch.cdist(c, x).min(1)) bound_ms={b_ms:.5f} ({b_by}) "
                  f"plan={tuple(plan)} ctas_per_sm="
                  f"{argmin_ctas_per_sm(plan.tc, plan.smem) if plan.tc else None}",
                  flush=True)
            results.append(dict(kernel="argmin_rows", shape=(n, m, d, gen),
                                tier=tier, err=err, ms=ms, plain_ms=plain,
                                bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    argmin_edge_cases(torch, engine, rng)


def argmin_edge_cases(torch, engine, rng):
    """The argmin kernel's edge cases, bitwise on the exact tier: center
    counts past one tile and widths past the old register limit, n below
    one tile and n = 0, ties inside one thread's rows and across CTAs, and
    widths that take smaller center tiles (d = 200) or the wide kernel
    (d = 1000)."""
    from repro_torch.kernels.fused_stream import argmin_carry, fused_argmin_cuda
    cases = [(50_000, m, d) for m in (1, 129, 300) for d in (65, 130)]
    cases += [(100, 25, 2), (90, 7, 38), (573_580, 100, 38), (1_864_135, 25, 2)]
    cases += [(50_000, m, 200) for m in (1, 129)] + [(20_000, m, 1000) for m in (1, 300)]
    for n, m, d in cases:
        x = exact_points(rng, (n, d))
        c = exact_points(rng, (m, d))
        c[0], c[-1] = 70.0, 80.0      # off the grid: only the planted rows match
        if n > 200:
            # rows 130 and 194 are one thread's (64 apart in a 128-row
            # sub-tile); rows n // 2 and n - 1 lie in two CTAs' stages
            x[130] = x[194] = c[0]
            x[n // 2] = x[n - 1] = c[-1]
        xt, ct = torch.from_numpy(x).cuda(), torch.from_numpy(c).cuda()
        got = engine.fused_argmin(xt, ct, impl="kernel")
        want = engine.fused_argmin(xt, ct, impl="ref")
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"argmin edge n={n} m={m} d={d}: not bitwise")
        if n > 200:
            check(int(got[1][0]) == 130 and (m == 1 or int(got[1][-1]) == n // 2),
                  f"argmin edge n={n} m={m} d={d}: planted ties lost")
    carry = argmin_carry(5, "cuda")
    before = fused_argmin_cuda.launches
    fused_argmin_cuda(torch.empty((0, 3), device="cuda"),
                      torch.ones((5, 3), device="cuda"), carry, 7)
    check(fused_argmin_cuda.launches == before
          and torch.equal(carry, argmin_carry(5, "cuda")),
          "argmin n=0: the carry changed or a kernel launched")
    print(f"argmin edge cases: {[(n, m, d) for n, m, d in cases]} bitwise, ties "
          "inside one thread's rows and across CTAs kept by the first row; n=0 "
          "leaves the carry", flush=True)


def phase_ring(torch, P):
    print("== phase 2f: pinned upload ring against a lagging consumer", flush=True)
    from repro_torch.data.source import HostSource
    x = P.unif(1_000_000, d=3, seed=8)
    want = torch.from_numpy(x).cuda()
    for prefetch in (1, 2, 4):
        for rows in (65_536, 333_333):
            copies = []
            for blk in HostSource(x).blocks(rows, prefetch=prefetch):
                torch.cuda._sleep(1_000_000)     # the consumer lags the copies
                copies.append(blk.clone())
            got = torch.cat(copies)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"ring prefetch={prefetch} rows={rows}: blocks differ from the host rows")
            print(f"ring prefetch={prefetch} rows={rows} blocks={len(copies)}: "
                  "every block equals its host rows", flush=True)


def sync_warnings(caught):
    # set_sync_debug_mode's own notice ("... a prototype feature ...") is not
    # a synchronising call; each real one warns with this text
    return [w for w in caught
            if str(w.message).startswith("called a synchronizing CUDA")]


def phase_mrg(torch, mrg, counters, P):
    print("== phase 3: mrg end to end, impl='auto' against impl='ref' on the card",
          flush=True)
    # positive control: the counter sees one synchronising call
    probe = torch.ones(4).cuda()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        probe.sum().item()
        torch.cuda.set_sync_debug_mode(0)
    check(len(sync_warnings(caught)) == 1, "sync detection control failed")
    totals = {name: 0 for name in counters}
    for gen, n, d, k in MRG_CONFIGS:
        x = (P.pokerlike(n, seed=0) if gen == "pokerlike"
             else P.GENERATORS[gen](n, d=d, seed=0))
        xt = torch.from_numpy(x).cuda()
        mrg(xt, k, m=50)                       # warm-up
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            res = mrg(xt, k, m=50)
            torch.cuda.set_sync_debug_mode(0)
        launches = {name: fn.launches for name, fn in counters.items()}
        syncs = sync_warnings(caught)
        for w in syncs:
            print(f"  sync: {str(w.message)[:120]!r} at {w.filename}:{w.lineno}",
                  flush=True)
        check(not syncs, f"mrg {gen} n={n} k={k}: {len(syncs)} synchronising calls")
        for name, c in launches.items():
            check(c > 0, f"mrg {gen} n={n} k={k}: kernel {name} never launched")
            totals[name] += c
        with gon_clock() as clock:
            walls = wall_ms(torch, lambda: mrg(xt, k, m=50), runs=10)
        ref = mrg(xt, k, m=50, impl="ref")
        torch.cuda.synchronize()
        check(tuple(res.centers.shape) == (k, d), "centers shape")
        check(bool(torch.isfinite(res.centers).all()), "centers not finite")
        r2, r2_ref = res.radius2.item(), ref.radius2.item()
        check(np.isfinite(r2) and r2 >= 0, f"radius2 {r2}")
        check(res.rounds == ref.rounds, f"rounds {res.rounds} vs ref {ref.rounds}")
        differ = int((res.centers != ref.centers).any(dim=1).sum())
        if gen == "pokerlike":
            check(differ == 0 and r2 == r2_ref,
                  f"pokerlike: centers/radius2 differ from impl='ref' ({differ})")
        else:
            check(abs(r2 - r2_ref) <= 1e-4 * abs(r2_ref),
                  f"{gen}: radius2 {r2} vs ref {r2_ref} beyond rtol 1e-4")
        print(f"mrg {gen} n={n} d={d} m=50 k={k}: rounds={res.rounds} "
              f"radius={r2 ** 0.5:.6g} radius2={r2!r} ref_radius2={r2_ref!r} "
              f"centers_differing_from_ref={differ} "
              f"wall_ms_median={statistics.median(walls):.3f} "
              f"launches={launches} sync_warnings={len(syncs)} "
              f"{gon_host_note(clock, 10, launches)}", flush=True)
    return totals


def gon_clock():
    """A host clock around every GON run the executors start."""
    from repro_torch.core import executor
    return HostClock(executor, ("_gonzalez_device",))


def gon_host_note(clock, runs, launches):
    """Host time of the GON runs per GON iteration (one kernel launch each),
    from ``clock`` over ``runs`` runs of ``launches['gon_step']`` launches."""
    iters = runs * launches["gon_step"]
    us = clock.ms.get("_gonzalez_device", 0.0) * 1e3 / iters if iters else 0.0
    return (f"gon_iterations={launches['gon_step']} "
            f"gon_host_us_per_iteration={us:.2f}")


def phase_small_vs_cpu(torch, mrg, P):
    x = P.pokerlike(3000, seed=5)
    gpu = mrg(torch.from_numpy(x).cuda(), 12, m=8)
    cpu = mrg(x, 12, m=8, device="cpu")
    check(torch.equal(gpu.centers.cpu(), cpu.centers)
          and gpu.radius2.item() == cpu.radius2.item()
          and gpu.rounds == cpu.rounds,
          "small pokerlike mrg on the card differs from the CPU plain path")
    print("mrg pokerlike n=3000 k=12 m=8: card (kernels) == CPU (plain) bitwise",
          flush=True)


def phase_profile(torch, mrg, P, gen, n, d, k, gon):
    print(f"== phase 4: profile of one mrg run ({gen} n={n} d={d} m=50 k={k})",
          flush=True)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    xt = torch.from_numpy(P.GENERATORS[gen](n, d=d, seed=0)).cuda()
    mrg(xt, k, m=50)
    torch.cuda.synchronize()
    gon.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mrg(xt, k, m=50)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("profile: no device time recorded (not measured)", flush=True)
        return
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels)) / 1e3
    print(f"profile: wall_ms={wall_ms:.3f} (profiler on) device_span_ms={span:.3f} "
          f"device_busy_ms={busy:.3f} idle_share_of_wall={1 - busy / wall_ms:.4f} "
          f"kernels={len(kernels)}", flush=True)
    # one device kernel per GON iteration: no second reduce kernel and no
    # gather of the next center (the gathers left are once a GON run)
    steps = sum("gon_kernel" in e.name for e in kernels)
    reduces = sum("gon_reduce" in e.name for e in kernels)
    gathers = sum("index" in e.name.lower() for e in kernels)
    check(steps == gon.launches and reduces == 0,
          f"profile: {steps} GON kernels and {reduces} reduce kernels for "
          f"{gon.launches} GON iterations")
    print(f"profile: gon_iterations={gon.launches} gon_kernels={steps} "
          f"gon_reduce_kernels={reduces} index_kernels={gathers} "
          f"device_kernels_per_gon_iteration={steps / gon.launches:.2f}", flush=True)
    by_name = {}
    for e in kernels:
        ms, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    for name, (ms, count) in sorted(by_name.items(), key=lambda r: -r[1][0])[:10]:
        print(f"  {ms:9.4f} ms  {count:6d}x  {name[:90]}", flush=True)


def counted_run(torch, fn, counters):
    """``fn()`` once with every launch counter and the upload count at 0
    just before and read just after, synchronising calls recorded, and the
    peak device memory above what was allocated before. Returns
    ``(result, launches, syncs, blocks uploaded, peak bytes)``."""
    from repro_torch.data.source import stream_device
    torch.cuda.synchronize()
    for fn_ in counters.values():
        fn_.launches = 0
    stream_device.uploads = 0
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        res = fn()
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in counters.items()}
    return (res, launches, sync_warnings(caught), stream_device.uploads,
            torch.cuda.max_memory_allocated() - base)


def wall_ms(torch, fn, runs: int = 2):
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def near_tie_rows(torch, engine, src, centers, rows):
    """Rows whose two nearest centers lie within twice the d2 tolerance of
    each other (plain version): a rounding difference may move them."""
    ties = 0
    for blk in src.blocks(rows):
        two = torch.topk(engine.ref.pairwise_dist2(blk, centers), 2, dim=1,
                         largest=False)
        tol = dist2_tol(blk, centers[two.indices[:, 0]])
        ties += int(((two.values[:, 1] - two.values[:, 0]) <= 2 * tol).sum())
    return ties


def check_coreset(torch, engine, label, src, rows, got, want, max_weight=1):
    """Same centers, representatives and weights as impl="ref"; where the
    float rounding of the two versions may differ, only on near ties (a
    moved row of weight at most ``max_weight`` moves that much weight out
    of one cluster and into another)."""
    check(torch.equal(got.centers, want.centers), f"{label}: centers differ from ref")
    moved = int((got.weights - want.weights).abs().sum())
    ties = near_tie_rows(torch, engine, src, got.centers, rows) if moved else 0
    check(moved <= 2 * ties * max_weight,
          f"{label}: weights move {moved} beyond the {ties} near ties")
    differ = (got.indices != want.indices).nonzero().flatten().tolist()
    for j in differ:     # both rows must be equally near center j
        pair = torch.from_numpy(src.take([int(got.indices[j]),
                                          int(want.indices[j])])).cuda()
        d2 = engine.ref.pairwise_dist2(pair, got.centers[j:j + 1])[:, 0]
        tol = dist2_tol(pair, got.centers[j:j + 1].expand(2, -1))
        check(bool((d2[0] - d2[1]).abs() <= 2 * tol.max()),
              f"{label}: representative of center {j} differs beyond a tie")
    return moved, ties, len(differ)


def phase_streamed(torch, engine, P, counters):
    print("== phase 5: the streamed path on HostStreamExecutor, impl='auto' "
          "against impl='ref' on the card", flush=True)
    from repro_torch.core import (HostStreamExecutor, SimExecutor, covering_radius,
                                  gonzalez, mrg, select_coreset)
    from repro_torch.data.source import HostSource, MemmapSource, synthetic_source
    paths = {"mrg": ("gon_step", "fused_filter"),
             "coreset": ("gon_step", "fused_filter", "assign_sums", "argmin_rows")}
    totals = {name: 0 for name in counters}
    kdd = HostSource(kdd_host(P))                        # 608 MB of host points
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        gau = MemmapSource.save_shards(P.gau(2_000_000, seed=0), tmp,
                                       rows_per_shard=500_000)
        runs = [
            ("mrg unif n=1e7 d=2 synthetic", "mrg",
             synthetic_source("unif", 10_000_000, d=2, seed=0), 25, 64 * MiB),
            ("mrg unif n=1e7 d=2 synthetic", "mrg",
             synthetic_source("unif", 10_000_000, d=2, seed=0), 100, 64 * MiB),
            ("mrg kddlike n=4e6 d=38 host", "mrg", kdd, 25, 256 * MiB),
            ("mrg gau n=2e6 d=2 memmap 4 shards", "mrg", gau, 25, None),
            ("select_coreset kddlike n=4e6 d=38 host", "coreset", kdd, 100,
             256 * MiB),
        ]
        for label, kind, src, k, budget in runs:
            ex = HostStreamExecutor(memory_budget=budget)
            rows = ex.rows_for(src)
            if kind == "mrg":
                def fn(impl="auto"):
                    return mrg(src, k, executor=ex, impl=impl)
            else:
                def fn(impl="auto"):
                    return select_coreset(src, k, executor=ex, impl=impl)
            fn()                                   # warm-up
            res, launches, syncs, blocks, peak = counted_run(torch, fn, counters)
            with gon_clock() as clock:
                walls = wall_ms(torch, fn)
            ref = fn("ref")
            torch.cuda.synchronize()
            label = f"{label} k={k} super-shard rows={rows}"
            for w in syncs:
                print(f"  sync: {str(w.message)[:120]!r} at {w.filename}:{w.lineno}",
                      flush=True)
            check(not syncs, f"{label}: {len(syncs)} synchronising calls")
            for name in paths[kind]:
                check(launches[name] > 0, f"{label}: kernel {name} never launched")
            for name, c in launches.items():
                totals[name] += c
            shards = -(-src.n // rows)
            allowed = (ex.prefetch + 1) * 4 * rows * (src.d + 1)
            # the union of the shards' centers and its validity, twice
            # while it is concatenated
            allowed += 2 * shards * k * (4 * src.d + 1) + PEAK_SLACK
            check(peak <= allowed, f"{label}: peak device memory {peak} bytes "
                  f"above the allowed {allowed}")
            check(tuple(res.centers.shape) == (k, src.d)
                  and bool(torch.isfinite(res.centers).all()), f"{label}: centers")
            r2, r2_ref = res.radius2.item(), ref.radius2.item()
            check(np.isfinite(r2) and abs(r2 - r2_ref) <= 1e-4 * abs(r2_ref),
                  f"{label}: radius2 {r2} vs ref {r2_ref} beyond rtol 1e-4")
            note = ""
            if kind == "mrg":
                check(res.rounds == ref.rounds, f"{label}: rounds differ from ref")
                check(torch.equal(res.centers, ref.centers),
                      f"{label}: centers differ from ref")
                note = f"rounds={res.rounds}"
            else:
                moved, ties, idiff = check_coreset(torch, engine, label, src,
                                                   rows, res, ref)
                note = (f"weights_sum={int(res.weights.sum())} "
                        f"weight_rows_moved_vs_ref={moved} near_tie_rows={ties} "
                        f"representatives_differing={idiff}")
            print(f"{label}: ok {note} radius2={r2!r} ref_radius2={r2_ref!r} "
                  f"wall_ms={[round(w, 3) for w in walls]} launches={launches} "
                  f"{gon_host_note(clock, len(walls), launches)} "
                  f"sync_warnings={len(syncs)} blocks_streamed={blocks} "
                  f"peak_MiB={peak / MiB:.2f} allowed_MiB={allowed / MiB:.2f} "
                  f"budget_MiB={None if budget is None else budget / MiB}",
                  flush=True)
            if kind == "mrg" and src.n >= 4_000_000 and budget is not None:
                # the streamed fold (filter) against the in-memory pass (assign)
                x = src.materialize("cuda")
                a = ex.radius2(src, res.centers)
                b = SimExecutor(50).radius2(x, res.centers)
                check(a.item() == b.item(),
                      f"{label}: HostStreamExecutor.radius2 {a.item()!r} != "
                      f"SimExecutor.radius2 {b.item()!r}")
                print(f"{label}: HostStreamExecutor.radius2 == SimExecutor.radius2 "
                      f"bitwise ({a.item()!r})", flush=True)
                del x
    x = P.pokerlike(3000, seed=5)
    src = HostSource(x)
    card, cpu = HostStreamExecutor(block_rows=1000), HostStreamExecutor(
        block_rows=1000, device="cpu")
    a, b = mrg(src, 12, executor=card), mrg(src, 12, executor=cpu)
    ca, cb = (select_coreset(src, 12, executor=e) for e in (card, cpu))
    check(torch.equal(a.centers.cpu(), b.centers) and a.radius2.item() == b.radius2.item()
          and a.rounds == b.rounds, "streamed pokerlike mrg: card != CPU")
    check(all(torch.equal(p.cpu(), q) for p, q in zip(ca, cb)),
          "streamed pokerlike select_coreset: card != CPU")
    # GON streamed over the source (no executor), its coreset and radius
    gon = counters["gon_step"]
    gon.launches = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        ga = gonzalez(src, 12, block_rows=1000)
        torch.cuda.set_sync_debug_mode(0)
    syncs = len(sync_warnings(caught))
    # one wait, at the end, for the per-row distances returned on the host
    check(syncs <= 1, f"streamed gonzalez: {syncs} synchronising calls")
    # one GON launch per block and pass: 12 passes over 3 blocks
    check(gon.launches == 36, f"streamed gonzalez: {gon.launches} GON launches, not 36")
    gb = gonzalez(src, 12, block_rows=1000, device="cpu")
    check(all(torch.equal(p.cpu(), q) for p, q in zip(ga, gb)),
          "streamed pokerlike gonzalez: card != CPU")
    sa = select_coreset(src, 12, block_rows=1000)
    sb = select_coreset(src, 12, block_rows=1000, device="cpu")
    check(all(torch.equal(p.cpu(), q) for p, q in zip(sa, sb)),
          "streamed pokerlike select_coreset without an executor: card != CPU")
    ra = covering_radius(src, ga.centers, block_rows=1000)
    rb = covering_radius(src, gb.centers, block_rows=1000, device="cpu")
    check(ra.item() == rb.item(), "streamed pokerlike covering_radius: card != CPU")
    print("streamed mrg, select_coreset (with and without an executor), gonzalez "
          "and covering_radius, pokerlike n=3000 k=12 block_rows=1000: card "
          f"(kernels) == CPU (plain) bitwise; streamed gonzalez sync_warnings={syncs} "
          "gon_launches=36 (one a block and pass)",
          flush=True)
    return totals


def phase_stream_profile(torch, P):
    print("== phase 6: profile of one streamed mrg run (unif n=1e7 d=2 k=25, "
          "64 MiB)", flush=True)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import HostStreamExecutor, mrg
    from repro_torch.data.source import synthetic_source
    src = synthetic_source("unif", 10_000_000, d=2, seed=0)
    ex = HostStreamExecutor(memory_budget=64 * MiB)
    rows = ex.rows_for(src)
    t0 = time.perf_counter()
    for _ in src.host_blocks(rows):
        pass
    host_ms = (time.perf_counter() - t0) * 1e3
    mrg(src, 25, executor=ex)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mrg(src, 25, executor=ex)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        print("profile: no device time recorded (not measured)", flush=True)
        return
    copies = [e for e in events if e.name.startswith("Memcpy")]
    kernels = [e for e in events if not e.name.startswith(("Memcpy", "Memset"))]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    copy = sum(e.time_range.elapsed_us() for e in copies) / 1e3
    print(f"profile: wall_ms={wall:.3f} (profiler on) kernel_busy_ms={busy:.3f} "
          f"kernels={len(kernels)} copy_ms={copy:.3f} copies={len(copies)} "
          f"idle_share_of_wall={1 - busy / wall:.4f} "
          f"host_block_generation_ms_per_pass={host_ms:.3f}", flush=True)
    by_name = {}
    for e in events:
        ms, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    for name, (ms, count) in sorted(by_name.items(), key=lambda r: -r[1][0])[:10]:
        print(f"  {ms:9.4f} ms  {count:6d}x  {name[:90]}", flush=True)


# -- slice 3: the weighted objective, (k,z)-center and the streaming sketch --

# Phase 2g: the weighted filter at the super-shards, with the path's k (25
# for kz_center's and weighted mrg's radius, 125 = t, a round-1 coreset's
# size) and ranks (1: the weighted radius fold; 101: kz_center's z + 1 at
# z = 100; 300: past a tile's 256 candidates).
W_FILTER_SHAPES = [(n, k, d, rank, gen) for n, d, gen in SHARDS
                   for k in (25, 125) for rank in (1, 101, 300)]
# Phase 2h: the weighted reducer's assign, m=50 machines of per=20,000 rows
# against their own t=125 centers (kz_center in memory, unif n=1e6; kddlike
# at d = 38).
BATCHED_SHAPES = [(50, 20_000, 125, 2, "unif"), (50, 20_000, 125, 38, "kddlike"),
                  (1, 573_580, 125, 38, "kddlike")]
# The last: phase 9's round 1, one kddlike super-shard of the streamed
# weighted kz_center against its t = k + z = 125 centers, where the sums
# entry adds the cluster weights (the JSON line's assign_sums row).
KZ_ROUND1 = BATCHED_SHAPES[2]
# Phase 2i: the sketch's bootstraps (k=100 on kddlike, k=25 on unif), a
# large block, and the JAX repo's kernel benchmark
# (benchmarks/kernel_bench.py: 100,000 × 256 at d = 2 and 64, 20,000 ×
# 1,024 at d = 128).
PAIRWISE_SHAPES = [(101, 101, 38), (65_536, 1_024, 38), (26, 26, 2),
                   (100_000, 256, 2), (100_000, 256, 64), (20_000, 1_024, 128)]
# Phase 2i's routing lines: square outputs on both sides of pairwise_plan's
# boundary (4, 9 and 16 large tiles at 256², 384² and 512²), both routes
# forced, at the sketch's widths.
PAIRWISE_ROUTING = [(s, s, d) for d in (2, 38) for s in (101, 256, 384, 512, 768, 1_024)]
# Its grid lines: the large route in f32 with persistent CTAs against a CTA
# a tile, on both sides of PERSIST_MIN_D.
PAIRWISE_GRID = ([(100_000, 256, d) for d in (2, 4, 8, 16, 38)]
                 + [(65_536, 1_024, d) for d in (2, 8, 16, 38)])
PAIRWISE_TOL = {"float32": 1e-4, "float16": 3e-2}      # tests/test_kernels.py
KZ_Z = 100
# --times: the filter at the super-shards, in each form its paths call:
# #3 at rank 1 (the radius fold) at k = 25 and 100; #3 in EIM's form (a
# float ds and a 70 % H mask) at ranks 17 and 129; #6 with integer weights
# at rank 1, 101 (k = 25 and 125; k = 25 is phase 9's) and 300.
FILTER_TIMES = ([("fold", n, k, d, 1, gen) for n, d, gen in SHARDS for k in (25, 100)]
                + [("eim", n, 25, d, rank, gen) for n, d, gen in SHARDS
                   for rank in (17, 129)]
                + [("weighted", n, k, d, rank, gen) for n, d, gen in SHARDS
                   for k, rank in ((25, 1), (25, KZ_Z + 1), (125, KZ_Z + 1), (25, 300))])


@functools.lru_cache(maxsize=None)
def kdd_host(P):
    """kddlike n=4e6, d=38 on the host (608 MB), made once per run."""
    t0 = time.perf_counter()
    x = P.kddlike(4_000_000, seed=0)
    print(f"kddlike n=4e6 d=38 made on the host in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return x


def int_weights(rng, n):
    """Integer row weights in {1, 2, 3, 4} with about 1 % zeros."""
    w = rng.integers(1, 5, n).astype(np.float32)
    w[rng.random(n) < 0.01] = 0.0
    return w


def cuda_t(torch, a):
    return torch.from_numpy(np.ascontiguousarray(a)).cuda()


def phase_weighted_filter(torch, engine, P, rng, results):
    print("== phase 2g: weighted filter (fused_filter.cu, weighted entry) "
          "against its plain version; the plain filter at ranks 101 and 300",
          flush=True)
    for n, k, d, rank, gen in W_FILTER_SHAPES:
        for tier in ("exact", "float"):
            xt = cuda_t(torch, shard_points(P, rng, n, d, gen, tier))
            ct = xt[cuda_t(torch, rng.choice(n, k, replace=False))]
            wt = cuda_t(torch, int_weights(rng, n))
            ds0 = cuda_t(torch, np.floor(rng.random(n) * 5000).astype(np.float32))
            hm = cuda_t(torch, rng.random(n) < 0.7)
            err = 0.0
            for form in ("fold", "eim"):
                eim = form == "eim"     # with ds and the mask

                def run(impl, w, eim=eim):
                    return engine.fused_filter(xt, ct, ds0.clone() if eim else None,
                                               hm if eim else None, rank=rank,
                                               w=w, impl=impl)

                got, want = run("kernel", wt), run("ref", wt)
                unit, plain = run("kernel", torch.ones_like(wt)), run("kernel", None)
                merged = [engine.merge_top_k(engine.top_k_init(rank), r[1], rank)
                          for r in (got, want)]
                torch.cuda.synchronize()
                check(torch.equal(unit[1], plain[1])
                      and (not eim or torch.equal(unit[0], plain[0])),
                      f"filter_w n={n} k={k} rank={rank} {form}: unit weights "
                      "not bitwise the plain kernel")
                err = max(err, (merged[0] - merged[1]).abs().max().item())
                if eim:
                    err = max(err, (got[0] - want[0]).abs().max().item())
                label = f"filter_w n={n} k={k} d={d} rank={rank} {form} {tier}"
                if tier == "exact":
                    check(torch.equal(got[1], want[1])
                          and (not eim or torch.equal(got[0], want[0])),
                          f"{label}: not bitwise")
                else:
                    check(torch.allclose(merged[0], merged[1], rtol=1e-4, atol=1e-4),
                          f"{label}: merged top beyond rtol 1e-4")
                    if eim:
                        check(bool(((got[0] - want[0]).abs() <= dist2_tol(xt, ct)).all()),
                              f"{label}: ds beyond tolerance")
                if rank > 1 and form == "fold":
                    # repair 0: the plain kernel past its old cap of 128
                    # ranks and past a tile's 256 candidates
                    p_got = engine.fused_filter(xt, ct, rank=rank, impl="kernel")[1]
                    p_want = engine.fused_filter(xt, ct, rank=rank, impl="ref")[1]
                    pm = [engine.merge_top_k(engine.top_k_init(rank), t, rank)
                          for t in (p_got, p_want)]
                    torch.cuda.synchronize()
                    p_err = (pm[0] - pm[1]).abs().max().item()
                    check(torch.equal(p_got, p_want) if tier == "exact" else
                          torch.allclose(pm[0], pm[1], rtol=1e-4, atol=1e-4),
                          f"filter n={n} k={k} rank={rank} {tier}: plain kernel "
                          "differs from its plain version")
                    ntiles = -(-n // engine.ref.FILTER_TILE_ROWS)
                    ms = p_plain = None
                    if tier == "float":
                        ms = device_ms(torch, lambda: engine.fused_filter(
                            xt, ct, rank=rank, impl="kernel"))
                        p_plain = device_ms(torch, lambda: engine.fused_filter(
                            xt, ct, rank=rank, impl="ref"), reps=5)
                    b_ms, b_by = bound(4 * (n * d + k * d + ntiles * rank),
                                       n * k * (2 * d + 5) + 2 * d * (n + k))
                    print(f"filter n={n} k={k} d={d} rank={rank} fold {tier}: ok "
                          f"max_abs_err={p_err:.3g} kernel_ms={fmt(ms)} plain_ms={fmt(p_plain)} "
                          f"bound_ms={b_ms:.5f} ({b_by})", flush=True)
                    results.append(dict(kernel="fused_filter",
                                        shape=(n, k, d, rank, gen), tier=tier,
                                        err=p_err, ms=ms, plain_ms=p_plain,
                                        bound_ms=b_ms, bound_by=b_by,
                                        library_ms=None))
            if tier == "exact":
                print(f"filter_w n={n} k={k} d={d} rank={rank} exact: ok (fold and "
                      f"eim forms bitwise; unit weights bitwise the plain kernel)",
                      flush=True)
                results.append(dict(kernel="fused_filter_w", shape=(n, k, d, rank, gen),
                                    tier=tier, err=err, ms=None, plain_ms=None,
                                    bound_ms=None, bound_by=None, library_ms=None))
                continue
            ms = device_ms(torch, lambda: engine.fused_filter(
                xt, ct, rank=rank, w=wt, impl="kernel"))
            plain = device_ms(torch, lambda: engine.fused_filter(
                xt, ct, rank=rank, w=wt, impl="ref"), reps=5)
            ntiles = -(-n // engine.ref.FILTER_TILE_ROWS)
            b_ms, b_by = bound(4 * (n * d + k * d + ntiles * rank) + 4 * n,
                               n * k * (2 * d + 5) + 2 * d * (n + k))
            print(f"filter_w n={n} k={k} d={d} rank={rank} fold float: ok "
                  f"max_abs_err={err:.3g} kernel_ms={ms:.5f} plain_ms={plain:.5f} "
                  f"bound_ms={b_ms:.5f} ({b_by})", flush=True)
            results.append(dict(kernel="fused_filter_w", shape=(n, k, d, rank, gen),
                                tier=tier, err=err, ms=ms, plain_ms=plain,
                                bound_ms=b_ms, bound_by=b_by, library_ms=None))
    filter_edge_cases(torch, engine, rng)


def phase_batched_assign(torch, engine, P, rng, results):
    print("== phase 2h: batched assign (assign.cu, machine grid axis) against "
          "its plain version and the 2-D entry", flush=True)
    for m, per, t, d, gen in BATCHED_SHAPES:
        for tier in ("exact", "float"):
            x = (exact_points(rng, (m, per, d)) if tier == "exact"
                 else P.GENERATORS[gen](m * per, d=d, seed=6).reshape(m, per, d))
            xt = cuda_t(torch, x)
            ct = xt[:, cuda_t(torch, rng.choice(per, t, replace=False))].contiguous()
            got = engine.assign_nearest_batched(xt, ct, impl="kernel")
            want = engine.assign_nearest_batched(xt, ct, impl="ref")
            one = [engine.assign_nearest(xt[b], ct[b], impl="kernel") for b in range(m)]
            torch.cuda.synchronize()
            check(all(torch.equal(got[0][b], one[b][0]) and torch.equal(got[1][b], one[b][1])
                      for b in range(m)),
                  f"assign_batched m={m} d={d} {tier}: not bitwise the 2-D entry")
            err = (got[1] - want[1]).abs().max().item()
            if tier == "exact":
                check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                      f"assign_batched m={m} d={d} exact tier: not bitwise")
            else:
                rows = torch.arange(m, device=xt.device)[:, None]
                tol = dist2_tol(xt.reshape(-1, d),
                                ct[rows, want[0].long()].reshape(-1, d)).reshape(m, per)
                check(bool(((got[1] - want[1]).abs() <= tol).all()),
                      f"assign_batched m={m} d={d}: d2 beyond tolerance ({err})")
                two = torch.topk(engine.ref.pairwise_dist2(xt, ct), 2, dim=-1,
                                 largest=False).values
                unique = (two[..., 1] - two[..., 0]) > 2 * tol
                check(torch.equal(got[0][unique], want[0][unique]),
                      f"assign_batched m={m} d={d}: index differs where unique")
            ms = device_ms(torch, lambda: engine.assign_nearest_batched(
                xt, ct, impl="kernel"))
            plain = device_ms(torch, lambda: engine.assign_nearest_batched(
                xt, ct, impl="ref"))
            lib = device_ms(torch, lambda: torch.cdist(xt, ct).min(-1))
            rows_n = m * per
            b_ms, b_by = bound(4 * (rows_n * d + m * t * d + 2 * rows_n),
                               rows_n * t * (2 * d + 5) + 2 * d * (rows_n + m * t))
            print(f"assign_batched m={m} per={per} t={t} d={d} {tier}: ok (each "
                  f"machine bitwise the 2-D entry) max_abs_err={err:.3g} "
                  f"kernel_ms={ms:.5f} plain_ms={plain:.5f} library_ms={lib:.5f} "
                  f"(torch.cdist(x, c).min(-1), batched) bound_ms={b_ms:.5f} ({b_by})",
                  flush=True)
            results.append(dict(kernel="assign_batched", shape=(m, per, t, d, gen),
                                tier=tier, err=err, ms=ms, plain_ms=plain,
                                bound_ms=b_ms, bound_by=b_by, library_ms=lib))
            batched_sums(torch, engine, rng, results, xt, ct, (m, per, t, d, gen), tier)


def batched_sums(torch, engine, rng, results, xt, ct, shape, tier):
    """The sums entry on a batched shape (the weighted reducer's cluster
    weights): integer weights (machine 0 of several weighs nothing) and
    counts bitwise the plain assign + index_add_; on float inputs a row may
    move between two near-tied centers, so each sum within the weight of
    the rows whose two nearest centers tie within tolerance. Times the
    kernel against the plain version (no single PyTorch call computes the
    same)."""
    m, per, t, d, gen = shape
    w = cuda_t(torch, int_weights(rng, m * per).reshape(m, per))
    if m > 1:
        w[0] = 0.0
    outs = []
    for ww in (w, None):
        dtype = torch.float32 if ww is not None else torch.int32
        for impl in ("kernel", "ref"):
            outs.append(engine.assign_sums(
                xt, ct, torch.zeros((m, t), dtype=dtype, device="cuda"), ww, impl=impl))
    torch.cuda.synchronize()
    err = (outs[0] - outs[1]).abs().max().item()
    label = f"assign_sums m={m} per={per} t={t} d={d} {tier}"
    check(float(outs[0].sum()) == float(w.sum()) and int(outs[2].sum()) == m * per,
          f"{label}: the sums lose weight")
    if tier == "exact":
        check(torch.equal(outs[0], outs[1]) and torch.equal(outs[2], outs[3]),
              f"{label}: not bitwise the plain assign + index_add_")
    else:
        tol = dist2_tol(xt.reshape(-1, d), ct.reshape(-1, d))
        two = torch.topk(engine.ref.pairwise_dist2(xt, ct), 2, dim=-1, largest=False).values
        ties = ((two[..., 1] - two[..., 0]).reshape(-1) <= 2 * tol).sum().item()
        check(err <= 4 * ties and (outs[2] - outs[3]).abs().max().item() <= ties,
              f"{label}: sums differ beyond the {ties} near-tied rows ({err})")
    ms = plain = None
    if tier == "float":
        sums = torch.zeros((m, t), device="cuda")
        ms = device_ms(torch, lambda: engine.assign_sums(xt, ct, sums, w, impl="kernel"))
        plain = device_ms(torch, lambda: engine.assign_sums(xt, ct, sums, w, impl="ref"))
    rows_n = m * per
    b_ms, b_by = bound(4 * (rows_n * d + m * t * d + rows_n + m * t),
                       rows_n * t * (2 * d + 5) + 2 * d * (rows_n + m * t))
    print(f"{label}: ok (integer weights, machine 0 weightless, and counts; "
          f"{'bitwise' if tier == 'exact' else 'near ties only'}) max_abs_err={err:.3g} "
          f"kernel_ms={fmt(ms)} plain_ms={fmt(plain)} (assign + index_add_) "
          f"bound_ms={b_ms:.5f} ({b_by})", flush=True)
    results.append(dict(kernel="assign_sums", shape=shape, tier=tier, err=err, ms=ms,
                        plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None))


def pairwise_bound(torch, n, m, d, dtype):
    """The pairwise kernel's bound at one shape, on the route it takes: the
    output and both inputs once against the product's 2·d·n·m operations,
    on the tensor cores (with ~4 f32 operations a pair of epilogue) where
    the f16 route runs there."""
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.pairwise import pairwise_plan
    half = dtype == torch.float16
    route = pairwise_plan(n, m, d, half, sm_count(0)).route
    nbytes = 4 * n * m + (2 if half else 4) * (n + m) * d
    if route == "mma":
        return route, bound(nbytes, 4 * n * m, 2 * d * n * m)
    return route, bound(nbytes, 2 * d * n * m)


def phase_pairwise(torch, engine, rng, results):
    print("== phase 2i: pairwise (pairwise.cu) against its plain version",
          flush=True)
    for n, m, d in PAIRWISE_SHAPES:
        for dtype in (torch.float32, torch.float16):
            name = str(dtype).split(".")[1]
            route, (b_ms, b_by) = pairwise_bound(torch, n, m, d, dtype)
            for tier in ("exact", "float"):
                if tier == "exact":
                    x, c = exact_points(rng, (n, d)), exact_points(rng, (m, d))
                else:      # tests/test_kernels.py's inputs
                    x = rng.normal(size=(n, d)).astype(np.float32)
                    c = rng.normal(size=(m, d)).astype(np.float32)
                xt, ct = cuda_t(torch, x).to(dtype), cuda_t(torch, c).to(dtype)
                got = engine.pairwise_dist2(xt, ct, impl="kernel")
                want = engine.pairwise_dist2(xt, ct, impl="ref")
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                label = f"pairwise n={n} m={m} d={d} {name} {tier} route={route}"
                if tier == "exact":
                    check(torch.equal(got, want), f"{label}: not bitwise")
                else:
                    tol = PAIRWISE_TOL[name]
                    check(torch.allclose(got, want, rtol=tol, atol=10 * tol),
                          f"{label}: beyond rtol {tol} ({err})")
                ms = plain = lib = mm = None
                if tier == "float":
                    ms = device_ms(torch, lambda: engine.pairwise_dist2(
                        xt, ct, impl="kernel"))
                    plain = device_ms(torch, lambda: engine.pairwise_dist2(
                        xt, ct, impl="ref"))
                    xf, cf = xt.float(), ct.float()
                    lib = device_ms(torch, lambda: torch.cdist(xf, cf).square())
                    # the product alone on the f32 units (cuBLAS SGEMM, TF32
                    # off): a yardstick, never called by the port
                    mm = device_ms(torch, lambda: torch.mm(xf, cf.T))
                print(f"{label}: ok max_abs_err={err:.3g} kernel_ms={fmt(ms)} "
                      f"plain_ms={fmt(plain)} library_ms={fmt(lib)} (torch.cdist(x, c)"
                      f".square() on f32) product_ms={fmt(mm)} (torch.mm(x, c.T), f32, "
                      f"no TF32) bound_ms={b_ms:.5f} ({b_by})", flush=True)
                results.append(dict(kernel="pairwise", shape=(n, m, d, name),
                                    tier=tier, err=err, ms=ms, plain_ms=plain,
                                    bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                                    route=route))


# LARGE_MIN_TILES that makes pairwise_plan take each route (``large``: the
# tensor cores for f16)
PAIRWISE_ROUTES = {"small": 1 << 30, "large": 0}


def pairwise_routing(torch, engine):
    """Both routes of the pairwise kernel at square outputs on both sides
    of ``pairwise_plan``'s boundary (``PAIRWISE_ROUTING``), each bitwise
    the plain version on the exact tier, with its time: the measurements
    that set ``LARGE_MIN_TILES``. Then the large route's two grids
    (``PAIRWISE_GRID``), which set ``PERSIST_MIN_D``."""
    from repro_torch.kernels import pairwise as pw
    from repro_torch.kernels._build import sm_count
    rng = np.random.default_rng(11)
    saved = pw.LARGE_MIN_TILES, pw.PERSIST_MIN_D

    def restore():
        pw.LARGE_MIN_TILES, pw.PERSIST_MIN_D = saved
        pw.pairwise_plan.cache_clear()
    try:
        for n, m, d in PAIRWISE_ROUTING:
            x, c = exact_points(rng, (n, d)), exact_points(rng, (m, d))
            for dtype in (torch.float32, torch.float16):
                half = dtype == torch.float16
                xt, ct = cuda_t(torch, x).to(dtype), cuda_t(torch, c).to(dtype)
                want = engine.pairwise_dist2(xt, ct, impl="ref")
                times = {}
                for least in PAIRWISE_ROUTES.values():
                    pw.LARGE_MIN_TILES = least
                    pw.pairwise_plan.cache_clear()
                    name = pw.pairwise_plan(n, m, d, half, sm_count(0)).route
                    got = engine.pairwise_dist2(xt, ct, impl="kernel")
                    torch.cuda.synchronize()
                    check(torch.equal(got, want), f"pairwise route={name} n={n} m={m} "
                          f"d={d} {dtype}: not bitwise the plain version")
                    times[name] = round(device_ms(
                        torch, lambda: engine.pairwise_dist2(xt, ct, impl="kernel")), 5)
                restore()
                print(f"pairwise routing n={n} m={m} d={d} {str(dtype).split('.')[1]}: "
                      f"planned={pw.pairwise_plan(n, m, d, half, sm_count(0)).route} "
                      f"ms={times} (each bitwise the plain version)", flush=True)
        for n, m, d in PAIRWISE_GRID:
            x, c = exact_points(rng, (n, d)), exact_points(rng, (m, d))
            xt, ct = cuda_t(torch, x), cuda_t(torch, c)
            want = engine.pairwise_dist2(xt, ct, impl="ref")
            times = {}
            for grid, least in (("persistent", 0), ("a tile a CTA", 1 << 30)):
                pw.PERSIST_MIN_D = least
                pw.pairwise_plan.cache_clear()
                got = engine.pairwise_dist2(xt, ct, impl="kernel")
                torch.cuda.synchronize()
                check(torch.equal(got, want), f"pairwise grid {grid} n={n} m={m} d={d}: "
                      "not bitwise the plain version")
                times[grid] = round(device_ms(
                    torch, lambda: engine.pairwise_dist2(xt, ct, impl="kernel")), 5)
            restore()
            plan = pw.pairwise_plan(n, m, d, False, sm_count(0))
            print(f"pairwise grid n={n} m={m} d={d} float32 {plan.route}: planned="
                  f"{'persistent' if plan.grid < plan.tiles else 'a tile a CTA'} "
                  f"(slab {plan.ks}) ms={times} (each bitwise the plain version)", flush=True)
    finally:
        restore()


def pairwise_edge_cases(torch, engine, rng):
    """The pairwise kernel's edge cases, bitwise the plain version on the
    exact tier in f32 and f16, each on the route it is meant to test
    (checked, so that a change of the boundary cannot move a case off its
    path): n = 1 and m = 1; n and m off every tile; d = 1, 15, 17 and 39
    (f16 padding to 16, and the tensor-core kernel's plain loads of odd
    widths) and 1,000 (slabs past a small tile's whole staging); m of 1
    and 48 on the large route (masked columns of a 128 × 128 tile); x and c
    one tensor (the sketch's call) on both routes; m past 65,535 · 64 (the
    previous grid's cap); shapes just on each side of the route boundary;
    and x and c as views that start one element past an aligned address
    (f16: 2 bytes off a 4-byte boundary, so the tensor-core kernel takes
    plain loads in place of its 4-byte copies)."""
    from repro_torch.kernels import pairwise as pw
    from repro_torch.kernels._build import sm_count
    # (n, m, d, route, shifted); m None: c is x; an f16 "large" case takes "mma"
    cases = [(1, 1, 38, "small"), (1, 1, 1, "small"), (1, 300, 38, "small"),
             (300, 1, 38, "small"), (129, 65, 38, "small"), (37, 45, 3, "small"),
             (300, 200, 1, "small"), (150, 90, 1_000, "small"), (101, None, 38, "small"),
             (1_000, 333, 17, "large"), (200, 1_100, 17, "large"), (700, 513, 1_000, "large"),
             (1_100, 600, 1_000, "large"), (5_000, 1_000, 100, "large"),
             (2_048, None, 38, "large"), (2, 65_535 * 64 + 3, 2, "large"),
             (8_192, 48, 38, "large"), (8_192, 1, 2, "large")]
    cases += [(4_096, 1_024, d, "large") for d in (1, 15, 17, 39)]
    # around the boundary, at 4 column tiles of 128
    hi = 128 * -(-pw.LARGE_MIN_TILES // 4)
    cases += [(hi - 128, 512, 38, "small"), (hi, 512, 38, "large")]
    cases = [case + (False,) for case in cases]
    cases += [(101, 101, 38, "small", True), (1_000, 333, 16, "large", True),
              (4_096, 1_024, 38, "large", True)]
    seen = []
    for n, m, d, want_route, shifted in cases:
        x = exact_points(rng, (n, d))
        c = x if m is None else exact_points(rng, (m, d))
        for dtype in (torch.float32, torch.float16):
            xt = cuda_t(torch, x).to(dtype)
            ct = xt if m is None else cuda_t(torch, c).to(dtype)
            if shifted:
                xt, ct = (torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)
                          for t in (xt, ct))
                check(xt.data_ptr() % 16 == xt.element_size() and xt.is_contiguous(),
                      "pairwise edge: the shifted view is not one element off")
            half = dtype == torch.float16
            route = pw.pairwise_plan(n, ct.shape[0], d, half, sm_count(0)).route
            want = "mma" if half and want_route == "large" else want_route
            label = (f"pairwise edge n={n} m={ct.shape[0]} d={d} {dtype} route={route} "
                     f"(x is c: {m is None}, shifted: {shifted})")
            check(route == want, f"{label}: planned off its route {want}")
            got = engine.pairwise_dist2(xt, ct, impl="kernel")
            want_d2 = engine.pairwise_dist2(xt, ct, impl="ref")
            torch.cuda.synchronize()
            check(torch.equal(got, want_d2), f"{label}: not bitwise")
            seen.append((n, "x" if m is None else m, d, route) + (("shifted",) if shifted
                                                                  else ()))
    print(f"pairwise edge cases (n, m, d, route; f32 then f16): {seen} bitwise the "
          "plain version, each on its route", flush=True)


def report_syncs(syncs):
    for w in syncs:
        print(f"  sync: {str(w.message)[:120]!r} at {w.filename}:{w.lineno}",
              flush=True)


def planted_kdd(P, rng):
    """The kddlike cloud with 100 rows moved far apart (planted outliers,
    weight 1 each, so that together they weigh z) and integer weights."""
    x = kdd_host(P).copy()
    w = int_weights(rng, x.shape[0])
    far = rng.choice(x.shape[0], KZ_Z, replace=False)
    x[far] += (rng.normal(size=(KZ_Z, x.shape[1])) * 1e5).astype(np.float32)
    w[far] = 1.0
    return x, w


def phase_weighted(torch, engine, P, rng, counters):
    print("== phase 7: weighted objective and (k,z)-center, impl='auto' "
          "against impl='ref' on the card", flush=True)
    from repro_torch.core import (HostStreamExecutor, Objective, SimExecutor,
                                  kz_center, mrg, select_coreset)
    from repro_torch.data.source import HostSource, WeightedSource, synthetic_source
    totals = {name: 0 for name in counters}
    xk, wk = planted_kdd(P, rng)
    kdd_w = WeightedSource(HostSource(xk), wk)
    exact = exact_points(rng, (500_000, 38))
    exact_w = WeightedSource(HostSource(exact), int_weights(rng, exact.shape[0]))
    unif = P.unif(1_000_000, d=2, seed=0)
    runs = [
        ("kz_center unif n=1e6 d=2 in memory SimExecutor(m=50)", "kz",
         torch.from_numpy(unif).cuda(), 25, None,
         ("gon_step", "assign_sums", "assign")),
        ("kz_center kddlike n=4e6 d=38 weighted host, 100 planted outliers", "kz",
         kdd_w, 25, 256 * MiB,
         ("gon_step", "assign_sums", "fused_filter_w")),
        ("kz_center unif n=1e7 d=2 synthetic", "kz",
         synthetic_source("unif", 10_000_000, d=2, seed=0), 25, 64 * MiB,
         ("gon_step", "assign_sums", "fused_filter_w")),
        ("kz_center exact-tier n=5e5 d=38 weighted host", "kz", exact_w, 25,
         64 * MiB, ("gon_step", "assign_sums", "fused_filter_w")),
        ("weighted mrg kddlike n=4e6 d=38 weighted host", "mrg_w", kdd_w, 25,
         256 * MiB, ("gon_step", "assign_sums", "fused_filter_w")),
        ("weighted select_coreset kddlike n=4e6 d=38 weighted host", "coreset",
         kdd_w, 100, 256 * MiB,
         ("gon_step", "fused_filter", "assign_sums", "argmin_rows")),
    ]
    obj = Objective(weighted=True)
    for label, kind, src, k, budget, path in runs:
        if budget is None:
            ex = SimExecutor(50)
        else:
            ex = HostStreamExecutor(memory_budget=budget)
        if kind == "kz":
            def fn(impl="auto"):
                return kz_center(src, k, KZ_Z, executor=ex, impl=impl)
        elif kind == "mrg_w":
            def fn(impl="auto"):
                return mrg(src, k, executor=ex, impl=impl, objective=obj)
        else:
            def fn(impl="auto"):
                return select_coreset(src, k, executor=ex, impl=impl)
        fn()                                              # warm-up
        reads = kz_center.host_reads
        res, launches, syncs, blocks, peak = counted_run(torch, fn, counters)
        reads = kz_center.host_reads - reads
        with gon_clock() as clock:
            walls = wall_ms(torch, fn)
        ref = fn("ref")
        torch.cuda.synchronize()
        report_syncs(syncs)
        for name in path:
            check(launches[name] > 0, f"{label}: kernel {name} never launched")
        for name, c in launches.items():
            totals[name] += c
        n, d = src.shape if isinstance(src, torch.Tensor) else (src.n, src.d)
        r2, r2_ref = res.radius2.item(), ref.radius2.item()
        check(np.isfinite(r2) and abs(r2 - r2_ref) <= 1e-4 * abs(r2_ref),
              f"{label}: radius2 {r2} vs ref {r2_ref} beyond rtol 1e-4")
        if "exact" in label:
            check(r2 == r2_ref, f"{label}: radius2 not bitwise on the exact tier")
        check(tuple(res.centers.shape) == (k, d)
              and bool(torch.isfinite(res.centers).all()), f"{label}: centers")
        note = ""
        if kind == "kz":
            check(len(syncs) == 1 and reads == 1,
                  f"{label}: {len(syncs)} synchronising calls, {reads} coreset "
                  "reads (expected the one coreset read)")
            check(torch.equal(res.centers, ref.centers)
                  and res.coreset_size == ref.coreset_size
                  and res.rounds == ref.rounds, f"{label}: differs from ref")
            note = f"coreset_size={res.coreset_size} rounds={res.rounds}"
            if src is kdd_w:
                plain = ex.radius2(src, res.centers).item()
                check(plain > 100 * r2, f"{label}: planted outliers not excluded "
                      f"(radius2 {r2} against the plain covering radius2 {plain})")
                note += f" plain_covering_radius2={plain!r}"
        else:
            check(not syncs, f"{label}: {len(syncs)} synchronising calls")
            wsum = float(np.sum(src.weights_of(0, n), dtype=np.float64))
            if kind == "mrg_w":
                check(torch.equal(res.centers, ref.centers) and res.rounds == ref.rounds,
                      f"{label}: centers or rounds differ from ref")
                check(torch.equal(res.weights, ref.weights),
                      f"{label}: cluster weights differ from ref")
                note = f"rounds={res.rounds}"
            else:
                moved, ties, idiff = check_coreset(torch, engine, label, src,
                                                   ex.rows_for(src), res, ref,
                                                   max_weight=4)
                note = (f"weight_moved_vs_ref={moved} near_tie_rows={ties} "
                        f"representatives_differing={idiff}")
            check(float(res.weights.sum().item()) == wsum,
                  f"{label}: cluster weights sum {res.weights.sum().item()} != {wsum}")
            note += f" weights_sum={wsum!r}"
        allowed = None
        if budget is not None:
            rows = ex.rows_for(src)
            shards = -(-n // rows)
            t = k + KZ_Z if kind == "kz" else k
            allowed = ((ex.prefetch + 1) * 4 * rows * (d + 1)
                       + 2 * shards * t * (4 * d + 5) + PEAK_SLACK)
            check(peak <= allowed, f"{label}: peak device memory {peak} bytes "
                  f"above the allowed {allowed}")
        print(f"{label} k={k}{f' z={KZ_Z}' if kind == 'kz' else ''}: ok {note} "
              f"radius2={r2!r} ref_radius2={r2_ref!r} "
              f"wall_ms={[round(w, 3) for w in walls]} launches={launches} "
              f"{gon_host_note(clock, len(walls), launches)} "
              f"sync_warnings={len(syncs)} blocks_streamed={blocks} "
              f"peak_MiB={peak / MiB:.2f} allowed_MiB="
              f"{None if allowed is None else round(allowed / MiB, 2)} "
              f"budget_MiB={None if budget is None else budget / MiB}", flush=True)
    # unit weights: the weighted rounds are bitwise the plain ones
    ex = HostStreamExecutor(memory_budget=256 * MiB)
    kdd = HostSource(kdd_host(P))
    unit = mrg(WeightedSource(kdd, np.ones(kdd.n, np.float32)), 25, executor=ex,
               objective=obj)
    plain = mrg(kdd, 25, executor=ex)
    check(torch.equal(unit.centers, plain.centers)
          and unit.radius2.item() == plain.radius2.item()
          and unit.rounds == plain.rounds
          and unit.weights.sum().item() == kdd.n,
          "unit-weight weighted mrg differs from the plain mrg")
    print("unit-weight weighted mrg kddlike n=4e6 (256 MiB) == plain mrg bitwise "
          "(centers, radius2, rounds; weights sum to n)", flush=True)
    float_weight_repeat(torch, xk, rng, ex, obj)
    for name, c in coreset_in_memory(torch, engine, P, counters).items():
        totals[name] += c
    return totals


def float_weight_repeat(torch, x, rng, ex, obj):
    """Weighted mrg and kz_center twice each on the card with non-integer
    weights (uniform in [0, 4), about 1 % zeros): the sums entry adds f32
    weights by atomics, so a cluster weight's last bits may follow the
    order the CTAs add in. Prints whether the two runs' centers, cluster
    weights and kz_center results are bitwise equal, and the largest
    relative difference of a cluster weight; raises only where the two runs
    give the same centers and weights further apart than f32 rounding of
    the sums."""
    from repro_torch.core import kz_center, mrg
    from repro_torch.data.source import HostSource, WeightedSource
    w = (rng.random(x.shape[0]) * 4).astype(np.float32)
    w[rng.random(x.shape[0]) < 0.01] = 0.0
    src = WeightedSource(HostSource(x), w)
    runs = [mrg(src, 25, executor=ex, objective=obj) for _ in range(2)]
    kz = [kz_center(src, 25, KZ_Z, executor=ex) for _ in range(2)]
    torch.cuda.synchronize()
    a, b = runs
    rel = ((a.weights - b.weights).abs() / a.weights.abs().clamp_min(1e-30)).max().item()
    if torch.equal(a.centers, b.centers):
        check(rel <= 1e-5, f"float weights: the same centers, cluster weights {rel} "
              "apart, beyond f32 rounding of the sums")
    print("float-weight repeat, weighted kddlike n=4e6 (256 MiB), weights in [0, 4): "
          f"mrg centers_equal={torch.equal(a.centers, b.centers)} "
          f"radius2_equal={a.radius2.item() == b.radius2.item()} "
          f"weights_equal={torch.equal(a.weights, b.weights)} "
          f"max_weight_rel_diff={rel!r} weights_sum={a.weights.sum().item()!r} / "
          f"{b.weights.sum().item()!r}; kz_center "
          f"centers_equal={torch.equal(kz[0].centers, kz[1].centers)} "
          f"radius2={kz[0].radius2.item()!r} / {kz[1].radius2.item()!r} "
          f"coreset_size={kz[0].coreset_size} / {kz[1].coreset_size}", flush=True)


def coreset_in_memory(torch, engine, P, counters):
    """select_coreset in memory (SimExecutor(m=50), kddlike n=400,000,
    k=100): its cluster counts come from the assign's sums entry and its
    representatives from the per-center argmin over all rows (one launch),
    against impl="ref" on the card, with no synchronising call. Returns the
    run's launches."""
    from repro_torch.core import SimExecutor, select_coreset
    from repro_torch.data.source import HostSource
    n, k = 400_000, 100
    x = P.kddlike(n, seed=0)
    xt = cuda_t(torch, x)
    ex = SimExecutor(50)

    def fn(impl="auto"):
        return select_coreset(xt, k, executor=ex, impl=impl)
    fn()                                                  # warm-up
    res, launches, syncs, _, _ = counted_run(torch, fn, counters)
    walls = wall_ms(torch, fn)
    ref = fn("ref")
    torch.cuda.synchronize()
    label = f"select_coreset kddlike n={n} d=38 k={k} in memory SimExecutor(m=50)"
    report_syncs(syncs)
    check(not syncs, f"{label}: {len(syncs)} synchronising calls")
    for name in ("gon_step", "assign", "assign_sums", "argmin_rows"):
        check(launches[name] > 0, f"{label}: kernel {name} never launched")
    check(launches["argmin_rows"] == 1, f"{label}: {launches['argmin_rows']} argmin "
          "launches for the representatives (one expected)")
    check(int(res.weights.sum()) == n, f"{label}: counts sum to {int(res.weights.sum())}")
    moved, ties, idiff = check_coreset(torch, engine, label, HostSource(x), 100_000,
                                       res, ref)
    print(f"{label}: ok indices_equal_to_ref={bool(torch.equal(res.indices, ref.indices))} "
          f"representatives_differing={idiff} weight_rows_moved_vs_ref={moved} "
          f"near_tie_rows={ties} wall_ms={[round(w, 3) for w in walls]} "
          f"launches={launches} sync_warnings={len(syncs)}", flush=True)
    return launches



class HostClock:
    """Host time spent in the functions it wraps (the sketch's insertion
    tail and merge, its coverage passes), by name, while installed."""

    def __init__(self, module, names):
        self.module, self.names, self.ms = module, names, {}
        self.orig = {name: getattr(module, name) for name in names}

    def __enter__(self):
        for name, f in self.orig.items():
            def timed(*a, _f=f, _name=name, **kw):
                t0 = time.perf_counter()
                try:
                    return _f(*a, **kw)
                finally:
                    self.ms[_name] = (self.ms.get(_name, 0.0)
                                      + (time.perf_counter() - t0) * 1e3)
            setattr(self.module, name, timed)
        return self

    def __exit__(self, *exc):
        for name, f in self.orig.items():
            setattr(self.module, name, f)


def phase_sketch(torch, P, counters):
    print("== phase 8: the streaming sketch (stream_update), impl='auto' "
          "against impl='ref' on the card", flush=True)
    from repro_torch.core import streaming
    from repro_torch.core.streaming import stream_init, stream_update
    from repro_torch.data.source import HostSource, synthetic_source
    totals, states = {name: 0 for name in counters}, {}
    runs = [("unif n=1e7 d=2 synthetic", synthetic_source(
                 "unif", 10_000_000, d=2, seed=0), 25),
            ("kddlike n=4e6 d=38 host", HostSource(kdd_host(P)), 100)]
    for label, src, k in runs:
        for tail in ("host", "device"):
            def fn(impl="auto"):
                return stream_update(stream_init(k, src.d), src, tail=tail,
                                     impl=impl)
            # no warm-up: phase 2 built and ran the kernels
            passes, reads = stream_update.coverage_passes, stream_update.host_reads
            with HostClock(streaming, ("_insert_tail", "_merge", "_min_d2")) as clock:
                t0 = time.perf_counter()
                res, launches, syncs, _, peak = counted_run(torch, fn, counters)
                wall = (time.perf_counter() - t0) * 1e3
            passes = stream_update.coverage_passes - passes
            reads = stream_update.host_reads - reads
            walls = wall_ms(torch, fn)
            ref = fn("ref")
            name = f"sketch {label} k={k} tail={tail}"
            check(launches["pairwise"] > 0 and launches["assign"] > 0,
                  f"{name}: pairwise or assign never launched")
            check(launches["assign"] == passes,
                  f"{name}: {launches['assign']} assign launches for {passes} passes")
            check(len(syncs) == reads == passes + 1,
                  f"{name}: {len(syncs)} synchronising calls, {reads} reads, "
                  f"{passes} coverage passes (expected one read a pass and one "
                  "for the bootstrap)")
            check(res.count == ref.count and res.r == ref.r and np.array_equal(
                res.centers[:res.count], ref.centers[:ref.count]),
                f"{name}: sketch differs from impl='ref'")
            check(0 < res.count <= k and res.r > 0, f"{name}: sketch state")
            states[(label, tail)] = res
            for c, v in launches.items():
                totals[c] += v
            host_ms = clock.ms.get("_insert_tail", 0.0) + clock.ms.get("_merge", 0.0)
            print(f"{name}: ok count={res.count} r={res.r!r} coverage_passes={passes} "
                  f"launches={launches} sync_warnings={len(syncs)} host_reads={reads} "
                  f"wall_ms(counted, sync debug on)={wall:.3f} "
                  f"wall_ms={[round(w, 3) for w in walls]} "
                  f"insert_tail_and_merge_ms={host_ms:.3f} "
                  f"coverage_pass_ms(upload, assign, read)={clock.ms.get('_min_d2', 0.0):.3f} "
                  f"peak_MiB={peak / MiB:.2f}", flush=True)
    return totals, states


def device_profile(torch, fn):
    """``fn()`` under the profiler: (wall ms, kernel ms, kernels, copy ms,
    copies, {name: (ms, count)}), or None when no device time was
    recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return None
    copies = [e for e in events if e.name.startswith("Memcpy")]
    kernels = [e for e in events if not e.name.startswith(("Memcpy", "Memset"))]
    by_name = {}
    for e in events:
        ms, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    return (wall, sum(e.time_range.elapsed_us() for e in kernels) / 1e3,
            len(kernels), sum(e.time_range.elapsed_us() for e in copies) / 1e3,
            len(copies), by_name)


def phase_kz_profile(torch, P, rng):
    print("== phase 9: profile of one streamed kz_center run (weighted kddlike "
          "n=4e6, 256 MiB, k=25, z=100)", flush=True)
    from repro_torch.core import HostStreamExecutor, kz_center, outliers
    from repro_torch.data.source import HostSource, WeightedSource
    xk, wk = planted_kdd(P, rng)
    src = WeightedSource(HostSource(xk), wk)
    ex = HostStreamExecutor(memory_budget=256 * MiB)
    kz_center(src, 25, KZ_Z, executor=ex)
    with HostClock(outliers, ("_weighted_charikar",)) as clock:
        prof = device_profile(torch, lambda: kz_center(src, 25, KZ_Z, executor=ex))
    if prof is None:
        print("profile: no device time recorded (not measured)", flush=True)
        return
    wall, busy, nk, copy, nc, by_name = prof
    print(f"profile: wall_ms={wall:.3f} (profiler on) kernel_busy_ms={busy:.3f} "
          f"kernels={nk} copy_ms={copy:.3f} copies={nc} "
          f"idle_share_of_wall={1 - busy / wall:.4f} "
          f"host_solve_ms={clock.ms.get('_weighted_charikar', 0.0):.3f}",
          flush=True)
    for name, (ms, count) in sorted(by_name.items(), key=lambda r: -r[1][0])[:10]:
        print(f"  {ms:9.4f} ms  {count:6d}x  {name[:90]}", flush=True)
    # the cluster weights are summed inside the assign: no scatter kernel
    scatter = [n for n in by_name
               if any(s in n.lower() for s in ("indexfunc", "index_add", "scatter"))]
    check(not scatter, f"profile: index_add_ / scatter kernels in kz_center: {scatter}")
    assign = [(ms, count, n) for n, (ms, count) in by_name.items() if "assign_" in n]
    print("profile: no index_add_ or scatter kernel; the assign "
          + "; ".join(f"{n[:40]} {ms:.4f} ms over {count} launches"
                      for ms, count, n in assign), flush=True)
    filt = [(ms, count, n) for n, (ms, count) in by_name.items() if "filter_" in n]
    print("profile: the weighted filter "
          + "; ".join(f"{n[:40]} {ms:.4f} ms over {count} launches"
                      for ms, count, n in filt), flush=True)


def phase_sketch_profile(torch, P):
    print("== phase 9b: profile of one stream_update run (unif n=1e7 d=2 "
          "synthetic, k=25, host tail)", flush=True)
    from repro_torch.core import streaming
    from repro_torch.core.streaming import stream_init, stream_update
    from repro_torch.data.source import synthetic_source
    src = synthetic_source("unif", 10_000_000, d=2, seed=0)
    with HostClock(streaming, ("_insert_tail", "_merge", "_min_d2")) as clock:
        prof = device_profile(torch, lambda: stream_update(stream_init(25, 2), src))
    if prof is None:
        print("profile: no device time recorded (not measured)", flush=True)
        return
    wall, busy, nk, copy, nc, by_name = prof
    host_ms = clock.ms.get("_insert_tail", 0.0) + clock.ms.get("_merge", 0.0)
    print(f"profile: wall_ms={wall:.3f} (profiler on) kernel_busy_ms={busy:.3f} "
          f"kernels={nk} copy_ms={copy:.3f} copies={nc} "
          f"idle_share_of_wall={1 - busy / wall:.4f} "
          f"insert_tail_and_merge_ms={host_ms:.3f} "
          f"coverage_pass_ms={clock.ms.get('_min_d2', 0.0):.3f}", flush=True)
    for name, (ms, count) in sorted(by_name.items(), key=lambda r: -r[1][0])[:8]:
        print(f"  {ms:9.4f} ms  {count:6d}x  {name[:90]}", flush=True)

# -- slice 8: EIM (paper §4) --------------------------------------------------

EIM_KEY = 1                  # eim's key: the int seed 1, jax.random.PRNGKey(1)
EIM_EPS, EIM_PHI = 0.1, 8.0  # eim's defaults
# Phase 2j: #2 at the device path's S buffer (unif n=1e6 and kddlike
# n=400,000, k=25: s_cap centers, the last ~5 % at the 1e18 sentinel of
# empty slots) and #3 at the streamed path's super-shards (unif n=1e7 at 64
# MiB, kddlike n=4e6 at 256 MiB; k=25: s_cap centers, EIM's rank
# round(phi ln n), ds and a ~40 % H mask), each against its plain version
# run in row chunks of about PLAIN_TILE_BYTES, as the plain route of
# phase 10's impl="ref" runs.
EIM_ASSIGN = [(1_000_000, 2, 25, "unif"), (400_000, 38, 25, "kddlike")]
EIM_FILTER = [(10_000_000, 64 * MiB, 2, 25, "unif"),
              (4_000_000, 256 * MiB, 38, 25, "kddlike")]
PLAIN_TILE_BYTES = 1 << 30
# Phase 10a: the device path on the paper's Fig. 4 inputs and kddlike.
EIM_CONFIGS = [(gen, 1_000_000, 2, k) for gen in ("unif", "gau", "unb")
               for k in (25, 100)] + [("kddlike", 400_000, 38, 25)]
# Phase 10c: the exact tier (integer coordinates): Fig. 4's inputs on the
# [0, 1024)^2 grid and phase 7's n = 5e5, d = 38 exact cloud.
EIM_EXACT = [("unif", 1_000_000, 2, 25), ("gau", 1_000_000, 2, 25),
             ("unb", 1_000_000, 2, 25), ("exact", 500_000, 38, 25)]


def eim_params(n, k):
    """EIM's schedule at n, k: (threshold, s_cap, rank)."""
    from repro_torch.core.eim import _params
    _, threshold, s_cap, _, rank, _, _ = _params(n, k, EIM_EPS, EIM_PHI)
    return threshold, s_cap, rank


def on_grid(x):
    """``x`` rounded onto the integer grid [0, side)^d: the exact tier. The
    side is 1024 where 2·d·side^2 stays below 2^24 (d = 2), else the largest
    that does (469 at d = 38), so |x|^2 + |c|^2 and every partial sum of
    either version are exact f32 integers in any order."""
    x = np.asarray(x, np.float64)
    d = x.shape[1]
    side = min(1024, int(np.sqrt(2.0 ** 24 / (2 * d))))
    lo, hi = x.min(0), x.max(0)
    return np.floor((x - lo) / (hi - lo) * (side - 0.001)).astype(np.float32)


def eim_points(P, gen, n, d, tier, seed=0):
    x = P.GENERATORS[gen](n, d=d, seed=seed)
    return on_grid(x) if tier == "exact" else x


def s_buffer(x, s_cap, rng):
    """An S buffer of the device path: ~95 % of s_cap sampled rows in row
    order, the rest at the 1e18 sentinel of empty slots."""
    rows = np.sort(rng.choice(x.shape[0], s_cap - s_cap // 20, replace=False))
    c = np.full((s_cap, x.shape[1]), 1e18, np.float32)
    c[:rows.size] = x[rows]
    return c


def plain_chunk(engine, n, m, d):
    """The plain route's row chunk for entry points that take ``chunk``
    only (``eim``, ``fused_filter``): what ``memory_budget=PLAIN_TILE_BYTES``
    resolves to on the ops that take a budget."""
    return engine.resolve_chunk(n, m, d, memory_budget=PLAIN_TILE_BYTES)


def phase_eim_shapes(torch, engine, P, rng, results):
    """#2 and #3 at EIM's shapes against their plain versions (in row
    chunks: unchunked, the plain versions would build 51 to 139 GB), each
    kernel of each plan timed; and whether #2 and #3 round every pair's d2
    alike on float inputs (``alike[d]``): where they do, the device path
    and the streamed path must agree bitwise on the kernels."""
    print("== phase 2j: assign (#2) and filter (#3) at EIM's shapes against "
          "their plain versions (in row chunks)", flush=True)
    from repro_torch.kernels import assign
    from repro_torch.kernels import fused_stream as fs
    from repro_torch.kernels._build import sm_count
    alike = {}
    for n, d, k, gen in EIM_ASSIGN:
        _, s_cap, _ = eim_params(n, k)
        chunk = plain_chunk(engine, n, s_cap, d)
        for tier in ("exact", "float"):
            x = eim_points(P, gen, n, d, tier)
            xt, ct = cuda_t(torch, x), cuda_t(torch, s_buffer(x, s_cap, rng))
            got = engine.assign_nearest(xt, ct, impl="kernel")
            want = engine.assign_nearest(xt, ct, impl="ref",
                                         memory_budget=PLAIN_TILE_BYTES)
            # #3 on the same pairs: the d2 the streamed path compares
            ds = torch.full((n,), engine.ref.BIG, device="cuda")
            engine.fused_filter(xt, ct, ds, rank=1, impl="kernel")
            torch.cuda.synchronize()
            err = (got[1] - want[1]).abs().max().item()
            label = f"assign eim n={n} k={s_cap} d={d} {tier}"
            if tier == "exact":
                check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                      f"{label}: not bitwise the plain version")
                check(torch.equal(ds, got[1]), f"{label}: #3 d2 differs from #2")
            else:
                tol = dist2_tol(xt, ct[want[0].long()])
                check(bool(((got[1] - want[1]).abs() <= tol).all()),
                      f"{label}: d2 beyond tolerance ({err})")
                moved = (got[0] != want[0]).nonzero().flatten()
                xr = xt[moved]
                dg = ((xr - ct[got[0][moved].long()]) ** 2).sum(1)
                dw = ((xr - ct[want[0][moved].long()]) ** 2).sum(1)
                check(bool(((dg - dw).abs() <= 2 * tol[moved]).all()),
                      f"{label}: index differs beyond a tie")
                alike[d] = torch.equal(ds, got[1])
            plain = device_ms(torch, lambda: engine.assign_nearest(
                xt, ct, impl="ref", memory_budget=PLAIN_TILE_BYTES),
                reps=2, warmup=1)
            times = {}
            saved = assign.WIDE_MAX_D, assign.WIDE_MAX_KD
            try:
                for route, th in (("tiled", (0, 0)), ("wide", (1 << 30, 1 << 30))):
                    assign.WIDE_MAX_D, assign.WIDE_MAX_KD = th
                    assign.assign_plan.cache_clear()
                    again = engine.assign_nearest(xt, ct, impl="kernel")
                    check(torch.equal(again[0], got[0]) and torch.equal(again[1], got[1]),
                          f"{label}: the {route} kernel differs")
                    times[route] = device_ms(torch, lambda: engine.assign_nearest(
                        xt, ct, impl="kernel"), reps=5, warmup=1)
            finally:
                assign.WIDE_MAX_D, assign.WIDE_MAX_KD = saved
                assign.assign_plan.cache_clear()
            planned = "wide" if assign.assign_plan(n, s_cap, d, sm_count(0)).tc == 0 else "tiled"
            b_ms, b_by = bound(4 * (n * d + s_cap * d + 2 * n),
                               n * s_cap * (2 * d + 5) + 2 * d * (n + s_cap))
            print(f"{label}: ok max_abs_err={err:.3g} planned={planned} "
                  f"kernel_ms={times[planned]:.5f} tiled_ms={times['tiled']:.5f} "
                  f"wide_ms={times['wide']:.5f} plain_ms={plain:.5f} "
                  f"(chunk={chunk} rows) bound_ms={b_ms:.5f} ({b_by}) "
                  f"library_ms=None (one torch.cdist call would build the "
                  f"{n * s_cap * 4 / 1e9:.0f} GB matrix) "
                  f"filter_d2_equal={torch.equal(ds, got[1])}", flush=True)
            results.append(dict(kernel="assign", shape=(n, s_cap, d, gen), tier=tier,
                                err=err, ms=times[planned], plain_ms=plain,
                                bound_ms=b_ms, bound_by=b_by, library_ms=None))
    saved = fs.SMALL_MAX_D, fs.TILED_MIN_KD
    for big_n, budget, d, k, gen in EIM_FILTER:
        _, s_cap, rank = eim_params(big_n, k)
        n = engine.resolve_block_rows(big_n, d, memory_budget=budget)
        chunk = plain_chunk(engine, n, s_cap, d)
        for tier in ("exact", "float"):
            x = eim_points(P, gen, n, d, tier, seed=5)
            xt, ct = cuda_t(torch, x), cuda_t(torch, s_buffer(x, s_cap, rng))
            ds0 = cuda_t(torch, np.floor(rng.random(n) * 5000).astype(np.float32))
            hm = cuda_t(torch, rng.random(n) < 0.4)
            got = engine.fused_filter(xt, ct, ds0.clone(), hm, rank=rank, impl="kernel")
            want = engine.fused_filter(xt, ct, ds0.clone(), hm, rank=rank, impl="ref",
                                       chunk=chunk)
            tops = [engine.merge_top_k(engine.top_k_init(rank), t[1], rank)
                    for t in (got, want)]
            # #2 on the same pairs; the plain assign's nearest centers
            # scale the float tier's per-row tolerance
            d2 = torch.minimum(ds0, engine.assign_nearest(xt, ct, impl="kernel")[1])
            near = None if tier == "exact" else engine.assign_nearest(
                xt, ct, impl="ref", memory_budget=PLAIN_TILE_BYTES)[0].long()
            torch.cuda.synchronize()
            err = max((got[0] - want[0]).abs().max().item(),
                      (got[1] - want[1]).abs().max().item())
            label = f"filter eim n={n} k={s_cap} d={d} rank={rank} {tier}"
            if tier == "exact":
                check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                      f"{label}: not bitwise the plain version")
                check(torch.equal(got[0], d2), f"{label}: #2 d2 differs from #3")
            else:
                tol = dist2_tol(xt, ct[near])
                check(bool(((got[0] - want[0]).abs() <= tol).all()),
                      f"{label}: ds beyond tolerance ({err})")
                check(torch.allclose(tops[0], tops[1], rtol=1e-4, atol=1e-4),
                      f"{label}: merged top beyond rtol 1e-4")
                alike[d] = alike[d] and torch.equal(got[0], d2)
            plain = device_ms(torch, lambda: engine.fused_filter(
                xt, ct, ds0.clone(), hm, rank=rank, impl="ref", chunk=chunk),
                reps=2, warmup=1)
            times = {}
            try:
                for route in ("small", "tiled", "wide"):
                    if route == "small" and d > 8:
                        continue
                    forced_filter_route(fs, route)
                    if fs.filter_plan(n, s_cap, d, sm_count(0)).route != getattr(
                            fs, f"ROUTE_{route.upper()}"):
                        continue
                    again = engine.fused_filter(xt, ct, ds0.clone(), hm, rank=rank,
                                                impl="kernel")
                    check(torch.equal(again[0], got[0]) and torch.equal(again[1], got[1]),
                          f"{label}: the {route} kernel differs")
                    scratch = ds0.clone()
                    times[route] = device_ms(torch, lambda: engine.fused_filter(
                        xt, ct, scratch, hm, rank=rank, impl="kernel"),
                        reps=5, warmup=1)
            finally:
                fs.SMALL_MAX_D, fs.TILED_MIN_KD = saved
                fs.filter_plan.cache_clear()
            names = {fs.ROUTE_SMALL: "small", fs.ROUTE_TILED: "tiled",
                     fs.ROUTE_WIDE: "wide"}
            planned = names[fs.filter_plan(n, s_cap, d, sm_count(0)).route]
            ntiles = -(-n // engine.ref.FILTER_TILE_ROWS)
            b_ms, b_by = bound(4 * (n * d + s_cap * d + ntiles * rank) + 9 * n,
                               n * s_cap * (2 * d + 5) + 2 * d * (n + s_cap))
            print(f"{label}: ok max_abs_err={err:.3g} planned={planned} "
                  f"kernel_ms={times[planned]:.5f} " + " ".join(
                      f"{r}_ms={t:.5f}" for r, t in times.items())
                  + f" plain_ms={plain:.5f} (chunk={chunk} rows) bound_ms={b_ms:.5f} "
                  f"({b_by}) assign_d2_equal={torch.equal(got[0], d2)}", flush=True)
            results.append(dict(kernel="fused_filter", shape=(n, s_cap, d, rank, gen),
                                tier=tier, err=err, ms=times[planned], plain_ms=plain,
                                bound_ms=b_ms, bound_by=b_by, library_ms=None))
    print(f"#2 and #3 round every pair's d2 alike on float inputs at EIM's "
          f"shapes: {alike}", flush=True)
    return alike


def eim_stats(res, n, k):
    """The sample's numbers: iterations, |S|, |C|, overflow, sampled, and
    the §4 cap on |C|."""
    from repro_torch.core.eim import _sample_cap
    s = res.sample
    size_s = int(s.s_mask.sum())
    return dict(iters=int(s.iters), S=size_s, C=int(s.sample_mask.sum()),
                overflow=int(s.overflow), sampled=bool(s.sampled),
                cap=_sample_cap(n, k, EIM_EPS, size_s))


def same_eim(a, b) -> bool:
    """Bitwise the same EIM result: sample, iterations, overflow, centers
    and radius2."""
    sa, sb = a.sample, b.sample
    return (torch_equal(sa.sample_mask, sb.sample_mask)
            and torch_equal(sa.s_mask, sb.s_mask)
            and int(sa.iters) == int(sb.iters)
            and int(sa.overflow) == int(sb.overflow)
            and bool(sa.sampled) == bool(sb.sampled)
            and torch_equal(a.centers, b.centers)
            and a.radius2.item() == b.radius2.item())


def same_sample(a, b) -> bool:
    return (torch_equal(a.sample.sample_mask, b.sample.sample_mask)
            and torch_equal(a.sample.s_mask, b.sample.s_mask))


def torch_equal(a, b) -> bool:
    import torch
    return torch.equal(a.cpu(), b.cpu())


def check_eim_float(label, res, r2_plain, st):
    """What a float run must show: overflow 0, |C| within the §4 cap, and
    radius2 its own centers' covering radius (recomputed by the plain
    version, rtol 1e-4)."""
    check(st["overflow"] == 0, f"{label}: overflow {st['overflow']}")
    check(st["sampled"] and st["C"] <= st["cap"],
          f"{label}: |C| = {st['C']} past the §4 cap {st['cap']}")
    r2 = res.radius2.item()
    check(np.isfinite(r2) and abs(r2 - r2_plain) <= 1e-4 * abs(r2_plain),
          f"{label}: radius2 {r2} vs its centers' plain radius2 {r2_plain}")


def eim_syncs(kind, iters):
    """The synchronising calls an eim run makes. Device path: one read of
    |R| for each evaluation of the loop condition (iterations + 1), and one
    read of the sample's masks for the compaction; none in the final GON
    or the radius. Streamed loop: per iteration one wait for the sampler's
    masks (copied back to pinned memory without a wait) and the filter
    round's pivot read (its d_s blocks come back on non-blocking copies
    that the read orders); none in the final GON or the streamed radius."""
    return iters + 2 if kind == "device" else 2 * iters


def streamed_allowance(ex, src, k, c_size, shards=1):
    """Device memory a streamed eim run may take beyond what was allocated
    before it: the ring's residency model at the budget, the S buffer
    (s_cap·d·4), the tile tops and their merge (twice ceil(rows / 256)·rank
    f32), a block's ds and H mask (two blocks' live), the ragged block
    padded to rows, the sampler's int64 words (SAMPLE_ROWS rows, 16 words
    a row), the final GON's gathered sample padded to a power of two (its
    points twice while padded, its md) and phase 5's slack. A mesh step
    holds the rows of ``shards`` shards (a process's, phase 13)."""
    from repro_torch.core.eim import SAMPLE_ROWS, _compact_cap
    rows, d = ex.rows_for(src) * shards, src.d
    _, s_cap, rank = eim_params(src.n, k)
    cap = _compact_cap(c_size, src.n)
    return ((ex.prefetch + 1) * 4 * rows * (d + 1) + 4 * s_cap * d
            + 2 * 4 * -(-rows // 256) * rank + 2 * 5 * rows + 4 * rows * d
            + SAMPLE_ROWS * 8 * 16 + 4 * cap * (2 * d + 1) + PEAK_SLACK)


def phase_eim(torch, engine, P, counters, alike):
    print("== phase 10: EIM (paper §4), impl='auto' against impl='ref' on the "
          "card; the device path, SimExecutor and HostStreamExecutor", flush=True)
    from repro_torch.core import (HostStreamExecutor, SimExecutor, eim, mrg)
    from repro_torch.data.source import HostSource, synthetic_source
    totals = {name: 0 for name in counters}

    def counted(label, fn, kind, path):
        t0 = time.perf_counter()
        res, launches, syncs, blocks, peak = counted_run(torch, fn, counters)
        wall = (time.perf_counter() - t0) * 1e3
        report_syncs(syncs)
        iters = int(res.sample.iters)
        want = eim_syncs(kind, iters)
        check(len(syncs) == want, f"{label}: {len(syncs)} synchronising calls, "
              f"expected {want} ({kind}, {iters} iterations)")
        for name in path:
            check(launches[name] > 0, f"{label}: kernel {name} never launched")
        for name, c in launches.items():
            totals[name] += c
        return res, launches, len(syncs), blocks, peak, wall

    # -- 10a: in memory, the device path ---------------------------------
    for gen, n, d, k in EIM_CONFIGS:
        x = P.GENERATORS[gen](n, d=d, seed=0)
        xt = cuda_t(torch, x)
        _, s_cap, rank = eim_params(n, k)
        chunk = plain_chunk(engine, n, s_cap, d)
        label = f"10a eim {gen} n={n} d={d} k={k} device path"
        eim(xt, k, EIM_KEY)                                   # warm-up
        res, launches, syncs, _, _, wall = counted(
            label, lambda: eim(xt, k, EIM_KEY), "device", ("assign", "gon_step"))
        ref = eim(xt, k, EIM_KEY, impl="ref", chunk=chunk)
        sim = eim(xt, k, EIM_KEY, executor=SimExecutor(50))
        st, st_ref = eim_stats(res, n, k), eim_stats(ref, n, k)
        for lab, r, s in ((label, res, st), (label + " ref", ref, st_ref)):
            r2_plain = engine.assign_nearest(xt, r.centers, impl="ref",
                                             chunk=chunk)[1].max().item()
            check_eim_float(lab, r, r2_plain, s)
        equal = same_sample(res, ref)
        if equal:
            check(torch.equal(res.centers, ref.centers),
                  f"{label}: equal samples but centers differ from ref")
        sim_equal = same_eim(res, sim)
        if alike.get(d):
            check(sim_equal, f"{label}: SimExecutor(m=50) differs from the device "
                  "path though #2 and #3 round alike")
        mrg(xt, k, m=50)
        m_walls = wall_ms(torch, lambda: mrg(xt, k, m=50))
        m_r2 = mrg(xt, k, m=50).radius2.item()
        r2 = res.radius2.item()
        print(f"{label}: ok iterations={st['iters']} |S|={st['S']} |C|={st['C']} "
              f"cap={st['cap']} overflow={st['overflow']} s_cap={s_cap} rank={rank} "
              f"radius2={r2!r} ref_radius2={ref.radius2.item()!r} "
              f"ref_iterations={st_ref['iters']} ref_|C|={st_ref['C']} "
              f"sample_equal_to_ref={equal} sim_m50_bitwise={sim_equal} "
              f"wall_ms={wall:.3f} launches={launches} sync_warnings={syncs} "
              f"mrg_radius2={m_r2!r} mrg_wall_ms={[round(w, 3) for w in m_walls]} "
              f"eim_over_mrg_radius={(r2 / m_r2) ** 0.5:.6f}", flush=True)
        del xt, ref, sim

    # -- 10b: out of core, HostStreamExecutor --------------------------------
    kdd = HostSource(kdd_host(P))
    # The unif generator runs at compact_threshold=0: a compacted view of a
    # generator costs one block_fn call per run of consecutive surviving
    # rows (~40 % of 1e7 rows survive the first iteration, scattered), far
    # more than the pass it saves; the sample does not depend on the knob.
    runs = [("10b eim unif n=1e7 d=2 synthetic, 64 MiB, compact_threshold=0",
             synthetic_source("unif", 10_000_000, d=2, seed=0), 64 * MiB, 0.0),
            ("10b eim kddlike n=4e6 d=38 host, 256 MiB, compact_threshold=0.5",
             kdd, 256 * MiB, 0.5)]
    for label, src, budget, ct in runs:
        k = 25
        ex = HostStreamExecutor(memory_budget=budget)
        rows = ex.rows_for(src)
        _, s_cap, rank = eim_params(src.n, k)
        chunk = plain_chunk(engine, rows, s_cap, src.d)
        res, launches, syncs, blocks, peak, wall = counted(
            label, lambda: eim(src, k, EIM_KEY, executor=ex, compact_threshold=ct),
            "streamed", ("fused_filter", "gon_step"))
        st = eim_stats(res, src.n, k)
        allowed = streamed_allowance(ex, src, k, st["C"])
        check(peak <= allowed, f"{label}: peak device memory {peak} bytes above "
              f"the allowed {allowed}")
        ref = eim(src, k, EIM_KEY, executor=ex, compact_threshold=ct, impl="ref",
                  chunk=chunk)
        st_ref = eim_stats(ref, src.n, k)
        for lab, r, s in ((label, res, st), (label + " ref", ref, st_ref)):
            check_eim_float(lab, r, ex.radius2(src, r.centers, impl="ref",
                                               chunk=chunk).item(), s)
        equal = same_sample(res, ref)
        if equal:
            check(torch.equal(res.centers, ref.centers),
                  f"{label}: equal samples but centers differ from ref")
        # the device path on the same points, on the kernels
        x = src.materialize("cuda")
        dev = eim(x, k, EIM_KEY)
        dev_equal = same_eim(dev, res)
        if alike.get(src.d):
            check(dev_equal, f"{label}: the device path differs though #2 and #3 "
                  "round alike")
        del x
        print(f"{label}: ok super-shard rows={rows} iterations={st['iters']} "
              f"|S|={st['S']} |C|={st['C']} cap={st['cap']} overflow={st['overflow']} "
              f"s_cap={s_cap} rank={rank} radius2={res.radius2.item()!r} "
              f"ref_radius2={ref.radius2.item()!r} ref_iterations={st_ref['iters']} "
              f"sample_equal_to_ref={equal} device_path_bitwise={dev_equal} "
              f"wall_ms={wall:.3f} launches={launches} sync_warnings={syncs} "
              f"blocks_streamed={blocks} peak_MiB={peak / MiB:.2f} "
              f"allowed_MiB={allowed / MiB:.2f} budget_MiB={budget / MiB}", flush=True)

    # -- 10c: the exact tier, every form bitwise -----------------------------
    rng = np.random.default_rng(7)
    for gen, n, d, k in EIM_EXACT:
        x = (exact_points(rng, (n, d)) if gen == "exact"
             else eim_points(P, gen, n, d, "exact"))
        xt = cuda_t(torch, x)
        _, s_cap, _ = eim_params(n, k)
        chunk = plain_chunk(engine, n, s_cap, d)
        ex = HostStreamExecutor(memory_budget=16 * MiB if d == 2 else 64 * MiB)
        forms = {"device kernel": eim(xt, k, EIM_KEY),
                 "device plain": eim(xt, k, EIM_KEY, impl="ref", chunk=chunk),
                 "SimExecutor(m=50)": eim(xt, k, EIM_KEY, executor=SimExecutor(50)),
                 "HostStreamExecutor": eim(HostSource(x), k, EIM_KEY, executor=ex)}
        if d > 2:
            forms["HostStreamExecutor plain"] = eim(
                HostSource(x), k, EIM_KEY, executor=ex, impl="ref",
                chunk=plain_chunk(engine, ex.rows_for(HostSource(x)), s_cap, d))
        first = forms["device kernel"]
        for name, r in forms.items():
            check(same_eim(first, r), f"10c eim {gen} n={n} d={d}: {name} differs "
                  "from the device path on the kernels")
        st = eim_stats(first, n, k)
        check(st["overflow"] == 0 and st["C"] <= st["cap"],
              f"10c eim {gen}: overflow {st['overflow']}, |C| {st['C']}")
        print(f"10c eim {gen} exact-tier n={n} d={d} k={k}: {sorted(forms)} bitwise "
              f"(sample_mask, s_mask, iterations, overflow, sampled, centers, "
              f"radius2) iterations={st['iters']} |S|={st['S']} |C|={st['C']} "
              f"radius2={first.radius2.item()!r} host_rows={ex.rows_for(HostSource(x))}",
              flush=True)
        del xt, forms, first
    return totals


def phase_eim_profile(torch, P):
    print("== phase 10d: profiles of one eim run of each form (device path "
          "unif n=1e6 k=25; streamed kddlike n=4e6 d=38 at 256 MiB, k=25)",
          flush=True)
    from repro_torch.core import HostStreamExecutor, eim
    from repro_torch.data.source import HostSource
    from repro_torch.kernels import engine
    xt = cuda_t(torch, P.unif(1_000_000, d=2, seed=0))
    kdd = HostSource(kdd_host(P))
    ex = HostStreamExecutor(memory_budget=256 * MiB)
    runs = [("device path unif n=1e6 k=25", lambda: eim(xt, 25, EIM_KEY)),
            ("streamed kddlike n=4e6 k=25", lambda: eim(kdd, 25, EIM_KEY,
                                                        executor=ex))]
    for label, fn in runs:
        fn()
        with HostClock(engine, ("bernoulli_rows", "bernoulli_rows_block",
                                "bernoulli_rows_at_block")) as clock:
            prof = device_profile(torch, fn)
        if prof is None:
            print("profile: no device time recorded (not measured)", flush=True)
            return
        wall, busy, nk, copy, nc, by_name = prof
        print(f"profile {label}: wall_ms={wall:.3f} (profiler on) "
              f"kernel_busy_ms={busy:.3f} kernels={nk} copy_ms={copy:.3f} "
              f"copies={nc} idle_share_of_wall={1 - busy / wall:.4f} "
              f"sampler_host_ms={sum(clock.ms.values()):.3f} (enqueueing the "
              f"draws)", flush=True)
        for name, (ms, count) in sorted(by_name.items(), key=lambda r: -r[1][0])[:8]:
            print(f"  {ms:9.4f} ms  {count:6d}x  {name[:90]}", flush=True)


# -- slice 9: the online k-center service ------------------------------------

# Phase 11a: every query row bucket of the service (1 row pads to 8; 11 to
# 16, 50 to 64, 200 to 256) against its center buckets: 11b's sketch (k=16,
# d=16, gau 4096), 11c's (phase 8's kddlike sketch, k=100, d=38, in 128
# slots), one live center in 8 slots, and 50 live centers in 64 slots at
# d=7, where the live set plans onto the wide assign kernel (k·d = 350) and
# the bucket onto the tiled one (448). Times at 8 x 16 x 16 and 256 x 16 x
# 16 (the wide kernel) and 256 rows against the kddlike bucket (tiled).
SERVE_ROWS = (1, 11, 32, 50, 128, 200)
SERVE_K, SERVE_D, SERVE_BOOT = 16, 16, 4096      # benchmarks/serve_bench.py
SERVE_CLIENTS, SERVE_SECONDS = 64, 3.0
SERVE_FEED_ROWS, SERVE_FEED_EVERY_S = 512, 0.002
SERVE_POOL = 16            # held-out query rows a client cycles through


def serve_bucket(torch, centers, mcap):
    """``centers`` in an ``mcap``-slot bucket on the card, the rows past
    them at the 1e18 sentinel as the service fills them, and the host
    mask."""
    m, d = centers.shape
    host = np.full((mcap, d), 1e18, np.float32)
    host[:m] = centers
    live = np.zeros((mcap,), bool)
    live[:m] = True
    return torch.from_numpy(host).cuda(), live


def serve_sets(P, rng, boot, kdd):
    """11a's center sets: (label, float-tier centers, float-tier query
    source, bucket slots)."""
    from repro_torch.serve.kcenter import _pow2_at_least
    def gau_rows(n):
        return P.gau(n, SERVE_K, d=SERVE_D, seed=1)
    def kdd_rows(n):
        return P.kddlike(n, seed=1)
    def rows7(n):
        return (rng.normal(size=(n, 7)) * 5.0).astype(np.float32)
    def rows16(n):
        return (rng.normal(size=(n, SERVE_D)) * 5.0).astype(np.float32)
    return [("11b k=16 d=16", boot, gau_rows, _pow2_at_least(boot.shape[0], 8)),
            ("11c kddlike k=100 d=38", kdd, kdd_rows, _pow2_at_least(kdd.shape[0], 8)),
            ("one live center d=16", rows16(1), rows16, 8),
            ("route crossing d=7", rows7(50), rows7, 64)]


def phase_serve_shapes(torch, engine, P, rng, results, kdd_sketch):
    print("== phase 11a: the service's query op (engine.assign_bucketed, "
          "assign.cu) at its buckets against the kernel on the live rows, "
          "the kernel on the whole bucket and the plain version", flush=True)
    from repro_torch.core.streaming import stream_init, stream_update
    from repro_torch.kernels import ops
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.assign import assign_nearest_cuda, assign_plan
    from repro_torch.serve.kcenter import _pow2_at_least
    # 11b's sketch (the service's bootstrap) and phase 8's kddlike one
    sketch = stream_update(stream_init(SERVE_K, SERVE_D),
                           P.gau(SERVE_BOOT, SERVE_K, d=SERVE_D, seed=1))
    boot = sketch.centers[:sketch.count]
    kdd = kdd_sketch.centers[:kdd_sketch.count]
    launches = 0
    routes = set()
    for label, centers, queries, mcap in serve_sets(P, rng, boot, kdd):
        m, d = centers.shape
        for tier in ("exact", "float"):
            c = exact_points(rng, (m, d)) if tier == "exact" else centers
            ct, live = serve_bucket(torch, c, mcap)
            for b in SERVE_ROWS:
                bq = _pow2_at_least(b, 8)
                q = np.zeros((bq, d), np.float32)
                q[:b] = exact_points(rng, (b, d)) if tier == "exact" else queries(b)
                qt = torch.from_numpy(q).cuda()
                before = assign_nearest_cuda.launches
                got = ops.assign_bucketed(qt, ct, live)
                launches += assign_nearest_cuda.launches - before
                check(assign_nearest_cuda.launches - before == 1,
                      f"11a {label} b={b}: {assign_nearest_cuda.launches - before} "
                      "launches for one call")
                live_run = engine.assign_nearest(qt[:b].contiguous(), ct[:m],
                                                 impl="kernel")
                whole = engine.assign_nearest(qt, ct, impl="kernel")
                plain = ops.assign_bucketed(qt, ct, live, impl="ref")
                torch.cuda.synchronize()
                name = f"11a {label} {tier} b={b} bucket={bq}x{mcap} live={m}"
                gi, gd = got[0][:b], got[1][:b]
                check(torch.equal(gi, live_run[0]) and torch.equal(gd, live_run[1]),
                      f"{name}: not bitwise the kernel on the live rows")
                # the bucket's own plan (1e18 rows included) against the live
                # run's: the two routes of assign_plan agree bitwise
                r_live = assign_plan(b, m, d, sm_count(0))
                r_whole = assign_plan(bq, mcap, d, sm_count(0))
                routes.add((label, "wide" if r_live.tc == 0 else "tiled",
                            "wide" if r_whole.tc == 0 else "tiled"))
                check(torch.equal(gi, whole[0][:b]) and torch.equal(gd, whole[1][:b]),
                      f"{name}: the whole bucket's launch (route "
                      f"{'wide' if r_whole.tc == 0 else 'tiled'}) differs from the "
                      f"live run's ({'wide' if r_live.tc == 0 else 'tiled'})")
                pi, pd = plain[0][:b], plain[1][:b]
                err = (gd - pd).abs().max().item()
                if tier == "exact":
                    check(torch.equal(gi, pi) and torch.equal(gd, pd),
                          f"{name}: not bitwise the plain version")
                else:
                    tol = dist2_tol(qt[:b], ct[:m][pi.long()])
                    check(bool(((gd - pd).abs() <= tol).all()),
                          f"{name}: d2 beyond tolerance of the plain version ({err})")
                    if m > 1:
                        two = torch.topk(engine.pairwise_dist2(qt[:b], ct[:m], impl="ref"),
                                         2, dim=1, largest=False).values
                        unique = (two[:, 1] - two[:, 0]) > 2 * tol
                        check(torch.equal(gi[unique], pi[unique]),
                              f"{name}: index differs from the plain version where unique")
                    else:
                        check(torch.equal(gi, pi), f"{name}: index differs")
                results.append(dict(kernel="assign", shape=(b, m, d, label), tier=tier,
                                    err=err, ms=None, plain_ms=None, bound_ms=None,
                                    bound_by=None, library_ms=None))
            print(f"11a {label} {tier}: ok at query buckets "
                  f"{[_pow2_at_least(b, 8) for b in SERVE_ROWS]} against {m} live "
                  f"of {mcap}: bitwise the kernel on the live rows and on the "
                  f"whole bucket, {'bitwise' if tier == 'exact' else 'within tolerance of'} "
                  "the plain version", flush=True)
    for label, r_live, r_whole in sorted(routes):
        print(f"11a routes {label}: live rows -> {r_live}, whole bucket -> {r_whole}",
              flush=True)
    check(any(r[1] != r[2] for r in routes),
          "11a: no shape put the live rows and the bucket on different routes")
    # times: one row (bucket 8) and 256 rows against 11b's bucket (the wide
    # kernel), 256 rows against 11c's (tiled)
    sets = {s[0]: s for s in serve_sets(P, rng, boot, kdd)}
    for b, label in ((8, "11b k=16 d=16"), (256, "11b k=16 d=16"),
                     (256, "11c kddlike k=100 d=38")):
        _, centers, queries, mcap = sets[label]
        m, d = centers.shape
        ct, live = serve_bucket(torch, centers, mcap)
        qt = torch.from_numpy(queries(b)).cuda()
        plan = assign_plan(b, m, d, sm_count(0))
        ms = device_ms(torch, lambda: ops.assign_bucketed(qt, ct, live, impl="kernel"))
        plain = device_ms(torch, lambda: ops.assign_bucketed(qt, ct, live, impl="ref"))
        lib = device_ms(torch, lambda: torch.cdist(qt, ct[:m]).min(1))
        b_ms, b_by = bound(4 * (b * d + m * d + 2 * b), b * m * (2 * d + 5) + 2 * d * (b + m))
        print(f"11a times {label} n={b} k={m} (bucket {mcap}) d={d}: "
              f"kernel_ms={ms:.5f} ({'wide' if plan.tc == 0 else 'tiled'}) "
              f"plain_ms={plain:.5f} library_ms={lib:.5f} (torch.cdist(q, c).min(1)) "
              f"bound_ms={b_ms:.7f} ({b_by})", flush=True)
        results.append(dict(kernel="assign", shape=(b, m, d, "11a " + label), tier="float",
                            err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
                            bound_by=b_by, library_ms=lib))
    print(f"11a: assign_bucketed launched kernel #2 {launches} times (one a call)",
          flush=True)
    return {"assign": launches}


def pcts_us(lats):
    """(mean, p50, p95, p99) of latencies in seconds, in microseconds."""
    a = np.asarray(lats, np.float64) * 1e6
    return (float(a.mean()), float(np.percentile(a, 50)),
            float(np.percentile(a, 95)), float(np.percentile(a, 99)))


def closed_loop(svc, pools, seconds):
    """``len(pools)`` client threads, each sending one row at a time from
    its pool and waiting for the answer, for ``seconds``. Returns
    ``(latencies s, qps, answers [(client, row, AssignResult)], errors)``."""
    lats = [[] for _ in pools]
    answers = [[] for _ in pools]
    errors = []
    gate = threading.Barrier(len(pools) + 1)
    stop = threading.Event()

    def client(i):
        pool = pools[i]
        gate.wait()
        j = 0
        try:
            while not stop.is_set():
                row = j % pool.shape[0]
                t0 = time.monotonic()
                res = svc.assign(pool[row:row + 1], timeout=60)
                lats[i].append(time.monotonic() - t0)
                answers[i].append((row, res))
                j += 1
        except Exception as e:  # noqa: BLE001 — reported and failed on below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(pools))]
    for t in threads:
        t.start()
    gate.wait()
    t0 = time.monotonic()
    time.sleep(seconds)
    stop.set()
    for t in threads:
        t.join(timeout=120)
    wall = time.monotonic() - t0
    check(not any(t.is_alive() for t in threads), "a client thread did not stop")
    flat = [(i, row, res) for i, per in enumerate(answers) for row, res in per]
    return [x for per in lats for x in per], len(flat) / wall, flat, errors


def open_loop(svc, pool, rate, seconds):
    """Tickets of one row each at ``rate`` a second for ``seconds``,
    whatever the answers. Returns ``(latencies s, qps, answers, errors)``."""
    period = 1.0 / rate
    tickets = []
    t0 = time.monotonic()
    while True:
        now = time.monotonic()
        if now - t0 >= seconds:
            break
        target = t0 + len(tickets) * period
        if now < target:
            time.sleep(min(target - now, 0.001))
            continue
        row = len(tickets) % pool.shape[0]
        tickets.append((row, svc.assign_async(pool[row:row + 1])))
    answers, errors = [], []
    for row, t in tickets:
        try:
            answers.append((0, row, t.result(timeout=60)))
        except Exception as e:  # noqa: BLE001 — reported and failed on below
            errors.append(repr(e))
    wall = time.monotonic() - t0
    lats = [t.t_done - t.t_submit for _, t in tickets]
    return lats, len(tickets) / wall, answers, errors


def check_answers(torch, engine, svc, pools, answers, name):
    """Every answer bitwise the kernel's offline assign on the centers of
    its epoch: the answered rows of each epoch in one launch. Returns the
    epochs seen."""
    by_epoch = {}
    for i, row, res in answers:
        by_epoch.setdefault(res.epoch, []).append((i, row, res))
    for epoch, got in by_epoch.items():
        q = np.stack([pools[i][row] for i, row, _ in got])
        c = torch.from_numpy(svc.snapshot_at(epoch)).cuda()
        want_i, want_d = engine.assign_nearest(torch.from_numpy(q).cuda(), c,
                                               impl="kernel")
        gi = np.array([res.idx[0] for _, _, res in got], np.int32)
        gd = np.array([res.d2[0] for _, _, res in got], np.float32)
        check(np.array_equal(gi, want_i.cpu().numpy())
              and np.array_equal(gd, want_d.cpu().numpy()),
              f"{name}: an answer of epoch {epoch} is not bitwise the offline "
              "kernel assign on its centers")
    return sorted(by_epoch)


def serve_run(torch, engine, svc, pools, name, drive):
    """One load run: ``drive()`` -> (latencies, qps, answers, errors);
    prints the run's line and returns its QPS."""
    from repro_torch.serve import kcenter
    st0 = svc.stats
    with HostClock(kcenter.KCenterService, ("_upload", "_launch", "_read")) as clock:
        lats, qps, answers, errors = drive()
    st = svc.stats
    check(not errors, f"{name}: {len(errors)} tickets failed: {errors[:3]}")
    mean, p50, p95, p99 = pcts_us(lats)
    check(np.isfinite(p99), f"{name}: p99 not finite")
    epochs = check_answers(torch, engine, svc, pools, answers, name)
    dispatches = st["batches"] - st0["batches"]
    rows = st["batched_rows"] - st0["batched_rows"]
    per = {k: clock.ms.get(k, 0.0) * 1e3 / max(dispatches, 1)
           for k in ("_upload", "_launch", "_read")}
    print(f"{name}: ok qps={qps:.1f} latency_us mean={mean:.1f} p50={p50:.1f} "
          f"p95={p95:.1f} p99={p99:.1f} answers={len(answers)} "
          f"dispatches={dispatches} mean_batch={rows / max(dispatches, 1):.2f} "
          f"epochs={st['epochs'] - st0['epochs']} "
          f"cache_refreshes={st['cache_refreshes'] - st0['cache_refreshes']} "
          f"bucket_growths={st['bucket_growths'] - st0['bucket_growths']} "
          f"answer_epochs={epochs[:8]}{'...' if len(epochs) > 8 else ''} "
          f"host_us_per_dispatch(pad+upload={per['_upload']:.2f} "
          f"launch={per['_launch']:.2f} read={per['_read']:.2f}; clock on) "
          "every answer bitwise the kernel assign on its epoch's centers",
          flush=True)
    return qps


def serve_syncs(torch, svc, pool):
    """Synchronising calls over single-row dispatches, one at a time, and
    a 300-row request (two slices of max_batch 256): one a slice. Only
    the dispatch thread is at work, so the warnings it raises are
    recorded without a race."""
    # control: a warning raised in another thread is recorded here
    probe = torch.ones(4).cuda()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t = threading.Thread(target=lambda: probe.sum().item())
        t.start()
        t.join(timeout=60)
        torch.cuda.set_sync_debug_mode(0)
    check(len(sync_warnings(caught)) == 1, "sync detection control (thread) failed")
    slices = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        for row in range(pool.shape[0]):
            svc.assign(pool[row:row + 1], timeout=60)
            slices += 1
        svc.assign(np.concatenate([pool] * 19)[:300], timeout=60)
        slices += 2
        torch.cuda.set_sync_debug_mode(0)
    syncs = sync_warnings(caught)
    report_syncs(syncs[:2])
    check(len(syncs) == slices, f"{len(syncs)} synchronising calls for {slices} "
          "dispatch slices (expected one a slice)")
    return len(syncs), slices


def phase_serve(torch, engine, P, counters, kdd_sketch, kdd_src):
    from repro_torch.serve import KCenterService
    print(f"== phase 11b: KCenterService at benchmarks/serve_bench.py's "
          f"configuration (k={SERVE_K}, d={SERVE_D}, bootstrap gau {SERVE_BOOT}, "
          f"{SERVE_CLIENTS} closed-loop clients of one row, {SERVE_SECONDS} s a run)",
          flush=True)
    # held-out rows: the bootstrap's clusters (gau draws its cluster
    # centers first, from the seed), other draws around them
    pools = list(P.gau(SERVE_CLIENTS * SERVE_POOL, SERVE_K, d=SERVE_D, seed=1)
                 .reshape(SERVE_CLIENTS, SERVE_POOL, SERVE_D))

    def boot(**kw):
        svc = KCenterService(SERVE_K, SERVE_D, snapshot_history=True, **kw)
        svc.submit_points(P.gau(SERVE_BOOT, SERVE_K, d=SERVE_D, seed=1))
        svc.drain(timeout=120)
        for b in (1, 16, 32, 64, 128, 256):      # every query bucket
            svc.assign(np.concatenate(pools)[:b], timeout=60)
        return svc

    with boot() as svc:
        epoch, centers, _ = svc.snapshot()
        syncs, slices = serve_syncs(torch, svc, pools[0])
        print(f"11b syncs: {syncs} synchronising calls over {slices} dispatch "
              f"slices; live centers {centers.shape[0]}", flush=True)
        qps_b = serve_run(torch, engine, svc, pools, "11b batched",
                          lambda: closed_loop(svc, pools, SERVE_SECONDS))
    with boot(batching=False) as svc:
        qps_u = serve_run(torch, engine, svc, pools, "11b unbatched",
                          lambda: closed_loop(svc, pools, SERVE_SECONDS))
    print(f"11b batched/unbatched qps ratio={qps_b / qps_u:.3f} (reported, not gated)",
          flush=True)
    with boot() as svc:
        feed_pool = P.gau(16_384, SERVE_K, d=SERVE_D, seed=1)
        stop = threading.Event()

        def feeder():
            off = 0
            while not stop.is_set():
                svc.submit_points(feed_pool[off:off + SERVE_FEED_ROWS])
                off = (off + SERVE_FEED_ROWS) % (feed_pool.shape[0] - SERVE_FEED_ROWS)
                time.sleep(SERVE_FEED_EVERY_S)

        def drive():
            feed = threading.Thread(target=feeder, daemon=True)
            feed.start()
            try:
                return closed_loop(svc, pools, SERVE_SECONDS)
            finally:
                stop.set()
                feed.join(timeout=60)
                svc.drain(timeout=120)

        serve_run(torch, engine, svc, pools, "11b live ingest (512 rows every 2 ms)",
                  drive)
    with boot() as svc:
        rate = max(0.3 * qps_b, 100.0)
        serve_run(torch, engine, svc, [pools[0]], f"11b open loop at {rate:.0f}/s",
                  lambda: open_loop(svc, pools[0], rate, SERVE_SECONDS))

    print("== phase 11c: KCenterService at the sketch's kddlike configuration "
          "(phase 8's source, k=100, d=38)", flush=True)
    from repro_torch.core.streaming import stream_update
    totals = {name: 0 for name in counters}
    with KCenterService(100, 38, snapshot_history=True) as svc:
        passes = stream_update.coverage_passes

        def ingest():
            svc.submit_points(kdd_src)
            svc.drain(timeout=600)
        t0 = time.perf_counter()
        _, launches, _, _, _ = counted_run(torch, ingest, counters)
        wall = (time.perf_counter() - t0) * 1e3
        passes = stream_update.coverage_passes - passes
        epoch, centers, r = svc.snapshot()
        check(launches["assign"] == passes and launches["pairwise"] == 1,
              f"11c ingest: {launches} launches for {passes} coverage passes")
        check(r == kdd_sketch.r and np.array_equal(
            centers, kdd_sketch.centers[:kdd_sketch.count]),
            "11c: the service's sketch differs from phase 8's stream_update")
        for name, v in launches.items():
            totals[name] += v
        print(f"11c ingest: ok count={centers.shape[0]} r={r!r} epochs={svc.stats['epochs']} "
              f"coverage_passes={passes} launches={launches} wall_ms={wall:.3f}; "
              "snapshot bitwise phase 8's host-tail sketch", flush=True)
        kpools = list(P.kddlike(SERVE_CLIENTS * SERVE_POOL, seed=1)
                      .reshape(SERVE_CLIENTS, SERVE_POOL, 38))
        for b in (1, 16, 32, 64, 128, 256):
            svc.assign(np.concatenate(kpools)[:b], timeout=60)
        serve_run(torch, engine, svc, kpools, "11c no ingest",
                  lambda: closed_loop(svc, kpools, SERVE_SECONDS))
        stop = threading.Event()
        rounds = []

        def reingest():
            while not stop.is_set():
                t0 = time.perf_counter()
                svc.submit_points(kdd_src)
                svc.drain(timeout=600)
                rounds.append(time.perf_counter() - t0)

        def drive():
            feed = threading.Thread(target=reingest, daemon=True)
            feed.start()
            try:
                return closed_loop(svc, kpools, SERVE_SECONDS)
            finally:
                stop.set()
                feed.join(timeout=600)
        serve_run(torch, engine, svc, kpools, "11c while the source is ingested again",
                  drive)
        print(f"11c re-ingest: {len(rounds)} passes over the source, "
              f"{[round(s, 3) for s in rounds]} s each", flush=True)
    return totals


# Phase 12: the mesh. 12a the fused path over the paper's m = 50 machines
# as a (50,) mesh, 12b hierarchical over (2, 5, 5); 12c the streamed path
# over phase 5's sources, S shards at a per-shard budget; 12d phase 7's
# objectives and phase 10's streamed EIM over 4 shards, and
# select_coreset(mesh=) on phase 7's in-memory input.
MESH_FUSED = [("12a", "unif", 1_000_000, 2, 25, (50,), ("data",), False),
              ("12a", "kddlike", 400_000, 38, 100, (50,), ("data",), False),
              ("12b", "kddlike", 400_000, 38, 100, (2, 5, 5),
               ("pod", "data", "model"), True)]    # axes: the mesh's, all sharded
MESH_STREAMED = [("unif", 10_000_000, 8, 64 * MiB, 25),    # phase 5's sources
                 ("kddlike", 4_000_000, 4, 256 * MiB, 25)]
MESH_SHARDS = 4                      # 12d's mesh
MESH_REFS = {}         # 12c's runs by (generator, S, budget, k), for phase 13
MESH_BUDGET = 256 * MiB              # 12d's per-shard budget
MESH_CORESET = (400_000, 100)        # 12d's select_coreset(mesh=): n, k


def mesh_run(torch, fn, counters, warm=True):
    """``fn`` once as a warm-up (where ``warm``), then counted and timed
    (``counted_run``, host clock around it, as phase 10 times its runs).
    Returns ``(result, launches, syncs, blocks uploaded, peak bytes, wall
    ms)``."""
    if warm:
        fn()
    t0 = time.perf_counter()
    res, launches, syncs, blocks, peak = counted_run(torch, fn, counters)
    wall = (time.perf_counter() - t0) * 1e3
    report_syncs(syncs)
    return res, launches, syncs, blocks, peak, wall


def same_mrg(a, b) -> bool:
    return (torch_equal(a.centers, b.centers)
            and a.radius2.item() == b.radius2.item() and a.rounds == b.rounds)


def phase_mesh(torch, engine, P, counters):
    print("== phase 12: the mesh (MeshExecutor, mrg_distributed, ShardedSource) "
          "on the card, impl='auto' against impl='ref' and HostStreamExecutor",
          flush=True)
    from repro_torch.core import (HostStreamExecutor, MeshExecutor, Objective,
                                  eim, gonzalez, kz_center, mrg, mrg_distributed,
                                  select_coreset)
    from repro_torch.data.source import (HostSource, WeightedSource, shard_source,
                                         synthetic_source)
    from repro_torch.launch import make_mesh
    totals = {name: 0 for name in counters}

    def tally(label, launches, path):
        for name in path:
            check(launches[name] > 0, f"{label}: kernel {name} never launched")
        for name, c in launches.items():
            totals[name] += c

    # -- 12a, 12b: the fused path --------------------------------------------
    for tag, gen, n, d, k, shape, axes, hier in MESH_FUSED:
        mesh = make_mesh(shape, axes)
        ex = MeshExecutor(mesh, shard_axes=axes, hierarchical=hier)
        x = P.GENERATORS[gen](n, d=d, seed=0)
        xt = cuda_t(torch, x)

        def fn(impl="auto", pts=xt):
            return mrg(pts, k, executor=ex, impl=impl)
        label = (f"{tag} mrg {gen} n={n} d={d} k={k} mesh={dict(mesh.shape)} "
                 f"shard_axes={axes} hierarchical={hier}")
        res, launches, syncs, _, _, wall = mesh_run(torch, fn, counters)
        check(not syncs, f"{label}: {len(syncs)} synchronising calls")
        levels = len(axes) if hier else 1
        check(res.rounds == 1 + levels, f"{label}: rounds {res.rounds}")
        check(launches["gon_step"] == k * (1 + levels) and launches["assign"] == 1,
              f"{label}: launches {launches} (expected {k * (1 + levels)} GON "
              "steps and one assign)")
        tally(label, launches, ("gon_step", "assign"))
        c, r2w = mrg_distributed(xt, k, mesh, shard_axes=axes, hierarchical=hier)
        check(torch.equal(c, res.centers) and r2w.item() == res.radius2.item(),
              f"{label}: mrg_distributed differs from MeshExecutor.mrg")
        ref = fn("ref")
        r2, r2_ref = res.radius2.item(), ref.radius2.item()
        check(np.isfinite(r2) and abs(r2 - r2_ref) <= 1e-4 * abs(r2_ref)
              and ref.rounds == res.rounds,
              f"{label}: radius2 {r2} vs ref {r2_ref} beyond rtol 1e-4")
        ratio = (r2 / gonzalez(xt, k).radius2.item()) ** 0.5
        check(ratio <= (8.0 if hier else 4.0), f"{label}: radius over GON's {ratio}")
        note = ""
        if not hier:      # the paper's m machines: SimExecutor(m) bitwise
            sim = mrg(xt, k, m=shape[0], capacity=shape[0] * k)
            check(same_mrg(res, sim), f"{label}: differs from SimExecutor(m={shape[0]})")
            note = f"sim_m{shape[0]}_bitwise=True "
        xe = cuda_t(torch, on_grid(x))
        check(same_mrg(fn(pts=xe), fn("ref", pts=xe)),
              f"{label}: the exact tier differs from impl='ref'")
        print(f"{label}: ok {note}exact_tier_bitwise_ref=True rounds={res.rounds} "
              f"radius2={r2!r} ref_radius2={r2_ref!r} radius_over_gon={ratio:.6f} "
              f"centers_differing_from_ref="
              f"{int((res.centers != ref.centers).any(dim=1).sum())} "
              f"wall_ms={wall:.3f} launches={launches} sync_warnings={len(syncs)}",
              flush=True)
        del xt, xe

    # -- 12c: the streamed path, bitwise HostStreamExecutor ------------------
    for gen, n, S, budget, k in MESH_STREAMED:
        src = (synthetic_source("unif", n, d=2, seed=0) if gen == "unif"
               else HostSource(kdd_host(P)))
        label = (f"12c mrg {gen} n={src.n} d={src.d} "
                 f"{'synthetic' if gen == 'unif' else 'host'}")
        ex = MeshExecutor(make_mesh((S,), ("data",)), memory_budget=budget)
        sh = shard_source(src, S)
        rows = ex.rows_for(sh)

        def fn(impl="auto"):
            return mrg(sh, k, executor=ex, impl=impl)
        res, launches, syncs, blocks, peak, wall = mesh_run(torch, fn, counters)
        label = f"{label} S={S} shard rows={rows}"
        check(not syncs, f"{label}: {len(syncs)} synchronising calls")
        steps = -(-sh.max_shard_rows // rows)
        gon_want = k * (steps + res.rounds - 1)
        check(launches["gon_step"] == gon_want,
              f"{label}: {launches['gon_step']} GON launches, not k x (steps + "
              f"levels) = {gon_want}")
        tally(label, launches, ("gon_step", "fused_filter"))
        union = S * steps * k
        allowed = S * budget + 2 * union * (4 * src.d + 1) + PEAK_SLACK
        check(peak <= allowed, f"{label}: peak device memory {peak} bytes above "
              f"the allowed {allowed}")
        host = mrg(sh, k, executor=HostStreamExecutor(block_rows=rows))
        check(same_mrg(res, host), f"{label}: differs from HostStreamExecutor "
              f"at block_rows={rows}")
        MESH_REFS[(gen, S, budget, k)] = (res, wall)
        ref = fn("ref")
        r2, r2_ref = res.radius2.item(), ref.radius2.item()
        check(torch.equal(res.centers, ref.centers) and res.rounds == ref.rounds
              and abs(r2 - r2_ref) <= 1e-4 * abs(r2_ref),
              f"{label}: differs from impl='ref' (radius2 {r2} vs {r2_ref})")
        print(f"{label}: ok host_stream_bitwise=True rounds={res.rounds} steps={steps} "
              f"radius2={r2!r} ref_radius2={r2_ref!r} wall_ms={wall:.3f} "
              f"launches={launches} sync_warnings={len(syncs)} "
              f"blocks_streamed={blocks} peak_MiB={peak / MiB:.2f} "
              f"allowed_MiB={allowed / MiB:.2f} budget_MiB_per_shard={budget / MiB}",
              flush=True)

    # -- 12d: the objectives, EIM and select_coreset on the mesh ------------
    mesh4 = make_mesh((MESH_SHARDS,), ("data",))
    ex = MeshExecutor(mesh4, memory_budget=MESH_BUDGET)
    xk, wk = planted_kdd(P, np.random.default_rng(12))
    shw = shard_source(WeightedSource(HostSource(xk), wk), MESH_SHARDS)
    rows = ex.rows_for(shw)
    host_ex = HostStreamExecutor(block_rows=rows)
    obj = Objective(weighted=True)
    for kind in ("weighted mrg", "kz_center"):
        if kind == "kz_center":
            def fn(e=ex):
                return kz_center(shw, 25, KZ_Z, executor=e)
            want_syncs, path = 1, ("gon_step", "assign_sums", "fused_filter_w")
        else:
            def fn(e=ex):
                return mrg(shw, 25, executor=e, objective=obj)
            want_syncs, path = 0, ("gon_step", "assign_sums", "fused_filter_w")
        label = (f"12d {kind} kddlike n={shw.n} d={shw.d} weighted, {KZ_Z} planted "
                 "outliers, "
                 f"S={MESH_SHARDS} at {MESH_BUDGET // MiB} MiB a shard, k=25")
        res, launches, syncs, blocks, peak, wall = mesh_run(torch, fn, counters)
        check(len(syncs) == want_syncs, f"{label}: {len(syncs)} synchronising calls")
        tally(label, launches, path)
        host = fn(host_ex)
        if kind == "kz_center":
            same = (torch.equal(res.centers, host.centers)
                    and res.radius2.item() == host.radius2.item()
                    and (res.coreset_size, res.rounds)
                    == (host.coreset_size, host.rounds))
            note = f"coreset_size={res.coreset_size} z={KZ_Z}"
        else:
            same = same_mrg(res, host) and torch.equal(res.weights, host.weights)
            note = f"weights_sum={res.weights.sum().item()!r}"
        check(same, f"{label}: differs from HostStreamExecutor at block_rows={rows}")
        print(f"{label}: ok host_stream_bitwise=True {note} rounds={res.rounds} "
              f"radius2={res.radius2.item()!r} wall_ms={wall:.3f} "
              f"launches={launches} sync_warnings={len(syncs)} "
              f"blocks_streamed={blocks} peak_MiB={peak / MiB:.2f}", flush=True)
    del shw, xk, wk

    kdd = HostSource(kdd_host(P))
    label = (f"12d eim kddlike n={kdd.n} d={kdd.d} host, S={MESH_SHARDS} at "
             f"{MESH_BUDGET // MiB} MiB a shard, k=25, key {EIM_KEY}")
    res, launches, syncs, blocks, peak, wall = mesh_run(
        torch, lambda: eim(kdd, 25, EIM_KEY, executor=ex), counters, warm=False)
    iters = int(res.sample.iters)
    check(len(syncs) == eim_syncs("streamed", iters),
          f"{label}: {len(syncs)} synchronising calls for {iters} iterations")
    tally(label, launches, ("fused_filter", "gon_step"))
    host = eim(kdd, 25, EIM_KEY, executor=HostStreamExecutor(memory_budget=MESH_BUDGET))
    check(same_eim(res, host), f"{label}: differs from HostStreamExecutor's eim")
    st = eim_stats(res, kdd.n, 25)
    print(f"{label}: ok host_stream_bitwise=True iterations={iters} |S|={st['S']} "
          f"|C|={st['C']} radius2={res.radius2.item()!r} wall_ms={wall:.3f} "
          f"launches={launches} sync_warnings={len(syncs)} blocks_streamed={blocks} "
          f"peak_MiB={peak / MiB:.2f}", flush=True)

    n, k = MESH_CORESET
    x = P.kddlike(n, seed=0)
    xt = cuda_t(torch, x)
    flat = make_mesh((50,), ("data",))

    def fn(impl="auto"):
        return select_coreset(xt, k, mesh=flat, impl=impl)
    label = f"12d select_coreset(mesh=) kddlike n={n} d=38 k={k} mesh=(50,)"
    res, launches, syncs, _, _, wall = mesh_run(torch, fn, counters)
    check(not syncs, f"{label}: {len(syncs)} synchronising calls")
    tally(label, launches, ("gon_step", "assign", "assign_sums", "argmin_rows"))
    check(launches["argmin_rows"] == 1, f"{label}: {launches['argmin_rows']} argmin "
          "launches (one expected)")
    check(int(res.weights.sum()) == n, f"{label}: counts sum to {int(res.weights.sum())}")
    ref = fn("ref")
    moved, ties, idiff = check_coreset(torch, engine, label, HostSource(x), 100_000,
                                       res, ref)
    print(f"{label}: ok representatives_differing={idiff} weight_rows_moved_vs_ref="
          f"{moved} near_tie_rows={ties} radius2={res.radius2.item()!r} "
          f"wall_ms={wall:.3f} launches={launches} sync_warnings={len(syncs)}",
          flush=True)
    return totals


# Phase 13: the paper's machines as separate processes. ``launch_cluster``
# starts the workers (gloo, every worker on cuda:0: NCCL refuses two ranks
# on one GPU); each builds the cluster mesh, reads only its own shards (a
# ProcessShardedSource over SliceSources of the common input) and runs the
# streamed path in its own CUDA context. 13a: 12c's unif generator over 2
# processes of 4 shards (S = 8, 64 MiB a shard), mrg k=25 and eim (key 1);
# 13b: kddlike n = 4e6 in one .npy file, memory-mapped by 4 processes of one
# shard (256 MiB a shard), mrg k=100. Every process's results are held
# bitwise against the one-process MeshExecutor run over the same shards.
CLUSTER_CASES = {
    "13a": dict(gen="unif", n=10_000_000, d=2, procs=2, spp=4,
                budget=64 * MiB, k=25, eim=True),
    "13b": dict(gen="kddlike", n=4_000_000, d=38, procs=4, spp=1,
                budget=256 * MiB, k=100, eim=False),
}
CLUSTER_TIMEOUT = 300.0      # each run's hard deadline, and its groups' timeout


class RowSpy:
    """A process's shard that counts the rows it reads: by blocks (the
    folds) and by ``take`` (the candidate exchange)."""

    def __init__(self, inner):
        self.inner = inner
        self.block_rows = 0
        self.take_rows = 0

    @property
    def n(self):
        return self.inner.n

    @property
    def d(self):
        return self.inner.d

    def host_blocks(self, rows):
        for blk in self.inner.host_blocks(rows):
            self.block_rows += blk.shape[0]
            yield blk

    def blocks(self, rows, *, prefetch=2, device=None):
        from repro_torch.data.source import stream_device
        return stream_device(self.host_blocks(rows), prefetch, device)

    def take(self, indices):
        idx = np.asarray(indices).reshape(-1)
        self.take_rows += idx.size
        return self.inner.take(idx)

    def row(self, idx):
        return self.take([idx])[0]


def kernel_counters():
    """Every kernel wrapper, by its name in the kernel line."""
    from repro_torch.kernels.assign import (assign_nearest_batched_cuda,
                                            assign_nearest_cuda, assign_sums_cuda)
    from repro_torch.kernels.fused_argfar import fused_min_argmax_cuda
    from repro_torch.kernels.fused_stream import (fused_argmin_cuda,
                                                  fused_assign_cuda,
                                                  fused_filter_cuda,
                                                  fused_filter_w_cuda)
    from repro_torch.kernels.pairwise import pairwise_dist2_cuda
    return {"gon_step": fused_min_argmax_cuda, "assign": assign_nearest_cuda,
            "fused_filter": fused_filter_cuda, "fused_assign": fused_assign_cuda,
            "assign_sums": assign_sums_cuda, "argmin_rows": fused_argmin_cuda,
            "fused_filter_w": fused_filter_w_cuda,
            "assign_batched": assign_nearest_batched_cuda,
            "pairwise": pairwise_dist2_cuda}


def cluster_split(n, shards):
    """``shard_source``'s split of n rows: the offsets of the shards."""
    per = -(-n // shards)
    return [min(i * per, n) for i in range(shards + 1)]


def cluster_worker(ctx) -> dict:
    """Phase 13's scenario, run by every worker process (``launch_cluster``
    loads it from this file): this process's shards of the case's input,
    ``mrg`` (and ``eim``) over the cluster mesh on its card, each run
    counted (launches, synchronising calls, peak device memory, rows read)
    and checked here. A failed check fails this worker, and so the run."""
    import torch

    from repro_torch import compat
    from repro_torch.core import HostStreamExecutor, MeshExecutor, eim, mrg
    from repro_torch.data.source import (HostSource, MemmapSource,
                                         ProcessShardedSource, SliceSource,
                                         synthetic_source)
    from repro_torch.launch import make_cluster_mesh
    # count the host exchanges: over gloo they move host tensors, over NCCL
    # each also reads its result back from the GPU (one more sync apiece)
    exchange, exchanges = compat.exchange_host, [0]

    def counted_exchange(x):
        exchanges[0] += 1
        return exchange(x)

    compat.exchange_host = counted_exchange
    per_exchange = int(ctx.backend == "nccl")
    case = CLUSTER_CASES[ctx.args["case"]]
    n, d, spp, k, budget = (case[key] for key in ("n", "d", "spp", "k", "budget"))
    pid, procs = ctx.process_id, ctx.num_processes
    check(procs == case["procs"], f"{procs} processes for {ctx.args['case']}")
    S = procs * spp
    offs = cluster_split(n, S)
    base = (synthetic_source("unif", n, d=d, seed=0) if case["gen"] == "unif"
            else MemmapSource(ctx.args["path"]))
    check((base.n, base.d) == (n, d), f"input {(base.n, base.d)}")
    mine = [RowSpy(SliceSource(base, offs[s], offs[s + 1]))
            for s in range(pid * spp, (pid + 1) * spp)]
    src = ProcessShardedSource.for_process(
        mine, [offs[i + 1] - offs[i] for i in range(S)], pid)
    mesh = make_cluster_mesh(shards_per_process=spp)   # this process's card
    dev = mesh.device
    check(dev.type == "cuda", f"process {pid} runs on {dev}")
    ex = MeshExecutor(mesh, memory_budget=budget)
    rows = ex.rows_for(src)
    steps = -(-src.max_shard_rows // rows)
    local_n = sum(s.n for s in mine)
    counters = kernel_counters()
    # this process's CUDA context and kernels come up on a small input first
    mrg(HostSource(np.random.default_rng(pid).random((4096, d), np.float32)), 3,
        executor=HostStreamExecutor(block_rows=1024, device=dev))
    out = {"device": torch.cuda.get_device_name(dev), "cuda": str(dev),
           "backend": ctx.backend,
           "local_shards": list(src.local_shard_ids),
           "remote_shards": S - len(src.local_shard_ids), "local_rows": local_n,
           "rows": rows, "steps": steps}
    exchanges[0] = 0
    t0 = time.perf_counter()
    res, launches, syncs, _, peak = counted_run(
        torch, lambda: mrg(src, k, executor=ex), counters)
    wall = (time.perf_counter() - t0) * 1e3
    report_syncs(syncs)
    moved = exchanges[0]
    union = S * steps * k
    allowed = spp * budget + 2 * union * (4 * d + 1) + PEAK_SLACK
    read = sum(s.block_rows for s in mine)
    label = f"{ctx.args['case']} process {pid} mrg"
    check(len(syncs) == 2 + per_exchange * moved,
          f"{label}: {len(syncs)} synchronising calls, not 2 (the union's read "
          f"and the radius's) + {per_exchange} for each of {moved} exchanges")
    check(launches["gon_step"] == k * (steps + res.rounds - 1)
          and launches["fused_filter"] > 0, f"{label}: launches {launches}")
    check(peak <= allowed, f"{label}: peak {peak} bytes above {allowed}")
    check(read == 2 * local_n and not any(s.take_rows for s in mine),
          f"{label}: read {read} rows of its {local_n} (round 1 and the radius "
          "read each once)")
    out["mrg"] = {"centers": res.centers.cpu().numpy().tolist(),
                  "radius2": res.radius2.item(), "rounds": res.rounds,
                  "wall_ms": wall, "launches": launches, "syncs": len(syncs),
                  "exchanges": moved, "peak_MiB": peak / MiB,
                  "allowed_MiB": allowed / MiB, "rows_read": read}
    if case["eim"]:
        for s in mine:
            s.block_rows = s.take_rows = 0
        exchanges[0] = 0
        t0 = time.perf_counter()
        res, launches, syncs, _, peak = counted_run(
            torch, lambda: eim(src, k, EIM_KEY, executor=ex), counters)
        wall = (time.perf_counter() - t0) * 1e3
        report_syncs(syncs)
        moved = exchanges[0]
        st = eim_stats(res, n, k)
        allowed = streamed_allowance(ex, src, k, st["C"], shards=spp)
        read = sum(s.block_rows for s in mine)
        label = f"{ctx.args['case']} process {pid} eim"
        check(len(syncs) == 2 * st["iters"] + 1 + per_exchange * moved,
              f"{label}: {len(syncs)} synchronising calls for {st['iters']} "
              "iterations (2 an iteration and the radius's read expected, + "
              f"{per_exchange} for each of {moved} exchanges)")
        check(launches["gon_step"] > 0 and launches["fused_filter"] > 0,
              f"{label}: launches {launches}")
        check(peak <= allowed, f"{label}: peak {peak} bytes above {allowed}")
        check(read == (st["iters"] + 1) * local_n,
              f"{label}: read {read} block rows of its {local_n} (each filter "
              "round and the radius read each once: no compaction)")
        out["eim"] = {"centers": res.centers.cpu().numpy().tolist(),
                      "radius2": res.radius2.item(),
                      "sample": digest(res.sample.sample_mask, res.sample.s_mask),
                      "stats": st, "wall_ms": wall, "launches": launches,
                      "syncs": len(syncs), "exchanges": moved,
                      "peak_MiB": peak / MiB,
                      "allowed_MiB": allowed / MiB, "rows_read": read,
                      "take_rows": sum(s.take_rows for s in mine)}
    out["jax_imported"] = "jax" in sys.modules
    check(not out["jax_imported"], f"process {pid} imported jax")
    return out


def same_centers(v, centers, radius2) -> bool:
    """A worker's centers and radius2 (JSON floats, exact for f32) bitwise the
    one-process run's."""
    return (np.array_equal(np.asarray(v["centers"], np.float32),
                           centers.cpu().numpy())
            and np.float32(v["radius2"]) == np.float32(radius2.item()))


def phase_cluster(torch, P, counters, backend="gloo"):
    """Phase 13 over ``backend``: gloo with every worker on the one card, or
    NCCL with a card a worker (``--cluster nccl``)."""
    where = ("every worker on the card" if backend == "gloo"
             else "a card a worker")
    print(f"== phase 13: the machines as separate processes (launch_cluster, "
          f"{backend}, {where}), each process's results against the "
          "one-process MeshExecutor over the same shards", flush=True)
    from repro_torch.core import MeshExecutor, eim, mrg
    from repro_torch.data.source import HostSource, shard_source, synthetic_source
    from repro_torch.launch import make_mesh, run_scenario
    totals = {name: 0 for name in counters}
    target = f"{os.path.abspath(__file__)}:cluster_worker"
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    torch.cuda.empty_cache()           # the workers share the card
    for tag, case in CLUSTER_CASES.items():
        n, d, k, procs, spp = (case[key] for key in ("n", "d", "k", "procs", "spp"))
        S = procs * spp
        ex = MeshExecutor(make_mesh((S,), ("data",)), memory_budget=case["budget"])
        label = (f"{tag} {case['gen']} n={n} d={d} k={k} P={procs} x {spp} "
                 f"shard(s) = S={S} at {case['budget'] // MiB} MiB a shard")
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            args = {"case": tag}
            if case["gen"] == "unif":
                sh = shard_source(synthetic_source("unif", n, d=d, seed=0), S)
            else:
                x = kdd_host(P)
                args["path"] = os.path.join(tmp, "kddlike.npy")
                t0 = time.perf_counter()
                np.save(args["path"], x)
                print(f"{tag}: the .npy written in "
                      f"{time.perf_counter() - t0:.2f} s", flush=True)
                sh = shard_source(HostSource(x), S)
            ref_key = (case["gen"], S, case["budget"], k)
            if ref_key in MESH_REFS:             # 12c's run, the same shards
                ref, ref_wall = MESH_REFS[ref_key]
            else:
                t0 = time.perf_counter()
                ref = mrg(sh, k, executor=ex)
                torch.cuda.synchronize()
                ref_wall = (time.perf_counter() - t0) * 1e3
            ref_eim = None
            if case["eim"]:
                t0 = time.perf_counter()
                ref_eim = eim(sh, k, EIM_KEY, executor=ex, compact_threshold=0)
                ref_eim_wall = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            verdicts = run_scenario(target, procs, args=args,
                                    timeout=CLUSTER_TIMEOUT, backend=backend)
            cluster_s = time.perf_counter() - t0
        if backend == "nccl":
            check(sorted(v["cuda"] for v in verdicts)
                  == [f"cuda:{i}" for i in range(procs)],
                  f"{label}: not one card a worker")
        for v in verdicts:
            m = v["mrg"]
            check(same_centers(m, ref.centers, ref.radius2)
                  and m["rounds"] == ref.rounds,
                  f"{label}: process {v['process_id']}'s mrg differs from the "
                  "one-process MeshExecutor's")
            line = {key: v[key] for key in ("process_id", "device", "cuda",
                                             "backend",
                                             "local_shards", "remote_shards",
                                             "local_rows", "rows", "steps",
                                             "jax_imported")}
            line["mrg"] = {key: m[key] for key in m if key != "centers"}
            for name, c in m["launches"].items():
                totals[name] += c
            if ref_eim is not None:
                e = v["eim"]
                check(same_centers(e, ref_eim.centers, ref_eim.radius2)
                      and e["sample"] == digest(ref_eim.sample.sample_mask,
                                                ref_eim.sample.s_mask)
                      and e["stats"] == eim_stats(ref_eim, n, k),
                      f"{label}: process {v['process_id']}'s eim differs from "
                      "the one-process MeshExecutor's")
                line["eim"] = {key: e[key] for key in e if key != "centers"}
                for name, c in e["launches"].items():
                    totals[name] += c
            print(f"{tag} worker: {json.dumps(line)}", flush=True)
        note = (f"one_process_mrg_wall_ms={ref_wall:.3f}" if ref_eim is None else
                f"one_process_mrg_wall_ms={ref_wall:.3f} "
                f"one_process_eim_wall_ms={ref_eim_wall:.3f} "
                f"eim_iterations={int(ref_eim.sample.iters)}")
        print(f"{label}: ok every process bitwise the one-process MeshExecutor "
              f"(centers, radius2, rounds{', EIM sample' if ref_eim is not None else ''}) "
              f"radius2={ref.radius2.item()!r} rounds={ref.rounds} {note} "
              f"cluster_seconds={cluster_s:.2f}", flush=True)
    return totals


# Phase 14: the dense LM at qwen2-0.5b's full width (configs/qwen2_0_5b.py
# full(), bf16; random weights from a seed: no checkpoint exists) — served by
# the continuous-batching Engine, and embedding a token corpus that
# select_coreset curates on kernels #1, #2s and #5 at d = 896.
LM_ARCH = "qwen2_0_5b"
LM_PARAMS = 494_032_768      # param_counts()["total"] + 2·24·896 + 896 norm scales
LM_F32_RTOL = 1e-3           # 14b: max |Δ logit| within 1e-3 of the largest |logit|
LM_PARITY = (2, 16)          # 14b: the card's forward against the CPU's, B x S
LM_PREFILL, LM_DECODE = 600, 8   # 14b: a prompt past the 512-query chunk, steps
LM_LOOP = (4, 16, 32)        # 14c: examples/serve_lm.py's B, prompt length, steps
LM_ENGINE = (8, 512, 32)     # 14c: slots, s_max, max_new
# 16 prompt lengths: every bucket from 8 to 256 occurs
LM_PROMPTS = (4, 7, 8, 9, 13, 16, 17, 30, 33, 60, 64, 65, 100, 128, 129, 200)
LM_CORPUS = (64, 64, 128)    # 14d: batches x sequences x tokens: 4,096 examples
LM_K = 64


def greedy_agree(torch, got, want, tol):
    """Whether the greedy tokens agree wherever ``want``'s top-2 margin
    exceeds twice ``tol``; with the count of such positions."""
    top = torch.topk(want, 2, dim=-1).values
    sure = (top[..., 0] - top[..., 1]) > 2 * tol
    same = got.argmax(-1) == want.argmax(-1)
    return bool(same[sure].all()), int(sure.sum()), int(same.numel())


def phase_lm(torch, engine, counters, results):
    print("== phase 14: the dense LM at qwen2-0.5b's full width: 14a build, "
          "14b f32 parity (card against CPU, prefill + decode against "
          "forward), 14c serving (the example's loop, the Engine), 14d "
          "curation (embed_batches, select_coreset on kernels #1, #2s, #5)",
          flush=True)
    from repro_torch import models
    from repro_torch.configs import get_config
    # bf16 products into bf16 keep f32 sums in cuBLAS's split-K too
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = get_config(LM_ARCH)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = models.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    norms = (2 * cfg.num_layers + 1) * cfg.d_model
    check(n == LM_PARAMS == cfg.param_counts()["total"] + norms,
          f"14a: {n} parameters, expected {LM_PARAMS}")
    print(f"14a {cfg.name} full() {cfg.param_dtype}: params={n} "
          f"(param_counts total {cfg.param_counts()['total']} + norm scales "
          f"{norms}) bytes={nbytes} build_seconds={build_s:.3f} "
          f"peak_bytes={torch.cuda.max_memory_allocated() - base}", flush=True)
    lm_parity(torch, cfg)
    lm_serve(torch, cfg, model)
    return lm_curation(torch, engine, cfg, model, counters, results)


def lm_parity(torch, cfg):
    """14b: f32 weights (the same architecture), TF32 off: the card's
    forward against the CPU's on the same weights; prefill past the chunk
    then decode steps against forward over the whole sequence."""
    from repro_torch import models
    from repro_torch.data import token_batch
    from repro_torch.models.lm import LM
    f32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    model = models.init_params(f32, seed=1)
    cpu = LM(f32, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    B, S = LM_PARITY
    toks = token_batch(f32.vocab_size, B, S, seed=1)["tokens"]
    t0 = time.perf_counter()
    want = models.forward(cpu, {"tokens": toks}, f32)[0]
    cpu_s = time.perf_counter() - t0
    got = models.forward(model, {"tokens": toks}, f32)[0].cpu()
    del cpu
    tol = LM_F32_RTOL * want.abs().max().item()
    err = (got - want).abs().max().item()
    agree, sure, total = greedy_agree(torch, got, want, tol)
    check(err <= tol, f"14b: the card's f32 forward is {err} from the CPU's "
          f"(tolerance {tol})")
    check(agree, "14b: greedy tokens differ from the CPU's beyond the margin")
    print(f"14b forward f32 B={B} S={S} card against CPU: ok max_abs_err={err:.3g} "
          f"tolerance={tol:.3g} (1e-3 of max|logit| {want.abs().max().item():.4g}) "
          f"greedy_equal_where_margin={sure}/{total} cpu_seconds={cpu_s:.2f}",
          flush=True)
    n = LM_PREFILL + LM_DECODE
    toks = token_batch(f32.vocab_size, 1, n, seed=2)["tokens"]
    full = models.forward(model, {"tokens": toks}, f32)[0][0, LM_PREFILL - 1:]
    last, cache = models.prefill(model, {"tokens": toks[:, :LM_PREFILL]}, f32, n)
    steps = [last[0, 0]]
    for i in range(LM_DECODE):
        logits, cache = models.decode_step(
            model, cache, toks[:, LM_PREFILL + i:LM_PREFILL + i + 1], f32)
        steps.append(logits[0, 0])
    steps = torch.stack(steps)
    tol = LM_F32_RTOL * full.abs().max().item()
    errs = (steps - full).abs().amax(-1).tolist()
    agree, sure, total = greedy_agree(torch, steps, full, tol)
    check(max(errs) <= tol, f"14b: decode logits {max(errs)} from forward's "
          f"(tolerance {tol})")
    check(agree, "14b: greedy tokens of decode differ from forward's beyond "
          "the margin")
    check(int(cache["pos"][0]) == n, "14b: the cache's position")
    print(f"14b prefill {LM_PREFILL} tokens (chunked attend, queries padded "
          f"to 1024) + {LM_DECODE} decode steps f32 against forward over {n}: "
          f"ok max_abs_err_by_position={[float(f'{e:.3g}') for e in errs]} "
          f"tolerance={tol:.3g} greedy_equal_where_margin={sure}/{total}",
          flush=True)
    del model, cache
    torch.cuda.empty_cache()


def lm_serve(torch, cfg, model):
    """14c: examples/serve_lm.py's loop (a batch prefilled, then greedy
    decode steps), then the Engine over 16 mixed requests, twice from the
    same seed."""
    from repro_torch import models
    from repro_torch.data import model_batch
    B, plen, steps = LM_LOOP
    batch = model_batch(cfg, B, plen)

    def loop():
        logits, cache = models.prefill(model, batch, cfg, plen + steps)
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        out = [tok]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = models.decode_step(model, cache, tok, cfg)
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            out.append(tok)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, torch.cat(out, 1)
    loop()                                    # warm-up
    wall, seq = loop()
    check(bool(((seq >= 0) & (seq < cfg.vocab_size)).all()),
          "14c: a token outside the vocabulary")
    print(f"14c serve_lm loop B={B} prompt={plen} {steps} greedy decode steps: "
          f"ok tokens_per_s={B * steps / wall:.1f} ms_per_step="
          f"{wall / steps * 1e3:.3f}", flush=True)
    logits, cache = models.prefill(model, batch, cfg, plen + steps)
    tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)

    def decode(n=8):
        nonlocal cache
        for _ in range(n):
            _, cache = models.decode_step(model, cache, tok, cfg)
    lm_profile(torch, "14c decode_step B=4 (8 steps)", decode, 8)

    engine_runs(torch, cfg, model, "14c")


def engine_runs(torch, cfg, model, label):
    """The Engine over LM_PROMPTS' 16 mixed requests (LM_ENGINE: 8 slots,
    s_max 512, 32 new tokens each; odd uids stochastic, uid 1 top-p), run
    twice from the same seed: every request its tokens in the vocabulary,
    synchronising calls exactly one a step and one an admission, the same
    tokens both runs. Returns the second run's engine."""
    from repro_torch.data import token_batch
    from repro_torch.serve import Engine, Request
    slots, s_max, max_new = LM_ENGINE
    prompts = [token_batch(cfg.vocab_size, 1, n, seed=3, step=i)["tokens"][0]
               for i, n in enumerate(LM_PROMPTS)]

    def serve():
        eng = Engine(model, cfg, slots=slots, s_max=s_max)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, tokens=p, max_new=max_new,
                               temperature=0.7 if i % 2 else 0.0,
                               top_k=40 if i % 2 else 0,
                               top_p=0.9 if i == 1 else 1.0))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        n_steps = 0
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            while eng.pending or eng.alive.any():
                eng.step()
                n_steps += 1
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return (eng, n_steps, wall, sync_warnings(caught),
                torch.cuda.max_memory_allocated() - base)
    runs = []
    for run in ("first", "second"):
        eng, n_steps, wall, syncs, peak = serve()
        outs = {r.uid: r.out for r in eng.done}
        line = f"{label} Engine(slots={slots}, s_max={s_max}) {run} run"
        check(sorted(outs) == list(range(len(prompts))), f"{line}: requests lost")
        check(all(len(o) == max_new and all(0 <= t < cfg.vocab_size for t in o)
                  for o in outs.values()),
              f"{line}: a request without {max_new} tokens in the vocabulary")
        predicted = n_steps + len(prompts)    # one a step, one an admission
        if len(syncs) != predicted or eng.reads != predicted:
            report_syncs(syncs)
        check(len(syncs) == eng.reads == predicted,
              f"{line}: {len(syncs)} synchronising calls, {eng.reads} reads, "
              f"{predicted} predicted")
        ttft = np.array([r.t_first - r.t_submit for r in eng.done]) * 1e3
        buckets = sorted({eng._bucket(len(p)) for p in prompts})
        print(f"{line}: ok requests={len(outs)} tokens={len(outs) * max_new} "
              f"buckets={buckets} steps={n_steps} wall_s={wall:.3f} "
              f"tokens_per_s={len(outs) * max_new / wall:.1f} "
              f"ttft_mean_ms={ttft.mean():.2f} ttft_p99_ms="
              f"{np.percentile(ttft, 99):.2f} sync_warnings={len(syncs)} "
              f"(= steps + admissions) syncs_per_step="
              f"{(len(syncs) - len(prompts)) / n_steps:.3f} peak_bytes={peak}",
              flush=True)
        runs.append(outs)
    check(runs[0] == runs[1], f"{label}: a second run from the same seed gave "
          "other tokens")
    print(f"{label}: the second run's tokens equal the first's (greedy and "
          "stochastic, PRNGKey(0))", flush=True)
    return eng


def lm_profile(torch, label, fn, calls):
    """One profiled run of ``fn`` (``calls`` model calls): wall, device
    busy time and idle share, kernels a call, the largest kernels."""
    prof = device_profile(torch, fn)
    check(prof is not None, f"{label}: the profiler recorded no device time")
    wall, busy, launches, copy_ms, copies, by_name = prof
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    print(f"{label} profile: wall_ms={wall:.3f} device_busy_ms={busy:.3f} "
          f"idle_share={1 - busy / wall:.4f} kernels_per_call={launches / calls:.1f} "
          f"copies={copies} ({copy_ms:.3f} ms) top="
          f"{[(name[:60], round(ms, 3), count) for name, (ms, count) in top]}",
          flush=True)


def lm_curation(torch, engine, cfg, model, counters, results):
    """14d: the corpus embedded by bf16 forward(return_hidden=True), mean
    pooled in f32; select_coreset in memory against impl="ref"; kernels
    #1, #2s and #5 alone at its shape against their plain versions.
    Returns select_coreset's launches."""
    from repro_torch import models
    from repro_torch.core import embed_batches, select_coreset
    from repro_torch.data import token_batch
    from repro_torch.data.source import HostSource
    nb, b, s = LM_CORPUS
    batches = [token_batch(cfg.vocab_size, b, s, seed=0, step=i)["tokens"]
               for i in range(nb)]

    def apply(tb):
        return models.forward(model, {"tokens": tb}, cfg,
                              return_hidden=True)[0].float()
    embed_batches(apply, batches[:1])                       # warm-up
    lm_profile(torch, f"14d forward(return_hidden=True) {b}x{s}",
               lambda: embed_batches(apply, batches[:1]), 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb = embed_batches(apply, batches)
    torch.cuda.synchronize()
    embed_ms = (time.perf_counter() - t0) * 1e3
    n, d = nb * b, cfg.d_model
    check(tuple(emb.shape) == (n, d) and emb.dtype == torch.float32
          and bool(torch.isfinite(emb).all()), "14d: embeddings not finite "
          f"f32 ({n}, {d})")

    def fn(impl="auto"):
        return select_coreset(emb, LM_K, impl=impl)
    fn()                                                    # warm-up
    res, launches, syncs, _, peak = counted_run(torch, fn, counters)
    walls = wall_ms(torch, fn)
    ref = fn("ref")
    torch.cuda.synchronize()
    label = f"14d select_coreset n={n} d={d} k={LM_K} (LM embeddings)"
    for name in ("gon_step", "assign_sums", "argmin_rows"):
        check(launches[name] > 0, f"{label}: kernel {name} never launched")
    check(int(res.weights.sum()) == n, f"{label}: counts sum to "
          f"{int(res.weights.sum())}")
    moved, ties, idiff = check_coreset(torch, engine, label,
                                       HostSource(emb.cpu().numpy()), n, res, ref)
    print(f"{label}: ok centers_equal_to_ref=True representatives_differing="
          f"{idiff} weight_rows_moved_vs_ref={moved} near_tie_rows={ties} "
          f"radius2={res.radius2.item()!r} embed_wall_ms={embed_ms:.3f} "
          f"({n} sequences x {s} tokens, {cfg.compute_dtype}) select_coreset_wall_ms="
          f"{[round(w, 3) for w in walls]} launches="
          f"{ {k: v for k, v in launches.items() if v} } "
          f"sync_warnings={len(syncs)} peak_bytes={peak}", flush=True)
    lm_kernels(torch, engine, emb, res.centers, results)
    return launches


def lm_kernels(torch, engine, x, c, results):
    """Kernels #1, #2s and #5 alone at the curation's shape (1 x n x d, k
    centers), against their plain versions, with times, bounds and the
    library's time where one PyTorch call computes the same."""
    from repro_torch.kernels.fused_stream import argmin_carry, fused_argmin_cuda
    n, d = x.shape
    k = c.shape[0]
    shape = f"{n}x{d} k={k}"
    # 1: the GON step from the distances to center row 0, the next center row 1
    x3 = x[None]
    md = engine.fused_min_argmax(x3, x3[:, 0], torch.full(
        (1, n), 3.4e38, device=x.device), impl="ref")[0].clone()
    got, want = gon_step_pair(torch, engine, x3, x3[:, 1], md)
    torch.cuda.synchronize()
    err = (got[0] - want[0]).abs().max().item()
    check(torch.allclose(got[0], want[0], **GON_TOL)
          and torch.allclose(got[1], want[1], **GON_TOL),
          f"14d gon_step {shape}: beyond rtol 1e-5 (max err {err})")
    top = torch.topk(want[0], 2, dim=1).values
    if bool(((top[:, 0] - top[:, 1]) > 1e-5 * top[:, 0].abs()).all()):
        check(torch.equal(got[2], want[2]), f"14d gon_step {shape}: far index")
    ws = engine.gon_workspace(1, x3, impl="kernel")
    centers = torch.zeros((1, 2, d), device=x.device)
    indices = torch.zeros((1, 2), dtype=torch.int32, device=x.device)
    ct = x3[:, 1]
    ms = device_ms(torch, lambda: engine.fused_min_argmax(
        x3, ct, md, impl="kernel", ws=ws, centers=centers, indices=indices, slot=1))
    plain = device_ms(torch, lambda: engine.fused_min_argmax(
        x3, ct, md, impl="ref", centers=centers, indices=indices, slot=1))
    b_ms, b_by = bound(4 * (n * d + d + 2 * n + 2), n * (3 * d + 2))
    lm_result(results, "gon_step", (1, n, d, "lm"), err, ms, plain, b_ms, b_by, None)
    # 2s: the cluster counts of select_coreset in memory
    outs = [engine.assign_sums(x, c, torch.zeros((k,), dtype=torch.int32,
                                                 device=x.device), impl=impl)
            for impl in ("kernel", "ref")]
    torch.cuda.synchronize()
    tol = dist2_tol(x, c)
    two = torch.topk(engine.ref.pairwise_dist2(x, c), 2, dim=-1, largest=False).values
    ties = int(((two[:, 1] - two[:, 0]) <= 2 * tol).sum())
    err = (outs[0] - outs[1]).abs().max().item()
    check(int(outs[0].sum()) == n and err <= ties,
          f"14d assign_sums {shape}: counts differ beyond the {ties} near ties")
    sums = torch.zeros((k,), dtype=torch.int32, device=x.device)
    ms = device_ms(torch, lambda: engine.assign_sums(x, c, sums, impl="kernel"))
    plain = device_ms(torch, lambda: engine.assign_sums(x, c, sums, impl="ref"))
    b_ms, b_by = bound(4 * (n * d + k * d + k), n * k * (2 * d + 5) + 2 * d * (n + k))
    lm_result(results, "assign_sums", (n, k, d, "lm"), err, ms, plain, b_ms, b_by,
              None, f"near_tie_rows={ties}")
    # 5: each center's nearest row (its representative)
    got = engine.fused_argmin(x, c, impl="kernel")
    want = engine.fused_argmin(x, c, impl="ref")
    torch.cuda.synchronize()
    err = (got[0] - want[0]).abs().max().item()
    tol = dist2_tol(c, x[want[1].long()])
    check(bool(((got[0] - want[0]).abs() <= tol).all()),
          f"14d argmin_rows {shape}: d2 beyond tolerance ({err})")
    two = torch.topk(engine.ref.pairwise_dist2(c, x), 2, dim=1, largest=False).values
    unique = (two[:, 1] - two[:, 0]) > 2 * tol
    check(torch.equal(got[1][unique], want[1][unique]),
          f"14d argmin_rows {shape}: row differs where unique")
    fresh = iter([argmin_carry(k, x.device) for _ in range(23)])
    ms = device_ms(torch, lambda: fused_argmin_cuda(x, c, next(fresh)))
    plain = device_ms(torch, lambda: engine.fused_argmin(x, c, impl="ref"), reps=5)
    lib = device_ms(torch, lambda: torch.cdist(c, x).min(1), reps=5)
    b_ms, b_by = bound(4 * (n * d + k * d) + 16 * k,
                       n * k * (2 * d + 5) + 2 * d * (n + k))
    lm_result(results, "argmin_rows", (n, k, d, "lm"), err, ms, plain, b_ms, b_by,
              lib, "library: torch.cdist(c, x).min(1)")


def lm_result(results, name, shape, err, ms, plain, b_ms, b_by, lib, note=""):
    print(f"14d kernel {name} {'x'.join(map(str, shape[:3]))}: ok "
          f"max_abs_err={err:.3g} kernel_ms={ms:.5f} plain_ms={plain:.5f} "
          f"library_ms={fmt(lib)} bound_ms={b_ms:.5f} ({b_by}) {note}", flush=True)
    results.append(dict(kernel=name, shape=shape, tier="float", err=err, ms=ms,
                        plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                        library_ms=lib))


# Phase 15: every other LM family at full width (configs/*.py full(), bf16;
# random weights from a seed): qwen2-vl-2b (vlm, M-RoPE), mamba2-370m (ssm),
# hymba-1.5b (hybrid: 25 query heads over 5 KV heads, a 1,024 window on all
# but layers 0, 8, 16, 24), dbrx-132b (moe, 16 experts top-4) and
# whisper-large-v3 (encdec), one model at a time. dbrx keeps its widths and
# is cut to 2 of its 40 layers: its experts alone are ~254 GB in bf16 at 40
# layers, past one 80 GB card (2 layers: ~15.5 GB). kimi-k2 (~2 TB; one
# layer's 384 experts ~34 GB) waits for the port of sharding/ (ROADMAP.md).
FAMILIES = (("qwen2_vl_2b", None), ("mamba2_370m", None), ("hymba_1_5b", None),
            ("dbrx_132b", 2), ("whisper_large_v3", None))
FAM_PARITY = (2, 16)         # 15b: B x S at depth 1 (vlm: + its 256 patches)
FAM_PROMPT = 600             # 15c: past the 512-query chunk, not a multiple
#                              of SSD's chunk of 256
FAM_PROMPTS = {"hybrid": 1100}       # past hymba's window of 1,024
FAM_DECODE = 8
FAM_BF16_RTOL = 5e-2         # 15c: bf16 rounds to 2^-8 relative, and the two
#                              paths' products round apart (other kernels)
FAM_BF16_RTOL_SSM = 0.15     # 15c mamba2: its sequence path rounds each of
#                              the conv's products and sums in bf16, the step
#                              path once, over 48 layers; at smoke width and
#                              full depth the JAX package's own steps drift
#                              0.37 of max|logit| from its forward and the
#                              port's 0.28 (tests/test_torch_lm_families.py::
#                              test_bf16_ssm_decode_drift); on an H100 (700 W)
#                              at full width 0.113
MOE_TIE = 1e-3               # 15b: K-th and (K+1)-th router probabilities
#                              within this of each other (relative): the
#                              card may pick either expert
ENCDEC_LOOP = (4, 16, 32)    # 15d whisper: B, prompt tokens, decode steps


class MoESpy:
    """Wraps ``layers._moe_route`` while in use: keeps each call's router
    probabilities and expert choices, sorted (``keep=True``), and counts
    its dropped assignments (one read at the end). ``hit`` fails unless the
    wrapper saw each MoE layer of the passes run under it."""

    def __init__(self, torch, keep=False):
        from repro_torch.models import layers
        self.torch, self.layers, self.keep = torch, layers, keep
        self.route = layers._moe_route
        self.probs, self.choices, self.dropped = [], [], []

    def __enter__(self):
        def spy(xf, router, cfg, capacity_factor):
            out = self.route(xf, router, cfg, capacity_factor)
            if self.keep:
                self.probs.append(out[0])
                self.choices.append(out[2].sort(-1).values)
            self.dropped.append((out[4] >= out[-1]).sum())
            return out
        self.layers._moe_route = spy
        return self

    def __exit__(self, *exc):
        self.layers._moe_route = self.route

    def drops(self) -> int:
        return int(sum(self.dropped)) if self.dropped else 0

    def hit(self, cfg, passes, what):
        if cfg.family == "moe":
            check(len(self.dropped) == passes * cfg.num_layers, f"{what}: the "
                  f"router was seen {len(self.dropped)} times, expected "
                  f"{passes} passes x {cfg.num_layers} layers")


class DropFree:
    """``layers.apply_moe`` at capacity factor E/K while in use: C = N·K/E ·
    E/K = N, so no expert queue overflows (decode is drop-free by its floor
    of min(64, N·K)); forward and prefill then compute what decode does.
    ``calls`` counts the MoE layers run under it."""

    def __init__(self, cfg):
        from repro_torch.models import layers
        self.layers, self.cfg = layers, cfg
        self.apply = layers.apply_moe
        self.calls = 0

    def __enter__(self):
        if self.cfg.family == "moe":
            cf = self.cfg.num_experts / self.cfg.top_k

            def drop_free(*args, **kw):
                self.calls += 1
                return self.apply(*args, **dict(kw, capacity_factor=cf))
            self.layers.apply_moe = drop_free
        return self

    def __exit__(self, *exc):
        self.layers.apply_moe = self.apply


def phase_families(torch):
    print("== phase 15: every other LM family at full width: qwen2-vl-2b, "
          "mamba2-370m, hymba-1.5b, dbrx-132b (2 of 40 layers), "
          "whisper-large-v3 — 15a build, 15b f32 parity at depth 1 (card "
          "against CPU), 15c prefill + decode against forward at full depth "
          "(f32, then bf16), 15d serving (the Engine; whisper: prefill + "
          "decode through models.api)", flush=True)
    from repro_torch import models
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    for arch, layers in FAMILIES:
        cfg = get_config(arch)
        if layers:
            print(f"15 {cfg.name}: reduced num_layers {cfg.num_layers} -> "
                  f"{layers} (every width as published)", flush=True)
            cfg = cfg.replace(num_layers=layers)
        fam_parity(torch, cfg)
        f32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
        model = models.init_params(f32, seed=1)
        fam_decode(torch, f32, model, LM_F32_RTOL)
        del model
        torch.cuda.empty_cache()
        model = fam_build(torch, cfg)
        fam_decode(torch, cfg, model, FAM_BF16_RTOL_SSM
                   if cfg.family == "ssm" else FAM_BF16_RTOL)
        if cfg.family == "encdec":
            fam_encdec_loop(torch, cfg, model)
        else:
            eng = engine_runs(torch, cfg, model, f"15d {cfg.name}")
            toks = torch.zeros((eng.B, 1), dtype=torch.int32, device=model.device)
            cache = eng.cache

            def decode(n=4):
                nonlocal cache
                for _ in range(n):
                    _, cache = models.decode_step(model, cache, toks, cfg)
            decode(1)
            lm_profile(torch, f"15d {cfg.name} decode_step B={eng.B} "
                       f"s_max={eng.S} (4 steps)", decode, 4)
            del eng, cache
        del model
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    print(f"phase 15 seconds={time.perf_counter() - t0:.1f}", flush=True)


def fam_build(torch, cfg):
    """15a: the bf16 model on the card; its parameter count against
    param_counts() and the extra scales."""
    from repro_torch import models
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = models.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    total, extra = cfg.param_counts()["total"], models.extra_params(cfg)
    check(n == total + extra, f"15a {cfg.name}: {n} parameters, expected "
          f"{total} + {extra}")
    print(f"15a {cfg.name} {cfg.family} {cfg.param_dtype} layers={cfg.num_layers}"
          f"{f'+{cfg.enc_layers} encoder' if cfg.enc_layers else ''}: ok "
          f"params={n} (param_counts total {total} + extra scales {extra}) "
          f"bytes={nbytes} build_seconds={build_s:.3f} "
          f"peak_bytes={torch.cuda.max_memory_allocated() - base}", flush=True)
    return model


def fam_parity(torch, cfg):
    """15b: the architecture at depth 1 in f32 (TF32 off): forward on the
    card against forward on the CPU, same weights and inputs."""
    from repro_torch.data import model_batch
    from repro_torch.models import EncDec, LM
    from repro_torch import models
    one = dict(num_layers=1, param_dtype="float32", compute_dtype="float32")
    if cfg.family == "encdec":
        one["enc_layers"] = 1
    f32 = cfg.replace(**one)
    model = models.init_params(f32, seed=1)
    cpu = (EncDec if f32.family == "encdec" else LM)(f32, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()},
                        assign=True)
    B, S = FAM_PARITY
    if f32.family == "vlm":
        S += f32.num_patches                  # patch and text positions
    batch = model_batch(f32, B, S, seed=1)
    t0 = time.perf_counter()
    with MoESpy(torch, keep=True) as spy:
        want = models.forward(cpu, batch, f32)[0]
    cpu_s = time.perf_counter() - t0
    spy.hit(f32, 1, f"15b {f32.name}")
    got = models.forward(model, batch, f32)[0].cpu()
    del cpu, model
    torch.cuda.empty_cache()
    keep = torch.ones((B, S), dtype=torch.bool)
    if spy.probs:
        K = f32.top_k
        top = torch.topk(spy.probs[0], K + 1, dim=-1).values
        keep = ~((top[:, K - 1] - top[:, K]) <= MOE_TIE * top[:, K - 1]).reshape(B, S)
    tol = LM_F32_RTOL * want.abs().max().item()
    err = (got - want).abs()[keep].max().item()
    agree, sure, total = greedy_agree(torch, got[keep], want[keep], tol)
    shape = " ".join(f"{k}={tuple(v.shape)}" for k, v in batch.items())
    check(err <= tol, f"15b {f32.name}: the card's f32 forward is {err} from "
          f"the CPU's (tolerance {tol})")
    check(agree, f"15b {f32.name}: greedy tokens differ from the CPU's beyond "
          "the margin")
    print(f"15b {f32.name} f32 depth 1 {shape}: card against CPU ok "
          f"max_abs_err={err:.3g} tolerance={tol:.3g} (1e-3 of max|logit| "
          f"{want.abs().max().item():.4g}) greedy_equal_where_margin={sure}/"
          f"{total} router_near_ties_left_out={int((~keep).sum())} "
          f"moe_drops={spy.drops()} cpu_seconds={cpu_s:.2f}", flush=True)


def fam_decode(torch, cfg, model, rtol):
    """15c: prefill past the chunk (and hymba's window), then decode steps,
    against forward over the whole sequence (MoE: at a drop-free capacity,
    with forward's drops at the default capacity counted). The prefill's
    last logits and the decode steps are held within ``rtol`` of the
    largest |logit|; greedy tokens equal wherever the top-2 margin exceeds
    twice that. A MoE position whose token the
    step (or the prefill) sent to other experts than forward did, in any
    layer (a near-tie of the router that rounding flipped), is left out
    and counted."""
    from repro_torch import models
    from repro_torch.data import model_batch
    n = FAM_PROMPTS.get(cfg.family, FAM_PROMPT)
    total = n + FAM_DECODE
    batch = model_batch(cfg, 1, total, seed=2)
    pre = dict(batch, tokens=batch["tokens"][:, :n])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with MoESpy(torch) as spy:
        models.forward(model, batch, cfg)
    drops = spy.drops()
    spy.hit(cfg, 1, f"15c {cfg.name} forward")
    t0 = time.perf_counter()
    with DropFree(cfg) as free, MoESpy(torch, keep=True) as fwd:
        full = models.forward(model, batch, cfg)[0][0, n - 1:]
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with DropFree(cfg) as dec_free, MoESpy(torch, keep=True) as dec:
        last, cache = models.prefill(model, pre, cfg, total)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        steps = [last[0, 0]]
        for i in range(FAM_DECODE):
            logits, cache = models.decode_step(
                model, cache, batch["tokens"][:, n + i:n + i + 1], cfg)
            steps.append(logits[0, 0])
    steps = torch.stack(steps)
    for spied, dropfree, passes, what in ((fwd, free, 1, "forward"),
                                          (dec, dec_free, 1 + FAM_DECODE,
                                           "prefill and steps")):
        spied.hit(cfg, passes, f"15c {cfg.name} drop-free {what}")
        if cfg.family == "moe":
            check(dropfree.calls == passes * cfg.num_layers and spied.drops() == 0,
                  f"15c {cfg.name}: the drop-free {what} ran {dropfree.calls} "
                  f"MoE layers and dropped {spied.drops()} assignments")
    tol = rtol * full.abs().max().item()
    errs = (steps - full).abs().amax(-1).tolist()
    keep = list(range(len(errs)))
    flipped = []
    if fwd.choices:           # per layer: forward's, then the prefill's and each step's
        Lh = cfg.num_layers
        for j in list(keep):
            mine = dec.choices[j * Lh:(j + 1) * Lh]
            if any(not torch.equal(m[-1], f[n - 1 + j]) for m, f in zip(mine, fwd.choices)):
                keep.remove(j)
                flipped.append(j)
    held = [errs[j] for j in keep]
    agree, sure, count = greedy_agree(torch, steps[keep], full[keep], tol)
    extra = (f" moe_drops_at_cf_1.25={drops} (compared at cf "
             f"{cfg.num_experts / cfg.top_k:g}: drop-free) routing_flipped_"
             f"positions_left_out={flipped}" if cfg.family == "moe" else "")
    print(f"15c {cfg.name} {cfg.compute_dtype} prefill {n} tokens + {FAM_DECODE} "
          f"decode steps against forward over {total}: max_abs_err_by_position="
          f"{[float(f'{e:.3g}') for e in errs]} tolerance={tol:.3g} ({rtol:g} of "
          f"max|logit| {full.abs().max().item():.4g}) "
          f"greedy_equal_where_margin={sure}/{count} forward_s={fwd_s:.3f} "
          f"prefill_s={pre_s:.3f} peak_bytes="
          f"{torch.cuda.max_memory_allocated() - base}{extra}", flush=True)
    check(bool(torch.isfinite(steps).all()), f"15c {cfg.name}: non-finite logits")
    check(len(held) > len(errs) // 2, f"15c {cfg.name}: most positions left out")
    check(max(held) <= tol, f"15c {cfg.name} {cfg.compute_dtype}: logits "
          f"{max(held)} from forward's (tolerance {tol})")
    check(agree, f"15c {cfg.name} {cfg.compute_dtype}: greedy tokens differ "
          "from forward's beyond the margin")
    check(int(cache["pos"][0]) == total, f"15c {cfg.name}: the cache's position")
    del cache


def fam_encdec_loop(torch, cfg, model):
    """15d whisper: a batch of frames prefilled (the encoder, the cross
    caches), then greedy decode steps through models.api, twice: the same
    tokens; no synchronising call inside the decode loop."""
    from repro_torch.data import model_batch
    from repro_torch import models
    B, plen, steps = ENCDEC_LOOP
    batch = model_batch(cfg, B, plen)

    def loop():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, cache = models.prefill(model, batch, cfg, plen + steps)
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = [tok]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            for _ in range(steps):
                logits, cache = models.decode_step(model, cache, tok, cfg)
                tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
                out.append(tok)
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return (t1 - t0, t2 - t1, torch.cat(out, 1), sync_warnings(caught),
                torch.cuda.max_memory_allocated() - base, cache)
    runs = []
    for run in ("first", "second"):
        pre_s, wall, seq, syncs, peak, cache = loop()
        check(bool(((seq >= 0) & (seq < cfg.vocab_size)).all()),
              f"15d {cfg.name}: a token outside the vocabulary")
        if syncs:
            report_syncs(syncs)
        check(not syncs, f"15d {cfg.name}: {len(syncs)} synchronising calls in "
              "the decode loop")
        print(f"15d {cfg.name} {run} run: B={B} frames={tuple(batch['frames'].shape)} "
              f"prompt={plen} prefill_ms={pre_s * 1e3:.3f} {steps} greedy decode "
              f"steps: ok tokens_per_s={B * steps / wall:.1f} ms_per_step="
              f"{wall / steps * 1e3:.3f} sync_warnings=0 peak_bytes={peak}",
              flush=True)
        runs.append(seq)
    check(torch.equal(runs[0], runs[1]), f"15d {cfg.name}: a second run gave "
          "other tokens")
    tok = runs[1][:, -1:].contiguous()

    def decode(n=4):
        nonlocal cache
        for _ in range(n):
            _, cache = models.decode_step(model, cache, tok, cfg)
    lm_profile(torch, f"15d {cfg.name} decode_step B={B} (4 steps)", decode, 4)


# Phase 16: LM training on the card (repro_torch.optim, .train, .checkpoint,
# .launch.train; random weights from a seed). 16b trains one config a
# family through train_loop, each as its config has it (remat "full";
# minicpm's WSD schedule, as configs.schedule_for names it; dbrx Adafactor, 2 microbatches, a bf16
# accumulator). dbrx keeps its widths at 1 of its 40 layers: ~9 GB of bf16
# weights, as much again in gradients and in the accumulator, ~4.2 GB an
# f32 temporary of its largest expert leaf; 40 layers are past one card.
TRAIN_PARITY = (("qwen2_0_5b", 2, 2, 64), ("mamba2_370m", 2, 2, 256),
                ("dbrx_132b", 1, 2, 64))  # 16a: arch, layers, B, S, in f32
#                              mamba2: one SSD chunk of 256; dbrx: Adafactor,
#                              2 microbatches, its bf16 accumulator (in bf16
#                              its routing flips on rounding: near ties)
TRAIN_PARITY_LR = 1e-3
TRAIN_LOSS_RTOL = 1e-5       # 16a: the loss, relative
TRAIN_GRAD_RTOL = 1e-3       # 16a: each gradient leaf within 1e-3 of its
#                              largest |g|, plus one rounding step where the
#                              gradient is bf16 (dbrx's accumulator); a leaf
#                              below 1e-3 of the model's largest, such as the
#                              key bias's, 0 in exact arithmetic, within 1e-6
#                              of the model's largest
TRAIN_ELEM_RTOL = 5e-4       # 16a: a gradient element is resolved where the
#                              card's is within 5e-4 of the CPU's, relative
#                              (both 0 included); AdamW's delta g / (|g| +
#                              1e-8), or Adafactor's u, then differs by 5e-4
#                              of itself at most
TRAIN_PARAM_ATOL = 1e-6      # 16a: params after the step where the gradient
#                              is resolved (lr x 5e-4 = 5e-7 apart at most),
#                              plus TRAIN_MEAN_RTOL of the element's step
#                              where the gradient is bf16; elsewhere AdamW's
#                              first step turns rounding into up to ±lr: left
#                              out, counted, each within 2 lr plus a rounding
#                              step of the CPU's
TRAIN_MEAN_RTOL = 2 ** -6    # 16a: Adafactor's row and column means of g^2
#                              (its state vr, vc) agree within 2^-6 where an
#                              element is resolved: they are taken in the
#                              gradient's dtype, bf16 for dbrx, so one
#                              rounding apart is up to 2^-7; twice that
#                              keeps the state's own f32 rounding inside
TRAIN_SKIP_SHARE = 1e-2      # 16a: the left-out share of the elements
#                              (on the H100: 1.08e-3 qwen2, 3.72e-3 mamba2,
#                              1.86e-3 dbrx)
MATMUL_FLIP_SHARE = 5e-3     # 16a: of a bf16 gradient of the product, the
#                              share of elements that may differ from the
#                              CPU's at all: f32 sums in another order flip
#                              a few bf16 roundings (on the H100: 0 to
#                              5.67e-4), a backward that rounds the cotangent
#                              to bf16 many (0.422-0.426): checked too
TRAIN_FAMILIES = (("qwen2_0_5b", None), ("minicpm_2b", None),
                  ("qwen2_vl_2b", None), ("mamba2_370m", None),
                  ("hymba_1_5b", None), ("whisper_large_v3", None),
                  ("dbrx_132b", 1))
TRAIN_SHAPE = (4, 512)       # 16b-16d: B x S a step (qwen2-vl: 256 patch
#                              positions, then text; whisper: + 1,500 frames)
TRAIN_STEPS = 8
TRAIN_LR = 3e-4              # the train CLI's default peak
TRAIN_PROFILE = ("qwen2_0_5b", "dbrx_132b")   # 16b: one more step profiled
TRAIN_SERVE = (4, 64, 16)    # 16b: requests, s_max, new tokens (trained qwen2)
REMAT = (("none", dict(remat="none")), ("full", dict(remat="full")),
         ("dots", dict(remat="dots")), ("block8", dict(remat="full", remat_block=8)))
REMAT_RUNS = 3               # 16c: timed runs a setting (the median), after a warm-up
RESTART = (6, 2, 3)          # 16d: steps, a checkpoint every 2, a fault at step 3


def phase_train(torch):
    print("== phase 16: LM training at full width: 16a a train step card "
          "against CPU (qwen2-0.5b, mamba2-370m at 2 layers in f32; dbrx at 1 "
          "layer in bf16) and the bf16 product's gradient, 16b bf16 train_loop for every family (dbrx at "
          "1 of 40 layers) and serving the trained qwen2, 16c remat none / "
          "full / dots / blocks of 8, 16d checkpoint, fault and restart "
          "against an uninterrupted run", flush=True)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    train_matmul_grad(torch)
    for arch, layers, B, S in TRAIN_PARITY:
        train_parity(torch, arch, layers, B, S)
    train_families(torch)
    train_remat(torch)
    train_restart(torch)
    check("jax" not in sys.modules, "phase 16: jax was imported")
    print(f"phase 16 seconds={time.perf_counter() - t0:.1f}", flush=True)


def train_matmul_grad(torch):
    """16a: the card's bf16 products into f32 (the head, the experts: cuBLAS
    with out_dtype=f32, under an autograd Function) against the CPU path
    (upcast, f32 product) on the same inputs: the f32 outputs within 1e-4
    of the largest (the sums' order differs), each bf16 gradient element
    within one bf16 step (2^-7 relative) of the CPU's plus that, and at
    most MATMUL_FLIP_SHARE of them differing at all. The same share of a
    backward that rounds the cotangent to bf16 and takes a bf16 product
    must pass that limit, so that the check tells the two apart."""
    from repro_torch.models import layers
    gen = torch.Generator().manual_seed(16)
    for shape_x, shape_w in (((4, 128, 896), (896, 4864)),
                             ((4, 64, 256), (4, 256, 512))):
        x = torch.randn(shape_x, generator=gen).to(torch.bfloat16)
        w = (torch.randn(shape_w, generator=gen) / 16).to(torch.bfloat16)
        r = torch.randn(shape_x[:-1] + shape_w[-1:], generator=gen)
        got, want = [], []
        for dev, out in (("cuda", got), ("cpu", want)):
            xd = x.to(dev).requires_grad_(True)
            wd = w.to(dev).requires_grad_(True)
            y = layers.matmul(xd, wd)
            gx, gw = torch.autograd.grad((y * r.to(dev)).sum(), (xd, wd))
            out.extend(t.detach().cpu().float() for t in (y, gx, gw))
            check(y.dtype == torch.float32 and gx.dtype == gw.dtype == torch.bfloat16,
                  f"16a matmul {shape_x} x {shape_w}: dtypes {y.dtype} {gx.dtype} "
                  f"{gw.dtype}")
        rb, xc, wc = r.cuda().bfloat16(), x.cuda(), w.cuda()
        if w.dim() == 3:
            low = (torch.bmm(rb, wc.mT), torch.bmm(xc.mT, rb))
        else:
            low = (rb @ wc.T, xc.reshape(-1, x.shape[-1]).T @ rb.reshape(-1, w.shape[-1]))
        low = [None] + [t.float().cpu() for t in low]
        errs = []
        for name, a, b, step, lo in zip(("out", "grad_x", "grad_w"), got, want,
                                        (0.0, 2 ** -7, 2 ** -7), low):
            top = b.abs().max().item()
            err = ((a - b).abs() - step * b.abs()).max().item() / top
            check(err <= 1e-4, f"16a matmul {shape_x} x {shape_w}: {name} "
                  f"{err} of the largest from the CPU's (tolerance 1e-4)")
            errs.append(f"{name}={(a - b).abs().max().item() / top:.3g}")
            if lo is None:
                continue
            share = (a != b).float().mean().item()
            share_low = (lo != b).float().mean().item()
            check(share <= MATMUL_FLIP_SHARE, f"16a matmul {shape_x} x {shape_w}: "
                  f"{name} differs from the CPU's at {share} of its elements "
                  f"(limit {MATMUL_FLIP_SHARE})")
            check(share_low > MATMUL_FLIP_SHARE, f"16a matmul {shape_x} x {shape_w}: "
                  f"a bf16-cotangent {name} differs at only {share_low} of its "
                  f"elements: the limit {MATMUL_FLIP_SHARE} cannot tell it apart")
            errs.append(f"{name}_differing={share:.3g} bf16_cotangent_{name}_"
                        f"differing={share_low:.3g}")
        print(f"16a bf16 product into f32 {shape_x} x {shape_w} (cuBLAS out_dtype"
              f"=f32, autograd Function) against the CPU's upcast product: ok "
              f"max_abs_err/largest {' '.join(errs)} (out within 1e-4 of the "
              f"largest; grads within one bf16 step of each element plus that, "
              f"at most {MATMUL_FLIP_SHARE} of them differing)", flush=True)


def _leaf_on_card(torch, tensors: dict, key: str, names) -> "torch.Tensor":
    """The JAX package's leaf ``key`` from per-layer tensors (by parameter
    name), stacked where the leaf is, on the card in f32."""
    from repro_torch.optim.optimizers import leaf_tensor
    return leaf_tensor(key, [tensors[n].detach().to("cuda", torch.float32)
                             for n in names])


def train_parity(torch, arch, layers, B, S):
    """16a: one make_train_step on the same f32 weights (``layers`` layers
    at full width; TF32 off) and batch, on the card and on the CPU, with
    the config's optimizer, microbatches and accumulator: the loss, every
    gradient leaf, and the params after the step."""
    from repro_torch import optim, train
    from repro_torch.configs import get_config
    from repro_torch.data import model_batch
    from repro_torch.models import api
    from repro_torch.models.lm import LM
    from repro_torch.optim import leaf_groups
    cfg = get_config(arch).replace(num_layers=layers, param_dtype="float32",
                                   compute_dtype="float32")
    card = api.init_params(cfg, seed=1)
    before = {n: p.detach().cpu() for n, p in card.named_parameters()}
    cpu = LM(cfg, device="cpu")
    cpu.load_state_dict(before)
    batch = model_batch(cfg, B, S, seed=1)
    runs = {}
    for where, model in (("card", card), ("cpu", cpu)):
        opt = optim.make_optimizer(cfg.optimizer, optim.make_schedule(
            "constant", peak=TRAIN_PARITY_LR))
        seen = {}

        def update(grads, state, m, opt=opt, seen=seen):
            seen.update(grads)
            return opt.update(grads, state, m)
        step = train.make_train_step(cfg, optim.Optimizer(opt.init, update))
        model.requires_grad_(True)
        t0 = time.perf_counter()
        with MoESpy(torch) as spy:
            new, metrics = step({"params": model, "opt": opt.init(model), "step": 0},
                                batch)
        runs[where] = (float(metrics["loss"]), seen, time.perf_counter() - t0,
                       dict(model.named_parameters()), new["opt"], spy.drops())
    (loss, g_card, card_s, p_card, s_card, drops), \
        (want_loss, g_cpu, cpu_s, p_cpu, s_cpu, cpu_drops) = runs["card"], runs["cpu"]
    rel = abs(loss - want_loss) / abs(want_loss)
    check(rel <= TRAIN_LOSS_RTOL, f"16a {cfg.name}: loss {loss} against the "
          f"CPU's {want_loss} (relative {rel})")
    top = max(g.detach().abs().max().item() for g in g_cpu.values())
    worst, moved, leaves, left, off, flips, total = 0.0, 0.0, 0, 0, 0, 0, 0
    with torch.no_grad():
        for key, names in leaf_groups(g_cpu).items():
            gdt, pdt = g_cpu[names[0]].dtype, p_cpu[names[0]].dtype
            gc, gp = (_leaf_on_card(torch, t, key, names) for t in (g_card, g_cpu))
            lmax = gp.abs().max().item()
            scale = max(lmax, TRAIN_GRAD_RTOL * top)
            gtol = TRAIN_GRAD_RTOL + (torch.finfo(gdt).eps if gdt != torch.float32
                                      else 0.0)
            err = (gc - gp).abs().max().item()
            check(err <= gtol * scale, f"16a {cfg.name}: gradient {key} {err} "
                  f"from the CPU's (tolerance {gtol * scale})")
            worst = max(worst, err / scale)
            loose = (gc - gp).abs() > TRAIN_ELEM_RTOL * gp.abs()
            flips += int(((torch.sign(gc) != torch.sign(gp)) & loose).sum())
            del gc, gp
            v = s_cpu.get("v", {}).get(key, {})
            if "vr" in v:
                # Adafactor's u at (i, j) reads row i's and column j's means
                # of g^2: resolved where those agree too
                ok = [(s_card["v"][key][n] - v[n].cuda()).abs()
                      <= TRAIN_MEAN_RTOL * v[n].cuda() for n in ("vr", "vc")]
                loose |= ~(ok[0][..., None] & ok[1][..., None, :])
                del ok
            pc, pp = (_leaf_on_card(torch, t, key, names) for t in (p_card, p_cpu))
            d = (pc - pp).abs()
            rounding = torch.finfo(pdt).eps * torch.maximum(pc.abs(), pp.abs())
            del pc
            bound = torch.full_like(d, TRAIN_PARAM_ATOL)
            if gdt != torch.float32:
                # Adafactor's row and column means of g^2, within
                # TRAIN_MEAN_RTOL each, move u by that much at most (its
                # rsqrt halves their sum)
                step = (pp - _leaf_on_card(torch, before, key, names)).abs()
                bound += TRAIN_MEAN_RTOL * step
                part = torch.where(loose | (step == 0), 0.0,
                                   (d - TRAIN_PARAM_ATOL) / step)
                moved = max(moved, part.max().item())
                del step, part
            over = int(((d > bound) & ~loose).sum())
            check(over == 0, f"16a {cfg.name}: param {key} from the CPU's past "
                  f"its tolerance at {over} elements where the gradient is "
                  f"resolved (the largest part of a step taken {moved})")
            far = int(((d > 2 * TRAIN_PARITY_LR + rounding) & loose).sum())
            check(far == 0, f"16a {cfg.name}: param {key}: {far} left-out "
                  f"elements past 2 lr and a rounding step from the CPU's")
            left += int(loose.sum())
            off += int(((d > TRAIN_PARAM_ATOL) & loose).sum())
            total += d.numel()
            leaves += 1
            del pp, d, rounding, bound, loose
    check(left <= TRAIN_SKIP_SHARE * total, f"16a {cfg.name}: {left} of {total} "
          f"param elements left out (limit {TRAIN_SKIP_SHARE} of them)")
    print(f"16a {cfg.name} f32 {layers} layers B={B} S={S} {cfg.optimizer} "
          f"microbatches={cfg.microbatches} accum={cfg.accum_dtype}: ok "
          f"loss={loss:.6f} cpu_loss={want_loss:.6f} rel_err={rel:.3g} "
          f"grad_leaves={leaves} max_err/leaf_max={worst:.3g} (tolerance "
          f"{TRAIN_GRAD_RTOL}, plus 2^-7 where the gradient is bf16) params equal within {TRAIN_PARAM_ATOL} "
          f"(and a bf16 gradient's {TRAIN_MEAN_RTOL:.3g} of the step: the largest "
          f"part taken {moved:.3g}) where the gradient element is within "
          f"{TRAIN_ELEM_RTOL} of the CPU's (and Adafactor's means of g^2 within "
          f"{TRAIN_MEAN_RTOL:.3g}); "
          f"left out {left} of {total} elements (share {left / total:.3g}, limit "
          f"{TRAIN_SKIP_SHARE}), {off} of them off by more, {flips} sign flips "
          f"moe_drops={drops} cpu_moe_drops={cpu_drops} "
          f"card_s={card_s:.2f} cpu_s={cpu_s:.2f}", flush=True)
    del card, cpu, before, runs, g_card, g_cpu, p_card, p_cpu, s_card, s_cpu
    torch.cuda.empty_cache()


def train_bytes(torch, cfg, B, S) -> dict:
    """The device bytes a train step should take, reckoned from the
    shapes before anything is built: weights; gradients (the param dtype);
    the accumulator; the optimizer's state; the update's f32 temporaries
    (~5 of the largest tensor it takes at a time: a layer's slice for
    AdamW, a stacked leaf for Adafactor); one CE chunk's f32 logits (x3:
    logits, softmax, their gradient); the layer inputs kept by remat."""
    from repro_torch import optim
    from repro_torch.checkpoint.manager import _walk
    from repro_torch.models.encdec import EncDec
    from repro_torch.models.layers import _DTYPES
    from repro_torch.models.lm import LM
    from repro_torch.optim.optimizers import leaf_groups
    meta = (EncDec if cfg.family == "encdec" else LM)(cfg, device="meta")
    params = dict(meta.named_parameters())
    weights = sum(p.numel() * p.element_size() for p in params.values())
    n = sum(p.numel() for p in params.values())
    state = optim.make_optimizer(cfg.optimizer, lambda s: 0.0).init(meta)
    opt = sum(t.numel() * t.element_size() for _, t in _walk(state)
              if isinstance(t, torch.Tensor))
    if cfg.optimizer == "adamw":
        largest = max(p.numel() for p in params.values())
    else:
        largest = max(sum(params[m].numel() for m in members)
                      for members in leaf_groups(params).values())
    acc = n * _DTYPES[cfg.accum_dtype].itemsize if cfg.microbatches > 1 else 0
    b = B // max(cfg.microbatches, 1)
    logits = 3 * b * min(512, S) * cfg.vocab_size * 4
    layers = cfg.num_layers + (cfg.enc_layers if cfg.family == "encdec" else 0)
    acts = layers * b * (S + (cfg.enc_seq if cfg.family == "encdec" else 0)) \
        * cfg.d_model * 2
    parts = dict(weights=weights, grads=weights, accumulator=acc, opt_state=opt,
                 f32_temps=5 * largest * 4, ce_logits=logits, layer_inputs=acts)
    parts["total"] = sum(parts.values())
    return parts


def train_families(torch):
    """16b: train_loop at full width, one config a family, TRAIN_STEPS
    steps of TRAIN_SHAPE each: every loss and grad norm finite; ms a step
    (the median past the first), tokens a second, peak memory against the
    reckoned bytes, the loss curve. TRAIN_PROFILE's configs profile one
    more step; the trained qwen2 serves."""
    from repro_torch.configs import get_config, schedule_for
    from repro_torch.launch.train import train_loop
    B, S = TRAIN_SHAPE
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    for arch, layers in TRAIN_FAMILIES:
        cfg = get_config(arch)
        if layers:
            print(f"16b {cfg.name}: reduced num_layers {cfg.num_layers} -> "
                  f"{layers} (every width as published)", flush=True)
            cfg = cfg.replace(num_layers=layers)
        reckon = train_bytes(torch, cfg, B, S)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            path = os.path.join(tmp, "metrics.jsonl")
            t0 = time.perf_counter()
            state, hist = train_loop(cfg, steps=TRAIN_STEPS, batch_size=B,
                                     seq_len=S, lr=TRAIN_LR, seed=0,
                                     schedule=schedule_for(arch),
                                     log_every=TRAIN_STEPS, metrics_path=path)
            wall = time.perf_counter() - t0
            with open(path) as f:
                recs = [json.loads(line) for line in f]
        peak = torch.cuda.max_memory_allocated() - base
        losses = [h["loss"] for h in hist]
        norms = [r["grad_norm"] for r in recs]
        check(len(hist) == TRAIN_STEPS == len(norms), f"16b {cfg.name}: "
              f"{len(hist)} steps logged, {TRAIN_STEPS} run")
        check(all(math.isfinite(v) for v in losses + norms),
              f"16b {cfg.name}: a loss or grad norm is not finite: {losses} {norms}")
        ms = statistics.median(h["dt"] for h in hist[1:]) * 1e3
        lrs = [float(f"{r['lr']:.3g}") for r in recs]
        print(f"16b {cfg.name} {cfg.family} {cfg.param_dtype} layers={cfg.num_layers}"
              f" remat={cfg.remat} remat_block={cfg.remat_block} {cfg.optimizer} "
              f"microbatches={cfg.microbatches} accum={cfg.accum_dtype} "
              f"schedule={schedule_for(arch)} B={B} "
              f"S={S}: ok ms_per_step={ms:.1f} first_step_ms="
              f"{hist[0]['dt'] * 1e3:.1f} tokens_per_s={B * S / ms * 1e3:.0f} "
              f"wall_s={wall:.1f} peak_bytes={peak} reckoned_bytes={reckon['total']} "
              f"peak/reckoned={peak / reckon['total']:.3f} "
              f"({' '.join(f'{k}={v}' for k, v in reckon.items() if k != 'total')}) "
              f"loss={[round(v, 4) for v in losses]} grad_norm="
              f"{[round(v, 3) for v in norms]} lr={lrs}",
              flush=True)
        if arch in TRAIN_PROFILE:
            train_profile(torch, cfg, state)
        if arch == "qwen2_0_5b":
            train_serve(torch, cfg, state["params"])
        del state
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def train_profile(torch, cfg, state):
    """16b: one more train step of the trained state under the profiler:
    kernels a step, device busy time and idle share, the largest
    kernels."""
    from repro_torch import optim, train
    from repro_torch.data import model_batch
    B, S = TRAIN_SHAPE
    opt = optim.make_optimizer(cfg.optimizer, optim.make_schedule(
        "constant", peak=TRAIN_LR))
    step = train.make_train_step(cfg, opt)
    batch = model_batch(cfg, B, S, seed=0, step=TRAIN_STEPS)
    lm_profile(torch, f"16b {cfg.name} train step B={B} S={S}",
               lambda: step(state, batch), 1)


def train_serve(torch, cfg, model):
    """16b: the trained qwen2 serves TRAIN_SERVE's requests through the
    Engine: every request its tokens in the vocabulary, and no tensor of
    the cache carries an autograd graph."""
    from repro_torch.data import token_batch
    from repro_torch.serve import Engine, Request
    n, s_max, new = TRAIN_SERVE
    eng = Engine(model, cfg, slots=n, s_max=s_max)
    for i in range(n):
        eng.submit(Request(uid=i, tokens=token_batch(cfg.vocab_size, 1, 8 + 5 * i,
                                                     seed=5, step=i)["tokens"][0],
                           max_new=new))
    t0 = time.perf_counter()
    done = eng.run()
    wall = time.perf_counter() - t0
    check(len(done) == n and all(len(r.out) == new and all(0 <= t < cfg.vocab_size
                                                           for t in r.out)
                                 for r in done),
          f"16b {cfg.name} serving: a request without {new} tokens in the vocabulary")
    graphs = [k for k, t in eng.cache.items() if t.grad_fn is not None or t.requires_grad]
    check(not graphs, f"16b {cfg.name} serving: cache tensors {graphs} carry a graph")
    print(f"16b {cfg.name} trained, served by Engine(slots={n}, s_max={s_max}): "
          f"ok requests={n} tokens={n * new} wall_s={wall:.3f} cache tensors "
          f"without grad_fn {sorted(eng.cache)} params require grad="
          f"{all(p.requires_grad for p in model.parameters())}", flush=True)


def train_remat(torch):
    """16c: qwen2 full() in bf16, one batch: the loss and its gradients
    under remat none, full, dots and blocks of 8 (3 blocks of 8 layers):
    bitwise alike; peak memory and ms of the forward and backward (the
    median of REMAT_RUNS runs, the last one's gradients compared)."""
    from repro_torch import train
    from repro_torch.configs import get_config
    from repro_torch.data import model_batch
    from repro_torch.models import api
    from repro_torch.train.step import to_device
    cfg0 = get_config("qwen2_0_5b")
    B, S = TRAIN_SHAPE
    model = api.init_params(cfg0, seed=2)
    model.requires_grad_(True)
    names, params = zip(*model.named_parameters())
    batch = to_device(model_batch(cfg0, B, S, seed=2), model.device)
    ref = None
    for label, changes in REMAT:
        cfg = cfg0.replace(**changes)
        loss_fn = train.make_loss_fn(cfg)

        def run():
            loss, _ = loss_fn(model, batch)
            return loss.detach(), torch.autograd.grad(loss, params)
        run()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(REMAT_RUNS):
            grads = None        # the last run's gradients are not held
            t0 = time.perf_counter()
            loss, grads = run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        peak = torch.cuda.max_memory_allocated() - base
        same = "reference"
        if ref is None:
            ref = (loss, grads)
        else:
            diff = {n: (g.float() - r.float()).abs().max().item()
                    for n, g, r in zip(names, grads, ref[1]) if not torch.equal(g, r)}
            if diff or not torch.equal(loss, ref[0]):
                worst = sorted(diff.items(), key=lambda kv: -kv[1])[:5]
                print(f"16c remat={label}: gradients differ from remat=none: "
                      f"{len(diff)} of {len(names)} tensors, largest {worst}; loss "
                      f"{loss.item()} against {ref[0].item()}", flush=True)
            check(not diff and torch.equal(loss, ref[0]), f"16c remat={label}: "
                  "the gradients are not bitwise those without remat")
            same = "bitwise remat=none's"
        print(f"16c {cfg.name} {cfg.param_dtype} B={B} S={S} remat={cfg.remat} remat_block="
              f"{cfg.remat_block}: ok loss={loss.item():.6f} gradients {same} "
              f"forward+backward_ms={ms:.1f} (runs {[round(t, 1) for t in times]}) "
              f"peak_bytes={peak}", flush=True)
        del grads
    del model, ref
    torch.cuda.empty_cache()


def train_restart(torch):
    """16d: qwen2 full() bf16 under train_loop, a checkpoint every 2 steps
    and a fault raised at step 3: the loop restores step 2's checkpoint and
    runs to step 6; its state against an uninterrupted run's, bitwise.
    Then the checkpoint's bytes and its save and restore seconds."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.launch.train import RestartPolicy, train_loop
    from repro_torch.checkpoint.manager import _walk
    cfg = get_config("qwen2_0_5b")
    steps, every, fault_at = RESTART
    B, S = TRAIN_SHAPE
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    armed = [True]

    def fault(step):
        if step == fault_at and armed[0]:
            armed[0] = False
            raise RuntimeError("injected device failure")
    kw = dict(steps=steps, batch_size=B, seq_len=S, lr=TRAIN_LR, seed=0,
              log_every=steps)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        t0 = time.perf_counter()
        state, hist = train_loop(cfg, ckpt_dir=tmp, ckpt_every=every,
                                 resume="auto", fault_hook=fault,
                                 policy=RestartPolicy(max_restarts=1, backoff_s=0.0),
                                 **kw)
        faulted_s = time.perf_counter() - t0
        seen = [h["step"] for h in hist]
        check(not armed[0] and seen == [0, 1, 2, 2, 3, 4, 5],
              f"16d: steps run {seen}, expected 0 1 2, the restart at 2, 3 4 5")
        t0 = time.perf_counter()
        clean, clean_hist = train_loop(cfg, **kw)
        clean_s = time.perf_counter() - t0
        a, b = dict(_walk(state)), dict(_walk(clean))
        check(list(a) == list(b), "16d: the two states differ in structure")
        diff = {n: (a[n].float() - b[n].float()).abs().max().item()
                for n in a if isinstance(a[n], torch.Tensor) and not torch.equal(a[n], b[n])}
        scalars = [n for n in a if not isinstance(a[n], torch.Tensor) and a[n] != b[n]]
        losses = [h["loss"] for h in hist[-3:]] == [h["loss"] for h in clean_hist[-3:]]
        if diff or scalars or not losses:
            print(f"16d: the restarted state differs from the uninterrupted run's: "
                  f"{sorted(diff.items(), key=lambda kv: -kv[1])[:5]} {scalars} "
                  f"losses {[h['loss'] for h in hist]} {[h['loss'] for h in clean_hist]}",
                  flush=True)
        check(not diff and not scalars and losses, "16d: the restart does not "
              "reproduce the uninterrupted run bitwise")
        t0 = time.perf_counter()
        path = save_checkpoint(tmp, 100, clean, keep=1)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restore_checkpoint(tmp, state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(all(torch.equal(x, dict(_walk(clean))[n]) for n, x in _walk(state)
                  if isinstance(x, torch.Tensor)), "16d: a restored state is not "
              "the saved one")
    print(f"16d {cfg.name} {cfg.param_dtype} B={B} S={S}: ok {steps} steps, a checkpoint every "
          f"{every}, a fault at step {fault_at}, restored from step 2: state "
          f"bitwise the uninterrupted run's ({len(a)} tensors and scalars), losses "
          f"{[round(h['loss'], 4) for h in hist]} faulted_run_s={faulted_s:.1f} "
          f"clean_run_s={clean_s:.1f} checkpoint_bytes={nbytes} save_s={save_s:.2f}"
          f" restore_s={restore_s:.2f}", flush=True)


# ---------------------------------------------------------------------------
# Phase 17: the LM's sharding (repro_torch.sharding)
# ---------------------------------------------------------------------------

SHARD_MESHES = (("pod16x16", (16, 16), ("data", "model")),
                ("pod2x16x16", (2, 16, 16), ("pod", "data", "model")))
SHARD_DRYRUN = (("qwen2_0_5b", "decode_32k", "single"),    # 17b: the JAX
                ("mamba2_370m", "long_500k", "multi"))     # tests' two cells
SHARD_ELASTIC = (4, 512, 2)  # 17c: B x S, steps (qwen2-0.5b at full width)
SHARD_PARITY = (("qwen2_0_5b", 2, True), ("mamba2_370m", 2, True),
                ("dbrx_132b", 2, False))  # 17d: arch, layers, train step too, in f32
SHARD_GRIDS = ((2, 2), (1, 4))
SHARD_PARITY_BS = (2, 8)     # 17d: B x S (dbrx: N·K = 64 slots, drop-free)
SHARD_LOGIT_RTOL = 1e-3      # 17d: logits within 1e-3 of the largest |logit|
#                              (14b's tolerance: sums in another order)
SHARD_BF16 = (16, 512, 3)    # 17d: qwen2 at full depth in bf16: B x S, steps
SHARD_CELLS = (("qwen2_0_5b", "train_4k", 8), ("qwen2_0_5b", "prefill_32k", 1),
               ("qwen2_0_5b", "decode_32k", 1), ("mamba2_370m", "long_500k", 1))
#                              17d: the SHAPES cells at (4, 1), microbatches
#                              (train_4k takes 8 to fit: 8 rows a card each)
SHARD_CELL_GRID = (4, 1)
KIMI_SERVE = (4, 4, 64, 8)   # 17d: layers, B, prompt, decode steps (the
#                              depth reckoned from the bytes: PERF.md)
KIMI_TRAIN = (1, 8, 128)     # 17d: layers, B, S of the one train step
SHARD_TIMEOUT = 1500.0       # 17d: the workers' deadline
SHARD_WORKERS = os.path.abspath(__file__)   # the file 17's workers load


def phase_sharding(torch):
    print("== phase 17: the LM's sharding: 17a every config's placements "
          "at pod16x16 and pod2x16x16, 17b the dry-run of two cells on a fake "
          "process group, 17c train_loop on the elastic mesh of one card "
          "against mesh=None, and two processes on the card over gloo",
          flush=True)
    t0 = time.perf_counter()
    reckoned = shard_specs(torch)
    shard_dryrun(reckoned)
    shard_elastic(torch)
    shard_gloo(torch)
    check("jax" not in sys.modules, "phase 17: jax was imported")
    print(f"phase 17 seconds={time.perf_counter() - t0:.1f}", flush=True)


def shard_specs(torch) -> dict:
    """17a: each config's full() train state placed by the rules on both
    production meshes: every sharded dim divides its axes, and the bytes a
    device holds of the parameters and of the optimizer's state. Returns
    {(arch, mesh): param bytes}."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch import Mesh
    from repro_torch.launch.specs import state_specs
    from repro_torch.sharding import specs
    from torch.distributed.tensor import Shard
    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        state = state_specs(cfg)
        shapes = specs.leaf_shapes(state)
        for name, shape, axes in SHARD_MESHES:
            mesh = Mesh(shape, axes, device="cpu")
            pl = specs.state_pspecs(state, mesh)
            sharded = 0
            for path, places in pl.items():
                split = {}
                for axis, p in zip(axes, places):
                    if isinstance(p, Shard):
                        split[p.dim] = split.get(p.dim, 1) * mesh.shape[axis]
                for dim, n in split.items():
                    check(shapes[path][dim] % n == 0, f"17a {arch} {name}: "
                          f"{path} dim {dim} ({shapes[path][dim]}) over {n}")
                sharded += bool(split)
            pbytes = specs.placed_bytes(state["params"], specs.params_pspecs(
                state["params"], mesh), mesh)
            obytes = specs.placed_bytes({"opt": state["opt"]}, pl, mesh)
            full_bytes = sum(p.numel() * p.element_size()
                             for p in state["params"].parameters())
            out[(arch, name)] = pbytes
            print(f"17a {cfg.name} {name}: ok leaves={len(pl)} sharded={sharded} "
                  f"param_bytes_per_device={pbytes} opt_bytes_per_device={obytes} "
                  f"param_bytes_whole={full_bytes} "
                  f"({full_bytes / max(pbytes, 1):.1f}x)", flush=True)
    return out


def shard_dryrun(reckoned: dict):
    """17b: ``python -m repro_torch.launch.dryrun`` for SHARD_DRYRUN's cells,
    both at once, each in a process of its own on a fake 512-rank group
    (its fake tensors on the card's device type; nothing is allocated):
    the record's parameter bytes against 17a's, its FLOPs, bytes,
    collectives and roofline terms."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(here, "build", "dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(here, "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", which, "--out", out, "--force"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for arch, shape, which in SHARD_DRYRUN]
    for (arch, shape, which), p in zip(SHARD_DRYRUN, procs):
        log, _ = p.communicate(timeout=600)
        check(p.returncode == 0, f"17b {arch} {shape}: dry-run failed:\n{log[-3000:]}")
        mesh = "pod16x16" if which == "single" else "pod2x16x16"
        with open(os.path.join(out, mesh, f"{arch}__{shape}.json")) as f:
            rec = json.load(f)
        mem, terms = rec["memory_analysis"], rec["roofline_terms_s"]
        check(mem["param_bytes"] == reckoned[(arch, mesh)],
              f"17b {arch} {shape} {mesh}: the record's parameter bytes "
              f"{mem['param_bytes']} against 17a's {reckoned[(arch, mesh)]}")
        check(rec["cost_per_device"]["flops"] > 0 and terms["memory_s"] > 0,
              f"17b {arch} {shape}: {rec}")
        print(f"17b {arch} {shape} {mesh}: ok chips={rec['chips']} "
              f"device={rec['device']} run_s={rec['run_s']} "
              f"{' '.join(f'{k}={v}' for k, v in mem.items())} "
              f"flops_per_device={rec['cost_per_device']['flops']:.6g} "
              f"bytes_per_device={rec['cost_per_device']['bytes']:.6g} "
              f"collectives={rec['collectives_per_device']} "
              f"terms_s={terms} dominant={rec['dominant']} "
              f"useful_flops_fraction={rec['useful_flops_fraction']:.6g}",
              flush=True)


def shard_elastic(torch):
    """17c: ``train_loop(mesh=make_elastic_mesh())`` on one card — a (1, 1)
    mesh — for qwen2-0.5b at full width, bitwise the ``mesh=None`` run."""
    from repro_torch.configs import get_config
    from repro_torch.launch import make_elastic_mesh
    from repro_torch.launch.train import train_loop
    B, S, steps = SHARD_ELASTIC
    cfg = get_config("qwen2_0_5b")
    mesh = make_elastic_mesh()
    check(tuple(mesh.shape.values()) == (1, 1), f"17c: elastic mesh {mesh.shape}")
    runs = []
    for m in (None, mesh):
        t0 = time.perf_counter()
        state, hist = train_loop(cfg, steps=steps, batch_size=B, seq_len=S,
                                 mesh=m, log_every=steps)
        runs.append((state, hist, time.perf_counter() - t0))
    (a, ha, ta), (b, hb, tb) = runs
    same = all(torch.equal(p, q) for (_, p), (_, q) in
               zip(a["params"].named_parameters(), b["params"].named_parameters()))
    check(same and [h["loss"] for h in ha] == [h["loss"] for h in hb],
          "17c: the elastic mesh's run is not bitwise the mesh=None run")
    print(f"17c qwen2-0.5b elastic mesh {dict(mesh.shape)} B={B} S={S} "
          f"steps={steps}: ok bitwise mesh=None losses={[h['loss'] for h in hb]} "
          f"wall_s={tb:.1f} (mesh=None {ta:.1f})", flush=True)
    del a, b, runs
    torch.cuda.empty_cache()


def gloo_probe(ctx) -> dict:
    """17c: whether gloo takes, on CUDA tensors, the collectives DTensor
    and the MoE issue (all-gather, reduce-scatter, all-reduce): two
    processes on the one card."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import make_process_mesh
    dev = make_process_mesh((1, 2), ("data", "model")).device
    x = torch.ones(4, device=dev)
    dist.all_gather_into_tensor(torch.empty(8, device=dev), x)
    dist.reduce_scatter_tensor(torch.empty(2, device=dev), x)
    dist.all_reduce(x)
    torch.cuda.synchronize()
    return {}


def gloo_worker(ctx) -> dict:
    """17c: qwen2-0.5b at 2 layers in f32 at (1, 2), two processes on the
    one card over gloo, against this process's one-device run."""
    import torch
    return shard_parity(torch, (1, 2), "qwen2_0_5b", 2, True)


def shard_gloo(torch):
    """17c: two processes on the one card over gloo, where gloo takes the
    collectives on CUDA tensors: the plain ones (gloo_probe), then
    DTensor's (gloo_worker). A probe that fails, or workers killed by a
    signal, mean gloo does not: a line says so. Anything else fails."""
    from repro_torch.launch import ClusterError, run_scenario
    torch.cuda.empty_cache()
    stage = "the plain all-gather, reduce-scatter and all-reduce"
    try:
        run_scenario(f"{SHARD_WORKERS}:gloo_probe", 2, backend="gloo", timeout=120)
        stage = "DTensor's collectives in the f32 parity case (the plain ones passed)"
        v = run_scenario(f"{SHARD_WORKERS}:gloo_worker", 2, backend="gloo",
                         timeout=300)
    except ClusterError as e:
        codes = [r.returncode for r in e.results]
        if stage.startswith("DTensor") and not any(c is not None and c < 0
                                                   for c in codes):
            raise
        print(f"17c two processes on one card: gloo does not take {stage} on "
              f"CUDA tensors (the workers exit {codes}); the multi-process "
              "cases run under --cluster nccl only (17d)", flush=True)
        return
    for r in v:
        shard_parity_check(r)
    print(f"17c two processes on one card over gloo (1, 2): ok {v[0]}", flush=True)


def shard_parity(torch, grid, arch, layers, train):
    """The sharded run of ``arch`` at ``layers`` in f32 on ``grid`` against
    this process's one-device run on its own card: forward, prefill and a
    decode step (logits relative to the largest |logit|), and where
    ``train``, one train step's loss and gradients (each leaf relative to
    its largest |g|, the optimizer's step taken too)."""
    from repro_torch import models, optim
    from repro_torch.configs import get_config
    from repro_torch.data import model_batch
    from repro_torch.launch import make_process_mesh
    from repro_torch.sharding import use_mesh
    from repro_torch.sharding.runtime import full
    from repro_torch.train import make_train_step
    from repro_torch.train.step import make_loss_fn
    B, S = SHARD_PARITY_BS
    cfg = get_config(arch).replace(num_layers=layers, param_dtype="float32",
                                   compute_dtype="float32",
                                   accum_dtype="float32")
    batch = model_batch(cfg, B, S, seed=0, step=0)
    mesh = make_process_mesh(grid, ("data", "model"))

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())
    out = {"case": f"{cfg.name} {layers} layers {grid}"}
    ref = models.init_params(cfg, seed=0)
    logits, _ = models.forward(ref, batch, cfg)
    pl, cache = models.prefill(ref, batch, cfg, S + 2)
    tok = pl.argmax(-1).to(torch.int32).cpu().numpy()
    dl, _ = models.decode_step(ref, cache, tok, cfg)
    with use_mesh(mesh):
        model = models.init_params(cfg, seed=0)
        got, _ = models.forward(model, batch, cfg)
        spl, scache = models.prefill(model, batch, cfg, S + 2)
        sdl, _ = models.decode_step(model, scache, tok, cfg)
        got, spl, sdl = got.full_tensor(), spl.full_tensor(), sdl.full_tensor()
    out.update(forward=rel(got, logits), prefill=rel(spl, pl), decode=rel(sdl, dl))
    del ref, cache, scache
    if train:
        loss_fn = make_loss_fn(cfg)

        def grads(m):
            m.requires_grad_(True)
            names, ps = zip(*m.named_parameters())
            loss, _ = loss_fn(m, batch)
            return float(loss), dict(zip(names, torch.autograd.grad(
                loss, ps, materialize_grads=True)))
        ref = models.init_params(cfg, seed=0)
        l1, g1 = grads(ref)
        with use_mesh(mesh):
            ls, gs = grads(model)
            gs = {n: full(g) for n, g in gs.items()}
        out["loss"] = abs(ls - l1) / abs(l1)
        out["grad"] = max(float((gs[n] - g).abs().max() / g.abs().max().clamp_min(1e-30))
                          for n, g in g1.items() if g.abs().max() > 1e-3 * max(
                              float(h.abs().max()) for h in g1.values()))
        opt = optim.make_optimizer(cfg.optimizer, optim.make_schedule(
            "constant", peak=TRAIN_LR))
        from repro_torch.train import init_train_state
        with use_mesh(mesh):
            state = init_train_state(cfg, opt, seed=0)
            state, metrics = make_train_step(cfg, opt)(state, batch)
            out["step_loss"] = float(metrics["loss"])
        del state, ref, g1, gs
    del model
    torch.cuda.empty_cache()
    return out


def shard_parity_check(r: dict):
    check(max(r["forward"], r["prefill"], r["decode"]) <= SHARD_LOGIT_RTOL,
          f"17d {r['case']}: logits {r}")
    if "loss" in r:
        check(r["loss"] <= TRAIN_LOSS_RTOL and r["grad"] <= TRAIN_GRAD_RTOL,
              f"17d {r['case']}: loss or gradients {r}")
        check(math.isfinite(r["step_loss"]), f"17d {r['case']}: step loss {r}")


def _peak_reset(torch):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def sharded_worker(ctx) -> dict:
    """17d, run by every worker (a card each, NCCL), one part of it a run
    (``ctx.args["part"]``), so that each part starts on empty cards:
    ``parity`` (the SHARD_PARITY cases at SHARD_GRIDS, then qwen2-0.5b at
    full depth in bf16), ``cells`` (SHARD_CELLS at SHARD_CELL_GRID),
    ``kimi_serve`` and ``kimi_train`` (kimi-k2 at full width). Each case's
    per-card peak device memory and ms."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return {"parity": _shard_parity_part, "cells": _shard_cells_part,
            "kimi_serve": _kimi_serve_part, "kimi_train": _kimi_train_part}[
                ctx.args["part"]](torch)


def _shard_parity_part(torch) -> dict:
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.data import model_batch
    from repro_torch.launch import make_process_mesh
    from repro_torch.sharding import use_mesh
    from repro_torch.train import init_train_state, make_train_step
    out = {"parity": []}
    for arch, layers, train in SHARD_PARITY:
        for grid in SHARD_GRIDS:
            out["parity"].append(shard_parity(torch, grid, arch, layers, train))
    # qwen2-0.5b at full depth in bf16 on (2, 2)
    B, S, steps = SHARD_BF16
    cfg = get_config("qwen2_0_5b")
    mesh = make_process_mesh((2, 2), ("data", "model"))
    base = _peak_reset(torch)
    opt = optim.make_optimizer(cfg.optimizer, optim.make_schedule("constant",
                                                                  peak=TRAIN_LR))
    with use_mesh(mesh):
        state = init_train_state(cfg, opt, seed=0)
        step = make_train_step(cfg, opt)
        ms, losses = [], []
        for i in range(steps):
            (state, m), t = _timed(torch, lambda: step(
                state, model_batch(cfg, B, S, step=i)))
            ms.append(t)
            losses.append(float(m["loss"]))
    out["bf16"] = {"grid": [2, 2], "B": B, "S": S, "ms": ms, "losses": losses,
                   "peak": torch.cuda.max_memory_allocated() - base,
                   "held": _held_bytes(state)}
    return out


def _shard_cells_part(torch) -> dict:
    from repro_torch import models
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import model_batch
    from repro_torch.launch import make_process_mesh
    from repro_torch.sharding import runtime, use_mesh
    from repro_torch.sharding.specs import state_pspecs
    from repro_torch.train import make_train_step
    mesh = make_process_mesh(SHARD_CELL_GRID, ("data", "model"))
    out = {}
    for arch, cell, micro in SHARD_CELLS:
        shape = SHAPES[cell]
        cfg = get_config(arch)
        Bg, Sg = shape.global_batch, shape.seq_len
        base = _peak_reset(torch)
        rec = {"B": Bg, "S": Sg, "microbatches": micro}
        with use_mesh(mesh):
            model = models.init_params(cfg, seed=0)
            if shape.kind == "train":
                model.requires_grad_(True)
                ostate = opt_for(cfg).init(model)
                ostate = runtime.place_tree(ostate, state_pspecs(
                    {"opt": ostate}, mesh), mesh, prefix="opt/")
                st = {"params": model, "opt": ostate, "step": 0}
                stepf = make_train_step(cfg, opt_for(cfg), num_microbatches=micro)
                batch = model_batch(cfg, Bg, Sg)
                (st, m), rec["ms"] = _timed(torch, lambda: stepf(st, batch))
                rec["loss"] = float(m["loss"])
                del st
            elif shape.kind == "prefill":
                batch = {"tokens": np.zeros((Bg, Sg), np.int32)}
                (lg, cache), rec["ms"] = _timed(torch, lambda: models.prefill(
                    model, batch, cfg, Sg))
                rec["finite"] = bool(torch.isfinite(lg.to_local()).all())
                del lg, cache
            else:
                rows = runtime.dp_rows(Bg)
                b = Bg if rows is None else rows[1] - rows[0]
                with torch.inference_mode():
                    cache = models.init_cache(cfg, b, Sg, device=mesh.device)
                    cache["pos"].fill_(Sg - 1)
                tok = np.zeros((Bg, 1), np.int32)
                (lg, cache), rec["ms"] = _timed(torch, lambda: models.decode_step(
                    model, cache, tok, cfg))
                rec["finite"] = bool(torch.isfinite(lg.to_local()).all())
                del lg, cache
        rec["peak"] = torch.cuda.max_memory_allocated() - base
        out[f"{arch} {cell}"] = rec
        del model
    return {"cells": out}


def _kimi_serve_part(torch) -> dict:
    """kimi-k2 at full width on (1, 4), at KIMI_SERVE's depth: prefill and
    decode steps, each process's tokens the same."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.data import model_batch
    from repro_torch.launch import make_process_mesh
    from repro_torch.sharding import use_mesh
    mesh = make_process_mesh((1, 4), ("data", "model"))
    layers, B, P, steps = KIMI_SERVE
    cfg = get_config("kimi_k2_1t_a32b").replace(num_layers=layers)
    base = _peak_reset(torch)
    with use_mesh(mesh):
        (model, init_ms) = _timed(torch, lambda: models.init_params(cfg, seed=0))
        batch = model_batch(cfg, B, P)
        (lg, cache), pre_ms = _timed(torch, lambda: models.prefill(
            model, batch, cfg, P + steps))
        tok = lg.full_tensor().argmax(-1).to(torch.int32).cpu().numpy()
        dec = []
        for _ in range(steps):
            (lg, cache), t = _timed(torch, lambda: models.decode_step(
                model, cache, tok, cfg))
            dec.append(t)
            tok = lg.full_tensor().argmax(-1).to(torch.int32).cpu().numpy()
        finite = bool(torch.isfinite(lg.to_local()).all())
    return {"kimi_serve": {"layers": layers, "B": B, "prompt": P,
                           "init_ms": init_ms, "prefill_ms": pre_ms,
                           "decode_ms": dec, "finite": finite,
                           "tokens": tok.reshape(-1).tolist(),
                           "held": _held_bytes({"p": model}),
                           "peak": torch.cuda.max_memory_allocated() - base}}


def _kimi_train_part(torch) -> dict:
    """kimi-k2 at full width on (1, 4): one train step at KIMI_TRAIN's
    depth (its Adafactor, 2 microbatches, bf16 accumulator)."""
    from repro_torch.configs import get_config
    from repro_torch.data import model_batch
    from repro_torch.launch import make_process_mesh
    from repro_torch.sharding import use_mesh
    from repro_torch.train import init_train_state, make_train_step
    mesh = make_process_mesh((1, 4), ("data", "model"))
    layers, B, S = KIMI_TRAIN
    cfg = get_config("kimi_k2_1t_a32b").replace(num_layers=layers)
    base = _peak_reset(torch)
    opt = opt_for(cfg)
    with use_mesh(mesh):
        state = init_train_state(cfg, opt, seed=0)
        (state, m), ms = _timed(torch, lambda: make_train_step(cfg, opt)(
            state, model_batch(cfg, B, S)))
    return {"kimi_train": {"layers": layers, "B": B, "S": S, "ms": ms,
                           "loss": float(m["loss"]), "held": _held_bytes(state),
                           "peak": torch.cuda.max_memory_allocated() - base}}


def opt_for(cfg):
    from repro_torch import optim
    return optim.make_optimizer(cfg.optimizer, optim.make_schedule(
        "constant", peak=TRAIN_LR))


def _held_bytes(tree) -> int:
    """Bytes this process holds of a tree's tensors (its shards)."""
    import torch
    from repro_torch.sharding.runtime import local
    if isinstance(tree, torch.nn.Module):
        return sum(local(p).numel() * p.element_size() for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(_held_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        t = local(tree)
        return t.numel() * t.element_size()
    return 0


def phase_sharded_cluster(torch, backend: str):
    """17d over ``backend`` (a card a worker): the dry-run of SHARD_CELLS
    at SHARD_CELL_GRID first (its reckoned per-device peak, on a fake
    group), then sharded_worker on four processes."""
    print(f"== phase 17d: the LM sharded over 4 processes ({backend}, a card a "
          "worker): (2, 2) and (1, 4) against one card in f32, qwen2-0.5b at "
          "full depth in bf16, the SHAPES cells that fit at "
          f"{SHARD_CELL_GRID}, kimi-k2 at full width", flush=True)
    from repro_torch.launch import ClusterError, run_scenario
    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(here, "build", "dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(here, "src"))
    grid = "x".join(map(str, SHARD_CELL_GRID))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", cell, "--grid", grid, "--microbatches", str(micro),
         "--out", out, "--force"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for arch, cell, micro in SHARD_CELLS]
    reck = {}
    for (arch, cell, _), p in zip(SHARD_CELLS, procs):
        log, _ = p.communicate(timeout=900)
        check(p.returncode == 0, f"17d dry-run {arch} {cell}: {log[-3000:]}")
        with open(os.path.join(out, f"grid{grid}", f"{arch}__{cell}.json")) as f:
            reck[f"{arch} {cell}"] = json.load(f)["memory_analysis"]
    print(f"17d dry-run at {grid}: {reck}", flush=True)
    # each part on fresh processes; the allocator's expandable segments keep
    # kimi-k2's 22.5 GB f32 draws from fragmenting the cards
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

    def part(name):
        for attempt in range(3):
            try:
                return run_scenario(f"{SHARD_WORKERS}:sharded_worker", 4,
                                    args={"part": name}, backend=backend,
                                    timeout=SHARD_TIMEOUT)
            except ClusterError as e:   # a port of the last run's, not free yet
                if "EADDRINUSE" not in str(e) or attempt == 2:
                    raise
                print(f"17d {name}: the rendezvous port was in use; again",
                      flush=True)
    v = part("parity")
    for w in v:
        for r in w["parity"]:
            shard_parity_check(r)
    for r in v[0]["parity"]:
        print(f"17d parity {r['case']}: ok {r}", flush=True)
    print(f"17d bf16: ok {v[0]['bf16']} peak_per_card={[w['bf16']['peak'] for w in v]}",
          flush=True)
    v = part("cells")
    for name, rec in v[0]["cells"].items():
        peaks = [w["cells"][name]["peak"] for w in v]
        check(all(w["cells"][name].get("finite", True) for w in v)
              and all(math.isfinite(w["cells"][name].get("loss", 0.0)) for w in v),
              f"17d {name}: not finite {rec}")
        print(f"17d cell {name} at {grid}: ok {rec} peak_per_card={peaks} "
              f"reckoned_peak={reck[name]['peak_bytes']} "
              f"reckoned_args={reck[name]['argument_size_in_bytes']}", flush=True)
    v = part("kimi_serve")
    check(all(w["kimi_serve"]["finite"] for w in v), "17d kimi: logits not finite")
    check(all(w["kimi_serve"]["tokens"] == v[0]["kimi_serve"]["tokens"] for w in v),
          "17d kimi: the processes decoded different tokens")
    print(f"17d kimi_serve: ok {v[0]['kimi_serve']} "
          f"peak_per_card={[w['kimi_serve']['peak'] for w in v]}", flush=True)
    v = part("kimi_train")
    check(all(math.isfinite(w["kimi_train"]["loss"]) for w in v),
          "17d kimi: train loss not finite")
    print(f"17d kimi_train: ok {v[0]['kimi_train']} "
          f"peak_per_card={[w['kimi_train']['peak'] for w in v]}", flush=True)
    print(f"phase 17d seconds={time.perf_counter() - t0:.1f}", flush=True)


def digest(*tensors) -> str:
    """SHA-1 of the tensors' bytes, in order: equal digests, bitwise equal
    results."""
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def times_of(src: str) -> int:
    """``--times`` in one process: the kernels of the ``repro_torch`` under
    ``src``, one JSON line per shape and call form, with a digest of the
    form's outputs where it has them. GON ``call`` is the wrapper as its
    in-memory loop calls it (with a workspace and the next center into a
    slot where the wrapper takes them), ``iteration`` adds what else that
    loop ran on the card each step (the next center's gather ``x[rows,
    far]`` where the kernel did not write it); argmin ``fresh_carry`` is one
    launch on a fresh carry, ``engine`` the engine's call (the carry's fill,
    the launch, unpacking). The assign's ``engine`` form is
    ``engine.assign_nearest`` (``ASSIGN_SHAPES``), ``engine.fused_assign``
    (``STREAM_ASSIGN_SHAPES``) or ``engine.assign_nearest_batched``
    (``BATCHED_SHAPES``, phase 9's round 1 the last); ``sums`` adds integer
    row weights into per-cluster sums, by the sums entry where the tree has
    it, else by the kernel and ``index_add_`` as the weighted reducer and
    select_coreset did. ``representatives`` is in-memory select_coreset's
    per-center nearest row (kddlike n=400,000, k=100). The filter's forms
    (``FILTER_TIMES``) call ``engine.fused_filter(..., impl="kernel")``,
    their digest over ``(ds, tops)``; ``merge`` is ``engine.merge_top_k`` of
    one kddlike super-shard's rank-101 tops into a fresh carry, the
    per-block merge that follows each weighted filter launch. The pairwise
    kernel's ``engine`` form is ``engine.pairwise_dist2(x, c,
    impl="kernel")`` at every shape of ``PAIRWISE_SHAPES`` in f32 and f16,
    on float inputs; ``floor`` is an empty kernel's time by ``device_ms``
    in the same process."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(src))
    from repro_torch.data import pointsets as P
    from repro_torch.kernels import _build, engine, fused_argfar
    from repro_torch.kernels.fused_stream import argmin_carry, fused_argmin_cuda
    check("jax" not in sys.modules, "jax was imported")
    _build.build()
    rng = np.random.default_rng(0)
    out = []
    gon = fused_argfar.fused_min_argmax_cuda
    for m, per, d, gen in GON_SHAPES:
        xt = torch.from_numpy(generated(P, gen, m * per, d, 3)
                              .reshape(m, per, d)).cuda()
        md0 = (rng.random((m, per)) * 1e4).astype(np.float32)
        md0[:, ::7] = NEG
        md, ct = torch.from_numpy(md0).cuda(), xt[:, 11].contiguous()
        rows = torch.arange(m, device=xt.device)
        if hasattr(fused_argfar, "GonWorkspace"):
            ws = fused_argfar.GonWorkspace(m, xt.device)
            centers = torch.zeros((m, 2, d), device=xt.device)
            indices = torch.zeros((m, 2), dtype=torch.int32, device=xt.device)
            call = iteration = lambda: gon(xt, ct, md, ws=ws, centers=centers,
                                           indices=indices, slot=1)
        else:
            call = lambda: gon(xt, ct, md)
            iteration = lambda: xt[rows, gon(xt, ct, md)[2]]
        for form, fn in (("call", call), ("iteration", iteration)):
            out.append(dict(kernel="gon_step", shape=[m, per, d, gen], form=form,
                            ms=device_ms(torch, fn)))
    for n, m, d, gen in ARGMIN_SHAPES:
        xt = torch.from_numpy(P.GENERATORS[gen](n, d=d, seed=5)).cuda()
        ct = xt[torch.from_numpy(rng.choice(n, m, replace=False)).cuda()]
        fresh = iter([argmin_carry(m, xt.device) for _ in range(23)])
        for form, fn in (("fresh_carry", lambda: fused_argmin_cuda(xt, ct, next(fresh))),
                         ("engine", lambda: engine.fused_argmin(xt, ct, impl="kernel"))):
            out.append(dict(kernel="argmin_rows", shape=[n, m, d, gen], form=form,
                            ms=device_ms(torch, fn, reps=20, warmup=3)))
    folded = hasattr(engine, "assign_sums")
    shapes = ([("assign", engine.assign_nearest, (1,) + s) for s in ASSIGN_SHAPES]
              + [("fused_assign", engine.fused_assign, (1,) + s)
                 for s in STREAM_ASSIGN_SHAPES]
              + [("assign_batched", engine.assign_nearest_batched, s)
                 for s in BATCHED_SHAPES])
    for name, op, (m, n, k, d, gen) in shapes:
        x = generated(P, gen, m * n, d, 4)
        xt = torch.from_numpy(x.reshape(m, n, d) if name == "assign_batched" else x).cuda()
        pick = torch.from_numpy(rng.choice(n, k, replace=False)).cuda()
        ct = (xt[:, pick] if name == "assign_batched" else xt[pick]).contiguous()
        wt = torch.from_numpy(int_weights(rng, m * n).reshape(xt.shape[:-1])).cuda()

        def sums(op=op, xt=xt, ct=ct, wt=wt, m=m, k=k, batched=name == "assign_batched"):
            shape = (m, k) if batched else (k,)
            acc = torch.zeros(shape, dtype=torch.float32, device="cuda")
            if folded:
                return engine.assign_sums(xt, ct, acc, wt, impl="kernel")
            idx = op(xt, ct, impl="kernel")[0]
            if batched and m > 1:
                idx = idx + torch.arange(0, m * k, k, dtype=torch.int32,
                                         device=idx.device)[:, None]
            acc.view(-1).index_add_(0, idx.reshape(-1), wt.reshape(-1))
            return acc
        for form, fn in (("engine", lambda: op(xt, ct, impl="kernel")), ("sums", sums)):
            res = fn()
            out.append(dict(kernel=name, shape=[m, n, k, d, gen], form=form,
                            ms=device_ms(torch, fn),
                            digest=digest(*(res if form == "engine" else (res,)))))
    x = P.kddlike(400_000, seed=0)
    xt = torch.from_numpy(x).cuda()
    ct = xt[torch.from_numpy(rng.choice(400_000, 100, replace=False)).cuda()]
    fn = lambda: engine.argmin_dist2_over_rows(xt, ct, impl="kernel")
    out.append(dict(kernel="select_coreset", shape=[400_000, 100, 38, "kddlike"],
                    form="representatives", ms=device_ms(torch, fn, reps=10),
                    digest=digest(fn())))
    merged = None
    for form, n, k, d, rank, gen in FILTER_TIMES:
        xt = torch.from_numpy(P.GENERATORS[gen](n, d=d, seed=5)).cuda()
        ct = xt[torch.from_numpy(rng.choice(n, k, replace=False)).cuda()]
        ds0 = hm = wt = None
        if form == "eim":
            ds0 = torch.from_numpy((rng.random(n) * 5000).astype(np.float32)).cuda()
            hm = torch.from_numpy(rng.random(n) < 0.7).cuda()
        elif form == "weighted":
            wt = torch.from_numpy(int_weights(rng, n)).cuda()

        def filt(ds, xt=xt, ct=ct, hm=hm, wt=wt, rank=rank):
            return engine.fused_filter(xt, ct, ds, hm, rank=rank, w=wt, impl="kernel")
        ds_out, tops = filt(None if ds0 is None else ds0.clone())
        scratch = None if ds0 is None else ds0.clone()
        out.append(dict(kernel="fused_filter" if wt is None else "fused_filter_w",
                        shape=[n, k, d, rank, gen], form=form,
                        ms=device_ms(torch, lambda: filt(scratch)),
                        digest=digest(*(t for t in (ds_out, tops) if t is not None))))
        if form == "weighted" and (k, rank, gen) == (25, KZ_Z + 1, "kddlike"):
            merged = tops
    carry = engine.top_k_init(KZ_Z + 1, "cuda")
    fn = lambda: engine.merge_top_k(carry, merged, KZ_Z + 1)
    out.append(dict(kernel="merge_top_k", shape=list(merged.shape), form="merge",
                    ms=device_ms(torch, fn), digest=digest(fn())))
    prng = np.random.default_rng(7)
    for n, m, d in PAIRWISE_SHAPES:
        x = prng.normal(size=(n, d)).astype(np.float32)
        c = prng.normal(size=(m, d)).astype(np.float32)
        for dtype in (torch.float32, torch.float16):
            xt = torch.from_numpy(x).cuda().to(dtype)
            ct = torch.from_numpy(c).cuda().to(dtype)
            fn = lambda: engine.pairwise_dist2(xt, ct, impl="kernel")
            out.append(dict(kernel="pairwise", shape=[n, m, d, str(dtype).split(".")[1]],
                            form="engine", ms=device_ms(torch, fn), digest=digest(fn())))
    out.append(dict(kernel="empty_kernel", shape=[], form="floor",
                    ms=device_ms(torch, lambda: torch.cuda._sleep(1))))
    for row in out:
        print(json.dumps(dict(row, src=src)), flush=True)
    return 0


def compare_times(srcs) -> int:
    """``--times``: ``times_of`` for each tree in turn, then one line per
    shape and form with the trees' times in the order given, and their
    outputs' digests where the form has them (``same``: all equal)."""
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(), flush=True)
    runs = []
    for src in srcs:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--times-of", src], capture_output=True,
                              text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        runs.append([json.loads(line) for line in proc.stdout.splitlines()
                     if line.startswith("{")])
    for rows in zip(*runs):
        head = rows[0]
        note = ""
        if "digest" in head:
            digests = [r["digest"] for r in rows]
            note = (f" same={len(set(digests)) == 1} digests="
                    + ",".join(digests))
        print(f"{head['kernel']} {tuple(head['shape'])} {head['form']}: "
              + " ".join(f"{r['src']}={r['ms']:.5f}" for r in rows) + note, flush=True)
    return 0


def main() -> int:
    t_run = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    from repro_torch.core import mrg
    from repro_torch.data import pointsets as P
    from repro_torch.data.source import HostSource
    from repro_torch.kernels import _build, engine
    wrappers = kernel_counters()
    check("jax" not in sys.modules, "jax was imported")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    # the plain versions on the card use torch.matmul: keep it in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("== phase 1: build", flush=True)
    t0 = time.perf_counter()
    reports = _build.build()
    print(f"build: route=cuda (nvcc -> ctypes) sources={list(_build.SOURCES)} "
          f"compiled={sorted(reports)} seconds={time.perf_counter() - t0:.2f}",
          flush=True)
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    rng = np.random.default_rng(0)
    results = []
    phase_gon_step(torch, engine, P, rng, results)
    phase_assign(torch, P, rng, results, "assign", engine.assign_nearest,
                 ASSIGN_SHAPES, "== phase 2b: assign (assign.cu) against its "
                 "plain version", seed=4)
    assign_routing(torch, engine, P, rng)
    phase_filter(torch, engine, P, rng, results)
    phase_assign(torch, P, rng, results, "fused_assign", engine.fused_assign,
                 STREAM_ASSIGN_SHAPES, "== phase 2d: streamed assign "
                 "(fused_assign_cuda, assign.cu) against its plain version",
                 seed=5)
    assign_edge_cases(torch, engine, rng)
    phase_argmin(torch, engine, P, rng, results)
    phase_weighted_filter(torch, engine, P, rng, results)
    phase_batched_assign(torch, engine, P, rng, results)
    phase_pairwise(torch, engine, rng, results)
    pairwise_routing(torch, engine)
    pairwise_edge_cases(torch, engine, rng)
    alike = phase_eim_shapes(torch, engine, P, rng, results)
    phase_ring(torch, P)
    # each phase counts the kernels its paths may launch, so far
    def counting(*names):
        return {name: wrappers[name] for name in names}
    counters = counting("gon_step", "assign")
    totals = phase_mrg(torch, mrg, counters, P)
    phase_small_vs_cpu(torch, mrg, P)
    for gen, n, d, k in PROFILE_CONFIGS:
        phase_profile(torch, mrg, P, gen, n, d, k, wrappers["gon_step"])
    counters.update(counting("fused_filter", "fused_assign", "assign_sums",
                             "argmin_rows"))
    stream_totals = phase_streamed(torch, engine, P, counters)
    phase_stream_profile(torch, P)
    counters.update(counting("fused_filter_w", "assign_batched", "pairwise"))
    weighted_totals = phase_weighted(torch, engine, P, rng, counters)
    sketch_totals, sketch_states = phase_sketch(torch, P, counters)
    phase_kz_profile(torch, P, rng)
    phase_sketch_profile(torch, P)
    eim_totals = phase_eim(torch, engine, P, counters, alike)
    phase_eim_profile(torch, P)
    kdd_sketch = sketch_states[("kddlike n=4e6 d=38 host", "host")]
    serve_totals = phase_serve_shapes(torch, engine, P, rng, results, kdd_sketch)
    serve_ingest_totals = phase_serve(torch, engine, P, counters, kdd_sketch,
                                      HostSource(kdd_host(P)))
    mesh_totals = phase_mesh(torch, engine, P, counters)
    cluster_totals = phase_cluster(torch, P, counters)
    lm_totals = phase_lm(torch, engine, counters, results)
    phase_families(torch)
    phase_train(torch)
    phase_sharding(torch)

    # times at each path's first shape on float inputs — in memory: GON step
    # m=50, per=20000, d=2; assign n=1e6, k=25, d=2 (paper Fig. 4); streamed:
    # the filter at the unif super-shard (k=25, rank 1), assign and argmin at
    # the kddlike super-shard with the coreset's k=100; the weighted filter
    # at the kddlike super-shard with kz_center's k=25 and rank z + 1 = 101,
    # the batched assign at m=50, per=20000, t=125, d=2, the sums entry at
    # phase 9's round 1 (1 x 573,580 rows, t=125, d=38), pairwise at the
    # sketch's (101, 101, 38) bootstrap in f32. Launches: every launch of the
    # kernel's wrapper in the counted runs of phases 3, 5, 7, 8, 10, 12 and
    # 14 (14d's select_coreset), phase 13's workers' counted runs (each
    # counted in its own process), and
    # phase 11's deterministic ones (11a's assign_bucketed calls, 11c's
    # ingest), each counted once, by the wrapper that made it (the streamed and batched
    # assign's cluster sums take the sums entry: assign_sums, not
    # fused_assign or assign_batched). max_abs_err over every check of the
    # kernel.
    meta = {"gon_step": ("src/repro_torch/kernels/csrc/gon_step.cu",
                         "src/repro/kernels/fused_argfar.py:48", GON_SHAPES[0]),
            "assign": ("src/repro_torch/kernels/csrc/assign.cu",
                       "src/repro/kernels/assign.py:52", ASSIGN_SHAPES[0]),
            "fused_filter": ("src/repro_torch/kernels/csrc/fused_filter.cu",
                             "src/repro/kernels/fused_stream.py:106",
                             FILTER_SHAPES[0]),
            "fused_assign": ("src/repro_torch/kernels/csrc/assign.cu",
                             "src/repro/kernels/fused_stream.py:221",
                             STREAM_ASSIGN_SHAPES[2]),
            "argmin_rows": ("src/repro_torch/kernels/csrc/argmin_rows.cu",
                            "src/repro/kernels/fused_stream.py:285",
                            ARGMIN_SHAPES[2]),
            "fused_filter_w": ("src/repro_torch/kernels/csrc/fused_filter.cu",
                               "src/repro/kernels/fused_stream.py:166",
                               (573_580, 25, 38, KZ_Z + 1, "kddlike")),
            "assign_batched": ("src/repro_torch/kernels/csrc/assign.cu",
                               "src/repro/kernels/assign.py:52",
                               BATCHED_SHAPES[0]),
            "assign_sums": ("src/repro_torch/kernels/csrc/assign.cu",
                            "src/repro/kernels/assign.py:52", KZ_ROUND1),
            "pairwise": ("src/repro_torch/kernels/csrc/pairwise.cu",
                         "src/repro/kernels/pairwise.py:41",
                         PAIRWISE_SHAPES[0] + ("float32",))}
    kernels = []
    for name, (source, replaces, shape) in meta.items():
        mine = [r for r in results if r["kernel"] == name]
        main = next(r for r in mine if r["shape"] == shape and r["tier"] == "float")
        launches = sum(t.get(name, 0) for t in (totals, stream_totals,
                                                weighted_totals, sketch_totals,
                                                eim_totals, serve_totals,
                                                serve_ingest_totals, mesh_totals,
                                                cluster_totals, lm_totals))
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": max(r["err"] for r in mine),
                        "ms": main["ms"], "plain_ms": main["plain_ms"],
                        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                        "library_ms": main["library_ms"], "check": "pass"})
        if name == "pairwise":   # pairwise_plan's route at each shape of phase 2i
            kernels[-1]["routes"] = {"x".join(map(str, r["shape"][:3])) + " "
                                     + r["shape"][3]: r["route"]
                                     for r in mine if r["tier"] == "float"}
    print(f"chip_smoke seconds={time.perf_counter() - t_run:.1f}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def cluster_main(backend: str) -> int:
    """``--cluster nccl``: the kernels' build, then phase 13's cases over
    ``backend`` alone, each worker on a card of its own (13b takes 4)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    from repro_torch.data import pointsets as P
    from repro_torch.kernels import _build
    need = max(case["procs"] for case in CLUSTER_CASES.values())
    check(backend == "gloo" or torch.cuda.device_count() >= need,
          f"--cluster {backend} needs {need} cards, this host has "
          f"{torch.cuda.device_count()}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    _build.build()
    totals = phase_cluster(torch, P, kernel_counters(), backend)
    print(json.dumps({"cluster": backend, "launches": totals}), flush=True)
    phase_sharded_cluster(torch, backend)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cluster"] and len(sys.argv) == 3:
        sys.exit(cluster_main(sys.argv[2]))
    if sys.argv[1:2] == ["--times"] and len(sys.argv) > 2:
        sys.exit(compare_times(sys.argv[2:]))
    if sys.argv[1:2] == ["--times-of"] and len(sys.argv) == 3:
        sys.exit(times_of(sys.argv[2]))
    sys.exit(main())
