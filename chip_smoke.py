#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of MRG (paper Algorithm 1) on one GPU.

    python3 chip_smoke.py        # from the root of a checkout, one Hopper card

Phases, each of which raises on failure (nothing is caught):
  1. build  — compile every CUDA kernel of the path from src/repro_torch/
              kernels/csrc with nvcc, one process per source, in parallel;
  2. kernels — each kernel against its plain PyTorch version on the card at
              the path's shapes: bitwise on exact-arithmetic inputs (integer
              coordinates), within tolerance on float inputs; times from
              CUDA events with the device queue backed up, so they are
              device times and not host enqueue times;
  3. mrg    — ``repro_torch.core.mrg`` at paper scale (UNIF/GAU/UNB at
              n = 1e6, kddlike, pokerlike) with impl="auto": launch counts
              (reset just before each run, read just after), synchronising
              calls reported by torch.cuda.set_sync_debug_mode, wall time,
              and agreement with the same call at impl="ref" on the card and,
              on a small input, with the CPU;
  4. a profile of one mrg run (device busy share, time by kernel).

Prints the card's name and power limit, one JSON line describing every
kernel, and as its last line ``{"ok": true, "device": {...}}``. Exits non-zero
without a CUDA device, and where the repository's package is missing.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
GON_TOL = dict(rtol=1e-5, atol=0.0)        # tests/test_kernels.py
ASSIGN_TOL = dict(rtol=1e-4, atol=1e-4)    # tests/test_kernels.py
NEG = float(np.float32(-3.4e38))

# The path's shapes: GON step on m=50 machine blocks of per=20000 rows
# (n = 1e6, paper Fig. 4); assign over all n points (SimExecutor.radius2).
GON_SHAPES = [(50, 20_000, 2, "unif"), (50, 20_000, 38, "kddlike")]
ASSIGN_SHAPES = [(1_000_000, 25, 2, "unif"), (1_000_000, 100, 2, "unif"),
                 (400_000, 100, 38, "kddlike")]
MRG_CONFIGS = [("unif", 1_000_000, 2, 25), ("unif", 1_000_000, 2, 100),
               ("gau", 1_000_000, 2, 25), ("gau", 1_000_000, 2, 100),
               ("unb", 1_000_000, 2, 25), ("unb", 1_000_000, 2, 100),
               ("kddlike", 400_000, 38, 25), ("pokerlike", 25_010, 10, 25)]
PROFILE_CONFIGS = [("unif", 1_000_000, 2, 25), ("kddlike", 400_000, 38, 25)]


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


def bound(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def exact_points(rng, shape):
    # small integers: every f32 sum of the kernels is exact in any order
    return np.floor(rng.random(shape) * 50).astype(np.float32)


def phase_gon_step(torch, engine, P, rng, results):
    print("== phase 2a: GON step (gon_step.cu) against its plain version", flush=True)
    for m, per, d, gen in GON_SHAPES:
        for tier in ("exact", "float"):
            if tier == "exact":
                x = exact_points(rng, (m, per, d))
                md0 = np.floor(rng.random((m, per)) * 5000).astype(np.float32)
            else:
                x = P.GENERATORS[gen](m * per, d=d, seed=3).reshape(m, per, d)
                md0 = (rng.random((m, per)) * 1e4).astype(np.float32)
            md0[:, ::7] = NEG                  # masked rows
            xt = torch.from_numpy(x).cuda()
            ct = xt[:, 11].contiguous()
            md_t = torch.from_numpy(md0).cuda()
            got = engine.fused_min_argmax(xt, ct, md_t.clone(), impl="kernel")
            want = engine.fused_min_argmax(xt, ct, md_t.clone(), impl="ref")
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
            ms = device_ms(torch, lambda: engine.fused_min_argmax(
                xt, ct, md_t, impl="kernel"))
            plain = device_ms(torch, lambda: engine.fused_min_argmax(
                xt, ct, md_t, impl="ref"))
            nbytes = 4 * (m * per * d + m * d + 2 * m * per + 2 * m)
            b_ms, b_by = bound(nbytes, m * per * (3 * d + 2))
            print(f"gon_step m={m} per={per} d={d} {tier}: ok "
                  f"max_abs_err={err:.3g} kernel_ms={ms:.5f} plain_ms={plain:.5f} "
                  f"bound_ms={b_ms:.5f} ({b_by})", flush=True)
            results.append(dict(kernel="gon_step", shape=(m, per, d, gen),
                                tier=tier, err=err,
                                ms=ms, plain_ms=plain, bound_ms=b_ms,
                                bound_by=b_by, library_ms=None))


def phase_assign(torch, engine, P, rng, results):
    print("== phase 2b: assign (assign.cu) against its plain version", flush=True)
    for n, k, d, gen in ASSIGN_SHAPES:
        for tier in ("exact", "float"):
            x = (exact_points(rng, (n, d)) if tier == "exact"
                 else P.GENERATORS[gen](n, d=d, seed=4))
            xt = torch.from_numpy(x).cuda()
            ct = xt[torch.from_numpy(rng.choice(n, k, replace=False)).cuda()]
            got = engine.assign_nearest(xt, ct, impl="kernel")
            want = engine.assign_nearest(xt, ct, impl="ref")
            torch.cuda.synchronize()
            err = (got[1] - want[1]).abs().max().item()
            note = ""
            if tier == "exact":
                check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                      f"assign n={n} k={k} d={d} exact tier: not bitwise equal")
            else:
                # rtol applies to |x|^2 + |c|^2, the terms that cancel: the
                # clamped decomposition's rounding error scales with them, so
                # near a center d2 carries ~eps·|x|^2 in either version
                scale = (xt * xt).sum(1) + (ct * ct).sum(1)[want[0].long()]
                tol = ASSIGN_TOL["atol"] + ASSIGN_TOL["rtol"] * scale
                check(bool(((got[1] - want[1]).abs() <= tol).all()),
                      f"assign n={n} k={k} d={d}: d2 beyond tolerance ({err})")
                strict = int((~torch.isclose(got[1], want[1], **ASSIGN_TOL)).sum())
                two = torch.topk(engine.ref.pairwise_dist2(xt, ct), 2, dim=1,
                                 largest=False).values
                unique = (two[:, 1] - two[:, 0]) > 2 * tol
                check(torch.equal(got[0][unique], want[0][unique]),
                      f"assign n={n} k={k} d={d}: index differs where unique")
                note = (f" rows_beyond_rtol_atol_1e-4_of_d2={strict}"
                        f" rows_index_compared={int(unique.sum())}")
            ms = device_ms(torch, lambda: engine.assign_nearest(xt, ct, impl="kernel"))
            plain = device_ms(torch, lambda: engine.assign_nearest(xt, ct, impl="ref"))
            lib = device_ms(torch, lambda: torch.cdist(xt, ct).min(1))
            nbytes = 4 * (n * d + k * d + 2 * n)
            b_ms, b_by = bound(nbytes, n * k * (2 * d + 5) + 2 * d * (n + k))
            print(f"assign n={n} k={k} d={d} {tier}: ok max_abs_err={err:.3g} "
                  f"kernel_ms={ms:.5f} plain_ms={plain:.5f} library_ms={lib:.5f} "
                  f"(torch.cdist(x, c).min(1)) bound_ms={b_ms:.5f} ({b_by}){note}",
                  flush=True)
            results.append(dict(kernel="assign", shape=(n, k, d, gen),
                                tier=tier, err=err,
                                ms=ms, plain_ms=plain, bound_ms=b_ms,
                                bound_by=b_by, library_ms=lib))


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
        walls = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mrg(xt, k, m=50)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
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
              f"launches={launches} sync_warnings={len(syncs)}", flush=True)
    return totals


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


def phase_profile(torch, mrg, P, gen, n, d, k):
    print(f"== phase 4: profile of one mrg run ({gen} n={n} d={d} m=50 k={k})",
          flush=True)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    xt = torch.from_numpy(P.GENERATORS[gen](n, d=d, seed=0)).cuda()
    mrg(xt, k, m=50)
    torch.cuda.synchronize()
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
    by_name = {}
    for e in kernels:
        ms, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    for name, (ms, count) in sorted(by_name.items(), key=lambda r: -r[1][0])[:10]:
        print(f"  {ms:9.4f} ms  {count:6d}x  {name[:90]}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    from repro_torch.core import mrg
    from repro_torch.data import pointsets as P
    from repro_torch.kernels import _build, engine
    from repro_torch.kernels.assign import assign_nearest_cuda
    from repro_torch.kernels.fused_argfar import fused_min_argmax_cuda
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
    phase_assign(torch, engine, P, rng, results)
    counters = {"gon_step": fused_min_argmax_cuda, "assign": assign_nearest_cuda}
    totals = phase_mrg(torch, mrg, counters, P)
    phase_small_vs_cpu(torch, mrg, P)
    for gen, n, d, k in PROFILE_CONFIGS:
        phase_profile(torch, mrg, P, gen, n, d, k)

    # times at the main path's first shape (GON step m=50, per=20000, d=2;
    # assign n=1e6, k=25, d=2: paper Fig. 4) on float inputs;
    # max_abs_err over every check of the kernel
    meta = {"gon_step": ("src/repro_torch/kernels/csrc/gon_step.cu",
                         "src/repro/kernels/fused_argfar.py:48", GON_SHAPES[0]),
            "assign": ("src/repro_torch/kernels/csrc/assign.cu",
                       "src/repro/kernels/assign.py:52", ASSIGN_SHAPES[0])}
    kernels = []
    for name, (source, replaces, shape) in meta.items():
        mine = [r for r in results if r["kernel"] == name]
        main = next(r for r in mine if r["shape"] == shape and r["tier"] == "float")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": totals[name],
                        "max_abs_err": max(r["err"] for r in mine),
                        "ms": main["ms"], "plain_ms": main["plain_ms"],
                        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                        "library_ms": main["library_ms"], "check": "pass"})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
