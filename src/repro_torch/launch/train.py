"""Fault-tolerant training loop (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0_5b \\
        --smoke --steps 50 --ckpt-dir /tmp/ckpt --resume auto --device cpu

Without ``--device`` it trains on the card. The behaviours:
  * checkpoint/restart: atomic checkpoints every --ckpt-every steps;
    ``--resume auto`` restarts from the newest valid checkpoint; the data
    pipeline is a pure function of (seed, step), so the token stream
    resumes exactly.
  * restart policy: step exceptions (device loss, injected faults) trigger
    reload-from-checkpoint with bounded retries + backoff.
  * straggler watchdog: per-step wall-time is tracked; steps slower than
    ``factor ×`` the running median are counted and logged.
  * a mesh: ``--mesh elastic`` (the largest (data, model) grid over the
    live processes) or ``DxM``, one process a card, under the cluster
    launcher or ``torchrun``; the state is placed by the sharding rules
    and a checkpoint restores onto whatever mesh the restart has:

    python -m repro_torch.launch.cluster -n 4 --backend nccl \
        --target repro_torch.launch.train:cluster_main \
        --args-json '{"argv": ["--arch", "qwen2_0_5b", "--mesh", "2x2"]}'
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen2_0_5b --mesh 2x2
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config, schedule_for
from repro_torch.data import model_batch
from repro_torch.launch.mesh import make_elastic_mesh, make_process_mesh
from repro_torch.optim import make_optimizer, make_schedule
from repro_torch.sharding import use_mesh
from repro_torch.train import init_train_state, make_train_step


class StragglerWatchdog:
    """Flags steps slower than ``factor`` × running median."""

    def __init__(self, factor: float = 3.0, warmup: int = 3):
        self.times = []
        self.factor = factor
        self.warmup = warmup
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) <= self.warmup:
            return False
        med = float(np.median(self.times[self.warmup:]))
        if dt > self.factor * med:
            self.flagged += 1
            return True
        return False


class RestartPolicy:
    def __init__(self, max_restarts: int = 3, backoff_s: float = 0.5):
        self.max_restarts = max_restarts
        self.backoff_s = backoff_s
        self.restarts = 0

    def should_restart(self) -> bool:
        if self.restarts >= self.max_restarts:
            return False
        self.restarts += 1
        time.sleep(self.backoff_s * self.restarts)
        return True


def train_loop(cfg, *, steps: int, batch_size: int, seq_len: int,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 20,
               resume: str = "none", seed: int = 0,
               log_every: int = 10,
               fault_hook: Optional[Callable[[int], None]] = None,
               policy: Optional[RestartPolicy] = None,
               watchdog: Optional[StragglerWatchdog] = None,
               mesh=None, lr: float = 3e-4, schedule: str = "cosine",
               eval_every: int = 0, metrics_path: Optional[str] = None,
               device=None):
    """Runs training with restart-on-failure on ``device`` (None: the
    card), the learning rate warming up to ``lr`` and following
    ``schedule`` (``configs.schedule_for`` names an arch's), under
    ``mesh`` (a ``launch.mesh.Mesh`` of one process a position; its
    device is this process's) where one is given. Returns (state,
    history)."""
    with use_mesh(mesh):
        return _train_loop(
            cfg, steps=steps, batch_size=batch_size, seq_len=seq_len,
            ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, resume=resume, seed=seed,
            log_every=log_every, fault_hook=fault_hook, policy=policy,
            watchdog=watchdog, lr=lr, schedule=schedule, eval_every=eval_every,
            metrics_path=metrics_path,
            device=mesh.device if mesh is not None else device)


def _train_loop(cfg, *, steps, batch_size, seq_len, ckpt_dir, ckpt_every,
                resume, seed, log_every, fault_hook, policy, watchdog, lr,
                schedule, eval_every, metrics_path, device):
    policy = policy or RestartPolicy()
    watchdog = watchdog or StragglerWatchdog()
    opt = make_optimizer(cfg.optimizer,
                         make_schedule(schedule, peak=lr, warmup=max(steps // 10, 1),
                                       total=steps))
    step_fn = make_train_step(cfg, opt)
    history = []
    from repro_torch.train.metrics import MetricsLogger, make_eval_fn
    logger = MetricsLogger(metrics_path)
    eval_fn = make_eval_fn(cfg, batch_size=batch_size, seq_len=seq_len,
                           seed=seed) if eval_every else None

    def fresh_state():
        return init_train_state(cfg, opt, seed=seed, device=device)

    def load_or_init():
        if ckpt_dir and resume in ("auto", "must") and \
                latest_step(ckpt_dir) is not None:
            step, state = restore_checkpoint(ckpt_dir, fresh_state())
            print(f"[train] resumed from step {step}")
            return state, step
        if resume == "must":
            raise FileNotFoundError("resume=must but no checkpoint found")
        return fresh_state(), 0

    state, start = load_or_init()
    step = start
    while step < steps:
        try:
            if fault_hook is not None:
                fault_hook(step)
            batch = model_batch(cfg, batch_size, seq_len, seed=seed,
                                step=step)
            t0 = time.time()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            slow = watchdog.observe(dt)
            if step % log_every == 0 or slow:
                print(f"[train] step={step} loss={loss:.4f} "
                      f"dt={dt*1e3:.0f}ms"
                      + (" STRAGGLER" if slow else ""), flush=True)
            history.append({"step": step, "loss": loss, "dt": dt})
            logger.log(step, loss=loss, dt=dt,
                       grad_norm=metrics.get("grad_norm", 0.0),
                       lr=metrics.get("lr", 0.0))
            if eval_fn and step and step % eval_every == 0:
                ev = eval_fn(state["params"])
                logger.log(step, **ev)
                print(f"[eval] step={step} "
                      f"loss={ev['eval_loss']:.4f} "
                      f"ppl={ev['eval_ppl']:.2f}", flush=True)
            step += 1
            if ckpt_dir and step % ckpt_every == 0:
                save_checkpoint(ckpt_dir, step, state)
        except (FloatingPointError, RuntimeError, ValueError) as e:
            print(f"[train] step {step} failed: {e!r}")
            if not policy.should_restart():
                raise
            print(f"[train] restart {policy.restarts}/"
                  f"{policy.max_restarts} from checkpoint")
            state = None    # the failed step's state, before a fresh one
            state, step = load_or_init()
    if ckpt_dir:
        save_checkpoint(ckpt_dir, step, state)
    logger.close()
    return state, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", default="none",
                    choices=["none", "auto", "must"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="none",
                    help="none | elastic | DxM grid like 2x2 (one process a "
                         "position)")
    ap.add_argument("--eval-every", type=int, default=0)
    ap.add_argument("--metrics", default=None, help="JSONL metrics path")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    mesh = None
    if args.mesh != "none":
        _join_torchrun()
        if args.mesh == "elastic":
            mesh = make_elastic_mesh(device=args.device)
        else:
            d, m = (int(v) for v in args.mesh.split("x"))
            mesh = make_process_mesh((d, m), ("data", "model"),
                                     device=args.device)
    _, hist = train_loop(
        cfg, steps=args.steps, batch_size=args.batch, seq_len=args.seq,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        resume=args.resume, seed=args.seed, lr=args.lr,
        schedule=schedule_for(args.arch), mesh=mesh,
        eval_every=args.eval_every, metrics_path=args.metrics,
        device=args.device)
    if hist:
        first = np.mean([h["loss"] for h in hist[:5]])
        last = np.mean([h["loss"] for h in hist[-5:]])
        print(f"[train] done: loss {first:.4f} -> {last:.4f} "
              f"({len(hist)} steps)")


def _join_torchrun() -> None:
    """Join the process group ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) where
    none is up yet: NCCL where every process has a card, else gloo."""
    import os

    import torch
    import torch.distributed as dist
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return
    world = int(os.environ["WORLD_SIZE"])
    nccl = torch.cuda.is_available() and torch.cuda.device_count() >= world
    if nccl:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if nccl else "gloo", init_method="env://")


def cluster_main(ctx) -> dict:
    """``main`` as a ``repro_torch.launch.cluster`` scenario: the group is
    up, ``ctx.args["argv"]`` are the CLI's arguments (``--device`` from
    the launcher where they name none)."""
    argv = list(ctx.args.get("argv", []))
    if ctx.device is not None and "--device" not in argv:
        argv += ["--device", ctx.device]
    main(argv)
    return {}


if __name__ == "__main__":
    main()
