"""The multi-process launcher (port of ``repro.launch.cluster``).

``launch_cluster`` starts N local worker processes. Each joins one
``torch.distributed`` process group through a TCP rendezvous at process 0's
address (``compat.distributed_initialize``), loads a named *scenario*
function and runs it: every process runs the same driver over the cluster
mesh (``launch.mesh.make_cluster_mesh``) while it holds only its own shards
(``ProcessShardedSource.for_process``). That is the paper's MapReduce
machine model made literal: machines hold their partition, rounds exchange
O(k) candidates, and no process holds all n rows (EIM's filter rounds also
all-gather the n per-row distances ``d_s``, as the JAX package does).

Worker protocol
---------------

Workers are ``python -m repro_torch.launch.cluster --worker ...``. They
bootstrap in a fixed order: the scenario module is imported *before* the
process group comes up (a failure at import is a death before the group
exists, which the parent must report at once, not wait for), then the group
comes up with the backend asked for (``--backend``: ``gloo`` moves host
tensors and lets several processes share one card; ``nccl`` needs a GPU a
process), with the launcher's deadline as its timeout, so that a collective
whose peer died fails by itself. Then the scenario runs with a
``WorkerContext``. The dict it returns is printed as one ``CLUSTER-VERDICT
{...}`` line on stdout: the pipe is the only channel between parent and
child, so a hard kill leaves nothing to clean up. An exception at any stage
becomes an ``ok: false`` verdict with the traceback, and the worker leaves
by ``os._exit(1)``, past any handler that could wait on a dead peer.

Parent lifecycle
----------------

``launch_cluster`` reads every worker's pipe on a drain thread (so no pipe
fills up and blocks a child), optionally into a log file a worker, and
keeps two deadlines: a hard ``timeout``, after which every survivor is
killed, and an early exit: once any worker exits non-zero, the others get a
short grace (their own tracebacks beat "killed" in a report) and are then
killed. ``run_scenario`` adds the policy of the tests: it returns the
verdicts or raises ``ClusterError`` with each failed child's traceback.

Demo: ``PYTHONPATH=src python -m repro_torch.launch.cluster --demo -n 2``
runs ``mrg`` over 2 processes, each with a synthetic shard of its own, on
the card (``--device cpu`` for the CPU), and prints whether every process
got the same centers and radius.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

VERDICT_PREFIX = "CLUSTER-VERDICT "
# Seconds the other workers get after the first non-zero exit before they
# are killed: long enough for their own tracebacks to reach the pipe.
EARLY_EXIT_GRACE = 5.0
_SRC_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# parent side — spawn, drain, deadline, collect
# ---------------------------------------------------------------------------


def free_port() -> int:
    """A free TCP port on 127.0.0.1, chosen by the OS (bound for a moment,
    then released for process 0 to listen on)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclass
class WorkerResult:
    """One worker's outcome: exit status, parsed verdict, raw output."""
    process_id: int
    returncode: Optional[int]
    verdict: Optional[dict]
    output: str
    timed_out: bool = False
    killed: bool = False

    @property
    def ok(self) -> bool:
        return (self.returncode == 0 and self.verdict is not None
                and bool(self.verdict.get("ok", False)))


class ClusterError(RuntimeError):
    """A cluster run failed; the message carries every failed worker's
    traceback (or the tail of its output), and ``results`` every process's
    record."""

    def __init__(self, message: str, results: Sequence[WorkerResult]):
        super().__init__(message)
        self.results = list(results)


def worker_env(num_processes: int = 1) -> dict:
    """The environment of a worker: the caller's, with this checkout's
    ``src`` first on ``PYTHONPATH``, unbuffered output, gloo's sockets on
    the loopback device unless the caller chose one
    (``GLOO_SOCKET_IFNAME``), so a run on one host never opens a socket
    past 127.0.0.1, and unless the caller chose it, a share of the host's
    cores for each worker's CPU threads (``OMP_NUM_THREADS``): workers that
    each start a thread a core contend for the cores several times over."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC_DIR + os.pathsep + env.get("PYTHONPATH", "")
    env["PYTHONUNBUFFERED"] = "1"
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    cores = len(os.sched_getaffinity(0))
    env.setdefault("OMP_NUM_THREADS", str(max(1, cores // num_processes)))
    return env


def _drain(pipe, lines: list, log_fh) -> None:
    for line in iter(pipe.readline, ""):
        lines.append(line)
        if log_fh is not None:
            log_fh.write(line)
            log_fh.flush()
    pipe.close()


def _tail(text: str, n: int = 30) -> str:
    return "".join(text.splitlines(keepends=True)[-n:])


def launch_cluster(target: str, num_processes: int, *,
                   args: Optional[dict] = None,
                   timeout: float = 180.0,
                   coordinator_port: Optional[int] = None,
                   backend: str = "gloo",
                   device: Optional[str] = None,
                   log_dir: Optional[str] = None) -> list:
    """Start ``num_processes`` workers running ``target`` and collect their
    verdicts. Returns a ``WorkerResult`` a process, in process order; never
    raises on a worker's failure (``run_scenario`` raises).

    ``target`` is ``module:function`` or ``/path/to/file.py:function``.
    ``backend`` and ``device`` go to every worker (``device=None``: each
    worker's card). ``timeout`` is the hard wall-clock bound: survivors are
    killed at the deadline, and it is each process group's timeout too. The
    early exit kills the others ``EARLY_EXIT_GRACE`` seconds after the first
    non-zero exit, so one crashed worker fails the run in seconds, not
    after the whole timeout inside a dead collective.
    """
    if num_processes < 1:
        raise ValueError(f"num_processes must be >= 1, got {num_processes}")
    port = coordinator_port if coordinator_port is not None else free_port()
    coordinator = f"127.0.0.1:{port}"
    wenv = worker_env(num_processes)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)

    procs, buffers, threads, log_fhs = [], [], [], []
    for pid in range(num_processes):
        cmd = [sys.executable, "-m", "repro_torch.launch.cluster", "--worker",
               "--target", target, "--coordinator", coordinator,
               "--num-processes", str(num_processes),
               "--process-id", str(pid), "--backend", backend,
               "--timeout", str(timeout)]
        if device is not None:
            cmd += ["--device", str(device)]
        if args is not None:
            cmd += ["--args-json", json.dumps(args)]
        fh = (open(os.path.join(log_dir, f"worker-{pid}.log"), "w")
              if log_dir else None)
        p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, env=wenv)
        lines: list = []
        t = threading.Thread(target=_drain, args=(p.stdout, lines, fh),
                             daemon=True)
        t.start()
        procs.append(p)
        buffers.append(lines)
        threads.append(t)
        log_fhs.append(fh)

    deadline = time.monotonic() + timeout
    timed_out = [False] * num_processes
    killed = [False] * num_processes
    grace_deadline = None
    while True:
        rcs = [p.poll() for p in procs]
        if all(rc is not None for rc in rcs):
            break
        now = time.monotonic()
        if any(rc is not None and rc != 0 for rc in rcs):
            if grace_deadline is None:
                grace_deadline = min(deadline, now + EARLY_EXIT_GRACE)
            if now >= grace_deadline:
                for i, p in enumerate(procs):
                    if p.poll() is None:
                        p.kill()
                        killed[i] = True
                break
        if now >= deadline:
            for i, p in enumerate(procs):
                if p.poll() is None:
                    p.kill()
                    timed_out[i] = True
            break
        time.sleep(0.05)
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:  # pragma: no cover - kill lag
            pass
    for t in threads:
        t.join(timeout=5)
    for fh in log_fhs:
        if fh is not None:
            fh.close()

    results = []
    for pid, (p, lines) in enumerate(zip(procs, buffers)):
        out = "".join(lines)
        verdict = None
        for line in reversed(out.splitlines()):
            if line.startswith(VERDICT_PREFIX):
                try:
                    verdict = json.loads(line[len(VERDICT_PREFIX):])
                except json.JSONDecodeError:
                    verdict = None
                break
        results.append(WorkerResult(pid, p.returncode, verdict, out,
                                    timed_out=timed_out[pid],
                                    killed=killed[pid]))
    return results


def run_scenario(target: str, num_processes: int, **kwargs) -> list:
    """``launch_cluster`` with the tests' policy: every worker must exit 0
    with an ``ok`` verdict, else ``ClusterError`` is raised with each failed
    child's traceback. Returns the verdicts in process order."""
    results = launch_cluster(target, num_processes, **kwargs)
    if all(r.ok for r in results):
        return [r.verdict for r in results]
    parts = [f"cluster run of {target!r} failed "
             f"({sum(not r.ok for r in results)}/{len(results)} workers):"]
    for r in results:
        if r.ok:
            continue
        state = ("timed out (hard-killed)" if r.timed_out
                 else "killed after another worker failed" if r.killed
                 else f"exit {r.returncode}")
        parts.append(f"\n--- worker {r.process_id}: {state} ---")
        if r.verdict and r.verdict.get("traceback"):
            parts.append(r.verdict["traceback"].rstrip())
        elif r.output.strip():
            parts.append(_tail(r.output).rstrip())
        else:
            parts.append("(no output)")
    raise ClusterError("\n".join(parts), results)


# ---------------------------------------------------------------------------
# worker side — bootstrap, run, verdict
# ---------------------------------------------------------------------------


@dataclass
class WorkerContext:
    """What a scenario function receives: its place in the cluster, the
    backend and device it was started with (``device=None``: its card) and
    the launcher's scenario arguments."""
    process_id: int
    num_processes: int
    coordinator_address: str
    args: dict = field(default_factory=dict)
    backend: str = "gloo"
    device: Optional[str] = None


def load_target(target: str) -> Callable:
    """Resolve ``module:function`` or ``/path/to/file.py:function``."""
    mod_part, sep, fn_name = target.rpartition(":")
    if not sep:
        raise ValueError(
            f"target {target!r} must be 'module:function' or "
            "'/path/to/file.py:function'")
    if mod_part.endswith(".py"):
        import importlib.util
        spec = importlib.util.spec_from_file_location("cluster_scenario",
                                                      mod_part)
        if spec is None or spec.loader is None:
            raise ImportError(f"cannot load scenario file {mod_part!r}")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        import importlib
        module = importlib.import_module(mod_part)
    fn = getattr(module, fn_name, None)
    if not callable(fn):
        raise AttributeError(
            f"{mod_part!r} has no callable {fn_name!r}")
    return fn


def _emit_verdict(payload: dict) -> None:
    print(VERDICT_PREFIX + json.dumps(payload), flush=True)


def _worker_main(ns: argparse.Namespace) -> int:
    try:
        # 1) the scenario before the group: a failure at import is a death
        #    before the group exists, reported by its traceback at once
        fn = load_target(ns.target)
        # 2) the group, with the launcher's deadline as its timeout
        from repro_torch import compat
        compat.distributed_initialize(ns.coordinator, ns.num_processes,
                                      ns.process_id, backend=ns.backend,
                                      timeout=ns.timeout)
        ctx = WorkerContext(ns.process_id, ns.num_processes, ns.coordinator,
                            json.loads(ns.args_json or "{}"),
                            backend=ns.backend, device=ns.device)
        payload = fn(ctx) or {}
        payload.setdefault("ok", True)
        payload.setdefault("process_id", ns.process_id)
        _emit_verdict(payload)
        compat.distributed_shutdown()
        return 0
    except BaseException as e:  # noqa: BLE001 - the verdict is the report
        _emit_verdict({"ok": False, "process_id": ns.process_id,
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()})
        sys.stdout.flush()
        sys.stderr.flush()
        # leave at once: the verdict is on the pipe, and no exit handler
        # may wait on peers stuck in a dead collective
        os._exit(1)


# ---------------------------------------------------------------------------
# the built-in demo scenario
# ---------------------------------------------------------------------------


def demo_mrg(ctx: WorkerContext) -> dict:
    """``mrg`` over the processes: each holds one synthetic shard of its own
    (``unif``, its process id as the seed), the mesh spans every process,
    and round 1 streams only the local shard; every process gets the same
    centers and radius (the parent checks)."""
    from repro_torch.core import MeshExecutor, mrg
    from repro_torch.data import ProcessShardedSource, synthetic_source
    from repro_torch.launch.mesh import make_cluster_mesh

    n_per = int(ctx.args.get("n_per_process", 2048))
    k = int(ctx.args.get("k", 8))
    sizes = [n_per] * ctx.num_processes
    local = synthetic_source("unif", n_per, seed=ctx.process_id, d=3)
    source = ProcessShardedSource.for_process(local, sizes, ctx.process_id)
    mesh = make_cluster_mesh(device=ctx.device)
    res = mrg(source, k, executor=MeshExecutor(mesh, block_rows=512))
    return {"n": source.n, "k": k, "device": str(mesh.device),
            "radius": float(np.sqrt(np.float64(res.radius2.item()))),
            "centers": res.centers.cpu().numpy().tolist(),
            "rounds": res.rounds}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="multi-process torch.distributed launcher")
    ap.add_argument("--worker", action="store_true",
                    help="(internal) run as a cluster worker")
    ap.add_argument("--demo", action="store_true",
                    help="run the built-in mrg demo")
    ap.add_argument("-n", "--num-processes", type=int, default=2)
    ap.add_argument("--target", default=None,
                    help="scenario as module:function or file.py:function")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--device", default=None,
                    help="every worker's device (default: its card)")
    ap.add_argument("--coordinator", default=None,
                    help="(worker) process 0's host:port")
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--args-json", default=None,
                    help="the scenario's arguments (ctx.args), as JSON")
    ap.add_argument("--timeout", type=float, default=180.0)
    ns = ap.parse_args(argv)
    if ns.worker:
        if not ns.target or not ns.coordinator:
            ap.error("--worker requires --target and --coordinator")
        return _worker_main(ns)
    if not ns.demo and ns.target is None:
        ap.error("pass --demo or --target")
    target = ns.target or "repro_torch.launch.cluster:demo_mrg"
    try:
        verdicts = run_scenario(target, ns.num_processes, timeout=ns.timeout,
                                backend=ns.backend, device=ns.device,
                                args=json.loads(ns.args_json or "null"))
    except ClusterError as e:
        print(str(e), file=sys.stderr)
        return 1
    first = verdicts[0]
    agree = all(v.get("centers") == first.get("centers")
                and v.get("radius") == first.get("radius")
                for v in verdicts[1:])
    print(f"{ns.num_processes}-process {target}: "
          f"n={first.get('n')} k={first.get('k')} "
          f"radius={first.get('radius')} rounds={first.get('rounds')} "
          f"devices={[v.get('device') for v in verdicts]} "
          f"all-processes-agree={agree}")
    return 0 if agree else 1


if __name__ == "__main__":
    sys.exit(main())
