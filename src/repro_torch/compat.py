"""The multi-process runtime (port of the distributed half of
``repro.compat``).

The paper's machines as real processes: each process holds its own shards,
and the MapReduce rounds exchange host values between them, never rows in
bulk. The exchanges of ``mrg`` are O(k·S) values; EIM's filter rounds also
all-gather the updated ``d_s`` (``fetch_global``), n floats a round, as the
JAX package keeps ``d_s`` replicated on every process. The runtime is
``torch.distributed`` with a TCP rendezvous at a coordinator address
(``repro_torch.launch.cluster`` starts the processes):

  * ``distributed_initialize`` / ``distributed_shutdown`` bring the process
    group up and down; ``process_index`` and ``process_count`` read it
    (0 and 1 when no group exists, so callers never branch on the runtime);
  * ``exchange_host`` all-gathers one host value of every process, stacked
    in process order: the O(k) candidate exchange;
  * ``fetch_global`` assembles a value split into pieces by shard, each
    piece held by the process that owns the shard (EIM's ``d_s``: O(n));
  * ``local_shard_indices`` says which shards of a mesh this process owns.

The backend is the caller's choice and is never switched behind its back.
``gloo`` moves host tensors: it runs the CPU tests, and it runs several
processes that share one card (NCCL refuses two ranks on one GPU).
``nccl`` is accepted only where every process has a GPU of its own; the
exchanged values then go through that GPU.

The JAX package's ``global_array_from_shards`` and ``replicated_array``
have no counterpart: a torch tensor belongs to one process, so a step's
pieces stay local tensors, and where the JAX package assembles a global
array, the port exchanges host values.
"""
from __future__ import annotations

import datetime
import zlib

import numpy as np
import torch

BACKENDS = ("gloo", "nccl")


def _dist():
    import torch.distributed as dist
    return dist


def _active() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def distributed_initialize(coordinator_address: str, num_processes: int,
                           process_id: int, *, backend: str = "gloo",
                           timeout: float | None = None) -> None:
    """Join the process group of ``num_processes`` processes as
    ``process_id``, through the TCP rendezvous at ``coordinator_address``
    (``host:port``; process 0 listens there).

    ``timeout`` (seconds) bounds the rendezvous and every collective after
    it, so a process whose peer died fails instead of waiting for ever.
    ``backend="nccl"`` raises unless this host has a GPU for every process
    (``rank % device_count`` must name a card of its own); each process then
    works on ``cuda:{rank}``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    num_processes, process_id = int(num_processes), int(process_id)
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} out of range for "
                         f"{num_processes} processes")
    if backend == "nccl":
        gpus = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if gpus < num_processes:
            raise RuntimeError(
                f"backend='nccl' needs a GPU for every process: "
                f"{num_processes} processes, {gpus} GPU(s) here (NCCL refuses "
                "two ranks on one GPU); use backend='gloo'")
        torch.cuda.set_device(process_id)
    address = coordinator_address.removeprefix("tcp://")
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout))
    _dist().init_process_group(backend, init_method=f"tcp://{address}",
                               world_size=num_processes, rank=process_id,
                               **kwargs)


def distributed_shutdown() -> None:
    """Leave the process group; nothing to do when none exists."""
    if _active():
        _dist().destroy_process_group()


def process_index() -> int:
    """This process's rank (0 when no group exists)."""
    return _dist().get_rank() if _active() else 0


def process_count() -> int:
    """Processes in the group (1 when no group exists)."""
    return _dist().get_world_size() if _active() else 1


def exchange_host(x) -> np.ndarray:
    """All-gather a host value of every process: returns ``(P, ...)``, row
    ``p`` process p's ``x``. One process: ``x[None]``. A collective: every
    process calls it, with one shape and dtype."""
    arr = np.asarray(x)
    count = process_count()
    if count == 1:
        return arr[None]
    if arr.size == 0:
        return np.zeros((count,) + arr.shape, arr.dtype)
    dist = _dist()
    flat = np.ascontiguousarray(arr).reshape(-1)
    t = torch.from_numpy(flat.view(np.uint8) if arr.dtype == bool else flat)
    if dist.get_backend() == "nccl":      # through this process's GPU
        t = t.pin_memory().to(f"cuda:{torch.cuda.current_device()}",
                              non_blocking=True)
    out = [torch.empty_like(t) for _ in range(count)]
    dist.all_gather(out, t)
    got = torch.stack(out).cpu().numpy()
    if arr.dtype == bool:
        got = got.view(bool)
    return got.reshape((count,) + arr.shape)


def fetch_global(local_pieces) -> np.ndarray:
    """The full host value of a value split by shard: ``local_pieces`` has
    one entry a shard, this process's piece for the shards it owns and
    ``None`` for the others; pieces share their trailing shape and dtype and
    may differ in rows. Returns every shard's piece, concatenated in shard
    order, on every process. Each shard must have exactly one owner. A
    collective (two ``exchange_host`` calls: the piece sizes, then the
    pieces); one process: the concatenation, where no piece may be missing.
    """
    pieces = [None if p is None else np.asarray(p) for p in local_pieces]
    mine = [p for p in pieces if p is not None]
    if not mine:
        raise ValueError("fetch_global needs at least one local piece")
    if process_count() == 1:
        missing = [s for s, p in enumerate(pieces) if p is None]
        if missing:
            raise ValueError(
                f"pieces {missing} are None but the runtime is "
                "single-process — nobody can contribute them")
        return np.concatenate(mine)
    sizes = np.asarray([-1 if p is None else p.shape[0] for p in pieces],
                       np.int64)
    every = exchange_host(sizes)                     # (P, S)
    owners = (every >= 0).sum(axis=0)
    if (owners != 1).any():
        bad = np.nonzero(owners != 1)[0].tolist()
        raise ValueError(
            f"shards {bad} have {owners[bad].tolist()} owners; each shard "
            "needs exactly one process that holds its piece")
    totals = np.where(every >= 0, every, 0).sum(axis=1)
    buf = np.zeros((int(totals.max()),) + mine[0].shape[1:], mine[0].dtype)
    local = np.concatenate(mine)
    buf[:local.shape[0]] = local
    gathered = exchange_host(buf)                    # (P, max rows, ...)
    owner = np.argmax(every >= 0, axis=0)
    cursor = np.zeros(every.shape[0], np.int64)
    out = []
    for s, p in enumerate(owner.tolist()):
        rows = int(every[p, s])
        out.append(gathered[p, cursor[p]:cursor[p] + rows])
        cursor[p] += rows
    return np.concatenate(out)


def same_on_every_process(what: str, *values) -> None:
    """Raise, on every process alike, unless every process passed the same
    ``values`` (numbers or arrays, hashed): the guard in front of a
    collective whose arguments must agree, so that a mismatch fails on
    every process instead of leaving some of them waiting."""
    if process_count() == 1:
        return
    h = 0
    for v in values:
        h = zlib.crc32(np.ascontiguousarray(np.asarray(v)).tobytes(), h)
    every = exchange_host(np.asarray([h], np.int64))[:, 0]
    if (every != every[0]).any():
        raise RuntimeError(
            f"{what} was called with different arguments on different "
            f"processes (argument hashes {every.tolist()}): every process "
            "must make the same collective calls")


def local_shard_indices(mesh, num_shards: int) -> list:
    """The shards of ``mesh`` this process owns, sorted: shard ``s`` covers
    the mesh positions ``[s·per, (s+1)·per)`` in row-major order (``per``
    positions a shard), and is this process's where it owns one of them
    (``mesh.owners``)."""
    owners = np.asarray(mesh.owners).reshape(-1)
    num_shards = int(num_shards)
    if num_shards < 1 or owners.size % num_shards:
        raise ValueError(f"{num_shards} shards do not divide the mesh's "
                         f"{owners.size} positions")
    per = owners.size // num_shards
    me = process_index()
    return [s for s in range(num_shards)
            if (owners[s * per:(s + 1) * per] == me).any()]
