"""The port's multi-process runs (``repro_torch.launch.cluster``,
``repro_torch.compat``, ``ProcessShardedSource``, the multi-process
``MeshExecutor``) on the CPU, with gloo between real processes.

Every cluster test starts worker processes through ``run_scenario``, each
loading its scenario from this file (``test_torch_cluster.py:<name>``), so
this module imports no ``jax`` at module level: a worker never imports it.
The workers' results are held, in this pytest process, against

* the port's one-process executors over the same shards:
  ``HostStreamExecutor`` at the same ``block_rows``, and with one block a
  shard ``mrg_sim(m=2)`` and ``SimExecutor(m=2)``, bitwise;
* the JAX package's ``HostStreamExecutor`` and ``SimExecutor`` ``mrg`` and
  ``eim`` on the same numpy inputs (``impl="ref"``; JAX imported inside the
  test functions): bitwise on the exact tier (integer coordinates, every
  f32 sum exact) and, as ``tests/test_torch_mesh.py`` holds the streamed
  path, on these float inputs too.

The inputs are ``tests/distributed/test_multiprocess.py``'s: ``unif`` from
a seed, split by ``shard_source``'s ceil-split; each process reads a
``SliceSource`` of its own rows, regenerated locally.
"""
from __future__ import annotations

import functools
import os
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch import compat
from repro_torch.core import (HostStreamExecutor, MeshExecutor, SimExecutor,
                              eim, eim_sample, mrg, mrg_sim)
from repro_torch.data import (HostSource, ProcessShardedSource, SliceSource,
                              SyntheticSource, shard_source, synthetic_source)
from repro_torch.data.source import DEFAULT_PREFETCH, stream_device
from repro_torch.launch import ClusterError, make_cluster_mesh, run_scenario

HERE = os.path.dirname(os.path.abspath(__file__))
FAULTY_IMPORT = os.path.join(HERE, "distributed", "_faulty_import.py")
SEED = 7
EXACT_SIDE = 64            # integer coordinates in [0, 64): 3·63² < 2^24
# tests/distributed/test_multiprocess.py:37-38
PARITY = dict(n=6144, d=3, k=4, eim_k=2, eps=0.1, phi=8.0, key=0)
GRID = dict(n=6001, d=3, k=2, eps=0.1, phi=8.0, key=3, block_rows=512)
TIMEOUT = 120.0


# -- inputs, the same in every process and in the parent ---------------------

def base_source(n: int, d: int, tier: str):
    """The global input as a generator: ``unif`` from ``SEED``, floored onto
    the integer grid for the exact tier."""
    if tier == "float":
        return synthetic_source("unif", n, seed=SEED, d=d)
    grid = synthetic_source("unif", n, seed=SEED, d=d, side=EXACT_SIDE)

    def block_fn(start: int, rows: int) -> np.ndarray:
        return np.floor(grid.take(np.arange(start, start + rows)))

    return SyntheticSource(block_fn, n, d)


def points(n: int, d: int, tier: str) -> np.ndarray:
    return base_source(n, d, tier).take(np.arange(n))


def split_offsets(n: int, parts: int) -> list:
    """``shard_source``'s split: part i is rows ``[i·per, min((i+1)·per,
    n))``, ``per = ceil(n / parts)``; the last part is ragged where parts
    does not divide n."""
    per = -(-n // parts)
    return [min(i * per, n) for i in range(parts + 1)]


class SpySource:
    """This process's shard, recording every read: the largest block, the
    blocks read, the rows gathered by ``take`` (at most at once and in
    all), and any ``materialize`` (which raises)."""

    def __init__(self, inner):
        self._inner = inner
        self.max_block_rows = 0
        self.blocks_read = 0
        self.take_rows = 0
        self.max_take_rows = 0
        self.materialize_calls = 0

    @property
    def n(self):
        return self._inner.n

    @property
    def d(self):
        return self._inner.d

    def host_blocks(self, block_rows):
        for b in self._inner.host_blocks(block_rows):
            self.blocks_read += 1
            self.max_block_rows = max(self.max_block_rows, int(b.shape[0]))
            yield b

    def blocks(self, block_rows, *, prefetch=DEFAULT_PREFETCH, device=None):
        return stream_device(self.host_blocks(block_rows), prefetch, device)

    def take(self, indices):
        idx = np.asarray(indices).reshape(-1)
        self.take_rows += int(idx.size)
        self.max_take_rows = max(self.max_take_rows, int(idx.size))
        return self._inner.take(idx)

    def row(self, idx):
        return self.take([idx])[0]

    def materialize(self, device=None):
        self.materialize_calls += 1
        raise RuntimeError("spy: a local shard was materialized")

    def report(self) -> dict:
        return {"local_n": int(self.n),
                "max_block_rows": int(self.max_block_rows),
                "blocks_read": int(self.blocks_read),
                "take_rows": int(self.take_rows),
                "max_take_rows": int(self.max_take_rows),
                "materialize_calls": int(self.materialize_calls)}


def build_sharded(ctx, n: int, d: int, tier: str):
    """This process's view of the partition: a spied ``SliceSource`` of the
    common generator for its own rows, ``RemoteShard``s elsewhere."""
    offs = split_offsets(n, ctx.num_processes)
    sizes = [offs[i + 1] - offs[i] for i in range(ctx.num_processes)]
    pid = ctx.process_id
    spy = SpySource(SliceSource(base_source(n, d, tier), offs[pid],
                                offs[pid + 1]))
    return ProcessShardedSource.for_process(spy, sizes, pid), spy


def _f32(t) -> list:
    return np.asarray(t, np.float32).tolist()


def _idx(mask) -> list:
    return np.nonzero(np.asarray(mask))[0].tolist()


# -- scenarios: run inside every worker process ------------------------------

def parity(ctx) -> dict:
    """``mrg`` and streamed ``eim`` over the cluster mesh on both tiers at
    each of ``block_rows``, each process feeding only its own shard."""
    a = ctx.args
    mesh = make_cluster_mesh(device=ctx.device)
    out = {"jax_imported": "jax" in sys.modules}
    for rows in a["block_rows"]:
        ex = MeshExecutor(mesh, block_rows=int(rows))
        for tier in ("exact", "float"):
            src, spy = build_sharded(ctx, int(a["n"]), int(a["d"]), tier)
            m = mrg(src, int(a["k"]), executor=ex)
            e = eim(src, int(a["eim_k"]), int(a["key"]), eps=float(a["eps"]),
                    phi=float(a["phi"]), executor=ex)
            out[f"{tier}{rows}"] = {
                "mrg_centers": _f32(m.centers),
                "mrg_radius2": m.radius2.item(), "mrg_rounds": m.rounds,
                "eim_centers": _f32(e.centers),
                "eim_radius2": e.radius2.item(),
                "eim_iters": int(e.sample.iters),
                "sample_idx": _idx(e.sample.sample_mask),
                "s_idx": _idx(e.sample.s_mask)}
            out[f"spy_{tier}{rows}"] = spy.report()
    return out


def eim_draws(ctx) -> dict:
    """EIM's sample alone: its draws are keyed by the global row, so the
    sample is the same for any process count."""
    a = ctx.args
    src, spy = build_sharded(ctx, int(a["n"]), int(a["d"]), "float")
    ex = MeshExecutor(make_cluster_mesh(device=ctx.device),
                      block_rows=int(a["block_rows"]))
    s = eim_sample(src, int(a["k"]), int(a["key"]), eps=float(a["eps"]),
                   phi=float(a["phi"]), executor=ex)
    return {"sample_idx": _idx(s.sample_mask), "s_idx": _idx(s.s_mask),
            "iters": int(s.iters), "overflow": int(s.overflow),
            "sampled": bool(s.sampled), "spy_float": spy.report()}


def primitives(ctx) -> dict:
    """The exchange primitives, the cluster mesh and the collective
    ``take`` between real processes."""
    me, count = compat.process_index(), compat.process_count()
    meshes = {spp: make_cluster_mesh(shards_per_process=spp,
                                     device=ctx.device) for spp in (1, 2)}
    local = {spp: compat.local_shard_indices(m, m.shape["data"])
             for spp, m in meshes.items()}
    # ragged pieces, one a shard of the 2-a-process mesh, each held by its
    # owner only
    pieces = [np.full((s + 1, 2), s, np.int64) if s in local[2] else None
              for s in range(2 * count)]
    fetched = compat.fetch_global(pieces)
    want = np.concatenate([np.full((s + 1, 2), s, np.int64)
                           for s in range(2 * count)])
    exchanged = compat.exchange_host(np.asarray([me, 10 * me], np.float32))
    flags = compat.exchange_host(np.asarray([me % 2 == 0, True]))
    # the collective take: the global rows, each from its owner
    x = np.arange(40 * 3, dtype=np.float32).reshape(40, 3)
    offs = split_offsets(40, count)
    src = ProcessShardedSource.for_process(
        HostSource(x[offs[me]:offs[me + 1]]),
        [offs[i + 1] - offs[i] for i in range(count)], me)
    idx = np.asarray([39, 0, 21, 20, 7, 7])
    took = src.take(idx)
    mismatch = ""
    try:              # a take whose rows differ between processes
        src.take([me])
    except RuntimeError as e:
        mismatch = str(e)
    return {"process_index": me, "process_count": count,
            "owners": {str(spp): m.owners.tolist() for spp, m in meshes.items()},
            "processes": {str(spp): m.processes for spp, m in meshes.items()},
            "devices": [str(m.device) for m in meshes.values()],
            "local": {str(spp): ids for spp, ids in local.items()},
            "fetched": bool(np.array_equal(fetched, want)),
            "exchanged": exchanged.tolist(), "flags": flags.tolist(),
            "take": bool(np.array_equal(took, x[idx])),
            "row": bool(np.array_equal(src.row(33), x[33])),
            "local_shard_ids": list(src.local_shard_ids),
            "take_mismatch": mismatch}


def crash_mid_round(ctx) -> dict:
    """One process dies after a collective; the other waits in the next
    collective until the launcher reaps it."""
    x = compat.exchange_host(np.float32([ctx.process_id]))
    if ctx.process_id == int(ctx.args.get("crash_on", 1)):
        raise RuntimeError("boom mid-round (scenario-injected fault)")
    compat.exchange_host(np.float32([float(x.sum())]))
    return {"pid": int(ctx.process_id)}


# -- the tests ----------------------------------------------------------------

def _run(name: str, procs: int, args=None, **kwargs) -> list:
    return run_scenario(f"{os.path.abspath(__file__)}:{name}", procs,
                        args=args, device="cpu", timeout=TIMEOUT, **kwargs)


def _same_everywhere(verdicts, per_process=("process_id", "ok")):
    """Every process reports the same bits, its spy aside."""
    def shared(v):
        return {k: w for k, w in v.items()
                if k not in per_process and not k.startswith("spy")}
    for v in verdicts[1:]:
        assert shared(v) == shared(verdicts[0])


def _check_spy(spy: dict, block_rows: int) -> None:
    """No process held more than its own shard: it streamed blocks of at
    most ``block_rows``, never materialized, and gathered fewer rows at
    once than its shard holds."""
    assert spy["materialize_calls"] == 0
    assert spy["blocks_read"] > 0
    assert 0 < spy["max_block_rows"] <= block_rows
    assert spy["max_take_rows"] < spy["local_n"]


def _same(got: dict, centers, r2) -> None:
    np.testing.assert_array_equal(np.asarray(got[0], np.float32),
                                  np.asarray(centers, np.float32))
    assert np.float32(got[1]) == np.float32(float(r2))


def _check_eim(v: dict, e) -> None:
    _same((v["eim_centers"], v["eim_radius2"]), e.centers, e.radius2)
    assert v["eim_iters"] == int(e.sample.iters)
    assert v["sample_idx"] == _idx(e.sample.sample_mask)
    assert v["s_idx"] == _idx(e.sample.s_mask)


PARITY_ROWS = {"512": 512, "per": PARITY["n"] // 2}


@functools.lru_cache(maxsize=None)
def _parity_verdicts() -> list:
    """One 2-process run of ``parity`` at both blockings, for both tests."""
    return _run("parity", 2, args=dict(
        PARITY, block_rows=list(PARITY_ROWS.values())))


@pytest.mark.parametrize("blocking", list(PARITY_ROWS))
def test_two_process_mrg_and_eim_bitwise(blocking):
    """2-process ``mrg`` and streamed ``eim``, bitwise the port's
    ``HostStreamExecutor`` over the same shards at the same block_rows, and
    with one block a shard ``mrg_sim(m=2)`` and ``SimExecutor(m=2)``; then
    the JAX package's executors on the same numpy inputs."""
    import jax
    import jax.numpy as jnp

    from repro.core import HostStreamExecutor as JHostStreamExecutor
    from repro.core import SimExecutor as JSimExecutor
    from repro.core import eim as jeim
    from repro.core import mrg as jmrg
    from repro.core import mrg_sim as jmrg_sim
    from repro.data import HostSource as JHostSource
    from repro.data import source as jsource

    p = PARITY
    rows = PARITY_ROWS[blocking]
    verdicts = _parity_verdicts()
    _same_everywhere(verdicts)
    assert not any(v["jax_imported"] for v in verdicts)
    key = jax.random.PRNGKey(p["key"])
    for tier in ("exact", "float"):
        for v in verdicts:
            _check_spy(v[f"spy_{tier}{rows}"], rows)
        v = verdicts[0][f"{tier}{rows}"]
        got_mrg = (v["mrg_centers"], v["mrg_radius2"])
        x = points(p["n"], p["d"], tier)
        host = HostStreamExecutor(block_rows=rows, device="cpu")
        src = shard_source(base_source(p["n"], p["d"], tier), 2)
        m = mrg(src, p["k"], executor=host)
        _same(got_mrg, m.centers, m.radius2)
        assert v["mrg_rounds"] == m.rounds
        _check_eim(v, eim(src, p["eim_k"], p["key"], eps=p["eps"],
                          phi=p["phi"], executor=host))
        jhost = JHostStreamExecutor(block_rows=rows)
        jsrc = jsource.shard_source(JHostSource(x), 2)
        jm = jmrg(jsrc, p["k"], impl="ref", executor=jhost)
        _same(got_mrg, jm.centers, jm.radius2)
        _check_eim(v, jeim(jsrc, p["eim_k"], key, eps=p["eps"], phi=p["phi"],
                           impl="ref", executor=jhost))
        if blocking != "per":
            continue
        # one block a shard: the simulated machines' blocking
        sim = mrg_sim(x, p["k"], m=2, device="cpu")
        _same(got_mrg, sim.centers, sim.radius2)
        _check_eim(v, eim(x, p["eim_k"], p["key"], eps=p["eps"],
                          phi=p["phi"], executor=SimExecutor(2, device="cpu")))
        jsim = jmrg_sim(jnp.asarray(x), p["k"], m=2, impl="ref")
        _same(got_mrg, jsim.centers, jsim.radius2)
        _check_eim(v, jeim(x, p["eim_k"], key, eps=p["eps"], phi=p["phi"],
                           impl="ref", executor=JSimExecutor(m=2)))


@functools.lru_cache(maxsize=None)
def _grid_reference():
    """GRID's sample by the port's and the JAX package's
    ``HostStreamExecutor`` over the 2-way split, once a module."""
    import jax

    from repro.core import HostStreamExecutor as JHostStreamExecutor
    from repro.core import eim_sample as jeim_sample
    from repro.data import HostSource as JHostSource
    from repro.data import source as jsource

    g = GRID
    src = shard_source(base_source(g["n"], g["d"], "float"), 2)
    ref = eim_sample(src, g["k"], g["key"], eps=g["eps"], phi=g["phi"],
                     executor=HostStreamExecutor(block_rows=g["block_rows"],
                                                 device="cpu"))
    x = points(g["n"], g["d"], "float")
    want = jeim_sample(jsource.shard_source(JHostSource(x), 2), g["k"],
                       jax.random.PRNGKey(g["key"]), eps=g["eps"],
                       phi=g["phi"], impl="ref",
                       executor=JHostStreamExecutor(
                           block_rows=g["block_rows"]))
    assert _idx(ref.sample_mask) == _idx(want.sample_mask)
    assert _idx(ref.s_mask) == _idx(want.s_mask)
    assert int(ref.iters) == int(want.iters)
    return ref


@pytest.mark.parametrize("procs", [1, 2, 4])
def test_eim_draws_across_process_counts(procs):
    """EIM's draws are keyed by the global row: 1, 2 and 4 processes (a
    ragged last shard for 2 and 4) give the one-process sample, itself the
    JAX package's."""
    ref = _grid_reference()
    assert 0 < len(_idx(ref.sample_mask)) < GRID["n"], "the loop must engage"
    verdicts = _run("eim_draws", procs, args=GRID)
    _same_everywhere(verdicts)
    for v in verdicts:
        assert v["sample_idx"] == _idx(ref.sample_mask), f"P={procs}"
        assert v["s_idx"] == _idx(ref.s_mask)
        assert v["iters"] == int(ref.iters)
        assert v["overflow"] == int(ref.overflow)
        assert v["sampled"] == bool(ref.sampled)
        _check_spy(v["spy_float"], GRID["block_rows"])


def test_exchange_primitives_and_cluster_mesh():
    """``exchange_host``, ``fetch_global`` and ``local_shard_indices``
    across two processes; ``make_cluster_mesh`` ownership at 1 and 2 shards
    a process; the collective ``take`` and ``row``, and a take whose rows
    differ between processes raising on both."""
    verdicts = _run("primitives", 2)
    for pid, v in enumerate(verdicts):
        assert (v["process_index"], v["process_count"]) == (pid, 2)
        assert v["owners"] == {"1": [0, 1], "2": [0, 0, 1, 1]}
        assert v["processes"] == {"1": 2, "2": 2}
        assert v["devices"] == ["cpu", "cpu"]
        assert v["local"] == {"1": [pid], "2": [2 * pid, 2 * pid + 1]}
        assert v["fetched"] and v["take"] and v["row"]
        assert v["exchanged"] == [[0.0, 0.0], [1.0, 10.0]]
        assert v["flags"] == [[True, True], [False, True]]
        assert v["local_shard_ids"] == [pid]
        assert "different arguments on different processes" in \
            v["take_mismatch"]


def test_one_process_runtime():
    """With no process group: index 0 of 1, ``exchange_host`` is ``x[None]``,
    ``fetch_global`` the concatenation (a missing piece raises), every shard
    local, the cluster mesh one process's, shutdown a no-op; ``nccl``
    without a GPU a process raises before any rendezvous."""
    assert (compat.process_index(), compat.process_count()) == (0, 1)
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_array_equal(compat.exchange_host(x), x[None])
    np.testing.assert_array_equal(
        compat.fetch_global([x, x[:1]]), np.concatenate([x, x[:1]]))
    with pytest.raises(ValueError, match="single-process"):
        compat.fetch_global([x, None])
    mesh = make_cluster_mesh(shards_per_process=3, device="cpu")
    assert mesh.owners.tolist() == [0, 0, 0] and mesh.processes == 1
    assert compat.local_shard_indices(mesh, 3) == [0, 1, 2]
    compat.same_on_every_process("nothing", x)
    compat.distributed_shutdown()
    with pytest.raises(ValueError, match="single sharding axis"):
        make_cluster_mesh(("a", "b"), device="cpu")
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="GPU for every process"):
            compat.distributed_initialize("127.0.0.1:1", 2, 0,
                                          backend="nccl")
    with pytest.raises(ValueError, match="backend"):
        compat.distributed_initialize("127.0.0.1:1", 2, 0, backend="mpi")


def test_worker_dies_before_the_group():
    """A scenario module that raises at import kills every worker before
    the group comes up; the parent reports the traceback at once."""
    t0 = time.monotonic()
    with pytest.raises(ClusterError) as ei:
        run_scenario(FAULTY_IMPORT + ":never", 2, device="cpu",
                     timeout=TIMEOUT)
    elapsed = time.monotonic() - t0
    msg = str(ei.value)
    assert "boom at import" in msg and "RuntimeError" in msg
    assert elapsed < 60, f"the fault took {elapsed:.0f} s to surface"
    assert all(not r.ok for r in ei.value.results)
    assert not any(r.timed_out for r in ei.value.results)


def test_worker_raises_mid_round():
    """One worker raises between collectives; the other, waiting in a dead
    collective, is reaped by the early exit, and the report carries the
    crashed worker's traceback."""
    t0 = time.monotonic()
    with pytest.raises(ClusterError) as ei:
        _run("crash_mid_round", 2, args={"crash_on": 1})
    elapsed = time.monotonic() - t0
    assert "boom mid-round" in str(ei.value)
    assert elapsed < 60, f"the fault took {elapsed:.0f} s to surface"
    crashed = ei.value.results[1]
    assert crashed.returncode not in (0, None) and not crashed.timed_out
    assert not any(r.timed_out for r in ei.value.results)
