"""The port's mesh (``MeshExecutor``, ``mrg_distributed``, the sharded
sources, ``engine.zip_shard_blocks``) against the JAX package, on the CPU.

The same numpy inputs go through ``repro`` (``impl="ref"``) and
``repro_torch`` (``device="cpu"``, its plain versions).

* The streamed path is held bitwise (centers, ``radius2``, rounds) against
  the port's ``HostStreamExecutor`` and the JAX package's, run in this
  process, at the same ``block_rows``; with one block a shard also against
  both packages' ``mrg_sim(m=S)``. EIM and the weighted and outlier runs
  are held bitwise against the port's ``HostStreamExecutor``.
* The fused path needs a JAX mesh of 8 devices: one module-scoped fixture
  runs the JAX package in a subprocess with
  ``--xla_force_host_platform_device_count=8`` (as tests/test_distributed.py
  does) and writes its arrays to a temporary directory. The port is held
  bitwise on the exact tier (small integer coordinates, every f32 sum
  exact in any order) and, on float inputs, to the same centers and
  ``radius2`` at rtol 1e-6: the JAX fused path runs GON under ``jit``,
  where XLA contracts the direct form into an FMA (one ulp; ROADMAP §3).
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat as jcompat
from repro.core import HostStreamExecutor as JHostStreamExecutor
from repro.core import MeshExecutor as JMeshExecutor
from repro.core import eim as jeim
from repro.core import mrg as jmrg
from repro.core import mrg_sim as jmrg_sim
from repro.data import HostSource as JHostSource
from repro.data import WeightedSource as JWeightedSource
from repro.data import source as jsource
from repro.kernels import engine as jengine
from repro_torch.core import (HostStreamExecutor, MeshExecutor, Objective, eim,
                              eim_sample, kz_center, mrg, mrg_distributed,
                              mrg_sim, select_coreset)
from repro_torch.core.executor import gon_block_fn
from repro_torch.data import (HostSource, ShardedSource, SliceSource,
                              WeightedSource, shard_source, synthetic_source)
from repro_torch.kernels import engine, ops
from repro_torch.launch import Mesh, all_gather, make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R2_RTOL = 1e-6                       # tests/test_torch_mrg.py (radius2)


def _mesh(shape, axes=("data",)):
    return make_mesh(shape, axes, device="cpu")


def _same_mrg(a, b):
    """Bitwise centers and radius2, and the same rounds."""
    np.testing.assert_array_equal(np.asarray(a.centers), np.asarray(b.centers))
    assert float(a.radius2) == float(b.radius2)
    assert a.rounds == b.rounds


# -- the streamed path: bitwise HostStreamExecutor and mrg_sim ---------------

N, D, K = 4096, 3, 5
_X = np.random.default_rng(2).normal(size=(N, D)).astype(np.float32)


@pytest.mark.parametrize("S", [1, 2, 4, 8])
@pytest.mark.parametrize("rows", ["512", "per"])
def test_streamed_grid_matches_host_stream(S, rows):
    per = N // S
    r = per if rows == "per" else 512
    got = mrg(shard_source(HostSource(_X), S), K,
              executor=MeshExecutor(_mesh((S,)), block_rows=r))
    assert got.rounds == 2
    _same_mrg(got, mrg(HostSource(_X), K, executor=HostStreamExecutor(
        block_rows=r, device="cpu")))
    _same_mrg(got, jmrg(JHostSource(_X), K, impl="ref",
                        executor=JHostStreamExecutor(block_rows=r)))
    if r == per:        # one block a shard: the simulated machines' blocking
        _same_mrg(got, mrg_sim(_X, K, m=S, device="cpu"))
        _same_mrg(got, jmrg_sim(jnp.asarray(_X), K, m=S, impl="ref"))


def test_streamed_two_axes_matches_host_stream():
    ex = MeshExecutor(_mesh((2, 2), ("pod", "data")),
                      shard_axes=("pod", "data"), block_rows=512)
    assert ex.num_shards == 4
    got = mrg(shard_source(HostSource(_X), ex), K, executor=ex)
    _same_mrg(got, mrg(HostSource(_X), K, executor=HostStreamExecutor(
        block_rows=512, device="cpu")))
    _same_mrg(got, jmrg(JHostSource(_X), K, impl="ref",
                        executor=JHostStreamExecutor(block_rows=512)))


def test_streamed_launch_plan(monkeypatch):
    """Round 1 is one GON batch a step over the S blocks: k launches of
    the GON step a step, not k a block (counted on the plain route)."""
    calls = []
    real = ops.fused_min_argmax

    def counted(x, *a, **kw):
        calls.append(tuple(x.shape))
        return real(x, *a, **kw)

    monkeypatch.setattr(ops, "fused_min_argmax", counted)
    ex = MeshExecutor(_mesh((4,)), block_rows=512)
    centers, valid = ex.run_blocks(gon_block_fn(K),
                                   shard_source(HostSource(_X), 4))
    steps = (N // 4) // 512
    assert len(calls) == K * steps and set(calls) == {(4, 512, D)}
    assert tuple(centers.shape) == (4 * steps * K, D) and bool(valid.all())


# -- EIM over per-host shards, under a per-shard budget ----------------------

class SpyShard(HostSource):
    """A host shard that records its largest block read, its ``take``
    sizes, and whether it was materialized."""

    def __init__(self, x):
        super().__init__(x)
        self.max_block = 0
        self.takes = []
        self.materialized = False

    def host_blocks(self, block_rows):
        for blk in super().host_blocks(block_rows):
            self.max_block = max(self.max_block, blk.shape[0])
            yield blk

    def take(self, indices):
        out = super().take(indices)
        self.takes.append(out.shape[0])
        return out

    def materialize(self, device=None):
        self.materialized = True
        return super().materialize(device)


def test_eim_sharded_matches_host_stream(record_property):
    n, d, k, key, budget = 16_384, 3, 4, 7, 96 * 1024
    x = np.random.default_rng(3).normal(size=(n, d)).astype(np.float32)
    shards = [SpyShard(x[i * 4096:(i + 1) * 4096]) for i in range(4)]
    sh = ShardedSource.from_per_host_shards(shards)
    me = MeshExecutor(_mesh((4,)), memory_budget=budget)
    rows = me.rows_for(sh)
    assert rows * 4 * (d + 1) * (1 + me.prefetch) <= budget
    got = eim(sh, k, key, executor=me)
    assert all(s.max_block <= rows for s in shards), [s.max_block for s in shards]
    assert not any(s.materialized for s in shards)
    # EIM's final gather of the sample C reads through take; recorded only
    # (tests/test_distributed.py bounds these reads by rows, which the
    # reference itself does not meet)
    record_property("take_rows", [s.takes for s in shards])
    host = eim(HostSource(x), k, key, executor=HostStreamExecutor(
        memory_budget=budget, device="cpu"))
    np.testing.assert_array_equal(got.centers, host.centers)
    assert float(got.radius2) == float(host.radius2)
    np.testing.assert_array_equal(got.sample.sample_mask, host.sample.sample_mask)
    want = jeim(JHostSource(x), k, jax.random.PRNGKey(key), impl="ref",
                executor=JHostStreamExecutor(memory_budget=budget))
    np.testing.assert_array_equal(got.centers, np.asarray(want.centers))
    assert float(got.radius2) == float(want.radius2)
    np.testing.assert_array_equal(got.sample.sample_mask,
                                  np.asarray(want.sample.sample_mask))
    dev = eim_sample(x, k, key, device="cpu")
    mesh_s = eim_sample(sh, k, key, executor=me)
    np.testing.assert_array_equal(mesh_s.sample_mask, dev.sample_mask)
    assert int(mesh_s.iters) == int(dev.iters)


# -- the weighted objective and (k, z)-center --------------------------------

def _weighted(n=2048, d=3, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[:5] += 40.0                                  # planted outliers
    w = rng.integers(0, 4, size=n).astype(np.float32)
    return x, w


@pytest.mark.parametrize("kind", ["weighted_mrg", "kz_center"])
def test_weighted_and_outliers_match_host_stream(kind):
    x, w = _weighted()
    src = WeightedSource(HostSource(x), w)
    me = MeshExecutor(_mesh((4,)), block_rows=256)
    hs = HostStreamExecutor(block_rows=256, device="cpu")
    if kind == "weighted_mrg":
        obj = Objective(weighted=True)
        a, b = (mrg(src, 6, executor=e, objective=obj) for e in (me, hs))
        _same_mrg(a, b)
        np.testing.assert_array_equal(a.weights, b.weights)
        assert float(a.weights.sum()) == float(w.sum())
    else:
        a, b = (kz_center(src, 4, 5, executor=e) for e in (me, hs))
        np.testing.assert_array_equal(a.centers, b.centers)
        assert float(a.radius2) == float(b.radius2)
        assert (a.coreset_size, a.rounds) == (b.coreset_size, b.rounds)


# -- the fused path against the JAX MeshExecutor (8 forced host devices) -----

FUSED_N, FUSED_D, FUSED_K = 960, 3, 5
FUSED_CASES = {
    # name: (mesh shape, mesh axes, shard axes, hierarchical, kind)
    "flat_4x2_data": ((4, 2), ("data", "model"), ("data",), False, "mrg"),
    "flat_2x2x2": ((2, 2, 2), ("pod", "data", "model"),
                   ("pod", "data", "model"), False, "mrg"),
    "hier_2x2x2": ((2, 2, 2), ("pod", "data", "model"),
                   ("pod", "data", "model"), True, "mrg"),
    "coreset_4x2_data": ((4, 2), ("data", "model"), ("data",), False,
                         "coreset"),
}


def _fused_points(tier):
    rng = np.random.default_rng(11)
    if tier == "exact":
        return np.floor(rng.random((FUSED_N, FUSED_D)) * 30).astype(np.float32)
    return rng.normal(size=(FUSED_N, FUSED_D)).astype(np.float32)


_JAX_FUSED = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
out, cases, k = sys.argv[1], json.loads(sys.argv[2]), {k}
# the exact and float tiers lower to the same programs: compile each once
jax.config.update("jax_compilation_cache_dir", os.path.join(out, "xla"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
from repro.core import MeshExecutor, mrg, mrg_distributed, select_coreset
from repro.data import ArraySource
from repro.launch.mesh import make_mesh
arrays, meta = {{}}, {{}}
for tier in ("exact", "float"):
    x = np.load(os.path.join(out, tier + ".npy"))
    for name, (shape, axes, shard_axes, hier, kind) in cases.items():
        mesh = make_mesh(tuple(shape), tuple(axes))
        tag = name + "/" + tier
        if kind == "mrg":
            res = mrg(ArraySource(x), k, executor=MeshExecutor(
                mesh, shard_axes=tuple(shard_axes), hierarchical=hier))
            if tier == "exact":     # the shim is the executor's fused path
                c, r2 = mrg_distributed(jnp.asarray(x), k, mesh,
                                        shard_axes=tuple(shard_axes),
                                        hierarchical=hier)
                assert (np.asarray(c) == np.asarray(res.centers)).all()
                assert float(r2) == float(res.radius2)
            arrays[tag + "/centers"] = np.asarray(res.centers)
            arrays[tag + "/radius2"] = np.asarray(res.radius2)
            meta[tag] = {{"rounds": res.rounds}}
        else:
            cs = select_coreset(x, k, mesh=mesh, shard_axes=tuple(shard_axes))
            for f in cs._fields:
                arrays[tag + "/" + f] = np.asarray(getattr(cs, f))
            meta[tag] = {{}}
try:
    mrg_distributed(jnp.zeros((962, 3), jnp.float32), k,
                    make_mesh((4, 2), ("data", "model")))
    meta["indivisible"] = None
except Exception as e:
    meta["indivisible"] = type(e).__name__
np.savez(os.path.join(out, "jax_fused.npz"), **arrays)
with open(os.path.join(out, "jax_fused.json"), "w") as f:
    json.dump(meta, f)
"""


@pytest.fixture(scope="module")
def jax_fused(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_fused")
    for tier in ("exact", "float"):
        np.save(out / f"{tier}.npy", _fused_points(tier))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    prog = textwrap.dedent(_JAX_FUSED.format(k=FUSED_K))
    run = subprocess.run([sys.executable, "-c", prog, str(out),
                          json.dumps(FUSED_CASES)], capture_output=True,
                         text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    with np.load(out / "jax_fused.npz") as z:
        arrays = dict(z)
    with open(out / "jax_fused.json") as f:
        meta = json.load(f)
    return arrays, meta


@pytest.mark.parametrize("tier", ["exact", "float"])
@pytest.mark.parametrize("name", list(FUSED_CASES))
def test_fused_matches_jax_mesh(jax_fused, name, tier):
    arrays, meta = jax_fused
    shape, axes, shard_axes, hier, kind = FUSED_CASES[name]
    x = _fused_points(tier)
    mesh = _mesh(shape, axes)
    tag = f"{name}/{tier}"
    if kind == "coreset":
        got = select_coreset(x, FUSED_K, mesh=mesh, shard_axes=shard_axes)
        fields = dict(zip(got._fields, got))
        for f in ("indices", "centers", "weights"):
            np.testing.assert_array_equal(fields[f], arrays[f"{tag}/{f}"])
        want_r2 = float(arrays[f"{tag}/radius2"])
        r2 = float(got.radius2)
    else:
        ex = MeshExecutor(mesh, shard_axes=shard_axes, hierarchical=hier)
        res = mrg(x, FUSED_K, executor=ex)
        c, r2t = mrg_distributed(x, FUSED_K, mesh, shard_axes=shard_axes,
                                 hierarchical=hier)
        assert torch.equal(c, res.centers) and torch.equal(r2t, res.radius2)
        assert res.rounds == meta[tag]["rounds"] == (4 if hier else 2)
        np.testing.assert_array_equal(res.centers, arrays[f"{tag}/centers"])
        want_r2 = float(arrays[f"{tag}/radius2"])
        r2 = float(res.radius2)
    if tier == "exact":
        assert r2 == want_r2
    else:
        assert r2 == pytest.approx(want_r2, rel=R2_RTOL)


def test_fused_gather_order():
    """The flat gather concatenates along each shard axis in turn, so the
    union is ordered with the last axis outermost; the hierarchical levels
    group the shards that differ only along the current axis."""
    parts = torch.arange(8, dtype=torch.float32).view(2, 2, 2, 1, 1)
    one = all_gather(parts, 0)
    assert tuple(one.shape) == (1, 2, 2, 2, 1)
    assert one[0, 1, 0, :, 0].tolist() == [2.0, 6.0]   # shards (0,1,0), (1,1,0)
    flat = all_gather(all_gather(all_gather(parts, 0), 1), 2)
    assert flat.reshape(-1).tolist() == [0, 4, 2, 6, 1, 5, 3, 7]


# -- errors, as in the JAX package -------------------------------------------

def _jax_mesh1():
    return jcompat.make_mesh(np.array(jax.devices()[:1]), ("data",))


class _RemoteShards(ShardedSource):
    """A sharded source that holds data for its first shard only."""

    @property
    def local_shard_ids(self):
        return (0,)


def _raises_like_jax(port_call, jax_call):
    with pytest.raises(Exception) as want:
        jax_call()
    with pytest.raises(type(want.value)) as got:
        port_call()
    assert str(got.value) == str(want.value)


def test_capacity_on_fused_path_raises():
    x = _X[:64]
    _raises_like_jax(
        lambda: MeshExecutor(_mesh((1,))).mrg(torch.from_numpy(x), 3,
                                              capacity=32),
        lambda: JMeshExecutor(_jax_mesh1()).mrg(jnp.asarray(x), 3,
                                                capacity=32))


def test_mismatched_sharded_source_raises():
    x = _X[:64]
    _raises_like_jax(
        lambda: mrg(shard_source(HostSource(x), 2), 3,
                    executor=MeshExecutor(_mesh((1,)))),
        lambda: jmrg(jsource.shard_source(JHostSource(x), 2), 3, impl="ref",
                     executor=JMeshExecutor(_jax_mesh1())))
    _raises_like_jax(lambda: shard_source(shard_source(HostSource(x), 2), 3),
                     lambda: jsource.shard_source(
                         jsource.shard_source(JHostSource(x), 2), 3))


def test_filter_round_weights_raise():
    x = _X[:64]
    args = (x[:2], np.full(64, 3e38, np.float32), np.ones(64, bool), 4)
    _raises_like_jax(
        lambda: MeshExecutor(_mesh((1,))).run_filter_round(
            HostSource(x), *args, weights=np.ones(64, np.float32)),
        lambda: JMeshExecutor(_jax_mesh1()).run_filter_round(
            JHostSource(x), *args, weights=np.ones(64, np.float32)))


def test_remote_shards_in_one_process_raise():
    x = _X[:64]
    jsrc = jsource.ProcessShardedSource.for_process(JHostSource(x[:32]),
                                                    [32, 32], 0)
    with pytest.raises(ValueError) as want:
        jmrg(jsrc, 3, impl="ref",
             executor=JMeshExecutor(jcompat.make_mesh(
                 np.array(jax.devices()[:1] * 2), ("data",))))
    src = _RemoteShards([HostSource(x[:32]), HostSource(x[32:])])
    with pytest.raises(ValueError) as got:
        mrg(src, 3, executor=MeshExecutor(_mesh((2,))))
    assert str(got.value) in str(want.value)


def test_indivisible_n_on_fused_path_raises(jax_fused):
    _, meta = jax_fused
    assert meta["indivisible"] == "ValueError"
    with pytest.raises(ValueError, match="multiple of 8"):
        mrg_distributed(_X[:962], 3, _mesh((4, 2), ("data", "model")),
                        shard_axes=("data", "model"))


def test_device_none_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh((2,), ("data",))
    with pytest.raises(RuntimeError, match="CUDA"):
        Mesh((2,), ("data",))

    class CudaMesh:               # a mesh handed over with the card's device
        shape = {"data": 2}
        axis_names = ("data",)
        device = "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        MeshExecutor(CudaMesh())


# -- the sharded sources and the lockstep steps, against the JAX package -----

@pytest.mark.parametrize("n,shards", [(10, 4), (4096, 8), (7, 8), (9, 3)])
def test_shard_source_splits_match_jax(n, shards):
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    got = shard_source(HostSource(x), shards)
    want = jsource.shard_source(JHostSource(x), shards)
    assert [(s.start, s.stop) for s in got.shards] == \
        [(s.start, s.stop) for s in want.shards]
    np.testing.assert_array_equal(got.offsets, want.offsets)
    assert (got.n, got.d, got.max_shard_rows) == (want.n, want.d,
                                                  want.max_shard_rows)
    idx = np.arange(n)[::-1]
    np.testing.assert_array_equal(got.take(idx), want.take(idx))
    np.testing.assert_array_equal(got.row(n - 1), want.row(n - 1))
    np.testing.assert_array_equal(got.materialize("cpu"),
                                  np.asarray(want.materialize()))
    for a, b in zip(got.host_blocks(3), want.host_blocks(3)):
        np.testing.assert_array_equal(a, b)
    mesh = _mesh((2, 2), ("pod", "data"))
    assert shard_source(HostSource(x), mesh,
                        shard_axes=("data",)).num_shards == 2
    assert shard_source(HostSource(x), mesh).num_shards == 4


def test_sharded_generator_matches_jax():
    """Shards of a generator read whole runs: each block one ``block_fn``
    call, bitwise the JAX package's."""
    got = shard_source(synthetic_source("unif", 1000, d=3, seed=4), 3)
    want = jsource.shard_source(jsource.synthetic_source("unif", 1000, d=3,
                                                         seed=4), 3)
    for a, b in zip(got.host_blocks(128), want.host_blocks(128)):
        np.testing.assert_array_equal(a, b)
    idx = np.array([999, 0, 1, 2, 500, 334, 335])
    np.testing.assert_array_equal(got.take(idx), want.take(idx))
    assert got.shards[0].take([]).shape == (0, 3)


def test_slice_and_sharded_weights_match_jax():
    x, w = _weighted(n=50)
    got = shard_source(WeightedSource(HostSource(x), w), 3)
    want = jsource.shard_source(JWeightedSource(JHostSource(x), w), 3)
    assert got.has_weights and want.has_weights
    np.testing.assert_array_equal(got.weights_of(10, 30),
                                  want.weights_of(10, 30))
    idx = np.array([49, 0, 17, 18])
    np.testing.assert_array_equal(got.take_weights(idx),
                                  want.take_weights(idx))
    sl, jsl = SliceSource(got.shards[1], 2, 9), jsource.SliceSource(
        want.shards[1], 2, 9)
    assert (sl.start, sl.stop) == (jsl.start, jsl.stop)
    np.testing.assert_array_equal(sl.weights_of(5, 10), jsl.weights_of(5, 10))
    blocks = list(got.weighted_blocks(7, device="cpu"))
    np.testing.assert_array_equal(torch.cat([b for b, _ in blocks]), x)
    np.testing.assert_array_equal(torch.cat([v for _, v in blocks]), w)


@pytest.mark.parametrize("weights,local", [(False, None), (True, None),
                                           (False, (0, 2))])
def test_zip_shard_blocks_matches_jax(weights, local):
    x, w = _weighted(n=23, d=2)
    sizes = [(0, 9), (9, 11), (11, 23)]             # 9, 2 and 12 rows
    port = [SliceSource(WeightedSource(HostSource(x), w), a, b)
            for a, b in sizes]
    ref = [jsource.SliceSource(JWeightedSource(JHostSource(x), w), a, b)
           for a, b in sizes]
    got = list(engine.zip_shard_blocks(port, 4, with_weights=weights,
                                       local_ids=local))
    want = list(jengine.zip_shard_blocks(ref, 4, with_weights=weights,
                                         local_ids=local))
    assert len(got) == len(want) == 3
    for g, r in zip(got, want):
        assert len(g) == len(r)
        for a, b in zip(g, r):
            if isinstance(b, list):
                # the port stacks the fed shards, (S_l, rows, d), where the
                # JAX package leaves the other processes' slots None
                assert [p is None for p in b] == [i not in local
                                                  for i in range(len(b))]
                b = np.stack([q for q in b if q is not None])
            np.testing.assert_array_equal(a, b)
    with pytest.raises(NotImplementedError):
        next(engine.zip_shard_blocks(port, 4, with_weights=True,
                                     local_ids=(0,)))


# -- one process: the multi-process branches stay out of the way ---------------

def test_process_sharded_source_in_one_process_raises():
    """A ``ProcessShardedSource`` with another process's shard cannot run in
    one process: ``mrg`` and ``eim`` raise as the JAX package's do."""
    from repro_torch.data import ProcessShardedSource
    x = _X[:64]
    src = ProcessShardedSource.for_process(HostSource(x[:32]), [32, 32], 0)
    jsrc = jsource.ProcessShardedSource.for_process(JHostSource(x[:32]),
                                                    [32, 32], 0)
    with pytest.raises(ValueError) as want:
        jmrg(jsrc, 3, impl="ref",
             executor=JMeshExecutor(jcompat.make_mesh(
                 np.array(jax.devices()[:1] * 2), ("data",))))
    ex = MeshExecutor(_mesh((2,)), block_rows=16)
    with pytest.raises(ValueError) as got:
        mrg(src, 3, executor=ex)
    assert str(got.value) in str(want.value)
    # EIM's loop gathers its first samples, some of them remote, and raises
    half = N // 2
    src = ProcessShardedSource.for_process(HostSource(_X[:half]),
                                           [half, half], 0)
    jsrc = jsource.ProcessShardedSource.for_process(JHostSource(_X[:half]),
                                                    [half, half], 0)
    _raises_like_jax(
        lambda: eim(src, 3, 1, executor=MeshExecutor(_mesh((2,)),
                                                     block_rows=512)),
        lambda: jeim(jsrc, 3, jax.random.PRNGKey(1), impl="ref",
                     executor=JMeshExecutor(jcompat.make_mesh(
                         np.array(jax.devices()[:1] * 2), ("data",)),
                         block_rows=512)))


def test_one_process_mesh_makes_no_exchange(monkeypatch):
    """In one process the mesh executor never calls the exchanges of a
    multi-process run (so it adds no read: the card's phase 12 counts the
    synchronising calls), and its results stay bitwise
    ``HostStreamExecutor``'s over the same shards."""
    from repro_torch import compat

    def forbidden(*args, **kwargs):
        raise AssertionError("an exchange in a one-process run")

    for name in ("exchange_host", "fetch_global", "same_on_every_process",
                 "local_shard_indices"):
        monkeypatch.setattr(compat, name, forbidden)
    sh = shard_source(HostSource(_X), 4)
    ex = MeshExecutor(_mesh((4,)), block_rows=512)
    host = HostStreamExecutor(block_rows=512, device="cpu")
    _same_mrg(mrg(sh, K, executor=ex), mrg(sh, K, executor=host))
    got, want = eim(sh, 2, 5, executor=ex), eim(sh, 2, 5, executor=host)
    np.testing.assert_array_equal(got.centers, want.centers)
    assert float(got.radius2) == float(want.radius2)
    np.testing.assert_array_equal(got.sample.sample_mask,
                                  want.sample.sample_mask)


def test_fused_path_and_weighted_steps_raise_under_several_processes(
        monkeypatch):
    """Under several processes the fused in-memory path raises (naming the
    source to pass instead), as do the weighted steps and a non-plain
    radius; a one-process mesh there raises too."""
    from repro_torch import compat
    from repro_torch.launch import Mesh
    monkeypatch.setattr(compat, "process_count", lambda: 2)
    monkeypatch.setattr(compat, "process_index", lambda: 0)
    cluster = Mesh((2,), ("data",), device="cpu", owners=[0, 1])
    with pytest.raises(NotImplementedError, match="ProcessShardedSource"):
        mrg(torch.from_numpy(_X[:64]), 3, executor=MeshExecutor(cluster))
    sh = shard_source(HostSource(_X[:64]), 2)
    w = WeightedSource(HostSource(_X[:64]), np.ones(64, np.float32))
    ex = MeshExecutor(cluster, block_rows=16)
    with pytest.raises(NotImplementedError, match="weighted"):
        mrg(shard_source(w, 2), 3, executor=ex,
            objective=Objective(weighted=True))
    with pytest.raises(NotImplementedError, match="plain objective"):
        ex.radius2(sh, torch.zeros((3, D)), objective=Objective(outliers=2))
    with pytest.raises(ValueError, match="make_cluster_mesh"):
        mrg(sh, 3, executor=MeshExecutor(_mesh((2,)), block_rows=16))
