"""The port's weighted objective against the JAX package, on the CPU: the
weighted source, the weighted filter (kernel #6's plain version) and the
plain filter at any rank, the batched weighted reducer, the weighted
combine, the top-k folds, and weighted ``mrg`` and ``select_coreset`` on
both executors.

The same numpy inputs go through ``repro`` (``impl="ref"``, and the
weighted filter also through ``fused_filter_blocks_w`` in interpret mode)
and ``repro_torch`` (``device="cpu"``, its plain versions). Tolerances: on
exact-arithmetic inputs (small integer coordinates) and integer weights
everything is bitwise, the cluster weights included (integer sums below
2^24 are exact in any order); on float inputs d² and the top-k values hold
to tests/test_kernels.py's rtol = atol = 1e-4 and ``radius2`` to rtol 1e-6
(tests/test_torch_mrg.py), with float weights' sums to rtol 1e-6. The CUDA
kernels run only on the card (chip_smoke.py holds them against these plain
versions).
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mrg as jmrg
from repro.core import select_coreset as jselect_coreset
from repro.core.executor import HostStreamExecutor as JHostStreamExecutor
from repro.core.executor import Objective as JObjective
from repro.core.executor import SimExecutor as JSimExecutor
from repro.core.executor import weighted_gon_block_fn as jweighted_gon_block_fn
from repro.data import source as jsource
from repro.kernels import engine as jengine
from repro.kernels import fused_stream as jfs
from repro.kernels import ops as jops
from repro_torch.core import (HostStreamExecutor, Objective, SimExecutor, mrg,
                              select_coreset, weighted_gon_block_fn)
from repro_torch.data.source import (ArraySource, HostSource, WeightedSource,
                                     has_weights, take_weights, weights_of)
from repro_torch.kernels import engine, ref
from repro_torch.kernels.assign import (assign_nearest_batched_cuda,
                                        assign_nearest_cuda, assign_sums_cuda)
from repro_torch.kernels.fused_stream import (fused_assign_cuda, fused_filter_cuda,
                                              fused_filter_w_cuda)

TOL = dict(rtol=1e-4, atol=1e-4)     # tests/test_kernels.py (f32 d2)
R2_RTOL = 1e-6                       # tests/test_torch_mrg.py (radius2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pts(rng, shape, exact):
    if exact:
        return np.floor(rng.random(shape) * 30).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


def _weights(rng, n):
    """Integer weights in {0, ..., 4}, about a fifth of them 0."""
    return rng.integers(0, 5, n).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the weighted source -------------------------------------------------

def test_weighted_source_validates_and_delegates():
    rng = np.random.default_rng(0)
    x, w = _pts(rng, (37, 3), True), _weights(rng, 37)
    src = WeightedSource(HostSource(x), w)
    jsrc = jsource.WeightedSource(jsource.HostSource(x), w)
    assert has_weights(src) and src.parent.n == 37 and (src.n, src.d) == (37, 3)
    for start, rows in ((0, 37), (5, 9), (30, 7)):
        np.testing.assert_array_equal(weights_of(src, start, rows),
                                      jsource.weights_of(jsrc, start, rows))
    idx = [36, 0, 7, 7]
    np.testing.assert_array_equal(take_weights(src, idx),
                                  jsource.take_weights(jsrc, idx))
    np.testing.assert_array_equal(src.take(idx), x[idx])
    np.testing.assert_array_equal(src.row(4), x[4])
    np.testing.assert_array_equal(src.materialize("cpu").numpy(), x)
    # unweighted sources: unit weights
    plain = HostSource(x)
    assert not has_weights(plain)
    np.testing.assert_array_equal(weights_of(plain, 3, 4), np.ones(4))
    np.testing.assert_array_equal(take_weights(plain, idx), np.ones(4))
    for bad in (w[:-1], -w, np.full(37, np.inf, np.float32)):
        with pytest.raises(ValueError):
            WeightedSource(HostSource(x), bad)
    with pytest.raises(IndexError):
        take_weights(src, [37])


@pytest.mark.parametrize("parent", ["host", "array"])
def test_weighted_blocks_carry_each_blocks_weights(parent):
    rng = np.random.default_rng(1)
    x, w = _pts(rng, (50, 2), False), _weights(rng, 50)
    p = HostSource(x) if parent == "host" else ArraySource(_t(x))
    src = WeightedSource(p, w)
    blocks = list(src.weighted_blocks(16, device="cpu"))
    assert [b.shape[0] for b, _ in blocks] == [16, 16, 16, 2]
    np.testing.assert_array_equal(torch.cat([b for b, _ in blocks]).numpy(), x)
    np.testing.assert_array_equal(torch.cat([v for _, v in blocks]).numpy(), w)
    # the points alone are the parent's blocks
    np.testing.assert_array_equal(
        torch.cat(list(src.blocks(16, device="cpu"))).numpy(), x)


# -- kernel #6's plain version and the filter at any rank -----------------

@pytest.mark.parametrize("tier,rank,with_ds", [
    ("exact", 3, False), ("exact", 17, True), ("float", 3, True),
    ("float", 17, False)])
def test_weighted_filter_matches_pallas_interpret(tier, rank, with_ds):
    rng = np.random.default_rng(rank)
    n, k, d = 512, 9, 3
    x, c = _pts(rng, (n, d), tier == "exact"), _pts(rng, (k, d), tier == "exact")
    w = _weights(rng, n)
    ds = np.floor(rng.random(n) * 400).astype(np.float32)
    hm = rng.random(n) < 0.7
    jds = ds if with_ds else np.full(n, ref.BIG, np.float32)
    jhm = hm if with_ds else np.ones(n, bool)
    want_ds, want_tops = jfs.fused_filter_blocks_w(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(jds),
        jnp.asarray(jhm.astype(np.float32)), jnp.asarray(w), rank=rank,
        bn=ref.FILTER_TILE_ROWS, interpret=True)
    got_ds, got_tops = engine.fused_filter(
        _t(x), _t(c), _t(ds) if with_ds else None,
        _t(hm) if with_ds else None, rank=rank, w=_t(w), impl="auto")
    # the same 256-row tiles, so the per-tile tops compare directly
    if tier == "exact":
        np.testing.assert_array_equal(got_tops.numpy(), np.asarray(want_tops))
        if with_ds:
            np.testing.assert_array_equal(got_ds.numpy(), np.asarray(want_ds))
    else:
        np.testing.assert_allclose(got_tops.numpy(), np.asarray(want_tops), **TOL)
        if with_ds:
            np.testing.assert_allclose(got_ds.numpy(), np.asarray(want_ds), **TOL)


@pytest.mark.parametrize("rank", [1, 17, 129, 256, 300])
def test_filter_any_rank_and_unit_weights(rank):
    """The plain route at every rank, above the 256 candidates of a tile
    too, against a numpy sort of each tile; unit weights are bitwise no
    weights; zero weights leave ds alone but drop out of the tops."""
    rng = np.random.default_rng(rank)
    n, k, d = 600, 5, 2
    x, c = _pts(rng, (n, d), True), _pts(rng, (k, d), True)
    w = _weights(rng, n)
    ds = np.floor(rng.random(n) * 900).astype(np.float32)
    got_ds, tops = engine.fused_filter(_t(x), _t(c), _t(ds), rank=rank,
                                       w=_t(w), impl="ref")
    d2 = np.asarray(ref.pairwise_dist2(_t(x), _t(c))).min(1)
    new = np.minimum(ds, d2)
    np.testing.assert_array_equal(got_ds.numpy(), new)
    cand = np.where(w > 0, new, ref.NEG)
    tile = ref.FILTER_TILE_ROWS
    for t in range(tops.shape[0]):
        vals = np.sort(cand[t * tile:(t + 1) * tile])[::-1]
        want = np.full(rank, ref.NEG, np.float32)
        want[:min(rank, vals.size)] = vals[:rank]
        np.testing.assert_array_equal(tops[t].numpy(), want)
    plain = engine.fused_filter(_t(x), _t(c), rank=rank, impl="ref")[1]
    unit = engine.fused_filter(_t(x), _t(c), rank=rank,
                               w=torch.ones(n), impl="ref")[1]
    assert torch.equal(plain, unit)


def test_kernel_routes_raise_on_cpu_and_plain_routes_launch_nothing():
    x, c = torch.zeros((8, 2)), torch.zeros((2, 2))
    counters = (fused_filter_cuda, fused_filter_w_cuda,
                assign_nearest_batched_cuda)
    before = [f.launches for f in counters]
    with pytest.raises(ValueError, match="CUDA tensors"):
        engine.fused_filter(x, c, rank=300, w=torch.ones(8), impl="kernel")
    with pytest.raises(ValueError, match="CUDA tensors"):
        engine.assign_nearest_batched(x[None], c[None], impl="kernel")
    engine.fused_filter(x, c, rank=300, w=torch.ones(8))
    engine.assign_nearest_batched(x[None], c[None])
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("masked", [False, True])
def test_assign_sums_plain_matches_jax_at_add(masked):
    # the sums entry's plain version against jnp.zeros(k).at[idx].add(w),
    # machine by machine, on integer weights (and counts): bitwise
    rng = np.random.default_rng(11)
    m, per, d, k = 4, 150, 3, 7
    x = _pts(rng, (m, per, d), True)
    c = _pts(rng, (m, k, d), True)
    w = _weights(rng, m * per).reshape(m, per)
    if masked:                    # the reducer's where(sel, w, 0)
        sel = rng.random((m, per)) < 0.6
        sel[1] = False            # a machine with no row selected
        w = np.where(sel, w, np.float32(0))
    got = ref.assign_sums(_t(x), _t(c), torch.zeros((m, k)), _t(w))
    counts = engine.assign_sums(_t(x), _t(c), torch.zeros((m, k), dtype=torch.int32))
    for b in range(m):
        jidx = jops.assign_nearest(x[b], c[b], impl="ref")[0]
        np.testing.assert_array_equal(
            got[b].numpy(), np.asarray(jnp.zeros(k, jnp.float32).at[jidx].add(w[b])))
        np.testing.assert_array_equal(
            counts[b].numpy(), np.asarray(jnp.zeros(k, jnp.int32).at[jidx].add(1)))
        # the 2-D form is one machine of the batch
        one = engine.assign_sums(_t(x[b]), _t(c[b]), torch.zeros(k), _t(w[b]))
        assert torch.equal(one, got[b])
    if masked:
        assert not bool(got[1].any())


def test_assign_sums_source_matches_in_memory_sums():
    rng = np.random.default_rng(12)
    x, w = _pts(rng, (230, 4), True), _weights(rng, 230)
    c = _t(x[:9])
    src = WeightedSource(HostSource(x), w)
    for weighted, want in (
            (True, ref.assign_sums(_t(x), c, torch.zeros(9), _t(w))),
            (False, ref.assign_sums(_t(x), c, torch.zeros(9, dtype=torch.int32)))):
        got = engine.assign_sums_source(src, c, block_rows=64, weighted=weighted,
                                        device="cpu")
        assert got.dtype == want.dtype and torch.equal(got, want)
    # a source without weights sums unit weights
    unit = engine.assign_sums_source(HostSource(x), c, block_rows=64,
                                     weighted=True, device="cpu")
    assert torch.equal(unit, want.to(torch.float32))


def test_sums_kernel_routes_raise_on_cpu_and_plain_routes_launch_nothing():
    x, c = torch.zeros((8, 2)), torch.zeros((2, 2))
    counters = (assign_sums_cuda, assign_nearest_cuda, assign_nearest_batched_cuda,
                fused_assign_cuda)
    before = [f.launches for f in counters]
    for call in (lambda: assign_sums_cuda(x, c, torch.zeros(2), torch.ones(8)),
                 lambda: engine.assign_sums(x, c, torch.zeros(2, dtype=torch.int32),
                                            impl="kernel"),
                 lambda: engine.assign_sums(x[None], c[None], torch.zeros(1, 2),
                                            torch.ones(1, 8), impl="kernel"),
                 lambda: engine.argmin_dist2_over_rows(x, c, impl="kernel")):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    engine.assign_sums(x, c, torch.zeros(2), torch.ones(8))
    engine.assign_sums(x, c, torch.zeros(2, dtype=torch.int32), impl="ref")
    assert [f.launches for f in counters] == before


# -- the batched weighted reducer and the weighted combine ----------------

@pytest.mark.parametrize("tier", ["exact", "float"])
@pytest.mark.parametrize("mask_zero", [True, False])
def test_weighted_reducer_matches_jax_per_machine(tier, mask_zero):
    rng = np.random.default_rng(3)
    m, per, d, k = 3, 90, 3, 6
    x = _pts(rng, (m, per, d), tier == "exact")
    w = _weights(rng, m * per).reshape(m, per)
    if tier == "float":
        w = w * rng.random((m, per)).astype(np.float32)
    mask = np.ones((m, per), bool)
    mask[2, 70:] = False                        # a short machine
    jfn = jweighted_gon_block_fn(k, "ref", mask_zero=mask_zero)
    fn = weighted_gon_block_fn(k, "ref", mask_zero=mask_zero)
    centers, cw = fn(_t(x), _t(mask), _t(w))
    for i in range(m):
        jc, jw = jfn(jnp.asarray(x[i]), jnp.asarray(mask[i]), jnp.asarray(w[i]))
        np.testing.assert_array_equal(centers[i].numpy(), np.asarray(jc))
        if tier == "exact":
            np.testing.assert_array_equal(cw[i].numpy(), np.asarray(jw))
        else:
            np.testing.assert_allclose(cw[i].numpy(), np.asarray(jw), rtol=1e-6)
    # the batched assign is the 2-D assign machine by machine
    idx, d2 = engine.assign_nearest_batched(_t(x), centers)
    for i in range(m):
        i2, d22 = engine.assign_nearest(_t(x[i]), centers[i])
        assert torch.equal(idx[i], i2) and torch.equal(d2[i], d22)


@pytest.mark.parametrize("final_gon", [True, False])
def test_combine_weighted_matches_jax(final_gon):
    rng = np.random.default_rng(4)
    rows, d, k = 130, 2, 5
    c = _pts(rng, (rows, d), True)
    valid = rng.random(rows) < 0.9
    w = _weights(rng, rows)
    jc, jw, jv, jextra = JSimExecutor(4).combine_weighted(
        jnp.asarray(c), jnp.asarray(valid), jnp.asarray(w), k, 24,
        impl="ref", final_gon=final_gon)
    pc, pw, pv, extra = SimExecutor(4, device="cpu").combine_weighted(
        _t(c), _t(valid), _t(w), k, 24, impl="ref", final_gon=final_gon)
    assert extra == jextra >= 2
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


# -- the folds -------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("rank,rows", [(1, 64), (7, 100), (200, 128)])
def test_fold_top_k_matches_jax_and_sort(weighted, rank, rows):
    rng = np.random.default_rng(rank)
    n, k, d = 700, 6, 3
    x, c = _pts(rng, (n, d), True), _pts(rng, (k, d), True)
    w = _weights(rng, n)
    src = WeightedSource(HostSource(x), w)
    jsrc = jsource.WeightedSource(jsource.HostSource(x), w)
    got = engine.fold_top_k_min_d2(src, _t(c), rank, block_rows=rows,
                                   weighted=weighted, device="cpu")
    want = jengine.fold_top_k_min_d2(jsrc, jnp.asarray(c), rank, impl="ref",
                                     block_rows=rows, weighted=weighted)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    d2 = np.asarray(ref.pairwise_dist2(_t(x), _t(c))).min(1)
    if weighted:
        d2 = d2[w > 0]
    oracle = np.full(rank, ref.NEG, np.float32)
    srt = np.sort(d2)[::-1]
    oracle[:min(rank, srt.size)] = srt[:rank]
    np.testing.assert_array_equal(got.numpy(), oracle)
    r = engine.fold_min_d2(src, _t(c), block_rows=rows, weighted=weighted,
                           device="cpu")
    assert r.item() == float(jengine.fold_min_d2(
        jsrc, jnp.asarray(c), impl="ref", block_rows=rows, weighted=weighted))


class _DuckWeighted:
    """A weighted source known only by its ``weights_of`` (no ring of its
    own), as a view over a weighted source would be."""

    def __init__(self, x, w):
        self._src, self._w = HostSource(x), w
        self.n, self.d, self.has_weights = x.shape[0], x.shape[1], True

    def blocks(self, rows, **kw):
        return self._src.blocks(rows, **kw)

    def weights_of(self, start, rows):
        return self._w[start:start + rows]


def test_duck_typed_weighted_source_folds_like_weighted_source():
    rng = np.random.default_rng(8)
    x, w = _pts(rng, (300, 2), True), _weights(rng, 300)
    c = _t(x[:5])
    for src in (WeightedSource(HostSource(x), w), _DuckWeighted(x, w)):
        top = engine.fold_top_k_min_d2(src, c, 9, block_rows=70,
                                       weighted=True, device="cpu")
        want = jengine.fold_top_k_min_d2(
            jsource.WeightedSource(jsource.HostSource(x), w), jnp.asarray(c),
            9, impl="ref", block_rows=70, weighted=True)
        np.testing.assert_array_equal(top.numpy(), np.asarray(want))


def test_weighted_assign_source_yields_weights():
    # the streamed assign's blocks in row order, and the weighted folds'
    # (points, weights) blocks: a source's own weights, unit weights for a
    # source without them
    rng = np.random.default_rng(5)
    x, w = _pts(rng, (90, 2), True), _weights(rng, 90)
    c = _t(x[:4])
    src = WeightedSource(HostSource(x), w)
    got = list(engine.assign_nearest_source(src, c, block_rows=32, device="cpu"))
    idx, d2 = engine.assign_nearest(_t(x), c)
    assert torch.equal(torch.cat([g[0] for g in got]), idx)
    assert torch.equal(torch.cat([g[1] for g in got]), d2)
    blocks = [(b.clone(), bw.clone()) for b, bw in
              engine._weighted_source_blocks(src, 32, None, torch.device("cpu"))]
    assert [b.shape[0] for b, _ in blocks] == [32, 32, 26]
    np.testing.assert_array_equal(torch.cat([b for b, _ in blocks]).numpy(), x)
    np.testing.assert_array_equal(torch.cat([bw for _, bw in blocks]).numpy(), w)
    # an unweighted source gives unit weights
    unit = list(engine._weighted_source_blocks(HostSource(x), 32, None,
                                               torch.device("cpu")))
    assert all(bool((bw == 1).all()) for _, bw in unit)


# -- weighted mrg and select_coreset on both executors ---------------------

@pytest.mark.parametrize("executor,rows,tier", [
    ("sim", None, "exact"), ("host", 100, "exact"), ("host", 128, "float")])
def test_weighted_mrg_matches_jax(executor, rows, tier):
    rng = np.random.default_rng(6)
    n, d, k = 512, 3, 5
    x, w = _pts(rng, (n, d), tier == "exact"), _weights(rng, n)
    if executor == "sim":
        ex, jex = SimExecutor(8, device="cpu"), JSimExecutor(8)
        src = WeightedSource(ArraySource(_t(x)), w)
        jsrc = jsource.WeightedSource(jsource.ArraySource(jnp.asarray(x)), w)
    else:                 # rows=100 leaves a ragged last shard, 128 does not
        ex, jex = (HostStreamExecutor(block_rows=rows, device="cpu"),
                   JHostStreamExecutor(block_rows=rows))
        src = WeightedSource(HostSource(x), w)
        jsrc = jsource.WeightedSource(jsource.HostSource(x), w)
    obj, jobj = Objective(weighted=True), JObjective(weighted=True)
    got = mrg(src, k, executor=ex, impl="ref", objective=obj)
    want = jmrg(jsrc, k, executor=jex, impl="ref", objective=jobj)
    assert got.rounds == want.rounds
    np.testing.assert_array_equal(got.centers.numpy(), np.asarray(want.centers))
    np.testing.assert_array_equal(got.weights.numpy(), np.asarray(want.weights))
    assert got.weights.sum().item() == w.sum()
    if tier == "exact":
        assert got.radius2.item() == float(want.radius2)
    else:
        np.testing.assert_allclose(got.radius2.item(), float(want.radius2),
                                   rtol=R2_RTOL)
    # unit weights: bitwise the plain run, the cluster weights the counts
    unit = mrg(WeightedSource(src.parent, np.ones(n, np.float32)), k,
               executor=ex, impl="ref", objective=obj)
    plain = mrg(src.parent, k, executor=ex, impl="ref")
    assert torch.equal(unit.centers, plain.centers)
    assert unit.radius2.item() == plain.radius2.item()
    assert unit.weights.sum().item() == n


def test_weighted_select_coreset_matches_jax():
    rows = 100
    rng = np.random.default_rng(7)
    n, d, k = 400, 3, 6
    x, w = _pts(rng, (n, d), True), _weights(rng, n)
    x[np.flatnonzero(w == 0)[0]] += 500.0   # a far row of weight 0 counts
    src = WeightedSource(HostSource(x), w)
    jsrc = jsource.WeightedSource(jsource.HostSource(x), w)
    for ex, jex in ((HostStreamExecutor(block_rows=rows, device="cpu"),
                     JHostStreamExecutor(block_rows=rows)), (None, None)):
        got = select_coreset(src, k, executor=ex, block_rows=rows,
                             device=None if ex else "cpu")
        want = jselect_coreset(jsrc, k, executor=jex, impl="ref",
                               block_rows=rows)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert got.weights.sum().item() == w.sum()


def test_objective_validation_and_non_objectives():
    with pytest.raises(ValueError):
        Objective(outliers=-1)
    x = np.zeros((16, 2), np.float32)
    with pytest.raises(NotImplementedError, match="objective"):
        SimExecutor(2, device="cpu").mrg(x, 2, objective="weighted")
    # Objective() is the plain objective
    a = mrg(x, 2, m=2, device="cpu", objective=Objective())
    assert a.weights is None


def test_weighted_modules_import_no_jax():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    code = ("import sys, repro_torch.core.outliers, repro_torch.core.streaming, "
            "repro_torch.kernels.pairwise, repro_torch.data.source; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'repro' not in sys.modules, 'repro imported'")
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
