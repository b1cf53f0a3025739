"""The port's streamed path against the JAX package, on the CPU: the plain
versions of the streamed kernels, the source folds, and MRG, GON and
coreset selection over point sources.

The same numpy inputs go through ``repro`` (``impl="ref"``, and for the
``fused_stream`` kernels also ``impl="pallas"`` in interpret mode) and
``repro_torch`` (``device="cpu"``, its plain versions). On exact-arithmetic
inputs (small integer coordinates, so every f32 sum is exact in any order)
everything is bitwise, tie-breaks included. On float inputs the distances
hold to tests/test_kernels.py's rtol = atol = 1e-4, indices are compared
where the winner is unique by 1e-5, and ``radius2`` holds to rtol 1e-6 (as
in tests/test_torch_mrg.py). The CUDA kernels run only on the card
(chip_smoke.py holds them against these plain versions).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import covering_radius as jcovering_radius
from repro.core import gonzalez as jgonzalez
from repro.core import mrg as jmrg
from repro.core import select_coreset as jselect_coreset
from repro.core.executor import HostStreamExecutor as JHostStreamExecutor
from repro.data import source as jsource
from repro.kernels import engine as jengine
from repro.kernels import fused_stream as jfs
from repro_torch.core import (HostStreamExecutor, SimExecutor,
                              covering_radius, gonzalez, mrg, mrg_distributed,
                              select_coreset)
from repro_torch.data import pointsets
from repro_torch.data.source import HostSource, MemmapSource, synthetic_source
from repro_torch.kernels import engine, ref
from repro_torch.kernels.fused_stream import (argmin_carry,
                                              fused_argmin_cuda,
                                              fused_assign_cuda,
                                              fused_filter_cuda,
                                              unpack_argmin)
from repro_torch.launch import make_mesh

TOL = dict(rtol=1e-4, atol=1e-4)     # tests/test_kernels.py (f32 d2)
R2_RTOL = 1e-6                       # tests/test_torch_mrg.py (radius2)


def _pts(rng, shape, exact):
    if exact:
        return np.floor(rng.random(shape) * 30).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _check_d2(got, want, exact):
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


def _unique_rows(x, c):
    """Rows whose nearest center wins by more than 1e-5."""
    part = np.partition(np.asarray(ref.pairwise_dist2(_t(x), _t(c))), 1, axis=1)
    return part[:, 1] - part[:, 0] > 1e-5


# -- the plain versions of kernels #3-#5 against fused_stream ----------------

@pytest.mark.parametrize("jimpl,chunk,tier,n,k,d,rank", [
    ("ref", None, "exact", 300, 13, 5, 1),
    ("pallas", 128, "exact", 300, 13, 5, 1),
    ("pallas", 8, "exact", 300, 13, 5, 3),
    ("ref", None, "exact", 300, 13, 5, 17),
    ("pallas", 128, "exact", 300, 13, 5, 17),
    ("ref", None, "exact", 10, 4, 3, 17),        # rank > rows
    ("ref", None, "float", 300, 13, 2, 3),
    ("pallas", 128, "float", 300, 13, 2, 3),
])
def test_filter_matches_jax(jimpl, chunk, tier, n, k, d, rank):
    rng = np.random.default_rng(n + rank)
    x, c = _pts(rng, (n, d), tier == "exact"), _pts(rng, (k, d), tier == "exact")
    ds = (np.floor(rng.random(n) * 400) if tier == "exact"
          else rng.random(n) * 3).astype(np.float32)
    hm = rng.random(n) < 0.6
    jds, jtop = jengine.eim_filter_block(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(ds), jnp.asarray(hm),
        jengine.top_k_init(rank), rank=rank, impl=jimpl, chunk=chunk)
    got_ds, tops = engine.fused_filter(_t(x), _t(c), _t(ds), _t(hm), rank=rank,
                                       impl="ref")
    assert tops.shape == (-(-n // ref.FILTER_TILE_ROWS), rank)
    top = engine.merge_top_k(engine.top_k_init(rank, "cpu"), tops, rank)
    _check_d2(got_ds.numpy(), np.asarray(jds), tier == "exact")
    _check_d2(top.numpy(), np.asarray(jtop), tier == "exact")
    if n < rank:     # the slots past the candidates hold the sentinel
        assert (top.numpy()[int(hm.sum()):] == ref.NEG).all()
    # without ds and hm: the covering-radius fold's block step
    none_ds, tops1 = engine.fused_filter(_t(x), _t(c), rank=1, impl="ref")
    assert none_ds is None
    _, want = jengine.assign_nearest(jnp.asarray(x), jnp.asarray(c), impl="ref")
    _check_d2(tops1.max().numpy(), np.asarray(want).max(), tier == "exact")


@pytest.mark.parametrize("jimpl", ["ref", "pallas"])
@pytest.mark.parametrize("tier,n,k,d", [("exact", 300, 25, 6), ("exact", 64, 1, 2),
                                        ("float", 250, 17, 3)])
def test_assign_matches_jax(jimpl, tier, n, k, d):
    rng = np.random.default_rng(k)
    x, c = _pts(rng, (n, d), tier == "exact"), _pts(rng, (k, d), tier == "exact")
    if jimpl == "pallas":
        xp = np.pad(x, ((0, -n % 64), (0, 0)))
        jidx, jd2 = jfs.fused_assign_blocks(jnp.asarray(xp), jnp.asarray(c),
                                            bn=64, interpret=True)
        jidx, jd2 = np.asarray(jidx)[:n], np.asarray(jd2)[:n]
    else:
        jidx, jd2 = map(np.asarray, jengine.assign_nearest(
            jnp.asarray(x), jnp.asarray(c), impl="ref"))
    idx, d2 = engine.fused_assign(_t(x), _t(c), impl="ref")
    assert idx.dtype == torch.int32
    _check_d2(d2.numpy(), jd2, tier == "exact")
    keep = slice(None) if tier == "exact" else _unique_rows(x, c)
    np.testing.assert_array_equal(idx.numpy()[keep], jidx[keep])


@pytest.mark.parametrize("jimpl", ["ref", "pallas"])
@pytest.mark.parametrize("tier,n,nb,k,d", [("exact", 256, 256, 9, 4),
                                           ("exact", 256, 130, 9, 4),
                                           ("exact", 64, 1, 3, 2),
                                           ("float", 192, 150, 11, 3)])
def test_argmin_matches_jax(jimpl, tier, n, nb, k, d):
    rng = np.random.default_rng(nb)
    x, c = _pts(rng, (n, d), tier == "exact"), _pts(rng, (k, d), tier == "exact")
    if tier == "exact" and nb > 10:
        x[3] = x[nb - 2] = c[0]          # an exact tie: the first row wins
    if jimpl == "pallas":                # rows past nb are invalid padding
        vm = (np.arange(n) < nb).astype(np.float32)
        jd, ji = jfs.fused_argmin_blocks(jnp.asarray(x), jnp.asarray(c),
                                         jnp.asarray(vm), bn=64, interpret=True)
    else:
        ji, jd = jengine.assign_nearest(jnp.asarray(c), jnp.asarray(x[:nb]),
                                        impl="ref")
    bd, bi = engine.fused_argmin(_t(x[:nb]), _t(c), impl="ref")
    assert bi.dtype == torch.int32
    _check_d2(bd.numpy(), np.asarray(jd), tier == "exact")
    keep = (slice(None) if tier == "exact"
            else _unique_rows(c, x[:nb]))
    np.testing.assert_array_equal(bi.numpy()[keep], np.asarray(ji)[keep])
    if tier == "exact" and nb > 10:
        assert int(bi[0]) == 3


def test_argmin_carry_packs_value_then_row():
    carry = argmin_carry(3, "cpu")
    d, i = unpack_argmin(carry)
    assert (d.numpy() == np.float32(3.4e38)).all() and (i.numpy() == 0).all()
    vals = torch.tensor([0.0, 2.5, 2.5, 1e30], dtype=torch.float32)
    rows = torch.tensor([7, 1, 0, 2**31 - 1], dtype=torch.int64)
    keys = (vals.view(torch.int32).to(torch.int64) << 32) | rows
    got_d, got_i = unpack_argmin(keys)
    assert torch.equal(got_d, vals) and got_i.tolist() == rows.tolist()
    # packed keys order as (value, row): smaller value first, then lower row
    assert keys.argsort().tolist() == [0, 2, 1, 3]


def test_kernel_route_raises_on_cpu_and_plain_route_launches_nothing():
    x, c = torch.ones(8, 2), torch.zeros(3, 2)
    before = (fused_filter_cuda.launches, fused_assign_cuda.launches,
              fused_argmin_cuda.launches)
    for op in (lambda i: engine.fused_filter(x, c, rank=1, impl=i),
               lambda i: engine.fused_assign(x, c, impl=i),
               lambda i: engine.fused_argmin(x, c, impl=i)):
        op("auto")
        with pytest.raises(ValueError, match="CUDA tensors"):
            op("kernel")
    assert (fused_filter_cuda.launches, fused_assign_cuda.launches,
            fused_argmin_cuda.launches) == before


# -- the source folds -----------------------------------------------------------

@pytest.mark.parametrize("tier,n,block_rows", [("exact", 200, 8),
                                               ("exact", 600, 256),
                                               ("float", 600, 256)])
def test_folds_match_jax(tier, n, block_rows):
    rng = np.random.default_rng(block_rows)
    x = _pts(rng, (n, 2), tier == "exact")
    c = x[[5, 100, n - 1]]
    if tier == "exact":
        x[150] = x[5]                     # a tie across blocks
    src, jsrc = HostSource(x), jsource.HostSource(x)
    kw = dict(block_rows=block_rows)
    r2 = engine.fold_min_d2(src, c, device="cpu", **kw)
    blocks = list(engine.assign_nearest_source(src, c, device="cpu", **kw))
    cidx = engine.argmin_dist2_over_source(src, c, device="cpu", **kw)
    assert len(blocks) == -(-n // block_rows)
    idx = torch.cat([b[0] for b in blocks]).numpy()
    d2 = torch.cat([b[1] for b in blocks]).numpy()
    for jimpl in (("ref", "pallas") if tier == "exact" else ("ref",)):
        jr2 = jengine.fold_min_d2(jsrc, c, impl=jimpl, **kw)
        jb = list(jengine.assign_nearest_source(jsrc, c, impl=jimpl, **kw))
        jc = jengine.argmin_dist2_over_source(jsrc, c, impl=jimpl, **kw)
        jidx = np.concatenate([np.asarray(b[0]) for b in jb])
        jd2 = np.concatenate([np.asarray(b[1]) for b in jb])
        if tier == "exact":
            assert r2.numpy() == np.asarray(jr2)
            np.testing.assert_array_equal(d2, jd2)
            np.testing.assert_array_equal(idx, jidx)
        else:
            np.testing.assert_allclose(r2.numpy(), np.asarray(jr2),
                                       rtol=R2_RTOL)
            np.testing.assert_allclose(d2, jd2, **TOL)
            keep = _unique_rows(x, c)
            np.testing.assert_array_equal(idx[keep], jidx[keep])
        np.testing.assert_array_equal(cidx.numpy(), np.asarray(jc))
    assert cidx.dtype == torch.int32 and cidx.tolist()[0] == 5


def test_top_k_merge_and_block_rows_match_jax():
    rng = np.random.default_rng(0)
    vals = [rng.normal(size=s).astype(np.float32) for s in (3, 0, 40, 1)]
    for k in (1, 5, 50):
        got = engine.fold_top_k([_t(v) for v in vals], k, device="cpu")
        want = jengine.fold_top_k([jnp.asarray(v) for v in vals], k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for n, d, kw in [(10**6, 2, {}), (10**7, 2, dict(memory_budget=64 << 20)),
                     (4 * 10**6, 38, dict(memory_budget=256 << 20)),
                     (100, 3, dict(memory_budget=10**9)),
                     (500, 4, dict(block_rows=77)),
                     (500, 4, dict(memory_budget=10**4, prefetch=1))]:
        assert (engine.resolve_block_rows(n, d, **kw)
                == jengine.resolve_block_rows(n, d, **kw))
    assert engine.resolve_block_rows(10**7, 2, memory_budget=64 << 20) == 1864135
    assert engine.resolve_block_rows(4 * 10**6, 38,
                                     memory_budget=256 << 20) == 573580
    with pytest.raises(ValueError, match="cannot hold"):
        engine.resolve_block_rows(10, 3, memory_budget=10)


# -- end to end: MRG, GON and coreset selection over sources -------------------

def _source_pair(kind, gen, n, tmp_path, exact):
    if kind == "synthetic":
        return (synthetic_source(gen, n, seed=1),
                jsource.synthetic_source(gen, n, seed=1))
    x = (pointsets.pokerlike(n, seed=1) if exact
         else pointsets.GENERATORS[gen](n, seed=1))
    if kind == "memmap":
        return (MemmapSource.save_shards(x, tmp_path / "p", rows_per_shard=500),
                jsource.MemmapSource.save_shards(x, tmp_path / "j",
                                                 rows_per_shard=500))
    return HostSource(x), jsource.HostSource(x)


@pytest.mark.parametrize("kind,gen,block_rows,k", [
    ("host", "unif", 256, 8),
    ("memmap", "gau", 999, 8),
    ("synthetic", "unb", 256, 8),
    ("host", "pokerlike", 999, 8),         # exact tier
])
def test_mrg_streamed_matches_jax(tmp_path, kind, gen, block_rows, k):
    exact = gen == "pokerlike"
    src, jsrc = _source_pair(kind, gen, 1200, tmp_path, exact)
    got = mrg(src, k, executor=HostStreamExecutor(block_rows=block_rows,
                                                  device="cpu"))
    want = jmrg(jsrc, k, executor=JHostStreamExecutor(block_rows=block_rows),
                impl="ref")
    assert got.rounds == want.rounds
    np.testing.assert_array_equal(got.centers.numpy(), np.asarray(want.centers))
    if exact:
        assert got.radius2.numpy() == np.asarray(want.radius2)
    else:
        np.testing.assert_allclose(float(got.radius2), float(want.radius2),
                                   rtol=R2_RTOL)


def test_mrg_default_executor_and_multiround_capacity():
    x = pointsets.unif(600, seed=2)
    # an explicit host source streams on HostStreamExecutor(); arrays stay
    # in memory on SimExecutor(m)
    a = mrg(HostSource(x), 5, device="cpu")
    b = mrg(HostSource(x), 5, executor=HostStreamExecutor(device="cpu"))
    assert torch.equal(a.centers, b.centers)
    c = mrg(x, 5, m=4, device="cpu")
    d = mrg(x, 5, executor=SimExecutor(4, device="cpu"))
    assert torch.equal(c.centers, d.centers)
    # 3 super-shards of <= 256 rows: union 24 > capacity 20 forces a
    # third round
    ex = HostStreamExecutor(block_rows=256, device="cpu")
    got = mrg(HostSource(x), 8, executor=ex, capacity=20)
    want = jmrg(jsource.HostSource(x), 8, capacity=20, impl="ref",
                executor=JHostStreamExecutor(block_rows=256))
    assert got.rounds == want.rounds > 2
    np.testing.assert_array_equal(got.centers.numpy(), np.asarray(want.centers))


@pytest.mark.parametrize("gen,tie", [("gau", False), ("pokerlike", False),
                                     ("pokerlike", True)])
def test_gonzalez_and_covering_radius_over_a_source(gen, tie):
    exact = gen == "pokerlike"
    x = (pointsets.pokerlike(600, seed=4) if exact
         else pointsets.gau(600, seed=4))
    if tie:     # the farthest point twice, in blocks 0 and 2 of 3
        x[100] = x[520] = 1000.0
    # the streamed carry over 3 blocks (256, 256, 88 rows)
    got = gonzalez(HostSource(x), 8, block_rows=256, device="cpu")
    want = jgonzalez(jsource.HostSource(x), 8, impl="ref", block_rows=256)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.centers.numpy(), np.asarray(want.centers))
    if tie:     # strict >: the earlier block keeps the tie
        assert int(got.indices[1]) == 100
    assert got.indices.dtype == torch.int32 and got.min_d2.shape == (600,)
    # the streamed form picks what the in-memory form picks
    mem = gonzalez(x, 8, device="cpu")
    assert torch.equal(got.indices, mem.indices)
    if exact:
        assert got.radius2.numpy() == np.asarray(want.radius2)
        np.testing.assert_array_equal(got.min_d2.numpy(),
                                      np.asarray(want.min_d2))
    else:
        np.testing.assert_allclose(float(got.radius2), float(want.radius2),
                                   rtol=R2_RTOL)
        np.testing.assert_allclose(got.min_d2.numpy(),
                                   np.asarray(want.min_d2), rtol=1e-5)
    r = covering_radius(HostSource(x), got.centers, block_rows=256,
                        device="cpu")
    jr = jcovering_radius(jsource.HostSource(x), jnp.asarray(got.centers),
                          impl="ref", block_rows=256)
    np.testing.assert_allclose(float(r), float(jr), rtol=R2_RTOL)
    assert float(r) == float(covering_radius(x, got.centers, device="cpu"))
    with pytest.raises(ValueError, match="mask"):
        gonzalez(HostSource(x), 3, mask=np.ones(600, bool), device="cpu")


@pytest.mark.parametrize("mode", ["streamed_gon", "host_stream", "in_memory"])
@pytest.mark.parametrize("gen", ["unif", "pokerlike"])
def test_select_coreset_matches_jax(mode, gen):
    x = (pointsets.pokerlike(600, seed=6) if gen == "pokerlike"
         else pointsets.unif(600, seed=6))
    if mode == "in_memory":
        got = select_coreset(x, 8, device="cpu")
        want = jselect_coreset(x, 8, impl="ref")
    elif mode == "streamed_gon":
        got = select_coreset(HostSource(x), 8, block_rows=256, device="cpu")
        want = jselect_coreset(jsource.HostSource(x), 8, impl="ref",
                               block_rows=256)
    else:
        got = select_coreset(HostSource(x), 8, executor=HostStreamExecutor(
            block_rows=256, device="cpu"))
        want = jselect_coreset(jsource.HostSource(x), 8, impl="ref",
                               executor=JHostStreamExecutor(block_rows=256))
    np.testing.assert_array_equal(got.centers.numpy(), np.asarray(want.centers))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.weights.numpy(), np.asarray(want.weights))
    assert got.indices.dtype == torch.int32
    assert got.weights.dtype == torch.float32 and float(got.weights.sum()) == 600
    np.testing.assert_allclose(float(got.radius2), float(want.radius2),
                               rtol=0 if gen == "pokerlike" else R2_RTOL)


@pytest.mark.parametrize("gen", ["kddlike", "pokerlike"])
def test_host_stream_radius2_equals_sim_radius2(gen):
    # the streamed fold (filter step) and the in-memory pass (assign) round
    # every pair alike, so the two executors agree bitwise
    x = pointsets.GENERATORS[gen](600, seed=9)
    c = torch.from_numpy(x[[1, 50, 300, 550]])
    a = HostStreamExecutor(block_rows=256, device="cpu").radius2(HostSource(x), c)
    b = SimExecutor(4, device="cpu").radius2(x, c)
    assert a.numpy() == b.numpy()
    want = jengine.fold_min_d2(jsource.HostSource(x), c.numpy(), impl="ref",
                               block_rows=256)
    np.testing.assert_allclose(a.numpy(), np.asarray(want),
                               rtol=0 if gen == "pokerlike" else R2_RTOL)


def test_new_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = pointsets.unif(64, seed=0)
    src = HostSource(x)
    c = torch.from_numpy(x[:2])
    for call in (lambda: HostStreamExecutor(),
                 lambda: select_coreset(x, 4),
                 lambda: select_coreset(src, 4),
                 lambda: gonzalez(src, 4),
                 lambda: mrg(src, 4),
                 lambda: covering_radius(src, c),
                 lambda: engine.fold_min_d2(src, c),
                 lambda: engine.argmin_dist2_over_source(src, c),
                 lambda: next(engine.assign_nearest_source(src, c))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_unported_options_raise():
    x = pointsets.unif(64, seed=0)
    src, c = HostSource(x), torch.from_numpy(x[:2])
    # chunk is ported: chunked passes give the unchunked results
    assert torch.equal(engine.pairwise_dist2(c, c, chunk=8),
                       engine.pairwise_dist2(c, c))
    assert torch.equal(mrg(src, 4, chunk=8, device="cpu").centers,
                       mrg(src, 4, device="cpu").centers)
    # mesh= is ported: the fused mesh path's centers; device= is the mesh's
    mesh = make_mesh((4,), ("data",), device="cpu")
    assert torch.equal(select_coreset(x, 4, mesh=mesh).centers,
                       mrg_distributed(x, 4, mesh)[0])
    with pytest.raises(ValueError, match="mesh"):
        select_coreset(x, 4, mesh=mesh, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        select_coreset(x, 4, chunk=8, device="cpu"),
        select_coreset(x, 4, device="cpu")))
    with pytest.raises(NotImplementedError, match="objective"):
        HostStreamExecutor(device="cpu").mrg(src, 4, objective=object())
    with pytest.raises(ValueError, match="prefetch"):
        HostStreamExecutor(prefetch=0, device="cpu")
