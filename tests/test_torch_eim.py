"""The port's EIM (paper §4) against the JAX package, on the CPU: the key
split, the counter-based samplers, the fixed S buffer, the filter step,
``eim_sample`` and ``eim`` on the device path and the streamed loop (both
executors, any blocking, compacted or not), and the row-chunked passes.

The same numpy inputs go through ``repro`` (``impl="ref"``) and
``repro_torch`` (``device="cpu"``, its plain versions), at the JAX file's
size (tests/test_eim_stream.py: n = 20,000, d = 2, K = 4, key 1).

On float inputs the port is held bitwise against the JAX reference run
eagerly (``jax.disable_jit``): jitted, XLA contracts the reference's
distances differently from its own eager ops, and its samples part from
the eager ones by a row whose ``d(x, S)`` lies within rounding of the pivot
(1 of 20,000 here; ROADMAP, differences on the reference's side). On
exact-arithmetic inputs (integer coordinates, every f32 sum exact in any
order) the port is held bitwise against the jitted reference itself.
"""
import doctest
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import HostStreamExecutor as JHostStreamExecutor
from repro.core import SimExecutor as JSimExecutor
from repro.core import eim as jeim
from repro.core import eim_sample as jeim_sample
from repro.core import kz_center as jkz_center
from repro.core import mrg as jmrg
from repro.core.eim import _params as jparams
from repro.data import ArraySource as JArraySource
from repro.data import HostSource as JHostSource
from repro.kernels import engine as jengine
from repro_torch import interop
from repro_torch.core import (Executor, HostStreamExecutor, SimExecutor, eim,
                              eim_sample, gonzalez, kz_center, mrg,
                              select_coreset, stream_init, stream_update)
from repro_torch.core.eim import _params, _s_buffer, _sample_cap
from repro_torch.data.source import (ArraySource, HostSource, IndexedSource,
                                     MemmapSource, SyntheticSource,
                                     WeightedSource)
from repro_torch.kernels import engine

N, K, KEY_SEED = 20_000, 4, 1


def _t(a):
    return torch.from_numpy(np.array(a))


def _float_pts(n=N, d=2, seed=8):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _exact_pts(n=N, d=2, seed=9, side=1024):
    return np.floor(np.random.default_rng(seed).random((n, d)) * side
                    ).astype(np.float32)


def _host(n_rows, **kw):
    return HostStreamExecutor(block_rows=n_rows, device="cpu", **kw)


def _same_sample(got, want):
    np.testing.assert_array_equal(np.asarray(got.sample_mask),
                                  np.asarray(want.sample_mask))
    np.testing.assert_array_equal(np.asarray(got.s_mask),
                                  np.asarray(want.s_mask))
    assert int(got.iters) == int(want.iters)
    assert int(got.overflow) == int(want.overflow)
    assert bool(got.sampled) == bool(want.sampled)


@pytest.fixture(scope="module")
def float_case():
    """The JAX file's input and its device-path sample, jitted and eager."""
    x = _float_pts()
    key = jax.random.PRNGKey(KEY_SEED)
    jitted = jeim_sample(jnp.asarray(x), K, key, eps=0.1, phi=8.0, impl="ref")
    with jax.disable_jit():
        eager = jeim_sample(jnp.asarray(x), K, key, eps=0.1, phi=8.0,
                            impl="ref")
    assert bool(eager.sampled) and int(eager.iters) >= 1
    return x, key, eager, jitted


@pytest.fixture(scope="module")
def exact_case():
    """Integer coordinates on a [0, 1024)^2 grid: the jitted reference."""
    x = _exact_pts()
    key = jax.random.PRNGKey(KEY_SEED)
    want = jeim_sample(jnp.asarray(x), K, key, eps=0.1, phi=8.0, impl="ref")
    assert bool(want.sampled) and int(want.iters) >= 1
    return x, key, want


# -- keys and the counter-based samplers --------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 + 5])
def test_split_key_matches_jax(seed):
    words = np.array([0, seed], np.uint32)
    want = np.asarray(jax.random.split(jnp.asarray(words), 3))
    np.testing.assert_array_equal(engine.split_key(words, 3), want)
    np.testing.assert_array_equal(engine.split_key(seed, 3), want)
    # along a chain of splits, as EIM's loop walks it
    key, jkey = words, jnp.asarray(words)
    for _ in range(5):
        jkey = jax.random.split(jkey, 3)[0]
        key = engine.split_key(key, 3)[0]
        np.testing.assert_array_equal(key, np.asarray(jkey))


def test_key_forms():
    assert engine.key_words(7) == tuple(int(w) for w in
                                        np.asarray(jax.random.PRNGKey(7)))
    typed = jax.random.key(9)
    assert engine.key_words(jax.random.key_data(typed)) == (0, 9)
    assert engine.key_words(np.asarray(jax.random.PRNGKey(9))) == (0, 9)
    np.testing.assert_array_equal(
        engine.uniform_rows(jax.random.key_data(typed), 0, 64, device="cpu"),
        engine.uniform_rows(9, 0, 64, device="cpu"))
    with pytest.raises(ValueError, match="key"):
        engine.key_words(np.zeros(3, np.uint32))


@pytest.mark.parametrize("start", [0, 12_345, (1 << 32) - 5])
def test_uniform_rows_matches_jax(start):
    key = jax.random.PRNGKey(3)
    want = np.asarray(jengine.uniform_rows(key, start, 5000))
    got = engine.uniform_rows(np.asarray(key), start, 5000, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    p = np.float32(0.3)
    np.testing.assert_array_equal(
        engine.bernoulli_rows(np.asarray(key), start, 5000, p,
                              device="cpu").numpy(),
        np.asarray(jengine.bernoulli_rows(key, start, 5000, p)))


@pytest.mark.parametrize("rows", [13, 999, 4096])
def test_bernoulli_rows_blocking_invariance(rows):
    p, n = np.float32(0.3), 10_000
    full = engine.bernoulli_rows(7, 0, n, p, device="cpu")
    parts = [engine.bernoulli_rows(7, s, min(rows, n - s), p, device="cpu")
             for s in range(0, n, rows)]
    np.testing.assert_array_equal(torch.cat(parts).numpy(), full.numpy())
    # blocks that cross row 2^32: the low word carries into the high one
    start = (1 << 32) - rows // 2 - 1
    whole = engine.uniform_rows(3, start, 2 * rows, device="cpu")
    halves = [engine.uniform_rows(3, start, rows, device="cpu"),
              engine.uniform_rows(3, start + rows, rows, device="cpu")]
    np.testing.assert_array_equal(torch.cat(halves).numpy(), whole.numpy())


def test_gather_forms_are_the_full_range_draws():
    key = np.asarray(jax.random.PRNGKey(11))
    idx = np.sort(np.random.default_rng(3).choice(10_000, 3000,
                                                  replace=False))
    full = engine.uniform_rows(key, 0, 10_000, device="cpu").numpy()
    np.testing.assert_array_equal(
        engine.uniform_rows_at(key, idx, device="cpu").numpy(), full[idx])
    p = np.float32(0.25)
    np.testing.assert_array_equal(
        engine.bernoulli_rows_at(key, idx, p, device="cpu").numpy(),
        engine.bernoulli_rows(key, 0, 10_000, p, device="cpu").numpy()[idx])
    # 64-bit indices across 2^32, and padded block operands
    far = np.array([(1 << 32) - 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1],
                   np.uint64)
    np.testing.assert_array_equal(
        engine.uniform_rows_at(key, far, device="cpu").numpy(),
        engine.uniform_rows(key, (1 << 32) - 2, 4, device="cpu").numpy())
    np.testing.assert_array_equal(
        engine.uniform_rows_at(key, far, device="cpu").numpy(),
        np.asarray(jengine.uniform_rows_at(jnp.asarray(key), far)))
    lo, hi = engine.split_index_words(far)
    got = engine.bernoulli_rows_at_block(key, np.pad(lo, (0, 4)),
                                         np.pad(hi, (0, 4)), p, device="cpu")
    np.testing.assert_array_equal(
        got[:4].numpy(),
        engine.bernoulli_rows_at(key, far, p, device="cpu").numpy())


@pytest.mark.parametrize("s_cap,p", [(600, 0.02), (150, 0.02), (50, 0.0)])
def test_s_buffer_is_jax_nonzero(s_cap, p):
    # (150, 0.02) drops ~250 samples past the capacity: the forced overflow
    new_s = np.random.default_rng(1).random(20_000) < p
    want = np.asarray(jnp.nonzero(jnp.asarray(new_s), size=s_cap,
                                  fill_value=new_s.size)[0])
    idx, dropped = _s_buffer(_t(new_s), s_cap)
    np.testing.assert_array_equal(idx.numpy(), want)
    assert int(dropped) == max(0, int(new_s.sum()) - s_cap)
    assert idx.dtype == torch.int64 and dropped.dtype == torch.int32


# -- EIM's filter step ---------------------------------------------------------

@pytest.mark.parametrize("exact,d,rank", [(True, 5, 17), (False, 2, 17),
                                          (True, 3, 129)])
def test_filter_step_matches_jax(exact, d, rank):
    rng = np.random.default_rng(d + rank)
    x = _exact_pts(900, d, seed=rank, side=30) if exact else _float_pts(900, d)
    c = np.concatenate([x[rng.choice(900, 40, replace=False)],
                        np.full((9, d), 1e18, np.float32)])
    ds = np.floor(rng.random(900) * 500).astype(np.float32)
    hm = rng.random(900) < 0.6
    top = jengine.top_k_init(rank)
    jd, jtop = jengine.filter_tile_update(jnp.asarray(x), jnp.asarray(c),
                                          jnp.asarray(ds), jnp.asarray(hm),
                                          rank=rank, impl="ref")
    jd2, jtop2 = jengine.eim_filter_block(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(ds), jnp.asarray(hm),
        top, rank=rank, impl="ref")
    for chunk in (None, 64):
        d_blk, tops = engine.filter_tile_update(_t(x), _t(c), _t(ds), _t(hm),
                                                rank=rank, impl="ref",
                                                chunk=chunk)
        np.testing.assert_array_equal(d_blk.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tops.numpy(), np.asarray(jtop))
        d_blk, merged = engine.eim_filter_block(
            _t(x), _t(c), _t(ds), _t(hm), engine.top_k_init(rank, "cpu"),
            rank=rank, impl="ref", chunk=chunk)
        if exact:    # jitted, the reference's distances round otherwise
            np.testing.assert_array_equal(d_blk.numpy(), np.asarray(jd2))
            np.testing.assert_array_equal(merged.numpy(), np.asarray(jtop2))
        np.testing.assert_array_equal(merged.numpy()[:tops.shape[0]],
                                      tops.numpy()[:rank])


# -- eim_sample: both forms, both executors, any blocking ----------------------

def test_device_path_matches_jax(float_case):
    x, key, eager, _ = float_case
    _same_sample(eim_sample(x, K, np.asarray(key), device="cpu"), eager)
    # an int seed is the key it makes
    _same_sample(eim_sample(_t(x), K, KEY_SEED, device="cpu"), eager)


@pytest.mark.parametrize("block_rows", [1000, 3777, 8192])
def test_host_stream_any_blocking(float_case, block_rows):
    x, key, eager, _ = float_case
    got = eim_sample(HostSource(x), K, KEY_SEED, executor=_host(block_rows))
    _same_sample(got, eager)


@pytest.mark.parametrize("compact_threshold", [0.0, 0.5, 1.0])
def test_host_stream_compacted(float_case, compact_threshold):
    x, key, eager, _ = float_case
    got = eim_sample(HostSource(x), K, KEY_SEED, executor=_host(4096),
                     compact_threshold=compact_threshold)
    _same_sample(got, eager)


@pytest.mark.parametrize("compact_threshold", [0.0, 1.0])
def test_generator_and_disk_sources(float_case, tmp_path, compact_threshold):
    x, key, eager, _ = float_case
    gen = SyntheticSource(lambda s, r: x[s:s + r], N, 2, name="fixture")
    disk = MemmapSource.save_shards(x, tmp_path, rows_per_shard=1500)
    for src in (gen, disk):
        _same_sample(eim_sample(src, K, KEY_SEED, executor=_host(4096),
                                compact_threshold=compact_threshold), eager)


@pytest.mark.parametrize("form", ["device", "host", "host_compacted", "sim",
                                  "sim_compacted"])
def test_exact_tier_every_form_is_the_jitted_reference(exact_case, form):
    x, key, want = exact_case
    if form == "device":
        got = eim_sample(x, K, KEY_SEED, device="cpu")
    elif form.startswith("host"):
        got = eim_sample(HostSource(x), K, KEY_SEED, executor=_host(3777),
                         compact_threshold=1.0 if "compacted" in form else 0.0)
    else:
        got = eim_sample(ArraySource(x, device="cpu"), K, KEY_SEED,
                         executor=SimExecutor(m=8, device="cpu"),
                         compact_threshold=1.0 if "compacted" in form else 0.0)
    _same_sample(got, want)


def test_sim_executor_float_matches_eager_reference(float_case):
    # the JAX SimExecutor's jitted split (ROADMAP) does not reach the port
    x, key, eager, _ = float_case
    with jax.disable_jit():
        jsim = jeim_sample(JArraySource(x), K, key, impl="ref",
                           executor=JSimExecutor(m=8))
    _same_sample(jsim, eager)
    got = eim_sample(ArraySource(x, device="cpu"), K, KEY_SEED,
                     executor=SimExecutor(m=8, device="cpu"))
    _same_sample(got, eager)


def test_jitted_reference_split_is_within_a_few_rows(float_case):
    # what the float parity above does not hold against: the jitted
    # reference's own rounding moves rows whose d(x, S) is within rounding
    # of a pivot
    _, _, eager, jitted = float_case
    moved = int((np.asarray(eager.sample_mask)
                 != np.asarray(jitted.sample_mask)).sum())
    assert moved <= 2
    np.testing.assert_array_equal(np.asarray(eager.s_mask),
                                  np.asarray(jitted.s_mask))


class _MeteredExecutor(HostStreamExecutor):
    """Records the rows each filter round folds over."""

    def __init__(self, **kw):
        super().__init__(device="cpu", **kw)
        self.pass_rows = []

    def run_filter_round(self, source, *a, **kw):
        self.pass_rows.append(source.n)
        return super().run_filter_round(source, *a, **kw)


def test_compaction_shrinks_the_passes(float_case):
    x, _, eager, _ = float_case
    full, compacted = (_MeteredExecutor(block_rows=4096) for _ in range(2))
    eim_sample(HostSource(x), K, KEY_SEED, executor=full,
               compact_threshold=0.0)
    _same_sample(eim_sample(HostSource(x), K, KEY_SEED, executor=compacted,
                            compact_threshold=1.0), eager)
    iters = int(eager.iters)
    assert full.pass_rows == [N] * iters
    assert compacted.pass_rows[0] == N and len(compacted.pass_rows) == iters
    assert all(a >= b for a, b in zip(compacted.pass_rows,
                                      compacted.pass_rows[1:]))
    assert compacted.pass_rows[-1] < N


# -- eim: the final GON and the radius ---------------------------------------

def test_eim_d2_matches_jax(float_case):
    x, key, _, _ = float_case
    with jax.disable_jit():
        want = jeim(jnp.asarray(x), K, key, impl="ref")
    for got in (eim(x, K, KEY_SEED, device="cpu"),
                eim(HostSource(x), K, KEY_SEED, executor=_host(2048)),
                eim(ArraySource(x, device="cpu"), K, KEY_SEED,
                    executor=SimExecutor(m=8, device="cpu"))):
        np.testing.assert_array_equal(got.centers.numpy(),
                                      np.asarray(want.centers))
        assert float(got.radius2) == float(want.radius2)
        _same_sample(got.sample, want.sample)
        # radius2 is the squared fold itself
        _, d2 = engine.assign_nearest(_t(x), got.centers, impl="ref")
        assert float(got.radius2) == float(d2.max())


def test_eim_exact_d38_matches_jax():
    x = _exact_pts(12_000, 38, seed=4, side=50)
    key = jax.random.PRNGKey(2)
    want = jeim(jnp.asarray(x), 3, key, impl="ref")
    assert bool(want.sample.sampled)
    for got in (eim(x, 3, 2, device="cpu"),
                eim(HostSource(x), 3, 2, executor=_host(5000))):
        np.testing.assert_array_equal(got.centers.numpy(),
                                      np.asarray(want.centers))
        assert float(got.radius2) == float(want.radius2)
        _same_sample(got.sample, want.sample)


def test_eim_uncompacted_and_chunked_device_path(exact_case):
    x, key, _ = exact_case
    base = eim(x, K, KEY_SEED, device="cpu")
    for got in (eim(x, K, KEY_SEED, chunk=777, device="cpu"),
                eim(HostSource(x), K, KEY_SEED, chunk=333,
                    executor=_host(3000))):
        np.testing.assert_array_equal(got.centers.numpy(),
                                      base.centers.numpy())
        assert float(got.radius2) == float(base.radius2)
        _same_sample(got.sample, base.sample)
    full = eim(x, K, KEY_SEED, compact=False, device="cpu")
    want = jeim(jnp.asarray(x), K, key, impl="ref", compact=False)
    np.testing.assert_array_equal(full.centers.numpy(),
                                  np.asarray(want.centers))


def test_degenerate_regime_is_gon():
    # n under the loop threshold: C is everything and EIM is GON
    x = _float_pts(500, 3, seed=7)
    key = jax.random.PRNGKey(0)
    want = jeim(jnp.asarray(x), 8, key, impl="ref")
    gon = gonzalez(x, 8, device="cpu")
    for got in (eim(x, 8, 0, device="cpu"),
                eim(HostSource(x), 8, 0, executor=_host(100))):
        assert not bool(got.sample.sampled) and int(got.sample.iters) == 0
        np.testing.assert_array_equal(got.centers.numpy(),
                                      np.asarray(want.centers))
        np.testing.assert_array_equal(got.centers.numpy(),
                                      gon.centers.numpy())
        # the assign's squared fold (GON's own radius2 is the direct form's)
        assert float(got.radius2) == float(want.radius2)


@pytest.mark.parametrize("streamed", [False, True])
def test_cap_is_a_hard_error(exact_case, streamed):
    # max_iters=0 in the sampling regime leaves |R| = n past the §4 bound
    x, _, _, = exact_case
    points = HostSource(x) if streamed else x
    kw = dict(executor=_host(4096)) if streamed else dict(device="cpu")
    with pytest.raises(RuntimeError, match="max_iters"):
        eim(points, K, KEY_SEED, max_iters=0, **kw)
    assert _sample_cap(N, K, 0.1, 0) < N


def test_argument_errors():
    x = _float_pts(1000, seed=3)
    with pytest.raises(ValueError, match="compact_threshold"):
        eim_sample(HostSource(x), 4, 0, executor=_host(100),
                   compact_threshold=1.5)
    with pytest.raises(ValueError, match="compact_threshold"):
        eim(x, 4, 0, device="cpu", compact_threshold=-0.1)
    with pytest.raises(ValueError, match="compact"):
        eim(HostSource(x), 4, 0, compact=False, executor=_host(100))

    class _NoFilter(Executor):
        device = torch.device("cpu")

    with pytest.raises(NotImplementedError, match="run_filter_round"):
        eim_sample(HostSource(x), 4, 0, executor=_NoFilter())
    with pytest.raises(ValueError, match="executor"):
        eim(HostSource(x), 4, 0, executor=_host(100), device="cpu")


def test_indexed_source_views():
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    w = np.arange(20, dtype=np.float32)
    parent = WeightedSource(HostSource(x), w)
    view = IndexedSource(parent, [1, 4, 7, 9, 15])
    nested = IndexedSource(view, [0, 2, 4])
    assert nested.parent is parent and nested.indices.tolist() == [1, 7, 15]
    np.testing.assert_array_equal(nested.take([2, 0]), x[[15, 1]])
    np.testing.assert_array_equal(
        torch.cat(list(view.blocks(2, device="cpu"))).numpy(), x[view.indices])
    np.testing.assert_array_equal(view.materialize("cpu").numpy(),
                                  x[view.indices])
    assert view.has_weights and view.weights_of(1, 3).tolist() == [4, 7, 9]
    assert view.take_weights([4]).tolist() == [15]
    assert view.row(1).tolist() == x[4].tolist()
    with pytest.raises(ValueError, match="increasing"):
        IndexedSource(parent, [3, 3])
    with pytest.raises(IndexError):
        IndexedSource(parent, [0, 20])


def test_result_to_numpy_nests(exact_case):
    x, _, _ = exact_case
    res = interop.result_to_numpy(eim(x[:3000], 3, 5, device="cpu"))
    assert res["centers"].shape == (3, 2)
    assert res["sample"]["sample_mask"].dtype == np.bool_
    assert res["sample"]["iters"].dtype == np.int32


# -- the row-chunked passes ----------------------------------------------------

@pytest.mark.parametrize("n,m,d,chunk,budget", [
    (1000, 37, 5, 64, None), (1000, 37, 5, None, 20_000),
    (300, 700, 3, 7, None), (10, 4, 2, 1, None), (10, 4, 2, 50, None)])
def test_resolve_chunk_is_jax(n, m, d, chunk, budget):
    assert (engine.resolve_chunk(n, m, d, chunk=chunk, memory_budget=budget)
            == jengine.resolve_chunk(n, m, d, chunk=chunk,
                                     memory_budget=budget))


def test_resolve_chunk_errors():
    with pytest.raises(ValueError, match="chunk"):
        engine.resolve_chunk(10, 4, 2, chunk=0)
    with pytest.raises(ValueError, match="memory_budget"):
        engine.resolve_chunk(10, 100, 2, memory_budget=100)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("chunk", [1, 97, 256, 5000])
def test_chunked_ops_are_the_unchunked(exact, chunk):
    rng = np.random.default_rng(chunk)
    d = 6 if exact else 2
    x = _exact_pts(1500, d, seed=chunk, side=20) if exact else _float_pts(1500)
    c = x[rng.choice(1500, 31, replace=False)].copy()
    x[7] = x[900]                 # a tie across chunks for the argmin
    xt, ct = _t(x), _t(c)
    kw = dict(impl="ref", chunk=chunk)
    for a, b in zip(engine.assign_nearest(xt, ct, **kw),
                    engine.assign_nearest(xt, ct, impl="ref")):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(engine.pairwise_dist2(xt, ct, **kw).numpy(),
                                  engine.pairwise_dist2(xt, ct).numpy())
    np.testing.assert_array_equal(
        engine.argmin_dist2_over_rows(xt, ct, **kw).numpy(),
        engine.argmin_dist2_over_rows(xt, ct, impl="ref").numpy())
    ds, hm = _t(rng.random(1500).astype(np.float32) * 50), _t(rng.random(1500) < .5)
    a = engine.fused_filter(xt, ct, ds.clone(), hm, rank=9, **kw)
    b = engine.fused_filter(xt, ct, ds.clone(), hm, rank=9, impl="ref")
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u.numpy(), v.numpy())
    w = _t(np.floor(rng.random(1500) * 4).astype(np.float32))
    for ww, dt in ((None, torch.int32), (w, torch.float32)):
        np.testing.assert_array_equal(
            engine.assign_sums(xt, ct, torch.zeros(31, dtype=dt), ww,
                               **kw).numpy(),
            engine.assign_sums(xt, ct, torch.zeros(31, dtype=dt), ww,
                               impl="ref").numpy())
    # the GON step over 3 machines, with masked rows and a tie across chunks
    xb = _t(x[:1500].reshape(3, 500, d))
    md0 = torch.full((3, 500), 3.4e38)
    md0[1, ::3] = -3.4e38
    outs = []
    for ck in (None, chunk):
        centers = torch.zeros((3, 2, d))
        indices = torch.zeros((3, 2), dtype=torch.int32)
        got = engine.fused_min_argmax(xb, xb[:, 0], md0.clone(), impl="ref",
                                      centers=centers, indices=indices,
                                      slot=1, chunk=ck)
        outs.append((*got, centers, indices))
    for u, v in zip(*outs):
        np.testing.assert_array_equal(u.numpy(), v.numpy())


def test_chunked_ops_match_jax_chunked():
    x = _exact_pts(700, 4, seed=2, side=20)
    c = x[:23]
    ji, jd = jengine.assign_nearest(jnp.asarray(x), jnp.asarray(c),
                                    impl="ref", chunk=64)
    ti, td = engine.assign_nearest(_t(x), _t(c), impl="ref", chunk=64)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(
        engine.argmin_dist2_over_rows(_t(x), _t(c), impl="ref",
                                      memory_budget=4000).numpy(),
        np.asarray(jengine.argmin_dist2_over_rows(
            jnp.asarray(x), jnp.asarray(c), impl="ref", memory_budget=4000)))


# -- chunk= on the entry points: chunked equals unchunked, bitwise ------------

def _eq(a, b):
    for u, v in zip(interop.result_to_numpy(a).values(),
                    interop.result_to_numpy(b).values()):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def test_mrg_chunked():
    x = _float_pts(3000, 2, seed=5)
    _eq(mrg(x, 6, m=5, chunk=77, device="cpu"), mrg(x, 6, m=5, device="cpu"))
    src = HostSource(x)
    _eq(mrg(src, 6, executor=_host(700), chunk=50),
        mrg(src, 6, executor=_host(700)))
    want = jmrg(JHostSource(x), 6, executor=JHostStreamExecutor(block_rows=700),
                impl="ref", chunk=50)
    np.testing.assert_array_equal(
        mrg(src, 6, executor=_host(700), chunk=50).centers.numpy(),
        np.asarray(want.centers))


def test_select_coreset_chunked():
    x = _exact_pts(2500, 5, seed=6, side=20)
    for src, kw in ((x, dict(device="cpu")),
                    (HostSource(x), dict(executor=_host(600)))):
        _eq(select_coreset(src, 9, chunk=41, **kw),
            select_coreset(src, 9, **kw))


def test_kz_center_chunked():
    x = _float_pts(2000, 3, seed=7)
    x[:4] += 50.0
    got = kz_center(x, 3, 4, m=5, chunk=90, device="cpu")
    _eq(got, kz_center(x, 3, 4, m=5, device="cpu"))
    want = jkz_center(x, 3, 4, m=5, impl="ref", chunk=90)
    np.testing.assert_array_equal(got.centers.numpy(),
                                  np.asarray(want.centers))


def test_stream_update_chunked():
    x = _float_pts(3000, 2, seed=8)
    a = stream_update(stream_init(5, 2), HostSource(x), chunk=64,
                      block_rows=500, device="cpu")
    b = stream_update(stream_init(5, 2), HostSource(x), block_rows=500,
                      device="cpu")
    np.testing.assert_array_equal(a.centers, b.centers)
    assert (a.count, a.r) == (b.count, b.r)


def test_eim_doctests():
    mod = importlib.import_module("repro_torch.core.eim")
    result = doctest.testmod(mod, verbose=False)
    assert result.attempted > 0 and result.failed == 0


def test_eim_schedule_is_jax():
    for n, k in ((1_000_000, 25), (10_000_000, 25), (400_000, 25), (N, K)):
        assert _params(n, k, 0.1, 8.0) == jparams(n, k, 0.1, 8.0)
