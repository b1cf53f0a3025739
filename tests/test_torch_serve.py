"""The port's online k-center service (``repro_torch.serve``) and its query
op ``engine.assign_bucketed``, on the CPU (``device="cpu"``: the plain
versions).

  * ``assign_bucketed`` against the JAX package's eager
    ``ops.assign_bucketed`` on the same numpy buckets (masked rows, one live
    center, the shape where the live set and its bucket take different
    routes of ``assign_plan``): bitwise on the exact tier (integer
    coordinates), within tests/test_kernels.py's rtol 1e-4 / atol 1e-4 on
    floats, with the index equal wherever the nearest center wins by a
    margin; and against the port's own ``assign_nearest`` on the live
    rows, bitwise.
  * the service fed a fixed series of batches: its snapshots bitwise the
    JAX package's ``stream_update`` over the same batches, its answers
    bitwise the port's offline ``ops.assign_nearest`` on the snapshot of
    their epoch and, against the JAX package's eager ``ops.assign_nearest``,
    within the tolerance above (bitwise on the exact tier).
  * the serving contracts of tests/test_serve_kcenter.py, ported.

The JAX service's own answers are compared with nothing here, and the JAX
package's per-insertion ("device") tail runs on a few hundred points only:
each of its passes has a new shape, which JAX compiles.
"""
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import streaming as jstreaming
from repro.kernels import ops as jops
from repro_torch.core import stream_init, stream_result, stream_update
from repro_torch.data import pointsets
from repro_torch.data.source import HostSource
from repro_torch.kernels import _build, engine, ops
from repro_torch.kernels.assign import (WIDE_MAX_KD, assign_nearest_cuda,
                                        assign_plan)
from repro_torch.serve import AssignTicket, KCenterService
from repro_torch.serve.kcenter import _pow2_at_least

TOL = dict(rtol=1e-4, atol=1e-4)      # tests/test_kernels.py
WAIT = 60                             # seconds, every result / drain / join


def _svc(k, d, **kw):
    return KCenterService(k, d, device="cpu", **kw)


def _points(rng, n, d, exact, scale=5.0):
    if exact:
        return np.floor(rng.random((n, d)) * 40).astype(np.float32)
    return (rng.normal(size=(n, d)) * scale).astype(np.float32)


def _offline(q, centers):
    """The port's offline assign (plain route) on host arrays."""
    i, d2 = ops.assign_nearest(torch.from_numpy(np.asarray(q, np.float32)),
                               torch.from_numpy(np.asarray(centers)))
    return i.numpy(), d2.numpy()


def _same(res, want):
    np.testing.assert_array_equal(res[0], want[0])
    np.testing.assert_array_equal(res[1], want[1])


def _unique_rows(q, centers, margin=1e-3):
    """Rows whose nearest center wins by more than ``margin`` (relative),
    by float64 distances."""
    d2 = ((q[:, None, :].astype(np.float64) - centers[None]) ** 2).sum(-1)
    if d2.shape[1] < 2:
        return np.ones(q.shape[0], bool)
    two = np.sort(d2, axis=1)[:, :2]
    return two[:, 1] - two[:, 0] > margin * np.maximum(1.0, two[:, 0])


def _near_jax(idx, d2, jidx, jd2, q, centers, exact):
    """Port results against the JAX package's: bitwise on the exact tier;
    on floats d2 within TOL and idx equal where the winner is unique.
    ``centers`` are the rows ``idx`` indexes."""
    jidx, jd2 = np.asarray(jidx), np.asarray(jd2)
    if exact:
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(d2, jd2)
        return
    np.testing.assert_allclose(d2, jd2, **TOL)
    unique = _unique_rows(q, centers)
    assert unique.sum() > 0.9 * q.shape[0]
    np.testing.assert_array_equal(idx[unique], jidx[unique])


# ---------------------------------------------------------------------------
# assign_bucketed
# ---------------------------------------------------------------------------

# (name, query rows, padded query rows, bucket slots, live rows, d)
BUCKETS = [
    ("holes", 33, 64, 16, [0, 1, 2, 5, 6, 9, 10, 11, 15], 6),
    ("prefix", 5, 8, 8, list(range(7)), 3),
    ("one_center", 37, 64, 8, [5], 16),
    ("route_crossing", 200, 256, 64, list(range(50)), 7),
]


def _bucket(name, b, bq, mcap, live, d, exact):
    rng = np.random.default_rng(len(name) * 7 + b)
    q = np.zeros((bq, d), np.float32)
    q[:b] = _points(rng, b, d, exact)
    # the masked rows hold values that would win (the bucket's own fill is
    # the caller's business): the mask alone keeps them out
    c = _points(rng, mcap, d, exact)
    mask = np.zeros((mcap,), np.float32)
    mask[live] = 1.0
    return q, c, mask


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "float"])
@pytest.mark.parametrize("case", BUCKETS, ids=[c[0] for c in BUCKETS])
def test_assign_bucketed_matches_jax_and_own_assign(case, exact):
    name, b, bq, mcap, live, d = case
    q, c, mask = _bucket(name, b, bq, mcap, live, d, exact)
    idx, d2 = engine.assign_bucketed(torch.from_numpy(q), torch.from_numpy(c),
                                     mask)
    assert idx.dtype == torch.int32 and idx.shape == (bq,)
    idx, d2 = idx.numpy()[:b], d2.numpy()[:b]
    assert np.isin(idx, live).all()
    # (b) bitwise the port's assign on the live rows alone
    li, ld = _offline(q[:b], c[live])
    np.testing.assert_array_equal(idx, np.asarray(live)[li])
    np.testing.assert_array_equal(d2, ld)
    # (a) the JAX package's eager op on the same buckets
    ji, jd = jops.assign_bucketed(jnp.asarray(q), jnp.asarray(c),
                                  jnp.asarray(mask))
    _near_jax(idx, d2, np.asarray(ji)[:b], np.asarray(jd)[:b], q[:b], c,
              exact)


def test_route_crossing_shape_takes_both_routes():
    # 50 live centers at d = 7 plan onto the wide kernel (k·d = 350), their
    # 64-slot bucket onto the tiled one (448): the op plans on the live run
    assert 50 * 7 < WIDE_MAX_KD <= 64 * 7
    assert assign_plan(256, 50, 7, 132).tc == 0
    assert assign_plan(256, 64, 7, 132).tc > 0


def test_assign_bucketed_mask_forms_and_validation():
    q, c, mask = _bucket("holes", 33, 64, 16, [3, 4, 5], 6, False)
    want = engine.assign_bucketed(torch.from_numpy(q), torch.from_numpy(c),
                                  mask)
    for form in (mask > 0, torch.from_numpy(mask), torch.from_numpy(mask > 0)):
        got = engine.assign_bucketed(torch.from_numpy(q), torch.from_numpy(c),
                                     form)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="shape"):
        engine.assign_bucketed(torch.from_numpy(q), torch.from_numpy(c),
                               mask[:8])
    with pytest.raises(ValueError, match="no live"):
        engine.assign_bucketed(torch.from_numpy(q), torch.from_numpy(c),
                               np.zeros(16, np.float32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        engine.assign_bucketed(torch.from_numpy(q), torch.from_numpy(c),
                               mask, impl="kernel")


# ---------------------------------------------------------------------------
# the service against the JAX sketch and the offline assign
# ---------------------------------------------------------------------------

def _feeds(case):
    """(k, d, batches, queries a step, exact) of a fixed ingest series."""
    rng = np.random.default_rng(11)
    if case == "one_center":
        # k+1 unit vectors in high d: the bootstrap merge keeps one center
        k, d = 16, 16
        pts = rng.normal(size=(k + 1, d)).astype(np.float32)
        pts /= np.linalg.norm(pts, axis=1, keepdims=True)
        return k, d, [pts], [rng.normal(size=(37, d)).astype(np.float32)], False
    exact = case == "epochs_exact"
    k, d = 8, 6
    batches, queries = [], []
    for scale, seed in ((1.0, 1), (10.0, 2), (100.0, 3)):
        x = pointsets.gau(300, k, d=d, seed=seed) * np.float32(scale)
        batches.append(np.floor(x) if exact else x)
        queries.append(_points(rng, 33, d, exact, scale))
    return k, d, batches, queries, exact


@pytest.mark.parametrize("case", ["epochs_float", "epochs_exact",
                                  "one_center"])
def test_served_answers_match_offline_and_jax(case):
    k, d, batches, queries, exact = _feeds(case)
    jstate = jstreaming.stream_init(k, d)
    with _svc(k, d, snapshot_history=True) as svc:
        for x, q in zip(batches, queries):
            svc.submit_points(x)
            svc.drain(timeout=WAIT)
            jstate = jstreaming.stream_update(jstate, x)
            epoch, centers, r = svc.snapshot()
            jc, jr = jstreaming.stream_result(jstate)
            np.testing.assert_array_equal(centers, np.asarray(jc))
            assert r == jr
            res = svc.assign(q, timeout=WAIT)
            assert res.epoch == epoch
            _same(res, _offline(q, svc.snapshot_at(res.epoch)))
            ji, jd = jops.assign_nearest(jnp.asarray(q), jnp.asarray(centers))
            _near_jax(res.idx, res.d2, ji, jd, q, centers, exact)
        if case == "one_center":
            assert centers.shape[0] == 1     # the regime under test
        else:
            assert svc.stats["epochs"] >= 2


@pytest.mark.parametrize("tail", ["host", "device"])
def test_both_tails_match_jax(tail):
    k, d = 5, 4
    pts = pointsets.gau(150, 8, d=d, seed=3)
    jstate = jstreaming.stream_init(k, d)
    with _svc(k, d, ingest_tail=tail) as svc:
        for part in np.array_split(pts, 3):
            svc.submit_points(part)
            jstate = jstreaming.stream_update(jstate, part, tail=tail)
        svc.drain(timeout=WAIT)
        _, centers, r = svc.snapshot()
        jc, jr = jstreaming.stream_result(jstate)
        np.testing.assert_array_equal(centers, np.asarray(jc))
        assert r == jr and 1 < centers.shape[0] <= k
        q = pts[::7]
        _same(svc.assign(q, timeout=WAIT), _offline(q, centers))


# ---------------------------------------------------------------------------
# serving contracts (tests/test_serve_kcenter.py, ported)
# ---------------------------------------------------------------------------

def test_parity_under_interleaved_ingest():
    """Epoch bumps racing a query stream: every answer must still be
    bitwise-correct for the centers of the epoch that answered it."""
    k, d = 8, 4
    rng = np.random.default_rng(1)
    with _svc(k, d, snapshot_history=True) as svc:
        svc.submit_points(pointsets.gau(400, k, d=d, seed=0))
        svc.drain(timeout=WAIT)
        stop = threading.Event()
        feed_pts = pointsets.gau(100, k, d=d, seed=7)

        def feeder():
            scale = 1.0
            while not stop.is_set():
                # keep forcing center-set changes; wrap before f32 overflow
                scale = scale * 1.5 if scale < 1e12 else 1.0
                svc.submit_points(feed_pts * np.float32(scale))
                svc.drain(timeout=WAIT)

        feed = threading.Thread(target=feeder, daemon=True)
        feed.start()
        try:
            for _ in range(40):
                q = rng.normal(size=(9, d)).astype(np.float32) * 10
                res = svc.assign(q, timeout=WAIT)
                _same(res, _offline(q, svc.snapshot_at(res.epoch)))
        finally:
            stop.set()
            feed.join(timeout=WAIT)
        assert not feed.is_alive()
        svc.drain(timeout=WAIT)
        assert svc.stats["epochs"] >= 2   # the race actually happened


def test_covered_ingest_bumps_no_epoch_and_refreshes_no_cache():
    k, d = 8, 6
    with _svc(k, d) as svc:
        svc.submit_points(pointsets.gau(800, k, d=d, seed=0))
        svc.drain(timeout=WAIT)
        epoch0, centers, r = svc.snapshot()
        svc.assign(centers[:1], timeout=WAIT)      # populate the cache
        st0 = svc.stats
        # points on (and 1e-6 off) the live centers are covered: the sketch
        # must absorb them without publishing
        for _ in range(5):
            svc.submit_points(centers)
            svc.submit_points(centers + 1e-6)
        svc.drain(timeout=WAIT)
        assert svc.snapshot()[0] == epoch0
        svc.assign(centers[:3], timeout=WAIT)
        st1 = svc.stats
        assert st1["epochs"] == st0["epochs"]
        assert st1["cache_refreshes"] == st0["cache_refreshes"]


def _spy_bucketed(monkeypatch, seen):
    real = ops.assign_bucketed

    def spy(q, c, cmask, **kw):
        seen.append((tuple(q.shape), tuple(c.shape), np.asarray(cmask).shape,
                     kw.get("impl"), kw.get("chunk")))
        return real(q, c, cmask, **kw)

    monkeypatch.setattr(ops, "assign_bucketed", spy)


def test_one_signature_across_ragged_batches_and_epochs(monkeypatch):
    k, d = 8, 6
    seen = []
    _spy_bucketed(monkeypatch, seen)
    with _svc(k, d, min_bucket=16, center_bucket_min=16,
              snapshot_history=True) as svc:
        svc.submit_points(pointsets.gau(600, k, d=d, seed=0))
        svc.drain(timeout=WAIT)
        rng = np.random.default_rng(0)
        svc.assign(rng.normal(size=(5, d)).astype(np.float32), timeout=WAIT)
        warm = set(seen)
        assert len(warm) == 1             # one (query-bucket, center-bucket)
        # ragged sizes all inside the same 16-row bucket
        for b in (1, 3, 7, 12, 16):
            svc.assign(rng.normal(size=(b, d)).astype(np.float32),
                       timeout=WAIT)
        assert set(seen) == warm
        # an epoch bump within the same center bucket: the cache is copied
        # into the same buffers and the shapes do not move
        st_before = svc.stats
        svc.submit_points(pointsets.gau(200, k, d=d, seed=1) * 50.0)
        svc.drain(timeout=WAIT)
        assert svc.stats["epochs"] > st_before["epochs"]
        q = rng.normal(size=(9, d)).astype(np.float32)
        res = svc.assign(q, timeout=WAIT)
        _same(res, _offline(q, svc.snapshot_at(res.epoch)))
        assert set(seen) == warm
        assert svc.stats["bucket_growths"] == 1   # only the initial fill
        assert svc.stats["cache_refreshes"] == 2


def test_query_buckets_are_pow2_and_capped(monkeypatch):
    k, d = 4, 3
    seen = []
    _spy_bucketed(monkeypatch, seen)
    with _svc(k, d, min_bucket=4, max_batch=8) as svc:
        svc.submit_points(pointsets.gau(300, k, d=d, seed=0))
        svc.drain(timeout=WAIT)
        rng = np.random.default_rng(0)
        # 21 rows > max_batch: slices of 8, 8, 5 → buckets 8, 8, 8
        q = rng.normal(size=(21, d)).astype(np.float32)
        res = svc.assign(q, timeout=WAIT)
        _same(res, _offline(q, svc.snapshot()[1]))
        assert [s[0][0] for s in seen] == [8, 8, 8]
        seen.clear()
        svc.assign(rng.normal(size=(3, d)).astype(np.float32), timeout=WAIT)
        assert [s[0][0] for s in seen] == [4]     # pow2 floor bucket
    assert [_pow2_at_least(n, 8) for n in (1, 8, 9, 100)] == [8, 8, 16, 128]


def test_concurrent_clients_coalesce_and_stay_correct():
    k, d = 8, 5
    n_clients = 16
    with _svc(k, d, batch_wait_s=0.05) as svc:
        svc.submit_points(pointsets.gau(500, k, d=d, seed=0))
        svc.drain(timeout=WAIT)
        _, centers, _ = svc.snapshot()
        rng = np.random.default_rng(0)
        qs = [rng.normal(size=(1 + i % 4, d)).astype(np.float32)
              for i in range(n_clients)]
        tickets = [svc.assign_async(q) for q in qs]
        for q, t in zip(qs, tickets):
            _same(t.result(timeout=WAIT), _offline(q, centers))
        st = svc.stats
        assert st["queries"] == n_clients
        assert st["batches"] < n_clients          # coalescing happened
        assert st["batched_rows"] == sum(q.shape[0] for q in qs)


def test_unbatched_mode_dispatches_each_request_alone():
    k, d = 4, 3
    with _svc(k, d, batching=False) as svc:
        svc.submit_points(pointsets.gau(200, k, d=d, seed=0))
        svc.drain(timeout=WAIT)
        rng = np.random.default_rng(0)
        tickets = [svc.assign_async(rng.normal(size=(2, d)).astype(np.float32))
                   for _ in range(4)]
        for t in tickets:
            t.result(timeout=WAIT)
        st = svc.stats
        assert st["batches"] == st["queries"] == 4


def test_ticket_timestamps_and_done():
    k, d = 4, 3
    with _svc(k, d) as svc:
        svc.submit_points(pointsets.gau(200, k, d=d, seed=0))
        svc.drain(timeout=WAIT)
        t = svc.assign_async(np.zeros((1, d), np.float32))
        assert isinstance(t, AssignTicket)
        t.result(timeout=WAIT)
        assert t.done()
        assert t.t_done >= t.t_submit


def test_point_source_ingest_matches_offline_fold():
    k, d = 8, 4
    pts = pointsets.gau(700, k, d=d, seed=2)
    with _svc(k, d, ingest_block_rows=128) as svc:
        svc.submit_points(HostSource(pts))
        svc.drain(timeout=WAIT)
        _, centers, r = svc.snapshot()
    want = stream_update(stream_init(k, d), HostSource(pts), block_rows=128,
                         device="cpu")
    want_c, want_r = stream_result(want)
    assert r == want_r
    np.testing.assert_array_equal(centers, want_c)


class _FailingSource(HostSource):
    """A host source whose second block cannot be read."""

    def host_blocks(self, block_rows):
        yield from list(super().host_blocks(block_rows))[:1]
        raise OSError("shard unreadable")


def test_ingest_errors_surface_on_drain():
    with _svc(4, 3, ingest_block_rows=100) as svc:
        with pytest.raises(ValueError):
            svc.submit_points(np.zeros((5, 7), np.float32))  # wrong d
        svc.submit_points(np.zeros((5, 3), np.float32))
        svc.drain(timeout=WAIT)
        svc.submit_points(_FailingSource(np.ones((300, 3), np.float32)))
        with pytest.raises(RuntimeError, match="ingest thread failed") as err:
            svc.drain(timeout=WAIT)
        assert isinstance(err.value.__cause__, OSError)
        with pytest.raises(RuntimeError, match="ingest thread failed"):
            svc.submit_points(np.zeros((5, 3), np.float32))


def test_assign_before_any_centers_fails():
    with _svc(4, 3) as svc:
        with pytest.raises(RuntimeError, match="no centers"):
            svc.assign(np.zeros((1, 3), np.float32), timeout=WAIT)


def test_closed_service_rejects_work():
    svc = _svc(4, 3)
    svc.close()
    assert not svc._ingest_thread.is_alive()
    assert not svc._dispatch_thread.is_alive()
    with pytest.raises(RuntimeError):
        svc.assign(np.zeros((1, 3), np.float32))
    with pytest.raises(RuntimeError):
        svc.submit_points(np.zeros((1, 3), np.float32))
    svc.close()                                    # idempotent


def test_query_validation():
    with _svc(4, 3) as svc:
        with pytest.raises(ValueError):
            svc.assign_async(np.zeros((2, 5), np.float32))   # wrong d
        with pytest.raises(ValueError):
            svc.assign_async(np.zeros((0, 3), np.float32))   # empty
        t = svc.assign_async(np.zeros(3, np.float32))        # (d,) promotes
        assert t.q.shape == (1, 3)
    with pytest.raises(ValueError):
        _svc(0, 3)
    with pytest.raises(ValueError):
        _svc(4, 3, max_batch=0)


def test_failed_launch_fails_its_tickets():
    # the kernel route on CPU tensors raises: the micro-batch's tickets
    # fail with that error, nothing falls back to the plain version
    with _svc(4, 3, impl="kernel", batch_wait_s=0.05) as svc:
        svc.submit_points(pointsets.gau(200, 4, d=3, seed=0))
        svc.drain(timeout=WAIT)
        tickets = [svc.assign_async(np.zeros((2, 3), np.float32))
                   for _ in range(3)]
        for t in tickets:
            with pytest.raises(ValueError, match="CUDA tensors"):
                t.result(timeout=WAIT)


def test_default_device_is_the_card():
    """Without a GPU the default device raises; with one, the service
    serves on the card, bitwise the kernel's offline assign (phase 11 of
    chip_smoke.py checks it at full size)."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            KCenterService(4, 3)
        return
    q = np.random.default_rng(0).normal(size=(37, 3)).astype(np.float32)
    with KCenterService(4, 3, snapshot_history=True) as svc:
        svc.submit_points(pointsets.gau(300, 4, d=3, seed=0))
        svc.drain(timeout=WAIT)
        res = svc.assign(q, timeout=WAIT)
        c = torch.from_numpy(svc.snapshot_at(res.epoch)).cuda()
        i, d2 = ops.assign_nearest(torch.from_numpy(q).cuda(), c)
    _same(res, (i.cpu().numpy(), d2.cpu().numpy()))


def test_launch_counts_are_exact_under_threads():
    # the service launches kernel #2 from its ingest and dispatch threads:
    # a lost update of a wrapper's count would show here
    before = assign_nearest_cuda.launches
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for _ in range(2000):
                _build.count_launch(assign_nearest_cuda)

        threads = [threading.Thread(target=bump) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert assign_nearest_cuda.launches - before == 16 * 2000
    assign_nearest_cuda.launches = before
