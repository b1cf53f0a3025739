"""The port's streaming doubling sketch and its pairwise kernel's plain
version against the JAX package, on the CPU.

The same numpy inputs go through ``repro.core.streaming`` (its distance
passes on the reference path) and ``repro_torch.core.streaming``
(``device="cpu"``, the plain versions): the sketch's state — centers,
count and radius — is compared bitwise, on batches and over point sources,
with both insertion tails, and for a sketch fed its first batches in the
JAX package and carried on in the port. The pairwise plain version is held
to ``pairwise_dist2`` in interpret mode at tests/test_kernels.py's
tolerances (1e-4 in f32, 3e-2 in f16, atol ten times each).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import streaming as jstreaming
from repro.data import source as jsource
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import interop
from repro_torch.core import (stream_init, stream_result, stream_update)
from repro_torch.data import pointsets
from repro_torch.data.source import HostSource
from repro_torch.kernels import engine
from repro_torch.kernels.pairwise import pairwise_dist2_cuda


def _batches(rng, n, d, exact, parts):
    x = (np.floor(rng.random((n, d)) * 40) if exact
         else rng.normal(size=(n, d)) * 5.0).astype(np.float32)
    cuts = np.sort(rng.choice(np.arange(1, n), parts - 1, replace=False))
    return x, np.split(x, cuts)


def _same_state(got, want):
    assert (got.count, got.r, got.k) == (want.count, want.r, want.k)
    np.testing.assert_array_equal(got.centers[:got.count],
                                  np.asarray(want.centers)[:want.count])


def _stream_data(exact):
    return _batches(np.random.default_rng(int(exact)), 400, 3, exact, 4)


@pytest.mark.parametrize("tail,exact", [("host", False), ("host", True),
                                        ("device", False)])
def test_stream_update_on_batches_matches_jax(tail, exact):
    x, parts = _stream_data(exact)
    k = 7
    got, want = stream_init(k, 3), jstreaming.stream_init(k, 3)
    passes = stream_update.coverage_passes
    for b in parts:
        got = stream_update(got, b, tail=tail, device="cpu")
        want = jstreaming.stream_update(want, b, tail=tail)
        _same_state(got, want)
    assert stream_update.coverage_passes > passes
    centers, r = stream_result(got)
    jc, jr = jstreaming.stream_result(want)
    np.testing.assert_array_equal(centers, np.asarray(jc))
    assert r == jr and centers.shape[0] <= k
    # every point is within 8 r of a kept center (the doubling invariant)
    d2 = engine.assign_nearest(torch.from_numpy(x),
                               torch.from_numpy(centers))[1]
    assert float(d2.max().sqrt()) <= 8.0 * r + 1e-3


def test_stream_update_over_a_source_matches_jax():
    n, d, k = 1500, 2, 9
    x = pointsets.gau(n, seed=3)
    src, jsrc = HostSource(x), jsource.HostSource(x)
    reads = stream_update.host_reads
    passes = stream_update.coverage_passes
    got = stream_update(stream_init(k, d), src, block_rows=500, device="cpu")
    want = jstreaming.stream_update(jstreaming.stream_init(k, d), jsrc,
                                    block_rows=500)
    _same_state(got, want)
    # one read per coverage pass and one for the bootstrap, no other
    passes = stream_update.coverage_passes - passes
    assert stream_update.host_reads - reads == passes + 1 and passes >= 3


def test_sketch_carried_from_jax_mid_stream():
    _, parts = _stream_data(False)    # the batches test's, so JAX compiles once
    jstate = jstreaming.stream_init(7, 3)
    for b in parts[:2]:
        jstate = jstreaming.stream_update(jstate, b)
    state = interop.stream_state_from_jax(jstate)
    for b in parts[2:]:
        state = stream_update(state, b, device="cpu")
        jstate = jstreaming.stream_update(jstate, b)
    _same_state(state, jstate)


def test_stream_update_validates():
    with pytest.raises(ValueError, match="tail"):
        stream_update(stream_init(3, 2), np.zeros((4, 2), np.float32),
                      tail="gpu", device="cpu")
    # chunk is ported: the coverage pass in row chunks, the same sketch
    batch = np.random.default_rng(3).normal(size=(40, 2)).astype(np.float32)
    a = stream_update(stream_init(3, 2), batch, chunk=2, device="cpu")
    b = stream_update(stream_init(3, 2), batch, device="cpu")
    np.testing.assert_array_equal(a.centers, b.centers)
    assert (a.count, a.r) == (b.count, b.r)


@pytest.mark.parametrize("n,m,d", [(8, 8, 2), (100, 17, 3), (26, 26, 38)])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_pairwise_plain_matches_pallas_interpret(n, m, d, dtype):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, d)).astype(dtype)
    c = rng.normal(size=(m, d)).astype(dtype)
    want = jops.pairwise_dist2(jnp.asarray(x), jnp.asarray(c), impl="pallas",
                               bn=64, bm=16)
    got = engine.pairwise_dist2(torch.from_numpy(x), torch.from_numpy(c))
    assert got.dtype == torch.float32 and got.shape == (n, m)
    tol = 1e-4 if dtype == np.float32 else 3e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol * 10)
    if dtype == np.float32:     # the reference oracle, which equals it
        np.testing.assert_allclose(got.numpy(), np.asarray(
            jref.pairwise_dist2(jnp.asarray(x), jnp.asarray(c))),
            rtol=tol, atol=tol * 10)


def test_pairwise_exact_tier_bitwise_and_routes():
    rng = np.random.default_rng(9)
    x = np.floor(rng.random((70, 5)) * 30).astype(np.float32)
    got = engine.pairwise_dist2(torch.from_numpy(x), torch.from_numpy(x[:9]))
    want = jref.pairwise_dist2(jnp.asarray(x), jnp.asarray(x[:9]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    launches = pairwise_dist2_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        engine.pairwise_dist2(torch.from_numpy(x), torch.from_numpy(x),
                              impl="kernel")
    # chunk is ported: row chunks of the plain version, bitwise the same
    assert torch.equal(engine.pairwise_dist2(torch.from_numpy(x),
                                             torch.from_numpy(x), chunk=8),
                       engine.pairwise_dist2(torch.from_numpy(x),
                                             torch.from_numpy(x)))
    assert pairwise_dist2_cuda.launches == launches
