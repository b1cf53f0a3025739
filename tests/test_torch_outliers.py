"""The port's (k,z)-center with outliers against the JAX package, on the
CPU: ``kz_center`` on both executors, its host solve and its one read of
the coreset, ``covering_radius_excluding`` and ``brute_force_opt_z``.

The same numpy inputs go through ``repro`` (``impl="ref"``) and
``repro_torch`` (``device="cpu"``, its plain versions). On exact-arithmetic
inputs and integer weights everything is bitwise; on float inputs the
centers are bitwise too (GON picks rows and the host solve runs in float64
on the same coreset) and ``radius2`` holds to rtol 1e-6
(tests/test_torch_mrg.py). The approximation bound is
tests/test_outliers.py's: at most 13 times the brute-force optimum.
"""
import doctest

import numpy as np
import pytest
import torch

from repro.core import brute_force_opt_z as jbrute_force_opt_z
from repro.core import covering_radius_excluding as jcovering_radius_excluding
from repro.core import kz_center as jkz_center
from repro.core.executor import HostStreamExecutor as JHostStreamExecutor
from repro.core.executor import SimExecutor as JSimExecutor
from repro.data import source as jsource
from repro_torch import interop
from repro_torch.core import (HostStreamExecutor, Objective, SimExecutor,
                              brute_force_opt_z, covering_radius2,
                              covering_radius_excluding, kz_center, mrg)
from repro_torch.data.source import HostSource, WeightedSource

R2_RTOL = 1e-6                       # tests/test_torch_mrg.py (radius2)


def _clustered_with_outliers(n=500, d=3, k=4, z=3, spread=100.0, seed=0,
                             exact=False):
    """k tight planted clusters + z far-flung outliers (as
    tests/test_outliers.py makes them)."""
    rng = np.random.default_rng(seed)
    cents = rng.normal(size=(k, d)).astype(np.float32) * 10.0
    x = (cents[rng.integers(0, k, size=n)]
         + rng.normal(size=(n, d)).astype(np.float32) * 0.5)
    x[:z] = rng.normal(size=(z, d)).astype(np.float32) * 0.1 + spread
    x = x.astype(np.float32)
    return np.round(x) if exact else x


def _executors(kind, rows):
    if kind == "sim":
        return SimExecutor(5, device="cpu"), JSimExecutor(5)
    return (HostStreamExecutor(block_rows=rows, device="cpu"),
            JHostStreamExecutor(block_rows=rows))


def _inputs(kind, x, w):
    if kind == "sim":
        return x, x
    if w is None:
        return HostSource(x), jsource.HostSource(x)
    return (WeightedSource(HostSource(x), w),
            jsource.WeightedSource(jsource.HostSource(x), w))


@pytest.mark.parametrize("kind,rows,weighted,exact", [
    ("sim", None, False, False), ("sim", None, False, True),
    ("host", 100, False, False), ("host", 128, False, True),
    ("host", 100, True, True), ("host", 128, True, False)])
def test_kz_center_matches_jax(kind, rows, weighted, exact):
    x = _clustered_with_outliers(seed=1, exact=exact)
    w = (np.random.default_rng(2).integers(0, 4, x.shape[0]).astype(np.float32)
         if weighted else None)
    ex, jex = _executors(kind, rows)
    src, jsrc = _inputs(kind, x, w)
    reads = kz_center.host_reads
    got = kz_center(src, 4, 3, executor=ex, impl="ref")
    assert kz_center.host_reads == reads + 1      # the coreset, once
    want = jkz_center(jsrc, 4, 3, executor=jex, impl="ref")
    np.testing.assert_array_equal(got.centers.numpy(), np.asarray(want.centers))
    assert (got.coreset_size, got.rounds) == (want.coreset_size, want.rounds)
    if exact:
        assert got.radius2.item() == float(want.radius2)
    else:
        np.testing.assert_allclose(got.radius2.item(), float(want.radius2),
                                   rtol=R2_RTOL)
    # the planted outliers are excluded: the radius is far below theirs
    assert got.radius2.item() ** 0.5 < 30.0


def test_kz_center_weighted_combine_level_matches_jax():
    """A round-1 union above solve_capacity takes a weighted Lemma-3 level
    (combine_weighted without the final GON) before the host solve."""
    x = _clustered_with_outliers(n=600, seed=3)
    ex, jex = _executors("sim", None)
    got = kz_center(x, 3, 2, executor=ex, t=8, solve_capacity=16, impl="ref")
    want = jkz_center(x, 3, 2, executor=jex, t=8, solve_capacity=16,
                      impl="ref")
    assert got.rounds == want.rounds >= 3
    assert got.coreset_size == want.coreset_size
    np.testing.assert_array_equal(got.centers.numpy(), np.asarray(want.centers))
    np.testing.assert_allclose(got.radius2.item(), float(want.radius2),
                               rtol=R2_RTOL)


def test_kz_center_within_bound_of_brute_force():
    """tests/test_outliers.py's small-n oracle: at most 13 x the (k,z)
    optimum on both executors, and the outliers excluded."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(14, 2)).astype(np.float32)
    x[:2] += 50.0                       # 2 extreme outliers
    k, z = 2, 2
    opt = brute_force_opt_z(x, k, z)
    assert opt == jbrute_force_opt_z(x, k, z) > 0.0
    for ex, src in ((SimExecutor(3, device="cpu"), x),
                    (HostStreamExecutor(block_rows=5, device="cpu"),
                     HostSource(x))):
        r = kz_center(src, k, z, executor=ex, impl="ref").radius2.item() ** 0.5
        assert r / opt <= 13.0 + 1e-5, (r, opt)
        assert r < 25.0


def test_kz_center_z0_and_an_outlier_scored_mrg():
    x = _clustered_with_outliers(n=300, z=0, seed=4)
    res = kz_center(x, 5, 0, m=4, impl="ref", device="cpu")
    assert res.radius2.item() == covering_radius2(x, res.centers,
                                                  device="cpu").item()
    # an outliers objective on mrg scores radius2 with the top-(z+1) fold
    plain = mrg(x, 5, m=4, device="cpu")
    scored = mrg(x, 5, m=4, device="cpu", objective=Objective(outliers=3))
    assert torch.equal(plain.centers, scored.centers)
    assert scored.radius2.item() <= plain.radius2.item()


@pytest.mark.parametrize("z,weighted,rows", [(0, False, 64), (5, False, 100),
                                              (5, True, 100), (40, True, 64)])
def test_covering_radius_excluding_matches_jax(z, weighted, rows):
    rng = np.random.default_rng(z)
    x = _clustered_with_outliers(n=300, z=5, seed=5)
    c = x[rng.choice(300, 6, replace=False)]
    w = rng.integers(0, 3, 300).astype(np.float32)
    src = WeightedSource(HostSource(x), w) if weighted else HostSource(x)
    jsrc = (jsource.WeightedSource(jsource.HostSource(x), w) if weighted
            else jsource.HostSource(x))
    got = covering_radius_excluding(src, torch.from_numpy(c), z,
                                    block_rows=rows, device="cpu")
    want = jcovering_radius_excluding(jsrc, c, z, impl="ref", block_rows=rows)
    assert got.item() == float(want)


def test_kz_center_validates_arguments():
    x = np.zeros((32, 2), np.float32)
    for args, kw in (((0, 1), {}), ((2, -1), {}), ((4, 1), {"t": 2})):
        with pytest.raises(ValueError):
            kz_center(x, *args, device="cpu", **kw)
    # chunk is ported: the row-chunked passes give the same result
    assert torch.equal(kz_center(x, 2, 1, chunk=8, device="cpu").centers,
                       kz_center(x, 2, 1, device="cpu").centers)
    with pytest.raises(ValueError, match="positive-weight"):
        kz_center(WeightedSource(HostSource(x), np.zeros(32, np.float32)),
                  2, 1, device="cpu")


def test_results_to_numpy():
    x = _clustered_with_outliers(n=200, seed=6)
    res = interop.result_to_numpy(kz_center(x, 3, 2, m=4, device="cpu"))
    assert res["centers"].shape == (3, 3) and isinstance(res["coreset_size"], int)
    w = np.ones(200, np.float32)
    m = interop.result_to_numpy(mrg(WeightedSource(HostSource(x), w), 3,
                                    executor=HostStreamExecutor(
                                        block_rows=64, device="cpu"),
                                    objective=Objective(weighted=True)))
    assert m["weights"].dtype == np.float32 and m["weights"].sum() == 200


@pytest.mark.parametrize("modname", ["repro_torch.core.outliers",
                                     "repro_torch.data.source"])
def test_doctests(modname):
    mod = __import__(modname, fromlist=["_"])
    result = doctest.testmod(mod, verbose=False)
    assert result.attempted > 0 and result.failed == 0
