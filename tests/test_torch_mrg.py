"""The port's GON and MRG against the JAX package, on the CPU.

The same numpy inputs go through ``repro`` (``impl="ref"``) and
``repro_torch`` (``device="cpu"``, its plain versions). The GON loop and
the blocking are exact, so the port must pick the same centers in the same
order and run the same rounds; ``radius2`` is bitwise on exact-arithmetic
inputs and within rtol 1e-6 on float ones.
"""
import doctest
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gonzalez as jgonzalez
from repro.core import mrg as jmrg
from repro.core.executor import SimExecutor as JSimExecutor
from repro.core.executor import gon_block_fn as jgon_block_fn
from repro.data.source import ArraySource
from repro_torch import interop
from repro_torch.core import (SimExecutor, assignment, brute_force_opt,
                              covering_radius2, gonzalez, mrg, mrg_sim,
                              plan_rounds)
from repro_torch.core.executor import gon_block_fn
from repro_torch.data import pointsets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data(gen, n, seed=1, exact=False):
    x = pointsets.GENERATORS[gen](n, seed=seed)
    return np.floor(x) if exact else x


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("gen,exact", [("gau", False), ("pokerlike", True)])
def test_gonzalez_matches_jax(gen, exact, masked):
    x = _data(gen, 700, seed=2)
    mask = (np.random.default_rng(0).random(700) < 0.6) if masked else None
    want = jgonzalez(jnp.asarray(x), 12, impl="ref",
                     mask=None if mask is None else jnp.asarray(mask))
    got = interop.result_to_numpy(gonzalez(x, 12, mask=mask, device="cpu"))
    np.testing.assert_array_equal(got["indices"], np.asarray(want.indices))
    np.testing.assert_array_equal(got["centers"], np.asarray(want.centers))
    if exact:
        assert got["radius2"] == np.asarray(want.radius2)
        np.testing.assert_array_equal(got["min_d2"], np.asarray(want.min_d2))
    else:
        # jitted, XLA contracts the reference's direct form (x-c)^2 + (x-c)^2
        # into an FMA; its eager oracle and the port round each step, so
        # float distances may sit an ulp apart (ROADMAP, faults found)
        np.testing.assert_allclose(got["radius2"], np.asarray(want.radius2),
                                   rtol=1e-6)
        np.testing.assert_allclose(got["min_d2"], np.asarray(want.min_d2),
                                   rtol=1e-5)
    assert got["indices"].dtype == np.int32


@pytest.mark.parametrize("gen,n,m,k,exact", [
    ("unif", 3000, 8, 8, False),
    ("gau", 4000, 50, 25, False),
    ("unb", 5000, 50, 8, False),
    ("pokerlike", 2500, 8, 25, True),
    ("unif", 2999, 50, 25, True),        # n not divisible by m
])
def test_mrg_matches_jax(gen, n, m, k, exact):
    x = _data(gen, n, exact=exact)
    want = jmrg(x, k, m=m, impl="ref")
    got = mrg(x, k, m=m, device="cpu")
    assert got.rounds == want.rounds
    np.testing.assert_array_equal(got.centers.numpy(), np.asarray(want.centers))
    if exact:
        assert got.radius2.numpy() == np.asarray(want.radius2)
    else:
        np.testing.assert_allclose(float(got.radius2), float(want.radius2),
                                   rtol=1e-6)


def test_multiround_matches_jax():
    x = _data("unif", 600, seed=6)
    # k*m = 80 > capacity 30 forces extra rounds
    want = jmrg(x, 8, m=10, capacity=30, impl="ref")
    got = mrg_sim(x, 8, m=10, capacity=30, device="cpu")
    assert got.rounds > 2 and got.rounds == want.rounds
    np.testing.assert_array_equal(got.centers.numpy(), np.asarray(want.centers))
    np.testing.assert_allclose(float(got.radius2), float(want.radius2),
                               rtol=1e-6)
    assert plan_rounds(600, 10, 8, 30) >= 3


def test_four_approx_vs_bruteforce():
    for seed in range(3):
        pts = np.random.default_rng(seed + 10).normal(size=(16, 2)).astype(
            np.float32)
        opt = brute_force_opt(pts, 3)
        r = mrg(pts, 3, m=4, capacity=100, device="cpu")
        assert float(r.radius2) ** 0.5 <= 4.0 * opt + 1e-5
        r2 = covering_radius2(pts, r.centers, device="cpu")
        assert r2.numpy() == r.radius2.numpy()
        idx = assignment(pts, r.centers, device="cpu")
        d2 = ((pts - r.centers.numpy()[idx.numpy()]) ** 2).sum(1)
        np.testing.assert_allclose(d2.max(), r2.numpy(), rtol=1e-5)


def test_jax_round1_union_through_interop_into_combine():
    # n = 97 on 50 machines: per = 2, the last block holds no valid row and
    # still emits k zero rows marked invalid
    x = _data("pokerlike", 97, seed=3)
    k = 4
    jex = JSimExecutor(m=50)
    centers, valid = jex.run_blocks(jgon_block_fn(k, "ref"), ArraySource(x))
    assert not bool(np.asarray(valid).all())
    want, want_extra = jex.combine(centers, valid, k, 12, impl="ref")
    st = interop.state_from_jax({"centers": np.asarray(centers),
                                 "valid": np.asarray(valid)}, "cpu")
    ex = SimExecutor(m=50, device="cpu")
    got, extra = ex.combine(st["centers"], st["valid"], k, 12, impl="ref")
    assert extra == want_extra and extra >= 1
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the port's own round 1 gives the same union and validity
    pc, pv = ex.run_blocks(gon_block_fn(k, "ref"), x)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(centers))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(valid))


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _data("unif", 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        mrg(x, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        gonzalez(x, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        SimExecutor(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        covering_radius2(x, x[:2])
    # chunk is ported: the row-chunked passes pick the same centers
    chunked, whole = mrg(x, 4, device="cpu", chunk=16), mrg(x, 4, device="cpu")
    assert torch.equal(chunked.centers, whole.centers)
    assert torch.equal(chunked.radius2, whole.radius2)
    with pytest.raises(NotImplementedError):
        mrg(x, 4, device="cpu", objective=object())


@pytest.mark.parametrize("modname", ["repro_torch.core.gonzalez",
                                     "repro_torch.core.mrg",
                                     "repro_torch.core.coreset",
                                     "repro_torch.data.source"])
def test_port_doctests(modname):
    mod = __import__(modname, fromlist=["_"])
    result = doctest.testmod(mod, verbose=False)
    assert result.attempted > 0 and result.failed == 0


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels, "
            "repro_torch.data, repro_torch.interop, repro_torch.data.source, "
            "repro_torch.kernels.fused_stream, repro_torch.core.coreset, "
            "repro_torch.models, repro_torch.models.layers, "
            "repro_torch.models.lm, repro_torch.models.api, "
            "repro_torch.models.encdec, "
            "repro_torch.configs, repro_torch.data.pipeline, "
            "repro_torch.serve, repro_torch.serve.engine, "
            "repro_torch.serve.sampler; "
            "from repro_torch.configs import ARCH_IDS, get_config; "
            "[get_config(a) for a in ARCH_IDS]; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'repro' not in sys.modules, 'repro imported'")
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
