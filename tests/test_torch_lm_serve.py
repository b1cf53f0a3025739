"""The port's LM sampler and continuous-batching ``Engine`` against the JAX
package's, on the CPU.

  * ``sample``: jax's uniform bits and uniforms bitwise (threefry-2x32,
    partitionable) over several keys and shapes; greedy, the top-k and
    top-p masks, and stochastic draws token for token over several keys.
    The Gumbel noise's logs are each library's own and may differ in the
    last place (within 1e-6 here), so the tokens are compared where the
    logits are not tied that closely (random normal logits).
  * ``Engine``: the JAX engine's weights carried across, 5 mixed greedy
    and stochastic requests through 2 slots, retiring on ``max_new``, on
    ``eos_id`` and on a full cache: every request's tokens equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import sample as jsample
from repro.serve import sampler as jsampler
from repro_torch import configs
from repro_torch.interop import params_from_jax
from repro_torch.kernels.engine import split_key
from repro_torch.serve import Engine, Request, sample
from repro_torch.serve import sampler

KEYS = [0, 1, 7, 12345]
DRAWS = [dict(temperature=0.7, top_k=40), dict(temperature=0.9, top_p=0.9),
         dict(temperature=1.0), dict(temperature=0.7, top_k=40, top_p=0.8)]


def _key(seed):
    return np.asarray(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("shape", [(1, 512), (3, 1000)])
def test_uniform_bits_bitwise(shape):
    tiny = np.finfo(np.float32).tiny
    for seed in KEYS:
        key = jax.random.PRNGKey(seed)
        bits = sampler.random_bits(_key(seed), shape, "cpu").numpy()
        np.testing.assert_array_equal(
            bits, np.asarray(jax.random.bits(key, shape)).astype(np.int64))
        for lo in (0.0, tiny):
            want = np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=1.0))
            got = sampler.uniform(_key(seed), shape, "cpu", minval=lo).numpy()
            np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(
            sampler.gumbel(_key(seed), shape, "cpu").numpy(),
            np.asarray(jax.random.gumbel(key, shape)), rtol=1e-6, atol=1e-6)
    # the split the engine makes between draws
    for seed in KEYS:
        np.testing.assert_array_equal(
            split_key(_key(seed), 2), np.asarray(jax.random.split(
                jax.random.PRNGKey(seed))))


def test_greedy_and_masks_match_jax():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(4, 512)) * 3).astype(np.float32)
    logits[1, 7] = logits[1, 9] = logits[1].max() + 1.0   # a tie: first index
    t = torch.from_numpy(logits)
    np.testing.assert_array_equal(sample(t, 0).numpy(),
                                  np.asarray(jsample(jnp.asarray(logits), 0)))
    assert int(sample(t, 0)[1]) == 7
    for k in (1, 40, 512):
        np.testing.assert_array_equal(
            sampler._apply_top_k(t, k).numpy(),
            np.asarray(jsampler._apply_top_k(jnp.asarray(logits), k)))
    for p in (0.1, 0.5, 0.9):
        np.testing.assert_array_equal(
            sampler._apply_top_p(t, p).numpy(),
            np.asarray(jsampler._apply_top_p(jnp.asarray(logits), p)))


@pytest.mark.parametrize("kw", DRAWS, ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_stochastic_draws_match_jax(kw):
    logits = (np.random.default_rng(1).normal(size=(4, 512)) * 3).astype(np.float32)
    for seed in range(6):
        want = np.asarray(jsample(jnp.asarray(logits), jax.random.PRNGKey(seed), **kw))
        got = sample(torch.from_numpy(logits), _key(seed), **kw)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

SPECS = [  # (prompt length, temperature, top_k, top_p, max_new)
    (5, 0.0, 0, 1.0, 6),       # retires on max_new
    (12, 0.7, 40, 1.0, 8),     # stochastic, top-k
    (3, 0.0, 0, 1.0, 30),      # bucket 8: the cache (s_max 32) fills first
    (9, 0.9, 0, 0.9, 10),      # stochastic, top-p; bucket 16
    (7, 0.0, 0, 1.0, 20),      # retires on eos_id
]
S_MAX = 32


def _requests(cls, eos):
    rng = np.random.default_rng(3)
    return [cls(uid=i, tokens=rng.integers(0, 512, n).astype(np.int32),
                temperature=t, top_k=k, top_p=p, max_new=m,
                eos_id=eos if i == 4 else -1)
            for i, (n, t, k, p, m) in enumerate(SPECS)]


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return {r.uid: r.out for r in eng.run()}


@pytest.fixture(scope="module")
def engines():
    cfg = configs.get_config("qwen2_0_5b", smoke=True)
    jcfg = jconfigs.get_config("qwen2_0_5b", smoke=True)
    jp = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


def test_engine_matches_jax_engine(engines):
    jcfg, jp, cfg, model = engines
    # eos: request 4's fourth token of a run without one
    eos = _serve(Engine(model, cfg, slots=2, s_max=S_MAX),
                 _requests(Request, -1))[4][3]
    eng = Engine(model, cfg, slots=2, s_max=S_MAX)
    got = _serve(eng, _requests(Request, eos))
    want = _serve(JEngine(jp, jcfg, slots=2, s_max=S_MAX), _requests(JRequest, eos))
    assert got == want
    assert [len(got[i]) for i in (0, 1, 3)] == [6, 8, 10]        # max_new
    assert got[4][-1] == eos and len(got[4]) == got[4].index(eos) + 1 < 20
    assert len(got[2]) == S_MAX - 1 - 8 + 1 < 30                  # full cache
    assert all(0 <= t < cfg.vocab_size for out in got.values() for t in out)


def test_engine_reads_and_repeat(engines):
    """Reads: exactly one a step plus one an admission; a second engine
    from the same seed gives the same tokens."""
    _, _, cfg, model = engines
    runs = []
    for _ in range(2):
        eng = Engine(model, cfg, slots=2, s_max=S_MAX)
        for r in _requests(Request, -1):
            eng.submit(r)
        steps = 0
        while eng.pending or eng.alive.any():
            eng.step()
            steps += 1
        assert eng.reads == steps + len(SPECS)
        assert not eng.alive.any() and len(eng.done) == len(SPECS)
        runs.append({r.uid: r.out for r in eng.done})
        np.testing.assert_array_equal(eng.cache["pos"].numpy(), eng.pos)
    assert runs[0] == runs[1]
