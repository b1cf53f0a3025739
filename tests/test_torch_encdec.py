"""The port's encoder-decoder family (whisper) and its layers against the
JAX package, on the CPU.

The JAX package's weights (``init_params(PRNGKey(0), cfg)`` of the smoke
config) are carried into the port by ``interop.params_from_jax``, and the
same numpy frames and tokens (``model_batch``) go through both.
Tolerances: f32 within rtol 1e-5, atol 1e-5 (measured ~6e-7 on logits);
sinusoidal tables within atol 1e-5 at positions below 64, and beyond
within three f32 spacings of the largest angle (the divisor's rounding and
the quotient's: 3.7e-4 at 1,500; measured 2.4e-4); bf16 within atol 0.05
on logits; the carry bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro_torch import configs, models
from repro_torch.data import model_batch
from repro_torch.interop import params_from_jax
from repro_torch.models import encdec, layers
from repro_torch.serve import Engine

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ATOL = 0.05
ARCH = "whisper_large_v3"


def _carry(**replace):
    jcfg = jconfigs.get_config(ARCH, smoke=True).replace(**replace)
    cfg = configs.get_config(ARCH, smoke=True).replace(**replace)
    jp = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


@pytest.fixture(scope="module")
def carried():
    return _carry()


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_forward_prefill_decode_match_jax(carried):
    """forward (logits and hidden states), the encoder alone, a 12-token
    prompt prefilled (self and cross caches) and 3 decode steps."""
    jcfg, jp, cfg, model = carried
    batch = model_batch(cfg, 2, 19, seed=1)
    for hidden in (False, True):
        want, waux = jmodels.forward(jp, _jax(batch), jcfg, return_hidden=hidden)
        got, aux = models.forward(model, batch, cfg, return_hidden=hidden)
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    assert aux == waux == {}
    np.testing.assert_allclose(
        encdec.encode(model, batch["frames"], cfg).numpy(),
        np.asarray(jencdec.encode(jp, jnp.asarray(batch["frames"]), jcfg)),
        **F32_TOL)
    pre = dict(batch, tokens=batch["tokens"][:, :12])
    wl, wc = jmodels.prefill(jp, _jax(pre), jcfg, 24)
    gl, gc = models.prefill(model, pre, cfg, 24)
    np.testing.assert_allclose(_np(gl), _np(wl), **F32_TOL)
    assert sorted(gc) == sorted(wc) == ["k", "pos", "v", "xk", "xv"]
    for name in gc:
        np.testing.assert_allclose(_np(gc[name]), _np(wc[name]), **F32_TOL)
    for s in range(12, 15):
        tok = batch["tokens"][:, s:s + 1]
        wl, wc = jmodels.decode_step(jp, wc, jnp.asarray(tok), jcfg)
        gl, gc = models.decode_step(model, gc, tok, cfg)
        np.testing.assert_allclose(_np(gl), _np(wl), **F32_TOL)
    for name in gc:
        np.testing.assert_allclose(_np(gc[name]), _np(wc[name]), **F32_TOL)


def test_prefill_then_decode_equals_forward(carried):
    """The port's own consistency: prompt prefilled, then decoded token by
    token, gives forward's logits at the same positions."""
    _, _, cfg, model = carried
    batch = model_batch(cfg, 2, 16, seed=2)
    full, _ = models.forward(model, batch, cfg)
    last, cache = models.prefill(model, dict(batch, tokens=batch["tokens"][:, :10]),
                                 cfg, 16)
    torch.testing.assert_close(last[:, 0], full[:, 9], **F32_TOL)
    for s in range(10, 16):
        step, cache = models.decode_step(model, cache,
                                         batch["tokens"][:, s:s + 1], cfg)
        torch.testing.assert_close(step[:, 0], full[:, s], **F32_TOL)


def test_bf16_matches_jax():
    jcfg, jp, cfg, model = _carry(param_dtype="bfloat16", compute_dtype="bfloat16")
    batch = model_batch(cfg, 2, 12, seed=4)
    want, _ = jmodels.forward(jp, _jax(batch), jcfg)
    got, _ = models.forward(model, batch, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=BF16_ATOL)
    wl, wc = jmodels.prefill(jp, _jax(batch), jcfg, 16)
    gl, gc = models.prefill(model, batch, cfg, 16)
    assert gc["xk"].dtype == torch.bfloat16
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=0, atol=BF16_ATOL)
    tok = batch["tokens"][:, :1]
    wl, _ = jmodels.decode_step(jp, wc, jnp.asarray(tok), jcfg)
    gl, _ = models.decode_step(model, gc, tok, cfg)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=0, atol=BF16_ATOL)


def test_params_from_jax_exact():
    """enc_layers and dec_layers unstacked, enc_norm/dec_norm carried, the
    cross-attention without biases; bf16 bit for bit."""
    jcfg = jconfigs.get_config(ARCH, smoke=True).replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg = configs.get_config(ARCH, smoke=True).replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    jp = jax.tree.map(np.asarray, jmodels.init_params(jax.random.PRNGKey(2), jcfg))
    model = params_from_jax(jp, cfg, "cpu")
    sd = model.state_dict()
    assert isinstance(model, models.EncDec)
    assert "dec_layers.1.xattn.wq" in sd and "dec_layers.1.xattn.bq" not in sd
    assert "dec_layers.1.attn.bq" in sd
    for group in ("enc_layers", "dec_layers"):
        for i in range(2):
            np.testing.assert_array_equal(
                sd[f"{group}.{i}.attn.wq"].view(torch.int16).numpy(),
                jp[group]["attn"]["wq"][i].view(np.int16))
            np.testing.assert_array_equal(sd[f"{group}.{i}.ln1.bias"].numpy(),
                                          jp[group]["ln1"]["bias"][i])
    np.testing.assert_array_equal(sd["enc_norm.scale"].numpy(), jp["enc_norm"]["scale"])
    np.testing.assert_array_equal(sd["embed"].view(torch.int16).numpy(),
                                  jp["embed"].view(np.int16))
    bad = jax.tree.map(lambda a: a, jp)
    bad["dec_layers"]["xattn"]["bq"] = np.zeros((2, 64), np.float32)
    with pytest.raises(KeyError, match="xattn.bq"):
        params_from_jax(bad, cfg, "cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_sinusoidal_matches_jax():
    for S, d in ((16, 64), (1500, 1280)):
        want = np.asarray(jlayers.sinusoidal_embed(S, d))
        got = layers.sinusoidal_embed(S, d, "cpu")
        assert tuple(got.shape) == (S, d) and got.dtype == torch.float32
        np.testing.assert_allclose(got[:64].numpy(), want[:64], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=3 * np.spacing(np.float32(S)))
    pos = np.array([[0, 3, 17], [400, 1499, 7]], np.int32)
    np.testing.assert_allclose(
        layers.sinusoidal_at(torch.from_numpy(pos), 64).numpy(),
        np.asarray(jlayers.sinusoidal_at(jnp.asarray(pos), 64)), rtol=0,
        atol=3 * np.spacing(np.float32(1499)))


def test_cross_attention_and_bidir_match_jax(carried):
    """encode_kv and cross_attention_block of layer 1 (every frame
    visible, no biases); a bidirectional attend in chunks of 4 over 13
    keys, its padded query rows included."""
    jcfg, jp, cfg, model = carried
    rng = np.random.default_rng(3)
    enc = rng.normal(size=(2, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    jx = jax.tree.map(lambda a: a[1], jp["dec_layers"]["xattn"])
    wkv = jlayers.encode_kv(jx, jnp.asarray(enc), jcfg)
    gkv = layers.encode_kv(model.dec_layers[1].xattn, torch.from_numpy(enc), cfg)
    for g, w in zip(gkv, wkv):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)
    want = jlayers.cross_attention_block(jx, jnp.asarray(x), wkv, jcfg)
    got = layers.cross_attention_block(model.dec_layers[1].xattn,
                                       torch.from_numpy(x), gkv, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    q = rng.normal(size=(2, 10, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 13, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 13, 2, 16)).astype(np.float32)
    q_pos = np.zeros((2, 10), np.int32)
    want = jlayers.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcfg,
                          q_pos=jnp.asarray(q_pos), bidir=True, chunk=4)
    got = layers.attend(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), cfg, q_pos=torch.from_numpy(q_pos),
                        bidir=True, chunk=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_api_and_engine_surface(carried):
    """init_params, init_cache through the api; the Engine refuses encdec
    (its prefill passes no frames, as the reference's cannot either)."""
    _, _, cfg, model = carried
    fresh = models.init_params(cfg, seed=1, device="cpu")
    assert isinstance(fresh, models.EncDec)
    assert sorted(fresh.state_dict()) == sorted(model.state_dict())
    cache = models.init_cache(cfg, 3, 20, device="cpu")
    assert tuple(cache["k"].shape) == (cfg.num_layers, 3, 20, cfg.num_kv_heads,
                                       cfg.resolved_head_dim)
    assert tuple(cache["xk"].shape) == (cfg.num_layers, 3, cfg.enc_seq,
                                        cfg.num_kv_heads, cfg.resolved_head_dim)
    assert models.head_weights(model, cfg).shape == (cfg.d_model, cfg.vocab_size)
    with pytest.raises(ValueError, match="encdec"):
        Engine(model, cfg, slots=2, s_max=16)
