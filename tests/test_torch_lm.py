"""The port's dense LM against the JAX package, on the CPU (and every
family's parameter count: ``test_init_matches_param_counts``).

The JAX package's weights (``init_params(PRNGKey(0), cfg)`` of a smoke
config) are carried into the port by ``interop.params_from_jax``, and the
same numpy tokens go through both. Tolerances, in order:
  * f32: logits, hidden states and caches within rtol 1e-5, atol 1e-5 (the
    two packages' products sum in other orders; measured ~1e-6 on logits
    of scale ~1.5);
  * RoPE alone: cos/sin within atol 1e-4, rotated values 2e-4 (at
    position 600 an angle carries 600 times its frequency's rounding);
  * bf16: within atol 0.05 on logits (one rounding of bf16 is 2^-8
    relative; the two round different intermediates);
  * exact: token batches, cache positions, parameter counts and the carry
    itself, bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.core import embed_batches as jembed_batches
from repro.core import select_coreset as jselect_coreset
from repro.data import pipeline as jpipeline
from repro.models import layers as jlayers
from repro_torch import configs, models
from repro_torch.core import embed_batches, select_coreset
from repro_torch.data import host_slice, model_batch, token_batch
from repro_torch.interop import params_from_jax
from repro_torch.models import layers, lm

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ATOL = 0.05
DENSE = ["qwen2_0_5b", "olmo_1b", "minicpm_2b", "granite_3_2b"]


def _carry(arch, **replace):
    """(JAX cfg, JAX params, the port's cfg, the port's model on the CPU)."""
    jcfg = jconfigs.get_config(arch, smoke=True).replace(**replace)
    cfg = configs.get_config(arch, smoke=True).replace(**replace)
    jp = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


@pytest.fixture(scope="module", params=DENSE)
def carried(request):
    return _carry(request.param)


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


def test_forward_prefill_decode_match_jax(carried):
    jcfg, jp, cfg, model = carried
    toks = token_batch(cfg.vocab_size, 2, 19, seed=1)["tokens"]
    for hidden in (False, True):
        want, _ = jmodels.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                  return_hidden=hidden)
        got, aux = models.forward(model, {"tokens": toks}, cfg,
                                  return_hidden=hidden)
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    assert got.dtype == torch.float32 and aux == {"moe_aux": 0.0}
    wl, wc = jmodels.prefill(jp, {"tokens": jnp.asarray(toks[:, :12])}, jcfg, 24)
    gl, gc = models.prefill(model, {"tokens": toks[:, :12]}, cfg, 24)
    np.testing.assert_allclose(_np(gl), _np(wl), **F32_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(gc[name]), _np(wc[name]), **F32_TOL)
    np.testing.assert_array_equal(gc["pos"].numpy(), np.asarray(wc["pos"]))
    for s in range(12, 15):
        wl, wc = jmodels.decode_step(jp, wc, jnp.asarray(toks[:, s:s + 1]), jcfg)
        gl, gc = models.decode_step(model, gc, toks[:, s:s + 1], cfg)
        np.testing.assert_allclose(_np(gl), _np(wl), **F32_TOL)
    np.testing.assert_array_equal(gc["pos"].numpy(), np.asarray(wc["pos"]))
    np.testing.assert_allclose(_np(gc["k"]), _np(wc["k"]), **F32_TOL)


def test_prefill_then_decode_equals_forward():
    """The port's own consistency (tests/test_models.py's check): a prompt
    prefilled, then decoded token by token, gives forward's logits at the
    same positions."""
    cfg = configs.get_config("granite_3_2b", smoke=True)
    model = lm.init_params(cfg, seed=3, device="cpu")
    toks = token_batch(cfg.vocab_size, 2, 16, seed=2)["tokens"]
    full, _ = models.forward(model, {"tokens": toks}, cfg)
    last, cache = models.prefill(model, {"tokens": toks[:, :10]}, cfg, 16)
    torch.testing.assert_close(last[:, 0], full[:, 9], **F32_TOL)
    for s in range(10, 16):
        step, cache = models.decode_step(model, cache, toks[:, s:s + 1], cfg)
        torch.testing.assert_close(step[:, 0], full[:, s], **F32_TOL)


def test_bf16_matches_jax():
    jcfg, jp, cfg, model = _carry("qwen2_0_5b", param_dtype="bfloat16",
                                  compute_dtype="bfloat16")
    assert model.layers[0].attn.wq.dtype == torch.bfloat16
    toks = token_batch(cfg.vocab_size, 2, 12, seed=4)["tokens"]
    want, _ = jmodels.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got, _ = models.forward(model, {"tokens": toks}, cfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=BF16_ATOL)
    wl, wc = jmodels.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, 16)
    gl, gc = models.prefill(model, {"tokens": toks}, cfg, 16)
    assert gc["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=0, atol=BF16_ATOL)
    wl, _ = jmodels.decode_step(jp, wc, jnp.asarray(toks[:, :1]), jcfg)
    gl, _ = models.decode_step(model, gc, toks[:, :1], cfg)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=0, atol=BF16_ATOL)


# ---------------------------------------------------------------------------
# layers, module by module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "layernorm_np"])
def test_norms_match_jax(norm):
    cfg = configs.get_config("qwen2_0_5b", smoke=True).replace(norm=norm)
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, 7, cfg.d_model)) * 3 + 1).astype(np.float32)
    jp = jlayers.init_norm(None, cfg)
    module = layers.init_norm(cfg, device="cpu")
    if norm != "layernorm_np":       # non-trivial parameters, carried across
        jp = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
              for k, v in jp.items()}
        for k, v in jp.items():
            getattr(module, k).copy_(torch.from_numpy(np.array(v)))
    else:
        assert list(module.parameters()) == []
    want = jlayers.apply_norm(jp, jnp.asarray(x), cfg)
    got = layers.apply_norm(module, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_rope_matches_jax():
    pos = np.array([[0, 1, 5, 600], [3, 2, 1, 0]], np.int32)
    x = np.random.default_rng(6).normal(size=(2, 4, 3, 16)).astype(np.float32)
    jc, js = jlayers.rope_cos_sin(jnp.asarray(pos), 16, 1e6)
    tc, ts = layers.rope_cos_sin(torch.from_numpy(pos), 16, 1e6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        layers._rope_freqs_host(16, 1e6), np.asarray(jlayers._rope_freqs(16, 1e6)),
        rtol=1e-6)
    want = jlayers.apply_rope(jnp.asarray(x), jc, js)
    got = layers.apply_rope(torch.from_numpy(x), tc, ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-4)


@pytest.mark.parametrize("G", [1, 2])
def test_attend_chunked_matches_jax(G):
    """Ten queries in chunks of 4 (the last padded, its pad rows at
    position 0) over 13 keys, causal from an offset, against the JAX
    attend with the same chunk; and the unchunked port's result."""
    cfg = configs.get_config("qwen2_0_5b", smoke=True)
    rng = np.random.default_rng(7)
    B, Sq, Sk, KV, hd = 2, 10, 13, 2, 16
    q = rng.normal(size=(B, Sq, KV * G, hd)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KV, hd)).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(3, 3 + Sq, dtype=np.int32), (B, Sq)).copy()
    want = jlayers.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cfg,
                          q_pos=jnp.asarray(q_pos), chunk=4)
    t = [torch.from_numpy(a) for a in (q, k, v, q_pos)]
    got = layers.attend(*t[:3], cfg, q_pos=t[3], chunk=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    whole = layers.attend(*t[:3], cfg, q_pos=t[3])
    torch.testing.assert_close(got, whole, **F32_TOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_jax(act):
    cfg = configs.get_config("qwen2_0_5b", smoke=True).replace(act=act)
    jp = jlayers.init_mlp(jax.random.PRNGKey(1), cfg)
    if act == "gelu":   # non-zero biases, so that they are carried and added
        jp = dict(jp, b_up=jp["b_up"] + 0.1, b_down=jp["b_down"] - 0.2)
    module = layers.init_mlp(cfg, device="cpu")
    for k, v in jp.items():
        getattr(module, k).copy_(torch.from_numpy(np.array(v)))
    x = np.random.default_rng(8).normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    want = jlayers.apply_mlp(jp, jnp.asarray(x), cfg)
    got = layers.apply_mlp(module, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


# ---------------------------------------------------------------------------
# the carry, init, device, families, configs, pipeline
# ---------------------------------------------------------------------------

def test_params_from_jax_is_exact_and_rejects_other_dtypes():
    cfg = configs.get_config("qwen2_0_5b", smoke=True).replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    jp = jax.tree.map(np.asarray, jmodels.init_params(
        jax.random.PRNGKey(2), jconfigs.get_config("qwen2_0_5b", smoke=True)
        .replace(param_dtype="bfloat16", compute_dtype="bfloat16")))
    assert jp["embed"].dtype == ml_dtypes.bfloat16
    model = params_from_jax(jp, cfg, "cpu")
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["embed"].view(torch.int16).numpy(),
                                  jp["embed"].view(np.int16))
    np.testing.assert_array_equal(
        sd["layers.1.attn.wq"].view(torch.int16).numpy(),
        jp["layers"]["attn"]["wq"][1].view(np.int16))
    np.testing.assert_array_equal(sd["layers.1.attn.bk"].numpy(),
                                  jp["layers"]["attn"]["bk"][1])
    assert sd["layers.0.ln1.scale"].dtype == torch.float32
    bad = dict(jp, embed=jp["embed"].astype(np.float16))
    with pytest.raises(TypeError, match="embed"):
        params_from_jax(bad, cfg, "cpu")
    with pytest.raises(KeyError):
        params_from_jax({k: v for k, v in jp.items() if k != "final_norm"},
                        cfg, "cpu")


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_init_matches_param_counts(arch):
    cfg = configs.get_config(arch, smoke=True)
    model = models.init_params(cfg, seed=0, device="cpu")
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.param_counts()["total"] + models.extra_params(cfg)
    norms = sum(p.numel() for name, p in model.named_parameters()
                if "." in name and name.split(".")[-2].startswith(
                    ("ln", "final_norm", "enc_norm", "dec_norm")))
    n_norms = {"encdec": 2 * cfg.enc_layers + 3 * cfg.num_layers + 2,
               "ssm": cfg.num_layers + 1}.get(cfg.family, 2 * cfg.num_layers + 1)
    assert norms == (0 if cfg.norm == "layernorm_np" else
                     n_norms * cfg.d_model * (2 if cfg.norm == "layernorm" else 1))
    jp = jmodels.init_params(jax.random.PRNGKey(0), jconfigs.get_config(
        arch, smoke=True))
    assert sorted(model.state_dict()) == sorted(
        params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu").state_dict())
    first = model.dec_layers[0] if cfg.family == "encdec" else model.layers[0]
    w = first.ssm.w_in if cfg.family == "ssm" else first.attn.wq
    assert abs(float(w.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.1


def test_full_qwen2_count():
    cfg = configs.get_config("qwen2_0_5b")
    norms = (2 * cfg.num_layers + 1) * cfg.d_model
    assert (cfg.param_counts()["total"], norms) == (493_988_864, 43_904)


def test_init_params_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("qwen2_0_5b", "mamba2_370m", "whisper_large_v3"):
        cfg = configs.get_config(arch, smoke=True)
        with pytest.raises(RuntimeError, match="CUDA"):
            models.init_params(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            models.init_cache(cfg, 1, 8)


def test_configs_are_the_jax_packages():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert configs.live_cells() == jconfigs.live_cells()
    assert ({k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()})
    for arch in configs.ARCH_IDS:
        for smoke in (False, True):
            assert (dataclasses.asdict(configs.get_config(arch, smoke=smoke))
                    == dataclasses.asdict(jconfigs.get_config(arch, smoke=smoke)))
        assert configs.get_config(arch).param_counts() == \
            jconfigs.get_config(arch).param_counts()


def test_pipeline_bitwise():
    for seed, step in ((0, 0), (3, 7)):
        want = jpipeline.token_batch(512, 4, 33, seed=seed, step=step)
        got = token_batch(512, 4, 33, seed=seed, step=step)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(got[key], want[key])
            assert got[key].dtype == np.int32
    for arch in ("qwen2_0_5b", "qwen2_vl_2b", "whisper_large_v3"):
        want = jpipeline.model_batch(jconfigs.get_config(arch, smoke=True), 4, 8,
                                     seed=1, step=2)
        got = model_batch(configs.get_config(arch, smoke=True), 4, 8, seed=1,
                          step=2)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
        sliced = host_slice(got, 1, 2)
        for key in want:
            np.testing.assert_array_equal(sliced[key],
                                          jpipeline.host_slice(want, 1, 2)[key])


def test_embed_then_select_coreset_matches_jax():
    """The curation pair — mean-pooled hidden states of 64 sequences, then a
    k = 8 coreset of them — against the JAX pair with impl="ref"."""
    jcfg, jp, cfg, model = _carry("qwen2_0_5b")
    batches = [token_batch(cfg.vocab_size, 16, 12, seed=0, step=s)["tokens"]
               for s in range(4)]
    want = jembed_batches(
        lambda tb: jmodels.forward(jp, {"tokens": tb}, jcfg,
                                   return_hidden=True)[0],
        [jnp.asarray(b) for b in batches])
    got = embed_batches(
        lambda tb: models.forward(model, {"tokens": tb}, cfg,
                                  return_hidden=True)[0], batches)
    assert tuple(got.shape) == (64, cfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    jcs = jselect_coreset(want, 8, impl="ref")
    cs = select_coreset(got, 8, device="cpu")
    np.testing.assert_array_equal(cs.indices.numpy(), np.asarray(jcs.indices))
    np.testing.assert_array_equal(cs.weights.numpy(), np.asarray(jcs.weights))
    np.testing.assert_allclose(cs.radius2.numpy(), np.asarray(jcs.radius2),
                               rtol=1e-4)
