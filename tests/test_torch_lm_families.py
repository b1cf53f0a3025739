"""The port's moe, ssm, hybrid and vlm families against the JAX package,
on the CPU.

The JAX package's weights (``init_params(PRNGKey(0), cfg)`` of a smoke
config) are carried into the port by ``interop.params_from_jax``, and the
same numpy inputs (``model_batch``: tokens, and patch embeddings for the
vlm) go through both. Tolerances, in order:
  * f32: logits, aux losses, caches (attention rows, SSM states and conv
    windows) within rtol 1e-5, atol 1e-5 (measured: logits ~6e-6 on dbrx
    and kimi-k2, ~2e-6 elsewhere; SSM states ~1e-5 of values up to ~17,
    within rtol);
  * layers alone: SSD within rtol/atol 1e-5 of the JAX scan and 1e-4 of a
    sequential float64 recurrence (16 steps of exp and products in f32);
    M-RoPE cos/sin within atol 1e-4, as RoPE's;
  * bf16: within atol 0.05 on logits (the two round different
    intermediates);
  * exact: expert choices, drop counts, M-RoPE positions, the carry, and
    the ``Engine``'s tokens.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.models import layers as jlayers
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro_torch import configs, models
from repro_torch.data import model_batch
from repro_torch.interop import params_from_jax
from repro_torch.models import layers
from repro_torch.serve import Engine, Request

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ATOL = 0.05
FAMILIES = ["dbrx_132b", "kimi_k2_1t_a32b", "mamba2_370m", "hymba_1_5b",
            "qwen2_vl_2b"]


def _carry(arch, **replace):
    """(JAX cfg, JAX params, the port's cfg, the port's model on the CPU)."""
    jcfg = jconfigs.get_config(arch, smoke=True).replace(**replace)
    cfg = configs.get_config(arch, smoke=True).replace(**replace)
    jp = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=FAMILIES)
def carried(request):
    return _carry(request.param)


def test_forward_prefill_decode_match_jax(carried):
    """forward (logits, hidden states and moe_aux), then a 12-token prompt
    prefilled (past hymba's window of 8 and across SSD's chunk of 8) and 3
    decode steps (M-RoPE: rope positions behind the cache slots)."""
    jcfg, jp, cfg, model = carried
    batch = model_batch(cfg, 2, 19, seed=1)
    for hidden in (False, True):
        want, waux = jmodels.forward(jp, _jax(batch), jcfg, return_hidden=hidden)
        got, aux = models.forward(model, batch, cfg, return_hidden=hidden)
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    assert got.dtype == torch.float32
    if cfg.family == "moe":
        assert float(aux["moe_aux"]) > 0
        np.testing.assert_allclose(float(aux["moe_aux"]), float(waux["moe_aux"]),
                                   **F32_TOL)
    else:
        assert aux == {"moe_aux": 0.0}
    pre = dict(batch, tokens=batch["tokens"][:, :12])
    wl, wc = jmodels.prefill(jp, _jax(pre), jcfg, 24)
    gl, gc = models.prefill(model, pre, cfg, 24)
    np.testing.assert_allclose(_np(gl), _np(wl), **F32_TOL)
    assert sorted(gc) == sorted(wc)
    for name in gc:
        assert gc[name].dtype == {"pos": torch.int32, "state": torch.float32}.get(
            name, torch.float32)
        np.testing.assert_allclose(_np(gc[name]), _np(wc[name]), **F32_TOL)
    for s in range(12, 15):
        tok = batch["tokens"][:, s:s + 1]
        wl, wc = jmodels.decode_step(jp, wc, jnp.asarray(tok), jcfg)
        gl, gc = models.decode_step(model, gc, tok, cfg)
        np.testing.assert_allclose(_np(gl), _np(wl), **F32_TOL)
    for name in gc:
        np.testing.assert_allclose(_np(gc[name]), _np(wc[name]), **F32_TOL)


@pytest.mark.parametrize("arch", ["dbrx_132b", "mamba2_370m", "hymba_1_5b",
                                  "qwen2_vl_2b"])
def test_bf16_matches_jax(arch):
    jcfg, jp, cfg, model = _carry(arch, param_dtype="bfloat16",
                                  compute_dtype="bfloat16")
    batch = model_batch(cfg, 2, 12, seed=4)
    want, _ = jmodels.forward(jp, _jax(batch), jcfg)
    got, _ = models.forward(model, batch, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=BF16_ATOL)
    wl, wc = jmodels.prefill(jp, _jax(batch), jcfg, 16)
    gl, gc = models.prefill(model, batch, cfg, 16)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=0, atol=BF16_ATOL)
    assert all(gc[n].dtype == torch.bfloat16 for n in ("k", "conv") if n in gc)
    assert "state" not in gc or gc["state"].dtype == torch.float32
    tok = batch["tokens"][:, :1]
    wl, _ = jmodels.decode_step(jp, wc, jnp.asarray(tok), jcfg)
    gl, _ = models.decode_step(model, gc, tok, cfg)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=0, atol=BF16_ATOL)


def _step_drift(prefill, decode_step, forward, tokens, n):
    """Each of prefill(n) and the decode steps after it against forward
    over all of ``tokens``: max |difference| over a position's logits, as
    a fraction of forward's max |logit| (position 0 is the prefill's)."""
    full = _np(forward(tokens))[:, n - 1:]
    logits, cache = prefill(tokens[:, :n])
    steps = [_np(logits)[:, -1]]
    for i in range(n, tokens.shape[1]):
        logits, cache = decode_step(cache, tokens[:, i:i + 1])
        steps.append(_np(logits)[:, -1])
    steps = np.stack(steps, 1)
    assert np.isfinite(steps).all()
    return np.abs(steps - full).max(axis=(0, 2)) / np.abs(full).max()


@pytest.mark.parametrize("arch,depth", [("mamba2_370m", 48), ("hymba_1_5b", 32)])
def test_bf16_ssm_decode_drift(arch, depth):
    """In bf16 the SSM's sequence path (chunked SSD; the conv's products and
    sums each rounded) and its step path (the recurrence; an einsum rounded
    once) part over depth, in the JAX package as in the port. At smoke
    width and the published depth, a 20-token prompt and 8 steps, the JAX
    package's own steps drift up to 0.37 (mamba2) and 0.075 (hymba) of
    max|logit| from its forward, the port's 0.28 and 0.070 (measured):
    past the 5e-2 that holds every other family. Held: the reference
    drifts past 5e-2, and the port no more than the reference."""
    jcfg, jp, cfg, model = _carry(arch, param_dtype="bfloat16",
                                  compute_dtype="bfloat16", num_layers=depth)
    n, total = 20, 28
    tokens = model_batch(cfg, 2, total, seed=2)["tokens"]
    want = _step_drift(lambda t: jmodels.prefill(jp, {"tokens": jnp.asarray(t)}, jcfg, total),
                       lambda c, t: jmodels.decode_step(jp, c, jnp.asarray(t), jcfg),
                       lambda t: jmodels.forward(jp, {"tokens": jnp.asarray(t)}, jcfg)[0],
                       tokens, n)
    got = _step_drift(lambda t: models.prefill(model, {"tokens": t}, cfg, total),
                      lambda c, t: models.decode_step(model, c, t, cfg),
                      lambda t: models.forward(model, {"tokens": t}, cfg)[0],
                      tokens, n)
    assert want.max() > 5e-2, want
    assert got.max() <= want.max(), (got, want)


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_from_jax_exact(arch):
    """Every family's names carried bit for bit in bf16 (the expert stacks,
    the router and SSM leaves in f32, hybrid's branch norms, patch_proj);
    a dtype or shape mismatch raises."""
    jcfg = jconfigs.get_config(arch, smoke=True).replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg = configs.get_config(arch, smoke=True).replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    jp = jax.tree.map(np.asarray, jmodels.init_params(jax.random.PRNGKey(2), jcfg))
    model = params_from_jax(jp, cfg, "cpu")
    sd = model.state_dict()
    flat = {}

    def walk(path, node):
        if isinstance(node, dict):
            for key, child in node.items():
                walk(path + (key,), child)
        else:
            flat[path] = node
    walk((), jp)
    assert len(sd) == sum(a.shape[0] if p[0] == "layers" else 1
                          for p, a in flat.items())
    for path, a in flat.items():
        rows = ([(".".join(("layers", str(i)) + path[1:]), a[i])
                 for i in range(a.shape[0])] if path[0] == "layers"
                else [(".".join(path), a)])
        for name, want in rows:
            got = sd[name]
            if want.dtype == ml_dtypes.bfloat16:
                assert got.dtype == torch.bfloat16, name
                np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                              want.view(np.int16))
            else:
                assert got.dtype == torch.float32, name
                np.testing.assert_array_equal(got.numpy(), want)
    leaf = {"moe": ("moe", "w_up"), "ssm": ("ssm", "conv"),
            "hybrid": ("ssm", "w_in"), "vlm": ("attn", "wq")}[cfg.family]
    bad = jax.tree.map(lambda a: a, jp)
    bad["layers"][leaf[0]][leaf[1]] = bad["layers"][leaf[0]][leaf[1]].astype(np.float32)
    with pytest.raises(ValueError, match=".".join(leaf)):
        params_from_jax(bad, cfg, "cpu")
    bad = jax.tree.map(lambda a: a, jp)
    bad["embed"] = bad["embed"][:, :-1]
    with pytest.raises(ValueError, match="embed"):
        params_from_jax(bad, cfg, "cpu")
    if cfg.family == "hybrid":
        del bad["layers"]["bnorm_a"]
        with pytest.raises(KeyError, match="bnorm_a"):
            params_from_jax(bad, cfg, "cpu")


# ---------------------------------------------------------------------------
# layers, module by module
# ---------------------------------------------------------------------------

def test_mrope_matches_jax_and_reduces_to_rope():
    rng = np.random.default_rng(0)
    pos3 = rng.integers(0, 700, (3, 2, 9)).astype(np.int32)
    for sections, hd, theta in (((2, 3, 3), 16, 1e4), ((16, 24, 24), 128, 1e6)):
        jc, js = jlayers.mrope_cos_sin(jnp.asarray(pos3), sections, hd, theta)
        tc, ts = layers.mrope_cos_sin(torch.from_numpy(pos3), sections, hd, theta)
        assert tuple(tc.shape) == (2, 9, hd // 2)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-4)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-4)
    # all three components equal: plain RoPE (tests/test_models.py's check)
    pos = torch.arange(10, dtype=torch.int32)[None]
    c1, s1 = layers.rope_cos_sin(pos, 16, 1e4)
    c2, s2 = layers.mrope_cos_sin(pos[None].expand(3, 1, 10), (2, 3, 3), 16, 1e4)
    torch.testing.assert_close(c1, c2, rtol=0, atol=0)
    torch.testing.assert_close(s1, s2, rtol=0, atol=0)


@pytest.mark.parametrize("P,S", [(4, 12), (256, 272), (0, 5), (10, 6)])
def test_build_mrope_positions_match_jax(P, S):
    jcfg = jconfigs.get_config("qwen2_vl_2b", smoke=True).replace(num_patches=P)
    cfg = configs.get_config("qwen2_vl_2b", smoke=True).replace(num_patches=P)
    got = models.build_mrope_positions(cfg, 2, S, "cpu")
    want = np.asarray(jmodels.build_mrope_positions(jcfg, 2, S))
    assert tuple(got.shape) == (3, 2, S)
    np.testing.assert_array_equal(got.numpy(), want)


def _ssd_inputs(B, S, nh, P, N, seed, dt_hi):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, nh, P)).astype(np.float32),
            rng.uniform(0.1, dt_hi, (B, S, nh)).astype(np.float32),
            -rng.uniform(0.1, 1.0, (nh,)).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32),
            rng.normal(size=(B, nh, N, P)).astype(np.float32))


@pytest.mark.parametrize("S,with_h0,dt_hi", [(13, False, 0.9), (13, True, 0.9),
                                             (16, True, 0.9), (3, True, 0.9),
                                             (13, True, 60.0)])
def test_ssd_chunked_matches_jax_and_scan(S, with_h0, dt_hi):
    """Chunks of 4: S = 13 pads 3 rows; with a carried state; S = 3 below
    one chunk; timesteps up to 60, so that the exp of the cumulative sums
    above the diagonal overflows to inf (selected away, never multiplied).
    Against the JAX scan and a float64 per-step recurrence
    (tests/test_models.py's oracle, from h0)."""
    cfg = configs.get_config("mamba2_370m", smoke=True).replace(ssm_chunk=4)
    jcfg = jconfigs.get_config("mamba2_370m", smoke=True).replace(ssm_chunk=4)
    B, nh, P, N = 2, 4, 8, 8
    xh, dtp, A, Bc, Cc, h0 = _ssd_inputs(B, S, nh, P, N, seed=S, dt_hi=dt_hi)
    h0 = h0 if with_h0 else None
    y, h = layers.ssd_chunked(*(torch.from_numpy(a) for a in (xh, dtp, A, Bc, Cc)),
                              cfg, h0=None if h0 is None else torch.from_numpy(h0))
    wy, wh = jlayers.ssd_chunked(*(jnp.asarray(a) for a in (xh, dtp, A, Bc, Cc)),
                                 jcfg, h0=None if h0 is None else jnp.asarray(h0))
    assert tuple(y.shape) == (B, S, nh, P) and y.dtype == torch.float32
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **F32_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(wh), **F32_TOL)
    hs = np.zeros((B, nh, N, P)) if h0 is None else h0.astype(np.float64)
    ys = []
    for t in range(S):
        da = np.exp(dtp[:, t].astype(np.float64) * A[None, :])
        bx = np.einsum("bn,bhp->bhnp", Bc[:, t], xh[:, t] * dtp[:, t][..., None])
        hs = hs * da[:, :, None, None] + bx
        ys.append(np.einsum("bn,bhnp->bhp", Cc[:, t], hs))
    np.testing.assert_allclose(y.numpy(), np.stack(ys, 1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h.numpy(), hs, rtol=1e-4, atol=1e-4)


def test_causal_conv_matches_jax():
    """Whole sequences (S = 6 and S = 2, below the K - 1 = 3 window) and
    the streaming step on a cache, against the JAX function; and the
    steps' outputs equal the whole sequence's."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(4, 10)).astype(np.float32)
    for S in (6, 2):
        x = rng.normal(size=(2, S, 10)).astype(np.float32)
        out, cache = layers._causal_conv(torch.from_numpy(x), torch.from_numpy(w))
        wout, wcache = jlayers._causal_conv(jnp.asarray(x), jnp.asarray(w))
        np.testing.assert_allclose(out.numpy(), np.asarray(wout), **F32_TOL)
        np.testing.assert_array_equal(cache.numpy(), np.asarray(wcache))
    x = rng.normal(size=(2, 6, 10)).astype(np.float32)
    whole, _ = layers._causal_conv(torch.from_numpy(x), torch.from_numpy(w))
    cache = torch.zeros((2, 3, 10))
    jcache = jnp.zeros((2, 3, 10))
    for t in range(6):
        step, cache = layers._causal_conv(torch.from_numpy(x[:, t:t + 1]),
                                          torch.from_numpy(w), cache)
        wstep, jcache = jlayers._causal_conv(jnp.asarray(x[:, t:t + 1]),
                                             jnp.asarray(w), jcache)
        np.testing.assert_allclose(step.numpy(), np.asarray(wstep), **F32_TOL)
        np.testing.assert_allclose(step[:, 0].numpy(), whole[:, t].numpy(), **F32_TOL)
        np.testing.assert_array_equal(cache.numpy(), np.asarray(jcache))


def test_softplus_is_jax():
    """``logaddexp(x, 0)`` across the range (``F.softplus`` returns x past
    20, which f32 cannot tell apart: exp(-20) is below x's rounding); XLA
    flushes a subnormal result (x = -100) to 0, hence the atol of f32's
    smallest normal."""
    x = np.array([-100.0, -20.0, -1.0, 0.0, 1e-3, 5.0, 20.0, 25.0, 90.0],
                 np.float32)
    np.testing.assert_allclose(layers.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-7, atol=np.finfo(np.float32).tiny)


def _moe_case(cfg, N, seed, skew):
    """Tokens, router and experts; where ``skew``, the tokens share a mean
    of 0.5 and expert 0's router column leans along it, so that most
    tokens pick that expert."""
    rng = np.random.default_rng(seed)
    D, E, Fd = cfg.d_model, cfg.num_experts, cfg.d_ff
    xf = rng.normal(size=(N, D)).astype(np.float32) + (0.5 if skew else 0.0)
    router = (rng.normal(size=(D, E)) * 0.1).astype(np.float32)
    router[:, 0] += skew / D
    experts = [(rng.normal(size=s) * 0.05).astype(np.float32)
               for s in ((E, D, Fd), (E, D, Fd), (E, Fd, D))]
    return xf, router, experts


def _jax_drops(xf, router, cfg, cf):
    """The JAX package's drop count: its router's top-k, counted against its
    capacity by expert."""
    probs = jax.nn.softmax(jlayers.matmul(jnp.asarray(xf), jnp.asarray(router)), -1)
    _, eidx = jax.lax.top_k(probs, cfg.top_k)
    counts = np.bincount(np.asarray(eidx).reshape(-1), minlength=cfg.num_experts)
    C = layers.moe_capacity(xf.shape[0], cfg, cf)
    return int(np.maximum(counts - C, 0).sum()), np.asarray(eidx)


@pytest.mark.parametrize("cf,skew", [(1.25, 8.0), (1.25, 0.0), (0.5, 0.0)])
def test_moe_math_matches_jax_with_drops(cf, skew):
    """N = 200 tokens, E = 4, K = 2: capacity max(ceil(N·K/E·cf), 64). A
    router skewed to expert 0 overfills it, so tokens are dropped (the
    count checked > 0 in both packages); the unskewed router at cf 1.25
    drops none; at cf 0.5 (C = 64) both drop some."""
    cfg = configs.get_config("dbrx_132b", smoke=True)
    jcfg = jconfigs.get_config("dbrx_132b", smoke=True)
    xf, router, (wg, wu, wd) = _moe_case(cfg, 200, 3, skew)
    want, waux = jlayers._moe_math(*(jnp.asarray(a) for a in (xf, router, wg, wu, wd)),
                                   jcfg, cf, 0, cfg.num_experts)
    args = [torch.from_numpy(a) for a in (xf, router, wg, wu, wd)]
    got, aux = layers._moe_math(*args, cfg, cf)
    _, _, eidx, _, slot, _, _, C = layers._moe_route(args[0], args[1], cfg, cf)
    drops = int((slot >= C).sum())
    jdrops, jeidx = _jax_drops(xf, router, cfg, cf)
    np.testing.assert_array_equal(eidx.numpy(), jeidx)
    assert drops == jdrops
    assert (drops > 0) == (skew > 0 or cf < 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(float(aux), float(waux), **F32_TOL)
    # a dropped assignment adds nothing: with every queue drop-free (cf =
    # E/K gives C = N), the dropped tokens' outputs change and the others
    # stay
    full, _ = layers._moe_math(*args, cfg, cfg.num_experts / cfg.top_k)
    hit = (slot >= C).any(1)
    torch.testing.assert_close(full[~hit], got[~hit], **F32_TOL)
    if drops:
        assert bool((full[hit] - got[hit]).abs().amax(1).gt(1e-6).all())


def test_moe_ties_take_the_lower_expert():
    """Two experts with one router column tie on every token: both packages
    pick the lower index first (jax.lax.top_k's rule)."""
    cfg = configs.get_config("dbrx_132b", smoke=True)
    xf, router, _ = _moe_case(cfg, 32, 5, 0.0)
    router[:, 2] = router[:, 1]
    router[:, 3] = router[:, 1] - 1.0           # never in the top 2 with 1, 2
    _, _, eidx, *_ = layers._moe_route(torch.from_numpy(xf),
                                       torch.from_numpy(router), cfg, 1.25)
    _, jeidx = _jax_drops(xf, router, cfg, 1.25)
    np.testing.assert_array_equal(eidx.numpy(), jeidx)
    ties = (eidx == 1).any(1) & (eidx == 2).any(1)
    assert bool(ties.any()) and bool((eidx[ties] == torch.tensor([1, 2])).all())


def test_window_mask_decode():
    """Hymba decode: a window layer sees the last ``window`` positions, a
    global one all up to the query (tests/test_models.py's check), and
    both packages' causal masks agree at every offset."""
    q_pos = torch.tensor([[10]])
    k_idx = torch.arange(16)
    m_global = layers._mask_block(q_pos, k_idx, 0)[0, 0]
    m_window = layers._mask_block(q_pos, k_idx, 4)[0, 0]
    assert m_global[:11].all() and not m_global[11:].any()
    assert m_window[7:11].all() and not m_window[:7].any() and not m_window[11:].any()
    q = np.arange(0, 20, 3, dtype=np.int32)[None].repeat(2, 0)
    for window in (0, 1, 4, 8):
        want = jlayers._mask_block(jnp.asarray(q), jnp.arange(16, dtype=jnp.int32),
                                   jnp.int32(window), False)
        got = layers._mask_block(torch.from_numpy(q), torch.arange(16), window)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_window_attention_decode_matches_jax():
    """Hymba's window layer, one decode step at position 10 of a filled
    cache, and its global layer, against the JAX attention_decode."""
    jcfg, jp, cfg, model = _carry("hymba_1_5b")
    rng = np.random.default_rng(9)
    B, S_max = 2, 16
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    ck = rng.normal(size=(B, S_max, cfg.num_kv_heads, cfg.resolved_head_dim)
                    ).astype(np.float32)
    cv = rng.normal(size=ck.shape).astype(np.float32)
    pos = np.array([10, 3], np.int32)
    for i, window in ((0, 0), (1, cfg.window)):
        jattn = jax.tree.map(lambda a: a[i], jp["layers"]["attn"])
        want, wk, _ = jlayers.attention_decode(
            jattn, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
            jnp.asarray(pos), jcfg, window=window)
        got, gk, _ = layers.attention_decode(
            model.layers[i].attn, torch.from_numpy(x), torch.from_numpy(ck.copy()),
            torch.from_numpy(cv.copy()), torch.from_numpy(pos), cfg, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **F32_TOL)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

SPECS = [  # (prompt length, temperature, top_k, top_p, max_new)
    (5, 0.0, 0, 1.0, 6),       # retires on max_new
    (12, 0.7, 40, 1.0, 8),     # stochastic, top-k
    (3, 0.0, 0, 1.0, 30),      # bucket 8: the cache (s_max 32) fills first
    (9, 0.9, 0, 0.9, 10),      # stochastic, top-p; bucket 16
    (7, 0.0, 0, 1.0, 12),
]
S_MAX = 32


def _requests(cls):
    rng = np.random.default_rng(3)
    return [cls(uid=i, tokens=rng.integers(0, 512, n).astype(np.int32),
                temperature=t, top_k=k, top_p=p, max_new=m)
            for i, (n, t, k, p, m) in enumerate(SPECS)]


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return {r.uid: r.out for r in eng.run()}


@pytest.mark.parametrize("arch", ["hymba_1_5b", "dbrx_132b"])
def test_engine_matches_jax_engine(arch):
    """5 mixed greedy and stochastic requests through 2 slots (the SSM
    states and conv windows spliced with the attention rows): every
    request's tokens equal the JAX Engine's; exactly one synchronising read
    a step plus one an admission."""
    jcfg, jp, cfg, model = _carry(arch)
    eng = Engine(model, cfg, slots=2, s_max=S_MAX)
    for r in _requests(Request):
        eng.submit(r)
    steps = 0
    while eng.pending or eng.alive.any():
        eng.step()
        steps += 1
    got = {r.uid: r.out for r in eng.done}
    assert eng.reads == steps + len(SPECS)
    want = _serve(JEngine(jp, jcfg, slots=2, s_max=S_MAX), _requests(JRequest))
    assert got == want
    assert [len(got[i]) for i in (0, 1, 3, 4)] == [6, 8, 10, 12]
    assert len(got[2]) == S_MAX - 1 - 8 + 1 < 30                  # full cache
    np.testing.assert_array_equal(eng.cache["pos"].numpy(), eng.pos)
