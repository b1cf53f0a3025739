"""The port's training (``repro_torch.optim``, ``repro_torch.train``, the
models' remat) against the JAX package, on the CPU.

The JAX package's weights and train states are carried into the port by
``interop.params_from_jax`` and ``train_state_from_jax``; the same numpy
inputs (``model_batch``, gradients drawn from a numpy seed) go through
both. The port's per-layer gradients and moments are stacked into the JAX
package's leaves (``optim.leaf_groups``) for comparison. Tolerances:
  * schedules: rtol 1e-6;
  * optimizer updates (the same gradients): params and state within rtol
    1e-6, atol 1e-7;
  * losses: rtol 1e-5; each gradient leaf within 1e-4 of its largest |g|
    (a leaf whose gradient is below 1e-4 of the model's largest, such as
    the key bias's, 0 in exact arithmetic: a bias on the keys shifts all
    of a query's scores alike, within 1e-8 of the model's largest);
  * train steps (lr 1e-3): params within atol 1e-6 (3e-5 with dbrx's
    bf16 accumulator), except, under AdamW, at gradient elements below the
    gradient tolerance at some step: there ``g / (|g| + 1e-8)`` (nearly a
    sign at the first step) turns rounding noise into up to ±lr. Those are
    left out and counted (at most 5 % of the elements, each within two
    learning rates a step).
  * remat: the port's gradients bitwise across none, full, dots and
    blocks; each within the loss tolerance of JAX under the same setting.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro import optim as joptim
from repro import train as jtrain
from repro.train import step as jstep
from repro_torch import configs, optim, train
from repro_torch.data import model_batch
from repro_torch.interop import params_from_jax, train_state_from_jax
from repro_torch.models import api
from repro_torch.optim.optimizers import leaf_tensor

B, S = 2, 16
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # of the leaf's largest |g|


def _jflat(tree):
    """A JAX param-shaped tree as numpy leaves by dotted path (sorted)."""
    flat = {}

    def walk(path, node):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(path + (key,), node[key])
        else:
            flat[".".join(path)] = np.asarray(node, np.float32)
    walk((), tree)
    return flat


def _stacked(named: dict):
    """The port's per-layer tensors (by parameter name) as JAX leaves."""
    return {key: leaf_tensor(key, [named[n] for n in names]).detach().float().numpy()
            for key, names in optim.leaf_groups(named).items()}


def _unstack(tree: dict) -> dict:
    """A JAX param-shaped numpy tree as the port's per-layer names."""
    out = {}
    for key, a in _jflat(tree).items():
        parts = key.split(".")
        if parts[0] in optim.optimizers.STACKED:
            for i in range(a.shape[0]):
                out[".".join([parts[0], str(i)] + parts[1:])] = a[i]
        else:
            out[key] = a
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _carry(arch, **replace):
    jcfg = jconfigs.get_config(arch, smoke=True).replace(**replace)
    cfg = configs.get_config(arch, smoke=True).replace(**replace)
    jp = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


def _port_grads(cfg, model, batch, **kw):
    model.requires_grad_(True)
    loss, _ = train.make_loss_fn(cfg, **kw)(model, batch)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), dict(zip(names, grads))


def _jax_grads(jcfg, jp, batch, **kw):
    fn = jax.jit(jax.value_and_grad(jstep.make_loss_fn(jcfg, **kw), has_aux=True))
    (loss, _), g = fn(jp, _jax(batch))
    return float(loss), _jflat(g)


def _close_grads(got: dict, want: dict, tol=GRAD_TOL):
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        bound = tol * max(float(np.abs(w).max()), tol * top)
        err = float(np.abs(got[key] - w).max())
        assert err <= bound, f"{key}: {err} > {bound}"


# ---------------------------------------------------------------------------
# schedules and optimizers
# ---------------------------------------------------------------------------

SCHED_STEPS = [0, 1, 4, 9, 10, 11, 37, 50, 79, 80, 81, 90, 99, 100, 140]


@pytest.mark.parametrize("name,kw", [
    ("cosine", dict(peak=3e-4, warmup=10, total=100)),
    ("cosine", dict(peak=1e-2, warmup=3, total=50, floor=1e-4)),
    ("wsd", dict(peak=1e-3, warmup=10, total=100, decay_frac=0.2)),
    ("wsd", dict(peak=3e-4, warmup=1, total=8)),
    ("constant", dict(peak=1e-3, warmup=5)),
])
def test_schedules_match_jax(name, kw):
    jf, f = joptim.make_schedule(name, **kw), optim.make_schedule(name, **kw)
    for s in SCHED_STEPS:
        want = float(jf(jnp.int32(s)))
        got = f(s)
        assert got.dtype == np.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, err_msg=f"step {s}")


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_schedule_for_matches_the_reference_train_loop(arch):
    """The configs name each arch's schedule; the reference's train loop
    picks it from the config's name (wsd for minicpm, else cosine)."""
    for smoke in (False, True):
        name = jconfigs.get_config(arch, smoke=smoke).name
        want = "wsd" if name.startswith("minicpm") else "cosine"
        assert configs.schedule_for(arch) == want, (arch, smoke)


def _grads_like(tree, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.normal(size=p.shape) * scale).astype(p.dtype),
                        jax.tree.map(np.asarray, tree))


OPTIMIZERS = {"adamw": ("adamw", {}), "adafactor": ("adafactor", {}),
              "adafactor_decay": ("adafactor", dict(weight_decay=0.1)),
              "adafactor_chunked": ("adafactor", dict(chunked_update=True))}


@pytest.mark.parametrize("which,arch", [
    ("adamw", "qwen2_0_5b"), ("adamw", "dbrx_132b"),
    ("adafactor", "qwen2_0_5b"), ("adafactor", "dbrx_132b"),
    ("adafactor_decay", "qwen2_0_5b"), ("adafactor_chunked", "qwen2_0_5b"),
])
def test_optimizer_updates_match_jax(which, arch):
    """Three updates fed the same gradients (clipped: their norm is ~50).
    The stacked leaves set the rules: AdamW decays the stacked norm scales
    and biases, Adafactor factors them and clips by the RMS of the whole
    stacked leaf; applied to the port's per-layer tensors, these fail."""
    layers = 8 if which == "adafactor_chunked" else 2   # lax.map from 8 layers
    jcfg, jp, cfg, model = _carry(arch, num_layers=layers)
    name, kw = OPTIMIZERS[which]
    sched = dict(peak=1e-2, warmup=2, total=10)
    jopt = joptim.make_optimizer(name, joptim.make_schedule("cosine", **sched), **kw)
    opt = optim.make_optimizer(name, optim.make_schedule("cosine", **sched), **kw)
    jstate, state = jopt.init(jp), opt.init(model)
    jupdate = jax.jit(jopt.update)
    for i in range(3):
        g = _grads_like(jp, seed=10 + i, scale=0.5)
        jp, jstate = jupdate(jax.tree.map(jnp.asarray, g), jstate, jp)
        model, state = opt.update({n: torch.from_numpy(a) for n, a in
                                   _unstack(g).items()}, state, model)
        np.testing.assert_allclose(float(state["grad_norm"]),
                                   float(jstate["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(state.pop("lr"), float(jstate.pop("lr")),
                                   rtol=1e-6)
        state.pop("grad_norm"), jstate.pop("grad_norm")
    assert state["step"] == int(jstate["step"]) == 3
    got = _stacked(dict(model.named_parameters()))
    for key, want in _jflat(jp).items():
        np.testing.assert_allclose(got[key], want, rtol=1e-6, atol=1e-7, err_msg=key)
    if name == "adamw":
        pairs = [(state[m], _jflat(jstate[m])) for m in ("mu", "nu")]
    else:
        keys = list(_jflat(jp))
        pairs = [({f"{k}.{f}": t for k, v in state["v"].items() for f, t in v.items()},
                  {f"{k}.{f}": np.asarray(t) for k, v in zip(keys, jstate["v"])
                   for f, t in v.items()})]
    for port, ref in pairs:
        assert set(port) == set(ref)
        for key, want in ref.items():
            np.testing.assert_allclose(port[key].numpy(), want, rtol=1e-6,
                                       atol=1e-7, err_msg=key)


def test_clip_keeps_dtype_norm_in_f32():
    g = {"embed": torch.full((4, 3), 2.0, dtype=torch.bfloat16),
         "layers.0.ln1.scale": torch.full((3,), 2.0)}
    clipped, norm = optim.clip_by_global_norm(g, 1.0)
    assert norm.dtype == torch.float32
    np.testing.assert_allclose(float(norm), np.sqrt(15 * 4.0), rtol=1e-6)
    assert clipped["embed"].dtype == torch.bfloat16
    np.testing.assert_allclose(float(optim.global_norm(clipped)), 1.0, rtol=1e-2)


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ["qwen2_0_5b", "qwen2_vl_2b", "dbrx_132b", "mamba2_370m",
                "hymba_1_5b", "whisper_large_v3"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_grads_match_jax(arch):
    """Every family's smoke config, the loss in chunks of 8 positions (two
    chunks of S = 16), the MoE aux term included."""
    jcfg, jp, cfg, model = _carry(arch)
    batch = model_batch(cfg, B, S, seed=3)
    want_loss, want = _jax_grads(jcfg, jp, batch, ce_chunk=8)
    loss, grads = _port_grads(cfg, model, batch, ce_chunk=8)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    _close_grads(_stacked(grads), want)


@pytest.mark.parametrize("S_,chunk", [(8, 4), (8, 8), (9, 4)])
def test_chunked_ce_matches_dense_ce(S_, chunk):
    """A chunk below S, one chunk, and the odd-S fallback to one chunk:
    the loss and both gradients as the dense cross-entropy's, and the loss
    as the JAX package's chunked one."""
    rng = np.random.default_rng(0)
    D, V = 16, 64
    h = rng.normal(size=(B, S_, D)).astype(np.float32)
    w = rng.normal(size=(D, V)).astype(np.float32)
    lab = rng.integers(0, V, (B, S_)).astype(np.int32)
    cfg = configs.get_config("olmo_1b", smoke=True)
    jcfg = jconfigs.get_config("olmo_1b", smoke=True)
    ht, wt = torch.tensor(h, requires_grad=True), torch.tensor(w, requires_grad=True)
    chunked = train.chunked_softmax_xent(ht, wt, lab, cfg, chunk=chunk)
    gc = torch.autograd.grad(chunked, (ht, wt))
    dense = train.cross_entropy(torch.einsum("bsd,dv->bsv", ht, wt),
                                torch.from_numpy(lab))
    gd = torch.autograd.grad(dense, (ht, wt))
    np.testing.assert_allclose(float(chunked.detach()), float(dense.detach()),
                               rtol=1e-6)
    for a, b in zip(gc, gd):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)
    want = jtrain.chunked_softmax_xent(jnp.asarray(h), jnp.asarray(w),
                                       jnp.asarray(lab), jcfg, chunk=chunk)
    np.testing.assert_allclose(float(chunked.detach()), float(want), rtol=1e-6)


def test_cross_entropy_mask_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32)
    lab = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = rng.random((2, 5)) < 0.6
    got = train.cross_entropy(torch.from_numpy(logits), torch.from_numpy(lab),
                              torch.from_numpy(mask))
    want = jtrain.cross_entropy(jnp.asarray(logits), jnp.asarray(lab),
                                jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_moe_aux_term_included():
    cfg = configs.get_config("dbrx_132b", smoke=True)
    model = api.init_params(cfg, seed=0, device="cpu")
    batch = model_batch(cfg, 2, 8)
    with torch.no_grad():
        l0 = float(train.make_loss_fn(cfg, moe_aux_weight=0.0)(model, batch)[0])
        l1 = float(train.make_loss_fn(cfg, moe_aux_weight=10.0)(model, batch)[0])
    assert l1 > l0  # balancing loss is positive


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

REMAT = {"none": dict(remat="none"), "full": dict(remat="full"),
         "dots": dict(remat="dots"), "block": dict(remat="none", remat_block=2)}


@pytest.fixture(scope="module")
def remat_reference():
    """The port's gradients without remat, on a 4-layer qwen2 smoke."""
    _, _, cfg, model = _carry("qwen2_0_5b", num_layers=4)
    batch = model_batch(cfg, B, S, seed=5)
    return _port_grads(cfg, model, batch)


@pytest.mark.parametrize("setting", list(REMAT))
def test_remat_grads_bitwise_and_match_jax(setting, remat_reference):
    """``full`` checkpoints each layer, ``dots`` saves the weight products,
    ``block`` nests 2 blocks of 2 layers: the port's gradients are bitwise
    those without remat, and within tolerance of JAX's under the same
    setting."""
    jcfg, jp, cfg, model = _carry("qwen2_0_5b", num_layers=4, **REMAT[setting])
    batch = model_batch(cfg, B, S, seed=5)
    loss, grads = _port_grads(cfg, model, batch)
    ref_loss, ref = remat_reference
    assert loss == ref_loss
    for n, g in grads.items():
        assert torch.equal(g, ref[n]), n
    want_loss, want = _jax_grads(jcfg, jp, batch)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    _close_grads(_stacked(grads), want)


def test_remat_checkpoints_only_where_autograd_records(monkeypatch):
    """Serving records nothing, so it checkpoints nothing; a training
    forward checkpoints each layer under ``full``."""
    from repro_torch.models import lm
    calls = []
    real = lm.checkpoint
    monkeypatch.setattr(lm, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = configs.get_config("qwen2_0_5b", smoke=True).replace(remat="full")
    model = api.init_params(cfg, seed=0, device="cpu")
    batch = model_batch(cfg, 2, 8)
    api.forward(model, batch, cfg)
    assert calls == []
    model.requires_grad_(True)
    api.train_forward(model, batch, cfg)
    assert len(calls) == cfg.num_layers


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def test_microbatched_step_matches_full_batch():
    """olmo smoke, batch 8: 4 microbatches against one, f32 accumulation
    (as tests/test_train.py holds the JAX package)."""
    cfg = configs.get_config("olmo_1b", smoke=True)
    opt = optim.adamw(optim.make_schedule("constant", peak=1e-3))
    batch = model_batch(cfg, 8, 16)
    s1, m1 = train.make_train_step(cfg, opt, num_microbatches=1)(
        train.init_train_state(cfg, opt, seed=1, device="cpu"), batch)
    s4, m4 = train.make_train_step(cfg.replace(microbatches=4), opt)(
        train.init_train_state(cfg, opt, seed=1, device="cpu"), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]), rtol=1e-5)
    p4 = dict(s4["params"].named_parameters())
    for n, p in s1["params"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), p4[n].detach().numpy(),
                                   rtol=5e-4, atol=5e-5, err_msg=n)


# (arch, config changes, params' atol): AdamW (qwen2); Adafactor with 2
# microbatches (dbrx), accumulated in f32, then in the config's bf16, where
# each microbatch's gradient is rounded to bf16 in both packages from f32
# values that differ in their last bits, so a rounding may fall one bf16
# step (2^-8 relative) apart; through the factored preconditioner an update
# element (up to ~4 in size) moves by up to ~1 % a step: params within
# 0.1 of the learning rate after 3 steps (measured 3.2e-5)
STEP_RUNS = {"qwen2": ("qwen2_0_5b", {}, 1e-6),
             "dbrx": ("dbrx_132b", dict(accum_dtype="float32"), 1e-6),
             "dbrx_bf16_accum": ("dbrx_132b", {}, 1e-4)}
STEPS, STEP_B, STEP_LR = 3, 4, 1e-3


def _step_opt(pkg, cfg):
    return pkg.make_optimizer(cfg.optimizer, pkg.make_schedule(
        "cosine", peak=STEP_LR, warmup=1, total=10))


@pytest.fixture(scope="module", params=list(STEP_RUNS))
def jax_run(request):
    """The JAX package's 3 train steps from init: the config, its losses,
    its state at init, after 2 steps and after 3, as numpy."""
    arch, changes, atol = STEP_RUNS[request.param]
    jcfg = jconfigs.get_config(arch, smoke=True).replace(**changes)
    jopt = _step_opt(joptim, jcfg)
    state = jtrain.init_train_state(jax.random.PRNGKey(0), jcfg, jopt)
    states = [jax.tree.map(np.asarray, state)]
    step = jax.jit(jtrain.make_train_step(jcfg, jopt))
    losses = []
    for s in range(STEPS):
        state, m = step(state, _jax(model_batch(jcfg, STEP_B, S, step=s)))
        losses.append(float(m["loss"]))
        states.append(jax.tree.map(np.asarray, state))
    cfg = configs.get_config(arch, smoke=True).replace(**changes)
    return cfg, atol, losses, states


class GradSpy:
    """The optimizer with each update's gradients kept, as JAX leaves."""

    def __init__(self, opt):
        self.opt, self.grads = opt, []

    def optimizer(self):
        def update(grads, state, model):
            self.grads.append(_stacked(grads))
            return self.opt.update(grads, state, model)
        return optim.Optimizer(self.opt.init, update)

    def unresolved(self, cfg):
        """Per leaf, where AdamW meets a gradient element below GRAD_TOL of
        its leaf's largest |g| at some step (the two packages' gradients
        are not held to agree there); nowhere for Adafactor."""
        return {key: np.any([np.abs(g[key]) < GRAD_TOL * np.abs(g[key]).max()
                             for g in self.grads], axis=0)
                & (cfg.optimizer == "adamw")
                for key in self.grads[0]}


def _params_close(got: dict, want: dict, unresolved: dict, atol: float):
    """Params within ``atol``, except at the ``unresolved`` gradient
    elements: those are left out and counted; they may be at most 5 % of
    the elements, each within two learning rates a step. Returns (left
    out, of those off by more than ``atol``)."""
    left = off = total = 0
    for key, w in want.items():
        d = np.abs(got[key] - w)
        mask = unresolved[key]
        assert float(d.max()) <= 2 * STEP_LR * STEPS, key
        assert float(d[~mask].max(initial=0.0)) <= atol, key
        left += int(mask.sum())
        off += int((d[mask] > atol).sum())
        total += w.size
    assert left <= 0.05 * total, f"{left} of {total} elements left out"
    return left, off


def test_train_steps_match_jax(jax_run):
    cfg, atol, losses, states = jax_run
    spy = GradSpy(_step_opt(optim, cfg))
    state = train_state_from_jax(states[0], cfg, "cpu")
    step = train.make_train_step(cfg, spy.optimizer())
    for s in range(STEPS):
        state, m = step(state, model_batch(cfg, STEP_B, S, step=s))
        np.testing.assert_allclose(float(m["loss"]), losses[s], rtol=LOSS_RTOL)
    assert state["step"] == STEPS == state["opt"]["step"]
    _params_close(_stacked(dict(state["params"].named_parameters())),
                  _jflat(states[-1]["params"]), spy.unresolved(cfg), atol)


def test_state_carried_from_jax_after_two_steps(jax_run):
    """The JAX state after 2 steps, its moments included, carried across:
    the third step in the port lands where the JAX package's does."""
    cfg, atol, losses, states = jax_run
    state = train_state_from_jax(states[2], cfg, "cpu")
    assert state["step"] == 2 == state["opt"]["step"]
    spy = GradSpy(_step_opt(optim, cfg))
    state, m = train.make_train_step(cfg, spy.optimizer())(
        state, model_batch(cfg, STEP_B, S, step=2))
    np.testing.assert_allclose(float(m["loss"]), losses[2], rtol=LOSS_RTOL)
    _params_close(_stacked(dict(state["params"].named_parameters())),
                  _jflat(states[3]["params"]), spy.unresolved(cfg), atol)


def test_loss_decreases_smoke_lm():
    cfg = configs.get_config("qwen2_0_5b", smoke=True)
    opt = optim.adamw(optim.make_schedule("cosine", peak=1e-2, warmup=3, total=30))
    state = train.init_train_state(cfg, opt, seed=0, device="cpu")
    step = train.make_train_step(cfg, opt)
    losses = []
    for s in range(25):
        state, m = step(state, model_batch(cfg, 8, 32, step=s))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses


# ---------------------------------------------------------------------------
# SSD at the configs' chunk
# ---------------------------------------------------------------------------

def test_ssd_grads_finite_at_chunk_256():
    """mamba2 smoke at ``ssm_chunk=256``, S = 256: a chunk's sum of dt·|A|
    passes ~88, where the reference's ``exp`` above the diagonal overflows
    and its gradient is NaN (asserted, so that a change on either side
    shows). The port masks before the ``exp``: its loss is the reference's
    and its gradients are finite and those of the reference at chunk 8."""
    jcfg, jp, cfg, model = _carry("mamba2_370m", ssm_chunk=256)
    batch = model_batch(cfg, 1, 256, seed=7)
    nan_loss, nan_grads = _jax_grads(jcfg, jp, batch)
    assert any(np.isnan(g).any() for g in nan_grads.values())
    want_loss, want = _jax_grads(jcfg.replace(ssm_chunk=8), jp, batch)
    assert all(np.isfinite(g).all() for g in want.values())
    loss, grads = _port_grads(cfg, model, batch)
    np.testing.assert_allclose(loss, nan_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    got = _stacked(grads)
    assert all(np.isfinite(g).all() for g in got.values())
    _close_grads(got, want)
