"""The port's sharding of the LM (``repro_torch.sharding``), held against
the JAX package's rules and against the port's own one-device runs.

  (a) the placements of every architecture's parameters, train state,
      cache and batch equal the JAX package's ``PartitionSpec``s, leaf by
      leaf, on six meshes (the JAX side on ``AbstractMesh``);
  (b) ``_moe_math`` on each tp shard of the experts against the JAX
      ``_moe_math`` with the same expert range, with drops; the shards sum
      to the one-device result;
  (c) four gloo processes (one ``run_scenario``): qwen2, mamba2 and kimi-k2
      smoke configs at (2, 2) and (1, 4) against the one-device CPU run
      (forward, two ``train_loop`` steps, prefill + decode), each
      process's parameter bytes against the rules, and a checkpoint saved
      at (2, 2) restored at (4, 1);
  (d) the dry-run CLI for one cell on a fake 256-rank group;
  (e) the production and elastic meshes on fake groups of 512, 448 and 7.

The workers of (c) load this file as ``file.py:function``, so it imports
no ``jax`` at module level.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((4, 1), ("data", "model")), ((1, 4), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
SHARDED_ARCHS = ["qwen2_0_5b", "mamba2_370m", "kimi_k2_1t_a32b"]
SHARDED_MESHES = [(2, 2), (1, 4)]
# kimi-k2 accumulates its microbatches' gradients in bf16: a rounding of
# one sum order lands an ulp (2^-8) away from the other's in some elements
# (7.3e-6 on a parameter after two steps at (2, 2)), so the parameters are
# held at 1e-6 with an f32 accumulator, and the config's own bf16 run by
# its losses (BF16_ACC).
BF16_ACC = "kimi_k2_1t_a32b-bf16acc-2x2"


def _config(arch: str, *, bf16_acc: bool = False):
    cfg = get_config(arch, smoke=True)
    return cfg if bf16_acc else cfg.replace(accum_dtype="float32")
B, S = 4, 8          # kimi smoke: N·K = 64 tokens' slots, drop-free (C >= 64)
TRAIN_STEPS = 2


# ---------------------------------------------------------------------------
# (a) placements against the JAX package's specs
# ---------------------------------------------------------------------------

def _jax_placements(pspec, axis_names) -> tuple:
    """A JAX ``PartitionSpec`` as DTensor placements on the same axes."""
    from torch.distributed.tensor import Replicate, Shard
    owner = {}
    for i, entry in enumerate(tuple(pspec)):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                owner[axis] = i
    return tuple(Shard(owner[a]) if a in owner else Replicate() for a in axis_names)


def _jax_paths(tree) -> dict:
    import jax
    from repro.sharding.specs import _leaf_name
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_leaf_name(p): leaf for p, leaf in flat}


@pytest.fixture(scope="module")
def jax_trees():
    """The JAX package's abstract train state, cache and batch of every
    architecture (``repro.launch.specs``), built once."""
    from repro.launch import specs as jspecs
    out = {}
    for arch in ARCH_IDS:
        jcfg = jspecs.get_config(arch)
        out[arch] = {"state": jspecs.state_specs(jcfg),
                     "cache": jspecs.cache_specs(jcfg, 128, 32768),
                     "batch": jspecs.batch_specs(jcfg, 256, 4096, train=True)}
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_the_jax_package(arch, jax_trees):
    from jax.sharding import AbstractMesh
    from repro.sharding import specs as jrules

    from repro_torch.launch import Mesh
    from repro_torch.launch import specs as tspecs
    from repro_torch.sharding import specs as trules

    cfg = get_config(arch)
    state = tspecs.state_specs(cfg)
    cache = tspecs.cache_specs(cfg, 128, 32768)
    batch = tspecs.batch_specs(cfg, 256, 4096, train=True)
    jt = jax_trees[arch]
    for shape, axes in MESHES:
        jm = AbstractMesh(shape, axes)
        tm = Mesh(shape, axes, device="cpu")
        pairs = [
            (jrules.params_pspecs(jt["state"]["params"], jm),
             trules.params_pspecs(state["params"], tm)),
            (jrules.state_pspecs(jt["state"], jm), trules.state_pspecs(state, tm)),
            (jrules.cache_pspecs(jt["cache"], jm), trules.cache_pspecs(cache, tm)),
            (jrules.batch_pspecs(jt["batch"], jm), trules.batch_pspecs(batch, tm)),
        ]
        for jspec, tspec in pairs:
            want = {k: _jax_placements(v, axes) for k, v in _jax_paths(jspec).items()}
            assert tspec == want, (shape, sorted(set(tspec.items()) ^ set(want.items()))[:4])
        # each layer's tensor takes its stacked leaf's placements, L axis off
        per_layer = trules.param_placements(state["params"], tm)
        for name, p in state["params"].named_parameters():
            assert len(per_layer[name]) == len(axes)
            for pl in per_layer[name]:
                assert not pl.is_shard() or pl.dim < p.dim()


# ---------------------------------------------------------------------------
# (b) the expert shards against the JAX _moe_math
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["kimi_k2_1t_a32b", "dbrx_132b"])
@pytest.mark.parametrize("tp", [2, 4])
def test_moe_expert_shards_match_jax(arch, tp):
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import layers as JL

    from repro_torch.models import layers as TL

    cfg = get_config(arch, smoke=True)
    jcfg = jget(arch, smoke=True)
    E, D, Fd, N, cf = cfg.num_experts, cfg.d_model, cfg.d_ff, 128, 1.0
    rng = np.random.default_rng(7)
    xf = rng.standard_normal((N, D), dtype=np.float32)
    router = rng.standard_normal((D, E), dtype=np.float32)
    wg, wu = (rng.standard_normal((E, D, Fd), dtype=np.float32) / 8 for _ in range(2))
    wd = rng.standard_normal((E, Fd, D), dtype=np.float32) / 8
    t = torch.from_numpy
    *_, order, slot, starts, ends, C = TL._moe_route(t(xf), t(router), cfg, cf)
    assert int((ends - starts).max()) > C        # some assignments drop
    full, aux_full = TL._moe_math(t(xf), t(router), t(wg), t(wu), t(wd), cfg, cf)
    E_loc = E // tp
    total = torch.zeros_like(full)
    for r in range(tp):
        e0, sl = r * E_loc, slice(r * E_loc, (r + 1) * E_loc)
        out, aux = TL._moe_math(t(xf), t(router), t(wg[sl]), t(wu[sl]), t(wd[sl]),
                                cfg, cf, e0, E_loc)
        jout, jaux = JL._moe_math(jnp.asarray(xf), jnp.asarray(router),
                                  jnp.asarray(wg[sl]), jnp.asarray(wu[sl]),
                                  jnp.asarray(wd[sl]), jcfg, cf, e0, E_loc)
        jout = np.asarray(jout)
        scale = np.abs(jout).max()
        np.testing.assert_allclose(out.numpy(), jout, rtol=0, atol=1e-6 * scale)
        np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
        assert aux.item() == aux_full.item()
        total += out
    np.testing.assert_allclose(total.numpy(), full.numpy(), rtol=0,
                               atol=1e-6 * full.abs().max().item())


# ---------------------------------------------------------------------------
# (c) four gloo processes against one device
# ---------------------------------------------------------------------------

def _shard_mean_reference(cfg, steps: int, dp: int):
    """The one-device counterpart of a dp-sharded MoE train run: each
    microbatch's loss (rows i, i + A, ... of the batch, as the trainer
    takes them) is the mean over its dp shards of each shard's loss (its
    CE and its own aux), as the sharded run computes it; the gradients
    accumulate as the trainer's do."""
    from repro_torch.data import model_batch
    from repro_torch.models.layers import _DTYPES
    from repro_torch.optim import make_optimizer, make_schedule
    from repro_torch.train import init_train_state
    from repro_torch.train.step import make_loss_fn
    opt = make_optimizer(cfg.optimizer, make_schedule(
        "cosine", peak=3e-4, warmup=max(steps // 10, 1), total=steps))
    state = init_train_state(cfg, opt, seed=0, device="cpu")
    loss_fn, model = make_loss_fn(cfg), state["params"]
    A, acc_dt = cfg.microbatches, _DTYPES[cfg.accum_dtype]
    names, ps = zip(*model.named_parameters())
    losses = []
    for step in range(steps):
        batch = model_batch(cfg, B, S, seed=0, step=step)
        acc = [torch.zeros(p.shape, dtype=acc_dt) for p in ps]
        total = 0.0
        for i in range(A):
            mb = {k: v[i::A] for k, v in batch.items()}
            per = len(mb["tokens"]) // dp
            grads = None
            for d in range(dp):
                loss, _ = loss_fn(model, {k: v[d * per:(d + 1) * per]
                                          for k, v in mb.items()})
                g = torch.autograd.grad(loss / dp, ps, materialize_grads=True)
                grads = g if grads is None else [a + b for a, b in zip(grads, g)]
                total += float(loss) / dp / A
            for a, g in zip(acc, grads):
                a.add_(g.to(acc_dt) / A)
        model, state["opt"] = opt.update(dict(zip(names, acc)), state["opt"], model)
        state["opt"].pop("grad_norm"), state["opt"].pop("lr")
        losses.append(total)
    return model, losses


def sharded_worker(ctx) -> dict:
    """One process of the (c) cases: every architecture at every mesh, the
    one-device run made alongside in the same process."""
    from repro_torch import models
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.data import model_batch
    from repro_torch.launch import make_process_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.optim import make_optimizer, make_schedule
    from repro_torch.sharding import specs, use_mesh
    from repro_torch.sharding.runtime import full, local
    from repro_torch.train import init_train_state

    torch.manual_seed(0)
    out = {}

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    for arch in SHARDED_ARCHS:
        cfg = _config(arch)
        batch = model_batch(cfg, B, S, seed=0, step=0)
        ref = models.init_params(cfg, seed=0, device="cpu")
        logits, _ = models.forward(ref, batch, cfg)
        pl, cache = models.prefill(ref, batch, cfg, S + 2)
        tok = np.argmax(pl.numpy(), -1).astype(np.int32)
        dl, _ = models.decode_step(ref, cache, tok, cfg)
        ref_state, ref_hist = train_loop(cfg, steps=TRAIN_STEPS, batch_size=B,
                                         seq_len=S, device="cpu", log_every=99)
        ref_losses = [h["loss"] for h in ref_hist]
        for shape in SHARDED_MESHES:
            key = f"{arch}-{shape[0]}x{shape[1]}"
            mesh = make_process_mesh(shape, ("data", "model"), device="cpu")
            with use_mesh(mesh):
                model = models.init_params(cfg, seed=0, device="cpu")
                got, _ = models.forward(model, batch, cfg)
                spl, scache = models.prefill(model, batch, cfg, S + 2)
                sdl, _ = models.decode_step(model, scache, tok, cfg)
                got, spl, sdl = got.full_tensor(), spl.full_tensor(), sdl.full_tensor()
            want = specs.placed_bytes(model, specs.params_pspecs(model, mesh), mesh)
            held = sum(local(p).numel() * p.element_size() for p in model.parameters())
            state, hist = train_loop(cfg, steps=TRAIN_STEPS, batch_size=B,
                                     seq_len=S, mesh=mesh, log_every=99)
            base, base_losses = ref_state["params"], ref_losses
            if cfg.family == "moe" and shape[0] > 1:
                base, base_losses = _shard_mean_reference(cfg, TRAIN_STEPS, shape[0])
            perr = max(float((full(q).detach() - p.detach()).abs().max())
                       for (_, p), (_, q) in zip(base.named_parameters(),
                                                 state["params"].named_parameters()))
            out[key] = {"forward": rel(got, logits), "prefill": rel(spl, pl),
                        "decode": rel(sdl, dl), "param_err": perr,
                        "losses": [h["loss"] for h in hist],
                        "ref_losses": base_losses,
                        "bytes_held": held, "bytes_rules": want}
    cfg = _config("kimi_k2_1t_a32b", bf16_acc=True)
    _, hist = train_loop(cfg, steps=TRAIN_STEPS, batch_size=B, seq_len=S,
                         mesh=make_process_mesh((2, 2), ("data", "model"),
                                                device="cpu"), log_every=99)
    out[BF16_ACC] = {"losses": [h["loss"] for h in hist],
                     "ref_losses": _shard_mean_reference(cfg, TRAIN_STEPS, 2)[1]}
    # a checkpoint at (2, 2) restored onto (4, 1)
    cfg = get_config("qwen2_0_5b", smoke=True)
    opt = make_optimizer(cfg.optimizer, make_schedule("cosine", peak=3e-4,
                                                      warmup=1, total=2))
    ck = os.path.join(ctx.args["tmp"], "ckpt")
    st, _ = train_loop(cfg, steps=1, batch_size=B, seq_len=S, ckpt_dir=ck,
                       mesh=make_process_mesh((2, 2), ("data", "model"), device="cpu"),
                       log_every=99)
    saved = {n: full(p).detach().clone() for n, p in st["params"].named_parameters()}
    saved_mu = {k: full(v).clone() for k, v in st["opt"]["mu"].items()}
    with use_mesh(make_process_mesh((4, 1), ("data", "model"), device="cpu")):
        step, back = restore_checkpoint(ck, init_train_state(cfg, opt, seed=1,
                                                             device="cpu"))
        same = all(torch.equal(full(p).detach(), saved[n])
                   for n, p in back["params"].named_parameters())
        same_mu = all(torch.equal(full(v), saved_mu[k])
                      for k, v in back["opt"]["mu"].items())
        placed = {str(p.placements) for p in back["params"].parameters()}
    out["restore"] = {"step": step, "params_equal": same, "mu_equal": same_mu,
                      "placements": sorted(placed)}
    return out


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    from repro_torch.launch import run_scenario
    tmp = str(tmp_path_factory.mktemp("sharded"))
    verdicts = run_scenario(f"{os.path.abspath(__file__)}:sharded_worker", 4,
                            args={"tmp": tmp}, device="cpu", timeout=300)
    return verdicts


CASES = [f"{a}-{m[0]}x{m[1]}" for a in SHARDED_ARCHS for m in SHARDED_MESHES]


@pytest.mark.parametrize("case", CASES)
def test_sharded_forward_and_serving_match_one_device(case, sharded_runs):
    for v in sharded_runs:
        r = v[case]
        assert r["forward"] <= 1e-5, r
        assert r["prefill"] <= 1e-5 and r["decode"] <= 1e-5, r


@pytest.mark.parametrize("case", CASES)
def test_sharded_train_loop_matches_one_device(case, sharded_runs):
    for v in sharded_runs:
        r = v[case]
        assert r["param_err"] <= 1e-6, r
        np.testing.assert_allclose(r["losses"], r["ref_losses"], rtol=1e-5)
        assert r["losses"] == sharded_runs[0][case]["losses"]


def test_sharded_bf16_accumulator_losses(sharded_runs):
    for v in sharded_runs:
        np.testing.assert_allclose(v[BF16_ACC]["losses"], v[BF16_ACC]["ref_losses"],
                                   rtol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_sharded_params_hold_the_rules_shards(case, sharded_runs):
    sizes = [v[case]["bytes_held"] for v in sharded_runs]
    assert all(v[case]["bytes_held"] == v[case]["bytes_rules"] for v in sharded_runs)
    assert len(set(sizes)) == 1


def test_checkpoint_restores_onto_another_mesh(sharded_runs):
    for v in sharded_runs:
        r = v["restore"]
        assert r["step"] == 1 and r["params_equal"] and r["mu_equal"], r
        assert any("Shard(dim=0)" in p for p in r["placements"])


def test_train_loop_on_a_one_process_mesh_is_the_unsharded_run():
    """``train_loop(mesh=make_elastic_mesh())`` in one process: a (1, 1)
    mesh, bitwise the ``mesh=None`` run (nothing is placed or gathered)."""
    from repro_torch.launch import make_elastic_mesh
    from repro_torch.launch.train import train_loop
    cfg = get_config("qwen2_0_5b", smoke=True)
    mesh = make_elastic_mesh(device="cpu")
    assert tuple(mesh.shape.values()) == (1, 1)
    a, ha = train_loop(cfg, steps=2, batch_size=2, seq_len=8, device="cpu",
                       log_every=99)
    b, hb = train_loop(cfg, steps=2, batch_size=2, seq_len=8, mesh=mesh,
                       log_every=99)
    assert [h["loss"] for h in ha] == [h["loss"] for h in hb]
    for (_, p), (_, q) in zip(a["params"].named_parameters(),
                              b["params"].named_parameters()):
        assert torch.equal(p, q)


# ---------------------------------------------------------------------------
# (d) the dry-run CLI, (e) the meshes, on fake process groups
# ---------------------------------------------------------------------------

def _python(code: str, *args, timeout: float = 240) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, *args] if not code else
                          [sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=timeout)


def test_dryrun_cell(tmp_path):
    from repro_torch.launch import Mesh
    from repro_torch.launch.specs import params_specs
    from repro_torch.sharding import specs

    run = _python("", "-m", "repro_torch.launch.dryrun", "--arch", "qwen2_0_5b",
                  "--shape", "decode_32k", "--mesh", "single", "--device", "cpu",
                  "--out", str(tmp_path))
    assert run.returncode == 0, run.stderr[-3000:]
    rec = json.loads((tmp_path / "pod16x16" / "qwen2_0_5b__decode_32k.json").read_text())
    assert rec["chips"] == 256
    model = params_specs(get_config("qwen2_0_5b"))
    mesh = Mesh((16, 16), ("data", "model"), device="cpu")
    assert rec["memory_analysis"]["param_bytes"] == specs.placed_bytes(
        model, specs.params_pspecs(model, mesh), mesh)
    assert rec["cost_per_device"]["flops"] > 0
    assert rec["roofline_terms_s"]["memory_s"] > 0
    assert rec["collectives_per_device"]["count"] > 0
    hw = rec["hardware"]
    assert (hw["peak_flops_bf16"], hw["hbm_bytes_per_s"], hw["nvlink_bytes_per_s"]) \
        == (989e12, 3.35e12, 450e9)


MESH_CHECK = r"""
import json, sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import make_elastic_mesh, make_production_mesh
out = {}
for world in (512, 448, 7):
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    e = make_elastic_mesh(device="cpu")
    r = {"elastic": [list(e.shape.items()), e.device_mesh.shape,
                     list(e.device_mesh.mesh_dim_names)],
         "elastic8": list(make_elastic_mesh(8, list(range(world)), device="cpu").shape.values())}
    if world >= 256:
        p = make_production_mesh(device="cpu")
        r["single"] = [list(p.shape.items()), p.device_mesh.shape, p.coordinate]
    if world >= 512:
        p = make_production_mesh(multi_pod=True, device="cpu")
        r["multi"] = [list(p.shape.items()), p.device_mesh.shape, p.coordinate]
    out[world] = r
    dist.destroy_process_group()
print(json.dumps(out))
"""


def test_production_and_elastic_meshes():
    run = _python(MESH_CHECK)
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])

    def reference(n, mp=16):      # src/repro/launch/mesh.py:97-110
        mp = min(mp, n)
        while n % mp:
            mp -= 1
        return [n // mp, mp]
    for world in (512, 448, 7):
        r = got[str(world)]
        d, m = reference(world)
        assert r["elastic"] == [[["data", d], ["model", m]], [d, m], ["data", "model"]]
        assert r["elastic8"] == reference(world, 8)
    assert got["512"]["single"] == [[["data", 16], ["model", 16]], [16, 16], [0, 0]]
    assert got["448"]["single"] == got["512"]["single"]
    assert got["512"]["multi"] == [[["pod", 2], ["data", 16], ["model", 16]],
                                   [2, 16, 16], [0, 0, 0]]
    assert "multi" not in got["448"] and "single" not in got["7"]
