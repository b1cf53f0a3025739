"""The port's checkpoint manager and fault-tolerant train loop
(``repro_torch.checkpoint``, ``repro_torch.launch.train``), on the CPU: the
cases of tests/test_checkpoint.py held against the port. Round trips and
resumes are bitwise."""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import token_batch
from repro_torch.launch import make_process_mesh
from repro_torch.launch.train import (RestartPolicy, StragglerWatchdog, main,
                                      train_loop)
from repro_torch.models import api
from repro_torch.optim import make_schedule


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 3), generator=g),
            "nested": {"b": torch.arange(5, dtype=torch.int32),
                       "c": torch.tensor(2.5),
                       "h": torch.randn((2, 7), generator=g).to(torch.bfloat16)},
            "list": [torch.randn((3,), generator=g), np.arange(4, dtype=np.int64)],
            "step": 7, "lr": 3e-4}


def _leaves(tree):
    from repro_torch.checkpoint.manager import _walk
    return list(_walk(tree))


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                                b.view(torch.int16) if b.dtype == torch.bfloat16 else b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


def test_roundtrip_bitwise(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 7, t)
    assert latest_step(str(tmp_path)) == 7
    step, got = restore_checkpoint(str(tmp_path), _tree(seed=1))
    assert step == 7
    for (na, a), (nb, b) in zip(_leaves(t), _leaves(got)):
        assert na == nb and _equal(a, b), na


def test_roundtrip_model_in_place(tmp_path):
    """A bf16 model in the tree: restored into the template's module, in
    place, bitwise; the template's other tensors come back on their
    template tensors' device."""
    cfg = get_config("qwen2_0_5b", smoke=True).replace(param_dtype="bfloat16")
    model = api.init_params(cfg, seed=0, device="cpu")
    save_checkpoint(str(tmp_path), 3, {"params": model, "m": torch.ones(2)})
    other = api.init_params(cfg, seed=1, device="cpu")
    ptr = other.embed.data_ptr()
    step, got = restore_checkpoint(str(tmp_path), {"params": other,
                                                   "m": torch.zeros(2)})
    assert step == 3 and got["params"] is other and other.embed.data_ptr() == ptr
    assert other.embed.dtype == torch.bfloat16
    want = model.state_dict()
    for name, t in other.state_dict().items():
        assert _equal(t, want[name]), name
    assert torch.equal(got["m"], torch.ones(2)) and got["m"].device.type == "cpu"


def test_retention_prunes_old(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), s, t, keep=2)
    files = [f for f in os.listdir(tmp_path) if f.startswith("ckpt_")]
    assert len(files) == 2
    assert latest_step(str(tmp_path)) == 5


def test_no_tmp_litter(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_structure_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    with pytest.raises(ValueError, match="mismatch"):
        restore_checkpoint(str(tmp_path), {"different": torch.zeros(2)})


def test_missing_checkpoint_raises(tmp_path):
    assert latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), _tree())


def test_data_pipeline_resume_exactness():
    # batch at step s is identical regardless of history
    a = token_batch(100, 4, 8, seed=3, step=17)
    b = token_batch(100, 4, 8, seed=3, step=17)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = token_batch(100, 4, 8, seed=3, step=18)
    assert not np.array_equal(a["tokens"], c["tokens"])


def _same_state(a, b):
    for (na, x), (nb, y) in zip(_leaves(a), _leaves(b)):
        assert na == nb and _equal(x, y), na


def test_train_restart_from_fault_is_exact(tmp_path):
    """Inject a fault mid-run; the loop resumes from the step-5
    checkpoint, replays steps 5 and 6, and ends bitwise where an
    uninterrupted run does (params, moments, steps)."""
    cfg = get_config("olmo_1b", smoke=True)
    boom = {"armed": True}

    def fault(step):
        if step == 7 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected device failure")

    kw = dict(steps=10, batch_size=4, seq_len=16, log_every=100, device="cpu")
    state, hist = train_loop(
        cfg, ckpt_dir=str(tmp_path), ckpt_every=5, resume="auto",
        fault_hook=fault, policy=RestartPolicy(max_restarts=2, backoff_s=0.01),
        **kw)
    steps_seen = [h["step"] for h in hist]
    assert steps_seen[-1] == 9
    assert steps_seen.count(5) == 2 and steps_seen.count(6) == 2  # replayed
    assert latest_step(str(tmp_path)) == 10
    clean, clean_hist = train_loop(cfg, **kw)
    _same_state(state, clean)
    assert [h["loss"] for h in hist[-3:]] == [h["loss"] for h in clean_hist[-3:]]


def test_restart_policy_gives_up():
    cfg = get_config("olmo_1b", smoke=True)

    def always_fail(step):
        raise RuntimeError("permanent failure")

    with pytest.raises(RuntimeError, match="permanent"):
        train_loop(cfg, steps=5, batch_size=2, seq_len=8,
                   fault_hook=always_fail,
                   policy=RestartPolicy(max_restarts=2, backoff_s=0.0),
                   log_every=100, device="cpu")


def test_straggler_watchdog_flags_outliers():
    w = StragglerWatchdog(factor=3.0, warmup=2)
    for _ in range(6):
        w.observe(0.1)
    assert w.observe(1.0) is True
    assert w.flagged == 1


def test_train_loop_raises_without_cuda_and_for_a_mesh(monkeypatch):
    cfg = get_config("olmo_1b", smoke=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_loop(cfg, steps=1, batch_size=2, seq_len=8)
    # a mesh of more positions than there are processes (one, here)
    with pytest.raises(ValueError, match="need 2 processes"):
        main(["--arch", "olmo_1b", "--smoke", "--mesh", "2x1", "--device", "cpu"])
    with pytest.raises(ValueError, match="need 4 processes"):
        train_loop(cfg, steps=1, batch_size=2, seq_len=8, device="cpu",
                   mesh=make_process_mesh((2, 2), ("data", "model"),
                                          device="cpu"))


def test_main_trains_a_smoke_config(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` for 3 steps on the CPU, with
    checkpoints, metrics and a held-out evaluation; then resumed to 4."""
    metrics = tmp_path / "m.jsonl"
    args = ["--arch", "qwen2_0_5b", "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2",
            "--metrics", str(metrics), "--eval-every", "2", "--device", "cpu"]
    main(args)
    out = capsys.readouterr().out
    assert "[train] done:" in out and "(3 steps)" in out and "[eval] step=2" in out
    assert latest_step(str(tmp_path / "ck")) == 3
    lines = metrics.read_text().splitlines()
    assert len(lines) == 4      # 3 steps + one evaluation
    main(args[:4] + ["4"] + args[5:] + ["--resume", "must"])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "(1 steps)" in out


def test_main_trains_minicpm_on_its_wsd_schedule(tmp_path):
    """``main`` takes the arch's schedule from its config module: minicpm's
    logged learning rates are WSD's, which part from the cosine's."""
    metrics = tmp_path / "m.jsonl"
    main(["--arch", "minicpm_2b", "--smoke", "--steps", "10", "--batch", "2",
          "--seq", "8", "--lr", "1e-3", "--metrics", str(metrics),
          "--device", "cpu"])
    lrs = [json.loads(line)["lr"] for line in metrics.read_text().splitlines()]
    kw = dict(peak=1e-3, warmup=1, total=10)
    wsd, cos = make_schedule("wsd", **kw), make_schedule("cosine", **kw)
    assert lrs == [float(wsd(s + 1)) for s in range(10)]
    assert lrs != [float(cos(s + 1)) for s in range(10)]
