"""Production-mesh dry-run: run every (architecture × shape × mesh) cell's
step on abstract tensors and reckon its per-device memory, FLOPs,
collectives and roofline terms (port of ``repro.launch.dryrun``).

Nothing is allocated and no card is needed. One process joins a fake
process group of 512 ranks (``torch.testing._internal.distributed.
fake_pg``: collectives return at once) as rank 0, builds the production
mesh over it, and runs the cell's step (train step, prefill or one decode
step) under ``FakeTensorMode``: every tensor has a shape, a dtype and a
device and no data. What rank 0 does is what every device does, so the
counts are per device:

  * memory — the bytes of the local shards of the step's inputs
    (parameters, optimizer state, cache, batch: ``argument_size_in_bytes``)
    and the peak of everything live during the step, from
    ``torch.distributed._tools.mem_tracker.MemTracker`` (``peak_bytes``;
    ``temp_size_in_bytes`` is the peak beyond the inputs);
  * FLOPs — ``torch.utils.flop_counter.FlopCounterMode``;
  * bytes accessed — every operator's inputs and outputs, views excluded
    (the counterpart of XLA's "bytes accessed");
  * collectives — ``torch.distributed.tensor.debug.CommDebugMode`` counts
    them; their operand bytes are summed here (all-gather: the input
    shard; reduce-scatter and all-reduce: the input).

The roofline terms divide those by the H100 SXM's rates (NVIDIA H100
Tensor Core GPU data sheet): 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, and
NVLink 4's 900 GB/s per GPU, 450 GB/s each way. The fake tensors live on
``--device``: ``cuda`` (the default where PyTorch has CUDA; no card is
touched) takes the card's code paths, bf16 products into f32 on cuBLAS;
``cpu`` (the default elsewhere) takes the CPU's, which upcasts a bf16
product's operands to f32 first, so its bytes and peak count those
copies too. The record names the device.

Results land in ``<out>/<mesh>/<arch>__<shape>.json`` (``--out``, default
``dryrun_out/``, which git ignores):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_0_5b \\
      --shape decode_32k --mesh single
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import time
import traceback

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable

# --- H100 SXM constants (roofline denominators), NVIDIA H100 Tensor Core
# GPU data sheet, SXM5 column ------------------------------------------------
PEAK_FLOPS = 989e12        # bf16 dense Tensor Core FLOP/s per GPU
HBM_BW = 3.35e12           # HBM3 bytes/s per GPU
NVLINK_BW = 450e9          # NVLink 4: 900 GB/s per GPU, 450 GB/s each way
HARDWARE = {"name": "NVIDIA H100 SXM5 80GB", "peak_flops_bf16": PEAK_FLOPS,
            "hbm_bytes_per_s": HBM_BW, "nvlink_bytes_per_s": NVLINK_BW,
            "source": "NVIDIA H100 Tensor Core GPU data sheet (SXM5)"}
WORLD = 512                # fake ranks: room for the two-pod mesh

_COLLECTIVES = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all"}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _tree_bytes(tree) -> int:
    """Bytes of the local tensors of a tree (a DTensor counts its shard)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, torch.nn.Module):
        return sum(_tree_bytes(p) for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, DTensor):
        return _nbytes(tree.to_local())
    return _nbytes(tree)


class Traffic(TorchDispatchMode):
    """Bytes every operator reads and writes (views and collectives
    excluded), and every collective's operand bytes by kind."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns in ("_c10d_functional", "c10d_functional") and name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            d = self.ops.setdefault(kind, {"count": 0, "operand_bytes": 0})
            d["count"] += 1
            d["operand_bytes"] += _nbytes(args[0])
            return out
        if ns == "aten" and not func.is_view:
            flat = torch.utils._pytree.tree_leaves((args, kwargs, out))
            self.bytes += sum(_nbytes(t) for t in flat)
        return out


def _product_flops(a_shape, b_shape, *_, out_shape=None, **__) -> int:
    """2·m·n·k a product (each batch's, for ``bmm``), for every overload of
    ``mm`` and ``bmm``: the counter's own formulas take the ``out_dtype``
    of a low-precision product into f32 (the card's path) for the
    output's shape, and fail."""
    batch = a_shape[0] if len(a_shape) == 3 else 1
    return 2 * batch * a_shape[-2] * a_shape[-1] * b_shape[-1]


def fake_world(world: int = WORLD) -> None:
    """Join a fake process group of ``world`` ranks as rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)


def fake_mesh(shape, axes, device: str = "cpu"):
    """A mesh of one fake rank a position (rank 0 at the origin), its
    ``DeviceMesh`` of ``device``'s type (the type DTensor's collectives
    put their outputs on)."""
    from repro_torch.launch.mesh import Mesh
    return Mesh(shape, axes, device=device,
                owners=np.arange(int(np.prod(shape))).reshape(shape))


def _placed_model(cfg, mesh, device):
    from repro_torch.launch.specs import params_specs
    from repro_torch.sharding.runtime import placing
    with placing(lambda: params_specs(cfg), mesh):
        return params_specs(cfg, device)


@contextlib.contextmanager
def _fake_tables():
    """The tables the layers keep a device (rotary and sinusoid
    frequencies) made afresh in this fake mode (another cell's belong to
    another), as fake tensors of their shape: a fake mode cannot pin the
    host memory their upload goes through, and needs no values."""
    from repro_torch.models import layers
    pinned = layers.upload
    layers.upload = lambda a, device: torch.empty(
        a.shape, dtype=torch.from_numpy(np.asarray(a[:0])).dtype, device=device)
    layers._rope_freqs.cache_clear()
    layers._sinusoid_div.cache_clear()
    try:
        yield
    finally:
        layers.upload = pinned
        layers._rope_freqs.cache_clear()
        layers._sinusoid_div.cache_clear()


def model_flops(cfg, shape) -> float:
    n_active = cfg.param_counts()["active"]
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: 1 token/seq


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str,
             device: str = "cuda", microbatches: int = 0) -> dict:
    """One cell's record (per device: rank 0 of the fake group)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.specs import cache_specs, make_opt
    from repro_torch.models import api
    from repro_torch.sharding import use_mesh
    from repro_torch.sharding import runtime as sr
    from repro_torch.sharding.specs import state_pspecs
    from repro_torch.train import make_train_step

    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    dev = torch.device(device)
    B, S = shape.global_batch, shape.seq_len
    t0 = time.time()
    mesh.device_mesh            # built outside the fake mode: its ranks are data
    with FakeTensorMode(), use_mesh(mesh), _fake_tables():
        model = _placed_model(cfg, mesh, dev)

        def tokens(b, s):
            return torch.zeros((b, s), dtype=torch.int32, device=dev)

        def embeds(b, s):
            return torch.zeros((b, s, cfg.d_model), dtype=torch.float32,
                               device=dev)
        batch = {"tokens": tokens(B, S)}
        if cfg.family == "encdec":
            batch["frames"] = embeds(B, cfg.enc_seq)
        if cfg.family == "vlm":
            batch["patch_embeds"] = embeds(B, cfg.num_patches)
        if shape.kind == "train":
            opt = make_opt(cfg)
            model.requires_grad_(True)
            ostate = opt.init(model)
            ostate = sr.place_tree(ostate, state_pspecs({"opt": ostate}, mesh),
                                   mesh, prefix="opt/")
            state = {"params": model, "opt": ostate, "step": 0}
            batch["labels"] = tokens(B, S)
            step_fn = make_train_step(cfg, opt, num_microbatches=microbatches)
            args = (state, batch)
            inputs = _tree_bytes(model) + _tree_bytes(ostate)

            def run():
                return step_fn(*args)
        elif shape.kind == "prefill":
            inputs = _tree_bytes(model)

            def run():
                return api.prefill(model, batch, cfg, S)
        else:
            rows = sr.dp_rows(B)
            b_loc = B if rows is None else rows[1] - rows[0]
            cache = {k: torch.empty_like(v, device=dev)
                     for k, v in cache_specs(cfg, b_loc, S).items()}
            token = tokens(B, 1)
            inputs = _tree_bytes(model) + _tree_bytes(cache)

            def run():
                return api.decode_step(model, cache, token, cfg)
        param_bytes = _tree_bytes(model)
        inputs += _tree_bytes(sr.local_batch(batch))
        mt = MemTracker()
        mt.track_external(model)
        traffic = Traffic()
        flops = FlopCounterMode(display=False, custom_mapping={
            torch.ops.aten.mm: _product_flops,
            torch.ops.aten.bmm: _product_flops})
        with mt, CommDebugMode() as comm, flops as fc, traffic:
            run()
        peak = sum(d.get("Total", 0) for d in
                   mt.get_tracker_snapshot("peak").values())
        flops_dev = float(fc.get_total_flops())
        comm_count = int(comm.get_total_counts())
    t_run = time.time() - t0

    coll_bytes = float(sum(d["operand_bytes"] for d in traffic.ops.values()))
    bytes_dev = float(traffic.bytes)
    terms = {"compute_s": flops_dev / PEAK_FLOPS,
             "memory_s": bytes_dev / HBM_BW,
             "collective_s": coll_bytes / NVLINK_BW}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    n_chips = mesh.size
    useful = mf / (flops_dev * n_chips) if flops_dev else 0.0
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "chips": n_chips, "device": device, "run_s": round(t_run, 2),
        "memory_analysis": {
            "argument_size_in_bytes": int(inputs),
            "param_bytes": int(param_bytes),
            "peak_bytes": int(peak),
            "temp_size_in_bytes": int(max(peak - inputs, 0)),
        },
        "cost_per_device": {"flops": flops_dev, "bytes": bytes_dev},
        "collectives_per_device": {"operand_bytes": coll_bytes,
                                   "count": comm_count, "ops": traffic.ops},
        "roofline_terms_s": terms,
        "dominant": dominant,
        "model_flops_global": mf,
        "useful_flops_fraction": useful,
        "bytes_global": bytes_dev * n_chips,
        "flops_global": flops_dev * n_chips,
        "collective_bytes_global": coll_bytes * n_chips,
        "hardware": HARDWARE,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--grid", default=None,
                    help="DxM: a (data, model) mesh of that shape in place of "
                         "the production meshes (e.g. 4x1 for four cards)")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="a train cell's microbatches (default: the config's)")
    ap.add_argument("--out", default="dryrun_out")
    ap.add_argument("--device", default=None,
                    help="the fake tensors' device: cuda (default where "
                         "PyTorch has CUDA; no card is touched) or cpu")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = [("pod16x16", (16, 16), ("data", "model")),
              ("pod2x16x16", (2, 16, 16), ("pod", "data", "model"))]
    meshes = {"single": meshes[:1], "multi": meshes[1:], "both": meshes}[args.mesh]
    if args.grid:
        d, m = (int(v) for v in args.grid.split("x"))
        meshes = [(f"grid{d}x{m}", (d, m), ("data", "model"))]

    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    fake_world()
    failures = []
    for mesh_name, shape, axes in meshes:
        mesh = fake_mesh(shape, axes, device)
        outdir = os.path.join(args.out, mesh_name)
        os.makedirs(outdir, exist_ok=True)
        for arch in archs:
            for shape_name in shapes:
                if not shape_applicable(arch, shape_name):
                    continue
                path = os.path.join(outdir, f"{arch}__{shape_name}.json")
                if os.path.exists(path) and not args.force:
                    print(f"[skip cached] {mesh_name} {arch} {shape_name}")
                    continue
                print(f"[cell] {mesh_name} {arch} {shape_name} ...", flush=True)
                try:
                    rec = run_cell(arch, shape_name, mesh, mesh_name, device,
                                   args.microbatches)
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    t = rec["roofline_terms_s"]
                    print(f"  ok run={rec['run_s']}s dom={rec['dominant']} "
                          f"comp={t['compute_s']:.3e} mem={t['memory_s']:.3e} "
                          f"coll={t['collective_s']:.3e} "
                          f"peak={rec['memory_analysis']['peak_bytes'] / 2**30:.2f}GiB",
                          flush=True)
                except Exception as e:  # noqa: BLE001
                    failures.append((mesh_name, arch, shape_name, repr(e)))
                    print(f"  FAIL {e!r}", flush=True)
                    traceback.print_exc()
                gc.collect()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", *f)
        raise SystemExit(1)
    print("\nall requested cells ran OK")


if __name__ == "__main__":
    main()
