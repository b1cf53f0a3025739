"""GON step kernel (CUDA C++, ``csrc/gon_step.cu``) and its plain version.

Replaces the TPU kernel ``src/repro/kernels/fused_argfar.py``
``fused_min_argmax_blocks``: distance of every row to the new center,
running-min update and farthest row, fused into one pass over the points.
Here the pass is batched over a leading axis of m machine blocks, which the
JAX package maps with ``jax.vmap`` and a hand-written kernel cannot.

Bound on the card: bytes (x read once, md read and written once). One
launch is one whole GON iteration: persistent CTAs stage contiguous row
tiles in shared memory with asynchronous copies, and the CTA that finishes
a machine last merges its partials and writes the next center (and the
streamed pass's carry) on the card; the source says how. Unlike the JAX
kernel it updates ``md`` in place.

A GON run makes one ``GonWorkspace`` (the per-CTA partials, the arrival
counters and the far outputs) and passes it to every step, so a step
allocates nothing. The launch shape comes from ``gon_plan``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .ref import fused_min_argmax as fused_min_argmax_ref  # noqa: F401

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

GON_STAGES = 3                 # csrc/gon_step.cu kStages
GON_STAGE_BYTES = 36 * 1024    # x bytes of a ring stage
GON_MAX_TILE_ROWS = 1024
MAX_CTAS_PER_SM = 4            # the workspace's partial slots allow 4·SMs CTAs


class GonArgs(ctypes.Structure):
    """``csrc/gon_step.cu``'s ``GonArgs``, field for field."""
    _fields_ = [(name, _P) for name in (
        "x", "c", "md", "part_v", "part_i", "counter", "far_v", "far_i",
        "centers", "indices", "carry_v", "carry_i", "carry_row")] + [
        ("c_stride", _L), ("off", _L)] + [(name, _I) for name in (
            "m", "per", "d", "k", "slot", "reset", "tile_rows", "ntiles",
            "grid", "x_stage", "md_stage", "c_floats", "smem")]


class GonPlan(NamedTuple):
    tile_rows: int   # rows of a tile (a ring stage)
    ntiles: int      # tiles of a machine
    grid: int        # persistent CTAs
    x_stage: int     # floats of a stage's x part (a tile and 3 of slack)
    md_stage: int    # floats of a stage's md part
    c_floats: int    # floats of the staged center
    smem: int        # dynamic shared bytes


def _round4(n: int) -> int:
    return -(-n // 4) * 4


@functools.lru_cache(maxsize=1024)
def gon_plan(m: int, per: int, d: int, sms: int) -> GonPlan:
    """Launch shape of one GON step on ``sms`` SMs: tiles of up to 1,024
    rows and 36 KB of x, a 3-stage ring (each part with room for a
    misaligned start), as many persistent CTAs as the SMs hold (up to 4
    a SM) and at least one tile each; where m is at most the CTA count,
    the same number of CTAs for every machine. Raises where one row's
    stage does not fit a block's shared memory."""
    tile = max(1, min(GON_MAX_TILE_ROWS, GON_STAGE_BYTES // (4 * (d + 1))))
    ntiles = -(-per // tile)
    x_stage, md_stage, c_floats = _round4(tile * d + 3), _round4(tile + 3), _round4(d)
    smem = 4 * (c_floats + GON_STAGES * (x_stage + md_stage))
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"d={d} is too wide for the GON kernel's ring "
                         f"({smem} bytes of shared memory)")
    # as many CTAs a SM as its shared memory holds (1 KB reserved a CTA, and
    # the kernel's static shared memory), up to 4: 4 at d <= 3, 3 at d = 4
    # and 5, 2 from d = 6 on
    ctas = max(1, min(MAX_CTAS_PER_SM, _build.SMEM_PER_SM // (smem + 1024 + 512))) * sms
    if m <= ctas:     # as many CTAs for every machine: no range crosses one
        grid = m * min(ntiles, ctas // m)
    else:
        grid = min(m * ntiles, ctas)
    return GonPlan(tile, ntiles, grid, x_stage, md_stage, c_floats, smem)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.library("gon_step")
    lib.repro_gon_step.argtypes = [ctypes.POINTER(GonArgs), _I, _P]
    lib.repro_gon_step.restype = _I
    lib.repro_gon_args_size.restype = _I
    lib.repro_gon_ctas_per_sm.argtypes = [_I, _I]
    lib.repro_gon_ctas_per_sm.restype = _I
    if lib.repro_gon_args_size() != ctypes.sizeof(GonArgs):
        raise RuntimeError("csrc/gon_step.cu's GonArgs disagrees with "
                           "fused_argfar.GonArgs")
    return lib


def ctas_per_sm(d: int, smem: int) -> int:
    """CTAs of the GON kernel that one SM of the current device holds at
    width ``d`` and ``smem`` dynamic bytes (what ``gon_plan`` counts on
    from the shared memory alone)."""
    ctas = _lib().repro_gon_ctas_per_sm(d, smem)
    if ctas < 0:
        _build.check(_lib(), -ctas, "gon_step occupancy")
    return ctas


class GonWorkspace:
    """Scratch of one GON run of ``m`` machines on one CUDA device, made
    once and passed to every step: the per-CTA partials (a launch has at
    most ``4·SMs`` CTAs, which take ``grid + m - 1`` slots), the per-machine
    arrival counters (zero between launches: the last CTA of a machine
    resets its own) and the far outputs ``far_v (m,) f32``, ``far_i (m,)
    int32``, overwritten by each step. One buffer, zeroed once.

    Never share a workspace between runs that may overlap (two streams):
    their CTAs would count into the same counters."""

    def __init__(self, m: int, device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a GonWorkspace lives on a CUDA device, got {device}")
        self.m, self.device = m, device
        self.sms = _build.sm_count(device.index)
        slots = MAX_CTAS_PER_SM * self.sms + m
        buf = torch.zeros((2 * slots + 3 * m,), dtype=torch.int32, device=device)
        self.part_v = buf[:slots].view(torch.float32)
        self.part_i = buf[slots:2 * slots]
        self.counter = buf[2 * slots:2 * slots + m]
        self.far_v = buf[2 * slots + m:2 * slots + 2 * m].view(torch.float32)
        self.far_i = buf[2 * slots + 2 * m:]
        self.args = GonArgs(
            part_v=self.part_v.data_ptr(), part_i=self.part_i.data_ptr(),
            counter=self.counter.data_ptr(), far_v=self.far_v.data_ptr(),
            far_i=self.far_i.data_ptr())
        # what the last step set in args: its shape, tensors and carry
        self.shape = self.x = self.md = None
        self.centers = self.indices = self.carry = None


def _require(t: torch.Tensor, name: str, shape, dtype, contiguous=True):
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or (contiguous and not t.is_contiguous())):
        raise ValueError(f"{name} must be {'contiguous ' if contiguous else ''}"
                         f"{dtype} {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}, contiguous={t.is_contiguous()}")


def fused_min_argmax_cuda(x: torch.Tensor, c: torch.Tensor, md: torch.Tensor,
                          *, ws: GonWorkspace | None = None, centers=None,
                          indices=None, slot: int = -1, carry=None,
                          off: int = 0, reset: bool = False):
    """Launch the GON-step kernel: same contract as ``fused_min_argmax_ref``.

    ``x (m, per, d)`` and ``md (m, per)`` are contiguous float32 tensors on
    one Hopper device; ``c (m, d)`` float32 with unit column stride (a
    ``centers[:, i]`` view serves). ``md`` is updated in place and returned
    with ``far_val (m,) f32`` and ``far_idx (m,) int32``, the buffers of
    ``ws`` (made for this call when ``None``), which the next step on it
    overwrites. ``centers (m, k, d)`` f32 and ``indices (m, k)`` int32, both
    contiguous, get the far row and index in ``slot`` when ``0 <= slot <
    k``; ``carry = (best_v (m,) f32, best_i (m,) int64, best_row (m, d)
    f32)`` folds the far point at global row ``off + far_idx`` in place
    (unconditionally when ``reset``), and the slot then gets the carry's.
    """
    dev = _build.require_hopper(x, c, md)
    if x.dim() != 3:
        raise ValueError(f"x must be (m, per, d), got shape {tuple(x.shape)}")
    m, per, d = x.shape
    if ws is None:
        ws = GonWorkspace(m, dev)
    elif ws.m != m or ws.device != dev:
        raise ValueError(f"workspace for m={ws.m} on {ws.device}, "
                         f"not m={m} on {dev}")
    a = ws.args
    # a run passes the same points, distances, outputs and carry to every
    # step, with a new center view: check and set each of the others once
    if x is not ws.x or md is not ws.md:
        _require(x, "x", (m, per, d), torch.float32)
        _require(md, "md", (m, per), torch.float32)
        if not (1 <= per < 2**31 - 2**12 and d >= 1):
            raise ValueError(f"unsupported sizes m={m}, per={per}, d={d}")
        if (per, d) != ws.shape:      # the plan changes with the shape alone
            (a.tile_rows, a.ntiles, a.grid, a.x_stage, a.md_stage, a.c_floats,
             a.smem) = gon_plan(m, per, d, ws.sms)
            a.m, a.per, a.d = m, per, d
            ws.shape = (per, d)
        a.x, a.md = x.data_ptr(), md.data_ptr()
        ws.x, ws.md = x, md
    _require(c, "c", (m, d), torch.float32, contiguous=False)
    if c.stride(1) != 1 and d > 1:
        raise ValueError("c must have unit column stride")
    a.c, a.c_stride, a.off = c.data_ptr(), c.stride(0), off
    if centers is not ws.centers or indices is not ws.indices:
        if centers is None:
            a.centers = a.indices = None
            a.k = 0
        else:
            k = centers.shape[1] if centers.dim() == 3 else -1
            _require(centers, "centers", (m, k, d), torch.float32)
            _require(indices, "indices", (m, k), torch.int32)
            a.centers, a.indices, a.k = centers.data_ptr(), indices.data_ptr(), k
        ws.centers, ws.indices = centers, indices
    a.slot = -1 if centers is None else slot
    if carry is not ws.carry:
        if carry is None:
            a.carry_v = a.carry_i = a.carry_row = None
        else:
            best_v, best_i, best_row = carry
            _require(best_v, "carry value", (m,), torch.float32)
            _require(best_i, "carry index", (m,), torch.int64)
            _require(best_row, "carry row", (m, d), torch.float32)
            a.carry_v, a.carry_i, a.carry_row = (
                best_v.data_ptr(), best_i.data_ptr(), best_row.data_ptr())
        ws.carry = carry
    a.reset = int(reset)
    lib = _lib()
    code = lib.repro_gon_step(ctypes.byref(a), dev.index,
                              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "gon_step")
    _build.count_launch(fused_min_argmax_cuda)
    return md, ws.far_v, ws.far_i


fused_min_argmax_cuda.launches = 0
