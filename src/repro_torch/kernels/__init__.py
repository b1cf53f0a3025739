"""Hand-written Hopper kernels for the k-center hot spots, with their plain
PyTorch versions.

Modules:
  fused_argfar.py — GON step: dist + running min + arg-farthest and the
                    next center, batched over machines (csrc/gon_step.cu)
  assign.py       — nearest-center assignment, 2-D and batched over
                    machines (csrc/assign.cu)
  fused_stream.py — the streamed folds' kernels: the filter and its
                    weighted entry (csrc/fused_filter.cu), the streamed
                    assign, the per-center argmin (csrc/argmin_rows.cu)
  pairwise.py     — the full pairwise distance matrix (csrc/pairwise.cu)
  _build.py       — builds csrc/*.cu with nvcc at first use, loads by ctypes
  engine.py       — impl dispatch: kernel on CUDA, plain version on CPU
  ops.py          — public API façade over the engine
  ref.py          — the plain PyTorch versions (semantics contract)

Importing this package builds nothing and needs no GPU.
"""
from . import engine, ops, ref  # noqa: F401
