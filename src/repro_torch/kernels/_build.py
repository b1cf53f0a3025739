"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles at first use, with ``nvcc -gencode
arch=compute_90a,code=sm_90a``, into a shared library with a plain C
interface under ``build/repro_torch_kernels/`` at the root of the checkout,
and loads through ``ctypes``. A library's file name carries a hash of its
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header rebuilds and a stale build is never loaded. ``build()`` starts one ``nvcc`` per source, all at once, so the
sources compile in parallel.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("gon_step", "assign", "fused_filter", "argmin_rows", "pairwise")
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``. Raises if none has it."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(DEFAULT_NVCC)
    for cand in candidates:
        if cand.is_file() and os.access(cand, os.X_OK):
            return str(cand)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin):"
        " the CUDA kernels of repro_torch cannot be built")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    digest = hashlib.sha256()
    digest.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Build every library of ``names`` that is not built yet, one ``nvcc``
    per source, all started together. Returns ``{name: ptxas report}`` for
    the sources compiled by this call (the report names each kernel's
    registers and shared memory). Raises on the first failed build."""
    todo = [name for name in names if not library_path(name).exists()]
    if not todo:
        return {}
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = {}
    for name in todo:
        target = library_path(name)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending[name] = (proc, tmp, target)
    reports, failed = {}, []
    for name, (proc, tmp, target) in pending.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, target)
        reports[name] = out
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


# First uses from several threads (the online service's ingest and dispatch
# threads) build one after another: a build's temporary file is named by
# the process alone.
_build_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _build_lock:
        build((name,))
    lib = ctypes.CDLL(str(library_path(name)))
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, the launch count of a kernel's
    wrapper, under a lock, so the count is exact when several threads
    launch (the online service's two)."""
    with _count_lock:
        wrapper.launches += 1


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")


# Dynamic shared memory a block may use on Hopper (cudaFuncSetAttribute),
# the bound of the kernels' launch plans, and the shared memory of an SM
# (228 KB), which the CTAs resident on it share (1 KB reserved a CTA).
SMEM_LIMIT = 232_448
SMEM_PER_SM = 233_472


@functools.lru_cache(maxsize=None)
def _capability(index: int) -> tuple[int, int]:
    return torch.cuda.get_device_capability(index)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def require_hopper(*tensors: torch.Tensor) -> torch.device:
    """The kernels' capability check: every tensor lies on one CUDA device of
    compute capability 9.x. Returns that device; raises otherwise."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(
            f"the CUDA kernel route needs CUDA tensors, got a {dev.type} "
            "tensor (use impl='ref' or 'auto' for the plain version)")
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    major, minor = _capability(dev.index)
    if major != 9:
        raise RuntimeError(
            f"the repro_torch kernels are built for sm_90a (Hopper); {dev} "
            f"has compute capability {major}.{minor}")
    return dev
