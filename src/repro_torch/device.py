"""Where the port's tensors live.

Entry points take ``device=None``, which means ``"cuda"``: the port runs on
the card unless the caller asks for the CPU, and it raises, rather than
carrying on on the CPU, where no CUDA device exists.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises if the device asked for is CUDA and
    PyTorch sees no CUDA device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and PyTorch sees "
            "none here; pass device='cpu' to run the plain versions")
    return dev


def as_points(points, device: torch.device) -> torch.Tensor:
    """``points`` (a numpy array, a tensor or a point source) as a
    contiguous float32 tensor on ``device``. The port holds points as
    float32, the kernels' type. A point source is materialized whole, for
    consumers that need random access (``SimExecutor``)."""
    from repro_torch.data.source import is_source  # the data layer imports this module
    if is_source(points):
        points = points.materialize(device)
    elif isinstance(points, np.ndarray):
        points = torch.from_numpy(np.array(points, np.float32))  # a copy
    elif not isinstance(points, torch.Tensor):
        raise TypeError(
            f"points must be a numpy array, a torch.Tensor or a point "
            f"source, got {type(points).__name__}")
    return points.to(device=device, dtype=torch.float32).contiguous()


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``. To a CUDA device it goes
    through pinned memory with ``non_blocking=True``, so the copy is queued
    on the current stream and the host does not wait for it (a pageable
    copy would be a synchronising call); the pinned buffer is held by
    PyTorch's host allocator until the copy is done."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.clone().to(device)
    return t.pin_memory().to(device, non_blocking=True)
