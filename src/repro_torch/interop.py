"""Carry state between the JAX package and the port.

The system has no model weights; what crosses over is state: points,
masks, running ``min_d2``, a round-1 center union and its ``valid`` mask,
cluster weights, a streaming sketch. Both directions go through numpy, so
neither package imports the other.
"""
from __future__ import annotations

import numpy as np
import torch

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.int32): torch.int32,
           np.dtype(np.bool_): torch.bool}


def state_from_jax(arrays: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """The JAX package's arrays, read out as numpy, as the port's tensors on
    ``device``. float32, int32 and bool map exactly; any other dtype
    raises rather than being converted silently."""
    out = {}
    for name, a in arrays.items():
        a = np.asarray(a)
        if a.dtype not in _DTYPES:
            raise TypeError(f"{name}: dtype {a.dtype} has no exact "
                            "counterpart (expected float32, int32 or bool)")
        out[name] = torch.from_numpy(np.array(a)).to(device)
    return out


def result_to_numpy(result):
    """A port result (a tensor, or a NamedTuple such as ``MRGResult`` with
    its cluster ``weights``, ``KZResult``, ``Coreset`` or ``EIMResult``) as
    numpy: tensors become arrays, a NamedTuple a dict of its fields, nested
    ones (``EIMResult.sample``) included; other values (``rounds``,
    ``coreset_size``, ``None``) pass through."""
    if isinstance(result, torch.Tensor):
        return result.detach().cpu().numpy()
    if isinstance(result, tuple) and hasattr(result, "_fields"):
        return {f: result_to_numpy(getattr(result, f)) for f in result._fields}
    return result


def stream_state_from_jax(state):
    """The JAX package's ``StreamState`` (host numpy already) as the
    port's, so that a sketch fed its first batches there goes on here.
    The centers are copied as float32; ``count``, ``r`` and ``k`` keep
    their values."""
    from repro_torch.core.streaming import StreamState
    centers = np.asarray(state.centers)
    if centers.dtype != np.float32:
        raise TypeError(f"centers: dtype {centers.dtype}, expected float32")
    return StreamState(np.array(centers), int(state.count), float(state.r),
                       int(state.k))
