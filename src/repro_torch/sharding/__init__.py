"""Sharding of the LM over a mesh (port of ``repro.sharding``).

  api.py     — the installed mesh (``use_mesh``, ``current_mesh``), logical
               specs resolved to DTensor placements (``spec``), and the
               model's ``constrain``/``constrain_seq``
  specs.py   — the placement rules for parameters, optimizer state,
               batches and caches, keyed by the JAX leaf path
  runtime.py — what runs the model on a mesh: parameters placed as
               DTensors and gathered where a layer uses them, the batch's
               data-parallel rows, the collectives of the MoE's
               expert-parallel branch
"""
from .api import (  # noqa: F401
    DP_AXES,
    TP_AXIS,
    constrain,
    constrain_seq,
    current_mesh,
    named_sharding,
    spec,
    use_mesh,
)
from .specs import (  # noqa: F401
    auto_spec,
    batch_pspecs,
    cache_pspecs,
    params_pspecs,
    shardings,
    state_pspecs,
)
