"""Launch helpers (port of ``repro.launch``).

  mesh.py    — ``Mesh``, ``make_mesh`` and ``make_cluster_mesh``: the
               paper's machines as the positions of a named mesh, in one
               process or over the processes of a run; the two collectives
               the mesh executor uses in one process (``all_gather``,
               ``all_max``); the LM's meshes of one process a position
               (``make_production_mesh``, ``make_elastic_mesh``,
               ``make_process_mesh``)
  specs.py   — the abstract inputs of every (arch × shape) cell, with no
               allocation
  dryrun.py  — the per-cell memory, FLOPs, collectives and roofline
               terms over a fake process group
  train.py   — the fault-tolerant training loop and its CLI
  cluster.py — the multi-process launcher: ``launch_cluster`` and
               ``run_scenario`` start local worker processes over one
               ``torch.distributed`` group and collect their verdicts
               (``python -m repro_torch.launch.cluster --demo -n 2``)
"""
from .mesh import (Mesh, all_gather, all_max, make_cluster_mesh,  # noqa: F401
                   make_elastic_mesh, make_mesh, make_process_mesh,
                   make_production_mesh)

# The launcher's names load on first use: ``python -m
# repro_torch.launch.cluster`` imports this package first, and an eager
# import of the module it is about to run would make runpy warn.
_CLUSTER = ("ClusterError", "WorkerContext", "WorkerResult", "free_port",
            "launch_cluster", "load_target", "run_scenario", "worker_env")


def __getattr__(name):
    if name in _CLUSTER:
        from . import cluster
        return getattr(cluster, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
