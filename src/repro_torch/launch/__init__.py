"""Launch helpers (port of ``repro.launch``).

  mesh.py — ``Mesh`` and ``make_mesh``: the paper's machines as the
            positions of a named mesh, in one process; the two collectives
            the mesh executor uses (``all_gather``, ``all_max``)
"""
from .mesh import Mesh, all_gather, all_max, make_mesh  # noqa: F401
