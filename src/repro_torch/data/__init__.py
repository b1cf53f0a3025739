"""Point-set generators (a verbatim copy of ``repro.data.pointsets``: numpy
Philox, so both packages draw bitwise the same inputs from a seed).

The JAX package reaches its copy through ``repro.data``, which imports jax,
so the port keeps its own.
"""
from .pointsets import GENERATORS, gau, kddlike, pokerlike, unb, unif  # noqa: F401
