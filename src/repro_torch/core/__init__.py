"""The paper's parallel k-center algorithms in PyTorch (port of
``repro.core``, in-memory MRG on simulated machines so far).

  gonzalez.py — GON, batched over machine blocks
  executor.py — SimExecutor: m simulated machines on one device
  mrg.py      — MRG, paper Algorithm 1 (mrg / mrg_sim / plan_rounds)
  metrics.py  — covering radius, assignment, brute-force OPT (tests)
"""
from .executor import Executor, SimExecutor  # noqa: F401
from .gonzalez import GonzalezResult, gonzalez  # noqa: F401
from .metrics import assignment, brute_force_opt, covering_radius2  # noqa: F401
from .mrg import MRGResult, mrg, mrg_sim, plan_rounds  # noqa: F401
