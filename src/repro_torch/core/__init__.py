"""The paper's parallel k-center algorithms in PyTorch (port of
``repro.core``: MRG in memory and out of core, and coreset selection).

  gonzalez.py — GON, batched over machine blocks; streamed over a source
  executor.py — SimExecutor (m simulated machines on one device) and
                HostStreamExecutor (out-of-core super-shards)
  mrg.py      — MRG, paper Algorithm 1 (mrg / mrg_sim / plan_rounds)
  coreset.py  — k-center coreset selection (data curation by diversity)
  metrics.py  — covering radius, assignment, brute-force OPT (tests)
"""
from .coreset import Coreset, select_coreset  # noqa: F401
from .executor import Executor, HostStreamExecutor, SimExecutor  # noqa: F401
from .gonzalez import GonzalezResult, covering_radius, gonzalez  # noqa: F401
from .metrics import assignment, brute_force_opt, covering_radius2  # noqa: F401
from .mrg import MRGResult, mrg, mrg_sim, plan_rounds  # noqa: F401
