"""The paper's parallel k-center algorithms in PyTorch (port of
``repro.core``: MRG in memory and out of core, coreset selection, the
weighted and outlier objectives, the streaming sketch, and EIM).

  gonzalez.py — GON, batched over machine blocks; streamed over a source
  executor.py — SimExecutor (m simulated machines on one device),
                HostStreamExecutor (out-of-core super-shards) and
                MeshExecutor (the machines as mesh shards: fused in memory,
                or each shard streamed); Objective (weighted, outliers)
  mrg.py      — MRG, paper Algorithm 1 (mrg / mrg_sim / mrg_distributed /
                plan_rounds)
  coreset.py  — k-center coreset selection (data curation by diversity)
                and embed_batches (mean-pooled LM embeddings to curate)
  outliers.py — (k,z)-center with outliers (kz_center)
  streaming.py — the doubling sketch over a stream (stream_update)
  metrics.py  — covering radius, assignment, brute-force OPT (tests)
  eim.py      — EIM, paper §4 (eim / eim_sample): the device path and the
                streamed loop over an executor's filter rounds
"""
from .coreset import Coreset, embed_batches, select_coreset  # noqa: F401
from .eim import EIMResult, EIMSample, eim, eim_sample  # noqa: F401
from .executor import (Executor, HostStreamExecutor, MeshExecutor,  # noqa: F401
                       Objective, SimExecutor, weighted_gon_block_fn)
from .gonzalez import GonzalezResult, covering_radius, gonzalez  # noqa: F401
from .metrics import (assignment, brute_force_opt,  # noqa: F401
                      brute_force_opt_z, covering_radius2)
from .mrg import (MRGResult, mrg, mrg_distributed, mrg_sim,  # noqa: F401
                  plan_rounds)
from .outliers import KZResult, covering_radius_excluding, kz_center  # noqa: F401
from .streaming import (StreamState, stream_init, stream_result,  # noqa: F401
                        stream_update)
