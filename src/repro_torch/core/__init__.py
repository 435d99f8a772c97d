"""CPR core of the port: the paper's contribution, on the flat store.

Public API (this slice):
  SystemParams, choose_strategy, expected_pls  — overhead/PLS policy (Eq.1-4)
  CPRManager                                   — mode policy + orchestration
  CheckpointStore, EmbShardSpec                — partial checkpoints by shard
  AsyncCheckpointWriter, AsyncApplier          — background incremental saves
  resolve_run_dir                              — run-versioned CURRENT pointer
  GammaFailureModel, FailureInjector           — failure modeling (§3)
  Emulator                                     — the evaluation framework (§5.1)
  trackers                                     — MFU / SSU / SCAR (§4.2)

The sharded writer fleet and its transports come with a later slice.
"""
from repro_torch.core.overhead import (SystemParams, choose_strategy,
                                       expected_pls, full_recovery_overhead,
                                       partial_recovery_overhead,
                                       scalability_curve, t_save_full_optimal,
                                       t_save_partial)
from repro_torch.core.checkpoint import (AsyncApplier, AsyncCheckpointWriter,
                                         CheckpointStore, EmbShardSpec,
                                         resolve_run_dir)
from repro_torch.core.failure import (FailureEvent, FailureInjector,
                                      GammaFailureModel)
from repro_torch.core.manager import ALL_MODES, CPRManager
from repro_torch.core.emulator import EmulationResult, Emulator
