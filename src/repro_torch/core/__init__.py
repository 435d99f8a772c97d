"""CPR core of the port: the paper's contribution.

Public API:
  SystemParams, choose_strategy, expected_pls  — overhead/PLS policy (Eq.1-4)
  CPRManager                                   — mode policy + orchestration
  CheckpointStore, EmbShardSpec                — partial checkpoints by shard
  AsyncCheckpointWriter, AsyncApplier          — background incremental saves
  ShardedCheckpointWriter, ShardSaveError      — per-shard writer fleet with
                                                 a coordinator fence
  StaleCoordinatorError                        — this coordinator was
                                                 superseded by a standby
  LeaseHeldError, lease_status                 — lease-based coordinator
                                                 leader election
  load_latest_auto                             — resume from either layout
  ShardTransport, make_transport, TRANSPORTS   — pluggable writer transports
                                                 (inproc / pipe / socket)
  WriterProcError, StaleEpochError             — a shard writer died / now
                                                 belongs to a newer epoch
  resolve_run_dir                              — run-versioned CURRENT pointer
  GammaFailureModel, FailureInjector           — failure modeling (§3)
  Emulator                                     — the evaluation framework (§5.1)
  trackers                                     — MFU / SSU / SCAR (§4.2)
"""
from repro_torch.core.overhead import (SystemParams, choose_strategy,
                                       expected_pls, full_recovery_overhead,
                                       partial_recovery_overhead,
                                       scalability_curve, t_save_full_optimal,
                                       t_save_partial)
from repro_torch.core.checkpoint import (AsyncApplier, AsyncCheckpointWriter,
                                         CheckpointStore, EmbShardSpec,
                                         resolve_run_dir)
from repro_torch.core.sharded_checkpoint import (LeaseHeldError,
                                                 ShardedCheckpointWriter,
                                                 ShardSaveError,
                                                 StaleCoordinatorError,
                                                 lease_status,
                                                 load_latest_auto)
from repro_torch.core.transport import (TRANSPORTS, ShardTransport,
                                        StaleEpochError, WriterProcError,
                                        make_transport)
from repro_torch.core.failure import (FailureEvent, FailureInjector,
                                      GammaFailureModel)
from repro_torch.core.manager import ALL_MODES, CPRManager
from repro_torch.core.emulator import EmulationResult, Emulator
