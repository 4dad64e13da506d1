"""Checkpointing: async saves, local (node-storage) checkpoints, clique replication.

TPU-native re-design of the reference's ``checkpointing/`` package (SURVEY §2.6):

- :mod:`~tpu_resiliency_torch.checkpoint.state_dict` — pytree hollow/payload split
  (``TensorAwareStateDict`` contract).
- :mod:`~tpu_resiliency_torch.checkpoint.format` — atomic single-file container.
- :mod:`~tpu_resiliency_torch.checkpoint.async_core` — ``AsyncRequest`` / callers /
  ``AsyncCallsQueue`` with distributed finalization.
- :mod:`~tpu_resiliency_torch.checkpoint.async_ckpt` — whole-pytree async checkpointer.
- :mod:`~tpu_resiliency_torch.checkpoint.comm` — store-backed object collectives + p2p
  bulk links.
- :mod:`~tpu_resiliency_torch.checkpoint.replication` — clique replication + exchange plans.
- :mod:`~tpu_resiliency_torch.checkpoint.local_manager` — per-rank local checkpoint manager
  with coverage-based ``find_latest``.
- :mod:`~tpu_resiliency_torch.checkpoint.reshard` — elastic resharding: repartition
  plans mapping any saved world's shards onto any target world/topology.
- :mod:`~tpu_resiliency_torch.checkpoint.coding` — byte economy: Reed-Solomon
  erasure replication (k-of-n blocks instead of full mirrors) and delta
  checkpoints (chunk-diff frames between keyframes).
- :mod:`~tpu_resiliency_torch.checkpoint.coldtier` — durable cold tier: async
  spill of finalized keyframe containers to a pluggable object store,
  manifest-verified restore-anywhere bootstrap.
"""

from tpu_resiliency_torch.checkpoint.async_ckpt import AsyncCheckpointer
from tpu_resiliency_torch.checkpoint.coldtier import (
    ColdTier,
    FilesystemStore,
    ObjectStore,
    cold_from_env,
)
from tpu_resiliency_torch.checkpoint.async_core import (
    AsyncCallsQueue,
    AsyncRequest,
    ForkAsyncCaller,
    ProcessAsyncCaller,
    ThreadAsyncCaller,
)
from tpu_resiliency_torch.checkpoint.coding import (
    DeltaTracker,
    ErasureReplicationStrategy,
    replication_from_env,
)
from tpu_resiliency_torch.checkpoint.comm import PeerExchange, StoreComm
from tpu_resiliency_torch.checkpoint.local_manager import CkptID, LocalCheckpointManager
from tpu_resiliency_torch.checkpoint.replication import (
    CliqueReplicationStrategy,
    ExchangePlan,
    LazyCliqueReplicationStrategy,
    group_sequence_for,
    parse_group_sequence,
)
from tpu_resiliency_torch.checkpoint.reshard import (
    LeafSpec,
    ReshardPlan,
    TreeLayout,
    build_plan,
)
from tpu_resiliency_torch.checkpoint.staging import HostStagingPool, StagingLease
from tpu_resiliency_torch.checkpoint.state_dict import (
    HostSnapshot,
    PyTreeStateDict,
    TensorPlaceholder,
)

__all__ = [
    "AsyncCheckpointer",
    "AsyncCallsQueue",
    "AsyncRequest",
    "ThreadAsyncCaller",
    "ProcessAsyncCaller",
    "ForkAsyncCaller",
    "StoreComm",
    "PeerExchange",
    "CkptID",
    "LocalCheckpointManager",
    "ColdTier",
    "FilesystemStore",
    "ObjectStore",
    "cold_from_env",
    "CliqueReplicationStrategy",
    "LazyCliqueReplicationStrategy",
    "ErasureReplicationStrategy",
    "DeltaTracker",
    "replication_from_env",
    "ExchangePlan",
    "group_sequence_for",
    "parse_group_sequence",
    "HostSnapshot",
    "HostStagingPool",
    "StagingLease",
    "PyTreeStateDict",
    "TensorPlaceholder",
    "TreeLayout",
    "LeafSpec",
    "ReshardPlan",
    "build_plan",
]
