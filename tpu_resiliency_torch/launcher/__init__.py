"""Fault-tolerant elastic launcher: per-host agent, CAS rendezvous, worker groups.

TPU-native analogue of the reference's ``ft_launcher`` + elastic-agent stack
(``fault_tolerance/launcher.py``, ``_torch_elastic_compat/agent``).
"""

from tpu_resiliency_torch.launcher.agent import AgentConfig, ElasticAgent, WorkersFailed
from tpu_resiliency_torch.launcher.errors import (
    ERROR_FILE_ENV,
    WorkerError,
    main_guard,
    record,
    write_error_file,
)
from tpu_resiliency_torch.launcher.proc import GroupState, WorkerFailure, WorkerGroup
from tpu_resiliency_torch.launcher.rendezvous import (
    RendezvousOutcome,
    RendezvousSettings,
    StoreRendezvous,
)

__all__ = [
    "AgentConfig",
    "ElasticAgent",
    "WorkersFailed",
    "ERROR_FILE_ENV",
    "WorkerError",
    "main_guard",
    "record",
    "write_error_file",
    "GroupState",
    "WorkerFailure",
    "WorkerGroup",
    "RendezvousOutcome",
    "RendezvousSettings",
    "StoreRendezvous",
]
