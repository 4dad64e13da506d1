"""Checkpoint byte-economy plane: erasure coding + delta checkpoints.

Two compounding attacks on replication bandwidth (ROADMAP item 3; the
reference — NVRx local checkpointing — only ever full-mirrors):

- :mod:`~tpu_resiliency_torch.checkpoint.coding.rs` /
  :mod:`~tpu_resiliency_torch.checkpoint.coding.strategy` — Reed-Solomon parity
  across the clique instead of full mirrors: each peer stores one coded
  block (``payload/k`` bytes) of every clique member's shard, so a save
  moves ~``(1 + (m-1)/k)×`` the payload instead of ``(n-1)×``, and a lost
  rank's shard reconstructs byte-identically from any ``k`` surviving
  blocks (the reconstruct rung slots into the recovery ladder between
  "local verify" and "peer retrieve").
- :mod:`~tpu_resiliency_torch.checkpoint.coding.delta` — delta checkpoints: the
  ``TPURES03`` chunk manifest makes consecutive saves diffable per chunk,
  so steady-state replication ships only changed chunks between full
  keyframes (``delta_interval`` knob on the local manager).
"""

import os

from tpu_resiliency_torch.checkpoint.coding.delta import (  # noqa: F401
    DeltaTracker,
    apply_delta,
    encode_delta,
    is_delta,
)
from tpu_resiliency_torch.checkpoint.coding.strategy import (  # noqa: F401
    ErasureReplicationStrategy,
    block_identity,
    is_block,
)

#: ``mirror`` (default) | ``erasure`` | ``erasure:<parity>`` — the launcher's
#: ``--ckpt-coding`` flag exports it so worker scripts pick the strategy
#: without plumbing a new argument through every training loop.
CODING_ENV = "TPU_RESILIENCY_CKPT_CODING"


def replication_from_env(
    comm,
    exchange,
    replication_jump: int = 1,
    replication_factor: int = 2,
    coding: str | None = None,
):
    """Strategy factory honoring ``$TPU_RESILIENCY_CKPT_CODING`` (or an
    explicit ``coding`` spec): the one construction-site change that moves a
    job from full mirrors to k-of-n parity."""
    from tpu_resiliency_torch.checkpoint.replication import CliqueReplicationStrategy
    from tpu_resiliency_torch.exceptions import CheckpointError

    spec = (coding if coding is not None else os.environ.get(CODING_ENV, "mirror"))
    spec = (spec or "mirror").strip().lower()
    if spec in ("", "mirror"):
        return CliqueReplicationStrategy(
            comm, exchange, replication_jump, replication_factor
        )
    if spec == "erasure" or spec.startswith("erasure:"):
        parity = 1
        if ":" in spec:
            try:
                parity = int(spec.split(":", 1)[1])
            except ValueError as e:
                raise CheckpointError(
                    f"bad {CODING_ENV} spec {spec!r} (want erasure[:parity])"
                ) from e
        return ErasureReplicationStrategy(
            comm, exchange, replication_jump, replication_factor, parity=parity
        )
    raise CheckpointError(
        f"unknown checkpoint coding {spec!r} (want mirror | erasure[:parity])"
    )


__all__ = [
    "CODING_ENV",
    "DeltaTracker",
    "apply_delta",
    "encode_delta",
    "is_delta",
    "ErasureReplicationStrategy",
    "block_identity",
    "is_block",
    "replication_from_env",
]
