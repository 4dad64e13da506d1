"""Distributed state carried across in-process restart iterations.

Analogue of the reference's ``inprocess/state.py:23-124``: the restart loop's view of
this rank's identity — initial (as launched) vs active (after rank reassignment) —
plus the iteration counter and the mode lattice INITIALIZED → ACTIVE/INACTIVE →
TERMINATED. ``set_distributed_vars`` rewrites the environment variables the training
function reads so a reassigned rank transparently becomes its new identity
(reference ``state.py:94-96``); on TPU the variables are the ones
``jax.distributed.initialize`` and our launcher consume.
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Optional


class Mode(enum.Enum):
    INITIALIZED = enum.auto()
    ACTIVE = enum.auto()  # runs the wrapped function
    INACTIVE = enum.auto()  # healthy spare: waits in reserve_fn for a slot
    TERMINATED = enum.auto()  # excluded from the job


@dataclasses.dataclass
class State:
    rank: int
    world_size: int
    active_rank: Optional[int] = None
    active_world_size: Optional[int] = None
    initial_rank: int = -1
    initial_world_size: int = -1
    iteration: int = 0
    mode: Mode = Mode.INITIALIZED
    fn_exception: Optional[BaseException] = None

    def __post_init__(self) -> None:
        if self.initial_rank < 0:
            self.initial_rank = self.rank
        if self.initial_world_size < 0:
            self.initial_world_size = self.world_size
        if self.active_rank is None:
            self.active_rank = self.rank
        if self.active_world_size is None:
            self.active_world_size = self.world_size

    @classmethod
    def from_env(cls) -> "State":
        """Identity from launcher-injected env (reference ``state.py:84``)."""
        rank = int(os.environ.get("TPU_RESILIENCY_RANK", os.environ.get("RANK", "0")))
        world = int(
            os.environ.get("TPU_RESILIENCY_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1"))
        )
        return cls(rank=rank, world_size=world)

    def set_distributed_vars(self) -> None:
        """Expose the *active* identity to the wrapped function via env."""
        if self.mode == Mode.ACTIVE:
            os.environ["RANK"] = str(self.active_rank)
            os.environ["WORLD_SIZE"] = str(self.active_world_size)
            os.environ["TPU_RESILIENCY_ACTIVE_RANK"] = str(self.active_rank)
            os.environ["TPU_RESILIENCY_ACTIVE_WORLD_SIZE"] = str(self.active_world_size)

    def advance(self) -> None:
        self.iteration += 1
        self.fn_exception = None

    def freeze(self) -> "FrozenState":
        return FrozenState(
            rank=self.rank,
            world_size=self.world_size,
            active_rank=self.active_rank,
            active_world_size=self.active_world_size,
            initial_rank=self.initial_rank,
            initial_world_size=self.initial_world_size,
            iteration=self.iteration,
            mode=self.mode,
            fn_exception=self.fn_exception,
        )


@dataclasses.dataclass(frozen=True)
class FrozenState:
    """Immutable snapshot handed to user-pluggable callbacks (reference ``FrozenState``)."""

    rank: int
    world_size: int
    active_rank: Optional[int]
    active_world_size: Optional[int]
    initial_rank: int
    initial_world_size: int
    iteration: int
    mode: Mode
    #: the local exception that triggered this restart round, if any — ``None`` when
    #: the round was triggered by a peer (lets per-rank fault accounting distinguish
    #: "this rank faulted" from "the job restarted")
    fn_exception: Optional[BaseException] = None
