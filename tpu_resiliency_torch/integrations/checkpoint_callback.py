"""Hierarchical checkpointing callback: fast local saves + slower global saves.

Analogue of the reference's ``LocalCheckpointCallback`` + ``HierarchicalCheckpointIO``
(``ptl_resiliency/local_checkpoint_callback.py:93-203``): local (node-disk/ramdisk)
checkpoints every ``local_every`` steps through the replicated
:class:`LocalCheckpointManager`, global checkpoints every ``global_every`` steps
through the :class:`AsyncCheckpointer`, async finalization polled each step, and
``restore_latest`` picking whichever of (local, global) is newest — local first,
since reading the node's own disk beats re-fetching from shared storage.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Optional

from tpu_resiliency_torch.checkpoint.async_ckpt import AsyncCheckpointer
from tpu_resiliency_torch.checkpoint.local_manager import LocalCheckpointManager
from tpu_resiliency_torch.checkpoint.state_dict import PyTreeStateDict
from tpu_resiliency_torch.integrations.loop import Callback, LoopContext
from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)


class HierarchicalCheckpointCallback(Callback):
    """Drives both checkpoint tiers from loop hooks.

    ``to_state_dict`` / ``from_state_dict``: optional adapters between the user's
    train state and the saved pytree (the reference's abstract
    ``to/from_tensor_aware_state_dict``); identity by default.
    """

    def __init__(
        self,
        local_manager: Optional[LocalCheckpointManager] = None,
        global_dir: Optional[str] = None,
        local_every: int = 0,
        global_every: int = 0,
        to_state_dict: Callable[[Any], Any] = lambda s: s,
        from_state_dict: Callable[[Any, Any], Any] = lambda s, loaded: loaded,
        global_checkpointer: Optional[AsyncCheckpointer] = None,
        rank: Optional[int] = None,
        driven_by_loop: bool = False,
        device: Any = None,
    ):
        if local_every and local_manager is None:
            raise ValueError("local_every set but no local_manager given")
        if global_every and not global_dir:
            raise ValueError("global_every set but no global_dir given")
        self.local_manager = local_manager
        self.global_dir = global_dir
        self.local_every = local_every
        self.global_every = global_every
        self.to_state_dict = to_state_dict
        self.from_state_dict = from_state_dict
        self.global_ckpt = global_checkpointer or (
            AsyncCheckpointer() if global_every else None
        )
        self.rank = rank
        self.driven_by_loop = driven_by_loop
        self.device = device

    def rebuild_group(self, comm, remirror: bool = True) -> None:
        """After a restart round changed the active world: adopt the new rank
        group on the local tier (clique rebuild + re-mirror; collective — every
        surviving rank's callback calls this with the new group's comm). See
        :meth:`LocalCheckpointManager.rebuild_group`."""
        if self.local_manager is not None:
            self.local_manager.rebuild_group(comm, remirror=remirror)

    # -- save path ---------------------------------------------------------

    @property
    def cadence(self) -> int:
        """The loop's ``checkpoint_every`` when driving saves via ``save_now``:
        the GCD of the tier cadences (each tier still fires only on its own)."""
        import math

        vals = [v for v in (self.local_every, self.global_every) if v]
        return math.gcd(*vals) if len(vals) > 1 else (vals[0] if vals else 0)

    def save_now(self, state: Any, step_index: int) -> None:
        """Save whichever tiers are due after ``step_index`` (0-based) completed.

        Wire as ``run_training(..., checkpoint_every=cb.cadence,
        checkpoint_fn=cb.save_now, callbacks=[sections_cb, cb])`` so the loop's
        ``on_checkpoint_start/end`` brackets fire and section-timing/heartbeat
        callbacks attribute checkpoint time correctly. The train state is popped
        and device→host-copied ONCE even when both tiers fire on the same step.
        """
        step = step_index + 1  # checkpoints are named by completed steps
        local_due = self.local_every and step % self.local_every == 0
        global_due = self.global_every and step % self.global_every == 0
        if not (local_due or global_due):
            return
        sd = PyTreeStateDict(self.to_state_dict(state))
        sd.pop_tensors()
        if local_due and global_due:
            # Both tiers consume the same payload: one shared blocking D2H
            # beats two independent async snapshots of the same tree.
            sd.copy_tensors_to_host()
        # Single-tier steps hand the device tensors straight to the engine —
        # pipelined savers enqueue their own async D2H, so the loop never
        # blocks on the copy.
        if local_due:
            self.local_manager.save(step, sd, is_async=True)
        if global_due:
            path = os.path.join(self.global_dir, f"step_{step:08d}")
            self.global_ckpt.async_save(sd, path, rank=self.rank)

    def on_step_end(self, ctx: LoopContext) -> None:
        if not self.driven_by_loop:
            # Standalone mode: save from the step hook. (Checkpoint time is then
            # attributed to the step/out-of-section bucket — wire save_now as the
            # loop's checkpoint_fn and pass driven_by_loop=True when running a
            # sections callback, so the on_checkpoint brackets fire instead.)
            self.save_now(ctx.state, ctx.step)
        # Poll async finalization without blocking the step.
        if self.local_manager is not None:
            self.local_manager.maybe_finalize(blocking=False)
        if self.global_ckpt is not None:
            self.global_ckpt.maybe_finalize(blocking=False)

    def on_train_end(self, ctx: LoopContext) -> None:
        if self.local_manager is not None:
            self.local_manager.maybe_finalize(blocking=True)
        if self.global_ckpt is not None:
            self.global_ckpt.finalize_all()

    # -- restore path ------------------------------------------------------

    def latest_global_step(self) -> int:
        if not self.global_dir or not os.path.isdir(self.global_dir):
            return -1
        steps = []
        for name in os.listdir(self.global_dir):
            if name.startswith("step_"):
                # Strip the per-rank suffix (`step_00000008.r0`) before parsing.
                stem = name[len("step_") :].split(".", 1)[0]
                try:
                    steps.append(int(stem))
                except ValueError:
                    continue
        return max(steps, default=-1)

    def restore_latest(self, ctx: LoopContext) -> bool:
        """Load the newest checkpoint across tiers into ``ctx.state`` and set
        ``ctx.start_step``. Returns False if nothing is restorable."""
        local_step = self.local_manager.find_latest() if self.local_manager else -1
        global_step = self.latest_global_step()
        if local_step < 0 and global_step < 0:
            return False
        if local_step >= global_step:
            tree, meta = self.local_manager.load_tree(local_step, device=self.device)
            step = local_step
            source = "local"
        else:
            path = os.path.join(self.global_dir, f"step_{global_step:08d}")
            tree, meta = AsyncCheckpointer.load(path, rank=self.rank, device=self.device)
            step = global_step
            source = "global"
        ctx.state = self.from_state_dict(ctx.state, tree)
        ctx.start_step = step
        log.info(f"restored {source} checkpoint at step {step}")
        return True

    def close(self) -> None:
        if self.local_manager is not None:
            self.local_manager.close()
        if self.global_ckpt is not None:
            self.global_ckpt.close()
