"""The global checkpoint tier on ``torch.distributed.checkpoint``: the loop protocol
driving a checkpointer this framework did NOT write.

Port of ``tpu_resiliency/integrations/orbax_adapter.py``. The reference drives orbax's
``CheckpointManager``, the JAX ecosystem's global-tier checkpointer; the port drives
``torch.distributed.checkpoint`` (DCP), which ships with torch, with the same save
cadence, retention (``max_to_keep``), asynchronous saves and ``restore_latest`` seam,
so the two tiers compose on one loop: DCP as the durable global tier,
:class:`~tpu_resiliency_torch.integrations.checkpoint_callback.HierarchicalCheckpointCallback`'s
local manager as the fast local tier, and the hierarchical callback falls back to this
tier through the same seam when the local tier is lost.

The files are DCP's (a ``.metadata`` file and ``*.distcp`` shards per step
directory), not orbax's: a global-tier checkpoint of one package does not load in the
other. The local tier's TPURES03 containers still interchange byte for byte.

Each save goes to ``<directory>/step_<step>.tmp`` through ``dcp.async_save`` (which
stages the state to host memory before it returns, so the loop may update tensors in
place right after) and is committed by a rename to ``step_<step>`` once written (by
rank 0, between two barriers, when the save is collective); only committed steps
count. Retention prunes the oldest committed steps past
``max_to_keep``.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Callable, Optional

import torch

from tpu_resiliency_torch.integrations.loop import Callback, LoopContext
from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)

_STEP_DIR = re.compile(r"^step_(\d+)$")


def _clone_tree(tree: Any) -> Any:
    """A copy of ``tree`` whose tensors are fresh (DCP loads into a state in place)."""
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return tree


class DcpCheckpointCallback(Callback):
    """Save the loop's train state through ``torch.distributed.checkpoint``.

    ``to_state_dict`` / ``from_state_dict`` adapt between the loop's train state and
    the saved state dict (a nested dict of tensors and plain values; identity by
    default — the adapter contract of :class:`HierarchicalCheckpointCallback`). Saves
    are asynchronous (``dcp.async_save``); ``on_train_end`` waits them out.

    ``collective``: whether saves and loads run over the default process group (every
    rank calls them together, as DCP requires); ``None`` means "when a group is
    initialized". Pass False where only some ranks write this tier.
    """

    def __init__(
        self,
        directory: str,
        every: int,
        max_to_keep: int = 2,
        to_state_dict: Callable[[Any], Any] = lambda s: s,
        from_state_dict: Callable[[Any, Any], Any] = lambda s, loaded: loaded,
        *,
        collective: Optional[bool] = None,
    ):
        self.directory = os.path.abspath(directory)
        self.every = every
        self.max_to_keep = max_to_keep
        self.to_state_dict = to_state_dict
        self.from_state_dict = from_state_dict
        self.collective = collective
        self._pending: Optional[tuple[int, str, Any]] = None  # (step, tmp dir, future)
        os.makedirs(self.directory, exist_ok=True)

    def _no_dist(self) -> bool:
        from tpu_resiliency_torch.platform.distributed import client_active

        collective = client_active() if self.collective is None else self.collective
        return not collective

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    # -- loop hooks --------------------------------------------------------

    def on_step_end(self, ctx: LoopContext) -> None:
        if self.every and (ctx.step + 1) % self.every == 0:
            self.save(ctx.step, ctx.state)
            log.info(f"dcp save scheduled @ step {ctx.step}")

    def on_train_end(self, ctx: LoopContext) -> None:
        self.wait_until_finished()

    # -- saving ------------------------------------------------------------

    def save(self, step: int, state: Any) -> None:
        """Save ``state`` as ``step``: the previous save is committed first; this one
        is committed once written (at the next save or :meth:`wait_until_finished`)."""
        import torch.distributed.checkpoint as dcp

        self.wait_until_finished()
        tmp = self._step_dir(step) + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        fut = dcp.async_save(self.to_state_dict(state), checkpoint_id=tmp,
                             no_dist=self._no_dist())
        self._pending = (step, tmp, fut)

    def wait_until_finished(self) -> None:
        """Block until the in-flight save is written, then commit it (rename) and
        prune past ``max_to_keep``."""
        if self._pending is None:
            return
        step, tmp, fut = self._pending
        self._pending = None
        fut.result()
        collective = not self._no_dist()
        if collective:
            import torch.distributed as dist

            dist.barrier()  # every rank's shards are written before the commit
        if not collective or dist.get_rank() == 0:
            final = self._step_dir(step)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            if self.max_to_keep:
                for old in self.all_steps()[: -self.max_to_keep]:
                    shutil.rmtree(self._step_dir(old), ignore_errors=True)
        if collective:
            dist.barrier()  # the commit is seen by every rank

    # -- restore -----------------------------------------------------------

    def all_steps(self) -> list[int]:
        """Committed steps, oldest first."""
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_DIR.match(name)
            if m and os.path.isdir(os.path.join(self.directory, name)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> int:
        """Newest committed step, or -1."""
        self.wait_until_finished()
        steps = self.all_steps()
        return steps[-1] if steps else -1

    def restore_latest(self, ctx: LoopContext) -> bool:
        """Restore the newest checkpoint into ``ctx.state`` (the current state, cloned,
        is the target, so shapes, dtypes and devices are kept) and advance
        ``ctx.start_step``. Returns False when nothing is saved yet."""
        import torch.distributed.checkpoint as dcp

        step = self.latest_step()
        if step < 0:
            return False
        target = _clone_tree(self.to_state_dict(ctx.state))
        dcp.load(target, checkpoint_id=self._step_dir(step), no_dist=self._no_dist())
        ctx.state = self.from_state_dict(ctx.state, target)
        ctx.start_step = int(step) + 1
        log.info(f"dcp restored step {step}; resuming at {ctx.start_step}")
        return True

    def close(self) -> None:
        self.wait_until_finished()
