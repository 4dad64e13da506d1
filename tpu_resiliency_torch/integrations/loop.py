"""Training-loop callback protocol: the L5 integration seam.

A copy of ``tpu_resiliency/integrations/loop.py``: the protocol holds no JAX, so a
PyTorch train loop takes it as it is.

The reference integrates via PyTorch-Lightning hooks (``ptl_resiliency/``); a plain
train loop has no Trainer object, so the seam here is a minimal callback protocol
plus ``run_training``, a loop driver that owns hook dispatch. Users with their own
loop call the hooks directly — every callback works either way, and all of them are
usable inside an ``inprocess.Wrapper``-wrapped train fn (layered restart).

Hook order per step: ``on_step_start`` → user step fn → ``on_step_end``. Checkpoint
and validation phases are bracketed so section-timing callbacks can attribute time
correctly (the reference's three sections: setup/step/checkpointing,
``fault_tolerance_sections_callback.py:141-179``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Optional

from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)


class Callback:
    """Base class: override any subset of hooks. All hooks are no-ops by default."""

    def on_train_start(self, ctx: "LoopContext") -> None: ...

    def on_step_start(self, ctx: "LoopContext") -> None: ...

    def on_step_end(self, ctx: "LoopContext") -> None: ...

    def on_validation_start(self, ctx: "LoopContext") -> None: ...

    def on_validation_end(self, ctx: "LoopContext") -> None: ...

    def on_checkpoint_start(self, ctx: "LoopContext") -> None: ...

    def on_checkpoint_end(self, ctx: "LoopContext") -> None: ...

    def on_exception(self, ctx: "LoopContext", exc: BaseException) -> None: ...

    def on_train_end(self, ctx: "LoopContext") -> None: ...


@dataclasses.dataclass
class LoopContext:
    """What callbacks can see/alter. ``should_stop`` mirrors the reference's
    ``trainer.should_stop`` cooperative-stop contract."""

    step: int = 0
    max_steps: int = 0
    rank: int = 0
    world_size: int = 1
    should_stop: bool = False
    state: Any = None  # user train state (params/opt state pytree)
    metrics: dict = dataclasses.field(default_factory=dict)
    start_step: int = 0


class CallbackRunner:
    """Dispatches a hook across callbacks; a callback failure is logged, never
    fatal to training (reference callbacks guard the same way)."""

    def __init__(self, callbacks: Iterable[Callback]):
        self.callbacks = list(callbacks)

    def fire(self, hook: str, ctx: LoopContext, *args) -> None:
        for cb in self.callbacks:
            try:
                getattr(cb, hook)(ctx, *args)
            except StopTraining:
                ctx.should_stop = True
            except Exception:
                log.exception(f"callback {type(cb).__name__}.{hook} failed")


class StopTraining(Exception):
    """A callback may raise this from any hook to request a cooperative stop."""


def run_training(
    step_fn: Callable[[Any, int], Any],
    state: Any,
    num_steps: int,
    callbacks: Iterable[Callback] = (),
    ctx: Optional[LoopContext] = None,
    checkpoint_every: Optional[int] = None,
    checkpoint_fn: Optional[Callable[[Any, int], None]] = None,
    validate_every: Optional[int] = None,
    validate_fn: Optional[Callable[[Any, int], dict]] = None,
) -> LoopContext:
    """Drive ``state = step_fn(state, step)`` for ``num_steps`` with hook dispatch.

    Returns the final context (``ctx.state`` is the final train state). Exceptions
    propagate after ``on_exception`` — the inprocess/in-job restart layers above
    decide what a fault means; the loop doesn't swallow it.
    """
    runner = CallbackRunner(callbacks)
    ctx = ctx or LoopContext()
    ctx.state = state
    ctx.max_steps = num_steps
    step = ctx.start_step
    runner.fire("on_train_start", ctx)
    try:
        while step < num_steps and not ctx.should_stop:
            ctx.step = step
            runner.fire("on_step_start", ctx)
            ctx.state = step_fn(ctx.state, step)
            runner.fire("on_step_end", ctx)
            if validate_fn is not None and validate_every and (step + 1) % validate_every == 0:
                runner.fire("on_validation_start", ctx)
                metrics = validate_fn(ctx.state, step) or {}
                ctx.metrics.update(metrics)
                runner.fire("on_validation_end", ctx)
            if checkpoint_fn is not None and checkpoint_every and (step + 1) % checkpoint_every == 0:
                runner.fire("on_checkpoint_start", ctx)
                checkpoint_fn(ctx.state, step)
                runner.fire("on_checkpoint_end", ctx)
            step += 1
        ctx.step = step
        return ctx
    except BaseException as e:
        runner.fire("on_exception", ctx, e)
        raise
    finally:
        runner.fire("on_train_end", ctx)
