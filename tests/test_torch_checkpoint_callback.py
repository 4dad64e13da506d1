"""The port's ``HierarchicalCheckpointCallback`` on the port's loop held against the
JAX package's on its own (``tests/integrations/test_loop_callbacks.py``, the
checkpoint-callback tests).

The same schedule of steps and tiers runs through both packages: the tiers' newest
steps, the tier ``restore_latest`` picks and the restored values must agree. The
port's train state is updated in place, as an optimizer step updates it, and each
checkpoint must hold the values of its own step.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_resiliency.integrations as ref_integrations
from tpu_resiliency.checkpoint.local_manager import LocalCheckpointManager as RefManager
from tpu_resiliency_torch.checkpoint.local_manager import LocalCheckpointManager
from tpu_resiliency_torch.integrations import (
    Callback,
    HierarchicalCheckpointCallback,
    LoopContext,
    run_training,
)


def run_schedule(side, root, local_every, global_every, steps, rank=None):
    """``steps`` steps of ``w += 1`` (in place in the port) with the callback; returns
    the tiers' newest steps and what ``restore_latest`` brings back."""
    os.makedirs(os.path.join(root, "global"), exist_ok=True)
    if side == "ref":
        mgr = RefManager(os.path.join(root, "local"), rank=0) if local_every else None
        cb = ref_integrations.HierarchicalCheckpointCallback(
            local_manager=mgr, global_dir=os.path.join(root, "global"),
            local_every=local_every, global_every=global_every, rank=rank,
            to_state_dict=lambda s: {"w": s}, from_state_dict=lambda s, loaded: loaded["w"])
        ctx = ref_integrations.run_training(lambda s, i: s + jnp.ones(()), jnp.zeros(()), steps,
                                            callbacks=[cb])
        fresh = ref_integrations.LoopContext()
        fresh.state = jnp.zeros(())
    else:
        mgr = LocalCheckpointManager(os.path.join(root, "local"), rank=0) if local_every else None
        cb = HierarchicalCheckpointCallback(
            local_manager=mgr, global_dir=os.path.join(root, "global"),
            local_every=local_every, global_every=global_every, rank=rank, device="cpu",
            to_state_dict=lambda s: {"w": s}, from_state_dict=lambda s, loaded: loaded["w"])
        ctx = run_training(lambda s, i: s.add_(1.0), torch.zeros(()), steps, callbacks=[cb])
        fresh = LoopContext()
        fresh.state = torch.zeros(())
    restored = cb.restore_latest(fresh)
    out = (float(ctx.state), mgr.find_latest() if mgr else None, cb.latest_global_step(),
           restored, fresh.start_step, float(fresh.state))
    cb.close()
    return out


SCHEDULES = {
    "local_newest": (2, 4, 8, None),
    "global_newest": (3, 4, 4, None),
    "global_rank_suffixed": (0, 2, 4, 0),
    "local_only": (2, 0, 6, None),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_end_as_the_references(tmp_path, name):
    local_every, global_every, steps, rank = SCHEDULES[name]
    port = run_schedule("port", str(tmp_path / "port"), local_every, global_every, steps, rank)
    ref = run_schedule("ref", str(tmp_path / "ref"), local_every, global_every, steps, rank)
    assert port == ref
    assert port[3] and port[5] == port[4]


def test_async_local_saves_hold_each_steps_values_under_in_place_updates(tmp_path):
    """Local tier every 2 steps, async, 6 steps of in-place updates to every leaf: a
    fresh state restored from the latest checkpoint equals the state at step 6, and
    each kept iteration holds its own step's values."""
    gen = torch.Generator().manual_seed(0)
    state = {"w": torch.randn(64, 8, generator=gen), "b": torch.randn(8, generator=gen).bfloat16(),
             "step": 0}
    seen = {}

    def step(s, i):
        for k in ("w", "b"):
            s[k].add_(torch.randn(s[k].shape, generator=gen).to(s[k].dtype))
        s["step"] = i + 1
        seen[i + 1] = {k: s[k].clone() for k in ("w", "b")}
        return s

    mgr = LocalCheckpointManager(str(tmp_path), rank=0, keep=3)
    cb = HierarchicalCheckpointCallback(local_manager=mgr, local_every=2, device="cpu")
    run_training(step, state, 6, callbacks=[cb])
    fresh = LoopContext()
    fresh.state = {"w": torch.zeros(64, 8), "b": torch.zeros(8).bfloat16(), "step": 0}
    assert cb.restore_latest(fresh) and fresh.start_step == 6
    for k in ("w", "b"):
        assert torch.equal(fresh.state[k].view(torch.int16), seen[6][k].view(torch.int16))
    assert fresh.state["step"] == 6
    for it in (2, 4):
        tree, _ = mgr.load_tree(it, device="cpu")
        assert all(torch.equal(tree[k], seen[it][k]) for k in ("w", "b"))
    cb.close()


def test_driven_by_loop_saves_inside_the_checkpoint_brackets(tmp_path):
    events = []

    class Brackets(Callback):
        def on_checkpoint_start(self, ctx):
            events.append(("start", ctx.step))

        def on_checkpoint_end(self, ctx):
            events.append(("end", ctx.step, mgr.find_latest()))

    mgr = LocalCheckpointManager(str(tmp_path), rank=0, pipelined=False)
    cb = HierarchicalCheckpointCallback(local_manager=mgr, local_every=2, driven_by_loop=True,
                                        to_state_dict=lambda s: {"w": s},
                                        from_state_dict=lambda s, loaded: loaded["w"],
                                        device="cpu")
    run_training(lambda s, i: s.add_(1.0), torch.zeros(()), 4, callbacks=[cb, Brackets()],
                 checkpoint_every=cb.cadence, checkpoint_fn=cb.save_now)
    assert [e[:2] for e in events] == [("start", 1), ("end", 1), ("start", 3), ("end", 3)]
    assert mgr.find_latest() == 4
    cb.close()


def test_restore_defaults_to_the_card(tmp_path):
    mgr = LocalCheckpointManager(str(tmp_path), rank=0)
    cb = HierarchicalCheckpointCallback(local_manager=mgr, local_every=1)
    run_training(lambda s, i: s, {"w": torch.ones(2)}, 1, callbacks=[cb])
    fresh = LoopContext()
    if torch.cuda.is_available():
        assert cb.restore_latest(fresh) and fresh.state["w"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cb.restore_latest(fresh)
    cb.close()
    assert np.array_equal(mgr.load(1)[1][0], np.ones(2, np.float32))
