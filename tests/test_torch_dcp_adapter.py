"""The port's global checkpoint tier (``tpu_resiliency_torch/integrations/dcp_adapter.py``,
``DcpCheckpointCallback`` on ``torch.distributed.checkpoint``) held against
``tests/integrations/test_orbax_adapter.py``'s four scenarios and
``tests/integrations/test_hierarchical_fallback.py``: the reference drives orbax, the
port drives DCP, with the same cadence, retention, asynchronous saves and
``restore_latest`` seam. The files on disk are DCP's (``.metadata`` and ``*.distcp``
in a ``step_<n>`` directory), not orbax's, and the test checks that they are; the
local tier's containers still interchange byte for byte with the reference's
(``tests/test_torch_checkpoint_*.py``), and the fallback case checks that too.
"""

import shutil

import numpy as np
import pytest
import torch

from tests.torch_ckpt_util import World, packages, run_ranks
from tpu_resiliency_torch.integrations import (
    DcpCheckpointCallback,
    HierarchicalCheckpointCallback,
)
from tpu_resiliency_torch.integrations.loop import LoopContext, run_training


def _step_fn(state, step):
    return {"w": state["w"] + 1.0, "step": torch.tensor(step)}


def _init_state():
    return {"w": torch.zeros((4,)), "step": torch.tensor(0)}


def test_save_restore_roundtrip(tmp_path):
    cb = DcpCheckpointCallback(str(tmp_path / "dcp"), every=2)
    ctx = run_training(_step_fn, _init_state(), num_steps=6, callbacks=[cb])
    assert float(ctx.state["w"][0]) == 6.0
    assert cb.latest_step() == 5  # saves after steps 1, 3, 5
    cb.close()
    files = sorted(p.name for p in (tmp_path / "dcp" / "step_00000005").iterdir())
    assert ".metadata" in files and any(f.endswith(".distcp") for f in files), files

    # A fresh callback (post-crash) restores the newest step and resumes.
    cb2 = DcpCheckpointCallback(str(tmp_path / "dcp"), every=2)
    ctx2 = LoopContext()
    ctx2.state = _init_state()
    assert cb2.restore_latest(ctx2)
    assert ctx2.start_step == 6
    np.testing.assert_array_equal(ctx2.state["w"].numpy(), np.full((4,), 6.0))
    assert int(ctx2.state["step"]) == 5

    # Resume the loop from the restored step and run to 8.
    ctx3 = run_training(_step_fn, ctx2.state, num_steps=8, callbacks=[cb2], ctx=ctx2)
    assert float(ctx3.state["w"][0]) == 8.0
    assert cb2.latest_step() == 7
    cb2.close()


def test_restore_empty_returns_false(tmp_path):
    cb = DcpCheckpointCallback(str(tmp_path / "empty"), every=2)
    ctx = LoopContext()
    ctx.state = _init_state()
    assert not cb.restore_latest(ctx)
    assert ctx.start_step == 0
    cb.close()


def test_retention_prunes_old_steps(tmp_path):
    cb = DcpCheckpointCallback(str(tmp_path / "keep"), every=1, max_to_keep=2)
    run_training(_step_fn, _init_state(), num_steps=5, callbacks=[cb])
    cb.wait_until_finished()
    assert cb.all_steps() == [3, 4]
    assert sorted(p.name for p in (tmp_path / "keep").iterdir()) == [
        "step_00000003", "step_00000004"]
    cb.close()


def test_composes_with_local_tier(tmp_path):
    """Both tiers on one loop: DCP global saves and the framework's local-manager
    saves, from independent callbacks."""
    from tpu_resiliency_torch.checkpoint import LocalCheckpointManager

    local_mgr = LocalCheckpointManager(str(tmp_path / "local"), rank=0)
    local_cb = HierarchicalCheckpointCallback(local_manager=local_mgr, local_every=2,
                                              device="cpu")
    dcp_cb = DcpCheckpointCallback(str(tmp_path / "dcp"), every=3)
    run_training(_step_fn, _init_state(), num_steps=6, callbacks=[local_cb, dcp_cb])
    local_mgr.queue.maybe_finalize_async_calls(blocking=True)
    # Local tier records steps-completed (6); DCP records the 0-based step (5).
    assert local_mgr.find_latest() == 6
    assert dcp_cb.latest_step() == 5
    dcp_cb.close()
    local_cb.close()


def test_an_async_save_holds_the_values_at_its_save(tmp_path):
    """``dcp.async_save`` stages to host memory before it returns: an in-place update
    right after the save does not reach the checkpoint."""
    cb = DcpCheckpointCallback(str(tmp_path / "dcp"), every=1)
    state = {"w": torch.arange(8, dtype=torch.float32), "step": torch.tensor(0)}
    cb.save(0, state)
    state["w"].add_(100.0)
    ctx = LoopContext()
    ctx.state = {"w": torch.zeros(8), "step": torch.tensor(-1)}
    assert cb.restore_latest(ctx)
    np.testing.assert_array_equal(ctx.state["w"].numpy(), np.arange(8, dtype=np.float32))


def test_local_tier_lost_dcp_restores_replication_repopulates(tmp_path):
    """``test_hierarchical_fallback.py`` on the port: world 4 saves the local tier every
    2 steps in cliques [0, 1], [2, 3], rank 0 also the DCP tier every 3 steps; every
    node's local disk is lost and ranks 2, 3 stay away; the survivors rebuild their
    group through the callback's seam, find the local tier unrestorable, fall back to
    DCP through the same seam, resume, and repopulate the local tier with
    coverage-complete saves, which the reference's manager loads byte for byte."""
    world = 4
    dcp_dir = str(tmp_path / "dcp")
    node_dir = lambda r: str(tmp_path / f"node{r}")  # noqa: E731  per-rank node-local disk
    pkgs = packages()
    port = pkgs["port"]
    w = World(port)
    try:
        def train_phase(rank):
            mgr, ex = w.manager(node_dir(rank), rank, range(world))
            try:
                local_cb = HierarchicalCheckpointCallback(local_manager=mgr, local_every=2,
                                                          device="cpu")
                cbs = [local_cb]
                dcp_cb = None
                if rank == 0:
                    dcp_cb = DcpCheckpointCallback(dcp_dir, every=3, collective=False)
                    cbs.append(dcp_cb)
                ctx = run_training(_step_fn, _init_state(), num_steps=4, callbacks=cbs)
                assert float(ctx.state["w"][0]) == 4.0
                assert mgr.find_latest() == 4  # iterations 2 and 4 saved, covered
                if dcp_cb is not None:
                    assert dcp_cb.latest_step() == 2  # saved after step index 2 (w=3)
                    dcp_cb.close()
                mgr.close()
            finally:
                ex.close()

        run_ranks(range(world), train_phase, timeout=240.0)

        # The crash: every node's local disk is lost, and ranks 2/3 don't come back.
        for r in range(world):
            shutil.rmtree(node_dir(r))
        survivors = [0, 1]

        def restart_phase(rank):
            mgr, ex = w.manager(node_dir(rank), rank, range(world))
            try:
                local_cb = HierarchicalCheckpointCallback(local_manager=mgr, local_every=2,
                                                          device="cpu")
                new_comm = port.comm.StoreComm(w.store(), rank, survivors, timeout=30.0,
                                               generation=1)
                local_cb.rebuild_group(new_comm)
                assert mgr.replication.my_group == survivors

                ctx = LoopContext()
                ctx.state = _init_state()
                # Local tier: gone beyond coverage — the seam must say so.
                assert local_cb.restore_latest(ctx) is False
                # Same seam, next tier down: DCP restores step 2 (w=3).
                dcp_cb = DcpCheckpointCallback(dcp_dir, every=3 if rank == 0 else 0,
                                               collective=False)
                assert dcp_cb.restore_latest(ctx) is True
                assert ctx.start_step == 3
                np.testing.assert_array_equal(ctx.state["w"].numpy(), np.full((4,), 3.0))

                cbs = [local_cb] + ([dcp_cb] if rank == 0 else [])
                ctx = run_training(_step_fn, ctx.state, num_steps=6, callbacks=cbs, ctx=ctx)
                assert float(ctx.state["w"][0]) == 6.0

                # The local tier is repopulated over the rebuilt group: find_latest
                # agrees at 6, and every survivor holds its own shard AND its clique
                # peer's mirror.
                assert mgr.find_latest() == 6
                held = {i.owner for i in mgr.local_ids() if i.iteration == 6}
                assert held == set(survivors), held
                tree, _ = mgr.load_tree(6, device="cpu")
                np.testing.assert_array_equal(tree["w"].numpy(), np.full((4,), 6.0))
                dcp_cb.close()
                mgr.close()
            finally:
                ex.close()

        run_ranks(survivors, restart_phase, timeout=240.0)
    finally:
        w.close()

    # The repopulated local tier is the reference's format: its manager loads it.
    ref = pkgs["ref"]
    mgr = ref.local.LocalCheckpointManager(node_dir(0), rank=0)
    try:
        tree, _ = mgr.load_tree(6)
        np.testing.assert_array_equal(np.asarray(tree["w"]), np.full((4,), 6.0))
    finally:
        mgr.close()


def test_the_dcp_files_are_not_orbax_files(tmp_path):
    """The global tier's layout is DCP's: no orbax metadata, so a reference orbax
    manager finds no step in it."""
    cb = DcpCheckpointCallback(str(tmp_path / "dcp"), every=1)
    run_training(_step_fn, _init_state(), num_steps=1, callbacks=[cb])
    cb.close()
    names = {p.name for p in (tmp_path / "dcp").rglob("*")}
    assert ".metadata" in names and not any("orbax" in n or n == "_CHECKPOINT_METADATA"
                                            for n in names), names
    ocp = pytest.importorskip("orbax.checkpoint")
    mgr = ocp.CheckpointManager(str(tmp_path / "dcp"))
    try:
        assert mgr.latest_step() is None
    finally:
        mgr.close()
