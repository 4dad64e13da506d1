"""The port's local checkpoint manager, clique replication and async callers held
against the JAX package's (``tests/checkpoint/test_local.py``).

Ranks are threads, each with its own store client and peer exchange against one
``KVServer`` of its package, as the reference's tests run them. Each scenario runs
in a world of the reference and a world of the port on the same seeded shards and
must end the same; one world mixes the packages, a rank of each.
"""

import os
import shutil
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_ckpt_util import World, packages, run_ranks
from tpu_resiliency_torch.checkpoint import async_core
from tpu_resiliency_torch.checkpoint import format as ckpt_format
from tpu_resiliency_torch.checkpoint.async_core import AsyncRequest, ForkAsyncCaller
from tpu_resiliency_torch.checkpoint.local_manager import CkptID, LocalCheckpointManager
from tpu_resiliency_torch.exceptions import CheckpointError

PKG = packages()


def shard(side, rank, it=0):
    v = np.random.default_rng(100 * rank + it).standard_normal((4, 3)).astype(np.float32)
    leaf = jnp.asarray(v) if side == "ref" else torch.from_numpy(v)
    return PKG[side].sd.PyTreeStateDict({"w": leaf, "step": rank})


def want(rank, it=0):
    return np.random.default_rng(100 * rank + it).standard_normal((4, 3)).astype(np.float32)


@pytest.mark.parametrize("side", ["ref", "port"])
def test_single_rank_roundtrip_prune_and_dirty_cleanup(tmp_path, side):
    Manager = PKG[side].local.LocalCheckpointManager
    mgr = Manager(str(tmp_path), rank=0)
    mgr.save(10, shard(side, 0), is_async=True)
    mgr.maybe_finalize(blocking=True)
    assert mgr.find_latest() == 10
    hollow, tensors, meta = mgr.load(10)
    assert meta["iteration"] == 10 and hollow["step"] == 0
    assert np.array_equal(np.asarray(tensors[0]), want(0))
    mgr.save(11, shard(side, 0, 1), is_async=False)
    assert {i.iteration for i in mgr.local_ids()} == {11}
    dirty = mgr._path(PKG[side].local.CkptID(9, 0)) + ckpt_format.DIRTY_SUFFIX
    with open(dirty, "wb") as f:
        f.write(b"junk")
    mgr.close()
    again = Manager(str(tmp_path), rank=0)
    assert not os.path.exists(dirty) and again.find_latest() == 11
    again.close()


def run_world(side, root, world, body, server_side=None):
    w = World(PKG[server_side or side])
    try:
        return run_ranks(world, lambda r: body(w, r), timeout=120.0)
    finally:
        w.close()


@pytest.mark.parametrize("side", ["ref", "port"])
def test_distributed_save_load_with_replication(tmp_path, side):
    world = [0, 1, 2, 3]

    def body(w, rank):
        mgr, ex = w.manager(str(tmp_path), rank, world)
        try:
            mgr.save(5, shard(side, rank), is_async=True)
            mgr.maybe_finalize(blocking=True)
            latest = mgr.find_latest()
            _, tensors, _ = mgr.load(latest)
            held = sorted((i.iteration, i.owner) for i in mgr.local_ids())
            return latest, np.asarray(tensors[0]).tobytes(), held
        finally:
            mgr.close()
            ex.close()

    out = run_world(side, str(tmp_path), world, body)
    assert [o[0] for o in out] == [5] * 4
    assert [o[1] for o in out] == [want(r).tobytes() for r in world]
    # Cliques of two: each rank holds its own shard and its partner's.
    assert [o[2] for o in out] == [[(5, 0), (5, 1)], [(5, 0), (5, 1)], [(5, 2), (5, 3)],
                                   [(5, 2), (5, 3)]]


@pytest.mark.parametrize("sides", [("ref", "ref"), ("port", "port"), ("ref", "port"),
                                   ("port", "ref")])
def test_lost_rank_recovers_from_its_mirror(tmp_path, sides):
    """Rank 1's storage is wiped after the save; its load routes the shard from rank
    0's mirror. ``("ref", "port")`` is one world of both packages: rank 0 runs the
    JAX package's manager and rank 1 the port's, on one store."""
    world = [0, 1]
    root = str(tmp_path)

    def save(w, rank):
        mgr, ex = w.manager(root, rank, world, pkg=PKG[sides[rank]])
        try:
            mgr.save(3, shard(sides[rank], rank), is_async=False)
        finally:
            mgr.close()
            ex.close()

    def load(w, rank):
        mgr, ex = w.manager(root, rank, world, pkg=PKG[sides[rank]])
        try:
            latest = mgr.find_latest()
            _, tensors, _ = mgr.load(latest)
            return latest, np.asarray(tensors[0]).tobytes()
        finally:
            mgr.close()
            ex.close()

    run_world(sides[0], root, world, save)
    mirror = os.path.join(root, "s0", "r0", "iter_0000003_1_local.ckpt")
    with open(mirror, "rb") as f:
        mirrored = f.read()
    shutil.rmtree(os.path.join(root, "s0", "r1"))
    assert run_world(sides[0], root, world, load) == [(3, want(0).tobytes()),
                                                      (3, want(1).tobytes())]
    with open(os.path.join(root, "s0", "r1", "iter_0000003_1_local.ckpt"), "rb") as f:
        assert f.read() == mirrored


def test_load_tree_defaults_to_the_card(tmp_path):
    mgr = LocalCheckpointManager(str(tmp_path), rank=0)
    mgr.save(1, shard("port", 0), is_async=False)
    if torch.cuda.is_available():
        assert mgr.load_tree(1)[0]["w"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mgr.load_tree(1)
    tree, meta = mgr.load_tree(1, device="cpu")
    assert np.array_equal(tree["w"].numpy(), want(0)) and meta["iteration"] == 1
    mgr.close()


def test_fork_guard_reads_whether_cuda_is_initialised(monkeypatch):
    assert async_core._cuda_initialized() == torch.cuda.is_initialized()
    monkeypatch.setattr(async_core, "_cuda_initialized", lambda: True)
    with pytest.raises(CheckpointError, match="initialized CUDA"):
        ForkAsyncCaller().schedule(AsyncRequest(async_fn=lambda: None))
    # The reference refuses over a live JAX backend with the same message shape.
    import jax

    jax.devices()
    from tpu_resiliency.checkpoint.async_core import AsyncRequest as RefRequest
    from tpu_resiliency.checkpoint.async_core import ForkAsyncCaller as RefFork
    from tpu_resiliency.exceptions import CheckpointError as RefError

    with pytest.raises(RefError, match="refusing to fork a checkpoint writer"):
        RefFork().schedule(RefRequest(async_fn=lambda: None))
    with pytest.raises(CheckpointError, match="refusing to fork a checkpoint writer"):
        async_core.AsyncCallsQueue(caller="fork").schedule_async_request(
            AsyncRequest(async_fn=lambda: None))


def _touch_file(path):
    with open(path, "w") as f:
        f.write("ok")


def test_fork_guard_override_forks(tmp_path, monkeypatch):
    monkeypatch.setattr(async_core, "_cuda_initialized", lambda: True)
    marker = tmp_path / "wrote"
    caller = ForkAsyncCaller(unsafe_allow_fork_with_backend=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # multithreaded fork
        warnings.simplefilter("ignore", RuntimeWarning)
        caller.schedule(AsyncRequest(async_fn=_touch_file, async_fn_args=(str(marker),)))
    assert caller.wait(timeout=30.0)
    caller.raise_if_failed()
    assert marker.exists()


def test_manager_id_and_paths_match_the_reference(tmp_path):
    ref = PKG["ref"].local.CkptID(12, 3, 1)
    assert CkptID(12, 3, 1).filename() == ref.filename() == "iter_0000012_3_local.ckpt"
    mgr = LocalCheckpointManager(str(tmp_path), rank=2, session=1)
    assert mgr._path(CkptID(12, 3, 1)) == os.path.join(str(tmp_path), "s1", "r2",
                                                      ref.filename())
    mgr.close()
