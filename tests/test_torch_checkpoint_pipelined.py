"""The port's pipelined save (``HostSnapshot``, the staging pool, the leaf-streaming
background half of ``AsyncCheckpointer`` and ``LocalCheckpointManager``) held against
the JAX package's (``tests/checkpoint/test_pipelined_save.py``).

The trap this file holds: a torch tensor changes in place. A save must write the
values at the moment of ``save()`` although every leaf is updated in place right
after it returns. On the CPU that holds the design's ordering (the snapshot is taken
at the call); the ``gpu``-marked tests hold the card's (a clone on the current
stream, copies to pinned memory on a side stream, one event per leaf), with the
helpers ``chip_smoke.py``'s ``checkpoint_path`` uses.
"""

import os
import shutil
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.torch_ckpt_util import World, bits, packages, run_ranks, same_bits
from tpu_resiliency.checkpoint.async_ckpt import AsyncCheckpointer as RefCheckpointer
from tpu_resiliency.checkpoint.local_manager import LocalCheckpointManager as RefManager
from tpu_resiliency.checkpoint.state_dict import PyTreeStateDict as RefStateDict
from tpu_resiliency_torch.checkpoint.async_ckpt import AsyncCheckpointer
from tpu_resiliency_torch.checkpoint.local_manager import LocalCheckpointManager
from tpu_resiliency_torch.checkpoint.staging import HostStagingPool
from tpu_resiliency_torch.checkpoint.state_dict import PyTreeStateDict, tree_flatten
from tpu_resiliency_torch.exceptions import CheckpointError

PKG = packages()


def seeded_tree(seed, lib):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    m = rng.standard_normal((64, 32)).astype(np.float32)
    b = rng.standard_normal((33,)).astype(np.float32)
    if lib == "jax":
        return {"params": {"w": jnp.asarray(w), "b": jnp.asarray(b).astype(jnp.bfloat16)},
                "opt": {"m": jnp.asarray(m)}, "step": seed}
    return {"params": {"w": torch.from_numpy(w), "b": torch.from_numpy(b).to(torch.bfloat16)},
            "opt": {"m": torch.from_numpy(m)}, "step": seed}


def tensor_leaves(tree):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def update_in_place(tree, seed):
    gen = torch.Generator().manual_seed(seed)
    for t in tensor_leaves(tree):
        t.add_(torch.randn(t.shape, generator=gen).to(t.dtype))


def test_pipelined_containers_equal_the_references(tmp_path):
    ref = RefCheckpointer()
    port = AsyncCheckpointer()
    assert ref.pipelined and port.pipelined
    ref.async_save(seeded_tree(3, "jax"), str(tmp_path / "ref.ckpt"), meta={"iteration": 3})
    port.async_save(seeded_tree(3, "torch"), str(tmp_path / "port.ckpt"), meta={"iteration": 3})
    ref.finalize_all(), port.finalize_all()
    with open(tmp_path / "ref.ckpt", "rb") as a, open(tmp_path / "port.ckpt", "rb") as b:
        assert a.read() == b.read()
    ref.close(), port.close()


def test_roundtrip_and_steady_state_pool_hit(tmp_path):
    ckpt = AsyncCheckpointer()
    for step in range(3):
        ckpt.async_save(seeded_tree(step, "torch"), str(tmp_path / f"s{step}.ckpt"))
        ckpt.finalize_all()
    misses = ckpt.staging.misses
    ckpt.async_save(seeded_tree(9, "torch"), str(tmp_path / "steady.ckpt"))
    ckpt.finalize_all()
    assert ckpt.staging.misses == misses and ckpt.staging.hits >= 1
    loaded, _ = AsyncCheckpointer.load(str(tmp_path / "steady.ckpt"), device="cpu")
    for got, want in zip(tensor_leaves(loaded), tensor_leaves(seeded_tree(9, "torch"))):
        assert same_bits(got, want)
    assert loaded["step"] == 9
    ckpt.close()


@pytest.mark.parametrize("engine", ["checkpointer", "manager_pipelined", "manager_blocking"])
def test_in_place_updates_after_save_do_not_reach_the_container(tmp_path, engine):
    """Save, then update every leaf in place before the background half has run:
    the container holds the values at ``save()``."""
    tree = seeded_tree(5, "torch")
    want = [t.clone() for t in tensor_leaves(tree)]
    if engine == "checkpointer":
        ckpt = AsyncCheckpointer()
        ckpt.async_save(tree, str(tmp_path / "c.ckpt"))
        update_in_place(tree, 1)
        ckpt.finalize_all()
        loaded, _ = AsyncCheckpointer.load(str(tmp_path / "c.ckpt"), device="cpu")
        ckpt.close()
    else:
        mgr = LocalCheckpointManager(str(tmp_path), rank=0,
                                     pipelined=engine == "manager_pipelined")
        mgr.save(1, PyTreeStateDict(tree), is_async=True)
        update_in_place(tree, 1)
        mgr.maybe_finalize(blocking=True)
        loaded, _ = mgr.load_tree(1, device="cpu")
        mgr.close()
    got = tensor_leaves(loaded)
    assert all(same_bits(g, w) for g, w in zip(got, want))
    assert not any(same_bits(g, t) for g, t in zip(got, tensor_leaves(tree)))


def test_host_snapshot_resolves_in_any_order_and_aliases_its_lease():
    sd = PyTreeStateDict({"a": torch.arange(4.0), "b": torch.arange(3.0)})
    sd.pop_tensors()
    snap = sd.copy_tensors_to_host_async()
    assert snap.nbytes == 28
    b, a = snap.resolve(1), snap.resolve(0)
    assert np.array_equal(a, np.arange(4, dtype=np.float32))
    assert np.array_equal(b, np.arange(3, dtype=np.float32))
    snap.release()
    ref = RefStateDict({"a": jnp.arange(4.0), "b": jnp.arange(3.0)})
    ref.pop_tensors()
    assert ref.copy_tensors_to_host_async().specs == snap.specs

    pool = HostStagingPool()
    sd = PyTreeStateDict({"a": torch.arange(16.0)})
    sd.pop_tensors()
    snap = sd.copy_tensors_to_host_async(pool=pool)
    arr, view = snap.resolve(0), snap.resolve_view(0)
    assert view.nbytes == arr.nbytes and bytes(view) == arr.tobytes()
    assert pool.stats()["in_use_bytes"] > 0
    snap.release()
    assert pool.stats()["in_use_bytes"] == 0
    snap.release()  # idempotent
    with pytest.raises(CheckpointError, match="after its release"):
        snap.resolve(0)


def test_pipelined_requires_the_thread_caller():
    with pytest.raises(CheckpointError, match="thread"):
        AsyncCheckpointer(caller="process", pipelined=True)
    with pytest.raises(CheckpointError, match="thread"):
        LocalCheckpointManager("/nonexistent-never-made", caller="process", pipelined=True)


def test_process_caller_falls_back_to_materialized(tmp_path):
    ckpt = AsyncCheckpointer(caller="process")
    assert not ckpt.pipelined
    ckpt.async_save({"x": torch.ones(4)}, str(tmp_path / "p.ckpt"))
    ckpt.finalize_all()
    tree, _ = AsyncCheckpointer.load(str(tmp_path / "p.ckpt"), device="cpu")
    assert torch.equal(tree["x"], torch.ones(4))
    ckpt.close()


def test_abandon_releases_the_staging_lease(tmp_path):
    ckpt = AsyncCheckpointer()
    ckpt.async_save(seeded_tree(0, "torch"), str(tmp_path / "a.ckpt"))
    ckpt.queue.abandon()
    deadline = time.monotonic() + 5.0
    while ckpt.staging.stats()["in_use_bytes"] and time.monotonic() < deadline:
        time.sleep(0.01)
    assert ckpt.staging.stats()["in_use_bytes"] == 0
    ckpt.close()


def test_leaf_streaming_clique_replication_equals_the_references(tmp_path):
    """Three ranks per package save two iterations each through the pipelined
    engine with full-mirror cliques: every rank holds every owner's shard of the
    newest iteration, byte-identical to the reference world's, and the second save
    is a pool hit."""
    world = [0, 1, 2]

    def run(side):
        w = World(PKG[side])
        root = str(tmp_path / side)

        def body(rank):
            mgr, ex = w.manager(root, rank, world, factor=len(world))
            try:
                assert mgr.pipelined
                for it in (1, 2):
                    rng = np.random.default_rng(rank * 10 + it)
                    v = rng.standard_normal((1 << 12,)).astype(np.float32)
                    leaf = jnp.asarray(v) if side == "ref" else torch.from_numpy(v)
                    mgr.save(it, PKG[side].sd.PyTreeStateDict({"w": leaf, "step": it}))
                    mgr.maybe_finalize(blocking=True)
                held = sorted((i.iteration, i.owner) for i in mgr.local_ids())
                return held, mgr.staging.hits, mgr.staging.misses
            finally:
                mgr.close()
                ex.close()

        try:
            return run_ranks(world, body), root
        finally:
            w.close()

    (ref_out, ref_root), (port_out, port_root) = run("ref"), run("port")
    assert port_out == ref_out
    assert all(held == [(2, o) for o in world] and hits >= 1 and misses == 1
               for held, hits, misses in port_out)
    for holder in world:
        for owner in world:
            name = f"s0/r{holder}/iter_0000002_{owner}_local.ckpt"
            with open(os.path.join(ref_root, name), "rb") as a, \
                    open(os.path.join(port_root, name), "rb") as b:
                assert a.read() == b.read(), name


def test_manager_containers_load_across_the_packages(tmp_path):
    ref = RefManager(str(tmp_path / "ref"), rank=0)
    ref.save(4, RefStateDict(seeded_tree(4, "jax")), is_async=True)
    ref.maybe_finalize(blocking=True)
    port = LocalCheckpointManager(str(tmp_path / "port"), rank=0)
    port.save(4, PyTreeStateDict(seeded_tree(4, "torch")), is_async=True)
    port.maybe_finalize(blocking=True)
    want = tensor_leaves(seeded_tree(4, "torch"))
    for root in ("ref", "port"):
        got, meta = LocalCheckpointManager(str(tmp_path / root), rank=0).load_tree(
            4, device="cpu")
        assert meta["iteration"] == 4 and all(
            same_bits(g, w) for g, w in zip(tensor_leaves(got), want))
        tree, _ = RefManager(str(tmp_path / root), rank=0).load_tree(4)
        assert [bits(x).tobytes() for x in (tree["opt"]["m"], tree["params"]["b"],
                                             tree["params"]["w"])] == [
            bits(x).tobytes() for x in want]
    ref.close(), port.close()


# -- on the card -----------------------------------------------------------------

SMALL = dict(n_layers=1, d=64, q=64, kv=16, ff=96, vocab=200, embed_rows=24, head_rows=8,
             norm=8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_pipelined_saves_hold_the_values_at_save(cuda, tmp_path):
    """Three pipelined saves one step apart, every leaf updated in place right after
    each ``save()``: each container loads bit-identical to a host copy taken at its
    save, onto the card; the pool misses at most twice and then hits; device memory
    comes back."""
    state = chip_smoke.ckpt_state(torch, chip_smoke.llama_shard_shapes(**SMALL), seed=1,
                                  device=cuda)
    mgr = LocalCheckpointManager(str(tmp_path), rank=0, keep=3)
    before = torch.cuda.memory_allocated()
    copies = {}
    for it in (1, 2, 3):
        copies[it] = chip_smoke.ckpt_host_copy(torch, state)
        mgr.save(it, PyTreeStateDict(state), is_async=True)
        chip_smoke.ckpt_step(torch, state, seed=100 + it)
    mgr.maybe_finalize(blocking=True)
    torch.cuda.synchronize()
    assert abs(torch.cuda.memory_allocated() - before) <= 1 << 20
    assert mgr.staging.hits >= 1 and mgr.staging.misses <= 2
    for it in (1, 2, 3):
        tree, _ = mgr.load_tree(it)
        assert all(t.is_cuda for t in tensor_leaves(tree))
        chip_smoke.ckpt_assert_equal(torch, tree, copies[it], f"iteration {it}")
    mgr.close()


@pytest.mark.gpu
def test_card_blocking_copy_and_restore(cuda, tmp_path):
    state = chip_smoke.ckpt_state(torch, chip_smoke.llama_shard_shapes(**SMALL), seed=2,
                                  device=cuda)
    copy = chip_smoke.ckpt_host_copy(torch, state)
    sd = PyTreeStateDict(state)
    sd.pop_tensors()
    sd.copy_tensors_to_host()
    assert all(isinstance(t, np.ndarray) for t in sd.tensors())
    mgr = LocalCheckpointManager(str(tmp_path), rank=0, pipelined=False)
    mgr.save(1, sd, is_async=False)
    tree, _ = mgr.load_tree(1)
    chip_smoke.ckpt_assert_equal(torch, tree, copy, "blocking")
    shutil.rmtree(tmp_path / "s0")
    mgr.close()
