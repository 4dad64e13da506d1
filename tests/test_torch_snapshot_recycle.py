"""The pipelined save's snapshot of CPU leaves into recycled staging buffers
(``HostSnapshot``, ``HostStagingPool.try_acquire``), held against the JAX package's
snapshot (``tpu_resiliency/checkpoint/state_dict.py``) and its containers.

A CPU tensor can change in place right after ``save()``, so its bytes are copied in the
foreground. The copy goes into a released buffer set of the tree's signature when the
engine's pool holds one (no allocation), and into a fresh clone otherwise; the
foreground neither allocates a pool buffer nor waits for one.
"""

import threading

import numpy as np
import pytest
import torch

from tests.torch_ckpt_util import bits, make_tree, same_bits
from tpu_resiliency.checkpoint.async_ckpt import AsyncCheckpointer as RefCheckpointer
from tpu_resiliency.checkpoint.state_dict import PyTreeStateDict as RefStateDict
from tpu_resiliency_torch.checkpoint import staging
from tpu_resiliency_torch.checkpoint.async_ckpt import AsyncCheckpointer
from tpu_resiliency_torch.checkpoint.local_manager import LocalCheckpointManager
from tpu_resiliency_torch.checkpoint.staging import HostStagingPool
from tpu_resiliency_torch.checkpoint.state_dict import PyTreeStateDict, tree_flatten


def tensor_leaves(tree):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def update_in_place(tree, seed):
    gen = torch.Generator().manual_seed(seed)
    for t in tensor_leaves(tree):
        if t.dtype == torch.bool:
            t.logical_not_()
        else:
            t.add_(torch.randint(1, 5, t.shape, generator=gen).to(t.dtype))


def snapshot(tree, pool):
    sd = PyTreeStateDict(tree)
    sd.pop_tensors()
    return sd.copy_tensors_to_host_async(pool=pool)


def reference_snapshot(seed):
    sd = RefStateDict(make_tree(seed, "jax"))
    sd.pop_tensors()
    return sd.copy_tensors_to_host_async()


@pytest.fixture
def counted_allocations(monkeypatch):
    """Counts of ``Tensor.clone`` calls and staging-pool allocations."""
    counts = {"clone": 0, "allocate": 0}
    clone, allocate = torch.Tensor.clone, staging._allocate

    def counting_clone(self, *a, **kw):
        counts["clone"] += 1
        return clone(self, *a, **kw)

    def counting_allocate(nbytes):
        counts["allocate"] += 1
        return allocate(nbytes)

    monkeypatch.setattr(torch.Tensor, "clone", counting_clone)
    monkeypatch.setattr(staging, "_allocate", counting_allocate)
    return counts


def test_the_second_save_reuses_the_first_saves_released_buffers(counted_allocations):
    pool = HostStagingPool()
    first = snapshot(make_tree(1, "torch"), pool)
    assert not first.recycled  # nothing released yet: cloned, the lease taken in the background
    first.resolve_all()
    backing = [v.data_ptr() for v in first._lease.views]
    first.release()
    assert pool.stats()["misses"] == 1 and counted_allocations["allocate"] == 1

    before = dict(counted_allocations)
    tree = make_tree(2, "torch")
    second = snapshot(tree, pool)
    assert second.recycled
    assert counted_allocations == before  # no clone, no pool allocation in the foreground
    stats = pool.stats()
    assert (stats["hits"], stats["misses"]) == (1, 1)
    assert [v.data_ptr() for v in second._lease.views] == backing

    update_in_place(tree, 9)  # after the snapshot: must not reach it
    want = reference_snapshot(2)
    assert second.specs == want.specs
    got = second.resolve_all()
    for g, w in zip(got, want.resolve_all()):
        assert same_bits(g, w)
    second.release()
    assert pool.stats()["in_use_bytes"] == 0


def test_with_every_set_still_leased_a_save_clones_fresh_and_does_not_block():
    pool = HostStagingPool(depth=2, timeout=30.0)
    held = []
    for seed in (1, 2):  # two saves whose background halves still hold their leases
        snap = snapshot(make_tree(seed, "torch"), pool)
        snap.resolve_all()
        held.append(snap)
    for snap in held:
        snap.release()
    held = [snapshot(make_tree(s, "torch"), pool) for s in (3, 4)]
    assert all(s.recycled for s in held) and pool.stats()["hits"] == 2

    made = {}
    thread = threading.Thread(target=lambda: made.update(snap=snapshot(make_tree(5, "torch"),
                                                                       pool)))
    thread.start()
    thread.join(timeout=10.0)
    assert not thread.is_alive(), "the foreground waited for a leased buffer"
    fresh = made["snap"]
    assert not fresh.recycled and pool.stats()["hits"] == 2

    resolved = {}
    background = threading.Thread(target=lambda: resolved.update(arrays=fresh.resolve_all()))
    background.start()  # its background half waits for a lease: none is free
    background.join(timeout=0.5)
    assert background.is_alive()
    held[0].release()
    background.join(timeout=30.0)
    assert not background.is_alive()
    for g, w in zip(resolved["arrays"], reference_snapshot(5).resolve_all()):
        assert same_bits(g, w)
    fresh.release()
    held[1].release()
    assert pool.stats()["in_use_bytes"] == 0


def test_a_recycled_set_takes_non_contiguous_leaves():
    pool = HostStagingPool()
    for i in range(2):
        base = torch.arange(24.0).reshape(4, 6) + i
        tree = {"t": base.t(), "row": base[:, 1]}  # a transpose and a strided column
        assert not (tree["t"].is_contiguous() or tree["row"].is_contiguous())
        snap = snapshot(tree, pool)
        assert snap.recycled == (i == 1)
        want = [np.array(tree["row"]), np.array(tree["t"])]
        update_in_place(tree, i)
        got = snap.resolve_all()
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
        snap.release()


@pytest.mark.parametrize("engine", ["checkpointer", "manager"])
def test_in_place_updates_after_a_recycled_save_never_reach_the_container(tmp_path, engine):
    """The second save of a signature rides a recycled set; every leaf is updated in
    place right after ``save()`` returns. The container holds the values at ``save()``:
    byte for byte the reference's container of the same tree (the checkpointer), the
    same bits when loaded (the manager)."""
    tree = make_tree(4, "torch")
    want = [t.clone() for t in tensor_leaves(tree)]
    if engine == "checkpointer":
        ckpt = AsyncCheckpointer()
        ckpt.async_save(make_tree(3, "torch"), str(tmp_path / "warm.ckpt"), meta={"iteration": 3})
        ckpt.finalize_all()
        ckpt.async_save(tree, str(tmp_path / "port.ckpt"), meta={"iteration": 4})
        update_in_place(tree, 1)
        ckpt.finalize_all()
        assert ckpt.staging.stats()["hits"] >= 1
        ckpt.close()
        ref = RefCheckpointer()
        ref.async_save(make_tree(4, "jax"), str(tmp_path / "ref.ckpt"), meta={"iteration": 4})
        ref.finalize_all()
        ref.close()
        assert (tmp_path / "port.ckpt").read_bytes() == (tmp_path / "ref.ckpt").read_bytes()
        loaded, _ = AsyncCheckpointer.load(str(tmp_path / "port.ckpt"), device="cpu")
    else:
        mgr = LocalCheckpointManager(str(tmp_path), rank=0, pipelined=True)
        mgr.save(1, PyTreeStateDict(make_tree(3, "torch")), is_async=True)
        mgr.maybe_finalize(blocking=True)
        mgr.save(2, PyTreeStateDict(tree), is_async=True)
        update_in_place(tree, 1)
        mgr.maybe_finalize(blocking=True)
        assert mgr.staging.stats()["hits"] >= 1
        loaded, _ = mgr.load_tree(2, device="cpu")
        mgr.close()
    got = tensor_leaves(loaded)
    assert len(got) == len(want)
    assert all(same_bits(g, w) for g, w in zip(got, want))
    assert not any(np.array_equal(bits(g), bits(t)) for g, t in zip(got, tensor_leaves(tree))
                   if t.numel())
