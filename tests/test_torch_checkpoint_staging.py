"""The port's staging pool (``tpu_resiliency_torch/checkpoint/staging.py``) held against
the JAX package's (``tests/checkpoint/test_staging.py``).

Every scenario runs on both pools with the same seeded leaves: hits, misses, byte
accounting, depth exhaustion and trimming must agree step for step. The port's
leases are one ``torch.uint8`` buffer (pinned when a card exists) with typed tensor
views on 64-byte-aligned windows.
"""

import threading
import time

import numpy as np
import pytest
import torch

from tests.torch_ckpt_util import bits, packages, same_bits
from tpu_resiliency_torch.checkpoint import format as ckpt_format
from tpu_resiliency_torch.checkpoint.staging import HostStagingPool, StagingLease, leaf_signature
from tpu_resiliency_torch.checkpoint.state_dict import leaf_specs, to_numpy
from tpu_resiliency_torch.exceptions import CheckpointError

PKG = packages()


def pool_of(side, **kw):
    return PKG[side].staging.HostStagingPool(**kw)


def specs_for(side, *arrays):
    if side == "port":
        arrays = [torch.from_numpy(np.array(a)) for a in arrays]
    return PKG[side].sd.leaf_specs(list(arrays))


def stats(pool):
    return {k: v for k, v in pool.stats().items()}


def test_signature_covers_shape_and_dtype_as_the_reference():
    leaves = [(np.zeros((4, 4), np.float32), np.zeros(3, np.int32)),
              (np.zeros((4, 4), np.float16), np.zeros(3, np.int32))]
    for a in leaves:
        assert leaf_signature(specs_for("port", *a)) == PKG["ref"].staging.leaf_signature(
            specs_for("ref", *a))
    assert leaf_signature(specs_for("port", *leaves[0])) != leaf_signature(
        specs_for("port", *leaves[1]))


SCENARIOS = ["miss_then_hits", "steady_state", "distinct_signatures", "release_idempotent",
             "trim"]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_pool_accounting_equals_the_reference(scenario):
    def run(side):
        trail = []
        if scenario == "miss_then_hits":
            pool = pool_of(side, depth=2)
            specs = specs_for(side, np.zeros((8, 8), np.float32))
            lease = pool.acquire(specs)
            trail.append(stats(pool))
            lease.release()
            lease2 = pool.acquire(specs)
            trail.append(stats(pool))
            assert pool.stats()["in_use_bytes"] >= lease2.nbytes
            lease2.release()
        elif scenario == "steady_state":
            pool = pool_of(side, depth=2)
            specs = specs_for(side, np.zeros((1 << 14,), np.float32), np.zeros(7, np.int32))
            a, b = pool.acquire(specs), pool.acquire(specs)
            a.release(), b.release()
            for _ in range(6):
                pool.acquire(specs).release()
                trail.append(stats(pool))
        elif scenario == "distinct_signatures":
            pool = pool_of(side, depth=1)
            l1 = pool.acquire(specs_for(side, np.zeros(4, np.float32)))
            l2 = pool.acquire(specs_for(side, np.zeros(8, np.float32)))
            l1.release(), l2.release()
        elif scenario == "release_idempotent":
            pool = pool_of(side, depth=2)
            lease = pool.acquire(specs_for(side, np.zeros(4, np.float32)))
            lease.release()
            lease.release()
        else:
            pool = pool_of(side, depth=2)
            specs = specs_for(side, np.zeros((64,), np.float32))
            pool.acquire(specs).release()
            trail.append(pool.trim())
            pool.acquire(specs).release()
        trail.append(stats(pool))
        return trail

    assert run("port") == run("ref")


@pytest.mark.parametrize("side", ["ref", "port"])
def test_depth_exhaustion_blocks_then_times_out(side):
    pool = pool_of(side, depth=1)
    specs = specs_for(side, np.zeros(16, np.float32))
    lease = pool.acquire(specs)
    got = []
    t = threading.Thread(target=lambda: got.append(pool.acquire(specs)), daemon=True)
    t.start()
    time.sleep(0.1)
    assert not got, "a second lease must wait for a release"
    lease.release()
    t.join(timeout=5.0)
    assert got and got[0].nbytes == lease.nbytes
    err = PKG[side].staging.CheckpointError
    with pytest.raises(err, match="still leased"):
        pool.acquire(specs, timeout=0.1)
    got[0].release()


def test_fill_round_trips_through_the_container_as_the_references(tmp_path):
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((3, 4)).astype(np.float32), np.arange(5, dtype=np.int32),
              rng.standard_normal((7,)).astype(np.float16)]
    files = {}
    for side in ("ref", "port"):
        pool = pool_of(side)
        lease = pool.acquire(specs_for(side, *arrays))
        for i, a in enumerate(arrays):
            staged = lease.fill(i, a if side == "ref" else torch.from_numpy(a.copy()))
            assert same_bits(staged, a)
        views = lease.views if side == "ref" else [to_numpy(v) for v in lease.views]
        prefix, parts = PKG[side].format.serialize_parts(b"h", views)
        files[side] = str(tmp_path / f"{side}.ckpt")
        PKG[side].format.write_parts(files[side], [prefix, *parts])
        lease.release()
    with open(files["ref"], "rb") as a, open(files["port"], "rb") as b:
        assert a.read() == b.read()
    _, tensors, _ = ckpt_format.read_payload(files["port"])
    for got, want in zip(tensors, arrays):
        assert same_bits(got, want)


def test_fill_bfloat16_and_numpy_sources():
    src = torch.arange(8, dtype=torch.float32).to(torch.bfloat16)
    scalar = np.asarray(2.5, np.float32)  # a 0-d host leaf keeps its shape
    pool = HostStagingPool()
    lease = pool.acquire(leaf_specs([src, src, torch.from_numpy(scalar)]))
    assert lease.fill(0, src).dtype == torch.bfloat16
    lease.fill(1, to_numpy(src))  # a host array tagged bfloat16
    for i in (0, 1):
        assert same_bits(lease.views[i], src)
        assert bytes(lease.raw_views[i]) == bits(src).tobytes()
    assert lease.fill(2, scalar).shape == () and same_bits(lease.views[2], scalar)
    lease.release()


def test_fill_rejects_size_mismatch():
    for side in ("ref", "port"):
        pool = pool_of(side)
        lease = pool.acquire(specs_for(side, np.zeros(8, np.float32)))
        nine = np.zeros(9, np.float32)
        with pytest.raises(PKG[side].staging.CheckpointError, match="signature says"):
            lease.fill(0, nine if side == "ref" else torch.from_numpy(nine))
        lease.release()


def test_views_are_aligned():
    lease = HostStagingPool().acquire(
        leaf_specs([torch.zeros(3, dtype=torch.int8), torch.zeros(4, dtype=torch.float64),
                    torch.zeros((), dtype=torch.bfloat16), torch.zeros(0)]))
    for v, raw in zip(lease.views, lease.raw_views):
        assert v.data_ptr() % 64 == 0
        assert np.frombuffer(raw, np.uint8).__array_interface__["data"][0] == v.data_ptr() \
            or v.numel() == 0
    assert [tuple(v.shape) for v in lease.views] == [(3,), (4,), (), (0,)]
    lease.release()


def test_leases_are_pinned_exactly_when_a_card_exists(monkeypatch):
    specs = leaf_specs([torch.zeros(4)])
    for lease in (StagingLease.unpooled(specs), HostStagingPool().acquire(specs)):
        assert lease.pinned == torch.cuda.is_available()
        lease.release()
    if torch.cuda.is_available():
        return
    # A failed pinned allocation is a checkpoint error, never a quiet unpinned buffer.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(CheckpointError, match="pinned host memory"):
        HostStagingPool().acquire(specs)


@pytest.mark.gpu
def test_card_leaves_stage_through_pinned_memory_with_events():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pool = HostStagingPool()
    src = torch.randn(1 << 16, device="cuda").to(torch.bfloat16)
    lease = pool.acquire(leaf_specs([src]))
    assert lease.pinned
    lease.fill(0, src)
    lease.wait(0)
    assert same_bits(lease.views[0], src)
    lease.release()
    pool.acquire(leaf_specs([src])).release()
    assert (pool.hits, pool.misses) == (1, 1)
