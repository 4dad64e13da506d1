"""The port's rings (``tpu_resiliency_torch.telemetry.ring_buffer``) and name registry
held against the JAX package's: ``tpu_resiliency.telemetry.ring_buffer`` with its
numpy path (``native=False``) as the oracle for the host rings, and its JAX
``DeviceRings`` for the device rings.

Seeded samples go through both. Linearized samples, counts, cursors and masks must
be equal exactly; the stats are numpy over the same float64 samples on both sides,
so they must be equal exactly too.
"""

import numpy as np
import pytest
import torch

from tpu_resiliency.telemetry import ring_buffer as ref_rb
from tpu_resiliency.telemetry.name_registry import NameRegistry as RefNameRegistry
from tpu_resiliency_torch.telemetry import ring_buffer as rb
from tpu_resiliency_torch.telemetry.name_registry import NameRegistry


@pytest.mark.parametrize("capacity,n_samples", [(1, 5), (4, 3), (4, 4), (16, 37), (128, 300)])
def test_signal_rings_match_the_numpy_reference_across_wraps_and_resets(capacity, n_samples):
    rng = np.random.default_rng(capacity * 1000 + n_samples)
    ours, ref = rb.SignalRings(3, capacity), ref_rb.SignalRings(3, capacity, native=False)
    assert not ours.native and not ref.native
    for phase in range(3):
        for i in range(3):
            samples = rng.uniform(1e-4, 0.1, n_samples + i)
            if phase == 1:
                ours.extend(i, samples)
                ref.extend(i, samples)
            else:
                for v in samples:
                    ours.push(i, float(v))
                    ref.push(i, float(v))
        for i in range(3):
            assert ours.count(i) == ref.count(i)
            np.testing.assert_array_equal(ours.linearize(i), ref.linearize(i))
            assert ours.stats(i) == ref.stats(i)
        ours.reset(phase % 3)
        ref.reset(phase % 3)
        assert ours.count(phase % 3) == ref.count(phase % 3) == 0
    ours.reset_all()
    ref.reset_all()
    for i in range(3):
        with pytest.raises(ValueError):
            ours.stats(i)


def test_host_ring_buffer_wraps_and_resets_as_the_reference():
    for ring in (rb.HostRingBuffer(4), ref_rb.HostRingBuffer(4, native=False)):
        for v in range(6):
            ring.push(float(v))
        assert len(ring) == 4 and ring.capacity == 4
        np.testing.assert_array_equal(ring.linearize(), [2.0, 3.0, 4.0, 5.0])
        ring.reset()
        ring.extend([9.0, 1.0, 3.0, 10.0])
        assert ring.stats()["median"] == 6.0


def test_views_share_the_pool_and_check_their_index():
    rings = rb.SignalRings(2, 4)
    a, b = rings.view(0), rings.view(1)
    a.push(1.0)
    b.extend([2.0, 3.0])
    assert (len(a), len(b)) == (1, 2)
    with pytest.raises(IndexError):
        rings.view(2)
    with pytest.raises(ValueError):
        rb.SignalRings(0, 4)


def test_native_rings_are_not_ported():
    with pytest.raises(RuntimeError, match="not ported"):
        rb.HostRingBuffer(4, native=True)


@pytest.mark.parametrize("capacity,pushes", [(4, 3), (4, 6), (5, 13)])
def test_device_rings_match_the_jax_rings_past_capacity(capacity, pushes):
    rng = np.random.default_rng(pushes)
    rows = rng.uniform(0.0, 1.0, (pushes, 3)).astype(np.float32)
    ref = ref_rb.DeviceRings.create(n_signals=3, capacity=capacity)
    ours = rb.DeviceRings.create(n_signals=3, capacity=capacity, device="cpu")
    for row in rows:
        ref = ref.push_row(row)
        assert ours.push_row(torch.from_numpy(row)) is ours
    np.testing.assert_array_equal(ours.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(ours.counts.numpy(), np.asarray(ref.counts))
    assert int(ours.cursor) == int(ref.cursor) == pushes
    np.testing.assert_array_equal(ours.valid_mask().numpy(), np.asarray(ref.valid_mask()))
    ref, ours = ref.reset(), ours.reset()
    np.testing.assert_array_equal(ours.valid_mask().numpy(), np.asarray(ref.valid_mask()))
    ref = ref.push_row(rows[0])
    ours.push_row(rows[0])  # numpy rows are taken too
    np.testing.assert_array_equal(ours.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(ours.counts.numpy(), np.asarray(ref.counts))


def test_device_rings_default_to_the_card():
    if torch.cuda.is_available():
        assert rb.DeviceRings.create(2, 4).data.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rb.DeviceRings.create(2, 4)


@pytest.mark.gpu
def test_device_rings_on_the_card_match_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rows = np.random.default_rng(3).uniform(0, 1, (11, 5)).astype(np.float32)
    gpu = rb.DeviceRings.create(5, 4, device="cuda")
    cpu = rb.DeviceRings.create(5, 4, device="cpu")
    for row in rows:
        gpu.push_row(torch.from_numpy(row).cuda())
        cpu.push_row(row)
    np.testing.assert_array_equal(gpu.data.cpu().numpy(), cpu.data.numpy())
    assert int(gpu.cursor) == int(cpu.cursor) == 11


def test_name_registry_matches_the_reference(coord_store):
    ours = [NameRegistry(8), NameRegistry(8)]
    refs = [RefNameRegistry(8), RefNameRegistry(8)]
    for regs, key in ((ours, "port/names"), (refs, "ref/names")):
        regs[0].get("x")
        regs[0].get("a")
        regs[1].get("y")
        for reg in regs:
            reg.publish(coord_store, key=key)
        for reg in regs:
            reg.merge(coord_store, key=key)
    for a, b in zip(ours, refs):
        assert a.index_map() == b.index_map() and a.names() == b.names()
    full = NameRegistry(1)
    full.get("a")
    with pytest.raises(ValueError, match="registry full"):
        full.get("b")
