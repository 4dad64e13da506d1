"""The port's health checks, held against ``tests/watchdog/test_health.py``: its host
memory and interconnect-counter tests run here on ``tpu_resiliency_torch.watchdog``
(``torch_port_tests``). Its ``TpuRuntimeCheck`` class reads JAX's device list; the
port answers it with ``CudaRuntimeCheck``, tested here on injected device-count and
``mem_get_info`` functions (the CPU has neither), beside the reference check's
verdicts on the same scenarios. On the card (``gpu``): it passes healthy, fails once an
allocation puts the memory pressure past a threshold set just below it, and fails with
``expect_devices`` one past the count.
"""

import numpy as np
import pytest
import torch

import tpu_resiliency.watchdog as ref_watchdog
from tests.torch_port_tests import port_tests
from tpu_resiliency_torch.watchdog import (
    CudaRuntimeCheck,
    DeviceLivenessCheck,
    HostMemoryCheck,
    PeriodicHealthMonitor,
)

port_tests(
    "tests/watchdog/test_health.py", globals(),
    edits=[("from tpu_resiliency_torch.watchdog import HostMemoryCheck, IciLinkCheck, "
            "TpuRuntimeCheck",
            "from tpu_resiliency_torch.watchdog import HostMemoryCheck, IciLinkCheck",
            "the port has no TpuRuntimeCheck")],
    leave_out={"TestTpuRuntimeCheck": "reads JAX's devices; CudaRuntimeCheck's tests below "
                                      "answer it"},
)


def runtime(count=1, free=None, total=80 << 30, **kw):
    """A CPU CudaRuntimeCheck over an injected inventory: ``count`` devices, each with
    ``free[i]`` of ``total`` bytes free."""
    free = [total] * count if free is None else free
    return CudaRuntimeCheck(device="cpu", device_count=lambda: count,
                            mem_get_info=lambda i: (free[i], total), **kw)


class TestCudaRuntimeCheck:
    def test_healthy_inventory(self):
        check = runtime(count=2)
        assert check() is True and check.last_failure is None
        assert check.describe() == "CudaRuntimeCheck(ok)"

    def test_device_count_drop_detected_as_the_reference_does(self):
        check = runtime(count=1, expect_devices=2)
        assert check() is False
        assert "device count dropped" in check.last_failure
        assert "device count dropped" in check.describe()
        ref = ref_watchdog.TpuRuntimeCheck(expect_devices=9)  # the CPU platform has 8
        assert ref() is False and "device count dropped" in ref.last_failure

    def test_no_device_is_unhealthy(self):
        check = runtime(count=0)
        assert check() is False and check.last_failure == "no local devices visible"

    def test_enumeration_failure_is_unhealthy(self):
        def broken():
            raise RuntimeError("CUDA error: unspecified launch failure")

        check = CudaRuntimeCheck(device="cpu", device_count=broken,
                                 mem_get_info=lambda i: (1, 1))
        assert check() is False
        assert check.last_failure.startswith("device enumeration failed")

    def test_a_memory_query_that_raises_is_unhealthy(self):
        def sticky(index):
            raise RuntimeError("CUDA error: an illegal instruction was encountered")

        check = CudaRuntimeCheck(device="cpu", device_count=lambda: 1, mem_get_info=sticky)
        assert check() is False and "memory query of device 0" in check.last_failure

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_pressure_past_the_threshold_on_any_device(self, seed):
        rng = np.random.default_rng(seed)
        total = 80 << 30
        free = [int(x) for x in rng.integers(0, total, size=4)]
        threshold = float(rng.uniform(0.1, 0.9))
        check = runtime(count=4, free=free, total=total, hbm_usage_threshold=threshold)
        over = [i for i in range(4) if 1 - free[i] / total > threshold]
        assert check() is (not over)
        if over:
            assert f"on device {over[0]}" in check.last_failure
            assert str(total - free[over[0]]) in check.last_failure

    def test_threshold_is_strict(self):
        assert runtime(count=1, free=[20], total=100, hbm_usage_threshold=0.8)() is True
        assert runtime(count=1, free=[19], total=100, hbm_usage_threshold=0.8)() is False

    def test_the_cpu_needs_injected_functions(self):
        with pytest.raises(ValueError, match="needs device_count and mem_get_info"):
            CudaRuntimeCheck(device="cpu")

    def test_defaults_to_the_card(self):
        if torch.cuda.is_available():
            assert CudaRuntimeCheck().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                CudaRuntimeCheck()

    def test_polled_by_the_periodic_monitor(self):
        import threading

        fired = threading.Event()
        bad = runtime(count=1, expect_devices=2)
        mon = PeriodicHealthMonitor([runtime(count=1), bad], 0.02, lambda c: fired.set())
        mon.start()
        try:
            assert fired.wait(5.0)
        finally:
            mon.stop()
        assert "device count dropped" in bad.describe()


def test_device_liveness_check_probes_the_device_it_is_given():
    assert DeviceLivenessCheck(timeout=15.0, device="cpu")() is True
    if not torch.cuda.is_available():
        assert DeviceLivenessCheck(timeout=5.0)() is False  # the card, and there is none
    assert HostMemoryCheck(min_available_fraction=0.0)() is True


# -- on the card -----------------------------------------------------------------------


@pytest.mark.gpu
def test_cuda_runtime_check_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert CudaRuntimeCheck()() is True
    count = torch.cuda.device_count()
    check = CudaRuntimeCheck(expect_devices=count + 1)
    assert check() is False and "device count dropped" in check.last_failure
    free, total = torch.cuda.mem_get_info(0)
    block = torch.empty(int(free * 0.5), dtype=torch.uint8, device="cuda:0")
    try:
        free_after, _ = torch.cuda.mem_get_info(0)
        pressure = 1.0 - free_after / total
        assert CudaRuntimeCheck(hbm_usage_threshold=pressure + 0.01)() is True
        check = CudaRuntimeCheck(hbm_usage_threshold=pressure - 0.01)
        assert check() is False and "device memory pressure" in check.last_failure
    finally:
        del block
        torch.cuda.empty_cache()
