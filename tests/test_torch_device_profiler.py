"""The port's device-time profiler (``tpu_resiliency_torch.telemetry.device_profiler``)
held against the JAX package's ``tpu_resiliency.telemetry.device_profiler``.

The extraction and the kernel-name normalization are pure functions over plain
event records, tested here on synthetic lists; the stats are held against the
reference's ``_stats_over`` on the same samples (numpy on both sides: exactly
equal). A window on the CPU runs end to end through ``torch.profiler``; the test
marked ``gpu`` runs one on the card, where each launch of the ``loop`` kernel must
give one ``op/`` sample.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from pytest import approx
from torch.profiler import record_function

from tpu_resiliency.telemetry.device_profiler import DeviceTimeProfiler as RefProfiler
from tpu_resiliency_torch.telemetry import device_profiler as dp
from tpu_resiliency_torch.telemetry.detector import Detector
from tpu_resiliency_torch.telemetry.device_profiler import (
    DEVICE_REGION,
    HOST_OP,
    HOST_REGION,
    KERNEL,
    OTHER,
    DeviceTimeProfiler,
    EventRecord,
    extract_op_times,
    extract_program_times,
    normalize_kernel_name,
)

LOOP_32 = ("void (anonymous namespace)::median_weights_network_kernel<32>(float const*, "
           "int const*, float*, float*, long long, int, int, long long, long long, long long, "
           "long long, long long)")
CLAMP = ("void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::"
         "launch_clamp_scalar(at::TensorIteratorBase&, c10::Scalar, c10::Scalar, "
         "at::native::detail::ClampLimits)::{lambda()#1}::operator()() const::{lambda()#7}::"
         "operator()() const::{lambda(int)#1}, std::array<char*, 2ul> >(int, at::native::"
         "(anonymous namespace)::launch_clamp_scalar(at::TensorIteratorBase&, c10::Scalar, "
         "c10::Scalar, at::native::detail::ClampLimits)::{lambda()#1}::operator()() const::"
         "{lambda()#7}::operator()() const::{lambda(int)#1}, std::array<char*, 2ul>)")


@pytest.mark.parametrize("name,key", [
    (LOOP_32, "median_weights_network_kernel"),
    (LOOP_32.replace("<32>", "<64>"), "median_weights_network_kernel"),
    ("void (anonymous namespace)::median_weights_loop_kernel(float const*, int const*)",
     "median_weights_loop_kernel"),
    (CLAMP, "at::native::vectorized_elementwise_kernel"),
    ("void at::native::bitonicSortKVInPlace<2, -1, 16, 16, float, long, "
     "at::native::LTOp<float, true>, unsigned int>(at::cuda::detail::TensorInfo<float, "
     "unsigned int>, unsigned int)", "at::native::bitonicSortKVInPlace"),
    ("spin_kernel(long)", "spin_kernel"),
    ("ampere_sgemm_128x64_nn", "ampere_sgemm_128x64_nn"),
])
def test_kernel_names_normalize_to_one_signal(name, key):
    assert normalize_kernel_name(name) == key


def records():
    """A trace of two steps: regions and kernels on the card, their host twins, and
    copies and sets that are no kernels."""
    return [
        EventRecord("push", HOST_REGION, 900_000, "cpu"),
        EventRecord("push", DEVICE_REGION, 40_000, "cuda"),
        EventRecord("aten::index_copy_", HOST_OP, 30_000, "cpu"),
        EventRecord(CLAMP, KERNEL, 2_000, "cuda"),
        EventRecord("report", HOST_REGION, 2_000_000, "cpu"),
        EventRecord("report", DEVICE_REGION, 300_000, "cuda"),
        EventRecord(LOOP_32, KERNEL, 20_000, "cuda"),
        EventRecord("Memcpy DtoH (Device -> Pinned)", OTHER, 3_000, "cuda"),
        EventRecord("push", DEVICE_REGION, 50_000, "cuda"),
        EventRecord(CLAMP.replace("<4,", "<2,"), KERNEL, 1_000, "cuda"),
    ]


def test_extraction_on_the_card_reads_device_records_only():
    progs = extract_program_times(records(), "cuda")
    assert progs == {"push": approx([40e-6, 50e-6]), "report": approx([300e-6])}
    ops = extract_op_times(records(), "cuda")
    assert ops == {"at::native::vectorized_elementwise_kernel": approx([2e-6, 1e-6]),
                   "median_weights_network_kernel": approx([20e-6])}


def test_extraction_on_the_cpu_reads_host_records_only():
    assert extract_program_times(records(), "cpu") == {"push": approx([900e-6]),
                                                       "report": approx([2000e-6])}
    assert extract_op_times(records(), "cpu") == {"aten::index_copy_": approx([30e-6])}


def test_a_lost_record_costs_its_sample_and_nothing_else():
    full = records()
    for lost in range(len(full)):
        trace = full[:lost] + full[lost + 1:]
        for extract in (extract_program_times, extract_op_times):
            want, got = extract(full, "cuda"), extract(trace, "cuda")
            assert sum(map(len, want.values())) - sum(map(len, got.values())) in (0, 1)
            for name, secs in got.items():  # what remains sits under its own name
                rest = list(want[name])
                for x in secs:
                    rest.remove(x)


def kineto_event(name, device, annotation=False, ns=1000):
    return SimpleNamespace(name=lambda: name, device_type=lambda: device,
                           is_user_annotation=lambda: annotation, duration_ns=lambda: ns)


def test_records_from_kineto_events():
    from torch.autograd import DeviceType

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [
        kineto_event("push", cpu, annotation=True),
        kineto_event("push", cuda, annotation=True),
        kineto_event(LOOP_32, cuda),
        kineto_event("Memset (Device)", cuda),
        kineto_event("Memcpy DtoD (Device -> Device)", cuda),
        kineto_event("aten::sort", cpu),
    ]
    kinds = [rec.kind for rec in dp.records_from_kineto(events)]
    assert kinds == [HOST_REGION, DEVICE_REGION, KERNEL, OTHER, OTHER, HOST_OP]


def test_stats_match_the_reference():
    rng = np.random.default_rng(7)
    samples = {"a": list(rng.gamma(2.0, 1e-3, 33)), "b": [1e-3], "empty": []}
    ours = DeviceTimeProfiler(device="cpu")
    ours._fold(ours._samples, ours._fresh, samples)
    from collections import deque

    assert ours.get_stats() == RefProfiler._stats_over({k: deque(v) for k, v in samples.items()})
    assert set(ours.get_stats()["a"]) == {"min", "max", "med", "avg", "std", "count"}


def test_samples_per_name_are_bounded():
    prof = DeviceTimeProfiler(device="cpu")
    prof._fold(prof._samples, prof._fresh, {"p": [1e-3] * (dp.MAX_SAMPLES_PER_PROGRAM + 5)})
    assert prof.get_stats()["p"]["count"] == dp.MAX_SAMPLES_PER_PROGRAM
    assert len(prof.drain()["p"]) == dp.MAX_SAMPLES_PER_PROGRAM + 5


def test_cpu_window_end_to_end():
    prof = DeviceTimeProfiler(collect_ops=True, device="cpu")
    x = torch.randn(64, 64)
    with prof:
        assert prof.active
        for _ in range(3):
            with record_function("work"):
                torch.tanh(x @ x).sum()
    assert not prof.active
    progs = prof.drain()
    assert list(progs) == ["work"] and len(progs["work"]) == 3
    assert all(s > 0 for s in progs["work"])
    assert prof.drain() == {}
    ops = prof.drain_ops()
    assert len(ops["aten::tanh"]) == 3 and "aten::mm" in ops
    assert prof.drain_ops() == {}
    st = prof.get_stats()["work"]
    assert st["count"] == 3 and st["min"] <= st["med"] <= st["max"]
    assert prof.get_op_stats()["aten::tanh"]["count"] == 3
    prof.reset()
    assert prof.get_stats() == {} and prof.get_op_stats() == {}
    prof.stop()  # stopping a closed window is a no-op


def test_a_window_cannot_start_inside_another_session():
    prof = DeviceTimeProfiler(device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert dp.profiler_running()
        with pytest.raises(RuntimeError, match="already running"):
            prof.start()
        assert not prof.active
    assert not dp.profiler_running()
    with prof:  # the process-global profiler is free again
        pass


def test_the_profiler_defaults_to_the_card():
    if torch.cuda.is_available():
        assert DeviceTimeProfiler().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeviceTimeProfiler()


def test_samples_join_the_scored_matrix():
    Detector.initialize(report_time_interval=3600.0, device="cpu")
    try:
        for _ in range(8):
            Detector.record_program_samples({"push": [1.0e-3], "report": [0.5e-3]})
            Detector.record_op_samples({"median_weights_network_kernel": [2e-5]})
        report = Detector.generate_report()
        assert {"prog/push", "prog/report", "op/median_weights_network_kernel"} <= set(
            report.section_names)
        assert report.relative_section_scores["prog/push"] == 1.0
    finally:
        Detector.shutdown()


@pytest.mark.gpu
def test_gpu_window_counts_each_loop_launch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpu_resiliency_torch.ops import scoring_kernels as sk

    data = torch.rand(256, 64, 32, device="cuda")
    counts = torch.full((256, 64), 32, dtype=torch.int32, device="cuda")
    sk.fused_median_weights(data, counts, mode="loop")  # build and load outside the window
    torch.cuda.synchronize()
    prof = DeviceTimeProfiler(collect_ops=True)
    sk.reset_launches()
    with prof:
        for _ in range(5):
            with record_function("reduce"):
                sk.fused_median_weights(data, counts, mode="loop")
    launches = sk.fused_median_weights.launches_by_mode["loop"]
    ops = prof.drain_ops()
    assert len(ops["median_weights_network_kernel"]) == launches == 5
    regions = prof.drain()["reduce"]
    assert len(regions) == 5 and all(0 < s < 0.1 for s in regions)
