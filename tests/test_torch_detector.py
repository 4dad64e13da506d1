"""The port's straggler-detection API (``tpu_resiliency_torch.telemetry.detector``)
held against the JAX package's ``tpu_resiliency.telemetry.detector``.

The same seeded section samples go into both ``Detector``s, single-rank and over 4
ranks on the store path (the JAX package's ``KVServer``/``CoordStore``; the store is
duck-typed on both sides). Each rank is a thread with its own Detector class, a
subclass of the singleton, so four singletons live in one process. Reports must
agree on column order, straggler sets and masks exactly, and on scores within the
tolerances of ``tests/test_torch_scoring.py``. The port runs with ``device="cpu"``.
"""

import threading
import time

import numpy as np
import pytest
import torch

from tests.test_torch_scoring import _assert_reports_equal
from tpu_resiliency.exceptions import ResiliencyError as RefResiliencyError
from tpu_resiliency.platform.store import CoordStore, KVServer
from tpu_resiliency.telemetry import interval_tracker as ref_it
from tpu_resiliency.telemetry import statistics as ref_stats
from tpu_resiliency.telemetry.detector import Detector as RefDetector
from tpu_resiliency_torch.exceptions import ResiliencyError
from tpu_resiliency_torch.telemetry import interval_tracker as port_it
from tpu_resiliency_torch.telemetry import statistics as port_stats
from tpu_resiliency_torch.telemetry.detector import (
    CallableId,
    Detector,
    synchronize_observed,
)


@pytest.fixture(autouse=True)
def clean_detectors():
    for cls in (Detector, RefDetector):
        if cls.initialized:
            cls.shutdown()
    yield
    for cls in (Detector, RefDetector):
        if cls.initialized:
            cls.shutdown()


def rank_samples(seed, rank, world, slow=2):
    """One report round's samples of a rank: ``{prefix: {name: [seconds]}}``. Rank
    ``slow`` is 3x slower in ``step``; the last rank never runs ``eval``; first-use
    order differs across ranks."""
    rng = np.random.default_rng(seed * 100 + rank)
    base = {"step": 0.1, "data": 0.02, "fwd": 0.05, "eval": 0.3}
    out = {"sec/": {}, "prog/": {}, "op/": {}}
    names = [("sec/", "step"), ("sec/", "data"), ("prog/", "fwd"), ("op/", "kernel"),
             ("sec/", "eval")]
    if rank % 2:
        names.reverse()
    for prefix, name in names:
        if name == "eval" and rank == world - 1:
            continue
        scale = base.get(name, 0.001) * (3.0 if (name == "step" and rank == slow) else 1.0)
        out[prefix][name] = list(scale * rng.uniform(0.95, 1.05, 6 + rank))
    return out


def feed(cls, samples):
    for prefix, by_name in samples.items():
        cls._record_samples(prefix, by_name)


def detector_class(base, rank):
    """A subclass of ``base``: a singleton of its own for one simulated rank."""
    return type(f"{base.__name__}Rank{rank}", (base,), {})


def run_ranks(base, world, rounds, init_kwargs):
    """Drive ``world`` ranks of ``base`` as threads on one fresh store; returns the
    rank-0 report of every round."""
    server = KVServer(host="127.0.0.1", port=0)
    reports, errors = {}, []

    def rank_main(rank):
        store = CoordStore("127.0.0.1", server.port, timeout=60.0)
        cls = detector_class(base, rank)
        try:
            cls.initialize(rank=rank, world_size=world, store=store, report_time_interval=1e9,
                           **init_kwargs)
            for k in range(rounds):
                feed(cls, rank_samples(k, rank, world))
                report = cls.generate_report()
                if rank == 0:
                    reports[k] = report
                else:
                    assert report is None  # gather_on_rank0
            cls.shutdown()
        except BaseException as e:  # noqa: BLE001 - surfaced by the test
            errors.append(e)
        finally:
            store.close()

    threads = [threading.Thread(target=rank_main, args=(r,), daemon=True) for r in range(world)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
        assert not any(t.is_alive() for t in threads), "a rank thread hung"
    finally:
        server.close()
    if errors:
        raise errors[0]
    return [reports[k] for k in range(rounds)]


def assert_detector_reports_equal(ref, got):
    _assert_reports_equal(ref, got)
    for perf_t, sec_t in ((0.75, 0.75), (0.9, 0.5)):
        rs = ref.identify_stragglers(perf_threshold=perf_t, section_threshold=sec_t)
        gs = got.identify_stragglers(perf_threshold=perf_t, section_threshold=sec_t)
        assert {s.rank for s in gs.by_perf} == {s.rank for s in rs.by_perf}
        assert {k: {s.rank for s in v} for k, v in gs.by_section.items()} == {
            k: {s.rank for s in v} for k, v in rs.by_section.items()
        }
    mask = lambda rep: np.asarray(  # noqa: E731
        [rep.perf_scores[r] < 0.75 or rep.z_scores[r] < -3.0 for r in range(rep.world_size)])
    np.testing.assert_array_equal(mask(got), mask(ref))


@pytest.mark.parametrize("world", [1, 4])
def test_store_path_reports_match_the_reference(world):
    ref = run_ranks(RefDetector, world, rounds=2, init_kwargs={})
    got = run_ranks(Detector, world, rounds=2, init_kwargs={"device": "cpu"})
    for r, g in zip(ref, got):
        assert g.section_names == r.section_names  # column order
        assert_detector_reports_equal(r, g)
    if world == 4:
        assert {s.rank for s in got[0].identify_stragglers().by_perf} == {2}


def test_single_rank_without_a_store_matches_the_reference():
    RefDetector.initialize(report_time_interval=1e9)
    Detector.initialize(report_time_interval=1e9, device="cpu")
    for k in range(2):
        samples = rank_samples(k, 0, 1)
        feed(RefDetector, samples)
        feed(Detector, samples)
        assert Detector.local_summary() == RefDetector.local_summary()
        assert_detector_reports_equal(RefDetector.generate_report(), Detector.generate_report())
        assert Detector.local_summary() == {}  # rings reset by the report


def test_requires_initialize():
    with pytest.raises(ResiliencyError):
        with Detector.detection_section("x"):
            pass
    with pytest.raises(ResiliencyError):
        Detector.generate_report()
    with pytest.raises(ResiliencyError):
        Detector.record_program_samples({"p": [1.0]})
    with pytest.raises(RefResiliencyError):
        RefDetector.generate_report()


def test_double_initialize_rejected():
    Detector.initialize(device="cpu")
    with pytest.raises(ResiliencyError, match="already initialized"):
        Detector.initialize(device="cpu")


def test_initialize_defaults_to_the_card():
    if torch.cuda.is_available():
        Detector.initialize()
        assert Detector.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Detector.initialize()
        assert not Detector.initialized


def test_section_timing_and_report():
    Detector.initialize(report_time_interval=1e9, device="cpu")
    for _ in range(8):
        with Detector.detection_section("step", profile_device=False):
            time.sleep(0.002)
    summary = Detector.local_summary()
    assert summary["sec/step"]["count"] == 8
    assert summary["sec/step"]["median"] >= 0.002
    report = Detector.generate_report()
    assert report.section_names == ("sec/step",)
    assert report.relative_section_scores["sec/step"] == pytest.approx(1.0)
    assert not report.identify_stragglers().any


def test_observe_on_torch_tensors():
    Detector.initialize(profiling_interval=2, device="cpu")
    for i in range(4):
        with Detector.detection_section("step") as sec:
            sec.observe({"loss": torch.ones(4) * i, "aux": [torch.zeros(2), "not a tensor"]})
    summary = Detector.local_summary()
    assert summary["sec/step"]["count"] == 4
    assert summary["dev/step"]["count"] == 2  # entries 0 and 2 are profiled


def test_wrap_callables():
    class Trainer:
        def training_step(self, x):
            return (x * 2.0).sum()

    trainer = Trainer()
    Detector.initialize(device="cpu")
    Detector.wrap_callables([CallableId(trainer, "training_step")])
    for _ in range(3):
        assert float(trainer.training_step(torch.ones(8))) == 16.0
    summary = Detector.local_summary()
    assert summary["sec/Trainer.training_step"]["count"] == 3
    assert summary["dev/Trainer.training_step"]["count"] == 3
    Detector.shutdown()
    assert not hasattr(trainer.training_step, "__wrapped__")


def test_report_interval():
    Detector.initialize(report_time_interval=0.0, device="cpu")
    Detector._interval_tracker.interval = 2
    with Detector.detection_section("s", profile_device=False):
        pass
    assert Detector.generate_report_if_interval_elapsed() is None  # iteration 1
    assert Detector.generate_report_if_interval_elapsed() is not None  # iteration 2


class FakeClock:
    def __init__(self, steps):
        self._times = iter(np.cumsum(steps))

    def monotonic(self):
        return float(next(self._times))


@pytest.mark.parametrize("seed", [0, 1])
def test_interval_tracker_matches_the_reference(monkeypatch, seed):
    steps = np.random.default_rng(seed).uniform(0.05, 0.2, 40)
    trackers = []
    for mod in (ref_it, port_it):
        monkeypatch.setattr(mod.time, "monotonic", FakeClock(steps).monotonic)
        t = mod.ReportIntervalTracker(report_time_interval=2.0)
        flags = []
        for _ in range(40):
            t.iter_increase()
            flags.append(t.is_interval_elapsed())
        trackers.append((t.interval, t.iteration, flags))
    assert trackers[0] == trackers[1]
    assert trackers[1][0] is not None


def test_interval_tracker_agrees_across_ranks_through_the_store():
    server = KVServer(host="127.0.0.1", port=0)
    out = {}

    def rank_main(rank):
        store = CoordStore("127.0.0.1", server.port, timeout=60.0)
        t = port_it.ReportIntervalTracker(1.0, store=store, world_size=2, rank=rank)
        t._step_times = [0.1 * (rank + 1)] * port_it.ESTIMATION_ITERS
        t._last_ts = time.monotonic()
        t.iter_increase()
        out[rank] = t.interval
        store.close()

    threads = [threading.Thread(target=rank_main, args=(r,), daemon=True) for r in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
    finally:
        server.close()
    assert out == {0: 10, 1: 10}  # the MAX of the ranks' estimates (10 and 5)


def test_compute_stats_matches_the_reference():
    samples = np.random.default_rng(5).gamma(2.0, 0.1, 33)
    for stats in (port_stats.ALL_STATISTICS, (port_stats.Statistic.MED,)):
        got = port_stats.compute_stats(samples, stats)
        want = ref_stats.compute_stats(samples, [ref_stats.Statistic(s.value) for s in stats])
        assert {k.value: v for k, v in got.items()} == {k.value: v for k, v in want.items()}
    empty = port_stats.compute_stats([])
    assert empty[port_stats.Statistic.NUM] == 0.0 and np.isnan(empty[port_stats.Statistic.MIN])


@pytest.mark.gpu
def test_observe_waits_for_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.rand(2048, 2048, device="cuda")
    y = x @ x
    synchronize_observed({"out": [y]})
    assert torch.cuda.current_stream().query()
    Detector.initialize(profiling_interval=1)
    with Detector.detection_section("mm") as sec:
        sec.observe(x @ x)
    assert Detector.local_summary()["dev/mm"]["count"] == 1
