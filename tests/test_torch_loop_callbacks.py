"""The port's train-loop seam (``tpu_resiliency_torch.integrations``) held against the
JAX package's ``tpu_resiliency.integrations`` (``tests/integrations/
test_loop_callbacks.py``): hook order, cooperative stop and exception propagation
must be the same in both loops, step for step; the straggler callback reports on
the CPU (``device="cpu"``), feeds profiler windows into the scored matrix, closes a
window a failed step left open, and emits the same ``straggler_report`` event on the
JSONL stream both packages share.
"""

import json
import logging
import time

import pytest
import torch
from torch.profiler import record_function

import tpu_resiliency.integrations.loop as ref_loop
import tpu_resiliency.utils.events as ref_events
from tpu_resiliency_torch.integrations import (
    Callback,
    StopTraining,
    StragglerDetectionCallback,
    run_training,
)
from tpu_resiliency_torch.integrations import loop as port_loop
from tpu_resiliency_torch.telemetry import Detector, HealthVectorPolicy
from tpu_resiliency_torch.utils import events


@pytest.fixture(autouse=True)
def clean_detector():
    if Detector.initialized:
        Detector.shutdown()
    yield
    if Detector.initialized:
        Detector.shutdown()


def recorder(base):
    class Recorder(base):
        def __init__(self):
            self.events = []

        def __getattribute__(self, name):
            if name.startswith("on_"):
                events_ = object.__getattribute__(self, "events")
                return lambda ctx, *a: events_.append((name, ctx.step))
            return object.__getattribute__(self, name)

    return Recorder()


def drive(loop, **kw):
    rec = recorder(loop.Callback)
    try:
        ctx = loop.run_training(callbacks=[rec], **kw)
    except ValueError as e:
        return rec.events, repr(e)
    return rec.events, (ctx.state, ctx.step, ctx.should_stop, dict(ctx.metrics))


def failing_step(state, i):
    if i == 3:
        raise ValueError("boom")
    return state + 1


@pytest.mark.parametrize("case", ["checkpoint_and_validate", "exception", "resume"])
def test_both_loops_fire_the_same_hooks(case):
    kw = {
        "checkpoint_and_validate": dict(
            step_fn=lambda s, i: s + 1, state=0, num_steps=6, checkpoint_every=2,
            checkpoint_fn=lambda s, i: None, validate_every=3,
            validate_fn=lambda s, i: {"val": s}),
        "exception": dict(step_fn=failing_step, state=0, num_steps=6),
        "resume": dict(step_fn=lambda s, i: s + 1, state=0, num_steps=5),
    }[case]
    results = []
    for loop in (ref_loop, port_loop):
        ctx = loop.LoopContext(start_step=2) if case == "resume" else None
        results.append(drive(loop, ctx=ctx, **kw))
    assert results[0] == results[1]
    hooks = [h for h, _ in results[1][0]]
    assert hooks[0] == "on_train_start" and hooks[-1] == "on_train_end"


def test_loop_stop_training_cooperative():
    class Stopper(Callback):
        def on_step_end(self, ctx):
            if ctx.step == 1:
                raise StopTraining

    ctx = run_training(lambda s, i: s + 1, 0, 10, callbacks=[Stopper()])
    assert ctx.state == 2 and ctx.should_stop


def test_loop_exception_fires_hook_and_propagates():
    seen = []

    class Witness(Callback):
        def on_exception(self, ctx, exc):
            seen.append(repr(exc))

    with pytest.raises(ValueError):
        run_training(failing_step, 0, 5, callbacks=[Witness()])
    assert seen and "boom" in seen[0]


def test_straggler_callback_reports():
    cb = StragglerDetectionCallback(report_time_interval=0.0, threshold=0.75, device="cpu")

    def step(state, i):
        time.sleep(0.002)
        return state + 1

    ctx = run_training(step, 0, 20, callbacks=[cb])
    assert ctx.state == 20
    assert cb.last_report is not None
    assert cb.last_report.section_names == ("sec/train_step",)
    assert ctx.metrics["straggler/best_score"] == 1.0
    assert not Detector.initialized  # shut down on train end


def test_straggler_callback_profiles_regions_and_ops():
    cb = StragglerDetectionCallback(report_time_interval=0.0, profile_programs_every=2,
                                    profile_ops=True, device="cpu")
    x = torch.randn(64, 64)

    def step(state, i):
        with record_function("work"):
            torch.tanh(x @ x).sum()
        return state + 1

    ctx = run_training(step, 0, 24, callbacks=[cb])
    assert ctx.state == 24
    names = cb.last_report.section_names
    assert "prog/work" in names and "op/aten::tanh" in names
    assert cb._program_profiler is not None and not cb._program_profiler.active


def test_max_signals_reaches_the_detector():
    seen = []
    cb = StragglerDetectionCallback(report_time_interval=0.0, max_signals=256, device="cpu")
    run_training(lambda s, i: seen.append(Detector.max_signals) or s, 0, 3, callbacks=[cb])
    assert seen == [256] * 3


def test_a_failed_step_does_not_leak_the_profiler_window():
    cb = StragglerDetectionCallback(report_time_interval=1e9, profile_programs_every=1,
                                    device="cpu")
    with pytest.raises(ValueError):
        run_training(failing_step, 0, 6, callbacks=[cb])
    assert not cb._program_profiler.active and not Detector.initialized
    cb2 = StragglerDetectionCallback(report_time_interval=0.0, profile_programs_every=1,
                                     device="cpu")
    ctx = run_training(lambda s, i: s + 1, 0, 20, callbacks=[cb2])  # windows open again
    assert ctx.state == 20 and cb2.last_report is not None


def test_a_window_that_cannot_start_is_logged_not_hidden(caplog):
    cb = StragglerDetectionCallback(report_time_interval=0.0, profile_programs_every=1,
                                    device="cpu")
    logger = logging.getLogger("tpu_resiliency_torch")
    logger.addHandler(caplog.handler)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            ctx = run_training(lambda s, i: s + 1, 0, 20, callbacks=[cb])
    finally:
        logger.removeHandler(caplog.handler)
    assert ctx.state == 20
    assert "StragglerDetectionCallback.on_step_start failed" in caplog.text
    assert not any(n.startswith("prog/") for n in (cb.last_report.section_names
                                                   if cb.last_report else ()))


def test_the_store_path_is_taken_without_a_process_group():
    cb = StragglerDetectionCallback(report_time_interval=0.0, use_device_mesh=True,
                                    device="cpu")
    ctx = run_training(lambda s, i: s + 1, 0, 20, callbacks=[cb])
    assert ctx.state == 20 and cb.last_report is not None


def test_straggler_report_emits_structured_event():
    seen = []
    events.add_sink(seen.append)
    try:
        cb = StragglerDetectionCallback(report_time_interval=0.0, device="cpu",
                                        health_policy=HealthVectorPolicy())
        ctx = run_training(lambda s, i: s + 1, 0, 20, callbacks=[cb])
        assert ctx.state == 20
    finally:
        events.remove_sink(seen.append)
    reports = [e for e in seen if e.kind == "straggler_report"]
    assert reports
    ev = reports[-1]
    assert ev.source == "telemetry"
    assert set(ev.payload) == {"step", "perf_scores", "stragglers_by_perf",
                               "stragglers_by_section"}
    assert ev.payload["perf_scores"] == {"0": 1.0}
    assert ev.payload["stragglers_by_perf"] == []
    assert cb.health_policy.last_decision is not None


def test_both_packages_write_one_event_stream(tmp_path, monkeypatch):
    path = tmp_path / "events.jsonl"
    monkeypatch.setenv(events.EVENTS_FILE_ENV, str(path))
    assert events.EVENTS_FILE_ENV == ref_events.EVENTS_FILE_ENV
    try:
        ref_events.record("telemetry", "straggler_report", step=1, perf_scores={"0": 1.0})
        events.record("telemetry", "straggler_report", step=2, perf_scores={"0": 1.0})
    finally:
        for mod in (ref_events, events):  # drop only the JSONL sinks this test wired
            for sink in [k for k in mod._sinks if getattr(k, "path", None) == str(path)]:
                mod.remove_sink(sink)
                sink.close()
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [r["step"] for r in lines] == [1, 2]
    assert set(lines[0]) == set(lines[1])
    assert ref_events.read_events(str(path)) == events.read_events(str(path)) == lines
