"""Each cell at a tiny size on the CPU against its plain reference: a sound run is
correct; the control and every fault the cell can have make it incorrect."""

import dataclasses
import time

import pytest
import torch

from benchmark import control, harness

SEED = 2**31 + 11


def tiny_train_cell():
    c = harness.cell("mistral7b-l2.train")
    tiny = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_attention_heads=4, num_key_value_heads=2, torch_dtype="float32",
                assumed=dict(c.config["assumed"], seq_len=32, micro_batch=4))
    return dataclasses.replace(c, config=dict(c.config, **tiny),
                               traffic=dict(c.traffic, report_time_interval_s=0.05))


def run(cell, seconds):
    return harness.run_cell(cell, SEED, seconds, False, "cpu", time.time())


# -- faults, planted in the program ---------------------------------------------------


def alter_a_score(monkeypatch):
    """An answer altered where it is produced: one rank's perf score on its way to the
    host."""
    from tpu_resiliency_torch.telemetry import scoring

    original = scoring.scores_to_host

    def to_host(res):
        host = original(res)
        host.perf[0] += 1e-3
        return host

    monkeypatch.setattr(scoring, "scores_to_host", to_host)


def wrap_train_step(monkeypatch, wrap):
    from tpu_resiliency_torch.models import transformer

    original = transformer.make_train_step

    def make(cfg, optimizer=None, attn_fn=None):
        step, init = original(cfg, optimizer, attn_fn)
        return wrap(step, cfg), init

    monkeypatch.setattr(transformer, "make_train_step", make)


def step_unchanged(monkeypatch):
    """A step that returns its state unchanged: the loss, no update."""
    from tpu_resiliency_torch.models import transformer

    def wrap(step, cfg):
        return lambda model, opt, tokens: (
            model, opt, transformer.loss_fn(model, tokens, cfg).detach())

    wrap_train_step(monkeypatch, wrap)


def step_half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    wrap_train_step(monkeypatch, lambda step, cfg: (
        lambda model, opt, tokens: step(model, opt, tokens[: tokens.shape[0] // 2])))


def hook_raises(monkeypatch):
    """The callback's profiled-step fold raises (the loop's runner logs it and goes
    on)."""
    from tpu_resiliency_torch.telemetry.detector import Detector

    def fail(samples):
        raise RuntimeError("planted")

    monkeypatch.setattr(Detector, "record_op_samples", staticmethod(fail))


def profiled_steps_skipped(monkeypatch):
    """The callback's profiled steps never open a profiler window."""
    from tpu_resiliency_torch.telemetry.device_profiler import DeviceTimeProfiler

    monkeypatch.setattr(DeviceTimeProfiler, "start", lambda self: None)


def op_signals_dropped(monkeypatch):
    """The profiled steps hand the detector no kernel times."""
    from tpu_resiliency_torch.telemetry.device_profiler import DeviceTimeProfiler

    monkeypatch.setattr(DeviceTimeProfiler, "drain_ops", lambda self: {})


def section_time_altered(monkeypatch):
    """An answer altered where it is produced: the step section timed at half."""
    from tpu_resiliency_torch.telemetry import detector

    record = detector.Detector._record

    def halved(signal, seconds):
        if signal.startswith(detector.SECTION_PREFIX):
            seconds *= 0.5
        record(signal, seconds)

    monkeypatch.setattr(detector.Detector, "_record", staticmethod(halved))


def step_altered_loss(monkeypatch):
    """An answer altered where it is produced: the step's loss."""
    def wrap(step, cfg):
        def altered(model, opt, tokens):
            model, opt, loss = step(model, opt, tokens)
            return model, opt, loss * 1.01
        return altered

    wrap_train_step(monkeypatch, wrap)


# -- the train cell -------------------------------------------------------------------


def test_train_cell_is_correct_at_a_tiny_size():
    res = run(tiny_train_cell(), 3.0)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"tokens_per_s", "setup_s"}


def test_train_cell_traced_run_reads_no_device_metric_on_the_cpu():
    res = harness.run_cell(tiny_train_cell(), SEED, 3.0, True, "cpu", time.time())
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"callback.ms_per_step"}
    assert res["device"]["busy_s"] == 0 and res["breakdown"]["device_ops"] == []


@pytest.mark.parametrize("fault", [step_unchanged, step_half_batch, step_altered_loss,
                                   alter_a_score, hook_raises, profiled_steps_skipped,
                                   op_signals_dropped, section_time_altered])
def test_train_cell_fails_each_fault(monkeypatch, fault):
    fault(monkeypatch)
    assert not run(tiny_train_cell(), 3.0)["correct"]


def test_train_cell_control_and_half_batch_read_past_the_limits():
    cell = tiny_train_cell()
    readings = control.train_readings(cell, SEED, "cpu")
    for label in ("fp8", "half_batch"):
        assert any(v > cell.limits[k] for k, v in readings[label].items()
                   if k in cell.limits), label


@pytest.mark.gpu
def test_the_control_fails_at_the_cells_own_size(card):
    cell = harness.cell("mistral7b-l2.train")
    readings = control.train_readings(cell, SEED, card)
    assert any(v > cell.limits[k] for k, v in readings["fp8"].items() if k in cell.limits)
    torch.cuda.empty_cache()
