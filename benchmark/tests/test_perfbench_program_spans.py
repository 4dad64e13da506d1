"""The per-layer metrics read from the program's span ring: each reader over a trace
and a ring made by hand, with a known answer; a tiny traced run on the CPU, whose
spans have to be where the readers look for them; on the card, a run of the train
cell that reads all seven."""

import dataclasses
import types

import pytest
import torch

from benchmark import harness
from benchmark.loops import train_loop
from benchmark.trace import TraceData, Tracer

SEED = 2**31 + 23
CELL = "mistral7b-l2.train"
METRICS = ("model.forward_ms", "model.backward_ms", "model.optimizer_ms", "model.idle_ms",
           "profiler.window_ms", "profiler.kept_share", "detector.report_ms")
BASE = 1_790_000_000.0  # seconds since the epoch, as the trace's records carry them


def span(name, step, start_ms, end_ms, device_ms=None, **counts):
    """A ring record from ``start_ms`` to ``end_ms`` after ``BASE``."""
    return types.SimpleNamespace(
        name=name, step=step, start_ns=int(BASE * 1e9 + start_ms * 1e6),
        end_ns=int(BASE * 1e9 + end_ms * 1e6), duration_ms=end_ms - start_ms,
        device_ms=device_ms, counts=counts, ok=True)


def at(ms):
    return BASE + ms * 1e-3


@pytest.fixture
def ring(monkeypatch):
    """Replaces the program's ring with the records the test appends."""
    from tpu_resiliency_torch.utils import tracing

    records = []
    monkeypatch.setattr(tracing, "spans", lambda name=None: [
        r for r in records if name is None or r.name == name])
    return records


def context(trace, steps=10, warmup=4):
    cell = types.SimpleNamespace(traffic={"warmup_steps": warmup})
    return harness.ReadContext(trace, {"steps": steps}, cell)


def device_trace(kernels, window=(0.0, 10.0)):
    return TraceData([("k", at(a), at(b)) for a, b in kernels], [], [],
                     (at(window[0]), at(window[1])))


def test_the_model_phases_read_the_median_over_the_windows_steps(ring):
    trace = device_trace([(0, 1)])
    for step, ms in ((3, 99.0), (4, 80.0), (5, 82.0), (6, 90.0), (14, 99.0)):
        ring.append(span("model.forward", step, 0, 1, device_ms=ms))
        ring.append(span("model.backward", step, 1, 2, device_ms=2 * ms))
        ring.append(span("model.optimizer", step, 2, 3, device_ms=ms / 4))
    ctx = context(trace)
    assert harness.reader("model.forward_ms")(ctx) == 82.0
    assert harness.reader("model.backward_ms")(ctx) == 164.0
    assert harness.reader("model.optimizer_ms")(ctx) == 20.5


def test_a_phase_without_its_device_interval_reads_nothing(ring):
    ring.append(span("model.forward", 5, 0, 1, device_ms=None))
    assert harness.reader("model.forward_ms")(context(device_trace([(0, 1)]))) is None


def test_model_idle_counts_only_the_pieces_of_gaps_inside_model_spans(ring):
    # Busy [1, 3] and [5, 9] ms of a [0, 10] window: idle [0, 1], [3, 5], [9, 10].
    trace = device_trace([(1, 3), (5, 9)])
    # Step 6: forward [0.5, 4] holds 0.5 + 1.0 of idle, backward [4.5, 9.5] 0.5 + 0.5;
    # the idle [4, 4.5] between them (the middle of the gap [3, 5]) counts for neither.
    ring.append(span("model.forward", 6, 0.5, 4.0))
    ring.append(span("model.backward", 6, 4.5, 9.5))
    # A callback span and a step outside the window count for nothing.
    ring.append(span("profiler.open", 6, 0.0, 10.0))
    ring.append(span("model.optimizer", 20, 9.5, 10.0))
    assert harness.reader("model.idle_ms")(context(trace)) == pytest.approx(2.5, abs=1e-3)


def test_model_idle_is_per_traced_step(ring):
    trace = device_trace([(1, 2), (3, 4)], window=(0.0, 4.0))
    ring.append(span("model.forward", 6, 0.0, 2.0))  # idle [0, 1]
    ring.append(span("model.forward", 7, 2.0, 4.0))  # idle [2, 3]
    assert harness.reader("model.idle_ms")(context(trace)) == pytest.approx(1.0, abs=1e-3)


def test_the_profiler_window_is_open_plus_close_per_profiled_step(ring):
    ring += [span("profiler.open", 0, 0, 30), span("profiler.close", 0, 40, 300),
             span("profiler.open", 50, 0, 25), span("profiler.close", 50, 30, 130),
             span("profiler.open", 100, 0, 21), span("profiler.close", 100, 30, 150)]
    assert harness.reader("profiler.window_ms")(context(device_trace([(0, 1)]), steps=100)) \
        == pytest.approx(((25 + 100) + (21 + 120)) / 2)


def test_the_kept_share_sums_samples_over_records(ring):
    ring += [span("profiler.close", 0, 0, 1, records=100, samples=100),
             span("profiler.close", 50, 0, 1, records=4000, samples=800),
             span("profiler.close", 100, 0, 1, records=6000, samples=700),
             span("profiler.close", 150, 0, 1)]  # a window whose parse failed
    assert harness.reader("profiler.kept_share")(context(device_trace([(0, 1)]), steps=200)) \
        == pytest.approx(15.0)


def test_the_report_reads_the_median_host_ms(ring):
    ring += [span("detector.report", 2, 0, 50), span("detector.report", 20, 0, 2),
             span("detector.report", 40, 0, 3), span("detector.report", 60, 0, 7)]
    assert harness.reader("detector.report_ms")(context(device_trace([(0, 1)]), steps=100)) \
        == pytest.approx(3.0)


@pytest.mark.parametrize("metric", METRICS)
def test_no_device_in_the_trace_reads_nothing(ring, metric):
    ring += [span(n, 5, 0, 1, device_ms=1.0, records=2, samples=1) for n in (
        "model.forward", "model.backward", "model.optimizer", "profiler.open",
        "profiler.close", "detector.report")]
    cpu = TraceData([], [], [], (at(0), at(10)))
    assert harness.reader(metric)(context(cpu)) is None
    assert harness.reader(metric)(context(None)) is None


@pytest.mark.parametrize("metric", METRICS)
def test_a_program_without_the_ring_reads_nothing(monkeypatch, metric):
    from tpu_resiliency_torch.utils import tracing

    monkeypatch.delattr(tracing, "spans")
    assert harness.reader(metric)(context(device_trace([(0, 1)]))) is None


# -- a traced run ---------------------------------------------------------------------


def tiny_train_cell():
    c = harness.cell(CELL)
    tiny = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_attention_heads=4, num_key_value_heads=2, torch_dtype="float32",
                assumed=dict(c.config["assumed"], seq_len=32, micro_batch=4))
    # A profiled step every 20 (none among the traced steps 6-13), reports every 0.05 s.
    return dataclasses.replace(c, config=dict(c.config, **tiny), traffic=dict(
        c.traffic, report_time_interval_s=0.05, profile_programs_every=20))


def window_spans(outcome, cell) -> list:
    from tpu_resiliency_torch.utils import tracing

    lo = cell.traffic["warmup_steps"]
    return [r for r in tracing.spans()
            if r.step is not None and lo <= r.step < lo + outcome.counters["steps"]]


def test_a_traced_run_keeps_its_spans_where_the_readers_look():
    from tpu_resiliency_torch.utils import tracing

    cell = tiny_train_cell()
    tracing.set_capacity()
    tracer = Tracer(True, "cpu")
    outcome = train_loop.run(cell, SEED, 3.0, tracer, "cpu")
    assert all(ch.ok for ch in outcome.checks), outcome.checks
    spans = window_spans(outcome, cell)
    lo, steps = cell.traffic["warmup_steps"], outcome.counters["steps"]
    every = cell.traffic["profile_programs_every"]
    profiled = [i for i in range(lo, lo + steps) if i % every == 0]
    assert profiled and outcome.counters["reports"]
    names = {}
    for r in spans:
        names.setdefault(r.step, []).append(r.name)
    for i in range(lo, lo + steps):
        phases = [n for n in names[i] if n.startswith("model.")]
        assert phases == ["model.forward", "model.backward", "model.optimizer"], i
        assert (i in profiled) == ("profiler.open" in names[i]) == ("profiler.close" in names[i])
    assert sum(r.name == "detector.report" for r in spans) >= outcome.counters["reports"]
    inside = sum(r.duration_ms for r in spans
                 if r.name.startswith(("profiler.", "detector."))) * 1e-3
    assert 0 < inside <= outcome.counters["callback_s"]
    ctx = harness.ReadContext(tracer.data, outcome.counters, cell)
    assert all(harness.reader(m)(ctx) is None for m in METRICS)  # no device in the trace


@pytest.mark.gpu
def test_on_the_card_a_traced_run_reads_all_seven(card):
    from tpu_resiliency_torch.utils import tracing

    cell = harness.cell(CELL)
    tracing.set_capacity()
    tracer = Tracer(True, card)
    tracer.warm()
    # 20 s holds step 50, the window's first profiled step, and three reports.
    outcome = train_loop.run(cell, SEED, 20.0, tracer, card)
    assert all(ch.ok for ch in outcome.checks), outcome.checks
    ctx = harness.ReadContext(tracer.data, outcome.counters, cell)
    values = {m: harness.reader(m)(ctx) for m in METRICS}
    assert None not in values.values(), values
    busy_ms = 1e3 * tracer.data.busy_s() / cell.traffic["trace_steps"]
    phases = sum(values[m] for m in METRICS[:3])
    assert abs(phases / busy_ms - 1) < 0.05, (phases, busy_ms)
    inside = sum(r.duration_ms for r in window_spans(outcome, cell)
                 if r.name.startswith(("profiler.", "detector."))) * 1e-3
    assert inside <= outcome.counters["callback_s"]
    assert 0 < values["profiler.kept_share"] < 100
    print({**values, "busy_ms_per_step": busy_ms, "callback_s": outcome.counters["callback_s"],
           "inside_s": inside})
    torch.cuda.empty_cache()
