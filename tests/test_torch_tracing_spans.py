"""The span ring of ``tpu_resiliency_torch/utils/tracing.py``: spans kept in memory,
in one tree with the stream's spans, stamped with the loop's step, on the clock of
torch.profiler's records; and the spans the port opens in a train step, a profiler
window and a report. On the card (``-m gpu``): the clock against a kernel's device
record, and device intervals that resolve after a loop that never waited for them."""

import ast
from pathlib import Path

import pytest
import torch

from tpu_resiliency_torch.integrations import loop
from tpu_resiliency_torch.utils import events, tracing

MODULE = Path(tracing.__file__)


@pytest.fixture(autouse=True)
def fresh_ring():
    tracing.set_capacity()
    tracing.set_step(None)
    yield
    tracing.set_capacity()
    tracing.set_step(None)


def test_ring_spans_nest_with_stream_spans_in_one_tree():
    seen = []
    events.add_sink(seen.append)
    try:
        with tracing.span("test", "outer") as outer:
            with tracing.ring_span("a") as a:
                with tracing.ring_span("b") as b:
                    assert tracing.current_span_id() == outer
                    events.record("test", "inside")
                    with tracing.span("test", "inner") as inner:
                        with tracing.ring_span("c") as c:
                            pass
    finally:
        events.remove_sink(seen.append)
    assert (a.parent_id, b.parent_id, c.parent_id) == (outer, a.span_id, inner)
    assert len({a.span_id, b.span_id, c.span_id}) == 3
    # The stream never names a ring span: its records parent to the stream's spans.
    begin = [e for e in seen if e.kind == "span_begin" and e.payload["span"] == "inner"]
    assert begin[0].payload["parent_id"] == outer
    assert [e.span_id for e in seen if e.kind == "inside"] == [outer]
    assert [r.name for r in tracing.spans()] == ["c", "b", "a"]
    assert tracing._stack() == []


def test_ring_spans_write_no_event():
    seen = []
    events.add_sink(seen.append)
    try:
        with tracing.ring_span("quiet"):
            pass
    finally:
        events.remove_sink(seen.append)
    assert seen == [] and len(tracing.spans("quiet")) == 1


def test_run_training_stamps_every_span_with_its_step():
    class Hooks(loop.Callback):
        def on_step_start(self, ctx):
            with tracing.ring_span("hook.start"):
                pass

        def on_step_end(self, ctx):
            with tracing.ring_span("hook.end"):
                pass

    def step(state, i):
        with tracing.ring_span("work"):
            return state + 1

    loop.run_training(step, 0, 5, callbacks=[Hooks()])
    by_name = {}
    for r in tracing.spans():
        by_name.setdefault(r.name, []).append(r.step)
    assert by_name == {name: [0, 1, 2, 3, 4] for name in ("hook.start", "work", "hook.end")}


def test_counts_attached_to_a_span():
    with tracing.ring_span("parse") as rec:
        rec.count(records=10)
        rec.count(samples=3)
    assert tracing.spans("parse")[0].counts == {"records": 10, "samples": 3}


def test_a_block_that_raises_is_kept_and_re_raised():
    with pytest.raises(ValueError, match="planted"):
        with tracing.ring_span("fails"):
            raise ValueError("planted")
    (rec,) = tracing.spans("fails")
    assert not rec.ok and "planted" in rec.error and rec.end_ns >= rec.start_ns
    assert tracing._stack() == []


def test_the_ring_keeps_the_last_spans_at_capacity():
    tracing.set_capacity(4)
    for i in range(10):
        with tracing.ring_span(f"s{i}"):
            pass
    assert [r.name for r in tracing.spans()] == ["s6", "s7", "s8", "s9"]


def test_capacity_zero_records_nothing():
    tracing.set_capacity(0)
    with tracing.ring_span("off") as rec:
        rec.count(samples=2)
        assert tracing._stack() == []
    assert tracing.spans() == []


def test_durations_are_monotonic_and_the_clock_is_the_epochs():
    import time

    before = time.time_ns()
    with tracing.ring_span("clock"):
        time.sleep(0.002)
    after = time.time_ns()
    (rec,) = tracing.spans("clock")
    assert before - 100_000 <= rec.start_ns <= rec.end_ns <= after + 100_000
    assert rec.duration_ms >= 2.0 and rec.device_ms is None


def test_the_module_imports_no_torch_at_its_top_level():
    tree = ast.parse(MODULE.read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = [a.name for n in top if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in top if isinstance(n, ast.ImportFrom)]
    assert not any(str(n).split(".")[0] == "torch" for n in names), names


def user_annotations(prof) -> dict:
    return {e.name(): e for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()}


def worst_offsets_ns(device) -> list[int]:
    """For each of five ring spans, each around a ``record_function`` region around
    the same call in one profiler session (after one to warm the region), the larger
    of the gaps between their starts and between their ends."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    x = torch.ones(256, 256, device=device)
    recs = []
    with profile(activities=acts) as prof:
        for i in range(6):
            with tracing.ring_span(f"clock{i}") as rec:
                with record_function(f"clock{i}"):
                    x @ x
            recs.append(rec)
    regions = user_annotations(prof)
    out = []
    for rec in recs[1:]:
        ev = regions[rec.name]
        out.append(max(abs(ev.start_ns() - rec.start_ns),
                       abs(ev.start_ns() + ev.duration_ns() - rec.end_ns)))
    return out


def test_ring_spans_and_profiler_regions_share_one_clock():
    assert min(worst_offsets_ns(torch.device("cpu"))) < 100_000


def test_a_train_step_keeps_forward_backward_and_optimizer_spans():
    from tpu_resiliency_torch.models import transformer as tfm

    cfg = tfm.TransformerConfig.tiny()
    model = tfm.Transformer(cfg, device="cpu")
    step, init = tfm.make_train_step(cfg)
    opt = init(model)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16))

    loop.run_training(lambda s, i: step(model, opt, tokens), None, 3)
    names = [(r.name, r.step) for r in tracing.spans()]
    assert names == [(n, i) for i in range(3)
                     for n in ("model.forward", "model.backward", "model.optimizer")]
    assert all(r.device_ms is None and r.ok for r in tracing.spans())


def test_a_profiler_window_keeps_its_open_and_close_with_counts():
    from tpu_resiliency_torch.telemetry.device_profiler import DeviceTimeProfiler

    prof = DeviceTimeProfiler(collect_ops=True, device="cpu")
    prof.start()
    torch.ones(64).sum()
    prof.stop()
    names = [r.name for r in tracing.spans()]
    assert names == ["profiler.open", "profiler.close"]
    (close,) = tracing.spans("profiler.close")
    kept = sum(len(v) for v in prof.drain_ops().values())
    assert 0 < close.counts["samples"] == kept <= close.counts["records"]


def test_a_report_keeps_its_span():
    from tpu_resiliency_torch.telemetry.detector import Detector

    Detector.initialize(rank=0, world_size=1, device="cpu")
    try:
        with Detector.detection_section("step"):
            pass
        assert Detector.generate_report() is not None
    finally:
        Detector.shutdown()
    (rec,) = tracing.spans("detector.report")
    assert rec.ok and rec.duration_ms > 0


# -- on the card ------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_on_the_card_ring_spans_share_the_clock_of_regions_and_kernels(card):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    assert min(worst_offsets_ns(card)) < 100_000
    x = torch.randn(2048, 2048, device=card)
    torch.cuda.synchronize(card)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with tracing.ring_span("kernel"):
            x @ x
            torch.cuda.synchronize(card)
    (rec,) = tracing.spans("kernel")
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() != DeviceType.CPU and not e.is_user_annotation()]
    assert kernels
    for ev in kernels:
        assert rec.start_ns <= ev.start_ns() <= ev.start_ns() + ev.duration_ns() <= rec.end_ns


@pytest.mark.gpu
def test_on_the_card_device_intervals_resolve_after_a_loop_that_never_waits(card):
    x = torch.randn(1024, 1024, device=card)
    torch.cuda.synchronize(card)

    def step(state, i):
        with tracing.ring_span("work", device=card):
            x @ x
        return state

    # A second of work queued ahead of the loop: a span that waited for the card would
    # leave it idle when the loop returns. The spans' intervals start after it.
    torch.cuda._sleep(2_000_000_000)
    loop.run_training(step, None, 4)
    assert not torch.cuda.current_stream(card).query()
    recs = tracing.spans()
    assert [r.step for r in recs] == [0, 1, 2, 3]
    assert all(0 < r.device_ms < 50 for r in recs), [r.device_ms for r in recs]


@pytest.mark.gpu
def test_on_the_card_a_train_step_gives_each_phase_its_device_interval(card):
    from tpu_resiliency_torch.models import transformer as tfm

    cfg = tfm.TransformerConfig.tiny()
    model = tfm.Transformer(cfg, device=card)
    step, init = tfm.make_train_step(cfg)
    opt = init(model)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=card)
    loop.run_training(lambda s, i: step(model, opt, tokens), None, 4)
    recs = tracing.spans()
    assert [(r.name, r.step) for r in recs] == [
        (n, i) for i in range(4) for n in ("model.forward", "model.backward",
                                           "model.optimizer")]
    assert all(r.device_ms is not None and r.device_ms > 0 for r in recs)
