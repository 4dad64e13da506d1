"""``attention.fused_share``: the share of the window's attention calls that ran the
causal softmax kernel, read from the counts on the program's ``model.forward`` spans,
over a trace and a ring made by hand."""

import types

import pytest

from benchmark import harness
from benchmark.trace import TraceData

METRIC = "attention.fused_share"
BASE = 1_790_000_000.0  # seconds since the epoch, as the trace's records carry them


def forward_span(step, **counts):
    return types.SimpleNamespace(name="model.forward", step=step, start_ns=int(BASE * 1e9),
                                 end_ns=int(BASE * 1e9) + 1_000_000, duration_ms=1.0,
                                 device_ms=1.0, counts=counts, ok=True)


@pytest.fixture
def ring(monkeypatch):
    """Replaces the program's ring with the records the test appends."""
    from tpu_resiliency_torch.utils import tracing

    records = []
    monkeypatch.setattr(tracing, "spans", lambda name=None: [
        r for r in records if name is None or r.name == name])
    return records


def context(on_device=True, steps=10, warmup=4):
    kernels = [("k", BASE, BASE + 1e-3)] if on_device else []
    trace = TraceData(kernels, [], [], (BASE, BASE + 1e-2))
    cell = types.SimpleNamespace(traffic={"warmup_steps": warmup})
    return harness.ReadContext(trace, {"steps": steps}, cell)


def test_every_call_fused_reads_100(ring):
    ring += [forward_span(s, attention_fused=2, attention_plain=0) for s in range(4, 14)]
    assert harness.reader(METRIC)(context()) == 100.0


def test_the_share_sums_over_the_windows_steps_only(ring):
    ring += [forward_span(2, attention_fused=0, attention_plain=2),  # warm-up
             forward_span(5, attention_fused=2, attention_plain=0),
             forward_span(6, attention_fused=1, attention_plain=1),
             forward_span(20, attention_fused=0, attention_plain=2)]  # past the window
    assert harness.reader(METRIC)(context()) == pytest.approx(75.0)


def test_spans_without_the_counts_read_nothing(ring):
    """A program whose forward span counts no attention calls (the parent's)."""
    ring += [forward_span(s) for s in range(4, 14)]
    assert harness.reader(METRIC)(context()) is None


def test_no_device_in_the_trace_reads_nothing(ring):
    ring += [forward_span(5, attention_fused=2, attention_plain=0)]
    assert harness.reader(METRIC)(context(on_device=False)) is None
    assert harness.reader(METRIC)(harness.ReadContext(None, {"steps": 10}, None)) is None


def test_a_program_without_the_ring_reads_nothing(monkeypatch):
    from tpu_resiliency_torch.utils import tracing

    monkeypatch.delattr(tracing, "spans")
    assert harness.reader(METRIC)(context()) is None
