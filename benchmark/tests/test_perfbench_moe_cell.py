"""The hybrid MoE cell (``lfm2-24b-a2b-l6.train``) at a tiny size on the CPU against its
plain reference: a sound run is correct; the control and every fault the cell can
have make it incorrect. Its readers over a ring made by hand, its frozen counts, and
its reference's two copies."""

import dataclasses
import os
import time
import types

import pytest
import torch

from benchmark import harness, roofline_moe
from benchmark.loops import moe_train_loop
from benchmark.trace import TraceData

SEED = 2**31 + 23
CELL = "lfm2-24b-a2b-l6.train"
NEW_READERS = ("mfu.moe_train", "moe.experts_ms", "moe.dispatch_ms", "moe.experts_mfu")


def tiny_cell():
    c = harness.cell(CELL)
    tiny = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                moe_intermediate_size=32, num_attention_heads=4, num_key_value_heads=2,
                num_experts=8, num_experts_per_tok=2, torch_dtype="float32",
                assumed=dict(c.config["assumed"], seq_len=32, micro_batch=2))
    return dataclasses.replace(c, config=dict(c.config, **tiny),
                               traffic=dict(c.traffic, report_time_interval_s=0.05))


def run(cell, seconds=3.0, trace=False):
    return harness.run_cell(cell, SEED, seconds, trace, "cpu", time.time())


# -- faults, planted in the program ---------------------------------------------------


def wrap_train_step(monkeypatch, wrap):
    from tpu_resiliency_torch.models import hybrid

    original = hybrid.make_train_step

    def make(cfg, optimizer=None):
        step, init = original(cfg, optimizer)
        return wrap(step, cfg), init

    monkeypatch.setattr(hybrid, "make_train_step", make)


def step_unchanged(monkeypatch):
    """A step that returns its state unchanged: the loss, no update."""
    from tpu_resiliency_torch.models import hybrid

    wrap_train_step(monkeypatch, lambda step, cfg: (
        lambda model, opt, tokens: (model, opt,
                                    hybrid.loss_fn(model, tokens, cfg).detach())))


def step_half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    wrap_train_step(monkeypatch, lambda step, cfg: (
        lambda model, opt, tokens: step(model, opt, tokens[: tokens.shape[0] // 2])))


def bias_ignored(monkeypatch):
    """The router chooses its experts by the sigmoid scores alone."""
    from tpu_resiliency_torch.models import moe

    choices = moe.sigmoid_choices
    monkeypatch.setattr(moe, "sigmoid_choices",
                        lambda logits, bias, *rest: choices(logits, None, *rest))


def one_token_dropped(monkeypatch):
    """The dispatch leaves each layer's last (token, slot) choice out of the groups."""
    from tpu_resiliency_torch.models import moe

    groups = moe.expert_groups
    monkeypatch.setattr(moe, "expert_groups",
                        lambda choices, n: groups(choices[:-1], n))


def combine_weight_altered(monkeypatch):
    """An answer altered where it is produced: the first token's first combine weight
    in every routed layer, doubled."""
    from tpu_resiliency_torch.models import moe

    choices = moe.sigmoid_choices

    def altered(*args):
        idx, weights = choices(*args)
        scale = torch.ones_like(weights)
        scale[0, 0] = 2.0
        return idx, weights * scale

    monkeypatch.setattr(moe, "sigmoid_choices", altered)


# -- the cell -------------------------------------------------------------------------


def test_the_cell_is_correct_at_a_tiny_size():
    res = run(tiny_cell())
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"tokens_per_s", "setup_s"}
    assert res["checks"]["tokens_dropped"]["value"] == 0
    assert res["checks"]["route_mismatch"]["value"] == 0


def test_the_traced_run_reads_no_device_metric_on_the_cpu():
    res = run(tiny_cell(), trace=True)
    assert res["correct"], res["checks"]
    assert res["metrics"] == {}
    assert res["device"]["busy_s"] == 0 and res["breakdown"]["device_ops"] == []


@pytest.mark.parametrize("fault", [step_unchanged, step_half_batch, bias_ignored,
                                   one_token_dropped, combine_weight_altered])
def test_the_cell_fails_each_fault(monkeypatch, fault):
    fault(monkeypatch)
    res = run(tiny_cell())
    assert not res["correct"], res["checks"]


def test_a_dropped_token_is_counted_and_an_ignored_bias_misroutes(monkeypatch):
    one_token_dropped(monkeypatch)
    checks = run(tiny_cell())["checks"]
    steps = 4 * 2  # routed layers; at least the compared steps' worth
    assert checks["tokens_dropped"]["value"] >= steps
    monkeypatch.undo()
    bias_ignored(monkeypatch)
    checks = run(tiny_cell())["checks"]
    assert checks["route_mismatch"]["value"] > checks["route_mismatch"]["limit"]


def test_the_control_and_the_faults_read_past_the_limits():
    cell = tiny_cell()
    readings = moe_train_loop.readings(cell, SEED, "cpu")
    for label in ("fp8", "half_batch", "bias_ignored"):
        assert any(v > cell.limits[k] for k, v in readings[label].items()
                   if k in cell.limits), label
    assert readings["bias_ignored"]["route_mismatch"] > cell.limits["route_mismatch"]


@pytest.mark.gpu
def test_the_control_fails_at_the_cells_own_size(card):
    cell = harness.cell(CELL)
    readings = moe_train_loop.readings(cell, SEED, card)
    assert any(v > cell.limits[k] for k, v in readings["fp8"].items() if k in cell.limits)
    torch.cuda.empty_cache()


# -- the readers ----------------------------------------------------------------------

BASE = 1_790_000_000.0


def span(name, step, device_ms, **counts):
    return types.SimpleNamespace(name=name, step=step, start_ns=int(BASE * 1e9),
                                 end_ns=int(BASE * 1e9) + 1_000_000, duration_ms=1.0,
                                 device_ms=device_ms, counts=counts, ok=True)


@pytest.fixture
def ring(monkeypatch):
    """Replaces the program's ring with the records the test appends."""
    from tpu_resiliency_torch.utils import tracing

    records = []
    monkeypatch.setattr(tracing, "spans", lambda name=None: [
        r for r in records if name is None or r.name == name])
    return records


def context(on_device=True, steps=3, warmup=4):
    kernels = [("k", BASE, BASE + 1e-3)] if on_device else []
    trace = TraceData(kernels, [], [], (BASE, BASE + 1e-2))
    cell = harness.cell(CELL)
    return harness.ReadContext(trace, {"steps": steps, "tokens": 8192 * steps,
                                       "window_s": 0.25 * steps}, cell)


def test_the_span_readers_sum_each_step_and_take_the_median(ring):
    for step, ms in ((2, 100.0), (4, 5.0), (5, 6.0), (6, 9.0), (9, 100.0)):
        ring += [span("moe.experts", step, ms), span("moe.experts", step, ms, backward=1),
                 span("moe.dispatch", step, ms / 2), span("moe.dispatch", step, ms / 2)]
    assert harness.reader("moe.experts_ms")(context()) == 12.0
    assert harness.reader("moe.dispatch_ms")(context()) == 6.0
    flop = roofline_moe.routed_flop(harness.cell(CELL).config, 8192)
    assert harness.reader("moe.experts_mfu")(context()) == pytest.approx(
        100 * flop / 989e12 / 12e-3)


def test_the_mfu_reads_the_windows_tokens_over_its_seconds(ring):
    per_token = roofline_moe.train_flop_per_token(harness.cell(CELL).config)
    assert harness.reader("mfu.moe_train")(context()) == pytest.approx(
        100 * 8192 * per_token / 989e12 / 0.25)


def test_the_new_readers_read_nothing_without_the_device_or_the_spans(ring, monkeypatch):
    for name in NEW_READERS:
        assert harness.reader(name)(context(on_device=False)) is None, name
        assert harness.reader(name)(harness.ReadContext(None, {"steps": 3}, None)) is None
    for name in NEW_READERS[1:]:
        assert harness.reader(name)(context()) is None, name  # the parent's ring: none
    ring += [span("moe.experts", 5, None)]
    assert harness.reader("moe.experts_ms")(context()) is None
    from tpu_resiliency_torch.utils import tracing

    monkeypatch.delattr(tracing, "spans")
    assert harness.reader("moe.dispatch_ms")(context()) is None


# -- the counts and the reference -----------------------------------------------------


def test_the_counts_at_the_cells_shapes_are_the_hand_counts():
    cfg = harness.cell(CELL).config
    assert round(roofline_moe.train_flop_per_token(cfg) / 1e9, 3) == 3.199
    assert round(roofline_moe.routed_flop(cfg, 8192) / 1e12, 2) == 7.42
    p = roofline_moe.parameters(cfg)
    assert p["total"] == 2_789_793_920 and p == cfg["parameters"]
    shapes = moe_train_loop.weight_shapes(cfg)
    assert sum(int(torch.Size(s).numel()) for k, s in shapes.items()
               if k != moe_train_loop.BIAS) == p["total"]


def test_the_references_two_copies_are_the_same_text():
    root = harness.CHECKOUT
    with open(os.path.join(root, "tests", "reference", "lfm2_moe.py")) as a, \
            open(os.path.join(root, "benchmark", "reference", "lfm2_moe.py")) as b:
        assert a.read() == b.read()
