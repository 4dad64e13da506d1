"""``tpu_resiliency_torch/bench.py`` held against the repo's ``bench.py``, loaded by path.

The reference's functions run at a small size with its module constants patched (R, S,
W, ITERS); its Pallas modes run in interpret mode, as they do off a TPU. Each port
variant meets its reference counterpart on the same seeded telemetry: the straggler
masks and F1 must be equal, and ``perf`` / ``ewma`` agree within ``RTOL`` (float32
reductions in other orders). The module's own run on the CPU prints the reference's
keys with ``vs_baseline`` null, and without a card (and no ``--device cpu``) it exits
non-zero with no result line.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.torch_port_tests import REPO
from tpu_resiliency_torch import bench

RANKS, SIGNALS, WINDOW, LONG_WINDOW, ITERS = 256, 8, 32, 512, 2
#: perf and ewma: the same float32 pipeline, its sums taken in other orders.
RTOL = 1e-5


@pytest.fixture(scope="module")
def reference():
    spec = importlib.util.spec_from_file_location("ref_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shrunk(monkeypatch, reference, window):
    for name, value in (("R", RANKS), ("S", SIGNALS), ("W", window), ("ITERS", ITERS)):
        monkeypatch.setattr(reference, name, value)


@pytest.mark.parametrize("seed,window", [(0, WINDOW), (3, LONG_WINDOW)])
def test_make_telemetry_is_the_references_bit_for_bit(monkeypatch, reference, seed, window):
    _shrunk(monkeypatch, reference, window)
    want = reference.make_telemetry(seed)
    got = bench.make_telemetry(seed, ranks=RANKS, signals=SIGNALS, window=window)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g.view(np.uint8), w.view(np.uint8))
    assert int(got[2].sum()) == int(RANKS * bench.SLOW_FRACTION)


def test_the_defaults_are_the_references_constants(reference):
    for name in ("R", "S", "W", "SLOW_FRACTION", "SLOWDOWN", "ITERS", "REPORT_INTERVAL"):
        assert getattr(bench, name) == getattr(reference, name), name


def test_baseline_host_scoring_gives_the_references_scores(monkeypatch, reference):
    _shrunk(monkeypatch, reference, WINDOW)
    data, counts, truth = reference.make_telemetry(1)
    _, want_scores, want_set = reference.baseline_host_scoring(data, counts)
    _, got_scores, got_set = bench.baseline_host_scoring(data, counts, ranks=RANKS,
                                                         signals=SIGNALS)
    assert got_scores == want_scores and got_set == want_set
    mask = np.zeros(RANKS, dtype=bool)
    mask[list(got_set)] = True
    assert bench.f1(mask, truth) == reference.f1(mask, truth) == 1.0


def _reference_run(reference, variant, data, counts):
    ref_name = bench.REFERENCE_NAMES[variant]
    if variant == bench.RINGS:
        *_, out = reference.device_ring_scoring(data, counts, reference.REPORT_INTERVAL)
    else:
        _, out = reference.device_scoring(data, counts, variant=ref_name)
    return out


@pytest.mark.parametrize("variant", bench.VARIANTS)
def test_each_variant_flags_the_references_stragglers(monkeypatch, reference, variant):
    window = LONG_WINDOW if variant == "radix" else WINDOW
    _shrunk(monkeypatch, reference, window)
    data, counts, truth = reference.make_telemetry(0)
    want = _reference_run(reference, variant, data, counts)
    if variant == bench.RINGS:
        times, got = bench.device_ring_scoring(data, counts, bench.REPORT_INTERVAL, "cpu",
                                               iters=ITERS)
        assert times["kernel_mode"] is None and times["per_step_ms"] > 0
    else:
        times, got = bench.device_scoring(data, counts, variant, "cpu", iters=ITERS)
        assert times["ms"] > 0
    assert times["timer"] == "host_clock" and "idle_share" not in times
    got_mask, want_mask = got.straggler.numpy(), np.asarray(want.straggler)
    assert np.array_equal(got_mask, want_mask) and got_mask.sum() == truth.sum()
    assert bench.f1(got_mask, truth) == reference.f1(want_mask, truth) == 1.0
    np.testing.assert_allclose(got.perf.numpy(), np.asarray(want.perf), rtol=RTOL)
    np.testing.assert_allclose(got.ewma.numpy(), np.asarray(want.ewma), rtol=RTOL)


def test_a_cpu_run_prints_the_references_keys_and_no_claim():
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_resiliency_torch.bench", "--device", "cpu", "--ranks",
         "128", "--signals", "8", "--iters", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    for key in ("metric", "value", "unit", "vs_baseline", "backend", "device_kind"):
        assert key in line, key
    assert line["vs_baseline"] is None and line["value"] > 0 and line["unit"] == "ms/step"
    assert (line["backend"], line["device_kind"], line["card"]) == ("cpu", "cpu", None)
    assert set(line["variants"]) == set(bench.VARIANTS)
    digests = {v["mask_digest"] for v in line["variants"].values()}
    assert len(digests) == 1
    for name, v in line["variants"].items():
        assert v["f1"] == 1.0 and v["launches"] == 0 and v["timer"] == "host_clock", name
        assert set(v["seconds"]) == {"ready", "set_up", "measure"}, name
    assert line["rings"]["per_step_ms"] == line["value"]


def test_without_a_card_it_exits_non_zero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "tpu_resiliency_torch.bench"], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


class FakeChild:
    """Stands in for ``VariantChild``: ``result`` is what its measurement returns."""

    result = None
    closed = []

    def __init__(self, variant, args):
        self.variant = variant

    def wait_ready(self):
        return 0.0

    def measure(self):
        if isinstance(self.result, Exception):
            raise self.result
        return dict(self.result, seconds={})

    def close(self):
        FakeChild.closed.append(self.variant)


def test_a_variant_that_fails_fails_the_run(monkeypatch):
    monkeypatch.setattr(FakeChild, "result", RuntimeError("variant sort failed (exit 1)"))
    monkeypatch.setattr(FakeChild, "closed", [])
    monkeypatch.setattr(bench, "VariantChild", FakeChild)
    with pytest.raises(RuntimeError, match="variant sort failed"):
        bench.main(["--device", "cpu", "--ranks", "64", "--signals", "4"])
    assert sorted(FakeChild.closed) == sorted(bench.VARIANTS)  # every child stopped


def test_a_variant_on_another_backend_fails_the_run(monkeypatch, capsys):
    monkeypatch.setattr(FakeChild, "result", {"backend": "cuda"})
    monkeypatch.setattr(FakeChild, "closed", [])
    monkeypatch.setattr(bench, "VariantChild", FakeChild)
    assert bench.main(["--device", "cpu", "--ranks", "64", "--signals", "4"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "ran on 'cuda'" in out.err
    assert sorted(FakeChild.closed) == sorted(bench.VARIANTS)


def test_a_child_that_dies_while_setting_up_fails_the_run(monkeypatch):
    args = bench.parse_args(["--device", "cpu", "--ranks", "-1"])  # make_telemetry refuses it
    child = bench.VariantChild("sort", args)
    try:
        with pytest.raises(RuntimeError, match="variant sort failed to set up"):
            child.wait_ready()
    finally:
        child.close()
