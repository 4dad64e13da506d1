"""``tpu_resiliency_torch/scripts/bench_configs.py`` held against the reference's
``scripts/bench_configs.py``: the reference's own test (``tests/test_bench_configs.py``)
runs on the port through ``torch_port_tests``, and each config runs side by side with
the reference's on the same seeded inputs.

The one edit to the reference's test: the script it starts is the port's module, on the
CPU (``-m tpu_resiliency_torch.scripts.bench_configs --device cpu``), since the port's
entry points run on the card by default.
"""

import importlib.util

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_tests import REPO, port_tests
from tpu_resiliency.telemetry import scoring as ref_scoring
from tpu_resiliency.telemetry.reporting import ReportGenerator as RefReportGenerator
from tpu_resiliency_torch.ops import scoring_kernels as sk
from tpu_resiliency_torch.scripts import bench_configs

port_tests(
    "tests/test_bench_configs.py", globals(),
    edits=[('os.path.join(REPO_ROOT, "scripts", "bench_configs.py"),',
            '"-m", "tpu_resiliency_torch.scripts.bench_configs", "--device", "cpu",',
            "the port's module, on the CPU: its default is the card")],
)

CPU = torch.device("cpu")
ITERS = 2


@pytest.fixture(scope="module")
def reference():
    """The reference script as a module (its ``main`` is not run)."""
    spec = importlib.util.spec_from_file_location("ref_bench_configs",
                                                  REPO / "scripts" / "bench_configs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_config1_flags_rank_17_in_both_and_the_perf_scores_agree(reference):
    ref = reference.config1(1)
    detail = {}
    port = bench_configs.config1(1, CPU, detail)
    assert ref["flagged"] == port["flagged"] == [17]
    assert ref["parity_semantics_ok"] and port["parity_semantics_ok"]
    assert ref["f1"] == port["f1"] == 1.0
    medians, weights, counts, names, _ = bench_configs.config1_inputs()
    gen = RefReportGenerator(world_size=64, max_signals=3)
    want = gen.generate_summary_report(jnp.asarray(medians), jnp.asarray(weights),
                                       jnp.asarray(counts), names)
    got = detail["report"]
    ranks = range(64)
    np.testing.assert_allclose([got.perf_scores[r] for r in ranks],
                               [want.perf_scores[r] for r in ranks], rtol=1e-6)


def test_config2_detects_the_same_rank_at_the_same_tick(reference, monkeypatch):
    """The reference's detected set reaches its ``f1`` (captured there); its latency is
    its line's. The port's map and latency must equal them exactly."""
    seen = []
    real_f1 = reference.f1
    monkeypatch.setattr(reference, "f1", lambda pred, truth: seen.append(set(pred))
                        or real_f1(pred, truth))
    ref = reference.config2(1)
    port = bench_configs.config2(1)
    assert seen == [{int(r) for r in port["detected"]}] == [{101}]
    assert port["detection_latency_s"] == ref["detection_latency_s"]
    assert port["detected"] == {"101": 29.0 + ref["detection_latency_s"]}
    assert port["latency_budget_s"] == ref["latency_budget_s"]
    assert port["f1"] == ref["f1"] == 1.0


def test_config3_flags_the_same_ranks_and_the_scores_agree():
    """The reference's ``score_round_jit`` over the same windows, ``ewma`` threaded the
    same ``1 + ITERS`` rounds, against the port's round (its window reduction from
    ``fused_median_weights``, the ``loop`` kernel's plain version on the CPU)."""
    data, counts, slow = bench_configs.config3_inputs()
    d, c = jnp.asarray(data), jnp.asarray(counts)
    hist = jnp.full(counts.shape, jnp.inf)
    out = ref_scoring.score_round_jit(d, c, jnp.ones((counts.shape[0],)), hist)
    for _ in range(ITERS):
        out = ref_scoring.score_round_jit(d, c, out.ewma, hist)
    detail = {}
    port = bench_configs.config3(ITERS, CPU, detail)
    got = detail["scores"]
    want_flagged = set(np.nonzero(np.asarray(out.straggler))[0].tolist())
    got_flagged = set(np.nonzero(got.straggler.numpy())[0].tolist())
    assert got_flagged == want_flagged == slow
    assert port["f1"] == 1.0 and port["flagged"] == len(slow)
    for name in ("section_scores", "individual_section_scores", "perf", "ewma"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(out, name)),
                                   rtol=1e-5, err_msg=name)
    assert port["medians_equal_sort_path_int32"]
    assert port["launches"] == dict.fromkeys(sk.MODES, 0)  # the plain version on the CPU
    assert port["timer"] == "host_clock"


def test_the_line_names_the_device_and_no_device_metric_on_the_cpu(tmp_path):
    results = bench_configs.run(bench_configs.parse_args(
        ["--out-dir", str(tmp_path), "--iters", "1", "--configs", "1,2", "--device", "cpu"]))
    for rec in results.values():
        assert (rec["backend"], rec["device_kind"], rec["card"]) == ("cpu", "cpu", None)
    assert results[1]["report_events_ms"] is None
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "BENCH_config1.json", "BENCH_config2.json", "BENCH_configs.json"]


def test_runs_on_the_card_by_default(tmp_path):
    args = bench_configs.parse_args(["--out-dir", str(tmp_path), "--configs", "1"])
    if torch.cuda.is_available():
        assert bench_configs.run(args)[1]["backend"] == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_configs.run(args)
