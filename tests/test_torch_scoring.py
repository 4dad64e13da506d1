"""The port's scoring pipeline (``tpu_resiliency_torch.telemetry.scoring`` and
``reporting``) held against the JAX package's, on the CPU.

Inputs are made from a numpy seed and handed to both. Tolerances: section and
individual scores rtol 1e-6; perf and EWMA rtol 1e-5 (weighted sums taken in another
order); robust-z atol 1e-4 plus rtol 1e-4 (z divides perf by 1.48 MAD, about 1e-2
here, so the perf noise of ~1e-7 grows a hundredfold and with |z|, which reaches -60
for a slow rank); medians, historical minima and the straggler mask exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_resiliency.ops.scoring_pallas import fused_median_weights as jax_median_weights
from tpu_resiliency.telemetry import scoring as jax_scoring
from tpu_resiliency.telemetry.reporting import ReportGenerator as JaxReportGenerator
from tpu_resiliency_torch.ops.scoring_kernels import fused_median_weights
from tpu_resiliency_torch.telemetry import scoring
from tpu_resiliency_torch.telemetry.reporting import ReportGenerator

TOL = {
    "section_scores": dict(rtol=1e-6, atol=0),
    "individual_section_scores": dict(rtol=1e-6, atol=0),
    "perf": dict(rtol=1e-5, atol=0),
    "ewma": dict(rtol=1e-5, atol=0),
    "z": dict(rtol=1e-4, atol=1e-4),
    "historical_min": dict(rtol=0, atol=0),
}


def telemetry(seed, r, s=8, w=16, slow=(3,)):
    """Gamma timings with slow ranks, a partially observed signal, a signal nobody
    measured and a rank that missed one signal."""
    rng = np.random.default_rng(seed)
    data = rng.gamma(4.0, 0.01, size=(r, s, w)).astype(np.float32)
    for k in slow:
        data[k] *= 1.8
    counts = np.full((r, s), w, dtype=np.int32)
    counts[:, s - 2] = rng.integers(1, w + 1, size=r)
    counts[:, s - 1] = 0
    counts[1, 0] = 0
    return data, counts


def assert_scores_match(jax_res, port_res):
    for name, tol in TOL.items():
        np.testing.assert_allclose(
            np.asarray(getattr(port_res, name)), np.asarray(getattr(jax_res, name)),
            err_msg=name, **tol,
        )
    np.testing.assert_array_equal(np.asarray(port_res.straggler), np.asarray(jax_res.straggler))


def port_score(data, counts, ewma, hist, *, use_kernel, **kw):
    d, c = torch.from_numpy(data), torch.from_numpy(counts)
    mw = fused_median_weights(d, c) if use_kernel else None
    res = scoring.score_round(
        d, c, torch.from_numpy(ewma), torch.from_numpy(hist), medians_and_weights=mw, **kw
    )
    return scoring.scores_to_host(res)


def jax_score(data, counts, ewma, hist, *, use_kernel, **kw):
    mw = (
        jax_median_weights(jnp.asarray(data), jnp.asarray(counts), interpret=True, mode="loop")
        if use_kernel
        else None
    )
    return jax_scoring.score_round(
        jnp.asarray(data), jnp.asarray(counts), jnp.asarray(ewma), jnp.asarray(hist),
        medians_and_weights=mw, **kw,
    )


@pytest.mark.parametrize("use_kernel", [False, True], ids=["sort", "kernel"])
@pytest.mark.parametrize("r", [16, 24])
def test_score_round_matches_jax(r, use_kernel):
    data, counts = telemetry(seed=r, r=r)
    rng = np.random.default_rng(r + 1)
    ewma = rng.uniform(0.5, 1.0, size=r).astype(np.float32)
    hist = rng.gamma(4.0, 0.01, size=(r, 8)).astype(np.float32)
    hist[:, 0] = np.inf
    ref = jax_score(data, counts, ewma, hist, use_kernel=use_kernel)
    got = port_score(data, counts, ewma, hist, use_kernel=use_kernel)
    assert_scores_match(ref, got)
    assert got.straggler[3] and got.straggler.sum() >= 1


@pytest.mark.parametrize("threshold,z_threshold,alpha", [(0.9, 2.0, 0.3), (0.5, 5.0, 0.9)])
def test_score_round_options_match_jax(threshold, z_threshold, alpha):
    data, counts = telemetry(seed=5, r=16, slow=(2, 9))
    ewma = np.ones(16, np.float32)
    hist = np.full((16, 8), np.inf, np.float32)
    kw = dict(threshold=threshold, z_threshold=z_threshold, alpha=alpha)
    assert_scores_match(
        jax_score(data, counts, ewma, hist, use_kernel=False, **kw),
        port_score(data, counts, ewma, hist, use_kernel=False, **kw),
    )


def test_masked_median_and_total_match_jax():
    rng = np.random.default_rng(0)
    data = np.round(rng.standard_normal((6, 5, 9)), 1).astype(np.float32)
    counts = rng.integers(0, 10, size=(6, 5)).astype(np.int32)
    counts[0, 0], counts[0, 1] = 0, 1
    jm = np.asarray(jax_scoring.masked_median(jnp.asarray(data), jnp.asarray(counts)))
    jt = np.asarray(jax_scoring.masked_total(jnp.asarray(data), jnp.asarray(counts)))
    tm = scoring.masked_median(torch.from_numpy(data), torch.from_numpy(counts)).numpy()
    tt = scoring.masked_total(torch.from_numpy(data), torch.from_numpy(counts)).numpy()
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(tt, jt, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("w", [1, 4, 7, 32])
def test_masked_median_matches_jax_at_every_count(w):
    """Counts 0 .. 2W + 1: from 2W on an order statistic lies past the window, where
    ``jnp.take_along_axis`` gives NaN; the port must give NaN at the same places."""
    rng = np.random.default_rng(100 + w)
    counts = np.arange(2 * w + 2, dtype=np.int32)
    data = np.round(rng.standard_normal((counts.size, w)), 1).astype(np.float32)
    jm = np.asarray(jax_scoring.masked_median(jnp.asarray(data), jnp.asarray(counts)))
    tm = scoring.masked_median(torch.from_numpy(data), torch.from_numpy(counts)).numpy()
    np.testing.assert_array_equal(np.isnan(tm), np.isnan(jm))
    np.testing.assert_array_equal(tm, jm)
    assert np.isinf(tm[0]) and np.isnan(tm[2 * w :]).all() and not np.isnan(tm[: 2 * w]).any()


def test_masked_median_past_twice_the_window_is_nan_as_in_jax():
    data = np.array([[3.0, 1.0, 2.0, 5.0]] * 8, np.float32)
    counts = np.array([0, 3, 4, 5, 7, 8, 9, 2**20], np.int32)
    jm = np.asarray(jax_scoring.masked_median(jnp.asarray(data), jnp.asarray(counts)))
    tm = scoring.masked_median(torch.from_numpy(data), torch.from_numpy(counts)).numpy()
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tm[:5], np.array([np.inf, 2.0, 2.5, 3.0, 5.0], np.float32))
    assert np.isnan(tm[5:]).all()
    jt = np.asarray(jax_scoring.masked_total(jnp.asarray(data), jnp.asarray(counts)))
    tt = scoring.masked_total(torch.from_numpy(data), torch.from_numpy(counts)).numpy()
    np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("n", [4, 5, 16])
def test_robust_z_takes_the_mean_of_the_two_middles(n):
    """``jnp.median`` of an even count is the mean of the two middle values;
    ``torch.median`` would give the lower one."""
    rng = np.random.default_rng(n)
    x = rng.uniform(0.5, 1.0, size=n).astype(np.float32)
    ref = np.asarray(jax_scoring.robust_z(jnp.asarray(x)))
    got = scoring.robust_z(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    if n % 2 == 0:
        s = np.sort(x)
        assert float(scoring._median(torch.from_numpy(x))) == np.float32(
            0.5 * (s[n // 2 - 1] + s[n // 2])
        )


def test_score_summary_matches_jax():
    data, counts = telemetry(seed=7, r=16)
    med = np.asarray(jax_scoring.masked_median(jnp.asarray(data), jnp.asarray(counts)))
    wt = np.asarray(jax_scoring.masked_total(jnp.asarray(data), jnp.asarray(counts)))
    ewma = np.ones(16, np.float32)
    hist = np.full((16, 8), np.inf, np.float32)
    ref = jax_scoring.score_summary_jit(*(jnp.asarray(x) for x in (med, wt, counts, ewma, hist)))
    got = scoring.score_summary(*(torch.from_numpy(np.array(x)) for x in (med, wt, counts, ewma, hist)))
    assert_scores_match(ref, scoring.scores_to_host(got))


def test_scores_to_host_is_one_copy(monkeypatch):
    data, counts = telemetry(seed=8, r=8)
    res = scoring.score_round(
        torch.from_numpy(data), torch.from_numpy(counts),
        torch.ones(8), torch.full((8, 8), float("inf")),
    )
    calls = []
    real_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda t, *a, **k: calls.append(1) or real_cpu(t, *a, **k))
    host = scoring.scores_to_host(res)
    assert len(calls) == 1
    for name in TOL:
        arr = getattr(host, name)
        assert isinstance(arr, np.ndarray) and arr.dtype == np.float32
        np.testing.assert_array_equal(arr, getattr(res, name).numpy())
    assert host.straggler.dtype == bool and host.straggler.shape == (8,)
    np.testing.assert_array_equal(host.straggler, res.straggler.numpy())


def test_sharded_mode_is_not_ported_yet():
    """The group mode is ported (``tests/test_torch_group_scoring.py`` holds it against
    the reference); what stays is that ``group`` must be a process group."""
    data, counts = telemetry(seed=9, r=8)
    with pytest.raises(TypeError, match="process group"):
        scoring.score_round(
            torch.from_numpy(data), torch.from_numpy(counts), torch.ones(8),
            torch.full((8, 8), float("inf")), group=object(),
        )


def _assert_reports_equal(ref, got):
    assert (got.rank, got.world_size, got.iteration, got.section_names) == (
        ref.rank, ref.world_size, ref.iteration, ref.section_names,
    )
    for field, tol in (
        ("relative_section_scores", TOL["section_scores"]),
        ("individual_section_scores", TOL["individual_section_scores"]),
        ("perf_scores", TOL["perf"]),
        ("ewma_scores", TOL["ewma"]),
        ("z_scores", TOL["z"]),
    ):
        a, b = getattr(ref, field), getattr(got, field)
        assert list(a) == list(b), field
        np.testing.assert_allclose(list(b.values()), list(a.values()), err_msg=field, **tol)
    np.testing.assert_allclose(got.global_section_scores, ref.global_section_scores, rtol=1e-6)
    assert got.rank_to_host == ref.rank_to_host
    rs, gs = ref.identify_stragglers(), got.identify_stragglers()
    assert {s.rank for s in gs.by_perf} == {s.rank for s in rs.by_perf}
    assert {k: {s.rank for s in v} for k, v in gs.by_section.items()} == {
        k: {s.rank for s in v} for k, v in rs.by_section.items()
    }


@pytest.mark.parametrize("use_kernel", [False, True], ids=["sort", "kernel"])
def test_report_generator_carries_state_like_jax(use_kernel):
    r, s = 16, 8
    names = tuple(f"s{i}" for i in range(s - 1))  # the last column is capacity only
    hosts = {i: f"h{i // 4}" for i in range(r)}
    ref_gen = JaxReportGenerator(r, s, use_pallas=use_kernel, rank_to_host=hosts)
    gen = ReportGenerator(r, s, use_kernel=use_kernel, rank_to_host=hosts, device="cpu")
    for round_ in range(2):
        data, counts = telemetry(seed=20 + round_, r=r)
        data = data[:, : s - 1]
        counts = counts[:, : s - 1]
        ref = ref_gen.generate_report(jnp.asarray(data), jnp.asarray(counts), names, rank=3)
        got = gen.generate_report(torch.from_numpy(data), torch.from_numpy(counts), names, rank=3)
        _assert_reports_equal(ref, got)
    np.testing.assert_array_equal(gen._hist_min.numpy(), np.asarray(ref_gen._hist_min))
    np.testing.assert_allclose(gen._ewma.numpy(), np.asarray(ref_gen._ewma), rtol=1e-5)


def test_report_generator_load_state_resumes_a_jax_run():
    r, s = 16, 8
    names = tuple(f"s{i}" for i in range(s))
    ref_gen = JaxReportGenerator(r, s)
    data, counts = telemetry(seed=30, r=r)
    ref_gen.generate_report(jnp.asarray(data), jnp.asarray(counts), names)

    gen = ReportGenerator(r, s, device="cpu")
    gen.load_state(np.asarray(ref_gen._ewma), np.asarray(ref_gen._hist_min))
    gen.iteration = ref_gen.iteration
    assert np.isfinite(gen._hist_min.numpy()[:, 2]).all()
    data, counts = telemetry(seed=31, r=r, slow=(5,))
    ref = ref_gen.generate_report(jnp.asarray(data), jnp.asarray(counts), names)
    got = gen.generate_report(torch.from_numpy(data), torch.from_numpy(counts), names)
    _assert_reports_equal(ref, got)
    with pytest.raises(ValueError, match="expected ewma"):
        gen.load_state(np.ones(r + 1), np.ones((r, s)))


def test_report_generator_summary_path_matches_jax():
    r, s = 16, 8
    names = tuple(f"s{i}" for i in range(s))
    data, counts = telemetry(seed=40, r=r)
    med = np.asarray(jax_scoring.masked_median(jnp.asarray(data), jnp.asarray(counts)))
    wt = np.asarray(jax_scoring.masked_total(jnp.asarray(data), jnp.asarray(counts)))
    ref = JaxReportGenerator(r, s).generate_summary_report(
        jnp.asarray(med), jnp.asarray(wt), jnp.asarray(counts), names
    )
    got = ReportGenerator(r, s, device="cpu").generate_summary_report(
        torch.from_numpy(np.array(med)), torch.from_numpy(np.array(wt)),
        torch.from_numpy(counts), names,
    )
    _assert_reports_equal(ref, got)
