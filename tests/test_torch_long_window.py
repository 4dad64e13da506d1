"""The port's long-window telemetry path held against the JAX package's, on the CPU.

At R = 16 ranks, S = 6 signals and window W = 160, past the TPU's loop cap of 128,
JAX's ``MeshTelemetry(use_pallas=True)`` and ``ReportGenerator(use_pallas=True)``
reduce the windows with the Pallas ``radix`` kernel (interpret mode). The port runs
the same rows through ``MeshTelemetry(use_kernel=True)`` and
``ReportGenerator(use_kernel=True)`` on the CPU, with the loop cap below 160 so that
its auto mode is ``radix`` too. Reports must agree within ``test_torch_scoring.TOL``;
ring, counts, cursor and historical minima exactly. The ``gpu`` test runs the port
on the card against its CPU path and skips where there is no card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tests.test_torch_scoring import _assert_reports_equal, telemetry
from tests.test_torch_sharded import assert_states_equal, rows
from tpu_resiliency.telemetry.reporting import ReportGenerator as JaxReportGenerator
from tpu_resiliency.telemetry.sharded import MeshTelemetry as JaxMeshTelemetry
from tpu_resiliency_torch.ops import scoring_kernels as sk
from tpu_resiliency_torch.telemetry.reporting import ReportGenerator
from tpu_resiliency_torch.telemetry.sharded import MeshTelemetry

R, S, W = 16, 6, 160
NAMES = tuple(f"s{i}" for i in range(S))
PARTIAL = 100  # pushes before the second report: a window filled 100 of 160


@pytest.fixture(autouse=True)
def radix_past_128(monkeypatch):
    """The TPU package's cap (128) for the port too, whatever the H100 sweep set."""
    monkeypatch.setenv(sk.MAX_WINDOW_ENV, "128")
    monkeypatch.delenv(sk.RADIX_ENV, raising=False)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.asarray(jax.devices()[:1]), ("rank",))


@pytest.mark.parametrize("use_kernel", [False, True], ids=["sort", "kernel"])
def test_full_then_partial_window_reports_match_jax(mesh, use_kernel):
    jmt = JaxMeshTelemetry(mesh, "rank", n_ranks=R, signal_names=NAMES, window=W,
                           use_pallas=use_kernel)
    mt = MeshTelemetry(R, signal_names=NAMES, window=W, use_kernel=use_kernel, device="cpu")
    assert mt.kernel_mode == ("radix" if use_kernel else None)
    js, ps = jmt.init_state(), mt.init_state()
    for v in rows(21, W):
        js = jmt.push(js, jnp.asarray(v))
        mt.push(ps, torch.from_numpy(v))
    assert_states_equal(js, ps)
    js, ref1 = jmt.generate_report(js, rank=1)
    ps, got1 = mt.generate_report(ps, rank=1)
    _assert_reports_equal(ref1, got1)
    assert {s.rank for s in got1.identify_stragglers().by_perf} == {5}
    assert_states_equal(js, ps)
    for v in rows(22, PARTIAL, slow=(5, 11)):
        js = jmt.push(js, jnp.asarray(v))
        mt.push(ps, torch.from_numpy(v))
    assert int(ps.counts.max()) == PARTIAL < W
    js, ref2 = jmt.generate_report(js)
    ps, got2 = mt.generate_report(ps)
    _assert_reports_equal(ref2, got2)
    assert {s.rank for s in got2.identify_stragglers().by_perf} == {5, 11}
    assert_states_equal(js, ps)


def test_report_generator_long_windows_match_jax():
    r, s = 16, 8
    names = tuple(f"s{i}" for i in range(s))
    ref_gen = JaxReportGenerator(r, s, use_pallas=True)
    gen = ReportGenerator(r, s, use_kernel=True, device="cpu")
    for round_ in range(2):
        data, counts = telemetry(seed=50 + round_, r=r, w=W, slow=(3, 7))
        ref = ref_gen.generate_report(jnp.asarray(data), jnp.asarray(counts), names, rank=2)
        got = gen.generate_report(torch.from_numpy(data), torch.from_numpy(counts), names, rank=2)
        _assert_reports_equal(ref, got)
        assert {x.rank for x in got.identify_stragglers().by_perf} >= {3, 7}
    np.testing.assert_array_equal(gen._hist_min.numpy(), np.asarray(ref_gen._hist_min))
    np.testing.assert_allclose(gen._ewma.numpy(), np.asarray(ref_gen._ewma), rtol=1e-5)


@pytest.mark.gpu
def test_card_long_window_goes_through_radix_and_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    mt = MeshTelemetry(R, signal_names=NAMES, window=W)
    assert mt.kernel_mode == "radix"
    ref = MeshTelemetry(R, signal_names=NAMES, window=W, device="cpu", use_kernel=True)
    ps, rs = mt.init_state(), ref.init_state()
    for v in rows(23, W):
        mt.push(ps, torch.from_numpy(v).cuda())
        ref.push(rs, torch.from_numpy(v))
    sk.reset_launches()
    ps, got = mt.generate_report(ps)
    rs, want = ref.generate_report(rs)
    assert sk.fused_median_weights.launches_by_mode == {"loop": 0, "pairwise": 0, "radix": 1}
    _assert_reports_equal(want, got)
    np.testing.assert_array_equal(ps.hist_min.cpu().numpy(), rs.hist_min.numpy())
