"""The port's device-resident telemetry (``tpu_resiliency_torch.telemetry.sharded``)
held against the JAX package's ``MeshTelemetry`` on a one-device CPU mesh.

Both are fed the same seeded rows. Reports compare with the tolerances of
``test_torch_scoring.py``; ring contents, counts, cursors and historical minima
exactly. Tests marked ``gpu`` run the port on the card against its CPU path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tests.test_torch_scoring import TOL, _assert_reports_equal
from tpu_resiliency.telemetry.sharded import MeshTelemetry as JaxMeshTelemetry
from tpu_resiliency_torch.ops import scoring_kernels as sk
from tpu_resiliency_torch.telemetry.convert import (
    telemetry_state_from_numpy,
    telemetry_state_to_numpy,
)
from tpu_resiliency_torch.telemetry.sharded import MeshTelemetry

R, S, W = 16, 6, 8
NAMES = tuple(f"s{i}" for i in range(S))


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.asarray(jax.devices()[:1]), ("rank",))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def rows(seed, n, slow=(5,)):
    """``n`` step rows [R, S]: a homogeneous fleet with per-rank jitter, drifting
    per step, and slow ranks."""
    rng = np.random.default_rng(seed)
    base = np.tile(rng.gamma(4.0, 0.01, size=(1, S)), (R, 1)).astype(np.float32)
    base *= 1.0 + rng.uniform(-0.05, 0.05, size=(R, S)).astype(np.float32)
    out = []
    for i in range(n):
        v = base * (1.0 + 0.01 * i) * rng.uniform(0.97, 1.03, size=(R, S)).astype(np.float32)
        for k in slow:
            v[k] *= 3.0
        out.append(v.astype(np.float32))
    return out


def jax_state_numpy(state):
    return tuple(np.asarray(x) for x in (state.data, state.counts, state.cursor, state.ewma,
                                         state.hist_min))


def assert_states_equal(jax_state, port_state):
    jd, jc, jcur, je, jh = jax_state_numpy(jax_state)
    pd, pc, pcur, pe, ph = telemetry_state_to_numpy(port_state)
    np.testing.assert_array_equal(pd, jd)
    np.testing.assert_array_equal(pc, jc)
    assert int(pcur) == int(jcur)
    np.testing.assert_allclose(pe, je, **TOL["ewma"])
    np.testing.assert_array_equal(ph, jh)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["sort", "kernel"])
def test_two_reports_with_a_wrapped_ring_match_jax(mesh, use_kernel):
    jmt = JaxMeshTelemetry(mesh, "rank", n_ranks=R, signal_names=NAMES, window=W,
                           use_pallas=use_kernel)
    mt = MeshTelemetry(R, signal_names=NAMES, window=W, use_kernel=use_kernel, device="cpu")
    assert mt.use_kernel is use_kernel
    js, ps = jmt.init_state(), mt.init_state()
    assert_states_equal(js, ps)
    first, second = rows(1, W + 3), rows(2, W)
    for v in first:  # overfill: the ring wraps
        js = jmt.push(js, jnp.asarray(v))
        assert mt.push(ps, torch.from_numpy(v)) is ps
    assert_states_equal(js, ps)
    js, ref1 = jmt.generate_report(js, rank=2)
    ps, got1 = mt.generate_report(ps, rank=2)
    _assert_reports_equal(ref1, got1)
    assert {s.rank for s in got1.identify_stragglers().by_perf} == {5}
    assert int(ps.counts.sum()) == 0 and int(ps.cursor) == 0
    assert_states_equal(js, ps)
    for v in second:
        js = jmt.push(js, jnp.asarray(v))
        mt.push(ps, v)  # numpy rows are taken too
    js, ref2 = jmt.generate_report(js)
    ps, got2 = mt.generate_report(ps)
    _assert_reports_equal(ref2, got2)
    assert got2.iteration == 2
    assert got2.ewma_scores[5] < got1.ewma_scores[5] < 1.0
    assert_states_equal(js, ps)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["sort", "kernel"])
def test_resume_from_a_jax_mid_run_state(mesh, use_kernel):
    """Start the port from the JAX package's state mid-run: a wrapped ring, a carried
    EWMA, a finite historical minimum, and a cursor that is not a multiple of W."""
    jmt = JaxMeshTelemetry(mesh, "rank", n_ranks=R, signal_names=NAMES, window=W,
                           use_pallas=use_kernel)
    js = jmt.init_state()
    for v in rows(3, W + 3):
        js = jmt.push(js, jnp.asarray(v))
    js, _ = jmt.generate_report(js)
    for v in rows(4, W + 5):
        js = jmt.push(js, jnp.asarray(v))
    leaves = jax_state_numpy(js)
    assert np.isfinite(leaves[4]).all() and (leaves[3] != 1.0).any()

    ps = telemetry_state_from_numpy(*leaves, device="cpu")
    assert_states_equal(js, ps)
    mt = MeshTelemetry(R, signal_names=NAMES, window=W, use_kernel=use_kernel, device="cpu")
    mt.iteration = jmt.iteration
    for v in rows(5, 3, slow=(5, 9)):
        js = jmt.push(js, jnp.asarray(v))
        mt.push(ps, torch.from_numpy(v))
    js, ref = jmt.generate_report(js)
    ps, got = mt.generate_report(ps)
    _assert_reports_equal(ref, got)
    assert_states_equal(js, ps)


def test_state_round_trips_through_numpy():
    rng = np.random.default_rng(6)
    leaves = (
        rng.standard_normal((W, R, S)).astype(np.float32),
        rng.integers(0, W + 1, size=(R, S)).astype(np.int32),
        np.asarray(13, np.int32),
        rng.uniform(size=R).astype(np.float32),
        rng.uniform(size=(R, S)).astype(np.float32),
    )
    state = telemetry_state_from_numpy(*leaves, device="cpu")
    assert state.cursor.dtype == torch.int64 and state.counts.dtype == torch.int32
    for a, b in zip(leaves, telemetry_state_to_numpy(state)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    with pytest.raises(ValueError, match="disagree"):
        telemetry_state_from_numpy(leaves[0], leaves[1][:, :2], *leaves[2:], device="cpu")


def test_kernel_choice_is_made_once_at_construction():
    assert MeshTelemetry(R, signal_names=NAMES, device="cpu").use_kernel is False
    assert MeshTelemetry(R, signal_names=NAMES, use_kernel=True, device="cpu").use_kernel
    with pytest.raises(ValueError, match="use_kernel=False"):
        MeshTelemetry(R, window=sk.MAX_WINDOW + 1, use_kernel=True, device="cpu")


@pytest.mark.gpu
def test_card_run_goes_through_the_kernel_and_matches_the_cpu(cuda):
    mt = MeshTelemetry(R, signal_names=NAMES, window=W)
    assert mt.device.type == "cuda" and mt.use_kernel
    ref = MeshTelemetry(R, signal_names=NAMES, window=W, device="cpu")
    ps, rs = mt.init_state(), ref.init_state()
    for v in rows(7, W + 2):
        mt.push(ps, torch.from_numpy(v).to(cuda))
        ref.push(rs, torch.from_numpy(v))
    before = sk.fused_median_weights.launches
    ps, got = mt.generate_report(ps)
    rs, want = ref.generate_report(rs)
    assert sk.fused_median_weights.launches == before + 1
    _assert_reports_equal(want, got)
    np.testing.assert_array_equal(ps.hist_min.cpu().numpy(), rs.hist_min.numpy())
