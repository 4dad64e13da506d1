"""The port's ``pairwise`` and ``radix`` window reductions and its mode selection
(``tpu_resiliency_torch.ops.scoring_kernels``) held against the JAX package's Pallas
kernels of the same modes and its ``auto_mode``/``pallas_supported``, on the CPU.

The JAX kernels run in interpret mode at small R and S, as the JAX package's own
tests run them. Inputs are made from a numpy seed and handed to both. Each mode's
medians must equal the JAX kernel's of the same mode bit for bit, compared as int32:
the kernels disagree on signed zeros (``radix`` keeps a selected -0.0, ``loop`` and
``pairwise`` add it into +0.0), and ``np.testing.assert_array_equal`` would call the
two equal. Across modes, medians agree by value. Weights are f32 sums taken in
another order than the JAX kernel's: each lies within 1e-5 of its window's sum of
absolute values. Tests marked ``gpu`` hold each CUDA kernel against its plain version
on the card and skip where there is none.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from chip_smoke import radix_adversarial
from tests.test_torch_scoring_kernels import _assert_weights_close, _bits
from tpu_resiliency.ops.scoring_pallas import fused_median_weights as jax_median_weights
from tpu_resiliency_torch.ops import scoring_kernels as sk
from tpu_resiliency_torch.telemetry import sharded

NEG_ZERO_BITS = np.int32(-(2**31))


def _windows(seed, r, s, w, *, past_window=True):
    """Rounded normals (negatives, many ties, -0.0), an all-equal rank, a window of
    signed zeros, and counts covering 0, 1, partial and full windows, plus one count
    past W unless ``past_window`` is False."""
    rng = np.random.default_rng(seed)
    data = np.round(rng.standard_normal((r, s, w)), 1).astype(np.float32)
    data[1] = 3.0
    data[2, 0] = -1.5
    data[3, 0] = -0.0
    data[3, 1, ::2] = 0.0
    counts = rng.integers(0, w + 1, size=(r, s)).astype(np.int32)
    counts[0, 0] = 0
    counts[0, 1] = 1
    counts[1, 0] = w
    counts[3, :2] = w
    if past_window:
        counts[2, 1] = w + 3
    return data, counts


def _both(mode, data, counts):
    jm, jw = jax_median_weights(jnp.asarray(data), jnp.asarray(counts), interpret=True, mode=mode)
    tm, tw = sk.fused_median_weights(torch.from_numpy(data), torch.from_numpy(counts), mode=mode)
    return (np.asarray(jm), np.asarray(jw)), (tm.numpy(), tw.numpy())


@pytest.mark.parametrize("w", [1, 7, 33, 129, 200])
def test_plain_radix_matches_pallas_radix_bit_for_bit(w):
    data, counts = _windows(w, 8, 6, w)
    (jm, jw), (tm, tw) = _both("radix", data, counts)
    assert tm.shape == (8, 6) and tm.dtype == np.float32
    np.testing.assert_array_equal(_bits(tm), _bits(jm))
    assert np.isinf(tm[0, 0])
    assert _bits(tm)[3, 0] == NEG_ZERO_BITS  # a window of -0.0 selects -0.0
    _assert_weights_close(tw, jw, data, counts)


@pytest.mark.parametrize("w", [1, 5, 16, 32])
def test_plain_pairwise_matches_pallas_pairwise_bit_for_bit(w):
    data, counts = _windows(w + 50, 8, 6, w)
    (jm, jw), (tm, tw) = _both("pairwise", data, counts)
    np.testing.assert_array_equal(_bits(tm), _bits(jm))
    assert np.isinf(tm[0, 0])
    # -0.0 is added into +0.0, except over one slot, whose sum XLA folds away.
    assert _bits(tm)[3, 0] == (NEG_ZERO_BITS if w == 1 else 0)
    _assert_weights_close(tw, jw, data, counts)


def test_signed_zeros_follow_each_mode():
    """Windows [-0.0, 0.0, -0.0, 1.0] with count 3: radix extracts -0.0; loop and
    pairwise sum it into +0.0. Each port mode gives its JAX kernel's bits."""
    data = np.array([-0.0, 0.0, -0.0, 1.0], np.float32).reshape(1, 1, 4)
    counts = np.array([[3]], np.int32)
    want = {"loop": 0, "pairwise": 0, "radix": NEG_ZERO_BITS}
    for mode, bits in want.items():
        (jm, _), (tm, _) = _both(mode, data, counts)
        assert _bits(jm)[0, 0] == bits, mode
        assert _bits(tm)[0, 0] == bits, mode
        assert tm[0, 0] == 0.0


@pytest.mark.parametrize("w", [1, 7, 33, 129])
def test_modes_agree_by_value(w):
    data, counts = _windows(w + 100, 6, 5, w, past_window=False)
    d, c = torch.from_numpy(data), torch.from_numpy(counts)
    results = {mode: sk.fused_median_weights(d, c, mode=mode) for mode in sk.MODES}
    loop_med, loop_wt = results["loop"]
    for mode in ("pairwise", "radix"):
        med, wt = results[mode]
        np.testing.assert_array_equal(med.numpy(), loop_med.numpy())
        np.testing.assert_array_equal(_bits(wt), _bits(loop_wt))  # one masked sum
    differ = _bits(results["radix"][0]) != _bits(loop_med)
    assert (loop_med.numpy()[differ] == 0).all()  # only the sign of a zero


@st.composite
def radix_case(draw):
    """``test_properties.py``'s ``radix_case``: windows short and past the TPU cap,
    positive floats of many magnitudes, counts 0..W."""
    r = draw(st.integers(2, 6))
    s = draw(st.integers(1, 3))
    w = draw(st.one_of(st.integers(1, 10), st.integers(129, 260)))
    data = draw(
        st.lists(
            st.floats(np.float32(1e-4), np.float32(1e3), allow_nan=False,
                      allow_subnormal=False, width=32),
            min_size=r * s * w,
            max_size=r * s * w,
        )
    )
    counts = draw(st.lists(st.integers(0, w), min_size=r * s, max_size=r * s))
    return (
        np.asarray(data, np.float32).reshape(r, s, w),
        np.asarray(counts, np.int32).reshape(r, s),
    )


@settings(max_examples=25, deadline=None)
@given(radix_case())
def test_plain_radix_matches_plain_loop(case):
    """Mirror of ``test_radix_kernel_matches_loop_kernel`` on the port's plain
    versions: bit-identical medians and weights on positive windows."""
    data, counts = (torch.from_numpy(x) for x in case)
    loop = sk.median_weights_reference(data, counts)
    radix = sk.median_weights_radix_reference(data, counts)
    np.testing.assert_array_equal(_bits(radix[0]), _bits(loop[0]))
    np.testing.assert_array_equal(_bits(radix[1]), _bits(loop[1]))


def test_order_key_orders_as_the_floats():
    x = torch.tensor([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0, np.inf], dtype=torch.float32)
    key = sk._order_key(x)
    assert (key[1:] > key[:-1]).all()
    assert int(key.min()) >= 0 and int(key.max()) < 2**32
    assert int(key[3]) == 0x7FFFFFFF and int(key[4]) == 0x80000000


# -- mode selection ----------------------------------------------------------------


def test_window_gate(monkeypatch):
    """Mirror of ``test_pallas_window_gate`` on the port's own constants: auto picks
    ``loop`` up to the cap and ``radix`` past it (while radix auto is on); explicit
    ``loop`` stays capped; ``pairwise`` has its own bound; the cap is overridable by
    the port's own variable."""
    monkeypatch.delenv(sk.MAX_WINDOW_ENV, raising=False)
    monkeypatch.delenv(sk.RADIX_ENV, raising=False)
    cap = sk.DEFAULT_MAX_WINDOW
    assert sk.max_auto_window() == cap
    assert sk.radix_auto_enabled() is sk.DEFAULT_RADIX_AUTO
    assert sk.auto_mode(cap) == "loop"
    assert sk.auto_mode(cap + 1) == "radix"
    assert sk.kernel_supported(cap, 64)
    assert sk.kernel_supported(512, 64) is sk.DEFAULT_RADIX_AUTO
    monkeypatch.setenv(sk.RADIX_ENV, "off")
    assert not sk.kernel_supported(512, 64)
    assert sk.kernel_supported(512, 64, mode="radix")  # explicit radix always works
    monkeypatch.setenv(sk.RADIX_ENV, "on")
    assert sk.kernel_supported(512, 64) and sk.kernel_supported(1024, 64)
    monkeypatch.delenv(sk.RADIX_ENV)
    # Explicit loop stays capped: no silent O(W^2) reduction of a long window.
    assert sk.kernel_supported(cap, 64, mode="loop")
    assert not sk.kernel_supported(cap + 1, 64, mode="loop")
    # Pairwise carries its own bound, independent of the loop cap.
    pairwise_cap = sk.MODE_MAX_WINDOW["pairwise"]
    assert pairwise_cap > sk.max_auto_window()
    assert sk.kernel_supported(pairwise_cap, 64, mode="pairwise")
    assert not sk.kernel_supported(pairwise_cap + 1, 64, mode="pairwise")
    assert sk.kernel_supported(sk.TILE_MAX_WINDOW, 64, mode="radix")
    assert not sk.kernel_supported(sk.TILE_MAX_WINDOW + 1, 64, mode="radix")
    # An operator's smaller crossover hands the window to radix earlier.
    monkeypatch.setenv(sk.MAX_WINDOW_ENV, "16")
    assert sk.auto_mode(32) == "radix"
    assert sk.kernel_supported(16, 64, mode="loop")
    assert not sk.kernel_supported(32, 64, mode="loop")
    monkeypatch.setenv(sk.MAX_WINDOW_ENV, "junk")
    assert sk.max_auto_window() == sk.DEFAULT_MAX_WINDOW
    with pytest.raises(ValueError, match="unknown mode"):
        sk.kernel_supported(32, 64, mode="bitonic")


def test_port_gate_ignores_the_tpu_variables(monkeypatch):
    monkeypatch.delenv(sk.MAX_WINDOW_ENV, raising=False)
    monkeypatch.delenv(sk.RADIX_ENV, raising=False)
    monkeypatch.setenv("TPU_RESILIENCY_PALLAS_MAX_WINDOW", "100000")
    monkeypatch.setenv("TPU_RESILIENCY_PALLAS_RADIX", "off" if sk.DEFAULT_RADIX_AUTO else "on")
    assert sk.max_auto_window() == sk.DEFAULT_MAX_WINDOW
    assert sk.radix_auto_enabled() is sk.DEFAULT_RADIX_AUTO
    assert sk.MAX_WINDOW_ENV.startswith("TPU_RESILIENCY_CUDA_")
    assert sk.RADIX_ENV.startswith("TPU_RESILIENCY_CUDA_")


@pytest.mark.parametrize("w", [8, 40, 160])
def test_default_mode_is_the_auto_mode(monkeypatch, w):
    """``mode=None`` is the JAX default and means ``auto_mode``; it used to raise."""
    monkeypatch.setenv(sk.MAX_WINDOW_ENV, "32")
    assert inspect.signature(sk.fused_median_weights).parameters["mode"].default is None
    data, counts = _windows(w + 200, 4, 3, w)
    d, c = torch.from_numpy(data), torch.from_numpy(counts)
    med, wt = sk.fused_median_weights(d, c, mode=None)
    want = sk.PLAIN_VERSIONS[sk.auto_mode(w)](d, c)
    assert sk.auto_mode(w) == ("loop" if w <= 32 else "radix")
    np.testing.assert_array_equal(_bits(med), _bits(want[0]))
    np.testing.assert_array_equal(_bits(wt), _bits(want[1]))
    if w == 8:  # the JAX package's own default agrees (loop at W=8 on both)
        (jm, _), _ = _both(None, data, counts)
        np.testing.assert_array_equal(_bits(med), _bits(jm))


@pytest.mark.parametrize("w", [16, 32, 33, 160, 512, 1024])
def test_long_windows_never_go_to_loop(monkeypatch, w):
    """``MeshTelemetry(use_kernel=None)`` on a card used to hand any window up to the
    loop kernel's shared-memory limit to the O(W^2) loop; past the cap it now runs
    radix, or the sort path when radix auto-selection is off."""
    monkeypatch.delenv(sk.RADIX_ENV, raising=False)
    monkeypatch.setenv(sk.MAX_WINDOW_ENV, "32")
    monkeypatch.setattr(sharded, "resolve_device", lambda device: torch.device("cuda"))
    mt = sharded.MeshTelemetry(16, signal_names=("a", "b"), window=w)
    want = "loop" if w <= 32 else ("radix" if sk.DEFAULT_RADIX_AUTO else None)
    assert mt.kernel_mode == want
    assert mt.use_kernel is (want is not None)
    monkeypatch.setenv(sk.RADIX_ENV, "off")
    assert sharded.select_kernel_mode(w, 2, None, "cuda") == ("loop" if w <= 32 else None)
    # Asked for a kernel, the scorer runs radix past the cap, as JAX's use_pallas=True.
    assert sharded.select_kernel_mode(w, 2, True, "cpu") == ("loop" if w <= 32 else "radix")
    assert sharded.select_kernel_mode(w, 2, False, "cuda") is None
    assert sharded.select_kernel_mode(w, 2, None, "cpu") is None


def test_cpu_calls_count_no_launch_in_any_mode():
    data, counts = _windows(9, 4, 3, 8)
    sk.reset_launches()
    for mode in (None, *sk.MODES):
        sk.fused_median_weights(torch.from_numpy(data), torch.from_numpy(counts), mode=mode)
    assert sk.fused_median_weights.launches == 0
    assert sk.fused_median_weights.launches_by_mode == {m: 0 for m in sk.MODES}


def test_plain_pairwise_takes_blocks_of_windows(monkeypatch):
    """The plain pairwise version bounds its [windows, W, W] block; the blocks give
    the same bits as one block."""
    data, counts = _windows(11, 8, 6, 24)
    d, c = torch.from_numpy(data), torch.from_numpy(counts)
    whole = sk.median_weights_pairwise_reference(d, c)
    monkeypatch.setattr(sk, "_PAIRWISE_BLOCK_ELEMS", 5 * 24 * 24)
    blocked = sk.median_weights_pairwise_reference(d, c)
    for a, b in zip(whole, blocked):
        np.testing.assert_array_equal(_bits(a), _bits(b))


# -- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["pairwise", "radix"])
@pytest.mark.parametrize("w", [1, 7, 32, 129, 256, 512, 1024, sk.TILE_MAX_WINDOW])
def test_cuda_kernel_matches_its_plain_version(cuda, mode, w):
    """Each kernel on ``_windows``; radix also on ``chip_smoke.radix_adversarial``
    (one value, signed zeros, low-bit-only keys, one outlier, counts past W), the
    windows its digit rounds could get wrong."""
    cases = [_windows(300 + w, 64, 64, w)]
    if mode == "radix":
        cases.append(radix_adversarial(w, seed=400 + w))
    for data, counts in cases:
        d, c = torch.from_numpy(data).to(cuda), torch.from_numpy(counts).to(cuda)
        sk.reset_launches()
        km, kw = sk.fused_median_weights(d, c, mode=mode)
        pm, pw = sk.PLAIN_VERSIONS[mode](d, c)
        torch.cuda.synchronize()
        assert sk.fused_median_weights.launches_by_mode[mode] == 1
        np.testing.assert_array_equal(_bits(km.cpu()), _bits(pm.cpu()))
        valid = np.arange(w) < counts[..., None]
        abs_sum = np.where(valid, np.abs(data), 0.0).sum(-1)
        rtol = max(1e-5, w * 2.0**-24)  # two f32 sums of W terms in other orders
        np.testing.assert_array_less(np.abs(kw.cpu().numpy() - pw.cpu().numpy()),
                                     rtol * abs_sum + 1e-30)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["pairwise", "radix"])
def test_cuda_kernel_reads_the_strided_ring(cuda, mode):
    data, counts = _windows(17, 256, 64, 200)
    ring = torch.from_numpy(np.ascontiguousarray(data.transpose(2, 0, 1))).to(cuda)
    c = torch.from_numpy(counts).to(cuda)
    km, _ = sk.fused_median_weights(ring.permute(1, 2, 0), c, mode=mode)
    pm, _ = sk.PLAIN_VERSIONS[mode](torch.from_numpy(data).to(cuda), c)
    np.testing.assert_array_equal(_bits(km.cpu()), _bits(pm.cpu()))
