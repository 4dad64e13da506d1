"""A plain numpy model of the ``loop`` CUDA kernel's register path
(``tpu_resiliency_torch/csrc/median_weights.cu``, W <= 64), held bit for bit against
the JAX package's Pallas ``loop`` kernel in interpret mode and against the port's
plain version ``median_weights_reference``, on the CPU.

The model takes the kernel's own steps, over all windows at once:
1. each window padded to P slots, the smallest power of two >= W, with the slots at
   or past the count and past W set to +inf; the weight summed in slot order from
   0.0 in f32;
2. the kernel's bitonic comparator schedule (stage, sub-stage, partner, direction),
   each compare-exchange a min and a max;
3. order statistics ``(n-1)//2`` and ``n//2`` (``n = max(count, 1)``) taken by a
   predicated select over the P sorted slots;
4. the tail: a statistic at or past ``min(count, W)`` is 0, a picked one is added
   into 0.0 (a -0.0 comes out +0.0) except over a window of one slot, and the median
   is their mean, +inf where the count is 0.

The schedule itself is checked by the 0-1 principle: a comparator network sorts
every input if it sorts every input of 0s and 1s. The CUDA kernel runs only on the
card: the ``gpu`` test below holds it against the model (medians and weights bit for
bit, on the same windows), as ``chip_smoke.py`` and the ``gpu`` tests of
``test_torch_scoring_kernels.py`` hold it against the plain version.
"""

import itertools
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from tpu_resiliency.ops.scoring_pallas import fused_median_weights as jax_median_weights  # noqa: E402
from tpu_resiliency_torch.ops import scoring_kernels as sk  # noqa: E402

WINDOWS = (1, 2, 3, 7, 16, 31, 32, 33, 63, 64)
INF = np.float32(np.inf)


# -- the model --------------------------------------------------------------------------


def schedule(p):
    """The kernel's compare-exchanges over ``p`` slots, in its order: ``(k, j, i, l,
    ascending)`` for stage k = 2, 4, .., p, sub-stage j = k/2, .., 1 and each i whose
    partner ``l = i ^ j`` lies above it; ascending where ``i & k == 0``."""
    out = []
    for ks in range(1, p.bit_length()):
        for js in range(ks - 1, -1, -1):
            for i in range(p):
                l = i ^ (1 << js)
                if l > i:
                    out.append((1 << ks, 1 << js, i, l, (i & (1 << ks)) == 0))
    return out


def network_sort(x):
    """The rows of ``x [N, P]`` (P a power of two) through the schedule."""
    x = x.copy()
    for _, _, i, l, up in schedule(x.shape[1]):
        lo, hi = np.minimum(x[:, i], x[:, l]), np.maximum(x[:, i], x[:, l])
        x[:, i], x[:, l] = (lo, hi) if up else (hi, lo)
    return x


def model(data, counts):
    """``(medians, weights) [R, S]`` of windows ``data [R, S, W]`` (W <= 64) as the
    kernel's register path computes them."""
    r, s, w = data.shape
    p = sk.network_size(w)
    count = counts.reshape(-1).astype(np.int64)
    x = np.full((count.size, p), INF, np.float32)
    x[:, :w] = data.reshape(-1, w)  # loads predicated on the window alone
    n_valid = np.clip(count, 0, w)
    total = np.zeros(count.size, np.float32)
    with np.errstate(all="ignore"):
        for j in range(p):
            valid = j < n_valid
            total = total + np.where(valid, x[:, j], np.float32(0))
            x[:, j] = np.where(valid, x[:, j], INF)
        x = network_sort(x)
        n = np.maximum(count, 1)
        picked = []
        for k in ((n - 1) // 2, n // 2):
            v = np.zeros(count.size, np.float32)
            for i in range(p):
                v = np.where(i == k, x[:, i], v)
            kept = v if p == 1 else np.float32(0) + v
            picked.append(np.where(k < n_valid, kept, np.float32(0)))
        med = np.where(count > 0, np.float32(0.5) * (picked[0] + picked[1]), INF)
    return med.astype(np.float32).reshape(r, s), total.reshape(r, s)


# -- windows ----------------------------------------------------------------------------


def network_windows(w, seed, ranks=16, signals=8):
    """Windows ``[ranks, signals, w]`` with what a sorting network could get wrong.
    Rank r % 8 picks the values: 0 rounded normals (ties, negatives, -0.0); 1 one
    value per window; 2 mixed -0.0 and +0.0 with a few +-1; 3 normals and +inf; 4
    normals and -inf; 5 one outlier (+-1e3, +-3e38, +-inf) in an otherwise equal
    window; 6 negatives only; 7 +-inf, +-0.0 and +-1 together. Signal s % 8 picks the
    count: 0, 1, W, W + 1, 2W + 1 (both order statistics past the valid slots), 2W,
    or random in [0, W]."""
    rng = np.random.default_rng(seed)
    shape = (ranks, signals, w)
    family = np.arange(ranks)[:, None, None] % 8
    normals = np.round(rng.standard_normal(shape), 1).astype(np.float32)
    per_window = np.round(rng.standard_normal((ranks, signals, 1)), 1).astype(np.float32)
    zeros = rng.choice(np.array([-0.0, 0.0, -0.0, 0.0, 1.0, -1.0], np.float32), size=shape)
    pos_inf = np.where(rng.random(shape) < 0.3, INF, normals)
    neg_inf = np.where(rng.random(shape) < 0.3, -INF, normals)
    outlier = np.broadcast_to(per_window, shape).copy()
    at = rng.integers(0, w, size=(ranks, signals))
    big = rng.choice(np.array([1e3, -1e3, 3e38, -3e38, np.inf, -np.inf], np.float32),
                     size=(ranks, signals))
    np.put_along_axis(outlier, at[..., None], big[..., None], axis=-1)
    negatives = -np.abs(normals) * 10.0
    mixed = rng.choice(np.array([np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0], np.float32), size=shape)
    choices = (normals, np.broadcast_to(per_window, shape), zeros, pos_inf, neg_inf, outlier,
               negatives, mixed)
    data = np.choose(family, choices).astype(np.float32)
    counts = rng.integers(0, w + 1, size=(ranks, signals))
    for s, c in enumerate((0, 1, w, w + 1, 2 * w + 1, 2 * w)):
        counts[:, s::8] = c
    return data, counts.astype(np.int32)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _as_xla_gives(x):
    """``x`` with each subnormal flushed to a zero of its sign, as XLA on the CPU
    leaves an f32 result. The mean of two order statistics can be subnormal (half the
    smallest normal); torch and the CUDA kernels keep it."""
    x = np.asarray(x, np.float32)
    with np.errstate(invalid="ignore"):
        return np.where(np.abs(x) < np.finfo(np.float32).tiny, np.copysign(np.float32(0), x), x)


def _jax(data, counts):
    jm, jw = jax_median_weights(jnp.asarray(data), jnp.asarray(counts), interpret=True, mode="loop")
    return np.asarray(jm), np.asarray(jw)


def _plain(data, counts):
    med, wt = sk.median_weights_reference(torch.from_numpy(data), torch.from_numpy(counts))
    return med.numpy(), wt.numpy()


def _assert_weights_close(got, want, data, counts):
    """Equal where the sum is not finite; else within 1e-5 of the window's sum of
    |x| (two f32 sums of the same terms in other orders)."""
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_array_equal(got[~finite], want[~finite])
    valid = np.arange(data.shape[-1]) < counts[..., None]
    abs_sum = np.where(valid, np.abs(data), 0.0).sum(-1)
    np.testing.assert_array_less(np.abs(got[finite] - want[finite]), 1e-5 * abs_sum[finite] + 1e-30)


def _assert_matches_both(data, counts):
    med, wt = model(data, counts)
    for other, seen in ((_jax, _as_xla_gives), (_plain, np.asarray)):
        om, ow = other(data, counts)
        np.testing.assert_array_equal(_bits(seen(med)), _bits(om))
        _assert_weights_close(wt, ow, data, counts)
    return med, wt


# -- the schedule -----------------------------------------------------------------------


@pytest.mark.parametrize("p", [1, 2, 4, 8, 16, 32, 64])
def test_schedule_is_the_bitonic_network(p):
    """p/2 compare-exchanges per sub-stage, each slot in exactly one; 240 at P = 32
    and 672 at P = 64, the count ``chip_smoke.py`` takes for the kernel's bound."""
    sched = schedule(p)
    assert len(sched) == chip_smoke.bitonic_comparators(p)
    for _, group in itertools.groupby(sched, key=lambda c: c[:2]):
        touched = [s for c in group for s in c[2:4]]
        assert sorted(touched) == list(range(p))
    assert all(up for k, _, _, _, up in sched if k == p)  # the last stage sorts up
    assert {32: 240, 64: 672}.get(p, len(sched)) == len(sched)


@pytest.mark.parametrize("p", [2, 4, 8, 16])
def test_zero_one_principle_exhaustively(p):
    """Every input of 0s and 1s comes out sorted, so every input does."""
    rows = (np.arange(1 << p)[:, None] >> np.arange(p)) & 1
    out = network_sort(rows.astype(np.float32))
    np.testing.assert_array_equal(out, np.sort(rows, axis=1))


@pytest.mark.parametrize("p", [32, 64])
def test_zero_one_principle_on_random_inputs(p):
    rng = np.random.default_rng(p)
    density = rng.random((20000, 1))
    rows = (rng.random((20000, p)) < density).astype(np.float32)
    np.testing.assert_array_equal(network_sort(rows), np.sort(rows, axis=1))
    floats = rng.standard_normal((2000, p)).astype(np.float32)
    np.testing.assert_array_equal(network_sort(floats), np.sort(floats, axis=1))


def test_network_size_is_the_next_power_of_two():
    assert [sk.network_size(w) for w in (1, 2, 3, 7, 16, 31, 32, 33, 63, 64)] == [
        1, 2, 4, 8, 16, 32, 32, 64, 64, 64]
    assert sk.network_size(sk.NETWORK_MAX_WINDOW) == sk.NETWORK_MAX_WINDOW


def test_the_card_meets_every_boundary_of_the_network():
    """``chip_smoke.py`` holds the kernel to its plain version on both sides of each
    switch: one slot (nothing to sort), P = 2, P = 32 to 64, and the general path."""
    edges = set(chip_smoke.EDGE_WINDOWS)
    top = sk.NETWORK_MAX_WINDOW
    assert {1, 2, 31, 32, 33, top - 1, top, top + 1} <= edges
    assert {1, 32, 33, top, top + 1} <= set(chip_smoke.LOOP_ADVERSARIAL_WINDOWS)


# -- the model against JAX and the plain version ----------------------------------------


@pytest.mark.parametrize("w", WINDOWS)
def test_model_matches_pallas_loop_and_the_plain_version(w):
    data, counts = network_windows(w, seed=w)
    med, _ = _assert_matches_both(data, counts)
    assert np.isinf(med[:, 0]).all()  # count 0
    assert (_bits(med[:, 4]) == 0).all()  # count 2W + 1: both statistics past W, +0.0


@pytest.mark.parametrize("w", [7, 33])
def test_the_windows_hold_what_they_claim(w):
    data, counts = network_windows(w, seed=w)
    assert np.isposinf(data[3::8]).any() and np.isneginf(data[4::8]).any()
    assert (_bits(data[2::8]) == np.int32(-(2**31))).any()  # -0.0
    assert (data[1::8] == data[1::8, :, :1]).all()  # one value per window
    assert set(counts[0, :6]) == {0, 1, w, w + 1, 2 * w + 1, 2 * w}


def test_signed_zeros_infinities_and_ties():
    rows = [
        ([-0.0, 0.0, -0.0, 1.0], 3),  # picked -0.0 comes out +0.0
        ([0.0, -0.0, 0.0, -0.0], 4),
        ([np.inf, 1.0, np.inf, 2.0], 4),  # valid +inf ties with the padding
        ([np.inf, np.inf, np.inf, np.inf], 2),
        ([-np.inf, 5.0, -np.inf, 5.0], 3),
        ([2.0, 2.0, 2.0, 2.0], 4),
        ([5.0, -1.0, 5.0, 5.0], 4),  # one outlier
        ([1.0, 1.0, 3.0, 3.0], 9),  # count past W: both statistics are 0
        ([1.0, 1.0, 3.0, 3.0], 8),  # the lower one valid (3.0), the upper one 0
        ([1.0, 1.0, 3.0, 3.0], 0),
    ]
    data = np.array([r for r, _ in rows], np.float32)[:, None, :]
    counts = np.array([c for _, c in rows], np.int32)[:, None]
    med, _ = _assert_matches_both(data, counts)
    want = [0.0, 0.0, np.inf, np.inf, -np.inf, 2.0, 5.0, 0.0, 1.5, np.inf]
    np.testing.assert_array_equal(_bits(med[:, 0]), _bits(np.array(want, np.float32)))
    # One slot: the picked value keeps its sign; a statistic past it is +0.0.
    one = np.array([[[-0.0]], [[-0.0]], [[3.0]]], np.float32)
    med1, _ = _assert_matches_both(one, np.array([[1], [2], [2]], np.int32))
    want1 = np.array([-0.0, 0.0, 1.5], np.float32)
    np.testing.assert_array_equal(_bits(med1[:, 0]), _bits(want1))


# -- random windows ---------------------------------------------------------------------


@st.composite
def network_case(draw):
    """Four windows of W from the tested sizes (so JAX compiles once per W), values
    from a small pool (ties, signed zeros, infinities, low-bit neighbours) and from all
    finite floats, counts from 0 to past 2W."""
    w = draw(st.sampled_from(WINDOWS))
    pool = [0.0, -0.0, 1.0, -1.0, 1.0000001, 0.99999994, 3.5, -2.25, 1e30, -1e-30,
            np.inf, -np.inf]
    value = st.one_of(
        st.sampled_from(pool),
        st.floats(allow_nan=False, allow_infinity=False, allow_subnormal=False, width=32),
    )
    data = draw(st.lists(value, min_size=4 * w, max_size=4 * w))
    counts = draw(st.lists(st.integers(0, 2 * w + 2), min_size=4, max_size=4))
    return (np.asarray(data, np.float32).reshape(1, 4, w),
            np.asarray(counts, np.int32).reshape(1, 4))


@settings(max_examples=60, deadline=None)
@given(network_case())
def test_model_matches_both_on_random_windows(case):
    data, counts = case
    med, _ = model(data, counts)
    for other, seen in ((_jax, _as_xla_gives), (_plain, np.asarray)):
        np.testing.assert_array_equal(_bits(seen(med)), _bits(other(data, counts)[0]))


def subnormal_mean_window():
    """A window of 16 whose order statistics 4 and 5 (count 10) are the smallest
    negative normal and 0: their mean, -2^-127, is subnormal."""
    data = np.zeros((1, 4, 16), np.float32)
    data[0, 0, 5:9] = -1.0
    data[0, 0, 9] = -np.finfo(np.float32).tiny
    return data, np.array([[10, 0, 0, 0]], np.int32)


def test_a_subnormal_median_is_kept_and_only_xla_flushes_it():
    data, counts = subnormal_mean_window()
    med, _ = _assert_matches_both(data, counts)
    assert med[0, 0] == np.float32(-2.0**-127)
    assert _bits(_jax(data, counts)[0])[0, 0] == np.int32(-(2**31))  # -0.0


# -- on the card ------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("w", WINDOWS)
def test_cuda_kernel_is_the_model(cuda, w):
    """The kernel's medians and weights equal the model's bit for bit: the same
    sort, selection and sequential f32 sum."""
    data, counts = network_windows(w, seed=500 + w, ranks=64, signals=64)
    med, wt = model(data, counts)
    km, kw = sk.fused_median_weights(torch.from_numpy(data).to(cuda),
                                     torch.from_numpy(counts).to(cuda), mode="loop")
    torch.cuda.synchronize()
    for got, want in ((km.cpu().numpy(), med), (kw.cpu().numpy(), wt)):
        # -inf + inf: each processor gives NaN its own bits.
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan)
        np.testing.assert_array_equal(_bits(got[~nan]), _bits(want[~nan]))
