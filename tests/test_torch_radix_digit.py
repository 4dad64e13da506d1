"""A plain numpy model of the ``radix`` CUDA kernel's selection
(``tpu_resiliency_torch/csrc/median_weights_radix.cu``), held bit for bit against the
JAX package's Pallas ``radix`` kernel in interpret mode and against the port's plain
version ``median_weights_radix_reference``, on the CPU.

The model works window by window in the kernel's own steps: order statistics past
the valid slots are +inf; the lower median ``k_lo`` is selected by digit rounds over
a candidate list that shrinks (the candidates' OR against their AND ends it, else a
5-bit digit at the top differing bit, 32 bins, the bin of rank k, compaction in
place); the upper median follows from the lower in one pass. The CUDA kernel itself
runs only on the card (``chip_smoke.py``, and the ``gpu`` tests of
``test_torch_scoring_modes.py``), on the same adversarial windows
(``chip_smoke.radix_adversarial``).

Run as a script, it prints the rounds per window on the long-window telemetry
(``chip_smoke.make_telemetry`` at W = 512)::

    python tests/test_torch_radix_digit.py
"""

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import digit_work, make_telemetry, radix_adversarial  # noqa: E402
from tpu_resiliency.ops.scoring_pallas import fused_median_weights as jax_median_weights  # noqa: E402
from tpu_resiliency_torch.ops import scoring_kernels as sk  # noqa: E402

DIGIT_BITS = 5
INF = np.float32(np.inf)


def order_keys(x):
    """The kernel's unsigned order key of each float (uint32)."""
    b = np.asarray(x, np.float32).view(np.uint32)
    return np.where(b >> 31, ~b, b | np.uint32(0x80000000)).astype(np.uint32)


def from_order_key(u):
    u = np.uint32(u)
    b = u ^ np.uint32(0x80000000) if u >> 31 else ~u
    return np.array(b, np.uint32).view(np.float32)[()]


def select_lower(keys, k):
    """The k-th smallest of ``keys`` by the kernel's digit rounds: ``(key, rounds,
    candidates examined over the rounds)``."""
    col = keys.copy()  # the window's column of the staged tile
    m = col.size
    rounds = examined = 0
    while True:
        cand = col[:m]
        diff = np.bitwise_or.reduce(cand) ^ np.bitwise_and.reduce(cand)
        if diff == 0:
            return col[0], rounds, examined
        rounds += 1
        examined += m
        shift = max(int(diff).bit_length() - DIGIT_BITS, 0)
        digit = (cand >> np.uint32(shift)) & np.uint32(31)
        bins = np.bincount(digit, minlength=32)
        incl = np.cumsum(bins)
        b = int(np.argmax(incl > k))
        k -= int(incl[b] - bins[b])
        src = np.flatnonzero(digit == b)
        assert (src >= np.arange(src.size)).all()  # no write passes its read
        col[: src.size] = cand[src]
        m = src.size


def model_window(window, count):
    """``(median, rounds, examined)`` of one window as the kernel computes them."""
    n_valid = max(min(int(count), window.size), 0)
    n = max(int(count), 1)
    k_lo, k_hi = (n - 1) // 2, n // 2
    if k_lo >= n_valid:
        return INF, 0, 0
    keys = order_keys(window[:n_valid])
    lo, rounds, examined = select_lower(keys, k_lo)
    hi_v = INF
    if k_hi == k_lo:
        hi_v = from_order_key(lo)
    elif k_hi < n_valid:
        c_le = int((keys <= lo).sum())
        hi_v = from_order_key(lo if c_le > k_hi else keys[keys > lo].min())
    with np.errstate(over="ignore"):
        med = np.float32(0.5) * (from_order_key(lo) + hi_v)
    return (med if count > 0 else INF), rounds, examined


def model(data, counts):
    """Medians ``[R, S]`` and the rounds and candidates examined per window."""
    r, s, _ = data.shape
    med = np.empty((r, s), np.float32)
    rounds = np.empty((r, s), np.int64)
    examined = np.empty((r, s), np.int64)
    for i in range(r):
        for j in range(s):
            med[i, j], rounds[i, j], examined[i, j] = model_window(data[i, j], counts[i, j])
    return med, rounds, examined


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _jax_medians(data, counts):
    jm, _ = jax_median_weights(jnp.asarray(data), jnp.asarray(counts), interpret=True, mode="radix")
    return np.asarray(jm)


def _plain_medians(data, counts):
    med, _ = sk.median_weights_radix_reference(torch.from_numpy(data), torch.from_numpy(counts))
    return med.numpy()


# -- fixed windows --------------------------------------------------------------------


@pytest.mark.parametrize("w", [1, 7, 33, 129])
def test_model_matches_pallas_radix_and_the_plain_version(w):
    data, counts = radix_adversarial(w, seed=w, ranks=16, signals=8)
    med, _, _ = model(data, counts)
    np.testing.assert_array_equal(_bits(med), _bits(_jax_medians(data, counts)))
    np.testing.assert_array_equal(_bits(med), _bits(_plain_medians(data, counts)))


@pytest.mark.parametrize("w", [1, 7, 33, 129])
def test_every_window_kind_is_exercised(w):
    """The adversarial set holds what it claims: all-equal windows end with no round,
    low-bit windows differ only in their lowest three key bits (the digit then holds
    common bits above the top differing one), -0.0 is present, and counts past W give
    +inf medians."""
    data, counts = radix_adversarial(w, seed=w, ranks=16, signals=8)
    med, rounds, _ = model(data, counts)
    assert (rounds[1::8] == 0).all()  # one value per window
    assert np.isinf(med[:, 0]).all() and np.isinf(med[:, 4]).all()  # counts 0 and 2W+1
    assert np.isinf(med[:, 5]).all()  # count 2W: the upper median is past the slots
    low = data[3::8].reshape(-1, w)
    if w > 1:
        spread = order_keys(low.max(-1)) - order_keys(low.min(-1))
        assert spread.max() < 8 and spread.max() > 0
    assert (_bits(data[2::8]) == np.int32(-(2**31))).any()  # -0.0 present


def test_signed_zeros_and_ties():
    rows = [
        ([-0.0, 0.0, -0.0, 1.0], 3),  # lower median -0.0, upper -0.0
        ([0.0, -0.0, 0.0, -0.0], 4),  # -0.0 and +0.0
        ([2.0, 2.0, 2.0, 2.0], 4),  # all equal
        ([5.0, -1.0, 5.0, 5.0], 4),  # one outlier
        ([1.0, 1.0, 3.0, 3.0], 8),  # count past W: upper median +inf
    ]
    data = np.array([r for r, _ in rows], np.float32)[:, None, :]
    counts = np.array([c for _, c in rows], np.int32)[:, None]
    med, _, _ = model(data, counts)
    np.testing.assert_array_equal(_bits(med), _bits(_jax_medians(data, counts)))
    np.testing.assert_array_equal(_bits(med), _bits(_plain_medians(data, counts)))
    assert _bits(med)[0, 0] == np.int32(-(2**31))
    assert med[1, 0] == 0.0 and med[2, 0] == 2.0 and med[3, 0] == 5.0 and np.isinf(med[4, 0])


def test_bench_telemetry_around_one():
    """Long-window telemetry at W = 512 (a few ranks): bit-equal to both, and no
    window takes more than a handful of rounds."""
    data, counts, _ = make_telemetry(seed=0, w=512, ranks=8)
    data, counts = data[:, :16], counts[:, :16]
    counts[:, 8:] = np.arange(8) * 60 + 1  # partial windows as well
    med, rounds, examined = model(data, counts)
    np.testing.assert_array_equal(_bits(med), _bits(_jax_medians(data, counts)))
    np.testing.assert_array_equal(_bits(med), _bits(_plain_medians(data, counts)))
    assert rounds.max() <= 8
    assert (examined[:, :8] >= 512).all()  # the first round reads every key


# -- random windows -------------------------------------------------------------------


@st.composite
def digit_case(draw):
    """Windows of values drawn from a small pool (ties, signed zeros, negatives, low-bit
    neighbours) and from all finite floats, counts from 0 to past W."""
    w = draw(st.integers(1, 70))
    s = draw(st.integers(1, 3))
    pool = [0.0, -0.0, 1.0, -1.0, 1.0000001, 0.99999994, 3.5, -2.25, 1e30, -1e-30]
    value = st.one_of(
        st.sampled_from(pool),
        st.floats(allow_nan=False, allow_infinity=False, allow_subnormal=False, width=32),
    )
    data = draw(st.lists(value, min_size=s * w, max_size=s * w))
    counts = draw(st.lists(st.integers(0, 2 * w + 2), min_size=s, max_size=s))
    return (np.asarray(data, np.float32).reshape(1, s, w),
            np.asarray(counts, np.int32).reshape(1, s))


@settings(max_examples=60, deadline=None)
@given(digit_case())
def test_model_matches_the_plain_version_on_random_windows(case):
    data, counts = case
    med, rounds, _ = model(data, counts)
    np.testing.assert_array_equal(_bits(med), _bits(_plain_medians(data, counts)))
    assert rounds.max() <= 32


# -- the card's work count ------------------------------------------------------------


@pytest.mark.parametrize("w", [7, 129])
def test_chip_smoke_counts_the_models_rounds(w):
    """``chip_smoke.digit_work`` (the kernel's work on the card's inputs, for its
    bound) counts the rounds and candidates the model takes, window for window."""
    data, counts = radix_adversarial(w, seed=50 + w, ranks=16, signals=8)
    _, rounds, examined = model(data, counts)
    got_rounds, got_examined = digit_work(torch.from_numpy(data), torch.from_numpy(counts), chunk=37)
    np.testing.assert_array_equal(got_rounds.numpy(), rounds.reshape(-1))
    np.testing.assert_array_equal(got_examined.numpy(), examined.reshape(-1))


def rounds_on_telemetry(ranks=64, w=512, seed=0):
    """Rounds per window of the model on ``make_telemetry`` data (full windows)."""
    data, counts, _ = make_telemetry(seed=seed, w=w, ranks=ranks)
    _, rounds, examined = model(data, counts)
    hist = np.bincount(rounds.reshape(-1))
    return {
        "windows": int(rounds.size), "window": w,
        "rounds_mean": float(rounds.mean()), "rounds_max": int(rounds.max()),
        "rounds_histogram": {str(i): int(c) for i, c in enumerate(hist) if c},
        "examined_per_key_mean": float(examined.mean() / w),
    }


if __name__ == "__main__":
    print(json.dumps(rounds_on_telemetry()))
