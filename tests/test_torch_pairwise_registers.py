"""A plain numpy model of the ``pairwise`` CUDA kernel's register path
(``tpu_resiliency_torch/csrc/median_weights_pairwise.cu``, W <= 64), held bit for
bit against the JAX package's Pallas ``pairwise`` kernel in interpret mode and
against the port's plain version ``median_weights_pairwise_reference``, on the CPU.

The model takes the kernel's own steps, over all windows at once:
1. each window padded to P slots, the smallest power of two >= W, with the slots at
   or past the count and past W set to +inf; the weight summed in slot order from
   0.0 in f32;
2. ranks held as f32, rank_j starting at P - 1 - j, then one compare per pair of
   slots j < i: ``c = x_j <= x_i`` is added to rank_i and taken from rank_j;
3. order statistics ``(n-1)//2`` and ``n//2`` (``n = max(count, 1)``) picked by a
   predicated select over the P slots, comparing each rank with ``min(k, P)``;
4. the tail: a statistic at or past ``min(count, W)`` is 0, a picked one is added
   into 0.0 (a -0.0 comes out +0.0) except over a window of one slot, and the median
   is their mean, +inf where the count is 0.

The CUDA kernel runs only on the card: the ``gpu`` test below holds it against the
model (medians and weights bit for bit, on the same windows), as ``chip_smoke.py``
holds it against the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from tests.test_torch_loop_network import (
    _as_xla_gives,
    _assert_weights_close,
    _bits,
    network_windows,
    subnormal_mean_window,
)
from tpu_resiliency.ops.scoring_pallas import fused_median_weights as jax_median_weights
from tpu_resiliency_torch.ops import scoring_kernels as sk

WINDOWS = (1, 2, 3, 7, 16, 31, 32, 33, 63, 64)
INF = np.float32(np.inf)


# -- the model --------------------------------------------------------------------------


def padded(data, counts):
    """``(x [N, P], total [N], n_valid [N], count [N])``: the kernel's registers after
    its loads and masking, and the weight it summed meanwhile."""
    w = data.shape[-1]
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
    return x, total, n_valid, count


def pair_schedule(p):
    """The kernel's compares over P slots, in its order: ``(j, i)`` for every pair
    j < i."""
    return [(j, i) for i in range(1, p) for j in range(i)]


def pair_ranks(x):
    """The kernel's ranks of the rows of ``x [N, P]``: one compare per pair."""
    p = x.shape[1]
    rank = np.broadcast_to(np.arange(p - 1, -1, -1, dtype=np.float32), x.shape).copy()
    for j, i in pair_schedule(p):
        c = (x[:, j] <= x[:, i]).astype(np.float32)
        rank[:, i] += c
        rank[:, j] -= c
    return rank


def stable_ranks(x):
    """The TPU kernel's ranks: ``#{j : x_j < x_i} + #{j < i : x_j == x_i}``."""
    xi, xj = x[:, :, None], x[:, None, :]
    before = np.arange(x.shape[1])[None, :] < np.arange(x.shape[1])[:, None]
    return ((xj < xi) | ((xj == xi) & before)).sum(-1)


def model(data, counts):
    """``(medians, weights) [R, S]`` of windows ``data [R, S, W]`` (W <= 64) as the
    kernel's register path computes them."""
    r, s, _ = data.shape
    x, total, n_valid, count = padded(data, counts)
    p = x.shape[1]
    rank = pair_ranks(x)
    n = np.maximum(count, 1)
    picked = []
    with np.errstate(all="ignore"):
        for k in ((n - 1) // 2, n // 2):
            fk = np.minimum(k, p).astype(np.float32)
            v = np.zeros(count.size, np.float32)
            for i in range(p):
                v = np.where(rank[:, i] == fk, x[:, i], v)
            kept = v if p == 1 else np.float32(0) + v
            picked.append(np.where(k < n_valid, kept, np.float32(0)))
        med = np.where(count > 0, np.float32(0.5) * (picked[0] + picked[1]), INF)
    return med.astype(np.float32).reshape(r, s), total.reshape(r, s)


# -- against JAX and the plain version ---------------------------------------------------


def _jax(data, counts):
    jm, jw = jax_median_weights(jnp.asarray(data), jnp.asarray(counts), interpret=True,
                                mode="pairwise")
    return np.asarray(jm), np.asarray(jw)


def _plain(data, counts):
    med, wt = sk.median_weights_pairwise_reference(torch.from_numpy(data), torch.from_numpy(counts))
    return med.numpy(), wt.numpy()


def _assert_same_bits(got, want):
    """Equal as int32, except that a NaN (-inf + inf) only has to be a NaN: each
    library gives it its own bits."""
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(_bits(got[~nan]), _bits(want[~nan]))


def _assert_matches_both(data, counts):
    med, wt = model(data, counts)
    for other, seen in ((_jax, _as_xla_gives), (_plain, np.asarray)):
        om, ow = other(data, counts)
        _assert_same_bits(seen(med), om)
        _assert_weights_close(wt, ow, data, counts)
    return med, wt


@pytest.mark.parametrize("w", WINDOWS)
def test_model_matches_pallas_pairwise_and_the_plain_version(w):
    data, counts = network_windows(w, seed=600 + w)
    med, _ = _assert_matches_both(data, counts)
    assert np.isinf(med[:, 0]).all()  # count 0
    assert (_bits(med[:, 4]) == 0).all()  # count 2W + 1: both statistics past W, +0.0


@pytest.mark.parametrize("w", WINDOWS)
def test_one_compare_per_pair_gives_the_stable_ranks(w):
    """On every drawn window (ties, +-0.0, +-inf, the +inf padding) the pair form's
    ranks equal the TPU kernel's, and they are a permutation of 0 .. P - 1."""
    data, counts = network_windows(w, seed=700 + w, ranks=32, signals=16)
    x, *_ = padded(data, counts)
    rank = pair_ranks(x)
    np.testing.assert_array_equal(rank, stable_ranks(x).astype(np.float32))
    np.testing.assert_array_equal(np.sort(rank, axis=1), np.broadcast_to(np.arange(x.shape[1]), x.shape))


@pytest.mark.parametrize("w", [1, 3, 7, 17, 33, 63])
def test_the_padding_leaves_the_ranks_of_the_window_unchanged(w):
    """A pad lies after every slot of the window and ``+inf < x`` is false for every
    x: the first W ranks over P slots are the ranks over the W slots alone, and each
    pad takes the rank of its own position."""
    data, counts = network_windows(w, seed=800 + w, ranks=32, signals=16)
    x, *_ = padded(data, counts)
    over_p = pair_ranks(x)
    np.testing.assert_array_equal(over_p[:, :w], stable_ranks(x[:, :w]).astype(np.float32))
    np.testing.assert_array_equal(over_p[:, w:], np.broadcast_to(np.arange(w, x.shape[1]), x[:, w:].shape))


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
        ([1.0, 1.0, 3.0, 3.0], 2**30),  # a statistic far past P matches no rank
        ([np.inf, -np.inf, 0.0, -0.0], 4),
    ]
    data = np.array([r for r, _ in rows], np.float32)[None]  # one rank: the JAX tile is 8
    counts = np.array([c for _, c in rows], np.int32)[None]
    med, _ = _assert_matches_both(data, counts)
    want = [0.0, 0.0, np.inf, np.inf, -np.inf, 2.0, 5.0, 0.0, 1.5, np.inf, 0.0, 0.0]
    np.testing.assert_array_equal(_bits(med[0]), _bits(np.array(want, np.float32)))
    # One slot: the picked value keeps its sign; a statistic past it is +0.0.
    one = np.array([[[-0.0]], [[-0.0]], [[3.0]]], np.float32)
    med1, _ = _assert_matches_both(one, np.array([[1], [2], [2]], np.int32))
    np.testing.assert_array_equal(_bits(med1[:, 0]), _bits(np.array([-0.0, 0.0, 1.5], np.float32)))


def test_the_card_meets_every_boundary_of_the_register_path():
    """``chip_smoke.py`` holds the kernel to its plain version at each register size
    and on both sides of the switch to the tiled path, on edge and adversarial
    windows, the latter with infinities."""
    top = sk.PAIRWISE_REGISTER_MAX_WINDOW
    assert {1, 2, 7, 31, 32, 33, top - 1, top, top + 1} <= set(chip_smoke.PAIRWISE_WINDOWS)
    data, counts = chip_smoke.radix_adversarial(33, seed=1)
    data = chip_smoke.with_infinities(data, seed=2)
    assert np.isposinf(data[0::8]).any() and np.isneginf(data[6::8]).any()
    assert not np.isinf(data[1::8]).any()
    assert {0, 1, 33, 2 * 33 + 1} <= set(counts[0].tolist())
    _assert_same_bits(model(data, counts)[0], _plain(data, counts)[0])


@pytest.mark.parametrize("w", WINDOWS + (65, 128))
def test_the_bound_counts_the_compares_of_the_launched_path(w):
    """``chip_smoke.py`` prices the kernel's bound at the compares the path it
    launches makes: the model's schedule over P slots on the register path, W^2 on
    the tiled path past it."""
    top = sk.PAIRWISE_REGISTER_MAX_WINDOW
    want = len(pair_schedule(sk.network_size(w))) if w <= top else w * w
    assert chip_smoke.pairwise_compares(w, top) == want
    assert chip_smoke.pairwise_compares(32, top) == 496


# -- random windows ---------------------------------------------------------------------


@st.composite
def pairwise_case(draw):
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
@given(pairwise_case())
def test_model_matches_both_on_random_windows(case):
    data, counts = case
    med, _ = model(data, counts)
    for other, seen in ((_jax, _as_xla_gives), (_plain, np.asarray)):
        _assert_same_bits(seen(med), other(data, counts)[0])


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
    """The register kernel's medians and weights equal the model's bit for bit: the
    same ranks, selection and sequential f32 sum."""
    data, counts = network_windows(w, seed=900 + w, ranks=64, signals=64)
    med, wt = model(data, counts)
    before = sk.fused_median_weights.launches_by_mode["pairwise"]
    km, kw = sk.fused_median_weights(torch.from_numpy(data).to(cuda),
                                     torch.from_numpy(counts).to(cuda), mode="pairwise")
    torch.cuda.synchronize()
    assert sk.fused_median_weights.launches_by_mode["pairwise"] == before + 1
    _assert_same_bits(km.cpu().numpy(), med)
    _assert_same_bits(kw.cpu().numpy(), wt)
