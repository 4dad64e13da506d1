"""The H100 sweep's decision rule (``tpu_resiliency_torch.ops.kernel_sweep``) held
against the rule of the JAX package's ``scripts/bench_pallas_sweep.py`` and against
the defaults the port carries.

``SWEEP_MS`` is the table that ``chip_smoke.py``'s ``sweep`` phase measured on an
NVIDIA H100 80GB HBM3 at 700 W (device ms per reduction from the profiler, S = 64,
full windows, the ring's permuted view, L2 flushed before each call). The port's
defaults must be what the rule derives from it. The sweep itself times kernels and
runs only on the card; its device timer's grouping of a trace is held here on
synthetic records.
"""

import pytest

from tpu_resiliency_torch.ops import kernel_sweep as ks
from tpu_resiliency_torch.ops import scoring_kernels as sk

# "RxW": (loop, pairwise, radix, sort) ms
SWEEP_MS = {
    "256x32": (0.00377599999999984, 0.004191499999999905, 0.01145550000000003, 0.08946650000000864),
    "256x64": (0.005942999999999757, 0.012828500000000076, 0.01647649999999976, 0.17362500000000092),
    "256x128": (0.15274049999999967, 0.06023599999999987, 0.023944999999999824, 0.20275700000000188),
    "256x256": (0.5172109999999993, 0.19517200000000026, 0.04080749999999989, 0.552671500000005),
    "256x512": (3.747696, 0.7238869999999997, 0.0919994999999999, 0.7038960000000006),
    "256x1024": (28.487896999999997, 3.9875250000000033, 0.30238900000000013, 1.016596499999998),
    "1024x32": (0.008098000000000183, 0.009663999999999874, 0.031003999999999907, 0.17841699999999674),
    "1024x64": (0.016129499999999894, 0.031637000000000054, 0.04630899999999997, 0.5545900000000019),
    "1024x128": (0.34845849999999995, 0.19223299999999996, 0.07313699999999994, 0.6833030000000072),
    "1024x256": (2.064879000000001, 0.685194, 0.1350505000000003, 2.006891000000007),
    "1024x512": (14.955883999999998, 2.6252495000000002, 0.2729660000000001, 2.5936204999999894),
    "1024x1024": (113.88680800000002, 15.986394999999996, 1.1602954999999993, 3.814545000000009),
    "4096x32": (0.02068600000000015, 0.027757000000000174, 0.10539850000000024, 0.5561145000000008),
    "4096x64": (0.04800999999999999, 0.0889090000000001, 0.15746199999999977, 1.9566559999999964),
    "4096x128": (1.1198154999999996, 0.7147800000000002, 0.24267150000000037, 2.458877999999981),
    "4096x256": (8.203406500000005, 2.597514000000001, 0.4625974999999996, 7.8200125000000025),
    "4096x512": (59.69065400000001, 10.1729165, 0.9111225000000004, 10.113152500000002),
    "4096x1024": (448.10712600000005, 64.242567, 4.508883, 15.002127499999986),
}


def _results(table=SWEEP_MS):
    out = {}
    for key, times in table.items():
        r, w = (int(x) for x in key.split("x"))
        out[(r, w)] = dict(zip(ks.PATHS, times))
    return out


def test_the_measured_sweep_derives_the_port_defaults():
    got = ks.derive(_results())
    assert got["loop_max_window"] == sk.DEFAULT_MAX_WINDOW == 64
    assert got["radix_beats_sort_past_cap"] is sk.DEFAULT_RADIX_AUTO is True
    assert got["kernel_beats_sort_at"] == {str(w): True for w in ks.WINDOWS}
    # Config 4 (R=4096, W=32) stays on loop, which keeps W=64 at every R; past the
    # register network (W > 64) its O(W^2) path loses to radix everywhere.
    results = _results()
    for r in ks.RANKS:
        for w in (32, 64):
            assert results[(r, w)]["loop"] < results[(r, w)]["radix"]
        assert results[(r, 128)]["radix"] < results[(r, 128)]["loop"]


@pytest.mark.parametrize(
    "ms,other,win",
    [
        (1.00, 1.00, True),
        (1.02, 1.00, True),  # within TOL
        (1.03, 1.00, False),
        (0.0204, 0.0200, True),  # 2% of a short kernel's device time: a tie
        (0.0210, 0.0200, False),  # device times need no absolute term
        (0.80, 1.00, True),
    ],
)
def test_a_path_wins_unless_slower_by_more_than_both_tolerances(ms, other, win):
    """The TPU sweep's relative rule alone: on device time there is no launch floor
    for an absolute term to cover."""
    assert ks.wins(ms, other) is win


def test_a_noise_win_past_a_loss_does_not_raise_the_cap():
    table = dict(SWEEP_MS)
    for r in ks.RANKS:  # loop "wins" W=256 at every R after losing W=128
        table[f"{r}x256"] = (0.01, 1.0, 1.0, 1.0)
    assert ks.derive(_results(table))["loop_max_window"] == 64


def test_radix_auto_needs_a_win_at_every_window_past_the_cap():
    table = dict(SWEEP_MS)
    table["256x1024"] = (28.49, 3.99, 1.50, 1.03)  # the sort beats radix at one cell
    got = ks.derive(_results(table))
    assert got["radix_beats_sort_past_cap"] is False
    assert got["kernel_beats_sort_at"]["1024"] is False
    assert got["loop_max_window"] == 64


SPIN = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
FILL = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>"


def _trace(calls):
    """Device records ``(name, start_us, duration_us)`` of timed calls as
    ``device_ms`` lays them out: the flush, two markers, the call's kernels, a
    marker."""
    records, t = [], 0.0
    for kernels in calls:
        for name, dur in ((FILL, 40.0), (SPIN, 0.5), (SPIN, 0.5), *kernels, (SPIN, 0.5)):
            records.append((name, t, dur))
            t += dur + 1.0
    return records


def test_device_time_leaves_out_the_flush_and_the_markers():
    records = _trace([[("median_weights_pairwise_registers_kernel<32>", 20.0)]] * 3)
    assert ks.median_call_ms(records, 3) == pytest.approx(0.020)


def test_device_time_sums_the_kernels_of_a_call_and_takes_the_median():
    """The plain versions launch many kernels (and fill kernels of their own) per
    call; the records may come in any order."""
    calls = [
        [("sort", 10.0), (FILL, 3.0), ("gather", 2.0)],  # 15
        [("sort", 30.0), ("Memcpy DtoD (Device -> Device)", 5.0)],  # 35
        [("sort", 11.0), ("gather", 2.0), ("where", 1.0)],  # 14
        [("sort", 16.0)],  # 16
        [("sort", 12.0), ("gather", 1.0)],  # 13
    ]
    records = _trace(calls)[::-1]
    assert ks.median_call_ms(records, 5) == pytest.approx(0.015)


@pytest.mark.parametrize(
    "lost",
    [
        (0,),  # the first flush
        (1,),  # one opening marker: that call is dropped
        (4,),  # a closing marker: that call is dropped, not summed with the flush
        (4, 5),  # a closing marker and the next flush
        (5,),  # a flush between two calls
        (3, 7),  # the first call's kernel (it counts 0), and the second call's marker
    ],
)
def test_device_time_survives_a_lost_record_without_a_wrong_sum(lost):
    """Each call is ``F M M k M`` (5 records) with k = 20 us; whatever the trace
    loses, every call that is counted sums its own kernels and nothing else."""
    records = _trace([[("k", 20.0)]] * 5)
    kept = [rec for i, rec in enumerate(records) if i not in lost]
    assert ks.median_call_ms(kept, 5) == pytest.approx(0.020)


def test_device_time_leaves_out_the_untimed_calls_and_a_lost_session_start():
    """``device_ms`` makes three untimed calls inside the profiler's session before
    the timed ones: their records lie before the first marker pair and count for no
    call. A session once lost its first three records on the card (the first call's
    flush and opening markers): that call is dropped, the others count."""
    warm = [(name, -100.0 + 10.0 * i, dur)
            for i, (name, dur) in enumerate([(FILL, 5.0), ("k", 99.0)] * 3)]
    timed = _trace([[("k", 20.0)]] * 3)
    assert ks.median_call_ms(warm + timed, 3) == pytest.approx(0.020)
    assert ks.median_call_ms(timed[3:], 3) == pytest.approx(0.020)


def test_device_time_raises_when_the_trace_lost_most_calls():
    records = [rec for rec in _trace([[("k", 1.0)]] * 4) if rec[0] != SPIN]
    with pytest.raises(RuntimeError, match="0 of 4 timed calls"):
        ks.median_call_ms(records, 4)


def test_device_time_raises_on_more_calls_than_were_timed():
    """Calls beyond those timed are records of another session: ``device_ms`` runs
    the session again rather than take them."""
    with pytest.raises(RuntimeError, match="5 of 3 timed calls"):
        ks.median_call_ms(_trace([[("k", 1.0)]] * 5), 3)


def test_the_sweep_runs_only_on_a_card():
    with pytest.raises(ValueError, match="CUDA card"):
        ks.run(windows=(32,), ranks=(8,), device="cpu")
