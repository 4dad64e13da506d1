"""The H100 sweep's decision rule (``tpu_resiliency_torch.ops.kernel_sweep``) held
against the rule of the JAX package's ``scripts/bench_pallas_sweep.py`` and against
the defaults the port carries.

``SWEEP_MS`` is the table that ``chip_smoke.py``'s ``sweep`` phase measured on an
NVIDIA H100 80GB HBM3 at 700 W (ms per reduction, S = 64, full windows, the ring's
permuted view, L2 flushed before each launch). The port's defaults must be what the
rule derives from it. The sweep itself times kernels and runs only on the card.
"""

import pytest

from tpu_resiliency_torch.ops import kernel_sweep as ks
from tpu_resiliency_torch.ops import scoring_kernels as sk

# "RxW": (loop, pairwise, radix, sort) ms
SWEEP_MS = {
    "256x32": (0.06673599779605865, 0.059407999739050865, 0.05641600117087364, 0.5443040132522583),
    "256x64": (0.0650240033864975, 0.06331200152635574, 0.06300800293684006, 0.212848000228405),
    "256x128": (0.15804799646139145, 0.0634399987757206, 0.0480320006608963, 0.2250239998102188),
    "256x256": (0.5252479910850525, 0.2011360004544258, 0.044895999133586884, 0.576911985874176),
    "256x512": (3.7835999727249146, 0.7357760071754456, 0.09649599716067314, 0.7276960015296936),
    "256x1024": (28.705056190490723, 4.020079851150513, 0.3075360059738159, 1.043615996837616),
    "1024x32": (0.04187200032174587, 0.041888000443577766, 0.04281600005924702, 0.27959999442100525),
    "1024x64": (0.0870399996638298, 0.0652799978852272, 0.0504320003092289, 0.5805120170116425),
    "1024x128": (0.3551520109176636, 0.1979839950799942, 0.0769599974155426, 0.7082880139350891),
    "1024x256": (2.0874240398406982, 0.6953920125961304, 0.13952000439167023, 2.040768027305603),
    "1024x512": (15.072896003723145, 2.64956796169281, 0.2717120051383972, 2.6115360260009766),
    "1024x1024": (114.7514877319336, 16.005712509155273, 1.1656959652900696, 3.8088639974594116),
    "4096x32": (0.0889119990170002, 0.08374399691820145, 0.10956799983978271, 0.5811200141906738),
    "4096x64": (0.2755360007286072, 0.22153599560260773, 0.1615999937057495, 1.98580801486969),
    "4096x128": (1.1345760226249695, 0.7240319848060608, 0.24694400280714035, 2.490272045135498),
    "4096x256": (8.276768207550049, 2.6202239990234375, 0.4657280147075653, 7.814432144165039),
    "4096x512": (60.14463996887207, 10.17745590209961, 0.9143200218677521, 10.098639965057373),
    "4096x1024": (451.51202392578125, 62.90398406982422, 4.512383937835693, 14.88420820236206),
}


def _results(table=SWEEP_MS):
    out = {}
    for key, times in table.items():
        r, w = (int(x) for x in key.split("x"))
        out[(r, w)] = dict(zip(ks.PATHS, times))
    return out


def test_the_measured_sweep_derives_the_port_defaults():
    got = ks.derive(_results())
    assert got["loop_max_window"] == sk.DEFAULT_MAX_WINDOW == 32
    assert got["radix_beats_sort_past_cap"] is sk.DEFAULT_RADIX_AUTO is True
    assert got["kernel_beats_sort_at"] == {str(w): True for w in ks.WINDOWS}
    # The TPU rule alone gives 0: at R=256, W=32 loop is 10 us slower than radix.
    assert got["loop_max_window_relative_only"] == 0
    # Config 4 (R=4096, W=32) stays on loop; at W=64 radix already wins there.
    results = _results()
    assert results[(4096, 32)]["loop"] < results[(4096, 32)]["radix"]
    assert results[(4096, 64)]["radix"] < results[(4096, 64)]["loop"]


@pytest.mark.parametrize(
    "ms,other,abs_tol,win",
    [
        (1.00, 1.00, ks.ABS_TOL_MS, True),
        (1.02, 1.00, 0.0, True),  # within TOL
        (1.03, 1.00, 0.0, False),
        (1.03, 1.00, ks.ABS_TOL_MS, False),  # 30 us over: more than the floor
        (0.055, 0.043, ks.ABS_TOL_MS, True),  # 12 us at the launch floor: a tie
        (0.055, 0.043, 0.0, False),
    ],
)
def test_a_path_wins_unless_slower_by_more_than_both_tolerances(ms, other, abs_tol, win):
    assert ks.wins(ms, other, abs_tol) is win


def test_a_noise_win_past_a_loss_does_not_raise_the_cap():
    table = dict(SWEEP_MS)
    for r in ks.RANKS:  # loop "wins" W=128 at every R after losing W=64
        table[f"{r}x128"] = (0.01, 1.0, 1.0, 1.0)
    assert ks.derive(_results(table))["loop_max_window"] == 32


def test_radix_auto_needs_a_win_at_every_window_past_the_cap():
    table = dict(SWEEP_MS)
    table["256x1024"] = (28.49, 3.99, 1.50, 1.03)  # the sort beats radix at one cell
    got = ks.derive(_results(table))
    assert got["radix_beats_sort_past_cap"] is False
    assert got["kernel_beats_sort_at"]["1024"] is False
    assert got["loop_max_window"] == 32


def test_the_sweep_runs_only_on_a_card():
    with pytest.raises(ValueError, match="CUDA card"):
        ks.run(windows=(32,), ranks=(8,), device="cpu")
