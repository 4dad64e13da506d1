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
    "256x32": (0.02774399984627962, 0.03043199982494116, 0.029264000244438648, 0.2937279939651489),
    "256x64": (0.027967999689280987, 0.031408000737428665, 0.034671999514102936, 0.5074079930782318),
    "256x128": (0.1573440060019493, 0.0735040009021759, 0.03412799909710884, 0.32128000259399414),
    "256x256": (0.5217919945716858, 0.19947200268507004, 0.04447999969124794, 0.5719040036201477),
    "256x512": (3.7677600383758545, 0.7283200025558472, 0.09596800059080124, 0.7240960001945496),
    "256x1024": (28.55366325378418, 3.991439938545227, 0.3062559962272644, 1.0353599786758423),
    "1024x32": (0.06473600119352341, 0.06849600002169609, 0.06478400155901909, 0.4312960058450699),
    "1024x64": (0.06441599875688553, 0.07011200115084648, 0.07065600156784058, 0.5749120116233826),
    "1024x128": (0.352512001991272, 0.19630400091409683, 0.0764160007238388, 0.7083680033683777),
    "1024x256": (2.07369601726532, 0.6879040002822876, 0.13846400380134583, 2.02619206905365),
    "1024x512": (14.960271835327148, 2.629296064376831, 0.2699680030345917, 2.5985920429229736),
    "1024x1024": (113.8911361694336, 15.881296157836914, 1.1605440378189087, 3.799440026283264),
    "4096x32": (0.08427200093865395, 0.08292799815535545, 0.10831999778747559, 0.5727680027484894),
    "4096x64": (0.08671999722719193, 0.21985600143671036, 0.16036800295114517, 1.9738240242004395),
    "4096x128": (1.1241599917411804, 0.7186079919338226, 0.2449759989976883, 2.4711999893188477),
    "4096x256": (8.199872016906738, 2.600559949874878, 0.46323201060295105, 7.7799201011657715),
    "4096x512": (59.690399169921875, 10.10105562210083, 0.9136160016059875, 10.109456062316895),
    "4096x1024": (449.24151611328125, 62.43204879760742, 4.496159791946411, 14.826815605163574),
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
    # In this call the TPU rule alone agrees; the loop and radix launches at R <= 1024
    # are shorter than their enqueue, whose scatter can tip it either way.
    assert got["loop_max_window_relative_only"] == 64
    # Config 4 (R=4096, W=32) stays on loop, which keeps W=64 at every R; past the
    # register network (W > 64) its O(W^2) path loses to radix everywhere.
    results = _results()
    for r in ks.RANKS:
        for w in (32, 64):
            assert results[(r, w)]["loop"] < results[(r, w)]["radix"]
        assert results[(r, 128)]["radix"] < results[(r, 128)]["loop"]


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


def test_the_sweep_runs_only_on_a_card():
    with pytest.raises(ValueError, match="CUDA card"):
        ks.run(windows=(32,), ranks=(8,), device="cpu")
