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
    "256x32": (0.05016000010073185, 0.043215999379754066, 0.044064000248909, 0.3333919942378998),
    "256x64": (0.0546719990670681, 0.04334400035440922, 0.04295999929308891, 0.32681600749492645),
    "256x128": (0.15696000307798386, 0.06254399940371513, 0.04572800174355507, 0.3316960036754608),
    "256x256": (0.5210079848766327, 0.19913599640130997, 0.06584000214934349, 0.5741280019283295),
    "256x512": (3.752000093460083, 0.7278720140457153, 0.12724799662828445, 0.7231200039386749),
    "256x1024": (28.490976333618164, 3.989375948905945, 0.3835200071334839, 1.0369439721107483),
    "1024x32": (0.03147200122475624, 0.0512159988284111, 0.08553600311279297, 0.36555199325084686),
    "1024x64": (0.08616000041365623, 0.06444799900054932, 0.10550399869680405, 0.5791040062904358),
    "1024x128": (0.3521760106086731, 0.19606399536132812, 0.1366720050573349, 0.7038719952106476),
    "1024x256": (2.066848039627075, 0.6877440214157104, 0.19563200324773788, 2.0291839838027954),
    "1024x512": (14.959136009216309, 2.62881600856781, 0.37164801359176636, 2.5957599878311157),
    "1024x1024": (113.8873291015625, 15.87656021118164, 1.4663519859313965, 3.7961279153823853),
    "4096x32": (0.0878559984266758, 0.08249600231647491, 0.30532799661159515, 0.5786559879779816),
    "4096x64": (0.2733759880065918, 0.2197120040655136, 0.37936000525951385, 1.9687359929084778),
    "4096x128": (1.1236799955368042, 0.7181279957294464, 0.48771199584007263, 2.476896047592163),
    "4096x256": (8.199888229370117, 2.600175976753235, 0.6979999840259552, 7.778992176055908),
    "4096x512": (60.13328170776367, 10.176543712615967, 1.3428639769554138, 10.09990406036377),
    "4096x1024": (451.4599304199219, 62.88030242919922, 5.7317280769348145, 14.893839836120605),
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
    # The TPU rule alone would move config 4 (R=4096, W=32) to a radix 3.5x slower.
    assert got["loop_max_window_relative_only"] == 0
    r4096 = _results()[(4096, 32)]
    assert r4096["radix"] > 3.4 * r4096["loop"]


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
    table["4096x256"] = (0.5, 2.6, 0.698, 7.78)  # loop "wins" W=256 after losing W=128
    assert ks.derive(_results(table))["loop_max_window"] == 64


def test_radix_auto_needs_a_win_at_every_window_past_the_cap():
    table = dict(SWEEP_MS)
    table["256x1024"] = (28.49, 3.99, 1.50, 1.04)  # the sort beats radix at one cell
    got = ks.derive(_results(table))
    assert got["radix_beats_sort_past_cap"] is False
    assert got["kernel_beats_sort_at"]["1024"] is False
    assert got["loop_max_window"] == 64


def test_the_sweep_runs_only_on_a_card():
    with pytest.raises(ValueError, match="CUDA card"):
        ks.run(windows=(32,), ranks=(8,), device="cpu")
