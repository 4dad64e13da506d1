"""``tpu_resiliency_torch/scripts/bench_pallas_sweep.py`` held against the repo's
``scripts/bench_pallas_sweep.py``: on the same ``results_ms`` tables the port's
derivation gives the reference's loop cap and kernel-against-sort verdicts (the
reference's ``main`` runs with its ``measure`` reading the table), and the port's
``measure`` runs on the CPU.
"""

import importlib.util
import json

import pytest
import torch

from tests.torch_port_tests import REPO
from tpu_resiliency_torch.scripts import bench_pallas_sweep as sweep

#: The reference's name of each port variant.
REF_NAMES = {"loop": "pallas-loop", "pairwise": "pallas-pairwise", "radix": "pallas-radix",
             "sort": "xla"}
RS = (256, 4096)


@pytest.fixture(scope="module")
def reference():
    spec = importlib.util.spec_from_file_location("ref_bench_pallas_sweep",
                                                  REPO / "scripts" / "bench_pallas_sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def table(rows_by_w: dict, rs=RS) -> dict:
    """``{(r, w): {variant: ms}}``: every R gets the window's row, and ``pairwise``
    only at W <= 64 (the rule both scripts keep)."""
    out = {}
    for r in rs:
        for w, row in rows_by_w.items():
            out[(r, w)] = {k: v for k, v in row.items()
                           if k != "pairwise" or w <= sweep.PAIRWISE_MAX_WINDOW}
    return out


def row(loop, radix, sort, pairwise=10.0):
    return {"loop": loop, "pairwise": pairwise, "radix": radix, "sort": sort}


TABLES = {
    # loop best through 64, radix past it: the cap is 64; a kernel beats the sort everywhere.
    "cap": table({32: row(1.0, 2.0, 3.0), 64: row(1.5, 2.0, 3.0), 128: row(4.0, 2.5, 3.0),
                  256: row(9.0, 3.0, 4.0)}),
    # loop loses at 64 and wins at 128: one noise win past a loss does not raise the cap.
    "noise_win_past_a_loss": table({32: row(1.0, 2.0, 3.0), 64: row(3.2, 3.3, 3.0),
                                    128: row(2.0, 2.5, 3.0)}),
    # pairwise fastest by far: it votes in neither export.
    "pairwise_votes_in_neither": table({32: row(2.5, 2.0, 2.2, pairwise=0.1),
                                        64: row(3.0, 3.1, 2.0, pairwise=0.1),
                                        128: row(3.0, 2.5, 3.0)}),
    # within 2% counts as a win; a loss at one R of two costs the window.
    "ties_and_one_rank": {(256, 32): row(1.015, 1.0, 1.01), (4096, 32): row(1.0, 1.2, 1.3),
                          (256, 64): row(1.0, 1.2, 1.3), (4096, 64): row(1.1, 1.0, 1.3)},
}


def reference_tail(reference, monkeypatch, capsys, results) -> dict:
    ws = sorted({w for _, w in results})
    rs = sorted({r for r, _ in results})
    by_ref = {(r, w): {REF_NAMES[k]: v for k, v in row.items()} for (r, w), row in results.items()}
    monkeypatch.setattr(reference, "measure", lambda r, w, variant: by_ref[(r, w)][variant])
    monkeypatch.setattr("sys.argv", ["bench_pallas_sweep.py", "--ws", ",".join(map(str, ws)),
                                     "--rs", ",".join(map(str, rs))])
    capsys.readouterr()
    reference.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", sorted(TABLES))
def test_the_derivation_is_the_references_on_the_same_table(reference, monkeypatch, capsys,
                                                            name):
    results = TABLES[name]
    want = reference_tail(reference, monkeypatch, capsys, results)
    got = sweep.summarize(results, torch.device("cpu"))
    assert got["loop_max_window"] == want["loop_max_window"]
    assert got["kernel_beats_sort_at"] == want["pallas_beats_xla_at"]
    assert got["loop_tolerance"] == want["loop_tolerance"] == sweep.TOL
    assert got["signals"] == want["signals"] == sweep.S
    assert got["export"] == f"TPU_RESILIENCY_CUDA_MAX_WINDOW={want['loop_max_window']}"
    assert set(got["results_ms"]) == set(want["results_ms"])
    expected = {"cap": 64, "noise_win_past_a_loss": 32, "pairwise_votes_in_neither": 0,
                "ties_and_one_rank": 32}
    assert got["loop_max_window"] == expected[name]


def test_pairwise_verdicts_do_not_count():
    got = sweep.summarize(TABLES["pairwise_votes_in_neither"], torch.device("cpu"))
    assert got["kernel_beats_sort_at"] == {"32": True, "64": False, "128": True}


@pytest.mark.parametrize("variant", sweep.VARIANTS)
def test_measure_runs_on_the_cpu(variant):
    assert sweep.measure(64, 8, variant, device="cpu") > 0


def test_pairwise_is_measured_only_up_to_64(monkeypatch):
    seen = []
    monkeypatch.setattr(sweep, "measure",
                        lambda r, w, v, dev, flush: seen.append((w, v)) or 1.0)
    out = sweep.run([32, 128], [64], device="cpu")
    assert sorted(v for w, v in seen if w == 32) == sorted(sweep.VARIANTS)
    assert "pairwise" not in {v for w, v in seen if w == 128}
    assert out["backend"] == "cpu" and out["card"] is None and set(out["results_ms"]) == {
        "64x32", "64x128"}


def test_without_a_card_it_exits_non_zero(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert sweep.main(["--ws", "8", "--rs", "64"]) == 1
    assert capsys.readouterr().out == ""
