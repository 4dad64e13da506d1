"""``tpu_resiliency_torch/scripts/bench_ckpt_save.py`` held against the reference's
``scripts/bench_ckpt_save.py``: the reference's perf acceptance
(``tests/checkpoint/test_ckpt_save_perf.py``, ``slow``) runs on the port through
``torch_port_tests``, the port's ``--smoke`` runs in tier-1, and the legs run side by
side with the reference's: the same trees give SHA-256-identical containers on every
rank, and the delta and cold legs move the same bytes.

The one edit to the reference's test: the script it starts is the port's module, on
the CPU (``-m tpu_resiliency_torch.scripts.bench_ckpt_save --device cpu``), since the
port's entry points run on the card by default.
"""

import hashlib
import importlib.util
import subprocess
import sys

import pytest
import torch

from tests.torch_port_tests import REPO, port_tests
from tpu_resiliency_torch.scripts import bench_ckpt_save

port_tests(
    "tests/checkpoint/test_ckpt_save_perf.py", globals(),
    edits=[('os.path.join(REPO_ROOT, "scripts", "bench_ckpt_save.py"),',
            '"-m", "tpu_resiliency_torch.scripts.bench_ckpt_save", "--device", "cpu",',
            "the port's module, on the CPU: its default is the card")],
)


@pytest.fixture(scope="module")
def reference():
    spec = importlib.util.spec_from_file_location("ref_bench_ckpt_save",
                                                  REPO / "scripts" / "bench_ckpt_save.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digests(root) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_clique_containers_are_identical_across_the_packages(tmp_path, reference):
    """``bench_clique(2, 16, 2, pipelined=True)``: every rank's container and mirror."""
    reference.bench_clique(2, 16, 2, pipelined=True, root=str(tmp_path / "ref"))
    bench_ckpt_save.bench_clique(2, 16, 2, pipelined=True, root=str(tmp_path / "port"),
                                 device="cpu")
    ref, port = _digests(tmp_path / "ref"), _digests(tmp_path / "port")
    assert ref and sum(n.endswith(".ckpt") or "iter_" in n for n in ref) >= 2, ref
    assert port == ref


def test_delta_and_cold_legs_move_the_same_bytes(tmp_path, reference):
    ref = reference.bench_delta_leg(2, 16, 2, str(tmp_path / "ref_delta"))
    port = bench_ckpt_save.bench_delta_leg(2, 16, 2, str(tmp_path / "port_delta"), device="cpu")
    for key in ("rounds_delta", "applied_ok", "frame_bytes", "full_bytes"):
        assert port[key] == ref[key], key
    assert port["frame_bytes"] < port["full_bytes"]
    ref = reference.bench_cold_leg(2, 16, 2, str(tmp_path / "ref_cold"))
    port = bench_ckpt_save.bench_cold_leg(2, 16, 2, str(tmp_path / "port_cold"), device="cpu")
    assert (port["spills"], port["spilled_bytes"], port["degraded"]) == (
        ref["spills"], ref["spilled_bytes"], ref["degraded"]) == (4, ref["spilled_bytes"], 0)


def test_make_tree_holds_the_references_values(reference):
    import numpy as np

    for it in (None, 3):
        want = reference.make_tree(32, 1.0)
        got = bench_ckpt_save.make_tree(32, 1.0, "cpu")
        if it is not None:
            want, got = reference._touch_tree(want, it), bench_ckpt_save._touch_tree(got, it)
        assert sorted(got["params"]) == sorted(want["params"]) and got["step"] == want["step"]
        for k, v in want["params"].items():
            assert np.array_equal(got["params"][k].numpy(), np.asarray(v)), k


def test_smoke_passes_on_the_cpu():
    proc = subprocess.run([sys.executable, "-m", "tpu_resiliency_torch.scripts.bench_ckpt_save",
                           "--smoke", "--device", "cpu"], cwd=str(REPO), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "bench_ckpt_save smoke OK" in proc.stdout


def test_the_results_name_the_device(tmp_path):
    out = bench_ckpt_save.run(bench_ckpt_save.parse_args(
        ["--mb", "16", "--world", "2", "--rounds", "2", "--device", "cpu"]))
    assert (out["backend"], out["device_kind"], out["card"]) == ("cpu", "cpu", None)
    (size,) = out["sizes"]
    assert size["mb"] == 16 and size["cold"]["spills"] == 4


def test_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        assert bench_ckpt_save.make_tree(16, 0.0)["params"]["w0"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_ckpt_save.make_tree(16, 0.0)
