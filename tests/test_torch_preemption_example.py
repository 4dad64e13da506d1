"""``tpu_resiliency_torch/examples/preemption_train.py`` on the CPU (the reference has no
test of its ``examples/preemption_train.py``): two gloo workers, SIGTERM to rank 1; both
must save the same agreed step, the two containers must load with that step's values,
and a second run over the same directory must resume from the step after it."""

import json
import os
import subprocess
import sys

import numpy as np

from tests.torch_port_tests import REPO
from tpu_resiliency_torch.checkpoint import LocalCheckpointManager


def _run(*argv):
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_resiliency_torch.examples.preemption_train", "--world", "2",
         "--device", "cpu", *argv], capture_output=True, text=True, timeout=240, env=env,
        cwd=str(REPO))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = [ln.split(": ", 1)[1] for ln in proc.stdout.splitlines()
             if ln.startswith("[parent] rank ") and ": {" in ln]
    return {r["rank"]: r for r in map(json.loads, lines)}, proc.stdout


def test_both_workers_save_the_agreed_step_and_it_restores(tmp_path):
    root = str(tmp_path / "ckpt")
    runs, out = _run("--ckpt-root", root, "--notice-after", "1.0")
    assert "PREEMPTION-SYNC OK" in out, out
    saved = runs[0]["saved"]
    assert saved is not None and runs[1]["saved"] == saved, runs
    assert runs[0]["stopped_at"] == runs[1]["stopped_at"] == saved + 1 < 400
    for rank in (0, 1):
        mgr = LocalCheckpointManager(root, rank=rank)
        try:
            assert mgr.find_latest() == saved
            tree, _ = mgr.load_tree(saved, device="cpu")
        finally:
            mgr.close()
        np.testing.assert_array_equal(tree["w"].numpy(), np.full((4, 2), saved + 1.0))

    resumed, out = _run("--ckpt-root", root, "--notice-after", "-1", "--steps", str(saved + 6))
    for rank in (0, 1):
        assert resumed[rank]["resumed"] == saved + 1, out
        assert resumed[rank]["w"] == saved + 6.0 and resumed[rank]["saved"] is None
