"""``chip_smoke.py``'s ``parallel_path`` rehearsed on the CPU at tiny widths:
``bench_model`` on the host, the pipelined dense step at pp = 1 against the
unpipelined loss (with the float8_e5m2 control outside the tolerance), ring attention
at sp = 1 against the dense attention and in the model's loss, and the three examples
(``moe_pipeline_training``, ``inprocess_restart_train`` with two ranks,
``mesh_telemetry_training`` under the port's launcher with two workers) with
``--device cpu``. It runs in a fresh interpreter, as the phase builds a process group
and its examples start Wrapper monitor processes.

The ``gpu`` tests run each part of the phase alone on the card, at small widths."""

import json
import os
import subprocess
import sys

import pytest
import torch

from tests.torch_port_tests import REPO

TINY_BENCH = ["--layers", "2", "--d-model", "64", "--heads", "4", "--kv-heads", "2",
              "--d-ff", "128", "--vocab", "256", "--batch", "2", "--seq", "32", "--iters", "2"]

SCRIPT = """
import json, sys
import torch
import chip_smoke as cs
from tpu_resiliency_torch.models import transformer as tfm

kw = json.loads(sys.argv[1])
smoke = cs.Smoke(torch, kw.pop("card"))
cs.parallel_path(smoke, dense=tfm.TransformerConfig.tiny(), bench=(("tiny", kw.pop("bench")),),
                 pipe_batch=(2, 64), ring_shape=(1, 64, 4, 16), **kw)
"""


def _phase(**kw) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO), TPU_RESILIENCY_LOG_LEVEL="WARNING")
    proc = subprocess.run([sys.executable, "-c", SCRIPT, json.dumps(kw)], cwd=str(REPO),
                          env=env, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"phase": "parallel_path"')]
    assert len(line) == 1, proc.stdout[-2000:]
    return json.loads(line[0])


def test_parallel_path_on_the_cpu():
    # Tiny widths over 64 tokens: the ring's loss lies 2.0e-4 from the default's on the
    # CPU (its softmax stays in float32 where the default rounds to bf16); the e5m2
    # controls lie 4.0e-3 and 8.5e-3 away.
    out = _phase(card="cpu", device="cpu", example_device="cpu", pipe_rtol=1e-3,
                 ring_rtol=1e-3, bench=[*TINY_BENCH, "--device", "cpu"])
    bench = out["bench_model"]["tiny"]
    assert bench["backend"] == "cpu" and bench["mfu"] is None and bench["timer"] == "host_clock"
    pipe, ring = out["pipeline"], out["ring"]
    assert pipe["rel_err"] <= pipe["rtol"] < pipe["control_rel_err"]
    assert pipe["losses"][-1] < pipe["losses"][0] and pipe["n_micro"] == 2
    assert ring["max_abs_err_f32"] <= ring["atol"]
    assert ring["rel_err"] <= ring["rtol"] < ring["control_rel_err"]
    assert out["moe_example"] == ["RESUMED step=3", out["moe_example"][1]]
    assert out["moe_example"][1].startswith("DONE loss=")
    inproc = out["inprocess_example"]
    assert (inproc["iteration"], inproc["active_world"]) == (1, 1) and inproc["resumed_from"] > 0
    mesh = out["mesh_telemetry"]
    assert [r["flagged"] for r in mesh["results"]] == [[1], None]
    assert set(out["part_seconds"]) == set("abcdef")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


@pytest.mark.gpu
@pytest.mark.parametrize("part", list("abcdef"))
def test_card_parallel_path_part(cuda, part):
    """Each part of the phase alone on the card at tiny widths (the examples at their
    own sizes). Part (f)'s workers score on the card through a gloo group."""
    out = _phase(card=cuda, parts=part, pipe_rtol=1e-3, ring_rtol=1e-3, bench=TINY_BENCH)
    assert set(out["part_seconds"]) == {part}
    if part == "a":
        rec = out["bench_model"]["tiny"]
        assert rec["timer"] == "cuda_events" and rec["mfu"] > 0 and rec["mfu_matmul"] > 0
    if part == "f":
        assert [r["device"] for r in out["mesh_telemetry"]["results"]] == ["cuda:0"] * 2
