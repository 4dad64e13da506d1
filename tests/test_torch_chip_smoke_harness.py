"""``chip_smoke.py``'s ``harness_path`` rehearsed on the CPU: the port's three measuring
harnesses called in one process, ``bench_configs`` (BASELINE configs 1-3),
``bench_restart`` (in-process restart, the in-job respawn cold and with warm spares,
the fast-path rendezvous, torch.compile's cache across a respawn) and
``bench_ckpt_save`` (the sync and pipelined engines, the delta and cold legs, the
single-rank checkpointer), at small sizes. The phase's own checks hold: the
reference's assertions over each harness, the pipelined foreground at most 0.25x the
sync engine's, the delta frame under the full container, the cold tier spilling every
round undegraded, the compile cache's ``miss`` then ``hit`` with a cheaper compile,
and no process left. The ``gpu`` test runs the phase alone on the card at its sizes.
"""

import json
import os
import subprocess
import sys
import uuid

import pytest
import torch

from tests.torch_port_tests import REPO

SCRIPT = """
import json, sys
import torch
import chip_smoke as cs

kw = json.loads(sys.argv[1])
cs.harness_path(cs.Smoke(torch, kw.pop("card")), **kw)
"""


def _phase(timeout=170, **kw) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO), TPU_RESILIENCY_LOG_LEVEL="WARNING")
    env["CHIP_SMOKE_RUN"] = uuid.uuid4().hex
    proc = subprocess.run([sys.executable, "-c", SCRIPT, json.dumps(kw)], cwd=str(REPO),
                          env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"phase": "harness_path"')]
    assert len(line) == 1, proc.stdout[-2000:]
    return json.loads(line[0])


def test_harness_path_on_the_cpu():
    out = _phase(timeout=400, card="cpu", device="cpu", iters=1, restarts=1, budget_s=380.0,
                 ckpt={"mb": 16, "world": 2, "rounds": 2})
    assert all(ok for k, ok in out["checks"].items() if k not in out["recorded_only"]), \
        out["checks"]
    # The CPU holds no speed gate of the card's (the port's CPU foreground, ROADMAP Queue 3).
    assert out["recorded_only"] == ["cold_foreground_unmoved", "pipelined_fg_ratio"]
    assert out["compile_outcomes"] == ["miss", "hit"]
    assert out["compile_manifest_entries"]["inductor"] > 0
    assert out["config3_timer"] == "host_clock" and out["loop_launches"] == 0  # no kernel
    assert out["loop_config3"] == {} and len(out["cold_attempts"]) == 1
    assert out["strays_killed"] == [] and out["card_holders"] == []


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


@pytest.mark.gpu
def test_harness_path_alone_on_the_card(cuda):
    out = _phase(card="gpu")
    assert all(ok for k, ok in out["checks"].items() if k not in out["recorded_only"]), \
        out["checks"]
    assert out["loop_launches"] == 31 and out["config3_timer"] == "cuda_events"
    assert out["loop_config3"]["shape"] == [1024, 16, 32] and out["loop_config3"]["ms"] > 0
    assert out["compile_manifest_entries"]["triton"] > 0
