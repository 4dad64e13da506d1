"""``chip_smoke.py``'s ``model_path`` rehearsed on the CPU at tiny widths: the dense
model trained under the Wrapper (a raise in step 15, the restore of step 10 from the
local tier, the replayed losses bit for bit), the straggler callback's profiled
windows, the preemption notice the process sends itself at step 18 and the save at
that agreed step, loaded in a fresh interpreter and held by SHA-256 of every leaf
against the state at the save; then the MoE family's checks. It runs in a fresh
interpreter, as the phase's Wrapper starts monitor processes and takes SIGTERM."""

import json
import os
import subprocess
import sys

from tests.torch_port_tests import REPO

SCRIPT = """
import torch
import chip_smoke as cs
from tpu_resiliency_torch.models import moe, transformer as tfm

smoke = cs.Smoke(torch, "cpu")
cs.model_path(smoke, device="cpu", dense=tfm.TransformerConfig.tiny(),
              moe_cfg=moe.MoEConfig.tiny(), seq=64, moe_batch=(2, 32), ranks=64,
              bf16_rtol=1e-3)  # tiny widths over 64 tokens: 1.06e-4 apart on the CPU
"""


def test_model_path_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO), TPU_RESILIENCY_LOG_LEVEL="WARNING")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"phase": "model_path"')]
    assert len(line) == 1, proc.stdout[-2000:]
    out = json.loads(line[0])
    dense, moe = out["dense"], out["moe"]
    f32, control = dense["loss_f32_step0"], dense["loss_e5m2_control_step0"]
    assert abs(control - f32) > dense["bf16_rtol"] * abs(f32)  # the control lies outside
    assert dense["replayed_steps"] == [10, 11, 12, 13, 14] and dense["replay_bit_equal"]
    assert dense["preempt_step"] == 18 and dense["fresh_interpreter"]["sha256_equal"]
    assert dense["fresh_interpreter"]["devices"] == ["cpu"]
    assert dense["losses"][-1] < dense["losses"][0] and len(dense["losses"]) == 19
    assert dense["profiled_steps"] == [0, 10, 10]
    assert set(dense["restart_wall_s"]) == {"raise_to_first_step", "abort", "health_check",
                                            "reinit", "restore", "other"}
    assert moe["most_tokens_per_expert_row"] <= moe["capacity"]
    assert moe["losses"][-1] < moe["losses"][0]
