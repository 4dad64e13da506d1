"""``chip_smoke.py``'s ``graft_path`` rehearsed on the CPU: the port's ``entry()`` forward
held to the same forward on the CPU (here the two are one device, so they agree
exactly, and the e5m2 control lies outside the tolerance), and
``dryrun_multichip(2, device="cpu")`` at the default splits (tp = 2, the MoE over
ep = 2) with every ``OK`` line the phase checks for, the telemetry mask equal to the
truth, the checkpoint round trip exact and no process left behind. The ``gpu`` tests run
the phase alone on the card (both ranks on ``cuda:0``, the split dp = 2), and check
that the default split is refused there by the op's name.
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
cs.graft_path(cs.Smoke(torch, kw.pop("card")), **kw)
"""


def _phase(timeout=300, **kw) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO), TPU_RESILIENCY_LOG_LEVEL="WARNING")
    env["CHIP_SMOKE_RUN"] = uuid.uuid4().hex
    proc = subprocess.run([sys.executable, "-c", SCRIPT, json.dumps(kw)], cwd=str(REPO),
                          env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"phase": "graft_path"')]
    assert len(line) == 1, proc.stdout[-2000:]
    return json.loads(line[0])


def _common(out, device, split, moe_split):
    import chip_smoke as cs

    assert out["entry"]["logits_rel_err"] <= out["entry"]["rtol"] < out["entry"]["control_rel_err"]
    assert out["entry"]["device"] == device
    assert [ln.split(":")[0] + ": " for ln in out["lines"]] == list(cs.GRAFT_LINES)
    assert out["split"] == {"dp": 1, "tp": 1, "sp": 1, "pp": 1, "ep": 1, **split}
    assert out["moe_split"] == {"dp": 1, "tp": 1, "sp": 1, "pp": 1, "ep": 1, **moe_split}
    tel = out["telemetry"]
    assert tel["mask"] == tel["truth"] == [True, False]
    assert all(ck["bits_equal"] and ck["placements_equal"] and ck["latest"] == 3
               for ck in out["local_ckpt"])
    assert out["loss"] > 0 and out["moe_loss"] > 0 and out["collectives"]


def test_graft_path_on_the_cpu():
    out = _phase(card="cpu", device="cpu")
    _common(out, "cpu", {"tp": 2}, {"ep": 2})  # the default splits
    assert out["entry"]["logits_rel_err"] == 0.0  # one device: the same forward
    assert out["telemetry"]["kernel_mode"] is None and out["loop_launches"] == 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


@pytest.mark.gpu
def test_graft_path_alone_on_the_card(cuda):
    out = _phase(card="gpu")
    _common(out, "cuda:0", {"dp": 2}, {"dp": 2})
    assert out["telemetry"]["kernel_mode"] == "loop" and out["loop_launches"] == 2
    assert set(out["collectives"]) == {"all_reduce"}
    assert out["within_budget"], out["seconds"]


@pytest.mark.gpu
def test_the_card_refuses_the_default_split_by_the_ops_name(cuda):
    """tp = 2 needs DTensor's all-gather, which gloo does not carry on CUDA tensors: each
    rank refuses it before it runs, naming it."""
    from tpu_resiliency_torch import __graft_entry__ as graft

    with pytest.raises(AssertionError, match="_c10d_functional.all_gather_into_tensor"):
        graft.dryrun_multichip(2)
