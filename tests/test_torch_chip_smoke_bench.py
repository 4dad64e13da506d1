"""``chip_smoke.py``'s ``bench_path`` rehearsed on the CPU at a small size: the port's
``bench.py`` whole (every variant in its own interpreter, the plain versions for the
kernel modes, ``vs_baseline`` null), then ``scripts/bench_pallas_sweep.py`` in-process.
The ``gpu`` test runs the phase alone on the card at config 4's defaults.
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
card = kw.pop("card")
if card == "gpu":
    from tpu_resiliency_torch.platform.device import card_name_and_power_limit
    card = card_name_and_power_limit()
times = {"push_ms_per_step": 0.05, "score_ms_per_report": 1.0, "amortised_ms_per_step": 0.06}
print(json.dumps({"launches": cs.bench_path(cs.Smoke(torch, card), times, **kw)}))
"""


def _phase(timeout=300, **kw) -> tuple[dict, dict]:
    env = dict(os.environ, PYTHONPATH=str(REPO), TPU_RESILIENCY_LOG_LEVEL="WARNING")
    env["CHIP_SMOKE_RUN"] = uuid.uuid4().hex
    proc = subprocess.run([sys.executable, "-c", SCRIPT, json.dumps(kw)], cwd=str(REPO),
                          env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"phase": "bench_path"')]
    assert len(line) == 1, proc.stdout[-2000:]
    return json.loads(line[0]), json.loads(proc.stdout.strip().splitlines()[-1])


def test_bench_path_on_the_cpu():
    out, ret = _phase(card="cpu", device="cpu", bench_args=["--ranks", "128", "--signals",
                                                            "8", "--iters", "2"],
                      sweep_ws=[8], sweep_rs=[64], budget_s=300)
    assert all(out["checks"].values()), out["checks"]
    assert ret["launches"] == out["launches"] == {"loop": 0, "pairwise": 0, "radix": 0}
    bench = out["bench"]
    assert bench["backend"] == "cpu" and bench["vs_baseline"] is None
    assert out["beside_times"]["bench"]["amortised_ms_per_step"] == bench["value"]
    assert out["sweep"]["backend"] == "cpu" and set(out["sweep"]["results_ms"]) == {"64x8"}
    assert set(out["sweep_agrees"]) == {"loop_max_window", "radix_auto"}


def test_cap_agrees_reads_the_grid():
    import chip_smoke as cs

    assert cs.cap_agrees(32, (32, 512), 64)  # 64 lies short of the next window tried
    assert not cs.cap_agrees(32, (32, 64, 512), 64)  # 64 was tried and lost
    assert cs.cap_agrees(64, (32, 64, 128), 64)
    assert not cs.cap_agrees(128, (32, 64, 128), 64)
    assert cs.cap_agrees(512, (32, 512), 1024) and not cs.cap_agrees(0, (32,), 64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


@pytest.mark.gpu
def test_bench_path_alone_on_the_card(cuda):
    out, ret = _phase(card="gpu", timeout=900)
    assert all(out["checks"].values()), out["checks"]
    bench = out["bench"]
    assert bench["backend"] == "cuda" and bench["device_kind"] == cuda
    assert bench["vs_baseline"] > 0 and bench["rings"]["kernel_mode"] == "loop"
    for variant in ("loop", "pairwise", "radix", "rings"):
        assert bench["variants"][variant]["launches"] >= 1, variant
        assert 0.0 <= bench["variants"][variant].get("idle_share", 0.0) < 1.0, variant
    assert min(ret["launches"].values()) >= 1
