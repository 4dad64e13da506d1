"""``chip_smoke.py``'s ``observe_path`` rehearsed on the CPU: the port's launcher with
``--warm-spares 1 --metrics-file --incidents-dir --telemetry-port 0 --autoscale act
--alerts on`` over a CPU worker at 64 ranks x 8 signals x window 32, priced from a
``BENCH_restart.json`` in the launcher's working directory. The phase's own checks
hold: the one swap of rank 0 actuated (``ok``), round 1 the parked spare's promotion,
the reinstate after the recovery, one incident opened on the degraded set and closed
as recovered (``tools.incident_report`` renders it), the restored ring and the masks
equal to an uninterrupted replay's, the metrics counted in the processes' snapshots
and in the stream, every endpoint answering 200, ``/goodput``'s phases within 5% of
its wall clock, the swap priced at the given respawn. The ``gpu`` test runs the phase
alone on the card.
"""

import json
import os
import subprocess
import sys
import uuid

import pytest
import torch

from tests.torch_port_tests import REPO

#: The respawn segments the CPU run prices with (the card's, PERF.md section 5: a warm
#: spare 10.03 s, a cold respawn 15.55 s from the last heartbeat).
COSTS = {"in_job": {"detect_ms": 5480.0, "teardown_ms": 120.0, "rendezvous_ms": 230.0,
                    "respawn_ms": 9720.0},
         "in_job_warm_spares": {"detect_ms": 5150.0, "teardown_ms": 110.0,
                                "rendezvous_ms": 220.0, "respawn_ms": 4550.0}}

SCRIPT = """
import json, sys
import torch
import chip_smoke as cs

kw = json.loads(sys.argv[1])
cs.observe_path(cs.Smoke(torch, kw.pop("card")), **kw)
"""


def _phase(**kw) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO), TPU_RESILIENCY_LOG_LEVEL="WARNING")
    env["CHIP_SMOKE_RUN"] = uuid.uuid4().hex
    proc = subprocess.run([sys.executable, "-c", SCRIPT, json.dumps(kw)], cwd=str(REPO),
                          env=env, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"phase": "observe_path"')]
    assert len(line) == 1, proc.stdout[-2000:]
    return json.loads(line[0])


def test_observe_path_on_the_cpu():
    # The CPU worker's work is a host sleep, whose wake-up a loaded host delays by
    # far more than the card's clocks drift: rank 0's slowdown is rounded to 0.25 here
    # (the card: 0.1), which still reads 1.6x padding as 1.5 or more and unpadded
    # steps as 1.0.
    out = _phase(card="cpu", device="cpu", ranks=64, signals=8, window=32, work_ms=20.0,
                 quantum=0.25, restart_costs=COSTS, timeout=50.0)
    (swap,) = [d for d in out["decisions"] if d["action"] == "swap"]
    assert swap["victims"] == [0] and swap["outcome"] == "ok"
    # priced with the given warm respawn: 5.15 + 0.11 + 0.22 + 4.55 s
    assert out["controller_restart_s"]["warm_restart_s"] == pytest.approx(10.03)
    assert swap["predicted_delta_s"] == pytest.approx(out["forecast"]["priced"]["card"])
    assert out["forecast"]["priced"]["repo_cpu_bench_restart"] > swap["predicted_delta_s"]
    assert out["incident"]["trigger"] == "degraded" and out["incident"]["outcome"] == "recovered"
    assert out["round1"]["restored_equal"] and out["round1"]["masks_equal_uninterrupted"]
    assert all(v == [1, 1] for v in out["metrics"]["counts_snapshots_stream"].values())
    assert all(e["ok"] >= 1 for e in out["endpoints"].values())
    assert out["context_holders"] == [] and out["loop_launches"] == 0  # no kernel on the CPU


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_observe_path_alone_on_the_card():
    out = _phase(card="gpu", restart_costs=COSTS, ranks=4096, signals=64, window=32)
    assert out["loop_launches"] >= 4 and out["round1"]["restored_equal"]
