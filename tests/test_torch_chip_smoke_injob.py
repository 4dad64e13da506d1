"""``chip_smoke.py``'s ``injob_path`` rehearsed on the CPU: its scenarios' own checks
(rounds, hang to kill within the heartbeat timeout's window, the restart cut from the
event stream, the restored state bit-identical to a replay, the masks of an
uninterrupted run, no ``nvcc`` in round 1, the layered restart's ``HealthCheckError``
and both ``[NestedRestarter]`` layers, no agent or monitor on the card) run on a CPU
worker at small widths
(``worker_extra``), through the port's launcher, each scenario a fresh process tree
stamped and reaped as on the card.
"""

import uuid

import pytest

import chip_smoke as cs

SMALL = ["--device", "cpu", "--ranks", "256", "--signals", "8", "--window", "8"]
SHARD = {"params": {"w": [64, 64]}, "opt": {"mu": {"w": [64, 64]}, "nu": {"w": [64, 64]}}}


@pytest.fixture(autouse=True)
def stamped(monkeypatch):
    monkeypatch.setenv(cs.RUN_ENV, uuid.uuid4().hex)


def test_the_hang_scenario_on_a_cpu_worker(tmp_path):
    """The cold respawn. The monitor may kill up to 5 s past its next check here (on
    the card: 1 s), as the test's host runs other tests beside it; the warm spare's
    promotion depends on the spare being warm before the hang, which a loaded host
    does not promise (``tests/test_torch_warm_spares.py`` covers the promotion)."""
    fields, loops, masks = cs.hang_scenario("cold", tmp_path, SHARD, worker_extra=SMALL,
                                            kill_slack_s=5.0)
    assert sorted(masks) == ["100", "200"]
    assert fields["rounds"] == [0, 1] and not fields["promoted"]
    assert fields["checkpoint_at_hang"] == cs.INJOB_CKPT_EVERY
    seg = fields["segments_s"]
    assert seg["detect"] + seg["kill_signal"] == pytest.approx(fields["last_heartbeat_to_kill_s"])
    assert cs.INJOB_HB_TIMEOUT_S <= fields["last_heartbeat_to_kill_s"] <= fields["limit_s"][1]
    assert all(seg[k] >= 0 for k in ("death", "teardown", "rendezvous", "spawn_and_startup",
                                      "cuda_context_and_kernel_load", "restore", "first_step"))
    assert fields["round1"]["restored_equal"] and fields["round1"]["nvcc_runs"] == 0
    assert fields["context_holders"] == [] and loops == 0  # a CPU worker launches no kernel
    roles = fields["processes_by_role"]
    assert roles["agent"] == 1 and roles["worker"] == 2 and roles["monitor"] >= 1


def test_the_layered_scenario_on_a_cpu_worker(tmp_path):
    import types

    import torch

    from tpu_resiliency_torch.examples.resilient_training import Workload

    args = types.SimpleNamespace(ranks=256, signals=8, window=8, shard_shapes=None,
                                 report_every=cs.REPORT_INTERVAL)
    twin, _ = Workload(args, torch.device("cpu"), events=False).replay(cs.REPORT_INTERVAL + 1)
    masks = {str(k): v for k, v in twin.masks.items()}  # an uninterrupted run's
    fields, loops = cs.layered_scenario(tmp_path, masks, worker_extra=SMALL)
    assert fields["rounds"] == [0, 1] and "HealthCheckError" in fields["round0_failure"]
    assert fields["nested_restarter_layers"] == {"InJob": True, "InProcess": True}
    assert fields["round1"]["iterations"] == [0] and loops == 0


@pytest.mark.parametrize("tail", ["", "[2026-01-01 00:00:00,000] [INFO] [launcher] round 1"],
                         ids=["whole-line", "another-process-after-the-record"])
def test_result_records_read_the_json_at_the_start_of_each_line(tail):
    out = f'log\nRESULT {{"round": 1, "masks": {{"100": [3]}}}}{tail}\nRESULT [0]\n'
    assert cs.result_records(out) == [{"round": 1, "masks": {"100": [3]}}, [0]]
