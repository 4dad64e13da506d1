"""The port's launcher end to end, held against ``tests/launcher/test_launcher_e2e.py``
and ``tests/launcher/test_layered_restart.py``: each scenario runs through the JAX
package's CLI (``python -m tpu_resiliency.launcher.launch``) and then through the port's
(``python -m tpu_resiliency_torch.launcher.launch``), one after the other, with the
same flags and a worker of the CLI's own package, and both must give the same outcome:
the return code, the rounds run and the names of the launcher's, rendezvous' and
watchdog's events. Times are never compared.

The scenarios: success with two workers, restart until success, the restart budget
exhausted, a worker hang the FT monitor detects, a workload-control shutdown, the
resilient-training example (a crash in round 0, resumed from the local checkpoint in
round 1) and a layered restart (an exception the in-process layer absorbs, then a
process death the in-job layer respawns). The examples are ``examples/*.py`` for the
JAX package and ``tpu_resiliency_torch.examples.*`` on the CPU for the port. Every
launcher run has its own timeout. On the card (``gpu``): one worker whose device hangs
in round 0 is killed by its monitor and round 1 completes.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from tests.torch_port_tests import REPO
from tests.torch_model_util import held_port

PACKAGES = ("tpu_resiliency", "tpu_resiliency_torch")
SOURCES = ("launcher", "rendezvous", "watchdog")
FAST = ["--rdzv-last-call", "0.2", "--monitor-interval", "0.1"]


def launch(pkg, args, worker, tmp_path, timeout=180.0):
    """One launcher run of ``pkg``'s CLI; returns (rc, rounds, event kinds, stdout,
    stderr). ``worker``: the script path or ``["-m", module, ...]``."""
    tag = pkg.rsplit("_", 1)[-1]
    events = tmp_path / f"events_{tag}.jsonl"
    env = dict(os.environ, TPU_RESILIENCY_LOG_LEVEL="INFO", JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", f"{pkg}.launcher.launch", *args, "--events-file", str(events),
           "--run-dir", str(tmp_path / f"run_{tag}"), *worker]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env,
                           cwd=str(tmp_path))
    except subprocess.TimeoutExpired as e:
        raise AssertionError(f"{pkg}: the launcher did not finish within {timeout} s:\n"
                             f"{(e.stderr or '')[-3000:]}") from e
    recs = [json.loads(ln) for ln in events.read_text().splitlines()] if events.exists() else []
    rounds = sorted({e["round"] for e in recs if e.get("kind") == "rendezvous_round"})
    kinds = sorted({e["kind"] for e in recs if e.get("source") in SOURCES})
    return r.returncode, rounds, kinds, r.stdout, r.stderr


def script(tmp_path, pkg, name, body):
    path = tmp_path / f"{name}_{pkg.rsplit('_', 1)[-1]}.py"
    path.write_text(textwrap.dedent(body).replace("PKG", pkg))
    return [str(path)]


def both(tmp_path, args, worker_of, timeout=180.0):
    """Run the scenario through both CLIs, one after the other; returns their runs,
    the JAX package's first, after checking their outcomes agree."""
    runs = [launch(pkg, args, worker_of(pkg), tmp_path, timeout) for pkg in PACKAGES]
    outcomes = [run[:3] for run in runs]
    assert outcomes[0] == outcomes[1], (
        f"JAX package {outcomes[0]} != port {outcomes[1]}\n"
        f"port stderr:\n{runs[1][4][-3000:]}")
    return runs


def ok_two_workers(tmp_path):
    def worker(pkg):
        return script(tmp_path, pkg, "ok", f"""
            import os
            with open({str(tmp_path)!r} + "/out_" + os.environ["RANK"] + "_PKG.txt", "w") as f:
                f.write(os.environ["WORLD_SIZE"])
            """)

    runs = both(tmp_path, ["--nproc-per-node", "2", "--rdzv-endpoint",
                           f"127.0.0.1:{held_port()}", "--no-ft-monitors", *FAST], worker)
    assert runs[1][:2] == (0, [0])
    for pkg in PACKAGES:
        assert [(tmp_path / f"out_{r}_{pkg}.txt").read_text() for r in (0, 1)] == ["2", "2"]


def restart_until_success(tmp_path):
    def worker(pkg):
        return script(tmp_path, pkg, "flaky", """
            import os, sys
            round_no = int(os.environ["TPU_FT_RESTART_COUNT"])
            if round_no < 2:
                print(f"round {round_no}: failing", file=sys.stderr)
                sys.exit(3)
            print(f"round {round_no}: ok")
            """)

    runs = both(tmp_path, ["--nproc-per-node", "2", "--rdzv-endpoint",
                           f"127.0.0.1:{held_port()}", "--max-restarts", "4", "--no-ft-monitors",
                           *FAST], worker)
    assert runs[1][:2] == (0, [0, 1, 2])
    assert all("requesting restart round" in run[4] for run in runs)


def budget_exhausted(tmp_path):
    def worker(pkg):
        return script(tmp_path, pkg, "dead", "raise RuntimeError('always broken')")

    runs = both(tmp_path, ["--nproc-per-node", "1", "--rdzv-endpoint",
                           f"127.0.0.1:{held_port()}", "--max-restarts", "1", "--no-ft-monitors",
                           *FAST], worker)
    assert runs[1][:2] == (1, [0, 1])
    assert all("restart budget" in run[4] and "RuntimeError" in run[4] for run in runs)


def hang_detected_by_monitor(tmp_path):
    def worker(pkg):
        return script(tmp_path, pkg, "hang", """
            import os, time
            from PKG.watchdog import RankMonitorClient

            round_no = int(os.environ["TPU_FT_RESTART_COUNT"])
            c = RankMonitorClient()
            c.init_workload_monitoring()
            if round_no == 0:
                time.sleep(600)  # hang: no heartbeat ever arrives
            for _ in range(3):
                c.send_heartbeat()
                time.sleep(0.1)
            c.shutdown_workload_monitoring()
            print("recovered")
            """)

    runs = both(tmp_path, ["--nproc-per-node", "1", "--rdzv-endpoint",
                           f"127.0.0.1:{held_port()}", "--max-restarts", "2", *FAST,
                           "--ft-param-initial_rank_heartbeat_timeout", "3",
                           "--ft-param-rank_heartbeat_timeout", "3",
                           "--ft-param-workload_check_interval", "0.5"], worker)
    assert runs[1][0] == 0 and runs[1][1] == [0, 1]
    assert "hang_detected" in runs[1][2]


def control_shutdown(tmp_path):
    def worker(pkg):
        return script(tmp_path, pkg, "quitter", """
            import time
            from PKG.watchdog import RankMonitorClient, WorkloadAction

            c = RankMonitorClient()
            c.init_workload_monitoring()
            c.send_workload_control_request(WorkloadAction.ShutdownWorkload, "test says stop")
            time.sleep(600)  # the launcher should kill us
            """)

    runs = both(tmp_path, ["--nproc-per-node", "1", "--rdzv-endpoint",
                           f"127.0.0.1:{held_port()}", "--max-restarts", "3", *FAST], worker)
    assert runs[1][:2] == (1, [0])
    assert all("shut down" in run[4] for run in runs)


SMALL = ["--device", "cpu", "--ranks", "64", "--signals", "8", "--window", "8"]


def resilient_training(tmp_path):
    def worker(pkg):
        if pkg == "tpu_resiliency":
            return [str(REPO / "examples" / "resilient_training.py"), "--steps", "30",
                    "--ckpt-dir", str(tmp_path / "ckpt_jax")]
        return ["-m", "tpu_resiliency_torch.examples.resilient_training", "--steps", "30",
                "--ckpt-dir", str(tmp_path / "ckpt_torch"), *SMALL, "--report-every", "10",
                "--verify"]

    runs = both(tmp_path, ["--nproc-per-node", "1", "--rdzv-endpoint", "127.0.0.1:0",
                           "--max-restarts", "2", *FAST,
                           "--ft-param-initial_rank_heartbeat_timeout", "60",
                           "--ft-param-rank_heartbeat_timeout", "60"], worker, timeout=300.0)
    assert runs[1][:2] == (0, [0, 1])
    for rc, _, _, out, err in runs:
        assert "resumed from step 10" in out + err, (out[-1500:], err[-1500:])
    result = json.loads(next(ln for ln in runs[1][3].splitlines()
                             if ln.startswith("RESULT "))[len("RESULT "):])
    assert result["start_step"] == 10 and result["final_step"] == 30
    assert result["restored_equal"] and result["masks_equal_uninterrupted"]


def layered_restart(tmp_path):
    def worker(pkg):
        if pkg == "tpu_resiliency":
            return [str(REPO / "examples" / "layered_restart.py"), "--steps", "20"]
        return ["-m", "tpu_resiliency_torch.examples.layered_restart", "--steps", "20", *SMALL,
                "--report-every", "5"]

    runs = both(tmp_path, ["--nproc-per-node", "2", "--rdzv-endpoint", "127.0.0.1:0",
                           "--max-restarts", "2", "--no-ft-monitors", *FAST], worker,
                timeout=300.0)
    assert runs[1][:2] == (0, [0, 1])
    for rc, _, _, out, err in runs:
        log = out + err
        assert "name=[InProcess]" in log and "name=[InJob]" in log
        assert "state=handling_start iteration=0" in log  # the in-process layer restarted
        assert log.count("finished (launcher round 1") == 2


SCENARIOS = {
    "success_two_workers": ok_two_workers,
    "restart_until_success": restart_until_success,
    "budget_exhausted": budget_exhausted,
    "hang_detected_by_monitor": hang_detected_by_monitor,
    "control_shutdown": control_shutdown,
    "resilient_training_example": resilient_training,
    "layered_restart": layered_restart,
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_both_clis_give_the_same_outcome(scenario, tmp_path):
    SCENARIOS[scenario](tmp_path)


# -- on the card ------------------------------------------------------------------------


@pytest.mark.gpu
def test_a_hung_card_is_killed_by_its_monitor_and_round_1_completes(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rc, rounds, kinds, out, err = launch(
        "tpu_resiliency_torch",
        ["--nproc-per-node", "1", "--rdzv-endpoint", "127.0.0.1:0", "--max-restarts", "1",
         *FAST, "--ft-param-rank_heartbeat_timeout", "5",
         "--ft-param-workload_check_interval", "0.5", "--ft-param-stack_dump_grace", "0"],
        ["-m", "tpu_resiliency_torch.examples.resilient_training", "--steps", "60",
         "--fault", "hang", "--fault-step", "30", "--ckpt-every", "20", "--report-every", "20",
         "--ranks", "256", "--ckpt-dir", str(tmp_path / "ckpt"), "--verify"],
        tmp_path, timeout=300.0)
    assert rc == 0 and rounds == [0, 1], err[-3000:]
    assert "hang_detected" in kinds
    result = json.loads(next(ln for ln in out.splitlines()
                             if ln.startswith("RESULT "))[len("RESULT "):])
    assert result["round"] == 1 and result["restored_equal"]
    assert result["masks_equal_uninterrupted"]
