"""The port's launcher pieces, held against ``tests/launcher/test_proc.py``,
``test_rendezvous.py``, ``test_rendezvous_fastpath.py`` and ``test_launch_cli.py``: each
of their tests runs here on ``tpu_resiliency_torch.launcher`` (``torch_port_tests``),
on the port's store, with the workers' ``@record`` and the ``-m`` entry points the
port's. ``test_failure_collects_error_file`` fails today on a loaded host (it stops
the group while the healthy rank may still be starting, which then counts as a
failure), so it is no oracle: its port counterpart below waits for every worker to
exit first. Beside them: ``--fleet-dir``, whose modules the port does not hold yet,
exits with an error naming them, and an agent config that asks for it raises; each
option of the observability slice (``--metrics-file``, ``--incidents-dir``,
``--telemetry-port``, ``--autoscale``, ``--alerts``) puts its artifact in its place in
a launcher run on the CPU; both CLIs parse every flag of the reference's parser.
"""

import os
import subprocess
import sys
import textwrap
import time

import pytest

from tests.torch_port_tests import REPO, port_tests


@pytest.fixture
def kv_server():
    from tpu_resiliency_torch.platform.store import KVServer

    server = KVServer(host="127.0.0.1", port=0)
    yield server
    server.close()


port_tests("tests/launcher/test_proc.py", globals(), leave_out={
    "test_failure_collects_error_file": "fails today under load; answered below",
})
port_tests("tests/launcher/test_rendezvous.py", globals())
port_tests("tests/launcher/test_rendezvous_fastpath.py", globals())
port_tests("tests/launcher/test_launch_cli.py", globals())


def test_failure_collects_error_file_once_every_worker_has_exited(tmp_path):
    from tpu_resiliency_torch.launcher.proc import GroupState, WorkerGroup

    script = tmp_path / "boom.py"
    script.write_text(textwrap.dedent(
        """
        import os
        from tpu_resiliency_torch.launcher.errors import record

        @record
        def main():
            if os.environ["RANK"] == "1":
                raise ValueError("rank one always dies")

        main()
        """
    ))
    group = WorkerGroup(argv=[str(script)], nproc=2, base_env={}, run_dir=str(tmp_path / "run"))
    group.start(round_no=0, first_global_rank=0, world_size=2)
    deadline = time.monotonic() + 120.0
    while any(w.exitcode is None for w in group.workers) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert group.poll() is GroupState.FAILED
    group.stop()
    failures = group.failures()
    assert [f.global_rank for f in failures] == [1]
    f = failures[0]
    assert f.exitcode == 1 and f.error is not None
    assert f.error.exception_type == "ValueError"
    assert "rank one always dies" in f.error.message and "ValueError" in f.error.traceback
    assert "rank 1" in f.describe() and "ValueError" in f.describe()


UNPORTED_FLAGS = [
    (["--fleet-dir", "fleet"], "fleet/"),
]


@pytest.mark.parametrize("flags,module", UNPORTED_FLAGS)
def test_a_flag_whose_module_is_not_ported_exits_naming_it(flags, module, tmp_path):
    from tpu_resiliency_torch.launcher import launch

    script = tmp_path / "never.py"
    script.write_text(f"open({str(tmp_path / 'ran')!r}, 'w').close()\n")
    argv = ["--standalone", "--run-dir", str(tmp_path / "run"), *flags, str(script)]
    with pytest.MonkeyPatch.context() as mp:
        records = []
        mp.setattr(launch.log, "error", records.append)
        assert launch.main(argv) == 2
    assert any(module in r and "not ported" in r for r in records), records
    assert not (tmp_path / "ran").exists()


@pytest.mark.parametrize("field,value,module", [
    ("fleet_dir", "fleet", "fleet/"),
])
def test_an_agent_config_that_asks_for_an_unported_module_raises(field, value, module):
    from tpu_resiliency_torch.launcher import AgentConfig
    from tpu_resiliency_torch.launcher.agent import UNPORTED_FEATURES

    assert list(UNPORTED_FEATURES) == ["fleet_dir"]
    with pytest.raises(NotImplementedError, match=module):
        AgentConfig(argv=["x.py"], **{field: value})
    cfg = AgentConfig(argv=["x.py"], alerts="on", autoscale="act", telemetry_port=0,
                      incidents_dir="inc")
    assert cfg.warm_spare_preload == "torch"


#: A worker for the option runs: it records what the option's plane reads, fetches
#: the launcher's endpoints through the port file, and fails in round 0 when asked.
OPTION_WORKER = """
import json, os, sys, time, urllib.request
from tpu_resiliency_torch.utils.events import record

out = sys.argv[1]
round_no = int(os.environ.get("TPU_FT_RESTART_COUNT", "0"))
for i in range(3):
    record("worker", "iteration_start", iteration=i)
if "degrade" in sys.argv and round_no == 0:
    record("telemetry", "degraded_set", degraded=[0], newly=[0], recovered=[],
           scores={"0": 0.2})
    time.sleep(3.0)  # the controller's ticks tail the stream meanwhile
answers = {}
for path in sys.argv[2:]:
    if not path.startswith("/"):
        continue
    port_file = os.path.join(os.environ["RUN_DIR"], "telemetry.port")
    deadline = time.time() + 30
    while not os.path.exists(port_file) and time.time() < deadline:
        time.sleep(0.05)
    port = int(open(port_file).read().strip())
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        answers[path] = [r.status, json.loads(r.read() or b"null")]
json.dump(answers, open(out + f".{round_no}", "w"))
if "fail" in sys.argv and round_no == 0:
    sys.exit(3)
"""


def _launch_with(tmp_path, flags, *worker_args):
    """One launcher run on the CPU with ``flags``; returns the run's events and what
    the worker fetched from the launcher's endpoints, by round."""
    import glob
    import json

    script = tmp_path / "worker.py"
    script.write_text(OPTION_WORKER)
    events = tmp_path / "events.jsonl"
    run_dir = tmp_path / "run"
    env = dict(os.environ, PYTHONPATH=str(REPO), RUN_DIR=str(run_dir))
    r = subprocess.run(
        [sys.executable, "-m", "tpu_resiliency_torch.launcher.launch", "--standalone",
         "--no-ft-monitors", "--rdzv-last-call", "0.2", "--monitor-interval", "0.1",
         "--max-restarts", "1", "--run-dir", str(run_dir), "--events-file", str(events),
         *flags, str(script), str(tmp_path / "answers"), *worker_args],
        capture_output=True, text=True, timeout=120, env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    recs = [json.loads(ln) for ln in events.read_text().splitlines()]
    answers = {int(p.rsplit(".", 1)[1]): json.loads(open(p).read())
               for p in glob.glob(str(tmp_path / "answers.*"))}
    return recs, answers


def test_metrics_file_writes_each_process_snapshot(tmp_path):
    import glob
    import json

    recs, _ = _launch_with(tmp_path, ["--metrics-file", str(tmp_path / "m.json"),
                                      "--alerts", "off"])
    snaps = {p: json.loads(open(p).read()) for p in glob.glob(str(tmp_path / "m.*.json"))}
    pids = {e["pid"] for e in recs}
    assert len(snaps) >= 2 and {int(p.rsplit(".", 2)[1]) for p in snaps} <= pids
    names = {name for snap in snaps.values() for name in snap["metrics"]}
    assert "tpu_rendezvous_rounds_total" in names, sorted(names)


def test_incidents_dir_writes_the_failed_rounds_incident(tmp_path):
    from tpu_resiliency_torch.launcher.incident import read_incident

    inc = tmp_path / "inc"
    recs, _ = _launch_with(tmp_path, ["--incidents-dir", str(inc), "--alerts", "off"], "fail")
    (path,) = inc.glob("incident-*.json")
    doc = read_incident(str(path))
    assert doc["schema"] == "tpu-incident-1" and doc["trigger"] == "worker_failed"
    assert doc["outcome"] == "recovered" and doc["slo"]["time_to_recover_s"] is not None
    assert {"incident_opened", "incident_closed"} <= {e["kind"] for e in recs}


def test_telemetry_port_writes_the_port_file_and_answers_healthz(tmp_path):
    recs, answers = _launch_with(tmp_path, ["--telemetry-port", "0", "--alerts", "off"],
                                 "/healthz")
    status, doc = answers[0]["/healthz"]
    assert status == 200 and doc["healthy"] is True


def test_autoscale_advises_a_swap_from_the_degraded_set(tmp_path):
    recs, _ = _launch_with(tmp_path, ["--autoscale", "advise", "--warm-spares", "1",
                                      "--alerts", "off"], "degrade")
    (decision,) = [e for e in recs if e["kind"] == "autoscale_decision"]
    assert (decision["action"], decision["victims"], decision["outcome"]) == (
        "swap", [0], "advised")
    assert [e["realized_delta_s"] for e in recs if e["kind"] == "autoscale_outcome"]


def test_alerts_on_serves_the_watchtower(tmp_path):
    recs, answers = _launch_with(tmp_path, ["--telemetry-port", "0", "--alerts", "on"],
                                 "/alerts")
    status, doc = answers[0]["/alerts"]
    assert status == 200 and doc["schema"] == "tpu-alerts-1" and doc["rules"]


def _actions(parser):
    return sorted((a.dest, tuple(a.option_strings), a.nargs, a.const)
                  for a in parser._actions)


def test_the_port_cli_has_every_flag_of_the_reference_cli():
    import tpu_resiliency.launcher.launch as ref
    import tpu_resiliency_torch.launcher.launch as port

    assert _actions(port.build_parser()) == _actions(ref.build_parser())
    defaults = {a.dest: a.default for a in port.build_parser()._actions}
    ref_defaults = {a.dest: a.default for a in ref.build_parser()._actions}
    changed = {k for k in defaults if defaults[k] != ref_defaults[k]}
    assert changed == {"warm_spare_preload"}
    assert (defaults["warm_spare_preload"], defaults["alerts"]) == ("torch", "on")
    assert port._STORE_TRUE_FLAGS == ref._STORE_TRUE_FLAGS


def test_the_compile_cache_flag_exports_the_compiler_caches(tmp_path):
    """``--compile-cache-dir`` exports the port's cache variable and torch.compile's
    two, under the directory, to the workers."""
    script = tmp_path / "env.py"
    script.write_text(textwrap.dedent(
        f"""
        import json, os
        keys = ("TPU_RESILIENCY_COMPILE_CACHE_DIR", "TORCHINDUCTOR_CACHE_DIR",
                "TRITON_CACHE_DIR", "JAX_COMPILATION_CACHE_DIR")
        with open({str(tmp_path / 'env.json')!r}, "w") as f:
            json.dump({{k: os.environ.get(k) for k in keys}}, f)
        """
    ))
    cache = tmp_path / "cc"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    for k in ("TORCHINDUCTOR_CACHE_DIR", "TRITON_CACHE_DIR", "JAX_COMPILATION_CACHE_DIR"):
        env.pop(k, None)
    r = subprocess.run(
        [sys.executable, "-m", "tpu_resiliency_torch.launcher.launch", "--standalone",
         "--no-ft-monitors", "--rdzv-last-call", "0.2", "--monitor-interval", "0.1",
         "--run-dir", str(tmp_path / "run"), "--compile-cache-dir", str(cache), str(script)],
        capture_output=True, text=True, timeout=120, env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    import json

    got = json.loads((tmp_path / "env.json").read_text())
    assert got == {"TPU_RESILIENCY_COMPILE_CACHE_DIR": str(cache),
                   "TORCHINDUCTOR_CACHE_DIR": str(cache / "inductor"),
                   "TRITON_CACHE_DIR": str(cache / "triton"),
                   "JAX_COMPILATION_CACHE_DIR": None}
