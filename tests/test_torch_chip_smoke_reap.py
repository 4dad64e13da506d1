"""``chip_smoke.py`` reaps only the processes its own run started: those whose
environment holds the run's stamp (``RUN_ENV``), the Wrapper's double-forked monitor
daemons included, and never another run's or a process that merely runs a file of
the same name.
"""

import os
import subprocess
import sys
import time

import chip_smoke

# Double-forks as ``MonitorProcess.start`` does, prints the grandchild's pid, and
# leaves it sleeping, detached from the caller's pipes.
DAEMON = """
import os, sys, time
r, w = os.pipe()
if os.fork() == 0:
    os.setsid()
    if os.fork() == 0:
        os.write(w, str(os.getpid()).encode())
        os.close(w)
        null = os.open(os.devnull, os.O_RDWR)  # drop the inherited stdio, as the monitor does
        for fd in (0, 1, 2):
            os.dup2(null, fd)
        time.sleep(60)
    os._exit(0)
os.close(w)
print(os.read(r, 32).decode(), flush=True)
"""


def test_stray_processes_are_this_runs_only(monkeypatch, tmp_path):
    monkeypatch.setenv(chip_smoke.RUN_ENV, "run-a")
    namesake = tmp_path / "chip_smoke.py"
    namesake.write_text("import time\ntime.sleep(60)\n")
    base = {k: v for k, v in os.environ.items() if k != chip_smoke.RUN_ENV}
    sleeper = [sys.executable, "-c", "import time; time.sleep(60)"]
    procs = {
        "ours": subprocess.Popen(sleeper, env=dict(base, **{chip_smoke.RUN_ENV: "run-a"})),
        "other_run": subprocess.Popen(sleeper, env=dict(base, **{chip_smoke.RUN_ENV: "run-b"})),
        "namesake": subprocess.Popen([sys.executable, str(namesake)], env=base),
    }
    daemons = {}
    try:
        for run in ("run-a", "run-b"):
            out = subprocess.run([sys.executable, "-c", DAEMON], capture_output=True, text=True,
                                 env=dict(base, **{chip_smoke.RUN_ENV: run}), timeout=30)
            daemons[run] = int(out.stdout.strip())
        time.sleep(0.2)
        found = set(chip_smoke.stray_processes())
        assert procs["ours"].pid in found and daemons["run-a"] in found
        assert not {procs["other_run"].pid, procs["namesake"].pid, daemons["run-b"],
                    os.getpid()} & found
        monkeypatch.delenv(chip_smoke.RUN_ENV)
        assert chip_smoke.stray_processes() == []  # an unstamped run owns nothing
    finally:
        for p in procs.values():
            p.kill()
            p.wait(timeout=10)
        for pid in daemons.values():
            try:
                os.kill(pid, 9)
            except ProcessLookupError:
                pass
