"""``chip_smoke.py`` reaps only the processes its own run started: those whose
environment holds the run's stamp (``RUN_ENV``), the Wrapper's double-forked monitor
daemons included, and never another run's or a process that merely runs a file of
the same name; and it counts a process as holding the card only while the process
still has its address space.
"""

import os
import subprocess
import sys
import time

import pytest

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


# Spawns a child, which starts multiprocessing's resource tracker beside it, and
# reports both as ``stray_processes`` sees them.
TRACKER = """
import json, multiprocessing as mp, time
from pathlib import Path
import chip_smoke
p = mp.get_context("spawn").Process(target=time.sleep, args=(30,))
p.start()
trackers = [int(e.name) for e in Path("/proc").iterdir()
            if e.name.isdigit() and chip_smoke.own_resource_tracker(e)]
found = chip_smoke.stray_processes()
p.kill()
p.join()
print(json.dumps({"child": p.pid, "trackers": trackers, "found": found}))
"""


def test_the_runs_own_resource_tracker_is_no_stray():
    """A spawned child is a stray while it lives; the resource tracker its parent
    started for it is not: it exits with the parent."""
    import json
    from pathlib import Path

    repo = str(Path(chip_smoke.__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=repo, **{chip_smoke.RUN_ENV: "run-c"})
    out = subprocess.run([sys.executable, "-c", TRACKER], capture_output=True, text=True,
                         env=env, cwd=repo, timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert len(got["trackers"]) == 1 and got["child"] in got["found"]
    assert not set(got["trackers"]) & set(got["found"])


@pytest.mark.parametrize("files, cmdline, held", [
    (["/dev/nvidia0", "/dev/nvidiactl"], b"python\0-m\0worker\0", True),
    # On its way out: the address space is gone (an empty command line) before the
    # files close, as the Wrapper monitor's first fork is when it exits.
    (["/dev/nvidia0", "/dev/nvidiactl"], b"", False),
    (["/dev/nvidiactl", "/dev/nvidia-uvm"], b"python\0", False),  # no card's file
    (None, None, False),  # already reaped
], ids=["context", "exiting", "control-files-only", "gone"])
def test_holds_card_needs_a_card_file_and_an_address_space(tmp_path, files, cmdline, held):
    pid = 4242
    if files is not None:
        fd = tmp_path / str(pid) / "fd"
        fd.mkdir(parents=True)
        for n, target in enumerate(files):
            (fd / str(n + 3)).symlink_to(target)
        (tmp_path / str(pid) / "cmdline").write_bytes(cmdline)
    assert chip_smoke.holds_card(pid, proc=tmp_path) is held
