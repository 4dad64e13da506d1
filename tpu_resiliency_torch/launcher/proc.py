"""Worker process group: spawn, poll, redirect, stop.

The lean re-design of the reference's vendored torchelastic multiprocessing layer
(``_torch_elastic_compat/multiprocessing/api.py`` ``start_processes``/``PContext``,
std redirection/tee, ~2000 LoC): one ``subprocess.Popen`` per rank with per-rank
log files and error files, a non-blocking group poll, and graceful→forceful stop.
No fork-server indirection — CUDA workers are always fresh interpreters (a forked CUDA
runtime is unusable anyway), so plain exec is both simpler and correct. The
spawn+import tax that exec'ing fresh interpreters costs on *restart* rounds is
removed by ``park.WarmSparePool`` (pre-imported parked interpreters, promoted
by ``start`` when available) rather than by forking.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import signal
import subprocess
import sys
import threading
import time
from typing import IO, Optional

from tpu_resiliency_torch.launcher.errors import ERROR_FILE_ENV, WorkerError
from tpu_resiliency_torch.utils.events import record as record_event
from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)


def signal_tree(pid: int, sig: int) -> None:
    """Signal a session-leader's whole process group, falling back to the
    single pid if the group is already gone. Shared by worker stop and
    warm-spare teardown (both spawn session leaders)."""
    try:
        os.killpg(pid, sig)
    except (ProcessLookupError, PermissionError, OSError):
        try:
            os.kill(pid, sig)
        except (ProcessLookupError, PermissionError):
            pass


class GroupState(enum.Enum):
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"


@dataclasses.dataclass
class Worker:
    local_rank: int
    global_rank: int
    proc: subprocess.Popen
    error_file: str
    log_dir: Optional[str] = None
    _stdout: Optional[IO] = None
    _stderr: Optional[IO] = None

    @property
    def pid(self) -> int:
        return self.proc.pid

    @property
    def exitcode(self) -> Optional[int]:
        return self.proc.poll()

    def error(self) -> Optional[WorkerError]:
        return WorkerError.from_file(self.error_file)


@dataclasses.dataclass
class WorkerFailure:
    local_rank: int
    global_rank: int
    exitcode: int
    error: Optional[WorkerError]

    def describe(self) -> str:
        base = f"rank {self.global_rank} (local {self.local_rank}) exit {self.exitcode}"
        if self.error is not None:
            base += f": {self.error.exception_type}: {self.error.message}"
        return base


class WorkerGroup:
    """One round's local workers. Start → poll → (stop | reap)."""

    def __init__(
        self,
        argv: list[str],
        nproc: int,
        base_env: dict[str, str],
        run_dir: str,
        log_dir: Optional[str] = None,
        use_python: bool = True,
        spare_pool=None,
    ):
        self.argv = argv
        self.nproc = nproc
        self.base_env = base_env
        self.run_dir = run_dir
        self.log_dir = log_dir
        self.use_python = use_python
        #: optional launcher-owned ``park.WarmSparePool``: ranks are served by
        #: promoting parked pre-imported interpreters when one is warm,
        #: removing the measured multi-second spawn+import tax from restart
        #: rounds; cold spawn remains the fallback per rank.
        self.spare_pool = spare_pool if use_python else None
        self.workers: list[Worker] = []
        #: optional callable local_rank -> extra env (e.g. the per-rank monitor socket)
        self.per_rank_env = None
        #: set by a per-worker reaper thread the instant ANY worker exits, so
        #: the supervise loop wakes immediately instead of discovering the exit
        #: at its next poll tick — this takes the detection segment of
        #: BENCH_restart's respawn decomposition from O(monitor_interval) to ~ms.
        self._change = threading.Event()

    def start(self, round_no: int, first_global_rank: int, world_size: int) -> None:
        if self.workers:
            raise RuntimeError("worker group already started")
        os.makedirs(self.run_dir, exist_ok=True)
        cmd = ([sys.executable] if self.use_python else []) + self.argv
        for local in range(self.nproc):
            grank = first_global_rank + local
            env = dict(os.environ)
            env.update(self.base_env)
            if self.per_rank_env is not None:
                env.update(self.per_rank_env(local))
            error_file = os.path.join(self.run_dir, f"err_r{round_no}_rank{grank}.json")
            if os.path.exists(error_file):
                os.unlink(error_file)
            env.update(
                {
                    "RANK": str(grank),
                    "LOCAL_RANK": str(local),
                    "WORLD_SIZE": str(world_size),
                    "LOCAL_WORLD_SIZE": str(self.nproc),
                    "TPU_FT_RESTART_COUNT": str(round_no),
                    ERROR_FILE_ENV: error_file,
                }
            )
            stdout = stderr = None
            stdout_path = stderr_path = None
            wlog_dir = None
            if self.log_dir:
                wlog_dir = os.path.join(self.log_dir, f"round_{round_no}", f"rank_{grank}")
                os.makedirs(wlog_dir, exist_ok=True)
                stdout_path = os.path.join(wlog_dir, "stdout.log")
                stderr_path = os.path.join(wlog_dir, "stderr.log")
            spare = self.spare_pool.acquire() if self.spare_pool is not None else None
            proc = None
            if spare is not None:
                # Promote a parked pre-imported interpreter: it applies env and
                # redirection itself (dup2 on the given paths) and runs the
                # script as __main__ — no spawn, no import bill. The pool
                # handed us its deepest-warmed spare; replacements are spawned
                # AFTER the round is up (see the replenish thread below), so
                # nothing here ever blocks on a Popen.
                try:
                    depth = spare.park_depth
                    proc = spare.unpark(
                        self.argv, env, stdout=stdout_path, stderr=stderr_path
                    )
                    log.info(
                        f"rank {grank}: promoted warm spare pid {proc.pid} "
                        f"(park depth {depth})"
                    )
                    # worker_pid, not pid: 'pid' is the Event's own identity
                    # field (the recording process — this launcher).
                    record_event(
                        "launcher", "worker_promoted", round=round_no,
                        global_rank=grank, worker_pid=proc.pid,
                        outcome="promoted", park_depth=depth,
                    )
                except OSError:
                    # The spare died between acquire() and the pipe write
                    # (EPIPE); fall through to a cold spawn.
                    spare.kill()
                    log.warning(f"rank {grank}: warm spare died at promotion; cold spawn")
                    record_event(
                        "launcher", "worker_promoted", round=round_no,
                        global_rank=grank, outcome="dead_at_promotion",
                    )
            elif self.spare_pool is not None and self.spare_pool.size > 0:
                # A pool exists but had nothing warm to give: the cold spawn
                # below is a fallback worth counting (it IS the latency the
                # pool exists to remove).
                record_event(
                    "launcher", "worker_promoted", round=round_no,
                    global_rank=grank, outcome="cold_fallback",
                )
            if proc is None:
                if stdout_path is not None:
                    stdout = open(stdout_path, "ab")
                    stderr = open(stderr_path, "ab")
                # Each worker leads its own session/process group so stop() can
                # signal the whole tree — a worker's own subprocesses
                # (dataloaders, shell wrappers) must not outlive it into the
                # next restart round.
                proc = subprocess.Popen(
                    cmd,
                    env=env,
                    stdout=stdout,
                    stderr=stderr,
                    start_new_session=True,
                )
            self.workers.append(
                Worker(
                    local_rank=local,
                    global_rank=grank,
                    proc=proc,
                    error_file=error_file,
                    log_dir=wlog_dir,
                    _stdout=stdout,
                    _stderr=stderr,
                )
            )
        for w in self.workers:
            threading.Thread(
                target=self._reap_and_signal, args=(w.proc,), daemon=True
            ).start()
        if self.spare_pool is not None:
            # Top the pool back up OFF the promotion critical path: the round's
            # workers are already running; replacement Popen cost lands on a
            # background thread, not on restart latency.
            threading.Thread(
                target=self._replenish_pool, daemon=True,
                name="spare-replenish",
            ).start()
        log.info(
            f"started {self.nproc} workers (global ranks "
            f"{first_global_rank}..{first_global_rank + self.nproc - 1} of {world_size})"
        )

    def _replenish_pool(self) -> None:
        try:
            self.spare_pool.replenish()
        except Exception:
            log.exception("warm-spare pool replenish failed")

    def _reap_and_signal(self, proc: subprocess.Popen) -> None:
        try:
            proc.wait()
        except Exception:
            pass
        self._change.set()

    def wait_change(self, timeout: float) -> bool:
        """Block up to ``timeout`` for any worker exit since the last call;
        True if one happened. The event is only a wakeup accelerator — state
        truth is always re-read via :meth:`poll` — so the clear-after-wake
        race (a second exit landing between wake and clear) is harmless: the
        caller's poll sees every exit code regardless."""
        if self._change.wait(timeout):
            self._change.clear()
            return True
        return False

    def notify_change(self) -> None:
        """External wake for :meth:`wait_change` — e.g. the agent's restart-key
        watcher folding store events into the same supervise wakeup."""
        self._change.set()

    def poll(self) -> GroupState:
        codes = [w.exitcode for w in self.workers]
        if any(c not in (0, None) for c in codes):
            return GroupState.FAILED
        if all(c == 0 for c in codes):
            return GroupState.SUCCEEDED
        return GroupState.RUNNING

    def failures(self) -> list[WorkerFailure]:
        return [
            WorkerFailure(
                local_rank=w.local_rank,
                global_rank=w.global_rank,
                exitcode=w.exitcode,
                error=w.error(),
            )
            for w in self.workers
            if w.exitcode not in (0, None)
        ]

    def exitcodes(self) -> dict[int, Optional[int]]:
        return {w.global_rank: w.exitcode for w in self.workers}

    @staticmethod
    def _signal_tree(pid: int, sig: int) -> None:
        signal_tree(pid, sig)

    def stop(self, grace: float = 15.0, sig: int = int(signal.SIGTERM)) -> None:
        """Graceful stop: `sig` (after SIGCONT, in case a worker is stopped), then
        SIGKILL leftovers after `grace` (reference ``_shutdown_rank`` escalation,
        ``rank_monitor_server.py:176``)."""
        for w in self.workers:
            if w.exitcode is None:
                self._signal_tree(w.pid, signal.SIGCONT)
                self._signal_tree(w.pid, sig)
        deadline = time.monotonic() + grace
        while time.monotonic() < deadline:
            if all(w.exitcode is not None for w in self.workers):
                break
            # The reaper threads set _change the instant any worker exits, so
            # this wait returns in ~ms once the last one dies — teardown is on
            # the restart critical path and must not poll it away in 100 ms
            # ticks. Clear first (the exit that triggered this stop already
            # set it); an exit racing the clear is caught by the timeout
            # re-check. State truth stays with the poll above.
            self._change.clear()
            self._change.wait(0.02)
        for w in self.workers:
            if w.exitcode is None:
                log.warning(f"worker rank {w.global_rank} ignored signal; SIGKILL")
                # The top rung of the kill ladder — pairs with the monitor's
                # per-signal ``kill_ladder`` records so the stream shows which
                # step actually ended a wedged rank.
                record_event(
                    "launcher", "kill_ladder", step="SIGKILL",
                    global_rank=w.global_rank, worker_pid=w.pid,
                    grace_s=grace,
                )
                self._signal_tree(w.pid, signal.SIGKILL)
            else:
                # Reap stragglers the dead leader left behind in its group.
                self._signal_tree(w.pid, signal.SIGKILL)
        for w in self.workers:
            try:
                w.proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                log.error(f"worker pid {w.pid} unreapable")
        self._close_logs()

    def reap(self) -> None:
        for w in self.workers:
            if w.exitcode is None:
                w.proc.wait()
        self._close_logs()

    def _close_logs(self) -> None:
        for w in self.workers:
            for f in (w._stdout, w._stderr):
                if f is not None:
                    try:
                        f.close()
                    except OSError:
                        pass
            w._stdout = w._stderr = None
