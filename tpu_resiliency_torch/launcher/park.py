"""Warm spare workers: pre-paid interpreter+import cost for restart rounds.

A copy of ``tpu_resiliency/launcher/park.py`` whose spares preload ``torch`` and
whose runtime warmup is the port's ``platform/device.py:warm_runtime``, which
creates no CUDA context. The in-job respawn tax is process spawn + interpreter
startup + imports, and the reference pays it on every restart round (its
``start_processes`` spawn path, ``_torch_elastic_compat/multiprocessing/api.py``) —
this module removes it:

- A :class:`WarmSparePool` keeps N **parked interpreters** that have already
  imported the expensive modules (``torch`` by default) but have NOT initialized
  any device-owning backend — parking happens strictly before rank assignment,
  rendezvous, or device use, so a promoted spare is indistinguishable from a
  fresh interpreter to the workload.
- An optional **runtime warmup phase** (``--warm-spare-warmup runtime``) goes
  one park level deeper: after the imports, the shim runs a platform-safe
  warmup (``platform/device.py:warm_runtime``) — the port's packages imported,
  its built kernel libraries opened, one CPU operation run — and never a CUDA
  context, which would hold card memory beside the dying worker's and block on
  a hung card. Device-grabbing stays strictly post-promotion. The achieved
  **park depth** (1 = imports, 2 = runtime-warm) is reported in the ready file
  so promotion can prefer the deepest-warmed spare.
- On a restart round, ``WorkerGroup.start`` *promotes* a warm spare instead of
  paying the spawn: the per-round spec (argv, env, log paths) is written down
  an inherited pipe, and the shim in this module applies it and runs the user
  script as ``__main__``.

The pipe is also the lifetime tether: a parked shim blocks in ``readline`` (no
polling, zero CPU while parked) and EOF — the launcher exiting or crashing at
ANY point, including while the spare is still importing — unparks it straight
into a clean exit. No leaked interpreters, no ppid watching.

No fork anywhere: each spare is a fresh ``exec``'d interpreter (a forked CUDA
runtime is unusable), merely one that did its imports early.

Promotion parity contract: the shim REPLACES ``os.environ`` with the round env
(matching ``Popen(env=...)`` semantics of the cold path), points ``sys.argv``
and ``sys.path[0]`` at the script exactly as ``python script.py`` would (for
``-m`` workers ``sys.path[0]`` stays the working directory, as
``python -m`` does), and splices round-env ``PYTHONPATH`` entries that were
not present at park time into ``sys.path``. The warmup phase is bound by the
same contract: it must not mutate ``os.environ`` or ``sys.path``, and a
warmup that raises kills the spare *before* its ready file exists, so the
pool counts it as a startup death (doomed warmups disable the pool instead of
respawning forever). One caveat remains by design: an env var that a
*preloaded* module reads at import time must already be present in the
launcher's environment (CUDA reads ``CUDA_VISIBLE_DEVICES`` at its first call,
after promotion, so card selection is not such a variable).

Pool discipline (the restart hot path): ``acquire()`` only *selects* — it
reaps the dead, prefers the deepest-warmed spare, and never spawns. Top-up is
``replenish()``, which ``WorkerGroup.start`` runs on a background thread
*after* the round's workers are up, so promotion latency never includes a
replacement ``Popen``.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
from typing import Optional

from tpu_resiliency_torch.utils.events import record as record_event
from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)

#: exported into a promoted spare's env so workloads/tests can observe promotion
PROMOTED_ENV = "TPU_FT_WARM_SPARE"
#: the promoted spare's park depth (1 = imports, 2 = runtime-warm)
PROMOTED_DEPTH_ENV = "TPU_FT_WARM_SPARE_DEPTH"

#: ``--warm-spare-warmup`` value meaning "imports only, no warmup phase"
WARMUP_IMPORTS = "imports"
#: alias for the built-in platform-safe runtime warmup
WARMUP_RUNTIME = "runtime"
_WARMUP_RUNTIME_SPEC = "tpu_resiliency_torch.platform.device:warm_runtime"


# ------------------------------------------------------------------ the shim --


def _run_warmup(spec: str) -> None:
    """Resolve and run the warmup callable (``module:function``; ``runtime``
    aliases the built-in platform-safe warmup). Any failure propagates: the
    shim dies before writing its ready file, which the pool counts as a
    startup death rather than promoting a half-warm interpreter."""
    if spec == WARMUP_RUNTIME:
        spec = _WARMUP_RUNTIME_SPEC
    mod_name, _, fn_name = spec.partition(":")
    import importlib

    fn = getattr(importlib.import_module(mod_name), fn_name or "warm_runtime")
    fn()


def _apply_spec_and_run(spec: dict) -> None:
    # Replace — not merge — the environment: a var the launcher dropped since
    # the spare was parked must not survive into the worker (cold workers get
    # Popen(env=...) replacement semantics; promoted workers must match).
    os.environ.clear()
    os.environ.update(spec.get("env", {}))
    for stream_name, fd in (("stdout", 1), ("stderr", 2)):
        path = spec.get(stream_name)
        if path:
            f = open(path, "ab")
            os.dup2(f.fileno(), fd)

    argv = spec["argv"]
    module_mode = bool(argv) and argv[0] == "-m"
    if not module_mode:
        # `python script.py`: sys.path[0] is the script's directory, REPLACING
        # the -m working-directory entry this interpreter booted with. Done
        # BEFORE the PYTHONPATH splice so a round entry equal to the launcher
        # cwd isn't wrongly deduped against that about-to-vanish slot.
        sys.path[0] = os.path.dirname(os.path.abspath(argv[0]))
    # Round-env PYTHONPATH entries the parked interpreter never saw: splice
    # them in where the cold interpreter would have put them (right after the
    # argv[0] slot, ahead of site-packages).
    for p in reversed(
        [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    ):
        if p not in sys.path:
            sys.path.insert(1, p)

    if module_mode:
        import runpy

        # `python -m mod`: sys.path[0] is the working directory — which is
        # exactly what this shim (itself launched via -m) already has there.
        sys.argv = [argv[1]] + argv[2:]
        runpy.run_module(argv[1], run_name="__main__", alter_sys=True)
    else:
        import types

        # Execute the script in a module REGISTERED as __main__ (runpy.run_path
        # runs in a throwaway namespace): pickling of script-level classes and
        # multiprocessing-spawn children resolve __main__ to the user's script,
        # exactly as under `python script.py`.
        script = argv[0]
        sys.argv = list(argv)
        mod = types.ModuleType("__main__")
        mod.__file__ = script
        mod.__dict__["__builtins__"] = __builtins__
        sys.modules["__main__"] = mod
        with open(script, "rb") as f:
            code = compile(f.read(), script, "exec")
        exec(code, mod.__dict__)


def _serve_parked(go_fd: int, ready_file: str, preload: str, warmup: str) -> None:
    """Import the expensive modules, run the optional warmup phase, announce
    readiness (with the achieved park depth), then block on the launcher's
    pipe until a round spec arrives (or EOF: launcher gone)."""
    for mod in filter(None, preload.split(",")):
        __import__(mod)
    depth = 1
    if warmup and warmup != WARMUP_IMPORTS:
        _run_warmup(warmup)
        depth = 2
    tmp = ready_file + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"pid": os.getpid(), "depth": depth}, f)
    os.replace(tmp, ready_file)

    with os.fdopen(go_fd, "r") as go:
        line = go.readline()  # blocks; zero CPU while parked
    if not line.strip():
        sys.exit(0)  # EOF/blank: the launcher is gone or released us
    _apply_spec_and_run(json.loads(line))


def main(argv: Optional[list[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="parked warm-spare worker shim")
    ap.add_argument("--go-fd", type=int, required=True)
    ap.add_argument("--ready-file", required=True)
    ap.add_argument("--preload", default="torch")
    ap.add_argument("--warmup", default=WARMUP_IMPORTS)
    args = ap.parse_args(argv)
    _serve_parked(args.go_fd, args.ready_file, args.preload, args.warmup)
    return 0


# ------------------------------------------------------------------ the pool --


class ParkedSpare:
    """One parked interpreter. ``warm`` once its preloads finished; ``unpark``
    hands it the round spec and it becomes a regular worker process."""

    def __init__(self, proc: subprocess.Popen, go_wfd: int, ready_file: str):
        self.proc = proc
        self._go_wfd: Optional[int] = go_wfd
        self.ready_file = ready_file

    @property
    def warm(self) -> bool:
        return self.proc.poll() is None and os.path.exists(self.ready_file)

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None

    @property
    def park_depth(self) -> int:
        """The ready file's reported depth: 0 not warm, 1 imports, 2 runtime.
        A legacy plain-pid ready file reads as depth 1."""
        if not self.warm:
            return 0
        try:
            with open(self.ready_file) as f:
                body = f.read().strip()
            if body.startswith("{"):
                return int(json.loads(body).get("depth", 1))
            return 1
        except (OSError, ValueError):
            return 1

    def unpark(
        self,
        argv: list[str],
        env: dict[str, str],
        stdout: Optional[str] = None,
        stderr: Optional[str] = None,
    ) -> subprocess.Popen:
        env = dict(env)
        env[PROMOTED_ENV] = "1"
        env[PROMOTED_DEPTH_ENV] = str(self.park_depth)
        spec = {"argv": list(argv), "env": env, "stdout": stdout, "stderr": stderr}
        payload = memoryview((json.dumps(spec) + "\n").encode())
        while payload:
            n = os.write(self._go_wfd, payload)
            payload = payload[n:]
        os.close(self._go_wfd)
        self._go_wfd = None
        self._cleanup_files()
        return self.proc

    def _cleanup_files(self) -> None:
        try:
            os.unlink(self.ready_file)
        except OSError:
            pass

    def kill(self, grace: float = 2.0) -> None:
        """Release (EOF → clean exit) with a SIGKILL backstop, and reap."""
        if self._go_wfd is not None:
            try:
                os.close(self._go_wfd)
            except OSError:
                pass
            self._go_wfd = None
        try:
            self.proc.wait(timeout=grace if self.proc.poll() is None else 0.1)
        except subprocess.TimeoutExpired:
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError, OSError):
                try:
                    self.proc.kill()
                except (ProcessLookupError, PermissionError):
                    pass
            try:
                self.proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                log.error(f"parked spare pid {self.proc.pid} unreapable")
        self._cleanup_files()


def spawn_spare(
    run_dir: str, spare_id: int, preload: str = "torch",
    warmup: str = WARMUP_IMPORTS,
) -> ParkedSpare:
    """Spawn one parked shim; the returned spare's pipe write-end is the only
    handle the launcher needs (spec on promote, close on release)."""
    os.makedirs(run_dir, exist_ok=True)
    ready = os.path.join(run_dir, f"ready_{spare_id}")
    try:
        os.unlink(ready)
    except OSError:
        pass
    rfd, wfd = os.pipe()
    try:
        proc = subprocess.Popen(
            [
                sys.executable,
                "-m",
                "tpu_resiliency_torch.launcher.park",
                "--go-fd",
                str(rfd),
                "--ready-file",
                ready,
                "--preload",
                preload,
                "--warmup",
                warmup,
            ],
            env=dict(os.environ),
            start_new_session=True,
            pass_fds=(rfd,),
        )
    except BaseException:
        os.close(wfd)
        raise
    finally:
        os.close(rfd)
    return ParkedSpare(proc, wfd, ready)


class WarmSparePool:
    """Keeps ``size`` parked interpreters ready.

    Spawning a spare is a non-blocking ``Popen`` (~ms for the parent); the
    spare pays its import bill in the background while the current round runs,
    so by the time a restart needs it the interpreter floor is already paid.

    ``acquire()`` is promotion-hot-path-safe: it only reaps and selects
    (deepest park depth first) — it NEVER spawns. Call :meth:`replenish`
    off the critical path (``WorkerGroup.start`` does, on a background
    thread after the round's workers are up) to top the pool back up.
    """

    def __init__(
        self, size: int, run_dir: str, preload: str = "torch",
        warmup: str = WARMUP_IMPORTS,
    ):
        self.size = size
        self.run_dir = os.path.join(run_dir, "spares")
        self.preload = preload
        self.warmup = warmup
        self._spares: list[ParkedSpare] = []
        self._next_id = 0
        self._lock = threading.Lock()
        self._startup_deaths = 0  # consecutive died-before-warm spares
        self.replenish()

    def _spawn_locked(self) -> None:
        sid = self._next_id
        self._next_id += 1
        self._spares.append(
            spawn_spare(self.run_dir, sid, self.preload, self.warmup)
        )

    def _reap_locked(self) -> None:
        """Drop dead spares; track consecutive startup deaths so a doomed
        preload/warmup (e.g. a typo'd module) disables the pool with a
        diagnostic instead of respawning dying interpreters on every round
        forever. The tracebacks went to the launcher's stderr."""
        live: list[ParkedSpare] = []
        for s in self._spares:
            if s.alive:
                live.append(s)
                continue
            died_cold = not os.path.exists(s.ready_file) and s.proc.poll() != 0
            self._startup_deaths = self._startup_deaths + 1 if died_cold else 0
            s.kill()  # reap the zombie + remove its ready file
        self._spares = live
        if self.size > 0 and self._startup_deaths >= 2 * self.size:
            log.error(
                f"warm-spare pool disabled: {self._startup_deaths} spares died "
                f"during startup (bad --warm-spare-preload={self.preload!r} or "
                f"--warm-spare-warmup={self.warmup!r}? see the launcher's "
                "stderr for their tracebacks); restart rounds will cold-spawn"
            )
            self.size = 0

    def _record_state_locked(self) -> None:
        # The pool gauge (tpu_warm_spares_warm) rides the event stream like
        # every other metric: one record per state change, not a poller.
        record_event(
            "launcher", "warm_spare_pool",
            size=self.size, parked=len(self._spares),
            warm=sum(1 for s in self._spares if s.warm),
        )

    def acquire(self) -> Optional[ParkedSpare]:
        """The deepest-warmed spare (removed from the pool), or None — callers
        fall back to a cold spawn, so a dead/cold pool degrades to exactly the
        poolless behavior. Selection only: replacements are spawned by
        :meth:`replenish`, never here — promotion must not block on a
        ``Popen``."""
        with self._lock:
            self._reap_locked()
            best_i, best_depth = -1, 0
            for i, spare in enumerate(self._spares):
                depth = spare.park_depth
                if depth > best_depth:
                    best_i, best_depth = i, depth
            found = self._spares.pop(best_i) if best_i >= 0 else None
            self._record_state_locked()
            return found

    def replenish(self) -> int:
        """Reap the dead and spawn spares until the pool is back at ``size``;
        returns how many were spawned. Safe to call from a background thread
        (WorkerGroup.start does, after the round's workers are up)."""
        with self._lock:
            self._reap_locked()
            spawned = 0
            while len(self._spares) < self.size:
                self._spawn_locked()
                spawned += 1
            if spawned:
                self._record_state_locked()
            return spawned

    @property
    def warm_count(self) -> int:
        with self._lock:
            return sum(1 for s in self._spares if s.warm)

    def stats(self) -> dict:
        """Pool state for /healthz: size, parked, warm, deepest park depth."""
        with self._lock:
            depths = [s.park_depth for s in self._spares]
            return {
                "size": self.size,
                "parked": len(self._spares),
                "warm": sum(1 for d in depths if d > 0),
                "deepest": max(depths, default=0),
            }

    def close(self) -> None:
        with self._lock:
            for s in self._spares:
                s.kill()
            self._spares = []


if __name__ == "__main__":
    sys.exit(main())
