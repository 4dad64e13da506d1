"""Progress watchdog: automatic proof that the main thread is alive and scheduling.

Analogue of reference ``inprocess/progress_watchdog.py:47-195``. The key trick is
identical because it is a CPython property, not a device one: a side thread schedules a
trampoline onto the **main thread** via ``Py_AddPendingCall``; the trampoline can only
run if the main thread is executing Python bytecode with a responsive eval loop. If the
main thread is wedged — C extension deadlock, GIL held forever, runaway native call —
pending calls never execute, timestamps stop, and the monitor process escalates
soft → hard timeout. ``ping()`` is the manual variant for marking forward progress
explicitly from the train loop.

Timestamps are *reported*, not stored: each observed heartbeat is pushed over the
monitor-process socket (``MonitorLink``), so the watcher works even when this process
subsequently dies.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Callable, Optional

from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)

# The pure-C pending-call trampoline (the reference's ``native/probe.c``) is not
# ported yet: the port keeps the ctypes pending-call path only, the reference's own
# path when its extension is not built.

_PENDING_CALLBACK_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)


class ProgressWatchdog:
    """Daemon thread that emits a timestamp whenever the main thread proves alive.

    ``report(kind, timestamp)`` is called from this watchdog thread with
    ``kind="auto"`` (pending-call round-trip completed) or ``kind="manual"``
    (user ping). Pause/resume fences the automatic probing during restart
    coordination (reference ``progress_watchdog.py:47-195`` pause protocol).
    """

    def __init__(
        self,
        interval: float,
        report: Callable[[str, float], None],
        use_native: bool | None = None,
    ):
        self.interval = interval
        self.report = report
        self.native = False
        if use_native:
            raise RuntimeError("the native probe is not ported; use_native must be falsy")
        self._executed = threading.Event()
        self._paused = threading.Event()
        self._shutdown = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Keep a reference: the C callback must outlive every scheduled pending call.
        self._c_callback = _PENDING_CALLBACK_T(self._trampoline)

    def _trampoline(self, _arg) -> int:
        # Runs ON THE MAIN THREAD inside the eval loop (ctypes fallback path only).
        # An async-injected RankShouldRestart can be delivered inside this frame;
        # swallowing it here would eat the restart signal, so re-arm it for delivery
        # at the next bytecode boundary outside the callback.
        try:
            self._executed.set()
        except BaseException as e:  # noqa: BLE001 - deliberate async-exc shield
            try:
                ctypes.pythonapi.PyThreadState_SetAsyncExc(
                    ctypes.c_ulong(threading.main_thread().ident), ctypes.py_object(type(e))
                )
            except Exception:
                pass
        return 0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="progress-watchdog", daemon=True
        )
        self._thread.start()

    def shutdown(self, timeout: float = 5.0) -> None:
        self._shutdown.set()
        if self._thread is not None:
            self._thread.join(timeout)

    def pause(self) -> None:
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()

    def ping(self) -> None:
        """Manual progress mark (callable from any thread)."""
        try:
            self.report("manual", time.monotonic())
        except Exception:
            log.warning("progress ping failed", exc_info=True)

    # -- probe loop --------------------------------------------------------

    def _loop(self) -> None:
        while not self._shutdown.is_set():
            if self._paused.is_set():
                self._shutdown.wait(self.interval)
                continue
            if self._probe_round_trip():
                try:
                    self.report("auto", time.monotonic())
                except Exception:
                    log.warning("progress report failed", exc_info=True)
                # Pace the probes.
                self._shutdown.wait(self.interval)
            # else: main thread did not schedule within interval — no timestamp.

    def _probe_round_trip(self) -> bool:
        """Schedule one main-thread probe and wait up to `interval` for it to run."""
        self._executed.clear()
        rc = ctypes.pythonapi.Py_AddPendingCall(self._c_callback, None)
        if rc != 0:
            # Pending-call queue full; try again next round.
            self._shutdown.wait(self.interval)
            return False
        return self._executed.wait(self.interval)
