"""In-rank monitor thread: turns a store interruption flag into an async exception.

Analogue of reference ``inprocess/monitor_thread.py:155-184``: a per-iteration daemon
thread blocks on the iteration's ``interrupted`` flag; when any rank records an
interruption, it runs the abort chain (under the atomic lock, so user-designated
critical sections are never torn), then repeatedly injects :class:`RankShouldRestart`
into the main thread via ``PyThreadState_SetAsyncExc`` until the restart loop
acknowledges — the CPython trick is identical to the reference's because it is a
property of the interpreter, not the device (``monitor_thread.py:56-105``).

Raise/acknowledge protocol: the thread only injects while ``armed`` (main is inside the
wrapped fn). The main handler calls ``acknowledge()``, which disarms and waits for the
quiesce event, then drains any already-pending injection with short interruptible
sleeps — closing the unavoidable window between "injection scheduled" and "injection
delivered".
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Callable, Optional

from tpu_resiliency_torch.exceptions import InternalError
from tpu_resiliency_torch.inprocess.coordination import RestartCoordinator
from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)


class RankShouldRestart(BaseException):
    """Injected into the main thread to unwind the wrapped fn. BaseException so user
    ``except Exception`` blocks cannot swallow it (reference ``monitor_thread.py:32``)."""


def async_raise(thread_id: int, exc_type: type[BaseException]) -> None:
    """Schedule ``exc_type`` in the thread with ``thread_id`` (reference ``:56``)."""
    res = ctypes.pythonapi.PyThreadState_SetAsyncExc(
        ctypes.c_ulong(thread_id), ctypes.py_object(exc_type)
    )
    if res == 0:
        raise InternalError(f"no thread with id {thread_id}")
    if res > 1:
        # Undo: we hit more than one thread state (should not happen).
        ctypes.pythonapi.PyThreadState_SetAsyncExc(ctypes.c_ulong(thread_id), None)
        raise InternalError("PyThreadState_SetAsyncExc affected multiple threads")


class MonitorThread:
    """Watches one iteration's interruption flag; aborts and unwinds the main thread."""

    def __init__(
        self,
        coord: RestartCoordinator,
        iteration: int,
        main_thread_id: int,
        atomic_lock: threading.RLock,
        abort_fn: Optional[Callable[[], None]] = None,
        interval: float = 1.0,
        last_call_wait: float = 0.0,
    ):
        self.coord = coord
        self.iteration = iteration
        self.main_thread_id = main_thread_id
        self.atomic_lock = atomic_lock
        self.abort_fn = abort_fn
        self.interval = interval
        self.last_call_wait = last_call_wait

        self._armed = threading.Event()
        self._ack = threading.Event()
        self._quiesced = threading.Event()
        self._shutdown = threading.Event()
        self._fired = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"inprocess-monitor-{iteration}", daemon=True
        )

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._thread.start()

    def arm(self) -> None:
        """Main is entering the wrapped fn: injections allowed."""
        self._armed.set()

    def disarm(self) -> None:
        self._armed.clear()

    @property
    def fired(self) -> bool:
        return self._fired.is_set()

    def acknowledge(self, drain: bool = True) -> None:
        """Main has taken the restart path: stop injecting, then drain stragglers.

        Every step is retried through a late delivery: an injection scheduled just
        before ``_armed`` cleared can land at any bytecode boundary in here, and a
        delivery that surfaces while a C call is returning can be mangled into
        ``SystemError("error return without exception set")`` — the CPython hazard the
        reference guards with its ``sys.unraisablehook`` re-raise
        (``nvidia_resiliency_ext/inprocess/monitor_thread.py:87-105``).
        After this returns, no injection is scheduled, pending, or deliverable: the
        caller's subsequent store/barrier work cannot be torn.
        """
        quiesced = False
        clean = 0
        attempts = 0
        while True:
            # One covered region for the whole body: a delivery at ANY internal
            # boundary (loop checks, assignments, the except body itself) lands
            # back in this try on the next pass. The irreducible escape window is
            # the few handler-entry bytecodes between a delivery and re-entering
            # the try — unavoidable in pure CPython, and orders of magnitude
            # smaller than one store round-trip.
            try:
                self._armed.clear()
                self._ack.set()
                if not quiesced:
                    # Monitor loop exits on ack; after the quiesce event no new
                    # injection can be scheduled.
                    self._quiesced.wait(timeout=10.0)
                    quiesced = True
                if not drain or not self._fired.is_set():
                    # Never fired ⇒ async_raise was never called ⇒ nothing can be
                    # pending: the common local-exception restart skips the drain.
                    return
                # At most one injection can still be pending (scheduled before
                # _armed cleared, not yet delivered). Async exceptions deliver at
                # the next eval-loop boundary, so require a streak of clean sleeps
                # before declaring the thread drained.
                while clean < 3 and attempts < 400:
                    attempts += 1
                    time.sleep(0.005)
                    clean += 1
                return
            except (RankShouldRestart, SystemError):
                clean = 0
                continue

    def shutdown(self, timeout: float = 10.0) -> None:
        self._ack.set()
        self._shutdown.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise InternalError("monitor thread did not shut down")

    # -- body --------------------------------------------------------------

    def _run(self) -> None:
        from tpu_resiliency_torch.exceptions import StoreError

        try:
            while not self._shutdown.is_set() and not self._ack.is_set():
                try:
                    fired = self.coord.wait_interrupted(self.iteration, timeout=self.interval)
                except StoreError:
                    return  # store gone: the job is shutting down
                if fired:
                    self._interrupt()
                    return
        finally:
            self._quiesced.set()

    def _interrupt(self) -> None:
        self._fired.set()
        if self.last_call_wait > 0:
            # Let other ranks' in-flight records land BEFORE reading, so the
            # attribution log covers every fault of the round, not just the first
            # (reference last_call_wait, ``monitor_thread.py:155-184``).
            time.sleep(self.last_call_wait)
        try:
            records = self.coord.get_interruptions(self.iteration)
            for rec in records:
                log.warning(f"interruption: {rec.describe()}")
        except Exception:
            log.warning("could not read interruption records", exc_info=True)
        # Abort under the atomic lock: user critical sections are never torn.
        with self.atomic_lock:
            if self.abort_fn is not None:
                try:
                    self.abort_fn()
                except Exception:
                    log.exception("abort chain failed")
        # Inject until acknowledged.
        while not self._ack.is_set() and not self._shutdown.is_set():
            if self._armed.is_set():
                with self.atomic_lock:
                    if self._ack.is_set() or not self._armed.is_set():
                        break
                    try:
                        async_raise(self.main_thread_id, RankShouldRestart)
                    except InternalError:
                        log.exception("async raise failed")
                        return
            if self._ack.wait(timeout=self.interval):
                break
