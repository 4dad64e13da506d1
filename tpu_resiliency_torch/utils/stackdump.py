"""All-thread Python stack capture for hang forensics.

When the watchdog decides a rank is hung, the most valuable artifact is the
one the reference (NVRx) never collects: *what every thread of the victim —
and of the ranks blocked waiting on it — was executing at that instant*.
This module is the capture half of the hang-forensics plane:

- :func:`capture_stacks` walks ``sys._current_frames()`` and renders each
  thread's Python stack (bounded frames, no locals — safe to serialize).
- :func:`dump_stacks` records the capture as ONE ``stack_dump`` event, which
  therefore lands in every attached sink: the shared JSONL, the metrics
  bridge (``tpu_stack_dumps_total{reason}``), and — the point — the
  flight-recorder ring (``utils/flight_recorder.py``), whose hot segment
  persists the dump within one ``write()`` even if the process is SIGKILLed
  moments later. A consolidated flight flush follows so the dump also appears
  in the ``flight-<rank>-<pid>.jsonl`` artifact the incident engine collects.
- :func:`install_signal_trigger` gives operators the on-demand path:
  ``kill -USR1 <worker pid>`` dumps without disturbing the workload. The
  handler itself only writes one byte to a self-pipe (async-signal-safe);
  a daemon watcher thread does the actual capture, so a signal landing while
  the main thread holds an event-sink lock can never deadlock — the same
  discipline as the flight recorder's signal flush.

Capture limits: a truly GIL-holding hang (a native call made without
releasing the GIL) blocks *every* Python thread, including the one trying to
capture — no in-process mechanism can observe that state while it lasts. The
capture fires the moment the GIL frees (chunk boundaries of
``Fault.GIL_SLEEP``, or the end of the native call); hangs parked in
GIL-releasing waits (collectives, ``block_until_ready``, socket reads, locks)
capture immediately.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import traceback
from typing import Optional

from tpu_resiliency_torch.utils.events import record as record_event
from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)

#: frames kept per thread (deepest first is what forensics wants — keep the
#: leaf end of the stack when truncating)
MAX_FRAMES_PER_THREAD = 64
#: threads kept per capture (a runaway thread-leaking process must not turn
#: one dump event into megabytes)
MAX_THREADS = 64

#: the operator's on-demand dump signal
DUMP_SIGNAL = signal.SIGUSR1


def capture_stacks(max_frames: int = MAX_FRAMES_PER_THREAD) -> list[dict]:
    """Every thread's Python stack as JSON-serializable dicts.

    Each entry: ``{"name", "ident", "daemon", "main", "frames": [
    "file:line in func | source"]}`` — outermost frame first, truncated to the
    *deepest* ``max_frames`` (the leaf is where the thread is stuck).
    """
    frames_by_id = sys._current_frames()
    threads = {t.ident: t for t in threading.enumerate()}
    main_id = threading.main_thread().ident
    # Rank BEFORE truncating: a JAX process can carry hundreds of pool
    # threads, and the main thread (usually the one that is stuck) must
    # never be the one the cap drops.
    ranked = sorted(
        frames_by_id.items(),
        key=lambda kv: (
            kv[0] != main_id,
            threads[kv[0]].name if kv[0] in threads else f"thread-{kv[0]}",
        ),
    )
    out: list[dict] = []
    for ident, frame in ranked[:MAX_THREADS]:
        t = threads.get(ident)
        stack = traceback.extract_stack(frame)
        if len(stack) > max_frames:
            stack = stack[-max_frames:]
        rendered = [
            f"{s.filename}:{s.lineno} in {s.name}"
            + (f" | {s.line.strip()}" if s.line else "")
            for s in stack
        ]
        out.append(
            {
                "name": t.name if t is not None else f"thread-{ident}",
                "ident": ident,
                "daemon": bool(t.daemon) if t is not None else None,
                "main": bool(t is threading.main_thread()) if t is not None else False,
                "frames": rendered,
            }
        )
    # Main thread first, then by name — deterministic artifacts.
    out.sort(key=lambda d: (not d["main"], str(d["name"])))
    return out


def dump_stacks(reason: str, detail: str = "") -> list[dict]:
    """Capture and record one ``stack_dump`` event, then flush the flight ring.

    Returns the captured thread list (callers embedding it elsewhere reuse
    the same capture). Never raises — forensics must not kill the patient.
    """
    try:
        threads = capture_stacks()
    except Exception:
        log.exception("stack capture failed")
        return []
    try:
        record_event(
            "flight", "stack_dump",
            reason=reason,
            **({"detail": detail} if detail else {}),
            thread_count=len(threads),
            threads=threads,
        )
    except Exception:
        log.debug("stack_dump record failed", exc_info=True)
    try:
        # The ring already holds the stack_dump line (it is an events sink);
        # the flush writes the consolidated per-process artifact so the
        # incident engine's collect() finds it even after a clean exit.
        from tpu_resiliency_torch.utils import flight_recorder

        flight_recorder.flush("stack_dump", detail=reason)
    except Exception:
        log.debug("flight flush after stack dump failed", exc_info=True)
    return threads


# -- operator signal path -----------------------------------------------------

_trigger_lock = threading.Lock()
_trigger_pipe: Optional[tuple[int, int]] = None


def _watcher(rfd: int) -> None:
    while True:
        try:
            data = os.read(rfd, 64)
        except OSError:
            return
        if not data:
            return
        dump_stacks("signal:SIGUSR1")


def install_signal_trigger() -> bool:
    """Chain a SIGUSR1 handler that requests a stack dump (idempotent).

    Returns True when installed. Main-thread-only (``signal.signal``
    restriction); safe no-op elsewhere. The previous disposition is chained
    so embedding applications keep their own SIGUSR1 semantics.
    """
    global _trigger_pipe
    if threading.current_thread() is not threading.main_thread():
        return False
    with _trigger_lock:
        if _trigger_pipe is not None:
            return True
        rfd, wfd = os.pipe()
        os.set_blocking(wfd, False)
        threading.Thread(
            target=_watcher, args=(rfd,), name="stackdump-usr1", daemon=True
        ).start()
        try:
            prev = signal.getsignal(DUMP_SIGNAL)

            def handler(signum, frame):
                try:
                    os.write(wfd, b"d")  # async-signal-safe; watcher dumps
                except OSError:
                    pass
                if callable(prev):
                    prev(signum, frame)

            signal.signal(DUMP_SIGNAL, handler)
        except (ValueError, OSError):
            try:
                os.close(rfd)
                os.close(wfd)
            except OSError:
                pass
            return False
        _trigger_pipe = (rfd, wfd)
        return True
