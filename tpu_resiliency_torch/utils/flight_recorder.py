"""Crash-surviving flight recorder: the last seconds before a death, always on disk.

The normal event sink (``$TPU_RESILIENCY_EVENTS_FILE``) dies with the process —
a SIGKILLed worker's final events may still sit in a userspace buffer, and a
worker whose filesystem path went away has nothing at all. Post-mortems care
about exactly those events: the span a rank died inside, the last heartbeat it
sent, the checkpoint phase it never finished. This module keeps a bounded ring
of each process's most recent events and guarantees it survives every way a
rank can die:

- **SIGKILL / OOM-kill** (uncatchable): the ring is *continuously* persisted.
  Every event is appended to a hot segment file (one ``write()`` per line, the
  same POSIX-append discipline as the JSONL sink); when the hot segment reaches
  ``capacity`` lines it is rotated to ``.prev`` (replacing the previous
  rotation). Between the two segments the last ``capacity``..``2×capacity``
  events are on disk within one write of real time — ``kill -9`` loses at most
  the event being written.
- **SIGTERM / SIGABRT** (the watchdog kill ladder's first rungs, and the
  launcher's graceful stop): a chained signal handler flushes a consolidated
  dump with the signal name before re-raising the previous disposition.
- **Unhandled exceptions** (``inprocess/wrap.py`` fn exceptions, interpreter
  ``sys.excepthook``): explicit ``flush(reason)`` calls, chained excepthook.

Layout under the flight directory (``$TPU_RESILIENCY_FLIGHT_DIR``, exported
once by the launcher like the events/metrics variables):

- ``flight-<rank>-<pid>.hot.jsonl`` / ``...prev.jsonl``: the live ring segments.
- ``flight-<rank>-<pid>.jsonl``: the consolidated dump written by ``flush``
  (ring contents + one trailing ``flight_flush`` record naming the reason).

``collect(dir)`` merges all three per (rank, pid) identity — consolidated dump
when present, stitched segments otherwise — which is what the launcher's
incident engine (``launcher/incident.py``) folds into incident artifacts.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from collections import deque
from typing import Optional

from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)

#: Re-exported from events (the envelope owner) — one name, one place.
from tpu_resiliency_torch.utils import events as _events  # noqa: E402

FLIGHT_DIR_ENV = _events.FLIGHT_DIR_ENV

#: default ring capacity (events per segment; disk holds up to 2× this)
DEFAULT_CAPACITY = 512

#: fault signals that trigger a consolidated flush before the previous
#: disposition runs (SIGKILL is uncatchable — the hot segments cover it)
FLUSH_SIGNALS = (signal.SIGTERM, signal.SIGABRT)


def _identity() -> str:
    rank = os.environ.get("RANK")
    rank_part = rank if rank and rank.isdigit() else "x"
    return f"{rank_part}-{os.getpid()}"


class FlightRecorder:
    """Bounded event ring with continuous segment persistence + fault-flush.

    Registered as an ``events.add_sink`` sink (it receives every ``record()``
    the process makes); additionally installs chained SIGTERM/SIGABRT handlers
    and a chained ``sys.excepthook`` when asked (``install_handlers=True``,
    main thread only — ``signal.signal`` is a no-op elsewhere)."""

    def __init__(
        self,
        directory: str,
        capacity: int = DEFAULT_CAPACITY,
        install_handlers: bool = True,
    ):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.directory = directory
        self.capacity = capacity
        os.makedirs(directory, exist_ok=True)
        self._ident = _identity()
        self._ring: deque[str] = deque(maxlen=2 * capacity)
        self._lock = threading.Lock()
        self._hot_lines = 0
        self._hot_f = open(self._hot_path, "a", buffering=1)
        self._flushed_reason: Optional[str] = None
        self._closed = False
        if install_handlers:
            self._install_handlers()

    # -- paths --------------------------------------------------------------

    @property
    def _hot_path(self) -> str:
        return os.path.join(self.directory, f"flight-{self._ident}.hot.jsonl")

    @property
    def _prev_path(self) -> str:
        return os.path.join(self.directory, f"flight-{self._ident}.prev.jsonl")

    @property
    def dump_path(self) -> str:
        return os.path.join(self.directory, f"flight-{self._ident}.jsonl")

    # -- the sink -----------------------------------------------------------

    def __call__(self, event) -> None:
        """events.add_sink entry: one line into the ring + the hot segment."""
        try:
            line = event.to_json()
        except Exception:
            return
        with self._lock:
            if self._closed:
                return
            self._ring.append(line)
            try:
                self._hot_f.write(line + "\n")
                self._hot_lines += 1
                if self._hot_lines >= self.capacity:
                    self._rotate_locked()
            except (OSError, ValueError):
                pass  # persistence is best-effort; the in-memory ring remains

    def _rotate_locked(self) -> None:
        try:
            self._hot_f.close()
        except OSError:
            pass
        try:
            os.replace(self._hot_path, self._prev_path)
        except OSError:
            pass
        self._hot_f = open(self._hot_path, "a", buffering=1)
        self._hot_lines = 0

    # -- fault flush --------------------------------------------------------

    def flush(self, reason: str, detail: str = "") -> Optional[str]:
        """Write the consolidated dump (ring + trailing ``flight_flush``
        marker). Idempotent per reason sequence — later flushes rewrite the
        dump with the newest ring, so the deepest-in-the-death flush wins.
        Returns the dump path (None if the write failed).

        Signal-safe: flush() runs from the chained SIGTERM/SIGABRT handlers,
        which interrupt the main thread at an arbitrary point — possibly while
        it already holds ``self._lock`` inside ``__call__``. A blocking
        acquire there would deadlock the handler and turn a graceful stop into
        a hang, so the ring is snapshotted with a non-blocking acquire and,
        when the lock is held, copied without it (deque reads are GIL-atomic
        enough for a best-effort dump)."""
        marker = json.dumps(
            {
                "ts": time.time(),
                "source": "flight",
                "kind": "flight_flush",
                "pid": os.getpid(),
                "rank": _rank_or_none(),
                "reason": reason,
                **({"detail": detail} if detail else {}),
            }
        )
        acquired = self._lock.acquire(blocking=False)
        try:
            lines = None
            for _ in range(3):
                try:
                    lines = list(self._ring)
                    break
                except RuntimeError:  # deque mutated mid-iteration (lockless)
                    continue
            if lines is None:
                lines = []
            lines.append(marker)
            self._flushed_reason = reason
        finally:
            if acquired:
                self._lock.release()
        tmp = f"{self.dump_path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                f.write("\n".join(lines) + "\n")
            os.replace(tmp, self.dump_path)
            return self.dump_path
        except OSError:
            return None

    def close(self) -> None:
        with self._lock:
            self._closed = True
            try:
                self._hot_f.close()
            except OSError:
                pass

    # -- handler chaining ---------------------------------------------------

    def _install_handlers(self) -> None:
        if threading.current_thread() is not threading.main_thread():
            return
        for sig in FLUSH_SIGNALS:
            try:
                prev = signal.getsignal(sig)
                signal.signal(sig, self._make_signal_handler(sig, prev))
            except (ValueError, OSError):
                pass  # non-main thread or unsupported signal
        prev_hook = sys.excepthook
        recorder = self

        def hook(exc_type, exc, tb):
            try:
                recorder.flush("unhandled_exception", detail=repr(exc))
            except Exception:
                pass
            prev_hook(exc_type, exc, tb)

        sys.excepthook = hook

    def _make_signal_handler(self, sig: int, prev):
        recorder = self

        def handler(signum, frame):
            try:
                recorder.flush(f"signal:{signal.Signals(signum).name}")
            except Exception:
                pass
            # Chain: a callable previous handler runs next; the default
            # disposition is re-raised so the process still dies by the signal
            # (a flight recorder must never convert a kill into survival).
            if callable(prev):
                prev(signum, frame)
            elif prev is signal.SIG_DFL:
                signal.signal(signum, signal.SIG_DFL)
                os.kill(os.getpid(), signum)
            # SIG_IGN: honored — nothing more to do.

        return handler


# -- process-global wiring ---------------------------------------------------

_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()
_wired_for: Optional[str] = None


def get_recorder() -> Optional[FlightRecorder]:
    return _recorder


def install(
    directory: str,
    capacity: int = DEFAULT_CAPACITY,
    install_handlers: bool = True,
) -> FlightRecorder:
    """Create (once per directory) the process recorder and register it as an
    events sink. Re-install with a new directory replaces the old recorder."""
    global _recorder, _wired_for
    from tpu_resiliency_torch.utils import events

    with _recorder_lock:
        if _recorder is not None and _wired_for == directory:
            # Re-register if a clear_sinks() dropped us (idempotent: remove
            # first so repeated installs never double-feed the ring).
            events.remove_sink(_recorder)
            events.add_sink(_recorder, front=True)
            return _recorder
        if _recorder is not None:
            events.remove_sink(_recorder)
            _recorder.close()
        _recorder = FlightRecorder(
            directory, capacity=capacity, install_handlers=install_handlers
        )
        _wired_for = directory
        # FIRST in sink order: if the process dies mid-record (a SIGKILL
        # racing a stack dump captured in a starved-GIL window), the
        # crash-surviving ring must be the sink that already persisted it.
        events.add_sink(_recorder, front=True)
        return _recorder


def uninstall() -> None:
    """Detach and close the process recorder (tests/scenarios; workloads keep
    theirs for life — the ring must outlive everything except the process)."""
    global _recorder, _wired_for
    from tpu_resiliency_torch.utils import events

    with _recorder_lock:
        if _recorder is not None:
            events.remove_sink(_recorder)
            _recorder.close()
        _recorder = None
        _wired_for = None


def install_from_env() -> Optional[FlightRecorder]:
    """Wire the recorder named by ``$TPU_RESILIENCY_FLIGHT_DIR`` (no-op when
    unset). Called lazily from the events layer so any process that records a
    single event self-installs, exactly like the JSONL/metrics env sinks."""
    path = os.environ.get(FLIGHT_DIR_ENV)
    if not path:
        return None
    try:
        return install(path)
    except OSError as e:
        log.warning(f"cannot install flight recorder in {path!r}: {e}")
        return None


def flush(reason: str, detail: str = "") -> Optional[str]:
    """Flush the process recorder if one is installed (safe no-op otherwise)."""
    rec = _recorder
    if rec is None:
        return None
    return rec.flush(reason, detail)


def _rank_or_none() -> Optional[int]:
    r = os.environ.get("RANK")
    return int(r) if r and r.isdigit() else None


# -- reading ------------------------------------------------------------------


def _read_lines(path: str) -> list[dict]:
    out: list[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue  # torn mid-write line (the SIGKILL instant)
    except OSError:
        pass
    return out


def collect(directory: str) -> dict[str, list[dict]]:
    """All flight dumps under ``directory``, keyed ``"<rank>-<pid>"``.

    Per identity, the consolidated dump (``flush`` output) is preferred; when
    only the live segments exist (SIGKILL — no flush ever ran) the ``.prev``
    and ``.hot`` segments are stitched in order. Records are deduplicated by
    exact line identity (a flushed ring repeats segment contents)."""
    out: dict[str, list[dict]] = {}
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    idents = set()
    for n in names:
        if n.startswith("flight-") and n.endswith(".jsonl"):
            ident = n[len("flight-"):-len(".jsonl")]
            for suffix in (".hot", ".prev"):
                if ident.endswith(suffix):
                    ident = ident[: -len(suffix)]
            idents.add(ident)
    for ident in sorted(idents):
        base = os.path.join(directory, f"flight-{ident}")
        records = _read_lines(f"{base}.prev.jsonl") + _read_lines(f"{base}.hot.jsonl")
        dump = _read_lines(f"{base}.jsonl")
        if dump:
            seen = {json.dumps(r, sort_keys=True) for r in dump}
            # Segment events newer than the flush (written between flush and
            # death) ride along after the dump.
            dump += [
                r for r in records
                if json.dumps(r, sort_keys=True) not in seen
            ]
            records = dump
        if records:
            # Stable ts order (flush markers and stitched segments can
            # interleave); ts-less garbage sinks to the front untouched.
            records.sort(key=lambda r: r.get("ts") if isinstance(
                r.get("ts"), (int, float)) else float("-inf"))
            out[ident] = records
    return out
