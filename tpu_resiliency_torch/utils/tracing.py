"""Cross-process causal tracing over the structured event stream.

One restart's causal chain — fault detected → abort → rendezvous round →
respawn / spare promotion → first step resumed — crosses at least three
processes (worker, monitor, launcher agent) and often several hosts. Log lines
interleave them; this module stitches them: a **trace id** minted once at the
launcher names the whole run, and **spans** (paired ``span_begin``/``span_end``
events carrying a span id and a parent id) nest the run's phases into a tree
that ``tools/trace_export.py`` renders as a Chrome/Perfetto trace.

Propagation mirrors the events layer's own env wiring
(``TPU_RESILIENCY_EVENTS_FILE``): the trace id rides ``$TPU_RESILIENCY_TRACE_ID``
and the spawner's active span rides ``$TPU_RESILIENCY_PARENT_SPAN``, so a worker
spawned inside the launcher's ``launcher.round`` span parents its own spans (and
every plain ``record()`` event) to that round without any code in the worker —
``utils/events.py`` stamps the inherited context onto each record.

Usage::

    from tpu_resiliency_torch.utils.tracing import ensure_trace_id, span

    ensure_trace_id()                     # launcher entry: mint + export
    with span("launcher", "launcher.round", round=3):
        ...                               # record() calls here carry this span
        env.update(child_env())           # explicit per-child propagation

Spans are observability, not control flow: every operation here is best-effort
and an exception inside the wrapped block still emits a ``span_end`` with
``ok=False`` and the error before re-raising.
"""

from __future__ import annotations

import itertools
import os
import secrets
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Optional

from tpu_resiliency_torch.utils import events
from tpu_resiliency_torch.utils.events import record

#: Re-exported from events (the envelope owner) — one name, one place.
TRACE_ID_ENV = events.TRACE_ID_ENV
PARENT_SPAN_ENV = events.PARENT_SPAN_ENV

_tls = threading.local()


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def trace_id() -> Optional[str]:
    """The run's trace id, or None when no launcher/test ever minted one."""
    return os.environ.get(TRACE_ID_ENV) or None


def ensure_trace_id() -> str:
    """Mint (once) and export the run's trace id.

    Called at the launcher entry point; exporting via ``os.environ`` means every
    process the launcher spawns — agents, workers, monitors — inherits it, the
    same single-variable wiring the JSONL sink uses.
    """
    tid = os.environ.get(TRACE_ID_ENV)
    if not tid:
        tid = secrets.token_hex(8)
        os.environ[TRACE_ID_ENV] = tid
    return tid


def current_span_id() -> Optional[str]:
    """The innermost open span on this thread, else the inherited parent span
    (a child process's spans/events parent to the span its spawner held open)."""
    for sid in reversed(_stack()):
        if isinstance(sid, str):  # a ring span (an int id) never reaches the stream
            return sid
    return os.environ.get(PARENT_SPAN_ENV) or None


def _context() -> tuple[Optional[str], Optional[str]]:
    return trace_id(), current_span_id()


# Upgrade the events layer's env-only default to the span-stack-aware provider.
events.set_context_provider(_context)


def child_env() -> dict[str, str]:
    """Env delta handing this process's trace context to a child it spawns.

    The trace id is usually already exported process-wide (``ensure_trace_id``);
    the parent span is per-call-site — a worker spawned during round 3 must
    parent to round 3's span, not to whatever the env held at launcher start.
    """
    env: dict[str, str] = {}
    tid = trace_id()
    if tid:
        env[TRACE_ID_ENV] = tid
    sid = current_span_id()
    if sid:
        env[PARENT_SPAN_ENV] = sid
    return env


@contextmanager
def span(source: str, name: str, **payload: Any):
    """Context manager emitting a paired ``span_begin``/``span_end``.

    The new span's id is pushed onto the thread-local stack BEFORE the begin
    event is recorded, so both span events (and every ``record()`` inside the
    block) carry it as their envelope ``span_id``; the parent linkage travels in
    the begin event's ``parent_id`` payload. Yields the span id (useful for
    handing to threads or asserting pairing in tests).
    """
    sid = secrets.token_hex(8)
    parent = current_span_id()
    stack = _stack()
    stack.append(sid)
    t0 = time.perf_counter()
    record(source, "span_begin", span=name, parent_id=parent, **payload)
    failure: Optional[str] = None
    try:
        yield sid
    except BaseException as e:
        failure = repr(e)
        raise
    finally:
        try:
            record(
                source, "span_end", span=name,
                duration_s=time.perf_counter() - t0,
                ok=failure is None,
                **({"error": failure} if failure else {}),
            )
        finally:
            # Pop AFTER span_end so the end event still carries this span's id;
            # tolerate mispaired exits (a generator-held span closed late).
            if stack and stack[-1] == sid:
                stack.pop()
            else:
                try:
                    stack.remove(sid)
                except ValueError:
                    pass


# -- the span ring: spans kept in this process's memory -------------------------------
#
# A ring span is for work inside a train step or a report, where a stream span would
# cost an id from ``secrets`` and two records: it writes no event and keeps one record
# in a bounded ring, read back with ``spans()``. It shares the thread's stack with
# ``span()``, so the spans of a thread form one tree; its id is an int, which
# ``current_span_id`` passes over, so no stream record names a span the stream never
# saw. It opens no ``torch.profiler`` region. Times are nanoseconds on the clock of
# ``time.time_ns()``, the one torch.profiler's Kineto records carry, taken as
# ``perf_counter_ns()`` plus one offset fixed when the ring starts, so they never run
# backwards.

#: Spans the ring holds by default: a 30 s window of train steps many times over.
RING_CAPACITY = 65536

_ids = itertools.count(1)
_ring: Optional[deque] = None
_offset_ns = 0
_step: Optional[int] = None


class SpanRecord:
    """One finished ring span: ``step`` is the loop step current at entry
    (:func:`set_step`), ``counts`` what the caller attached, ``ok``/``error`` whether
    the block raised and what, ``device_ms`` the device time from the span's entry to
    its exit on the stream it ran on (None without a device interval), filled in by
    :func:`spans`."""

    __slots__ = ("name", "span_id", "parent_id", "step", "start_ns", "end_ns", "ok",
                 "error", "counts", "device_ms", "_events")

    def __init__(self, name: str, span_id: int, step: Optional[int]):
        self.name = name
        self.span_id = span_id
        self.parent_id = None
        self.step = step
        self.start_ns = self.end_ns = 0
        self.ok = True
        self.error: Optional[str] = None
        self.counts: dict = {}
        self.device_ms: Optional[float] = None
        self._events = None  # (start, end) timing events until resolved

    @property
    def duration_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    def count(self, **counts) -> None:
        """Attach counts (``records=``, ``samples=``, ...) to the span. A count may be a
        0-d device tensor: it is read when the ring is read (:func:`spans`), so attaching
        it makes the host wait for nothing."""
        self.counts.update(counts)

    def _resolve(self) -> None:
        for name, value in self.counts.items():
            if hasattr(value, "item"):
                try:
                    self.counts[name] = value.item()
                except RuntimeError:  # the device failed before the count was made
                    self.counts[name] = None
        if self._events is None:
            return
        start, end = self._events
        try:
            end.synchronize()
            self.device_ms = start.elapsed_time(end)
        except RuntimeError:  # the device failed before the span's end ran
            pass
        self._events = None


class _RingSpan:
    __slots__ = ("ring", "record", "device")

    def __init__(self, ring: deque, name: str, device):
        self.ring = ring
        self.record = SpanRecord(name, next(_ids), _step)
        self.device = device

    def __enter__(self) -> SpanRecord:
        rec = self.record
        stack = _stack()
        rec.parent_id = stack[-1] if stack else None
        stack.append(rec.span_id)
        if self.device is not None and self.device.type == "cuda":
            import torch

            # torch.Event finds the current stream in C++: torch.cuda.Event with
            # torch.cuda.current_stream took 2.4 times as long per span on an H100 host.
            rec._events = (torch.Event(self.device, enable_timing=True),
                           torch.Event(self.device, enable_timing=True))
            rec._events[0].record()
        rec.start_ns = time.perf_counter_ns() + _offset_ns
        return rec

    def __exit__(self, exc_type, exc, tb) -> bool:
        rec = self.record
        rec.end_ns = time.perf_counter_ns() + _offset_ns
        if rec._events is not None:
            rec._events[1].record()
        if exc_type is not None:
            rec.ok, rec.error = False, repr(exc)
        stack = _stack()
        if stack and stack[-1] == rec.span_id:
            stack.pop()
        elif rec.span_id in stack:
            stack.remove(rec.span_id)
        self.ring.append(rec)
        return False


class _NullSpan:
    """What :func:`ring_span` returns while the ring is off."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def count(self, **counts) -> None:
        pass


_NULL_SPAN = _NullSpan()


def ring_span(name: str, *, device=None):
    """Context manager keeping one span in the ring; yields its :class:`SpanRecord`,
    whose ``count`` attaches counts known only at the end.

    ``device``: a torch device; a CUDA one gives the span a device interval, two
    timing events recorded on the device's current stream at entry and at exit and
    resolved only when :func:`spans` reads them (nothing here waits for the device).
    A block that raises is kept with ``ok=False`` and its error, and the exception
    goes on. With the ring off (capacity 0) this is one check."""
    ring = _ring
    if ring is None:
        return _NULL_SPAN
    return _RingSpan(ring, name, device)


def set_step(step: Optional[int]) -> None:
    """The loop step of the ring spans that start from now on (``run_training`` sets
    it each iteration): the identifier all spans of a step share."""
    global _step
    _step = step


def set_capacity(capacity: int = RING_CAPACITY) -> None:
    """Start an empty ring that keeps the last ``capacity`` spans; 0 turns it off."""
    global _ring, _offset_ns
    _offset_ns = time.time_ns() - time.perf_counter_ns()
    _ring = deque(maxlen=capacity) if capacity > 0 else None


def spans(name: Optional[str] = None) -> list[SpanRecord]:
    """The ring's records (only ``name``'s, if given) in the order they ended, their
    device intervals and device counts resolved: this waits for the device to run
    each span's end."""
    ring = _ring
    if ring is None:
        return []
    out = [r for r in ring.copy() if name is None or r.name == name]
    for r in out:
        r._resolve()
    return out


set_capacity()
