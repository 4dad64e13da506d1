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

import os
import secrets
import threading
import time
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
    stack = _stack()
    if stack:
        return stack[-1]
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


def traced(source: str, name: Optional[str] = None):
    """Decorator form of :func:`span` (``@prof``'s causal sibling: same timing
    payload, but begin/end pairing and parent linkage instead of one record)."""

    def deco(fn):
        label = name or getattr(fn, "__name__", "call")

        def wrapped(*args, **kwargs):
            with span(source, label):
                return fn(*args, **kwargs)

        wrapped.__name__ = getattr(fn, "__name__", label)
        wrapped.__wrapped__ = fn
        return wrapped

    return deco
