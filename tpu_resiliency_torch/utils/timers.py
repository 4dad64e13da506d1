"""Nested debug timers: lightweight elapsed-time logging for slow paths.

Analogue of the reference's ``debug_time`` context/decorator
(``checkpointing/utils.py:35-83``), used across its checkpoint machinery: nested
scopes log at DEBUG with indentation showing the call tree, so a slow save
decomposes at a glance (serialize → replicate → write → finalize). Also feeds a
``timing`` record into the structured event stream when a sink is attached.

Usage::

    from tpu_resiliency_torch.utils.timers import debug_time

    with debug_time("save"):
        with debug_time("serialize"):
            ...
        with debug_time("replicate"):
            ...

    @debug_time("finalize")
    def _finalize(...): ...
"""

from __future__ import annotations

import functools
import threading
import time
from contextlib import contextmanager
from typing import Callable, Optional

from tpu_resiliency_torch.utils.events import record as record_event
from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)

_depth = threading.local()


@contextmanager
def _timed(name: str, source: str):
    depth = getattr(_depth, "value", 0)
    _depth.value = depth + 1
    t0 = time.perf_counter()
    try:
        yield
        failure = None
    except BaseException as e:
        failure = repr(e)
        raise
    finally:
        _depth.value = depth
        elapsed = time.perf_counter() - t0
        log.debug("%s%s: %.3f ms", "  " * depth, name, elapsed * 1e3)
        if depth == 0:
            # Only roots go to the event stream; nested scopes stay in the log.
            # A raised block reports ok=False with the error (events.prof parity).
            record_event(
                source, "timing", name=name, duration_s=elapsed,
                ok=failure is None, **({"error": failure} if failure else {}),
            )


def debug_time(name: Optional[str] = None, source: str = "timer"):
    """Context manager when called with a name; decorator when applied to a fn."""
    if callable(name):  # bare @debug_time
        fn = name
        return debug_time(fn.__name__, source)(fn)

    def as_decorator(fn: Callable):
        label = name or getattr(fn, "__name__", "block")

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with _timed(label, source):
                return fn(*args, **kwargs)

        return wrapped

    class _Both:
        """Usable as ``with debug_time("x"):`` and ``@debug_time("x")``. Safe to
        share across threads: each ``with`` entry gets its own context manager
        (thread-local stack), so concurrent scopes never clobber each other."""

        def __init__(self):
            self._local = threading.local()

        def __call__(self, fn: Callable):
            return as_decorator(fn)

        def __enter__(self):
            cm = _timed(name or "block", source)
            stack = getattr(self._local, "stack", None)
            if stack is None:
                stack = self._local.stack = []
            stack.append(cm)
            return cm.__enter__()

        def __exit__(self, *exc):
            return self._local.stack.pop().__exit__(*exc)

    return _Both()
