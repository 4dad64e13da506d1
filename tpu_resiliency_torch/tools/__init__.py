"""Operator-facing CLI tools over the framework's artifacts and streams."""

from __future__ import annotations

import os
import sys
from typing import Callable

#: 128 + SIGPIPE: the conventional shell exit status of a pipe-truncated tool,
#: so ``tool | head`` scripting can tell a truncated run from a complete one.
SIGPIPE_EXIT = 141


def pipe_safe(emit: Callable[[], None]) -> bool:
    """Run ``emit`` (stdout-printing CLI body) with ``| head``-citizenship.

    Flushes inside the guard: with block-buffered stdout the writes that die
    on a closed pipe may be the interpreter-exit flush, after ``main``
    returned — so the flush must happen where the handler can see it. On a
    broken pipe, stdout is redirected to devnull so shutdown cannot re-raise.

    Returns True when the consumer vanished mid-output (callers exit
    :data:`SIGPIPE_EXIT` per the SIGPIPE convention, not 0 — a truncated
    report must not read as a complete one).
    """
    try:
        emit()
        sys.stdout.flush()
        return False
    except BrokenPipeError:
        fd = os.open(os.devnull, os.O_WRONLY)
        try:
            os.dup2(fd, sys.stdout.fileno())
        finally:
            os.close(fd)
        return True
