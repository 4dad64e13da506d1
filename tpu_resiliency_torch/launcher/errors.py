"""Worker error files: structured crash reports crossing the process boundary.

Analogue of the reference's torchelastic error-file machinery
(``_torch_elastic_compat/multiprocessing/errors/__init__.py:379`` ``@record``): the
launcher hands each worker a private JSON error-file path via
``$TPU_RESILIENCY_ERROR_FILE``; a ``@record``-wrapped main writes its traceback there
before dying, and the agent attaches the parsed payload to its failure report — so a
multi-node crash is diagnosed from the agent log alone, without grepping N worker logs.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import sys
import time
import traceback
from typing import Any, Callable, Optional

ERROR_FILE_ENV = "TPU_RESILIENCY_ERROR_FILE"


@dataclasses.dataclass
class WorkerError:
    message: str
    exception_type: str = ""
    traceback: str = ""
    pid: int = 0
    timestamp: float = 0.0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_file(cls, path: str) -> Optional["WorkerError"]:
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return None
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})


def write_error_file(exc: BaseException, path: Optional[str] = None) -> None:
    path = path or os.environ.get(ERROR_FILE_ENV)
    if not path:
        return
    err = WorkerError(
        message=str(exc),
        exception_type=type(exc).__name__,
        traceback="".join(traceback.format_exception(type(exc), exc, exc.__traceback__)),
        pid=os.getpid(),
        timestamp=time.time(),
    )
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(err.to_json())
    except OSError:
        pass


def record(fn: Callable[..., Any]) -> Callable[..., Any]:
    """Decorate a worker ``main`` so uncaught exceptions land in the error file
    (and still propagate). SystemExit with code 0 is not an error."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except SystemExit as e:
            if e.code not in (0, None):
                write_error_file(e)
            raise
        except BaseException as e:
            write_error_file(e)
            raise

    return wrapper


def main_guard(fn: Callable[[], Any]) -> None:
    """Run ``fn`` as a worker entry point: record + non-zero exit on failure."""
    try:
        record(fn)()
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
