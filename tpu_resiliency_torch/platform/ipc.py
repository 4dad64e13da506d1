"""Local inter-process messaging over Unix domain sockets.

The analogue of the reference's AF_UNIX pickled IPC (``fault_tolerance/utils.py:121-179``
sync + asyncio helpers, and ``fault_tolerance/ipc_connector.py:30`` one-way queue with a
receiver thread). Used between a worker rank and its per-host monitor, and between ranks
and the launcher — never for tensor data.

Framing is shared with the TCP store protocol (``platform/framing.py``); the pickles name
classes by the JAX package's paths (``platform/wire.py``), so either package's monitor and
client talk to the other's. Unix sockets are filesystem-permission-protected, so no auth
handshake is needed here.
"""

from __future__ import annotations

import asyncio
import functools
import os
import socket
import threading
import time
from typing import Any, Callable, Optional

from tpu_resiliency_torch.platform import chaos, wire
from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)

_MAX_FRAME = 256 * 1024 * 1024

# Environment variables carrying socket paths from launcher to workers; analogue of
# FT_RANK_MONITOR_IPC_SOCKET / FT_LAUNCHER_IPC_SOCKET (reference ``data.py:27-30``).
MONITOR_SOCKET_ENV = "TPU_FT_MONITOR_IPC_SOCKET"
LAUNCHER_SOCKET_ENV = "TPU_FT_LAUNCHER_IPC_SOCKET"

write_object = wire.send_obj
read_object = functools.partial(wire.recv_obj, max_frame=_MAX_FRAME)
read_object_stream = functools.partial(wire.read_obj_stream, max_frame=_MAX_FRAME)
write_object_stream = wire.write_obj_stream


def connect(
    path: str, timeout: float = 30.0, cancel: Optional[threading.Event] = None
) -> socket.socket:
    """Connect to a UDS server, retrying within ``timeout``.

    Retry matters even when the caller has seen the socket file: the file
    appears at the server's bind(), and a loaded machine can deschedule the
    server between bind() and listen() — a one-shot connect then dies on
    ECONNREFUSED for a server that is milliseconds from ready (observed as a
    1-in-4 suite flake under 2x concurrency). FileNotFoundError is retried
    for the same reason one step earlier (file not yet created).

    ``cancel``: optional event checked every iteration — a caller shutting
    down mid-retry (worker teardown racing monitor startup) aborts the loop
    promptly with ``ConnectionAbortedError`` instead of sleeping out the
    remaining budget against a server that will never appear."""
    deadline = time.monotonic() + timeout
    while True:
        if cancel is not None and cancel.is_set():
            raise ConnectionAbortedError(f"ipc connect to {path!r} cancelled")
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        # Remaining budget, not the full timeout: a blocking connect on the
        # final attempt must not stretch the caller's deadline to ~2x.
        sock.settimeout(max(0.001, deadline - time.monotonic()))
        try:
            chaos.check_connect("ipc", peer=path)
            sock.connect(path)
            # The clipped timeout governed only the connect attempt; the
            # returned socket keeps the caller's full I/O timeout (a late
            # connect must not bequeath a milliseconds recv budget).
            sock.settimeout(timeout)
            return chaos.wrap(sock, "ipc", peer=path)
        except (ConnectionRefusedError, FileNotFoundError, BlockingIOError):
            # BlockingIOError: Linux AF_UNIX connect returns EAGAIN when the
            # listener's accept backlog is full — same transient class.
            sock.close()
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.05)


class IpcReceiver:
    """One-way message sink: listens on a UDS path, queues every received object.

    Analogue of the reference's ``IpcConnector`` (``fault_tolerance/ipc_connector.py:30``):
    the launcher listens here for ``WorkloadControlRequest``-style messages from ranks.
    """

    def __init__(self, path: str, on_message: Optional[Callable[[Any], None]] = None):
        self.path = path
        self._on_message = on_message
        self._messages: list[Any] = []
        self._lock = threading.Lock()
        self._server: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def start(self) -> None:
        if os.path.exists(self.path):
            os.unlink(self.path)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._server.bind(self.path)
        self._server.listen(64)
        self._thread = threading.Thread(target=self._loop, name="ipc-receiver", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        assert self._server is not None
        while not self._stop.is_set():
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            if chaos.check_accept("ipc"):
                conn.close()  # injected EOF-on-accept; sender sees a clean close
                continue
            conn = chaos.wrap(conn, "ipc")
            threading.Thread(
                target=self._drain_conn, args=(conn,), name="ipc-receiver-conn", daemon=True
            ).start()

    def _drain_conn(self, conn: socket.socket) -> None:
        try:
            while True:
                obj = read_object(conn)
                with self._lock:
                    self._messages.append(obj)
                if self._on_message is not None:
                    try:
                        self._on_message(obj)
                    except Exception:
                        log.exception("ipc on_message callback failed")
        except (EOFError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def fetch(self) -> list[Any]:
        """Return and clear all queued messages."""
        with self._lock:
            msgs, self._messages = self._messages, []
        return msgs

    def peek(self) -> list[Any]:
        with self._lock:
            return list(self._messages)

    def stop(self) -> None:
        self._stop.set()
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass
        if os.path.exists(self.path):
            try:
                os.unlink(self.path)
            except OSError:
                pass


def send_to(path: str, obj: Any, timeout: float = 30.0) -> None:
    """Fire-and-forget a single object at a UDS listener."""
    sock = connect(path, timeout=timeout)
    try:
        write_object(sock, obj)
    finally:
        sock.close()
