"""The monitor channel's wire: object frames whose classes carry the JAX package's names.

The rank monitor, its client and the launcher's IPC listener exchange pickled
dataclasses (``watchdog/data.py``, ``watchdog/config.py``), and pickle names a class
by its module path. The JAX package's frames name ``tpu_resiliency.watchdog.data.*``;
the port's classes live under ``tpu_resiliency_torch``. So the port writes each of its
own classes under the JAX package's path (its name on the wire, as
``checkpoint/hollow_pickle.py`` does for the tensor placeholder) and maps that path
back to its own module when it reads, without importing the JAX package. A port
client then talks to a JAX-package monitor and back.

The frame layout is ``platform/framing.py``'s object frame (an 8-byte big-endian
length, then the pickle); the store keeps that module's C pickler, and only the
monitor channel (``platform/ipc.py``, ``watchdog/monitor_server.py``) goes through here.
"""

from __future__ import annotations

import asyncio
import io
import pickle
import socket
from typing import Any

from tpu_resiliency_torch.platform.framing import DEFAULT_MAX_FRAME, LEN, recv_exact

#: The package whose module paths name classes on the wire, and this package.
WIRE_PACKAGE = "tpu_resiliency"
LOCAL_PACKAGE = "tpu_resiliency_torch"


def _swap_root(module: str, old: str, new: str) -> str:
    if module == old or module.startswith(old + "."):
        return new + module[len(old):]
    return module


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, writing this package's classes under their wire names
    (the C pickler checks that a class's path imports to the class itself)."""

    def save_global(self, obj, name=None):
        module = getattr(obj, "__module__", None) or ""
        wire = _swap_root(module, LOCAL_PACKAGE, WIRE_PACKAGE)
        if wire == module:
            return super().save_global(obj, name)
        name = name or obj.__qualname__
        if self.proto >= 4:
            self.save(wire)
            self.save(name)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{wire}\n{name}\n".encode())
        self.memoize(obj)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        return super().find_class(_swap_root(module, WIRE_PACKAGE, LOCAL_PACKAGE), name)


def dumps(obj: Any) -> bytes:
    buf = io.BytesIO()
    _Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def loads(data) -> Any:
    return _Unpickler(io.BytesIO(data)).load()


def _checked(length: int, max_frame: int) -> int:
    if length > max_frame:
        raise ValueError(f"frame too large: {length} > {max_frame}")
    return length


def send_obj(sock: socket.socket, obj: Any) -> None:
    payload = dumps(obj)
    sock.sendall(LEN.pack(len(payload)) + payload)


def recv_obj(sock: socket.socket, max_frame: int = DEFAULT_MAX_FRAME) -> Any:
    (length,) = LEN.unpack(recv_exact(sock, LEN.size))
    return loads(recv_exact(sock, _checked(length, max_frame)))


async def read_obj_stream(reader: asyncio.StreamReader, max_frame: int = DEFAULT_MAX_FRAME) -> Any:
    (length,) = LEN.unpack(await reader.readexactly(LEN.size))
    return loads(await reader.readexactly(_checked(length, max_frame)))


async def write_obj_stream(writer: asyncio.StreamWriter, obj: Any) -> None:
    payload = dumps(obj)
    writer.write(LEN.pack(len(payload)) + payload)
    await writer.drain()
