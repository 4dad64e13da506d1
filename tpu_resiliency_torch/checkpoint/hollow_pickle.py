"""Pickling of hollow skeletons, interchangeable with the JAX package's containers.

A hollow skeleton is a plain pickle, and pickle names a class by its module path.
The JAX package's skeletons name ``tpu_resiliency.checkpoint.state_dict.TensorPlaceholder``;
the port's class lives at another path. So the port writes the placeholder under the
JAX package's path (its name on the wire, like the header's dtype names) and maps
that path back to its own class when it reads, without importing the JAX package.
A container written by either package then loads in the other.

The port's ``local_manager`` and ``async_ckpt`` import this module as ``pickle``:
every pickle they make or read is a hollow skeleton.
"""

from __future__ import annotations

import io
import pickle
from typing import Any

from tpu_resiliency_torch.checkpoint.state_dict import TensorPlaceholder

HIGHEST_PROTOCOL = pickle.HIGHEST_PROTOCOL

#: The placeholder's module path in containers (the JAX package's).
WIRE_MODULE = "tpu_resiliency.checkpoint.state_dict"
_NAMES = {(WIRE_MODULE, "TensorPlaceholder"), (TensorPlaceholder.__module__, "TensorPlaceholder")}


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, writing the placeholder class under its wire name
    (the C pickler checks that a class's path imports to the class itself)."""

    def save_global(self, obj, name=None):
        if obj is not TensorPlaceholder:
            return super().save_global(obj, name)
        if self.proto >= 4:
            self.save(WIRE_MODULE)
            self.save("TensorPlaceholder")
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{WIRE_MODULE}\nTensorPlaceholder\n".encode())
        self.memoize(obj)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _NAMES:
            return TensorPlaceholder
        return super().find_class(module, name)


def dumps(obj: Any, protocol: int = HIGHEST_PROTOCOL) -> bytes:
    buf = io.BytesIO()
    _Pickler(buf, protocol=protocol).dump(obj)
    return buf.getvalue()


def loads(data: bytes) -> Any:
    return _Unpickler(io.BytesIO(data)).load()
