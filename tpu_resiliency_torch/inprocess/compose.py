"""Functional composition of pluggable restart callbacks.

Analogue of reference ``inprocess/compose.py:66-118``: chain N callables of the same
plugin family into one, preserving the family type for validation. The reference
computes the lowest common MRO ancestor so a composed ``Abort`` still isinstance-checks
as ``Abort``; here composition returns a :class:`Compose` wrapper that records its
members, and type checks use :func:`isinstance_or_composed`.
"""

from __future__ import annotations

from typing import Any, Callable


class Compose:
    """Left-to-right chain: ``Compose(f, g)(x) == g(f(x))`` — each callback receives
    the previous one's return value (state-threading convention of the plugin API)."""

    def __init__(self, *callbacks: Callable):
        if not callbacks:
            raise ValueError("Compose requires at least one callback")
        self.callbacks = callbacks

    def __call__(self, value: Any) -> Any:
        for cb in self.callbacks:
            value = cb(value)
        return value

    def __repr__(self) -> str:
        inner = ", ".join(repr(c) for c in self.callbacks)
        return f"Compose({inner})"


def isinstance_or_composed(obj: Any, cls: type) -> bool:
    """True if obj is a `cls`, or a Compose whose members all are."""
    if isinstance(obj, Compose):
        return all(isinstance_or_composed(c, cls) for c in obj.callbacks)
    return isinstance(obj, cls)
