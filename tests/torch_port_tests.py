"""Run a test module of the JAX package against the port.

``port_tests(ref, namespace)`` reads a reference test file, rewrites every
``tpu_resiliency.`` to ``tpu_resiliency_torch.`` (imports, ``-m`` module paths and the
child scripts the tests write), applies the caller's listed edits, and executes it into
the calling module's namespace, so pytest collects each reference test there as a
test of the port: the same scenario and the same assertions, on the port's modules.
Line numbers stay the reference file's, so a failure points at the reference's line.

Every edit and every test left out is listed by the caller with its reason: a test
left out is one the port answers by a test of its own in the same file (a JAX call,
a TPU check), never one that fails.
"""

from __future__ import annotations

import re
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def port_source(ref: str, edits=()) -> str:
    """The reference test file ``ref`` (repo-relative) rewritten for the port."""
    src = re.sub(r"\btpu_resiliency\.", "tpu_resiliency_torch.", (REPO / ref).read_text())
    for old, new, why in edits:
        assert why and src.count(old) == 1, f"{ref}: the edit's text is not unique: {old!r}"
        src = src.replace(old, new)
    return src


def port_tests(ref: str, namespace: dict, edits=(), leave_out=None) -> list[str]:
    """Execute the rewritten ``ref`` into ``namespace``; returns the names of the tests
    (functions and classes) it added. ``leave_out``: ``{name: reason}`` of tests not
    run against the port (``Class.method`` for a method). A test name already in
    ``namespace`` raises, so two reference files never shadow each other's tests."""
    leave_out = dict(leave_out or {})
    assert all(leave_out.values()), "every test left out needs its reason"
    code = compile(port_source(ref, edits), str(REPO / ref), "exec")
    scratch = dict(namespace)
    exec(code, scratch)
    # The reference module's own marks go on its tests, not on the whole namespace.
    marks = scratch.pop("pytestmark", []) if scratch.get("pytestmark") is not namespace.get(
        "pytestmark") else []
    marks = marks if isinstance(marks, list) else [marks]
    added = []
    for name, obj in scratch.items():
        if name.startswith("__") or namespace.get(name) is obj:
            continue
        if not name.startswith(("Test", "test_")):
            namespace.setdefault(name, obj)  # fixtures and helpers; the caller's own win
            continue
        if name in namespace:
            raise AssertionError(f"{ref}: {name} is already defined here")
        if name in leave_out:
            continue
        if isinstance(obj, type):
            for attr in [a for a in vars(obj) if f"{name}.{a}" in leave_out]:
                delattr(obj, attr)
        for mark in marks:
            obj = mark(obj)
        namespace[name] = obj
        added.append(name)
    unknown = {n for n in leave_out if n.split(".")[0] not in scratch}
    assert not unknown, f"{ref}: no such tests to leave out: {sorted(unknown)}"
    return added
