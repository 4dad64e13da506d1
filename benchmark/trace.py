"""The traced run's reading of the device: a ``torch.profiler`` session over a part of
the window, reduced to device intervals, the benchmark's own host spans, busy time,
idle gaps and the operations that took the most time.

Spans are the benchmark's: ``bench/<name>`` regions (``record_function``) that the
loops open around their calls into the program, only while a session runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

PREFIX = "bench/"
TRACED = "traced"  # the region that marks the traced window itself
SETTLE_S = 0.05  # a session can lose the device's first records: let it settle
TOP = 10
_DEVICE_NON_KERNELS = ("Memcpy ", "Memset ")


def kernel_key(name: str) -> str:
    """A kernel's name without return type, template arguments, parameter list or
    anonymous namespace: ``void ns::k<32>(float const*)`` → ``k``."""
    s = name.replace("(anonymous namespace)::", "").strip()
    out, depth = [], 0
    for c in s:
        if c == "<":
            depth += 1
        elif c == ">" and depth:
            depth -= 1
        elif not depth:
            out.append(c)
    s = "".join(out)
    if s.endswith(")"):
        depth = 0
        for i in range(len(s) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(s[i], 0)
            if depth == 0:
                s = s[:i]
                break
    parts = s.split()
    return parts[-1].split("::")[-1] if parts else name


@dataclasses.dataclass
class TraceData:
    """One session's records, times in seconds on the host's clock."""

    kernels: list  # (key, start, end) of every kernel on the device
    copies: list  # (name, start, end) of device copies and sets
    host: list  # (region, start, end) of the benchmark's host spans
    window: tuple  # (start, end) of the traced window

    @property
    def on_device(self) -> bool:
        """Whether the session saw the device at all (a CPU run's trace does not)."""
        return bool(self.kernels or self.copies)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def in_window(self, items) -> list:
        lo, hi = self.window
        return [it for it in items if it[-1] > lo and it[-2] < hi]

    def busy(self, lo: float, hi: float) -> list:
        """The union of device intervals (kernels, copies, sets) clipped to
        ``[lo, hi]``, as sorted disjoint intervals."""
        ivs = sorted((max(a, lo), min(b, hi)) for _, a, b in self.kernels + self.copies
                     if b > lo and a < hi)
        merged: list = []
        for a, b in ivs:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self, lo: float | None = None, hi: float | None = None) -> float:
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        return sum(b - a for a, b in self.busy(lo, hi))

    def breakdown(self) -> dict:
        """The device operations that took most time in the window, and the idle
        gaps summed by the host span open at each gap's middle."""
        by_op: dict[str, float] = {}
        lo, hi = self.window
        for name, a, b in self.in_window(self.kernels + self.copies):
            by_op[name] = by_op.get(name, 0.0) + min(b, hi) - max(a, lo)
        gaps: dict[str, float] = {}
        edge = lo
        for a, b in self.busy(lo, hi) + [[hi, hi]]:
            if a > edge:
                name = self.host_at(0.5 * (edge + a))
                gaps[name] = gaps.get(name, 0.0) + a - edge
            edge = max(edge, b)
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_op), "idle_gaps": top(gaps)}

    def host_at(self, t: float) -> str:
        """The innermost benchmark span open on the host at ``t``."""
        best = None
        for name, a, b in self.host:
            if name != TRACED and a <= t <= b and (best is None or a >= best[1]):
                best = (name, a)
        return best[0] if best else "outside the benchmark's spans"


def _records(prof) -> TraceData:
    from torch.autograd import DeviceType

    kernels, copies, host = [], [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = ev.start_ns() * 1e-9
        end = start + ev.duration_ns() * 1e-9
        on_device = ev.device_type() != DeviceType.CPU
        if ev.is_user_annotation():
            if name.startswith(PREFIX) and not on_device:
                host.append((name[len(PREFIX):], start, end))
        elif on_device:
            if name.startswith(_DEVICE_NON_KERNELS):
                copies.append((name.split()[0] + " " + name.split()[1], start, end))
            else:
                kernels.append((kernel_key(name), start, end))
    window = [(a, b) for n, a, b in host if n == TRACED]
    if not window:
        raise RuntimeError("the trace lost the traced window's own span")
    return TraceData(kernels, copies, host, window[0])


class Tracer:
    """Opens one profiler session over part of a run. ``enabled=False`` (the timed
    runs) makes every call a no-op and every region a null context."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = torch.device(device)
        self.active = False
        self.data: TraceData | None = None
        self._prof = None
        self._window = None

    def region(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        return torch.profiler.record_function(PREFIX + name)

    def _session(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self) -> None:
        """One short session in set-up: the first session of a process initializes
        the device's tracing, which takes seconds on the card."""
        if not self.enabled:
            return
        with self._session():
            torch.ones(1, device=self.device).add_(1)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def start(self) -> None:
        if not self.enabled or self.active or self.data is not None:
            return
        self._prof = self._session()
        self._prof.start()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        time.sleep(SETTLE_S)
        self.active = True
        self._window = self.region(TRACED)
        self._window.__enter__()

    def stop(self) -> None:
        if not self.active:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._window.__exit__(None, None, None)
        self.active = False
        self._prof.stop()
        self.data = _records(self._prof)
        self._prof = None
