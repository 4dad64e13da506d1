"""Per-region and per-kernel device timing from ``torch.profiler``: the CUPTI signal.

Port of ``tpu_resiliency/telemetry/device_profiler.py``. The reference's straggler
detector feeds on CUPTI per-kernel durations (``straggler/cupti_src/
CuptiProfiler.cpp:96-203``) with a ``start/stop/get_stats/reset`` contract. Under XLA
kernels are fused into whole programs, so the JAX package read per-program times;
on the card, ``torch.profiler`` (Kineto over CUPTI) gives each kernel its own
device time again:

- ``prog/`` samples (:meth:`DeviceTimeProfiler.drain`) are the device span of each
  ``torch.profiler.record_function`` region run in the window (Kineto's GPU user
  annotations), one sample per execution, keyed by the region's name;
- ``op/`` samples (:meth:`DeviceTimeProfiler.drain_ops`, ``collect_ops=True``) are
  per-kernel device durations keyed by :func:`normalize_kernel_name`, which strips
  the return type, template arguments and parameter list (as the reference's
  ``op_scope_key`` strips instruction ids) so that instances of one kernel do not
  fragment into many signals.

With ``device="cpu"``, and only then, the profiler traces the host alone: ``prog/`` is
each region's host-inclusive duration and ``op/`` each host op's, a different
signal that keeps the pipeline exercisable off the card (the reference's host
``PjitFunction`` fallback). Every sample comes from one trace record of its own, so
a record the trace loses costs that sample and never moves a duration onto another
name. The extraction is pure functions over :class:`EventRecord`.

The profiler is process-global: a window cannot start while another
``torch.profiler`` session runs (``start`` raises), and a window left open must be
stopped (``StragglerDetectionCallback.on_exception`` does).

A window's own cost is kept in the span ring (``utils/tracing.py``): ``profiler.open``
(the session's start, and on the card the synchronise and the settle) and
``profiler.close`` (the session's stop, the parse and the fold), which counts the
trace's ``records`` and the ``samples`` kept from them.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Iterable

import numpy as np
import torch

from tpu_resiliency_torch.platform.device import resolve_device
from tpu_resiliency_torch.utils import tracing
from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)

MAX_SAMPLES_PER_PROGRAM = 8192  # reference statsMaxLenPerKernel ring bound

#: Kinds of :class:`EventRecord`.
KERNEL = "kernel"  # a kernel's run on the device
DEVICE_REGION = "device_region"  # a record_function region's span on the device
HOST_REGION = "host_region"  # a record_function region's span on the host
HOST_OP = "host_op"  # an operator's span on the host
OTHER = "other"  # copies and sets on the device

# Device records that are not kernels. Kinds are told by name: torch 2.11's Kineto
# events carry no activity type.
_DEVICE_NON_KERNELS = ("Memcpy ", "Memset ")


@dataclasses.dataclass(frozen=True)
class EventRecord:
    """One trace record, as the extraction reads it."""

    name: str
    kind: str
    duration_ns: int
    device: str  # "cuda" | "cpu"


def _strip_enclosed(s: str, open_c: str, close_c: str) -> str:
    """``s`` without every balanced ``open_c ... close_c`` group."""
    out, depth = [], 0
    for c in s:
        if c == open_c:
            depth += 1
        elif c == close_c and depth:
            depth -= 1
        elif not depth:
            out.append(c)
    return "".join(out)


def normalize_kernel_name(name: str) -> str:
    """The signal key of a kernel: its qualified name without return type, template
    arguments, parameter list or ``(anonymous namespace)::``. E.g. ``void
    (anonymous namespace)::median_weights_network_kernel<32>(float const*, ...)`` →
    ``median_weights_network_kernel``."""
    s = name.replace("(anonymous namespace)::", "").strip()
    s = _strip_enclosed(s, "<", ">")
    if s.endswith(")"):  # the parameter list: the last balanced group
        depth = 0
        for i in range(len(s) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(s[i], 0)
            if depth == 0:
                s = s[:i]
                break
    parts = s.split()
    return parts[-1] if parts else name


def extract_program_times(records: Iterable[EventRecord], device: str = "cuda") -> dict[str, list[float]]:
    """Per-region durations in seconds: device spans on ``"cuda"``, host spans on
    ``"cpu"``."""
    kind = DEVICE_REGION if device == "cuda" else HOST_REGION
    out: dict[str, list[float]] = {}
    for rec in records:
        if rec.kind == kind:
            out.setdefault(rec.name, []).append(rec.duration_ns * 1e-9)
    return out


def extract_op_times(records: Iterable[EventRecord], device: str = "cuda") -> dict[str, list[float]]:
    """Per-kernel device durations in seconds by :func:`normalize_kernel_name` on
    ``"cuda"``; per host op by name on ``"cpu"``."""
    out: dict[str, list[float]] = {}
    for rec in records:
        if device == "cuda" and rec.kind == KERNEL:
            key = normalize_kernel_name(rec.name)
        elif device != "cuda" and rec.kind == HOST_OP:
            key = rec.name
        else:
            continue
        out.setdefault(key, []).append(rec.duration_ns * 1e-9)
    return out


def records_from_kineto(events) -> list[EventRecord]:
    """:class:`EventRecord` of each Kineto event of a finished session
    (``profile.profiler.kineto_results.events()``): a device record is a kernel
    unless it is a copy or a set; a host record is an operator (the CPU-only traces
    whose host operators are read hold no runtime calls)."""
    from torch.autograd import DeviceType

    out = []
    for ev in events:
        on_device = ev.device_type() != DeviceType.CPU
        name = ev.name()
        if ev.is_user_annotation():
            kind = DEVICE_REGION if on_device else HOST_REGION
        elif on_device:
            kind = OTHER if name.startswith(_DEVICE_NON_KERNELS) else KERNEL
        else:
            kind = HOST_OP
        out.append(EventRecord(name, kind, int(ev.duration_ns()), "cuda" if on_device else "cpu"))
    return out


def profiler_running() -> bool:
    """Whether a ``torch.profiler`` session is running in this process."""
    return bool(torch._C._autograd._profiler_enabled())


class DeviceTimeProfiler:
    """Windowed per-region / per-kernel device-time capture with the CUPTI manager
    contract. ``device=None`` means the CUDA card (raises without one)."""

    #: A window on the card waits for the card and pauses this long after its
    #: session starts, before the caller's work runs: on the H100 the trace can lose
    #: the records the card produces first after a session starts
    #: (``window_probe.py``: 1 window in 60 opened without a pause, none of 120 with).
    SETTLE_S = 0.02

    def __init__(self, collect_ops: bool = False, *, device=None):
        self.device = resolve_device(device)
        self._prof = None
        self._samples: dict[str, deque] = {}
        self._fresh: dict[str, list[float]] = {}
        #: opt-in per-kernel granularity alongside the per-region default.
        self.collect_ops = collect_ops
        self._op_samples: dict[str, deque] = {}
        self._op_fresh: dict[str, list[float]] = {}
        self.active = False

    # -- capture window ------------------------------------------------------

    def start(self) -> None:
        """Open a window. Raises if another profiler session runs in the process
        (a leaked window, or user tracing) or the session fails to start."""
        if self.active:
            return
        from torch.profiler import ProfilerActivity, profile

        if profiler_running():
            raise RuntimeError(
                "a torch.profiler session is already running in this process; "
                "the device-time window cannot start"
            )
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with tracing.ring_span("profiler.open"):
            prof = profile(activities=activities)
            prof.start()
            self._prof = prof
            self.active = True
            if self.device.type == "cuda":
                self._settle()

    def _settle(self) -> None:
        torch.cuda.synchronize(self.device)
        time.sleep(self.SETTLE_S)

    def stop(self) -> None:
        """End the window (waiting for the card) and fold its samples into the
        stats. A window whose trace cannot be read is logged and dropped."""
        if not self.active:
            return
        prof, self._prof = self._prof, None
        self.active = False
        with tracing.ring_span("profiler.close") as span:
            prof.stop()
            try:
                records = records_from_kineto(prof.profiler.kineto_results.events())
                dev = self.device.type
                kept = self._fold(self._samples, self._fresh,
                                  extract_program_times(records, dev))
                if self.collect_ops:
                    kept += self._fold(self._op_samples, self._op_fresh,
                                       extract_op_times(records, dev))
                span.count(records=len(records), samples=kept)
            except Exception:
                log.exception("device profile parse failed; window dropped")

    @staticmethod
    def _fold(samples: dict[str, deque], fresh: dict[str, list[float]], times) -> int:
        """Fold ``times`` into the stats; returns the number of samples."""
        n = 0
        for name, secs in times.items():
            samples.setdefault(name, deque(maxlen=MAX_SAMPLES_PER_PROGRAM)).extend(secs)
            fresh.setdefault(name, []).extend(secs)
            n += len(secs)
        return n

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- consumption ---------------------------------------------------------

    def drain(self) -> dict[str, list[float]]:
        """New per-region samples since the last drain (seconds per execution)."""
        fresh, self._fresh = self._fresh, {}
        return fresh

    def drain_ops(self) -> dict[str, list[float]]:
        """New per-kernel samples since the last drain (collect_ops only); feed to
        ``Detector.record_op_samples``."""
        fresh, self._op_fresh = self._op_fresh, {}
        return fresh

    @staticmethod
    def _stats_over(samples: dict[str, deque]) -> dict[str, dict[str, float]]:
        out = {}
        for name, ring in samples.items():
            if not ring:
                continue
            arr = np.asarray(ring, dtype=np.float64)
            out[name] = {
                "min": float(arr.min()),
                "max": float(arr.max()),
                "med": float(np.median(arr)),
                "avg": float(arr.mean()),
                "std": float(arr.std()),
                "count": int(arr.size),
            }
        return out

    def get_stats(self) -> dict[str, dict[str, float]]:
        """Per-region stats over retained samples (reference ``computeStats``)."""
        return self._stats_over(self._samples)

    def get_op_stats(self) -> dict[str, dict[str, float]]:
        """Per-kernel stats over retained samples (collect_ops only)."""
        return self._stats_over(self._op_samples)

    def reset(self) -> None:
        self._samples.clear()
        self._fresh.clear()
        self._op_samples.clear()
        self._op_fresh.clear()
