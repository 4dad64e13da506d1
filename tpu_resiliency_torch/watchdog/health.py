"""Pluggable host/device health checks run by the rank monitor.

A copy of ``tpu_resiliency/watchdog/health.py`` whose device checks run on the CUDA
card: the JAX package's ``TpuRuntimeCheck`` becomes :class:`CudaRuntimeCheck`, and
:class:`DeviceLivenessCheck` runs the port's liveness probe. Analogue of the
reference's ``shared_utils/health_check.py`` (``GPUHealthCheck:148``,
``NicHealthCheck:306``):

- :class:`DeviceLivenessCheck` — submits tiny device work under a watchdog thread
  (must run in a process that owns the card; workers use it inside restart health
  checks, see ``inprocess/health_check``),
- :class:`CudaRuntimeCheck` — device inventory and device-memory pressure, read
  through the CUDA runtime of the process that owns the card,
- :class:`SysfsCounterCheck` — watches a sysfs error-counter delta, the generalization
  of the reference's IB ``link_downed`` monitoring (``health_check.py:527-559``); the
  path template is injectable so tests fake the counter exactly as the reference does
  (``health_check.py:325``),
- :class:`CallbackHealthCheck` — wraps any ``() -> bool``.

All checks expose sync ``__call__() -> bool`` and can be polled periodically by the
monitor with an ``on_failure`` callback (reference ``async_check`` loop,
``health_check.py:148-303``).
"""

from __future__ import annotations

import abc
import glob
import threading
import time
from typing import Any, Callable, Optional

from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)


class HealthCheck(abc.ABC):
    @abc.abstractmethod
    def __call__(self) -> bool:
        """True = healthy."""

    def describe(self) -> str:
        return type(self).__name__


class CallbackHealthCheck(HealthCheck):
    def __init__(self, fn: Callable[[], bool], name: str = "callback"):
        self._fn = fn
        self._name = name

    def __call__(self) -> bool:
        try:
            return bool(self._fn())
        except Exception:
            log.exception("health check %s raised", self._name)
            return False

    def describe(self) -> str:
        return self._name


class DeviceLivenessCheck(HealthCheck):
    """Two tiny launches, each followed by a synchronize, under a timeout thread
    (the reference ``CudaHealthCheck`` double-sync analogue,
    ``inprocess/health_check.py:70-110``). ``device=None`` means the card;
    ``device="cpu"`` probes the CPU."""

    def __init__(self, timeout: float = 60.0, device: Any = None):
        self.timeout = timeout
        self.device = device

    def __call__(self) -> bool:
        from tpu_resiliency_torch.platform.device import device_liveness_probe

        return device_liveness_probe(timeout=self.timeout, device=self.device)


class SysfsCounterCheck(HealthCheck):
    """Healthy while monitored counters do not increase between polls.

    ``path_glob``: glob of counter files (each containing one integer). The first poll
    snapshots baselines; any later increase marks unhealthy (sticky until ``reset``) —
    the failed source names are recorded in ``failed`` so policy layers can exclude
    the right failure domain. Subclasses override :meth:`_sources` to change how
    counters are discovered/named (see :class:`IciLinkCheck`).
    """

    def __init__(self, path_glob: str = ""):
        self.path_glob = path_glob
        self._baseline: Optional[dict[str, int]] = None
        self.failed: list[str] = []

    def _sources(self) -> dict[str, str]:
        """Counter name -> file path."""
        return {p: p for p in sorted(glob.glob(self.path_glob))}

    def _read(self) -> dict[str, int]:
        values = {}
        for name, path in self._sources().items():
            try:
                with open(path) as f:
                    values[name] = int(f.read().strip() or 0)
            except (OSError, ValueError):
                continue
        return values

    def reset(self) -> None:
        self._baseline = None
        self.failed = []

    def __call__(self) -> bool:
        current = self._read()
        if self._baseline is None:
            self._baseline = current
            return True
        for name, value in current.items():
            if value > self._baseline.get(name, value):
                log.error("counter increased: %s %d -> %d",
                          name, self._baseline.get(name, 0), value)
                if name not in self.failed:
                    self.failed.append(name)
        self._baseline.update(current)
        return not self.failed


class CudaRuntimeCheck(HealthCheck):
    """CUDA runtime state: device inventory + device-memory pressure.

    The analogue of the reference's NVML device/recovery-state poll
    (``shared_utils/health_check.py:148-303``), read through the CUDA runtime: the
    check must run in a process that owns the card (the worker — wire it into the
    in-process restart health chain or poll it from the train loop). A rank-monitor
    process never creates a CUDA context, and each device this check reads gets one
    in the calling process.

    Unhealthy when: the runtime can no longer count devices, the visible device
    count drops below ``expect_devices``, or any device's memory pressure exceeds
    ``hbm_usage_threshold`` (``1 - free/total``, from ``torch.cuda.mem_get_info``).

    ``device=None`` means the card, and construction raises without one. The CPU has
    no device inventory: ``device="cpu"`` needs ``device_count`` and
    ``mem_get_info`` (``index -> (free, total)``) from the caller, which also
    replace the runtime's on the card.
    """

    def __init__(
        self,
        expect_devices: Optional[int] = None,
        hbm_usage_threshold: float = 0.98,
        device: Any = None,
        device_count: Optional[Callable[[], int]] = None,
        mem_get_info: Optional[Callable[[int], tuple[int, int]]] = None,
    ):
        from tpu_resiliency_torch.platform.device import resolve_device

        self.device = resolve_device(device)
        if self.device.type != "cuda" and (device_count is None or mem_get_info is None):
            raise ValueError(
                "CudaRuntimeCheck on the CPU needs device_count and mem_get_info"
            )
        self.expect_devices = expect_devices
        self.hbm_usage_threshold = hbm_usage_threshold
        self._device_count = device_count
        self._mem_get_info = mem_get_info
        self.last_failure: Optional[str] = None

    def _count(self) -> int:
        if self._device_count is not None:
            return self._device_count()
        import torch

        return torch.cuda.device_count()

    def _memory(self, index: int) -> tuple[int, int]:
        if self._mem_get_info is not None:
            return self._mem_get_info(index)
        import torch

        return torch.cuda.mem_get_info(index)

    def __call__(self) -> bool:
        self.last_failure = None
        try:
            count = self._count()
        except Exception as e:
            self.last_failure = f"device enumeration failed: {e!r}"
            log.error(self.last_failure)
            return False
        if not count:
            self.last_failure = "no local devices visible"
            log.error(self.last_failure)
            return False
        if self.expect_devices is not None and count < self.expect_devices:
            self.last_failure = (
                f"device count dropped: {count} < expected {self.expect_devices}"
            )
            log.error(self.last_failure)
            return False
        for index in range(count):
            try:
                free, total = self._memory(index)
            except Exception as e:
                self.last_failure = f"memory query of device {index} failed: {e!r}"
                log.error(self.last_failure)
                return False
            if not total:
                continue
            usage = 1.0 - free / total
            if usage > self.hbm_usage_threshold:
                self.last_failure = (
                    f"device memory pressure on device {index}: {usage:.1%} > "
                    f"{self.hbm_usage_threshold:.0%} ({total - free}/{total} bytes)"
                )
                log.error(self.last_failure)
                return False
        return True

    def describe(self) -> str:
        return f"CudaRuntimeCheck({self.last_failure or 'ok'})"


class HostMemoryCheck(HealthCheck):
    """Host memory pressure: unhealthy when ``MemAvailable / MemTotal`` falls below
    ``min_available_fraction`` — an early signal before the OOM killer takes a
    worker (the host-side analogue of device-memory health). ``meminfo_path`` is
    injectable so tests fake the kernel file, like the reference's
    ``link_down_path_template`` (``health_check.py:325``)."""

    def __init__(
        self,
        min_available_fraction: float = 0.05,
        meminfo_path: str = "/proc/meminfo",
    ):
        self.min_available_fraction = min_available_fraction
        self.meminfo_path = meminfo_path

    def _read(self) -> Optional[tuple[int, int]]:
        try:
            fields = {}
            with open(self.meminfo_path) as f:
                for line in f:
                    name, _, rest = line.partition(":")
                    fields[name.strip()] = rest
            total = int(fields["MemTotal"].split()[0])
            avail = int(fields["MemAvailable"].split()[0])
            return avail, total
        except (OSError, KeyError, ValueError, IndexError):
            return None

    def __call__(self) -> bool:
        parsed = self._read()
        if parsed is None:
            return True  # unreadable meminfo must not take the job down
        avail, total = parsed
        frac = avail / max(total, 1)
        if frac < self.min_available_fraction:
            log.error(
                "host memory pressure: %.1f%% available < %.1f%% floor",
                frac * 100, self.min_available_fraction * 100,
            )
            return False
        return True


class IciLinkCheck(SysfsCounterCheck):
    """Per-link interconnect error monitoring with topology mapping.

    The analogue of the reference's ``NicHealthCheck`` (GPU→NIC mapping via PCI-tree
    walk + IB ``link_downed`` counter delta, ``health_check.py:352-465,527-559``),
    generalized for TPU hosts: ``device_glob`` discovers this host's accelerator
    device nodes (e.g. ``/sys/class/accel/accel*`` or a vfio path), and
    ``link_down_path_template`` maps each to its link-error counter file with
    ``{device}`` substituted — injectable so tests fake the counters exactly as the
    reference does (``link_down_path_template``, ``:325``). Delta/sticky semantics
    come from :class:`SysfsCounterCheck`; ``failed_links`` names the bad links so
    the policy layer can exclude the right failure domain.
    """

    def __init__(
        self,
        device_glob: str,
        link_down_path_template: str,
    ):
        super().__init__()
        self.device_glob = device_glob
        self.template = link_down_path_template

    def discover(self) -> dict[str, str]:
        """device name -> counter path, for every discovered device whose counter
        file exists."""
        import os

        out = {}
        for dev_path in sorted(glob.glob(self.device_glob)):
            name = os.path.basename(dev_path.rstrip("/"))
            counter = self.template.format(device=name)
            if os.path.exists(counter):
                out[name] = counter
        return out

    _sources = discover

    @property
    def failed_links(self) -> list[str]:
        return self.failed

    def describe(self) -> str:
        if self.failed:
            return f"IciLinkCheck(failed={self.failed})"
        return "IciLinkCheck"


def checks_from_config(cfg) -> list[HealthCheck]:
    """Build the config-enabled built-in checks (the reference enables its GPU/NIC
    checks the same way, ``shared_utils/health_check.py`` via FT config)."""
    checks: list[HealthCheck] = []
    if getattr(cfg, "host_memory_min_fraction", None):
        checks.append(HostMemoryCheck(cfg.host_memory_min_fraction))
    glob_set = bool(getattr(cfg, "ici_link_device_glob", None))
    tmpl_set = bool(getattr(cfg, "ici_link_down_path_template", None))
    if glob_set != tmpl_set:
        # Half-configured monitoring must fail loudly, not silently not-watch.
        raise ValueError(
            "ici_link_device_glob and ici_link_down_path_template must be set "
            "together (got only one)"
        )
    if glob_set:
        checks.append(
            IciLinkCheck(cfg.ici_link_device_glob, cfg.ici_link_down_path_template)
        )
    return checks


class PeriodicHealthMonitor:
    """Polls a set of checks on an interval in a daemon thread; fires ``on_failure``
    once per failed check (reference async_check loop)."""

    def __init__(
        self,
        checks: list[HealthCheck],
        interval: float,
        on_failure: Callable[[HealthCheck], None],
    ):
        self.checks = list(checks)
        self.interval = interval
        self.on_failure = on_failure
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._failed: set[int] = set()

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, name="health-monitor", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            for i, check in enumerate(self.checks):
                if i in self._failed:
                    continue
                if not check():
                    self._failed.add(i)
                    try:
                        self.on_failure(check)
                    except Exception:
                        log.exception("health on_failure callback failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
