"""Device resolution, card identity and liveness for the port.

Port of ``tpu_resiliency/platform/device.py``: device resolution, the local device
count, the visibility variables handed to spawned workers, the liveness probe the
health checks run, the card topology (``probe_topology``), the compile-cache and
platform environment a worker applies (``apply_platform_env``), and the warm spares'
runtime warmup (``warm_runtime``). Every public entry point of the port takes
``device=None``, which means the CUDA card: without one it raises instead of running
elsewhere. The CPU runs the plain PyTorch path only when the caller asks for it with
``device="cpu"``.

``make_mesh`` builds a ``torch.distributed.device_mesh.DeviceMesh`` over ranks of the
default process group, where the reference builds a ``jax.sharding.Mesh`` over
devices.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import threading
from typing import Any, Optional, Sequence

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``. Raises when a
    CUDA device is asked for and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; the port runs on 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def platform_kind() -> str:
    """'gpu' | 'cpu' — where the port's default device would run."""
    return "gpu" if torch.cuda.is_available() else "cpu"


def card_name_and_power_limit() -> str:
    """The first card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    lines = out.stdout.strip().splitlines()
    if not lines:
        raise RuntimeError("nvidia-smi listed no card")
    return lines[0].strip()


def local_device_count() -> int:
    """CUDA cards visible to this process (0 without a card)."""
    return torch.cuda.device_count()


def process_index() -> int:
    """This process's rank in the default process group (0 without one)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """Processes in the default process group (1 without one)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    """One accelerator device and where it lives."""

    device_id: int
    process_index: int
    platform: str
    device_kind: str
    coords: Optional[tuple[int, ...]]  # interconnect coordinates (none on a CUDA card)
    core_on_chip: Optional[int]


@dataclasses.dataclass(frozen=True)
class Topology:
    """Snapshot of the devices this process sees."""

    devices: tuple[DeviceInfo, ...]
    num_processes: int

    @property
    def num_devices(self) -> int:
        return len(self.devices)

    def devices_on_host(self, proc: int) -> list[DeviceInfo]:
        return [d for d in self.devices if d.process_index == proc]

    def host_of_device(self, device_id: int) -> int:
        for d in self.devices:
            if d.device_id == device_id:
                return d.process_index
        raise KeyError(device_id)

    def hosts(self) -> list[int]:
        return sorted({d.process_index for d in self.devices})


def probe_topology() -> Topology:
    """The CUDA cards this process sees, from ``torch.cuda`` (the JAX package reads
    the global device list; a CUDA process sees only its host's cards, so each is
    placed at this process's rank). Empty without a card."""
    proc = process_index()
    infos = tuple(
        DeviceInfo(device_id=i, process_index=proc, platform="gpu",
                   device_kind=torch.cuda.get_device_name(i), coords=None, core_on_chip=None)
        for i in range(torch.cuda.device_count())
    )
    return Topology(devices=infos, num_processes=process_count())


def make_mesh(axis_shapes: dict[str, int], *, devices: Optional[Sequence[int]] = None,
              device=None):
    """Build a ``DeviceMesh`` with named axes over ranks of the default process group.

    ``axis_shapes`` maps axis name → size in declaration order, e.g.
    ``{"dp": 2, "tp": 4}``; the ranks (``devices``, all of the group's by default)
    fill the grid row-major. ``device=None`` means the card (an NCCL group; raises
    without a card); ``device="cpu"`` a gloo one. Raises ``ValueError`` when the
    shape does not match the ranks, as the reference does, and ``RuntimeError``
    without an initialized process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    names = tuple(axis_shapes.keys())
    shape = tuple(int(s) for s in axis_shapes.values())
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized torch.distributed process group")
    devs = list(devices) if devices is not None else list(range(dist.get_world_size()))
    n = int(np.prod(shape))
    if n != len(devs):
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {len(devs)}")
    grid = torch.tensor(devs, dtype=torch.int64).reshape(shape)
    return DeviceMesh(dev.type, grid, mesh_dim_names=names)


def apply_platform_env() -> None:
    """Apply what a worker's environment asks of this process before its first
    device use: the launcher-exported persistent compilation cache
    (``--compile-cache-dir``), so a restarted worker's first ``torch.compile``d step
    loads the previous round's artifacts. Card selection needs nothing here: it
    rides ``CUDA_VISIBLE_DEVICES`` and ``LOCAL_RANK``, which CUDA and the worker read
    themselves."""
    apply_compile_cache_env()


def apply_compile_cache_env() -> None:
    """Worker-side half of the ``--compile-cache-dir`` plumbing: point torch.compile's
    caches at the launcher-exported directory (after the integrity sweep).
    One-shot per process; a no-op when the launcher didn't export a dir."""
    from tpu_resiliency_torch.platform import compile_cache

    compile_cache.apply_from_env()


#: Modules a warm spare imports in :func:`warm_runtime`: the port's packages a worker
#: reaches, each importing torch and nothing of CUDA.
WARM_MODULES = (
    "torch.distributed",
    "torch.profiler",
    "tpu_resiliency_torch.ops.scoring_kernels",
    "tpu_resiliency_torch.telemetry",
    "tpu_resiliency_torch.integrations",
    "tpu_resiliency_torch.checkpoint",
    "tpu_resiliency_torch.inprocess",
    "tpu_resiliency_torch.watchdog",
)


def warm_runtime() -> dict[str, Any]:
    """Runtime warmup for parked warm spares (``launcher/park.py``
    ``--warm-spare-warmup runtime``): pre-pay what a worker's first steps cost that
    does NOT touch a card.

    A parked spare coexists with the round's live workers and, at promotion, with
    the *dying* worker whose card is still held, so it must not create a CUDA
    context (one holds device memory, and blocks on a hung card): device use stays
    strictly post-promotion. It imports ``WARM_MODULES``, opens the port's kernel
    libraries that are already built for the current sources (opening one touches
    no device; a library not built stays for the worker to build), and runs one
    small operation on the CPU to warm the dispatcher. Raises if CUDA was
    initialised after all, so the spare dies before its ready file exists.

    Must not mutate ``os.environ`` or ``sys.path`` (promotion parity contract).
    """
    import importlib

    from tpu_resiliency_torch.inprocess.tools.inject_fault import FAULT_KERNELS
    from tpu_resiliency_torch.ops import _build
    from tpu_resiliency_torch.ops.scoring_kernels import KERNEL_NAMES

    for name in WARM_MODULES:
        importlib.import_module(name)
    loaded = []
    for name in (*KERNEL_NAMES.values(), FAULT_KERNELS):
        if _build.is_built(name):  # never builds: a spare runs no nvcc
            _build.load(name)
            loaded.append(name)
    (torch.ones(8) + 1.0).sum().item()
    if torch.cuda.is_initialized():
        raise RuntimeError("warm_runtime initialised CUDA; a parked spare must not")
    return {"modules": len(WARM_MODULES), "kernels_loaded": loaded, "cpu_init": True,
            "cuda_initialized": False}


def visible_device_env() -> dict[str, str]:
    """Environment variables that pin card visibility for spawned worker processes."""
    return {k: os.environ[k] for k in ("CUDA_VISIBLE_DEVICES", "CUDA_DEVICE_ORDER")
            if k in os.environ}


#: The CPU's stand-in for a dead device runtime: ``inject_fault``'s
#: ``DEVICE_ERROR`` on ``device="cpu"`` sets it and ``heal_device_error`` clears it.
#: On the card the fault is a real sticky CUDA error, which nothing in the process
#: can clear.
_cpu_runtime_dead = False


def set_cpu_runtime_dead(dead: bool) -> None:
    global _cpu_runtime_dead
    _cpu_runtime_dead = dead


def tiny_launch(device) -> None:
    """One small launch on ``device`` and a wait for it: an addition on a few
    elements, then ``torch.cuda.synchronize`` on the card. Raises when the runtime
    is dead: a sticky CUDA error on the card, the dead mark on the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu" and _cpu_runtime_dead:
        raise RuntimeError("the CPU device runtime was marked dead (injected DEVICE_ERROR)")
    x = torch.ones(8, dtype=torch.float32, device=dev)
    (x + 1.0).sum()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_liveness_probe(timeout: float = 30.0, device=None) -> bool:
    """Whether the device still executes and completes work: two tiny launches,
    each followed by a wait for the device, in a watchdog thread, so a wedged device
    turns into ``False`` after ``timeout`` seconds instead of a forever-block
    (reference ``platform/device.py:228-258``). Device resolution happens inside the
    guarded thread too: when the runtime is dead enough that resolving or touching
    the card raises (a sticky CUDA error) or blocks, the answer is still ``False``,
    never an exception. ``device=None`` means the card."""
    result: dict[str, bool] = {}

    def _work():
        try:
            dev = resolve_device(device)
            for _ in range(2):
                tiny_launch(dev)
            result["ok"] = True
        except Exception:
            result["ok"] = False

    t = threading.Thread(target=_work, name="device-probe", daemon=True)
    t.start()
    t.join(timeout)
    return result.get("ok", False)
