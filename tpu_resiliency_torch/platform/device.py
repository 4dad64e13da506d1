"""Device resolution, card identity and liveness for the port.

Port of the parts of ``tpu_resiliency/platform/device.py`` the telemetry and
in-process restart slices need: device resolution, the local device count, the
visibility variables handed to spawned workers, and the liveness probe the health
checks run. Every public entry point of the port takes ``device=None``, which means
the CUDA card: without one it raises instead of running elsewhere. The CPU runs the
plain PyTorch path only when the caller asks for it with ``device="cpu"``.

``make_mesh``, ``probe_topology`` and ``warm_runtime`` are not ported yet.
"""

from __future__ import annotations

import os
import subprocess
import threading

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
