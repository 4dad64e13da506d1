"""Device resolution and card identity for the port.

Port of the part of ``tpu_resiliency/platform/device.py`` the telemetry slice needs.
Every public entry point of the port takes ``device=None``, which means the CUDA
card: without one it raises instead of running elsewhere. The CPU runs the plain
PyTorch path only when the caller asks for it with ``device="cpu"``.
"""

from __future__ import annotations

import subprocess

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
