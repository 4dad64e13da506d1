"""Command-line measurements of the port (``python -m tpu_resiliency_torch.scripts.<name>``).

Every script runs on the card unless ``--device cpu`` is given, and each JSON line it
prints carries :func:`device_fields`. Device spans are timed on CUDA events
(:class:`SpanTimer`); a CPU run times them on the host's clock and says so
(``timer``), and gives no device metric."""

from __future__ import annotations

import functools
import os
import time

#: Where a script writes its result files by default: the checkout's ``build/``,
#: which git ignores, never over the reference's committed ``BENCH_*.json``.
DEFAULT_OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "tpu_resiliency_torch", "bench")


@functools.lru_cache(maxsize=None)
def _card() -> str:
    from tpu_resiliency_torch.platform.device import card_name_and_power_limit

    return card_name_and_power_limit()


def device_fields(dev) -> dict:
    """``backend`` (``"cuda"`` / ``"cpu"``), ``device_kind`` and ``card``, the card's name
    and power limit as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    gives them (``None`` on the CPU)."""
    import torch

    cuda = dev.type == "cuda"
    return {"backend": dev.type,
            "device_kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "card": _card() if cuda else None}


class SpanTimer:
    """Times one span: between two CUDA events on the card (what the card took for the
    work queued in it, read after a synchronize), on the host's clock on the CPU."""

    def __init__(self, dev):
        import torch

        self.torch, self.dev = torch, dev
        self.cuda = dev.type == "cuda"
        self.timer = "cuda_events" if self.cuda else "host_clock"

    def __enter__(self):
        if self.cuda:
            self.start = self.torch.cuda.Event(enable_timing=True)
            self.end = self.torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.end.record()
            self.end.synchronize()
            self.ms = self.start.elapsed_time(self.end)
        else:
            self.ms = (time.perf_counter() - self.t0) * 1e3
        return False
