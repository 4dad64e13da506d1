"""Count the trace records a ``DeviceTimeProfiler`` window loses, by how it opens.

On the H100 the trace of a ``torch.profiler`` session can miss the records the card
produces first after the session starts. This probe drives config 4's step (one
``[4096, 64]`` push into ``MeshTelemetry(window 32)`` and a report, each in its own
``record_function`` region) in ``--windows`` profiler windows per way of opening
one, interleaved, and counts per opening the windows that lost the ``loop`` kernel's
record, the windows short of the most kernel records any window held, and the
regions lost. The openings: ``plain`` (none), ``copies`` (three device-to-device
copies and a synchronize), ``copies_5ms`` and ``copies_20ms`` (then a pause),
``sleep_20ms`` (a synchronize and a pause). ``DeviceTimeProfiler`` opens every window
on the card with a synchronize and ``DeviceTimeProfiler.SETTLE_S`` (20 ms).

Run on a CUDA card from the root of a checkout::

    python -m tpu_resiliency_torch.telemetry.window_probe [--windows 60]

It prints the card's name and power limit, then one JSON object.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from tpu_resiliency_torch.platform.device import card_name_and_power_limit
from tpu_resiliency_torch.telemetry.device_profiler import DeviceTimeProfiler
from tpu_resiliency_torch.telemetry.sharded import MeshTelemetry

R, S, W = 4096, 64, 32  # config 4
LOOP_KERNEL = "median_weights_network_kernel"  # the loop kernel at W <= 64
OPENINGS = {  # (device-to-device copies, pause in seconds)
    "plain": (0, 0.0),
    "copies": (3, 0.0),
    "copies_5ms": (3, 0.005),
    "sleep_20ms": (0, 0.02),
    "copies_20ms": (3, 0.02),
}


def run(windows: int) -> dict:
    dev = torch.device("cuda")
    rows = torch.rand(W, R, S, device=dev) * 0.4 + 0.8
    mt = MeshTelemetry(R, signal_names=tuple(f"s{i}" for i in range(S)), window=W, device=dev)
    state = mt.init_state()
    for i in range(W):
        mt.push(state, rows[i])
    warm = torch.zeros(2, device=dev)

    def step(i):
        nonlocal state
        with torch.profiler.record_function("push"):
            mt.push(state, rows[i % W])
        with torch.profiler.record_function("report"):
            state, _ = mt.generate_report(state)
        torch.cuda.synchronize()

    def opening(copies, pause):
        def settle():
            for _ in range(copies):
                warm[1:].copy_(warm[:1])
            if copies or pause:
                torch.cuda.synchronize()
            if pause:
                time.sleep(pause)
        return settle

    for i in range(5):
        step(i)
    kernels = {name: [] for name in OPENINGS}
    regions = {name: [] for name in OPENINGS}
    loop_lost = dict.fromkeys(OPENINGS, 0)
    t0 = time.perf_counter()
    for n in range(windows):
        for name, (copies, pause) in OPENINGS.items():
            prof = DeviceTimeProfiler(collect_ops=True, device=dev)
            prof._settle = opening(copies, pause)
            prof.start()
            step(n)
            prof.stop()
            ops, progs = prof.drain_ops(), prof.drain()
            loop_lost[name] += 1 - len(ops.get(LOOP_KERNEL, []))
            kernels[name].append(sum(map(len, ops.values())))
            regions[name].append(sum(map(len, progs.values())))
    most = max(max(k) for k in kernels.values())
    out = {}
    for name in OPENINGS:
        k = np.asarray(kernels[name])
        out[name] = {
            "windows": windows,
            "loop_lost": loop_lost[name],
            "kernels_max": int(k.max()),
            "windows_short_of_max": int((k < most).sum()),
            "kernels_lost_total": int((most - k).sum()),
            "regions_lost": int((2 * windows) - sum(regions[name])),
        }
    return {"probe": out, "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=60)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the probe needs a CUDA card")
    print(card_name_and_power_limit(), flush=True)
    print(json.dumps(run(args.windows)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
