"""The harness: finds everything of one cell by name and runs it once.

``BENCHMARK.json`` names the cells, metrics and configurations. Everything else is a
file of its own, found by name:

- ``configs/<config>.json`` (through the configuration's ``file``): sizes and
  settings, as run;
- ``traffic/<traffic>.json``: the mix's parameters, and the ``loop`` that runs it
  (``loops/<loop>.py``, whose ``run`` returns an :class:`Outcome`);
- ``limits/<workload>.json``: the limit of every number that decides ``correct``;
- ``layer_metrics/<metric>.py``: one reader per per-layer metric, ``read(ctx)``
  returning a number, or ``None`` where the run gives it nothing to read.

A new cell, mix, configuration or per-layer metric is new files and entries; no
file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path

from benchmark.checks import load_limits
from benchmark.trace import Tracer

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
#: Top-level modules the run must not hold once its window has closed: JAX and the
#: JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_resiliency")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def spec(checkout: Path = CHECKOUT) -> dict:
    return json.loads((checkout / "BENCHMARK.json").read_text())


def reported_in(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(name: str, checkout: Path = CHECKOUT, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``bench`` (by default the checkout's ``BENCHMARK.json``)."""
    bench = bench or spec(checkout)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(by_name)}")
    w = by_name[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name,
        chips=w["chips"],
        config=json.loads((checkout / cfg["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=load_limits(name),
        end_to_end=[m for m in bench["end_to_end"] if reported_in(m, name)],
        per_layer=[m for m in bench["per_layer"] if reported_in(m, name)],
    )


def reader(metric: str):
    """The ``read`` function of ``layer_metrics/<metric>.py``."""
    path = HERE / "layer_metrics" / f"{metric}.py"
    mod_name = "benchmark.layer_metrics." + metric.replace(".", "_").replace("-", "_")
    module_spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.read


@dataclasses.dataclass
class ReadContext:
    """What a per-layer reader reads: the trace (``None`` if the run had none), the
    loop's counters and the cell."""

    trace: object
    counters: dict
    cell: Cell


def run_cell(c: Cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """One run of ``c``: the result line's fields, the device's name left to the
    caller. ``t0`` is the wall clock at the process's start."""
    import torch

    tracer = Tracer(trace, device)
    tracer.warm()
    loop = importlib.import_module(f"benchmark.loops.{c.traffic['loop']}")
    outcome = loop.run(c, seed, seconds, tracer, device)
    units = {m["name"]: m["unit"] for m in c.end_to_end + c.per_layer}
    values: dict[str, float] = {}
    if trace:
        ctx = ReadContext(tracer.data, outcome.counters, c)
        for m in c.per_layer:
            value = reader(m["name"])(ctx)
            if value is not None:
                values[m["name"]] = value
    else:
        values.update(outcome.end_to_end)
        values["setup_s"] = outcome.window_start - t0
    cuda = torch.device(device).type == "cuda"
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": c.chips, "memory_peak_bytes": outcome.memory_peak_bytes}
    result = {
        "correct": outcome.attempted > 0 and all(ch.ok for ch in outcome.checks),
        "attempted": outcome.attempted,
        "failed": outcome.failed,
        "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()
                    if k in units},
        "device": device_info,
    }
    if trace and tracer.data is not None:
        device_info["busy_s"] = tracer.data.busy_s()
        device_info["window_s"] = tracer.data.window_s
        result["breakdown"] = tracer.data.breakdown()
    result["checks"] = {ch.name: {"value": ch.value, "limit": ch.limit}
                        for ch in outcome.checks}
    return result


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's, compared
    whole (``tpu_resiliency_torch`` is not ``tpu_resiliency``)."""
    return sorted({name.partition(".")[0] for name in sys.modules} & set(FORBIDDEN))
