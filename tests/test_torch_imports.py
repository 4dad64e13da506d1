"""The port stands alone: it imports neither JAX nor the JAX package, and its entry
points run on the CUDA card unless the caller asks for the CPU."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tpu_resiliency_torch
from tpu_resiliency_torch.platform import device as port_device
from tpu_resiliency_torch.telemetry.convert import telemetry_state_from_numpy
from tpu_resiliency_torch.telemetry.detector import Detector
from tpu_resiliency_torch.telemetry.device_profiler import DeviceTimeProfiler
from tpu_resiliency_torch.telemetry.reporting import ReportGenerator
from tpu_resiliency_torch.telemetry.ring_buffer import DeviceRings
from tpu_resiliency_torch.telemetry.sharded import MeshTelemetry

PACKAGE_DIR = Path(tpu_resiliency_torch.__file__).parent
REPO_ROOT = PACKAGE_DIR.parent


def _module_names():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PACKAGE_DIR)], prefix="tpu_resiliency_torch.")
    )


#: Modules of the straggler-detection slice, each imported by the subprocess check.
SLICE_MODULES = (
    "tpu_resiliency_torch.exceptions",
    "tpu_resiliency_torch.utils.logging",
    "tpu_resiliency_torch.utils.events",
    "tpu_resiliency_torch.watchdog.data",
    "tpu_resiliency_torch.telemetry.statistics",
    "tpu_resiliency_torch.telemetry.name_registry",
    "tpu_resiliency_torch.telemetry.interval_tracker",
    "tpu_resiliency_torch.telemetry.ring_buffer",
    "tpu_resiliency_torch.telemetry.detector",
    "tpu_resiliency_torch.telemetry.device_profiler",
    "tpu_resiliency_torch.telemetry.policy",
    "tpu_resiliency_torch.integrations",
    "tpu_resiliency_torch.integrations.loop",
    "tpu_resiliency_torch.integrations.straggler_callback",
)


def test_importing_every_module_loads_no_jax():
    names = ["tpu_resiliency_torch", *_module_names()]
    assert "tpu_resiliency_torch.ops.scoring_kernels" in names
    assert set(SLICE_MODULES) <= set(names)
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'tpu_resiliency' or m.startswith('tpu_resiliency.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_file_imports_jax_or_the_jax_package():
    """Also covers imports inside functions, which the subprocess check never runs."""
    files = {str(p.relative_to(REPO_ROOT).with_suffix("")).replace("/", ".")
             for p in PACKAGE_DIR.rglob("*.py")}
    assert {m if m in files else m + ".__init__" for m in SLICE_MODULES} <= files
    for path in PACKAGE_DIR.rglob("*.py"):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                root = mod.split(".")[0]
                assert root not in ("jax", "jaxlib", "tpu_resiliency"), f"{path}: imports {mod}"


ENTRY_POINTS = {
    "DeviceRings": lambda **kw: DeviceRings.create(2, 4, **kw),
    "DeviceTimeProfiler": lambda **kw: DeviceTimeProfiler(**kw),
    "MeshTelemetry": lambda **kw: MeshTelemetry(8, **kw),
    "ReportGenerator": lambda **kw: ReportGenerator(8, 2, **kw),
    "telemetry_state_from_numpy": lambda **kw: telemetry_state_from_numpy(
        np.zeros((4, 8, 2), np.float32), np.zeros((8, 2), np.int32), 0,
        np.ones(8, np.float32), np.full((8, 2), np.inf, np.float32), **kw,
    ),
    "resolve_device": lambda **kw: port_device.resolve_device(**kw),
}


def _device_of(obj):
    if isinstance(obj, torch.device):
        return obj
    return getattr(obj, "device", None) or obj.data.device


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    make = ENTRY_POINTS[name]
    if torch.cuda.is_available():
        assert _device_of(make()).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert _device_of(make(device="cpu")).type == "cpu"


def test_detector_defaults_to_the_card():
    try:
        if torch.cuda.is_available():
            Detector.initialize()
            assert Detector.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                Detector.initialize()
            assert not Detector.initialized
        Detector.shutdown()
        Detector.initialize(device="cpu")
        assert Detector.device.type == "cpu"
    finally:
        Detector.shutdown()


def test_mesh_telemetry_over_a_group_defaults_to_the_card():
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                MeshTelemetry(8, group=group)
        mt = MeshTelemetry(8, group=group, device="cpu")
        assert mt.device.type == "cpu" and mt.local_ranks == 8
        with pytest.raises(TypeError, match="process group"):
            MeshTelemetry(8, group=object(), device="cpu")
    finally:
        dist.destroy_process_group()


def test_platform_kind_names_where_the_default_runs():
    assert port_device.platform_kind() == ("gpu" if torch.cuda.is_available() else "cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        port_device.resolve_device("meta")


def test_chip_smoke_prints_no_result_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(REPO_ROOT / "chip_smoke.py")], cwd=REPO_ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
