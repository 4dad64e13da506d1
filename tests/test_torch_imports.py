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
from tpu_resiliency_torch.telemetry.reporting import ReportGenerator
from tpu_resiliency_torch.telemetry.sharded import MeshTelemetry

PACKAGE_DIR = Path(tpu_resiliency_torch.__file__).parent
REPO_ROOT = PACKAGE_DIR.parent


def _module_names():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PACKAGE_DIR)], prefix="tpu_resiliency_torch.")
    )


def test_importing_every_module_loads_no_jax():
    names = ["tpu_resiliency_torch", *_module_names()]
    assert "tpu_resiliency_torch.ops.scoring_kernels" in names
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
