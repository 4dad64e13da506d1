"""The port stands alone: it imports neither JAX nor the JAX package (its modules and
its host extensions, ``_ringstats`` and ``_probe_native``), and its entry points run on
the CUDA card unless the caller asks for the CPU."""

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
from tpu_resiliency_torch.inprocess import CudaHealthCheck
from tpu_resiliency_torch.models.moe import MoE, MoEConfig
from tpu_resiliency_torch.models.transformer import Transformer, TransformerConfig, rope_tables
from tpu_resiliency_torch.platform import device as port_device
from tpu_resiliency_torch.telemetry.convert import telemetry_state_from_numpy
from tpu_resiliency_torch.telemetry.detector import Detector
from tpu_resiliency_torch.telemetry.device_profiler import DeviceTimeProfiler
from tpu_resiliency_torch.telemetry.reporting import ReportGenerator
from tpu_resiliency_torch.telemetry.ring_buffer import DeviceRings
from tpu_resiliency_torch.telemetry.sharded import MeshTelemetry
from tpu_resiliency_torch.watchdog import CudaRuntimeCheck

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

#: Modules of the in-process restart slice, each imported by the subprocess check.
INPROCESS_MODULES = (
    "tpu_resiliency_torch.utils.location",
    "tpu_resiliency_torch.utils.tracing",
    "tpu_resiliency_torch.utils.opstats",
    "tpu_resiliency_torch.utils.flight_recorder",
    "tpu_resiliency_torch.platform.chaos",
    "tpu_resiliency_torch.platform.framing",
    "tpu_resiliency_torch.platform.store",
    "tpu_resiliency_torch.platform.shardstore",
    "tpu_resiliency_torch.platform.device",
    "tpu_resiliency_torch.platform.distributed",
    "tpu_resiliency_torch.watchdog.state_machine",
    "tpu_resiliency_torch.inprocess",
    "tpu_resiliency_torch.inprocess.abort",
    "tpu_resiliency_torch.inprocess.health_check",
    "tpu_resiliency_torch.inprocess.monitor_process",
    "tpu_resiliency_torch.inprocess.progress_watchdog",
    "tpu_resiliency_torch.inprocess.wrap",
    "tpu_resiliency_torch.inprocess.tools",
    "tpu_resiliency_torch.inprocess.tools.inject_fault",
)


#: Modules of the checkpoint slice, each imported by the subprocess check.
CHECKPOINT_MODULES = (
    "tpu_resiliency_torch.utils.timers",
    "tpu_resiliency_torch.platform.treecomm",
    "tpu_resiliency_torch.checkpoint",
    "tpu_resiliency_torch.checkpoint.format",
    "tpu_resiliency_torch.checkpoint.state_dict",
    "tpu_resiliency_torch.checkpoint.hollow_pickle",
    "tpu_resiliency_torch.checkpoint.staging",
    "tpu_resiliency_torch.checkpoint.async_core",
    "tpu_resiliency_torch.checkpoint.async_ckpt",
    "tpu_resiliency_torch.checkpoint.comm",
    "tpu_resiliency_torch.checkpoint.replication",
    "tpu_resiliency_torch.checkpoint.coding",
    "tpu_resiliency_torch.checkpoint.coding.rs",
    "tpu_resiliency_torch.checkpoint.coding.delta",
    "tpu_resiliency_torch.checkpoint.coding.strategy",
    "tpu_resiliency_torch.checkpoint.coldtier",
    "tpu_resiliency_torch.checkpoint.reshard",
    "tpu_resiliency_torch.checkpoint.local_manager",
    "tpu_resiliency_torch.integrations.checkpoint_callback",
)


#: Modules of the fault-tolerance slice, each imported by the subprocess check.
FT_MODULES = (
    "tpu_resiliency_torch.platform.ipc",
    "tpu_resiliency_torch.platform.wire",
    "tpu_resiliency_torch.platform.compile_cache",
    "tpu_resiliency_torch.utils.stackdump",
    "tpu_resiliency_torch.watchdog",
    "tpu_resiliency_torch.watchdog.config",
    "tpu_resiliency_torch.watchdog.timeouts",
    "tpu_resiliency_torch.watchdog.health",
    "tpu_resiliency_torch.watchdog.monitor_server",
    "tpu_resiliency_torch.watchdog.monitor_client",
    "tpu_resiliency_torch.integrations.ft_callbacks",
    "tpu_resiliency_torch.launcher",
    "tpu_resiliency_torch.launcher.errors",
    "tpu_resiliency_torch.launcher.proc",
    "tpu_resiliency_torch.launcher.rendezvous",
    "tpu_resiliency_torch.launcher.park",
    "tpu_resiliency_torch.launcher.agent",
    "tpu_resiliency_torch.launcher.launch",
    "tpu_resiliency_torch.examples",
    "tpu_resiliency_torch.examples.resilient_training",
    "tpu_resiliency_torch.examples.layered_restart",
)


#: Modules of the model slice, each imported by the subprocess check.
MODEL_MODULES = (
    "tpu_resiliency_torch.models",
    "tpu_resiliency_torch.models.transformer",
    "tpu_resiliency_torch.models.moe",
    "tpu_resiliency_torch.parallel",
    "tpu_resiliency_torch.parallel.mesh",
    "tpu_resiliency_torch.integrations.preemption",
    "tpu_resiliency_torch.integrations.dcp_adapter",
    "tpu_resiliency_torch.examples.preemption_train",
)

#: Modules of the parallel model slice, each imported by the subprocess check.
PARALLEL_MODULES = (
    "tpu_resiliency_torch.parallel.p2p",
    "tpu_resiliency_torch.parallel.ring_attention",
    "tpu_resiliency_torch.parallel.pipeline",
    "tpu_resiliency_torch.examples.moe_pipeline_training",
    "tpu_resiliency_torch.examples.inprocess_restart_train",
    "tpu_resiliency_torch.examples.mesh_telemetry_training",
    "tpu_resiliency_torch.scripts",
    "tpu_resiliency_torch.scripts.bench_model",
)

#: Modules of the observability slice, each imported by the subprocess check.
OBSERVE_MODULES = (
    "tpu_resiliency_torch.utils.metrics",
    "tpu_resiliency_torch.utils.timeseries",
    "tpu_resiliency_torch.utils.goodput",
    "tpu_resiliency_torch.utils.byteflow",
    "tpu_resiliency_torch.tools",
    "tpu_resiliency_torch.tools.metrics_dump",
    "tpu_resiliency_torch.tools.events_summary",
    "tpu_resiliency_torch.telemetry.remediation",
    "tpu_resiliency_torch.launcher.autoscale",
    "tpu_resiliency_torch.telemetry.watchtower",
    "tpu_resiliency_torch.tools.alerts_cli",
    "tpu_resiliency_torch.launcher.incident",
    "tpu_resiliency_torch.tools.incident_report",
    "tpu_resiliency_torch.launcher.telemetry",
)

#: Modules of the last slice (fleet federation and the offline tools), each imported by
#: the subprocess check.
FLEET_MODULES = (
    "tpu_resiliency_torch.fleet",
    "tpu_resiliency_torch.fleet.registry",
    "tpu_resiliency_torch.fleet.aggregator",
    "tpu_resiliency_torch.fleet.server",
    "tpu_resiliency_torch.tools.fleetd",
    "tpu_resiliency_torch.tools.fleet_cli",
    "tpu_resiliency_torch.tools.trace_export",
    "tpu_resiliency_torch.tools.critpath",
    "tpu_resiliency_torch.tools.ckpt_info",
    "tpu_resiliency_torch.tools.store_info",
)

#: The repo-root programs ported last (``__graft_entry__`` and the scripts that ran on the
#: reference's modules), each imported by the subprocess check.
ROOT_MODULES = (
    "tpu_resiliency_torch.__graft_entry__",
    "tpu_resiliency_torch.scripts.bench_reshard",
    "tpu_resiliency_torch.scripts.chaos_soak",
    "tpu_resiliency_torch.scripts.bench_store",
    "tpu_resiliency_torch.scripts.bench_replication",
    "tpu_resiliency_torch.scripts.bench_fleet",
    "tpu_resiliency_torch.scripts.bench_ckpt_io",
    "tpu_resiliency_torch.bench",
    "tpu_resiliency_torch.scripts.bench_pallas_sweep",
)

ALL_SLICES = (SLICE_MODULES + INPROCESS_MODULES + CHECKPOINT_MODULES + FT_MODULES + MODEL_MODULES
              + PARALLEL_MODULES + OBSERVE_MODULES + FLEET_MODULES + ROOT_MODULES)


def test_importing_every_module_loads_no_jax():
    names = ["tpu_resiliency_torch", *_module_names()]
    assert "tpu_resiliency_torch.ops.scoring_kernels" in names
    assert set(ALL_SLICES) <= set(names)
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'ml_dtypes' or m.startswith('ml_dtypes.') or m == 'yaml'\n"
        "             or m == 'tpu_resiliency' or m.startswith('tpu_resiliency.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_native_loaders_load_no_jax():
    """The host extensions, loaded as the reference's tests load them, bring in neither
    JAX nor the JAX package, and carry the port's module names."""
    code = (
        "import sys\n"
        "from tpu_resiliency_torch import _probe_native, _ringstats\n"
        "from tpu_resiliency_torch.telemetry import ring_buffer as rb\n"
        "from tpu_resiliency_torch.inprocess.progress_watchdog import ProgressWatchdog\n"
        "assert rb._ringstats is _ringstats and rb.SignalRings(2, 4).native\n"
        "assert ProgressWatchdog(1.0, lambda k, t: None).native\n"
        "assert _ringstats.__name__ == 'tpu_resiliency_torch._ringstats'\n"
        "assert _probe_native.__name__ == 'tpu_resiliency_torch._probe_native'\n"
        "assert _ringstats.RingPool.__module__ == 'tpu_resiliency_torch._ringstats'\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'tpu_resiliency' or m.startswith('tpu_resiliency.'))\n"
        "print(bad)\n"
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
    assert {m if m in files else m + ".__init__"
            for m in ALL_SLICES} <= files
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
                assert root not in ("jax", "jaxlib", "ml_dtypes", "tpu_resiliency"), \
                    f"{path}: imports {mod}"


ENTRY_POINTS = {
    "CudaHealthCheck": lambda **kw: CudaHealthCheck(**kw),
    "DeviceRings": lambda **kw: DeviceRings.create(2, 4, **kw),
    "DeviceTimeProfiler": lambda **kw: DeviceTimeProfiler(**kw),
    "MeshTelemetry": lambda **kw: MeshTelemetry(8, **kw),
    "ReportGenerator": lambda **kw: ReportGenerator(8, 2, **kw),
    "telemetry_state_from_numpy": lambda **kw: telemetry_state_from_numpy(
        np.zeros((4, 8, 2), np.float32), np.zeros((8, 2), np.int32), 0,
        np.ones(8, np.float32), np.full((8, 2), np.inf, np.float32), **kw,
    ),
    "resolve_device": lambda **kw: port_device.resolve_device(**kw),
    "CudaRuntimeCheck": lambda **kw: CudaRuntimeCheck(
        device_count=lambda: 1, mem_get_info=lambda index: (1, 2), **kw),
    "Transformer": lambda **kw: Transformer(TransformerConfig.tiny(), **kw).embed,
    "MoE": lambda **kw: MoE(MoEConfig.tiny(), **kw).embed,
    "rope_tables": lambda **kw: rope_tables(TransformerConfig.tiny(), 4, **kw)[0],
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


@pytest.mark.parametrize("argv", [
    ["-m", "tpu_resiliency_torch.examples.moe_pipeline_training", "--steps", "1"],
    ["-m", "tpu_resiliency_torch.examples.inprocess_restart_train", "--world", "1",
     "--steps", "1"],
    [str(PACKAGE_DIR / "examples" / "mesh_telemetry_training.py")],
], ids=["moe_pipeline_training", "inprocess_restart_train", "mesh_telemetry_training"])
def test_parallel_examples_run_on_the_card_by_default(argv):
    """Without ``--device`` each parallel-path example asks for the card, and fails
    without one (``chip_smoke.py`` ``parallel_path`` runs them on it)."""
    if torch.cuda.is_available():
        pytest.skip("the card is here: chip_smoke.py parallel_path runs the examples on it")
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", TPU_RESILIENCY_LOG_LEVEL="WARNING",
               PYTHONPATH=str(REPO_ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, *argv], cwd=REPO_ROOT, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stdout + r.stderr
