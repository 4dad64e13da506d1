"""The port map: every module of the JAX package ``tpu_resiliency`` either has a
counterpart at the same path under ``tpu_resiliency_torch/``, is ported under another
name (``RENAMED``), or stands on the explicit not-yet-ported list below. The list
shrinks as slices land; a module that gains a counterpart must leave it.

The walk lists modules with ``pkgutil`` from the package directories, importing
nothing.
"""

import pkgutil
from pathlib import Path

import pytest

import tpu_resiliency
import tpu_resiliency_torch

REFERENCE_DIR = Path(tpu_resiliency.__file__).parent
PORT_DIR = Path(tpu_resiliency_torch.__file__).parent

#: Reference modules ported under another name.
RENAMED = {
    "tpu_resiliency.ops.scoring_pallas": "tpu_resiliency_torch.ops.scoring_kernels",
    "tpu_resiliency.integrations.orbax_adapter": "tpu_resiliency_torch.integrations.dcp_adapter",
}

#: Names of ported reference modules that the port answers by other means.
ANSWERED = {
    "tpu_resiliency.telemetry.scoring.score_round_jit": "score_round(group=...)",
    "tpu_resiliency.telemetry.scoring.make_sharded_scorer": "score_round(group=...)",
    "tpu_resiliency.telemetry.scoring.score_round_sharded": "score_round(group=...)",
    "tpu_resiliency.inprocess.health_check.JaxHealthCheck": "CudaHealthCheck",
    "tpu_resiliency.inprocess.abort.AbortJaxDistributed": "AbortTorchDistributed",
    "tpu_resiliency.watchdog.health.TpuRuntimeCheck": "CudaRuntimeCheck",
    "tpu_resiliency.integrations.orbax_adapter.OrbaxCheckpointCallback": "DcpCheckpointCallback",
}

#: Reference modules with no counterpart in the port yet, by package.
NOT_YET_PORTED = (
    # fleet
    "tpu_resiliency.fleet",
    "tpu_resiliency.fleet.aggregator",
    "tpu_resiliency.fleet.registry",
    "tpu_resiliency.fleet.server",
    # tools
    "tpu_resiliency.tools.ckpt_info",
    "tpu_resiliency.tools.critpath",
    "tpu_resiliency.tools.fleet_cli",
    "tpu_resiliency.tools.fleetd",
    "tpu_resiliency.tools.store_info",
    "tpu_resiliency.tools.trace_export",
)

#: The modules of the straggler-detection slice: each has its counterpart.
STRAGGLER_SLICE = (
    "tpu_resiliency.exceptions",
    "tpu_resiliency.utils.logging",
    "tpu_resiliency.utils.events",
    "tpu_resiliency.telemetry.statistics",
    "tpu_resiliency.telemetry.name_registry",
    "tpu_resiliency.telemetry.interval_tracker",
    "tpu_resiliency.telemetry.ring_buffer",
    "tpu_resiliency.telemetry.scoring",
    "tpu_resiliency.telemetry.sharded",
    "tpu_resiliency.telemetry.detector",
    "tpu_resiliency.telemetry.device_profiler",
    "tpu_resiliency.telemetry.policy",
    "tpu_resiliency.integrations.loop",
    "tpu_resiliency.integrations.straggler_callback",
)


#: The modules of the in-process restart slice and the support it stands on: each
#: has its counterpart.
INPROCESS_SLICE = (
    "tpu_resiliency.utils.location",
    "tpu_resiliency.utils.tracing",
    "tpu_resiliency.utils.opstats",
    "tpu_resiliency.utils.flight_recorder",
    "tpu_resiliency.platform.chaos",
    "tpu_resiliency.platform.framing",
    "tpu_resiliency.platform.store",
    "tpu_resiliency.platform.shardstore",
    "tpu_resiliency.platform.device",
    "tpu_resiliency.platform.distributed",
    "tpu_resiliency.watchdog.state_machine",
    "tpu_resiliency.inprocess",
    "tpu_resiliency.inprocess.state",
    "tpu_resiliency.inprocess.attribution",
    "tpu_resiliency.inprocess.compose",
    "tpu_resiliency.inprocess.completion",
    "tpu_resiliency.inprocess.finalize",
    "tpu_resiliency.inprocess.initialize",
    "tpu_resiliency.inprocess.rank_assignment",
    "tpu_resiliency.inprocess.progress_watchdog",
    "tpu_resiliency.inprocess.monitor_thread",
    "tpu_resiliency.inprocess.coordination",
    "tpu_resiliency.inprocess.monitor_process",
    "tpu_resiliency.inprocess.nested_restarter",
    "tpu_resiliency.inprocess.abort",
    "tpu_resiliency.inprocess.health_check",
    "tpu_resiliency.inprocess.tools",
    "tpu_resiliency.inprocess.tools.inject_fault",
    "tpu_resiliency.inprocess.wrap",
)


#: The modules of the checkpoint slice and the support it stands on: each has its
#: counterpart.
CHECKPOINT_SLICE = (
    "tpu_resiliency.utils.timers",
    "tpu_resiliency.platform.treecomm",
    "tpu_resiliency.checkpoint",
    "tpu_resiliency.checkpoint.format",
    "tpu_resiliency.checkpoint.state_dict",
    "tpu_resiliency.checkpoint.staging",
    "tpu_resiliency.checkpoint.async_core",
    "tpu_resiliency.checkpoint.async_ckpt",
    "tpu_resiliency.checkpoint.comm",
    "tpu_resiliency.checkpoint.replication",
    "tpu_resiliency.checkpoint.coding",
    "tpu_resiliency.checkpoint.coding.rs",
    "tpu_resiliency.checkpoint.coding.delta",
    "tpu_resiliency.checkpoint.coding.strategy",
    "tpu_resiliency.checkpoint.coldtier",
    "tpu_resiliency.checkpoint.reshard",
    "tpu_resiliency.checkpoint.local_manager",
    "tpu_resiliency.integrations.checkpoint_callback",
)


#: The modules of the fault-tolerance slice (the rank monitor and its client, the
#: health checks, the FT callbacks, the compile cache and the in-job launcher) and the
#: support they stand on: each has its counterpart.
FT_SLICE = (
    "tpu_resiliency.platform.ipc",
    "tpu_resiliency.utils.stackdump",
    "tpu_resiliency.watchdog.config",
    "tpu_resiliency.watchdog.timeouts",
    "tpu_resiliency.watchdog.health",
    "tpu_resiliency.watchdog.monitor_server",
    "tpu_resiliency.watchdog.monitor_client",
    "tpu_resiliency.integrations.ft_callbacks",
    "tpu_resiliency.platform.compile_cache",
    "tpu_resiliency.launcher",
    "tpu_resiliency.launcher.errors",
    "tpu_resiliency.launcher.proc",
    "tpu_resiliency.launcher.rendezvous",
    "tpu_resiliency.launcher.park",
    "tpu_resiliency.launcher.agent",
    "tpu_resiliency.launcher.launch",
)


#: The modules of the model slice (the mesh, the dense and MoE families, preemption
#: agreement and the global checkpoint tier): each has its counterpart.
MODEL_SLICE = (
    "tpu_resiliency.models",
    "tpu_resiliency.models.transformer",
    "tpu_resiliency.models.moe",
    "tpu_resiliency.parallel",
    "tpu_resiliency.parallel.mesh",
    "tpu_resiliency.integrations.preemption",
    "tpu_resiliency.integrations.orbax_adapter",
)


#: The modules of the parallel model slice (ring attention and the pipeline schedule,
#: over the port's differentiable neighbour shift ``parallel/p2p.py``): each has its
#: counterpart.
PARALLEL_SLICE = (
    "tpu_resiliency.parallel.ring_attention",
    "tpu_resiliency.parallel.pipeline",
)

#: The modules of the observability slice (the launcher's detect, decide and act loop:
#: the metrics family, remediation, the autoscale controller, the watchtower, the
#: incident engine, the telemetry server and the CLI tools their tests use): each has
#: its counterpart.
OBSERVE_SLICE = (
    "tpu_resiliency.utils.metrics",
    "tpu_resiliency.utils.timeseries",
    "tpu_resiliency.utils.goodput",
    "tpu_resiliency.utils.byteflow",
    "tpu_resiliency.tools",
    "tpu_resiliency.tools.metrics_dump",
    "tpu_resiliency.tools.events_summary",
    "tpu_resiliency.telemetry.remediation",
    "tpu_resiliency.launcher.autoscale",
    "tpu_resiliency.telemetry.watchtower",
    "tpu_resiliency.tools.alerts_cli",
    "tpu_resiliency.launcher.incident",
    "tpu_resiliency.tools.incident_report",
    "tpu_resiliency.launcher.telemetry",
)

#: The repo-root examples and scripts the port carries, each at its path under
#: ``tpu_resiliency_torch/``.
ROOT_PORTS = (
    "examples/resilient_training.py",
    "examples/layered_restart.py",
    "examples/preemption_train.py",
    "examples/moe_pipeline_training.py",
    "examples/inprocess_restart_train.py",
    "examples/mesh_telemetry_training.py",
    "scripts/bench_model.py",
)


def _answered(package: str) -> dict[str, str]:
    """ANSWERED's reference names exported by ``package``, mapped to their answers."""
    return {name.rsplit(".", 1)[1]: answer for name, answer in ANSWERED.items()
            if name.startswith(package + ".")}


def _walk(path: Path, prefix: str):
    for info in pkgutil.iter_modules([str(path)]):
        name = prefix + info.name
        yield name
        if info.ispkg:
            yield from _walk(path / info.name, name + ".")


def reference_modules() -> list[str]:
    return sorted(_walk(REFERENCE_DIR, "tpu_resiliency."))


def port_file(module: str) -> Path | None:
    """The port's file for a module path ``tpu_resiliency_torch.a.b``, or None."""
    p = PORT_DIR.joinpath(*module.split(".")[1:])
    for candidate in (p / "__init__.py", p.with_suffix(".py")):
        if candidate.is_file():
            return candidate
    return None


def has_counterpart(module: str) -> bool:
    port_name = RENAMED.get(module, "tpu_resiliency_torch." + module.split(".", 1)[1])
    return port_file(port_name) is not None


def test_every_reference_module_is_ported_or_listed():
    modules = reference_modules()
    assert len(modules) > 100 and "tpu_resiliency.telemetry.detector" in modules
    neither = [m for m in modules if not has_counterpart(m) and m not in NOT_YET_PORTED]
    assert not neither, f"neither ported nor on the not-yet-ported list: {neither}"


def test_the_not_yet_ported_list_holds_no_ported_or_unknown_module():
    modules = set(reference_modules())
    assert len(set(NOT_YET_PORTED)) == len(NOT_YET_PORTED)
    unknown = sorted(set(NOT_YET_PORTED) - modules)
    assert not unknown, f"not modules of the JAX package: {unknown}"
    ported = sorted(m for m in NOT_YET_PORTED if has_counterpart(m))
    assert not ported, f"ported, so off the not-yet-ported list: {ported}"


@pytest.mark.parametrize("module", STRAGGLER_SLICE)
def test_the_straggler_slice_is_ported(module):
    assert module in reference_modules()
    assert has_counterpart(module) and module not in NOT_YET_PORTED


@pytest.mark.parametrize("module", INPROCESS_SLICE)
def test_the_inprocess_slice_is_ported(module):
    assert module in reference_modules()
    assert has_counterpart(module) and module not in NOT_YET_PORTED


@pytest.mark.parametrize("module", CHECKPOINT_SLICE)
def test_the_checkpoint_slice_is_ported(module):
    assert module in reference_modules()
    assert has_counterpart(module) and module not in NOT_YET_PORTED


@pytest.mark.parametrize("module", FT_SLICE)
def test_the_fault_tolerance_slice_is_ported(module):
    assert module in reference_modules()
    assert has_counterpart(module) and module not in NOT_YET_PORTED


@pytest.mark.parametrize("module", MODEL_SLICE)
def test_the_model_slice_is_ported(module):
    assert module in reference_modules()
    assert has_counterpart(module) and module not in NOT_YET_PORTED


@pytest.mark.parametrize("module", PARALLEL_SLICE)
def test_the_parallel_slice_is_ported(module):
    assert module in reference_modules()
    assert has_counterpart(module) and module not in NOT_YET_PORTED


@pytest.mark.parametrize("module", OBSERVE_SLICE)
def test_the_observability_slice_is_ported(module):
    assert module in reference_modules()
    assert has_counterpart(module) and module not in NOT_YET_PORTED


def test_the_not_yet_ported_list_is_the_last_slice():
    assert len(NOT_YET_PORTED) == 10
    assert all(m.startswith(("tpu_resiliency.fleet", "tpu_resiliency.tools."))
               for m in NOT_YET_PORTED)


@pytest.mark.parametrize("path", ROOT_PORTS)
def test_the_root_example_or_script_is_ported(path):
    assert (REFERENCE_DIR.parent / path).is_file()
    assert (PORT_DIR / path).is_file()


def test_every_root_example_is_ported():
    examples = sorted(p.relative_to(REFERENCE_DIR.parent).as_posix()
                      for p in (REFERENCE_DIR.parent / "examples").glob("*.py"))
    assert examples and set(examples) <= set(ROOT_PORTS)


def test_renamed_modules_exist_on_both_sides():
    for ref, port in RENAMED.items():
        assert ref in reference_modules()
        assert port_file(port) is not None, port


def test_the_port_exports_every_reference_telemetry_name_or_answers_it():
    import tpu_resiliency.telemetry as ref
    import tpu_resiliency_torch.telemetry as port

    answered = set(_answered("tpu_resiliency.telemetry"))
    missing = sorted(set(ref.__all__) - set(port.__all__) - answered)
    assert not missing, f"reference telemetry names with no port export: {missing}"
    for name in answered:
        assert name in ref.__all__ and not hasattr(port, name)


def test_the_port_exports_the_ported_integration_names():
    import tpu_resiliency.integrations as ref
    import tpu_resiliency_torch.integrations as port

    answered = _answered("tpu_resiliency.integrations")
    assert answered == {"OrbaxCheckpointCallback": "DcpCheckpointCallback"}
    not_yet = sorted(set(ref.__all__) - set(port.__all__) - set(answered))
    assert not not_yet, f"reference integration names with no port export: {not_yet}"
    assert sorted(set(port.__all__) - set(ref.__all__)) == sorted(answered.values())
    for name, answer in answered.items():
        assert not hasattr(port, name) and callable(getattr(port, answer))


def test_the_port_exports_every_reference_model_name():
    import tpu_resiliency.models as ref
    import tpu_resiliency.parallel as ref_parallel
    import tpu_resiliency_torch.models as port
    import tpu_resiliency_torch.parallel as port_parallel

    assert sorted(port.__all__) == sorted(ref.__all__)
    assert all(getattr(port, name) is not None for name in port.__all__)
    assert port_parallel.__all__ == ref_parallel.__all__ == ["mesh"]


def test_the_port_exports_every_reference_checkpoint_name():
    import tpu_resiliency.checkpoint as ref
    import tpu_resiliency_torch.checkpoint as port

    assert not _answered("tpu_resiliency.checkpoint")
    assert sorted(port.__all__) == sorted(ref.__all__)
    assert all(callable(getattr(port, name)) for name in port.__all__)


def test_the_port_exports_every_reference_inprocess_name_or_answers_it():
    import tpu_resiliency.inprocess as ref
    import tpu_resiliency_torch.inprocess as port

    answered = _answered("tpu_resiliency.inprocess")
    assert answered == {"JaxHealthCheck": "CudaHealthCheck",
                        "AbortJaxDistributed": "AbortTorchDistributed"}
    assert sorted(set(ref.__all__) - set(port.__all__)) == sorted(answered)
    assert sorted(set(port.__all__) - set(ref.__all__)) == sorted(answered.values())
    for name, answer in answered.items():
        assert not hasattr(port, name) and callable(getattr(port, answer))


def test_the_port_exports_every_reference_watchdog_name_or_answers_it():
    import tpu_resiliency.watchdog as ref
    import tpu_resiliency_torch.watchdog as port

    answered = _answered("tpu_resiliency.watchdog")
    assert answered == {"TpuRuntimeCheck": "CudaRuntimeCheck"}
    assert sorted(set(ref.__all__) - set(port.__all__)) == sorted(answered)
    assert sorted(set(port.__all__) - set(ref.__all__)) == sorted(answered.values())
    for name, answer in answered.items():
        assert not hasattr(port, name) and getattr(port, answer) is not None
    assert all(getattr(port, name) is not None for name in port.__all__)


def test_the_port_exports_every_reference_launcher_name():
    import tpu_resiliency.launcher as ref
    import tpu_resiliency_torch.launcher as port

    assert sorted(port.__all__) == sorted(ref.__all__)
    assert all(getattr(port, name) is not None for name in port.__all__)
