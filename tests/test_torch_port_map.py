"""The port map: every module of the JAX package ``tpu_resiliency`` either has a
counterpart at the same path under ``tpu_resiliency_torch/``, is ported under another
name (``RENAMED``), or stands on the explicit not-yet-ported list below. The list
shrank as slices landed and is empty now: every module has its counterpart.

The walk lists modules with ``pkgutil`` from the package directories, importing
nothing. The repo-root programs that call JAX (by an import, or through a reference
module that imports it) are ported under ``tpu_resiliency_torch/`` at their paths, or
listed with a reason.
"""

import pkgutil
import re
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

#: Reference modules with no counterpart in the port yet: none is left.
NOT_YET_PORTED = ()

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

#: The modules of the last slice (fleet federation: leases, the aggregator, the fleet
#: server and its daemon and CLI; the offline tools: trace export, critical path,
#: checkpoint and store inspection): each has its counterpart.
FLEET_SLICE = (
    "tpu_resiliency.fleet",
    "tpu_resiliency.fleet.registry",
    "tpu_resiliency.fleet.aggregator",
    "tpu_resiliency.fleet.server",
    "tpu_resiliency.tools.fleetd",
    "tpu_resiliency.tools.fleet_cli",
    "tpu_resiliency.tools.trace_export",
    "tpu_resiliency.tools.critpath",
    "tpu_resiliency.tools.ckpt_info",
    "tpu_resiliency.tools.store_info",
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
    "scripts/bench_configs.py",
    "scripts/bench_restart.py",
    "scripts/bench_ckpt_save.py",
    "__graft_entry__.py",
    "scripts/bench_reshard.py",
    "scripts/chaos_soak.py",
    "scripts/bench_store.py",
    "scripts/bench_replication.py",
    "scripts/bench_fleet.py",
    "scripts/bench_ckpt_io.py",
    "bench.py",
    "scripts/bench_pallas_sweep.py",
)

#: The repo-root files that call JAX and have no counterpart in the port yet, each
#: with its reason: none is left.
ROOT_NOT_YET_PORTED: dict[str, str] = {}

#: A line of a file that imports JAX (a worker script inside a string counts).
IMPORTS_JAX = re.compile(r"^\s*(import jax\b|from jax\b)", re.M)

#: The reference modules that import JAX when they are loaded: all of ``telemetry/``
#: (its ``__init__`` imports ``scoring``), ``ops/``, ``models/`` and ``integrations/``,
#: ``parallel/pipeline.py``, ``parallel/ring_attention.py`` and ``tools/alerts_cli.py``.
#: A subprocess that imports each module alone finds the same 28;
#: :func:`imports_jax_at_load` derives them from the sources.
JAX_AT_LOAD = (
    "tpu_resiliency.integrations",
    "tpu_resiliency.integrations.checkpoint_callback",
    "tpu_resiliency.integrations.ft_callbacks",
    "tpu_resiliency.integrations.loop",
    "tpu_resiliency.integrations.orbax_adapter",
    "tpu_resiliency.integrations.preemption",
    "tpu_resiliency.integrations.straggler_callback",
    "tpu_resiliency.models",
    "tpu_resiliency.models.moe",
    "tpu_resiliency.models.transformer",
    "tpu_resiliency.ops",
    "tpu_resiliency.ops.scoring_pallas",
    "tpu_resiliency.parallel.pipeline",
    "tpu_resiliency.parallel.ring_attention",
    "tpu_resiliency.telemetry",
    "tpu_resiliency.telemetry.detector",
    "tpu_resiliency.telemetry.device_profiler",
    "tpu_resiliency.telemetry.interval_tracker",
    "tpu_resiliency.telemetry.name_registry",
    "tpu_resiliency.telemetry.policy",
    "tpu_resiliency.telemetry.remediation",
    "tpu_resiliency.telemetry.reporting",
    "tpu_resiliency.telemetry.ring_buffer",
    "tpu_resiliency.telemetry.scoring",
    "tpu_resiliency.telemetry.sharded",
    "tpu_resiliency.telemetry.statistics",
    "tpu_resiliency.telemetry.watchtower",
    "tpu_resiliency.tools.alerts_cli",
)

#: A reference module named in a file: an import statement (a worker script inside a
#: string counts), or a quoted dotted name (``import_module``, ``-m`` command lines).
FROM_IMPORT = re.compile(r"^\s*from\s+(tpu_resiliency(?:\.\w+)*)\s+import\s+(\([^)]*\)|[^\n]*)",
                         re.M)
PLAIN_IMPORT = re.compile(r"^\s*import\s+(tpu_resiliency(?:\.\w+)*)", re.M)
QUOTED_MODULE = re.compile(r"[\"'](tpu_resiliency(?:\.\w+)+)[\"']")


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


@pytest.mark.parametrize("module", FLEET_SLICE)
def test_the_fleet_slice_is_ported(module):
    assert module in reference_modules()
    assert has_counterpart(module) and module not in NOT_YET_PORTED


def test_the_not_yet_ported_list_is_the_last_slice():
    """Nothing is left: every reference module has its counterpart."""
    assert NOT_YET_PORTED == ()
    slices = (STRAGGLER_SLICE, INPROCESS_SLICE, CHECKPOINT_SLICE, FT_SLICE, MODEL_SLICE,
              PARALLEL_SLICE, OBSERVE_SLICE, FLEET_SLICE)
    assert all(has_counterpart(m) for m in reference_modules())
    assert len({m for s in slices for m in s}) == sum(len(s) for s in slices)


@pytest.mark.parametrize("path", ROOT_PORTS)
def test_the_root_example_or_script_is_ported(path):
    assert (REFERENCE_DIR.parent / path).is_file()
    assert (PORT_DIR / path).is_file()


def root_files() -> list[str]:
    """The repo-root programs: ``bench.py``, ``__graft_entry__.py``, ``scripts/*.py``
    and ``examples/*.py``, repo-relative."""
    repo = REFERENCE_DIR.parent
    paths = [repo / "bench.py", repo / "__graft_entry__.py",
             *(repo / "scripts").glob("*.py"), *(repo / "examples").glob("*.py")]
    return sorted(p.relative_to(repo).as_posix() for p in paths if p.is_file())


def _package_of(module: str) -> str:
    return module if is_package(module) else module.rsplit(".", 1)[0]


def is_package(module: str) -> bool:
    return REFERENCE_DIR.joinpath(*module.split(".")[1:], "__init__.py").is_file()


def module_source(module: str) -> Path:
    p = REFERENCE_DIR.joinpath(*module.split(".")[1:])
    return p / "__init__.py" if is_package(module) else p.with_suffix(".py")


def _with_parents(name: str) -> set[str]:
    """Importing ``a.b.c`` loads ``a`` and ``a.b`` too."""
    parts = name.split(".")
    return {".".join(parts[:i]) for i in range(1, len(parts) + 1)}


def load_time_imports(module: str) -> set[str]:
    """The names ``module`` imports when it is loaded: its module-level imports, in
    class bodies and in ``if``/``try``/``with`` blocks too, but not in functions nor
    under ``if TYPE_CHECKING``; ``from a import b`` names ``a`` and ``a.b``."""
    import ast

    out: set[str] = set()
    package = _package_of(module)

    def visit(nodes):
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(node, ast.If) and "TYPE_CHECKING" in ast.unparse(node.test):
                visit(node.orelse)
                continue
            if isinstance(node, ast.Import):
                out.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    parts = package.split(".")
                    base = ".".join(parts[:len(parts) - node.level + 1] + ([base] if base else []))
                out.add(base)
                out.update(f"{base}.{a.name}" for a in node.names)
            for field in ("body", "orelse", "finalbody", "handlers"):
                if isinstance(node, (ast.ClassDef, ast.If, ast.Try, ast.With, ast.For,
                                     ast.While, ast.ExceptHandler)):
                    visit(getattr(node, field, []))

    visit(ast.parse(module_source(module).read_text()).body)
    return out


def imports_jax_at_load() -> set[str]:
    """The reference modules whose loading imports JAX: directly, or through a
    reference module (or a parent package) whose loading does."""
    modules = ["tpu_resiliency", *reference_modules()]
    loads = {m: set().union(*map(_with_parents, load_time_imports(m))) | (
        _with_parents(m) - {m}) for m in modules}
    found: set[str] = set()
    while True:
        more = {m for m in modules if m not in found and (
            any(n.split(".")[0] in ("jax", "jaxlib") for n in loads[m]) or loads[m] & found)}
        if not more:
            return found
        found |= more


def reference_imports(text: str) -> set[str]:
    """The reference modules a file's text imports or names (and their packages)."""
    modules = set(reference_modules()) | {"tpu_resiliency"}
    named = set(PLAIN_IMPORT.findall(text)) | set(QUOTED_MODULE.findall(text))
    for base, names in FROM_IMPORT.findall(text):
        named.add(base)
        for item in names.strip("()").replace("\n", ",").split(","):
            name = item.split("#")[0].split(" as ")[0].strip()
            if name:
                named.add(f"{base}.{name}")
    return {p for n in named for p in _with_parents(n)} & modules


def calls_jax(text: str) -> bool:
    """A file calls JAX when it imports JAX, or imports a reference module that imports
    JAX at load time (:data:`JAX_AT_LOAD`) or whose source imports it at run time."""
    runtime = {m for m in reference_modules() if IMPORTS_JAX.search(module_source(m).read_text())}
    return bool(IMPORTS_JAX.search(text) or reference_imports(text) & (set(JAX_AT_LOAD) | runtime))


def test_jax_at_load_is_what_the_sources_import():
    assert len(JAX_AT_LOAD) == len(set(JAX_AT_LOAD)) == 28
    assert imports_jax_at_load() == set(JAX_AT_LOAD)


def test_every_root_file_that_imports_jax_is_ported_or_listed():
    """Calling JAX through the package counts: ``scripts/bench_reshard.py`` and
    ``scripts/chaos_soak.py`` import no ``jax`` themselves."""
    repo = REFERENCE_DIR.parent
    jax_files = [f for f in root_files() if calls_jax((repo / f).read_text())]
    assert "bench.py" in jax_files and "scripts/bench_configs.py" in jax_files
    assert "scripts/bench_reshard.py" in jax_files and "scripts/chaos_soak.py" in jax_files
    assert not IMPORTS_JAX.search((repo / "scripts/chaos_soak.py").read_text())
    for free in ("scripts/bench_store.py", "scripts/bench_replication.py",
                 "scripts/bench_fleet.py", "scripts/bench_ckpt_io.py"):
        assert free not in jax_files, free
    neither = [f for f in jax_files if f not in ROOT_PORTS and f not in ROOT_NOT_YET_PORTED]
    assert not neither, f"import JAX, neither ported nor listed with a reason: {neither}"
    assert all(ROOT_NOT_YET_PORTED.values())
    for f in ROOT_NOT_YET_PORTED:
        assert f in jax_files and f not in ROOT_PORTS and not (PORT_DIR / f).exists(), f


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
