"""Copies stay copies: each module the port copies from the JAX package (the support
of the in-process restart slice, the modules of ``inprocess/`` that hold no JAX, the
checkpoint layer but for ``checkpoint/state_dict.py`` and ``staging.py``, which are
ports of their own, the fault-tolerance slice: the watchdog, the launcher, the
FT callbacks, ``platform/ipc.py``, ``compile_cache.py`` and ``utils/stackdump.py``, and
the observability slice: the event stream, the metrics family, remediation, the
autoscale controller, the watchtower, the incident engine, the telemetry server and
their CLI tools)
must equal the reference's text with its imports rewritten from ``tpu_resiliency.``
to ``tpu_resiliency_torch.``, except for the edits listed here, each with its reason.
An edit to a copy has to be added to this list, with why.
"""

import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def rewrite(text: str) -> str:
    return re.sub(r"\btpu_resiliency\.", "tpu_resiliency_torch.", text)


_DOCSTRING = re.compile(r'\A"""(.*?)"""\n', re.S)

#: Module docstrings that may differ: the module is a port around a copied body.
OWN_DOCSTRING = {
    "inprocess/__init__.py": "names the port's CUDA abort and health check",
    "inprocess/health_check.py": "describes CudaHealthCheck, the port's check",
    "inprocess/wrap.py": "names the port's abort, health check and compilation cache",
    "watchdog/health.py": "names CudaRuntimeCheck and the port's liveness probe",
    "platform/compile_cache.py": "describes torch.compile's caches, not JAX's",
    "launcher/park.py": "spares preload torch and warm no CUDA context",
    "launcher/proc.py": "workers are CUDA processes, not JAX ones",
    "launcher/launch.py": "names the port's CLI and the flag it refuses",
    "utils/events.py": "names the port's copies of the stream's consumers",
    "integrations/ft_callbacks.py": "the loop protocol is no longer JAX's",
    "integrations/preemption.py": "the agreement runs over the process group",
}

#: The port's preemption notice: the flag SIGTERM sets and the gloo group of the
#: agreement (``integrations/preemption.py``).
PREEMPTION_NOTICE = '''#: Set by the SIGTERM handler (or :func:`notify`); cleared by :func:`rescind`.
_notice = threading.Event()
_handler_installed = False
#: The gloo group the agreement runs on, for the default group it was made beside.
_agreement: dict = {}


def install_notice_handler() -> bool:
    """Make SIGTERM set this process's preemption flag instead of ending it. Only
    the main thread may install a handler: elsewhere this logs and returns False."""
    global _handler_installed
    if _handler_installed:
        return True
    try:
        signal.signal(signal.SIGTERM, _on_notice)
    except ValueError:
        log.warning("preemption notice handler not installed: not the main thread")
        return False
    _handler_installed = True
    return True


def _on_notice(signum, frame) -> None:
    _notice.set()


def notify() -> None:
    """Raise this process's preemption flag, as the notice's signal does."""
    _notice.set()


def rescind() -> None:
    """Clear this process's preemption flag: the scheduler withdrew the notice."""
    _notice.clear()


def agreement_group():
    """The gloo group the agreement reduces over: the default group when it is gloo,
    else a gloo group of the default group's ranks, made once per default group
    (every rank must reach the first call together, as the callback's first step
    does)."""
    import torch.distributed as dist

    world = dist.group.WORLD
    if dist.get_backend(world) == "gloo":
        return world
    if _agreement.get("world") is not world:
        _agreement.update(world=world, group=dist.new_group(backend="gloo"))
    return _agreement["group"]


'''

PREEMPTION_CLASS_DOC = '''    """Agree each step, over the process group, on whether any rank holds a
    preemption notice; on the agreed step, run ``on_preemption(state, step)``
    (typically a blocking save — the grace window is short) and cooperatively stop
    the loop.

    ``stop_on_preemption=False`` keeps training (save-and-continue — useful when
    the scheduler sometimes cancels the reclamation).

    ``grace_steps=N`` defers the drain/save/stop by N steps after the notice is first
    agreed — the **rescind window**. A notice that clears (:func:`rescind` on every
    rank that held it) before the window elapses emits one ``preemption_rescinded``
    event, cancels the pending deferred drain (it simply never runs), and re-arms the
    callback for a later real notice. The default (0) acts immediately.

    ``ckpt_manager`` (anything with ``maybe_finalize(blocking=True)`` — a
    :class:`~tpu_resiliency_torch.checkpoint.local_manager.LocalCheckpointManager`,
    an :class:`~tpu_resiliency_torch.checkpoint.async_ckpt.AsyncCheckpointer`, or a
    bare callable) defers acting on a notice that lands DURING an in-flight async
    save: the callback first drains the pending save to its commit/rename, THEN runs
    ``on_preemption``. Without the drain, the grace-window save races the background
    writer.

    The notice is SIGTERM, handled from the first agreement on; call
    :func:`install_notice_handler` earlier to take notices before the first step.

    After the loop stops, tear the process group down coordinator-last before
    process exit — :func:`platform.distributed.shutdown_ordered` (store-backed,
    deterministic) or :func:`shutdown_graceful` (store-free) — or a peer's
    teardown can race the rendezvous host's death.
    """

'''

PREEMPTION_REACHED = '''    @staticmethod
    def _reached(step: int) -> bool:
        """Whether any rank holds a notice, agreed at this step by every rank: one
        ``all_reduce(MAX)`` of the host flag on the gloo group."""
        from tpu_resiliency_torch.platform.distributed import client_active

        if not client_active():
            return False  # no process group: nothing to agree with
        import torch.distributed as dist

        install_notice_handler()

        flag = torch.tensor([1 if _notice.is_set() else 0], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=agreement_group())
        return bool(flag.item())

'''

JAX_HEALTH_CHECK = '''@dataclasses.dataclass
class JaxHealthCheck(HealthCheck):
    """Device liveness probe: two tiny compiled adds under a timeout (the direct
    analogue of ``CudaHealthCheck``'s double ``synchronize``)."""

    timeout: float = 30.0

    def __call__(self, state: FrozenState) -> FrozenState:
        import jax
        import jax.numpy as jnp

        def probe() -> None:
            x = jnp.asarray([1.0, 2.0])
            jax.block_until_ready(x + x)
'''
CUDA_HEALTH_CHECK = '''@dataclasses.dataclass
class CudaHealthCheck(HealthCheck):
    """Device liveness probe: two tiny launches, each followed by a synchronize,
    each under a timeout. ``device=None`` means the card (raises at construction
    without one); ``device="cpu"`` runs the probes on the CPU, where they honour the
    dead-runtime mark of an injected ``DEVICE_ERROR``."""

    timeout: float = 30.0
    device: Any = None

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    def __call__(self, state: FrozenState) -> FrozenState:
        def probe() -> None:
            tiny_launch(self.device)
'''

REF_DTYPES = '''def _dtype_name(dtype: np.dtype) -> str:
    # `.str` is lossy for extension dtypes (bfloat16 → "<V2"); the name round-trips.
    return dtype.name


def resolve_dtype(name: str) -> np.dtype:
    """Resolve a dtype name, including ml_dtypes extension types (bfloat16, fp8...)."""
    try:
        return np.dtype(name)
    except TypeError:
        import ml_dtypes

        return np.dtype(getattr(ml_dtypes, name))
'''
PORT_DTYPES = '''#: Dtypes numpy lacks, by the name the header records (the JAX package's name,
#: which is torch's too): host arrays carry them as raw unsigned integers of the
#: same width, tagged with that name in the dtype's metadata, so headers keep it
#: and containers interchange without ``ml_dtypes``.
RAW_DTYPES = {
    "bfloat16": np.uint16,
    "float8_e4m3fn": np.uint8,
    "float8_e4m3fnuz": np.uint8,
    "float8_e5m2": np.uint8,
    "float8_e5m2fnuz": np.uint8,
}


def _dtype_name(dtype: np.dtype) -> str:
    # `.str` is lossy for extension dtypes (bfloat16 → "<V2"); the name round-trips,
    # and a raw stand-in carries the name of the dtype it stands for.
    return (dtype.metadata or {}).get("name", dtype.name)


def resolve_dtype(name: str) -> np.dtype:
    """Resolve a dtype name; a name numpy lacks (bfloat16, fp8...) resolves to its
    raw stand-in of the same width, tagged with the name (``RAW_DTYPES``)."""
    try:
        return np.dtype(name)
    except TypeError:
        if name not in RAW_DTYPES:
            raise
        return np.dtype(RAW_DTYPES[name], metadata={"name": name})
'''

JAX_BACKEND_PROBE = '''def _jax_backend_alive() -> bool:
    """True when this process holds an initialized JAX backend client (without
    triggering initialization by asking)."""
    import sys

    if "jax" not in sys.modules:
        return False
    try:
        from jax._src import xla_bridge

        return bool(xla_bridge._backends)
    except Exception:
        # Fail CLOSED: jax is imported but the (private) probe broke — assume a
        # backend may be live rather than silently disabling the guard.
        log.warning(
            "could not probe JAX backend state; treating it as initialized",
            exc_info=True,
        )
        return True
'''
CUDA_GUARD = '''def _cuda_initialized() -> bool:
    """True when this process has initialised CUDA (without initialising it by
    asking): a forked child of such a process inherits a CUDA context it cannot use."""
    import sys

    if "torch" not in sys.modules:
        return False
    import torch

    return torch.cuda.is_initialized()
'''

DEVICE_LIVENESS_CHECK = '''class DeviceLivenessCheck(HealthCheck):
    """Two tiny launches, each followed by a synchronize, under a timeout thread
    (the reference ``CudaHealthCheck`` double-sync analogue,
    ``inprocess/health_check.py:70-110``). ``device=None`` means the card;
    ``device="cpu"`` probes the CPU."""

    def __init__(self, timeout: float = 60.0, device: Any = None):
        self.timeout = timeout
        self.device = device

    def __call__(self) -> bool:
        from tpu_resiliency_torch.platform.device import device_liveness_probe

        return device_liveness_probe(timeout=self.timeout, device=self.device)
'''
CUDA_RUNTIME_CHECK = '''class CudaRuntimeCheck(HealthCheck):
    """CUDA runtime state: device inventory + device-memory pressure.

    The analogue of the reference's NVML device/recovery-state poll
    (``shared_utils/health_check.py:148-303``), read through the CUDA runtime: the
    check must run in a process that owns the card (the worker — wire it into the
    in-process restart health chain or poll it from the train loop). A rank-monitor
    process never creates a CUDA context, and each device this check reads gets one
    in the calling process.

    Unhealthy when: the runtime can no longer count devices, the visible device
    count drops below ``expect_devices``, or any device's memory pressure exceeds
    ``hbm_usage_threshold`` (``1 - free/total``, from ``torch.cuda.mem_get_info``).

    ``device=None`` means the card, and construction raises without one. The CPU has
    no device inventory: ``device="cpu"`` needs ``device_count`` and
    ``mem_get_info`` (``index -> (free, total)``) from the caller, which also
    replace the runtime's on the card.
    """

    def __init__(
        self,
        expect_devices: Optional[int] = None,
        hbm_usage_threshold: float = 0.98,
        device: Any = None,
        device_count: Optional[Callable[[], int]] = None,
        mem_get_info: Optional[Callable[[int], tuple[int, int]]] = None,
    ):
        from tpu_resiliency_torch.platform.device import resolve_device

        self.device = resolve_device(device)
        if self.device.type != "cuda" and (device_count is None or mem_get_info is None):
            raise ValueError(
                "CudaRuntimeCheck on the CPU needs device_count and mem_get_info"
            )
        self.expect_devices = expect_devices
        self.hbm_usage_threshold = hbm_usage_threshold
        self._device_count = device_count
        self._mem_get_info = mem_get_info
        self.last_failure: Optional[str] = None

    def _count(self) -> int:
        if self._device_count is not None:
            return self._device_count()
        import torch

        return torch.cuda.device_count()

    def _memory(self, index: int) -> tuple[int, int]:
        if self._mem_get_info is not None:
            return self._mem_get_info(index)
        import torch

        return torch.cuda.mem_get_info(index)

    def __call__(self) -> bool:
        self.last_failure = None
        try:
            count = self._count()
        except Exception as e:
            self.last_failure = f"device enumeration failed: {e!r}"
            log.error(self.last_failure)
            return False
        if not count:
            self.last_failure = "no local devices visible"
            log.error(self.last_failure)
            return False
        if self.expect_devices is not None and count < self.expect_devices:
            self.last_failure = (
                f"device count dropped: {count} < expected {self.expect_devices}"
            )
            log.error(self.last_failure)
            return False
        for index in range(count):
            try:
                free, total = self._memory(index)
            except Exception as e:
                self.last_failure = f"memory query of device {index} failed: {e!r}"
                log.error(self.last_failure)
                return False
            if not total:
                continue
            usage = 1.0 - free / total
            if usage > self.hbm_usage_threshold:
                self.last_failure = (
                    f"device memory pressure on device {index}: {usage:.1%} > "
                    f"{self.hbm_usage_threshold:.0%} ({total - free}/{total} bytes)"
                )
                log.error(self.last_failure)
                return False
        return True

    def describe(self) -> str:
        return f"CudaRuntimeCheck({self.last_failure or 'ok'})"


'''
UNPORTED_FEATURES = '''
#: Options of the JAX package's agent whose modules the port does not hold yet, and
#: those modules: a config or a launcher flag that asks for one fails, never is
#: silently ignored.
UNPORTED_FEATURES = {
    "fleet_dir": "tpu_resiliency/fleet/",
}


def unported(option: str) -> str:
    """The error for an option whose module is not ported yet."""
    return (f"{option} needs {UNPORTED_FEATURES[option]}, which is not ported to "
            f"tpu_resiliency_torch yet")
'''

#: Per copied module (path under both packages): ``(reference text, port text, why)``
#: after the import rewrite. Each reference text (or pattern) must occur exactly once.
COPIES = {
    "utils/location.py": (),
    "utils/tracing.py": (),
    "utils/opstats.py": (),
    "utils/flight_recorder.py": (),
    "platform/chaos.py": (),
    "platform/store.py": (),
    "platform/shardstore.py": (),
    "platform/framing.py": (),
    "watchdog/state_machine.py": (),
    "inprocess/state.py": (),
    "inprocess/attribution.py": (),
    "inprocess/compose.py": (),
    "inprocess/completion.py": (),
    "inprocess/finalize.py": (),
    "inprocess/initialize.py": (),
    "inprocess/rank_assignment.py": (),
    "inprocess/monitor_thread.py": (
        (re.compile(r"``/\S+/src/(nvidia_resiliency_ext/inprocess/monitor_thread\.py:87-105)``"),
         r"``\1``",
         "the original's file is named by its path in its own package, not on a machine"),
    ),
    "inprocess/coordination.py": (),
    "inprocess/monitor_process.py": (),
    "inprocess/nested_restarter.py": (),
    "inprocess/tools/__init__.py": (),
    "inprocess/progress_watchdog.py": (
        ('''try:
    # Pure-C pending-call trampoline (native/probe.c). Preferred: it executes no
    # Python bytecode on the main thread, so a PyThreadState_SetAsyncExc-injected
    # restart exception can never be delivered (and swallowed) inside the probe.
    from tpu_resiliency import _probe_native
except ImportError:  # pragma: no cover - depends on build_ext having run
    _probe_native = None
''', '''# The pure-C pending-call trampoline (the reference's ``native/probe.c``) is not
# ported yet: the port keeps the ctypes pending-call path only, the reference's own
# path when its extension is not built.
''', "the native trampoline is not ported: the pure-Python pending-call path only"),
        ('''        self.native = _probe_native is not None if use_native is None else use_native
        if self.native and _probe_native is None:
            raise RuntimeError("native probe requested but _probe_native is not built")
''', '''        self.native = False
        if use_native:
            raise RuntimeError("the native probe is not ported; use_native must be falsy")
''', "asking for the native probe raises, as the reference does when it is not built"),
        ('''        if self.native:
            before = _probe_native.count()
            if not _probe_native.schedule():
                self._shutdown.wait(self.interval)
                return False
            deadline = time.monotonic() + self.interval
            poll = min(max(self.interval / 20.0, 0.001), 0.05)
            while time.monotonic() < deadline and not self._shutdown.is_set():
                if _probe_native.count() > before:
                    return True
                time.sleep(poll)
            return _probe_native.count() > before
''', "", "the native probe's round trip goes with it"),
    ),
    "inprocess/wrap.py": (),
    "inprocess/health_check.py": (
        ("from typing import Optional\n", "from typing import Any, Optional\n",
         "the device field"),
        ("from tpu_resiliency_torch.inprocess.state import FrozenState\n",
         "from tpu_resiliency_torch.inprocess.state import FrozenState\n"
         "from tpu_resiliency_torch.platform.device import resolve_device, tiny_launch\n",
         "the probe is the port's tiny launch"),
        (JAX_HEALTH_CHECK, CUDA_HEALTH_CHECK,
         "JaxHealthCheck is answered by CudaHealthCheck (two launches, each synchronized)"),
    ),
    "inprocess/__init__.py": (
        ("AbortCompilationCache, AbortJaxDistributed\n",
         "AbortCompilationCache, AbortTorchDistributed\n", "the port's abort"),
        ("FaultCounter, HealthCheck, JaxHealthCheck\n",
         "CudaHealthCheck, FaultCounter, HealthCheck\n", "the port's health check"),
        ('    "AbortJaxDistributed",\n', '    "AbortTorchDistributed",\n', "exported"),
        ('    "Compose",\n', '    "Compose",\n    "CudaHealthCheck",\n', "exported"),
        ('    "JaxHealthCheck",\n', "", "not in the port"),
    ),
    "utils/timers.py": (),
    "platform/treecomm.py": (),
    "checkpoint/__init__.py": (),
    "checkpoint/comm.py": (),
    "checkpoint/replication.py": (),
    "checkpoint/coldtier.py": (),
    "checkpoint/coding/__init__.py": (),
    "checkpoint/coding/rs.py": (),
    "checkpoint/coding/delta.py": (),
    "checkpoint/coding/strategy.py": (),
    "checkpoint/format.py": (
        (REF_DTYPES, PORT_DTYPES,
         "bf16 and fp8 resolve to raw unsigned integers of their width, tagged with the "
         "reference's name: the header keeps the name and the port needs no ml_dtypes"),
    ),
    "checkpoint/async_core.py": (
        (JAX_BACKEND_PROBE, CUDA_GUARD,
         "the fork guard asks whether this process has initialised CUDA"),
        ("""    Only safe when the parent holds **no live TPU runtime** (e.g. a CPU-host data
    orchestrator) — forking a process with an initialized accelerator client is
    undefined behavior (runtime threads and device handles are duplicated into a
    child that never reaps them). ``schedule`` therefore REFUSES to fork once a
    JAX backend is initialized in this process, unless constructed with""",
         """    Only safe when the parent has **not initialised CUDA** (e.g. a CPU-host data
    orchestrator) — forking a process with an initialized accelerator client is
    undefined behavior (runtime threads and device handles are duplicated into a
    child that never reaps them). ``schedule`` therefore REFUSES to fork once
    CUDA is initialized in this process, unless constructed with""",
         "the docstring names the port's guard"),
        ("""        if not self._allow_backend and _jax_backend_alive():
            raise CheckpointError(
                "refusing to fork a checkpoint writer: this process holds an "
                "initialized JAX backend (forking duplicates runtime threads and \"""",
         """        if not self._allow_backend and _cuda_initialized():
            raise CheckpointError(
                "refusing to fork a checkpoint writer: this process has "
                "initialized CUDA (forking duplicates runtime threads and \"""",
         "the same message, naming CUDA"),
    ),
    "checkpoint/async_ckpt.py": (
        ("import os\nimport pickle\nimport time\n", "import os\nimport time\n",
         "hollow skeletons pickle through hollow_pickle"),
        ("from tpu_resiliency_torch.checkpoint import format as ckpt_format\n",
         "from tpu_resiliency_torch.checkpoint import format as ckpt_format\n"
         "from tpu_resiliency_torch.checkpoint import hollow_pickle as pickle\n",
         "every pickle here is a hollow skeleton: the placeholder keeps the reference's "
         "name on disk, so containers load in either package"),
        ("""    import jax

    from tpu_resiliency_torch.checkpoint.state_dict import TensorPlaceholder
""", """    from tpu_resiliency_torch.checkpoint.state_dict import (
        TensorPlaceholder,
        tree_flatten,
        tree_unflatten,
    )
""", "the port's flatten, in jax.tree_util's order"),
        ("        leaves, treedef = jax.tree_util.tree_flatten(subtree)\n",
         "        leaves, treedef = tree_flatten(subtree)\n", "the port's flatten"),
        ("            (jax.tree_util.tree_unflatten(treedef, new_leaves), part_tensors)\n",
         "            (tree_unflatten(treedef, new_leaves), part_tensors)\n", "the port's flatten"),
    ),
    "checkpoint/local_manager.py": (
        ("\nimport pickle\n",
         "\nfrom tpu_resiliency_torch.checkpoint import hollow_pickle as pickle\n",
         "every pickle here is a hollow skeleton: the placeholder keeps the reference's "
         "name on disk, and reading maps it to the port's class"),
    ),
    "checkpoint/reshard.py": (
        ("""        ``spec_tree`` mirrors ``tree`` with a per-leaf partition spec (a
        ``jax.sharding.PartitionSpec``, a tuple of axis names / ``None``, or
        ``None`` for fully replicated) at each array leaf.""",
         """        ``spec_tree`` mirrors ``tree`` with a per-leaf partition spec (a
        tuple of axis names / ``None``, or ``None`` for fully replicated) at
        each array leaf.""", "the port has no PartitionSpec yet"),
        ("""        import jax

        from tpu_resiliency_torch.checkpoint.state_dict import _is_array
""", "        from tpu_resiliency_torch.checkpoint.state_dict import _is_array, dtype_name, "
             "tree_flatten\n", "the port's flatten and dtype names"),
        ("""            try:
                from jax.sharding import PartitionSpec

                if isinstance(x, PartitionSpec):
                    return True
            except ImportError:  # pragma: no cover
                pass
""", "", "specs are tuples of axis names or None"),
        ("""        data_leaves = jax.tree_util.tree_flatten(tree)[0]
        spec_leaves = jax.tree_util.tree_flatten(spec_tree, is_leaf=is_spec)[0]
""", """        data_leaves = tree_flatten(tree)[0]
        spec_leaves = tree_flatten(spec_tree, is_leaf=is_spec)[0]
""", "the port's flatten"),
        ('            dt = np.dtype(getattr(arr.dtype, "name", arr.dtype)).name\n',
         "            dt = dtype_name(arr)\n", "a torch dtype has no numpy dtype"),
    ),
    "integrations/checkpoint_callback.py": (
        ("        driven_by_loop: bool = False,\n    ):",
         "        driven_by_loop: bool = False,\n        device: Any = None,\n    ):",
         "restores place tensors on device (None: the CUDA card)"),
        ("        self.driven_by_loop = driven_by_loop\n",
         "        self.driven_by_loop = driven_by_loop\n        self.device = device\n", "kept"),
        ("self.local_manager.load_tree(local_step)",
         "self.local_manager.load_tree(local_step, device=self.device)", "placed on device"),
        ("AsyncCheckpointer.load(path, rank=self.rank)",
         "AsyncCheckpointer.load(path, rank=self.rank, device=self.device)", "placed on device"),
    ),
    # -- the observability slice: the launcher's detect, decide and act loop
    "utils/events.py": (),
    "utils/metrics.py": (),
    "utils/timeseries.py": (),
    "utils/goodput.py": (),
    "utils/byteflow.py": (),
    "tools/__init__.py": (),
    "tools/metrics_dump.py": (),
    "tools/events_summary.py": (),
    "telemetry/remediation.py": (),
    "launcher/autoscale.py": (
        (re.compile(r"# Prefer the phase decomposition \(PR \d+\): "),
         "# Prefer the phase decomposition: ",
         "the reference's change numbers name nothing in the port"),
    ),
    "telemetry/watchtower.py": (),
    "tools/alerts_cli.py": (),
    "launcher/incident.py": (
        (re.compile(r"tie-breaking \(the PR-\d+ trace ids"), "tie-breaking (the trace ids",
         "the reference's change numbers name nothing in the port"),
    ),
    "tools/incident_report.py": (),
    "launcher/telemetry.py": (),
    # -- the fault-tolerance slice
    "utils/stackdump.py": (),
    "watchdog/data.py": (),
    "watchdog/timeouts.py": (),
    "watchdog/monitor_client.py": (),
    "launcher/__init__.py": (),
    "launcher/errors.py": (),
    "launcher/rendezvous.py": (),
    "integrations/ft_callbacks.py": (),
    "launcher/proc.py": (),
    "platform/ipc.py": (
        ("""Framing is shared with the TCP store protocol (``platform/framing.py``). Unix sockets are
filesystem-permission-protected, so no auth handshake is needed here.""",
         """Framing is shared with the TCP store protocol (``platform/framing.py``); the pickles name
classes by the JAX package's paths (``platform/wire.py``), so either package's monitor and
client talk to the other's. Unix sockets are filesystem-permission-protected, so no auth
handshake is needed here.""", "the docstring names the wire"),
        ("from tpu_resiliency_torch.platform import chaos, framing\n",
         "from tpu_resiliency_torch.platform import chaos, wire\n", "the monitor channel's wire"),
        ("""write_object = framing.send_obj
read_object = functools.partial(framing.recv_obj, max_frame=_MAX_FRAME)
read_object_stream = functools.partial(framing.read_obj_stream, max_frame=_MAX_FRAME)
write_object_stream = framing.write_obj_stream""",
         """write_object = wire.send_obj
read_object = functools.partial(wire.recv_obj, max_frame=_MAX_FRAME)
read_object_stream = functools.partial(wire.read_obj_stream, max_frame=_MAX_FRAME)
write_object_stream = wire.write_obj_stream""",
         "frames name the port's classes by the JAX package's paths, so a port client and "
         "a reference monitor (and back) understand each other"),
    ),
    "watchdog/config.py": (
        ("from typing import Any, Mapping, Optional\n\nimport yaml\n",
         "from typing import Any, Mapping, Optional\n",
         "PyYAML is not on the card's machine: only the YAML paths import it"),
        ("""    # reference's GPU/NIC checks; None disables each. TpuRuntimeCheck is NOT
    # listed: it must run in the process that owns the TPU (wire it into the""",
         """    # reference's GPU/NIC checks; None disables each. CudaRuntimeCheck is NOT
    # listed: it must run in the process that owns the card (wire it into the""",
         "names the port's runtime check"),
        ("""        (reference ``config.py:224-239``).\"\"\"
        with open(path) as f:""",
         """        (reference ``config.py:224-239``).\"\"\"
        import yaml  # only the YAML paths need PyYAML

        with open(path) as f:""", "yaml imported where it is used"),
        ("""    def to_yaml_file(self, path: str) -> None:
        with open(path, "w") as f:""",
         """    def to_yaml_file(self, path: str) -> None:
        import yaml

        with open(path, "w") as f:""", "yaml imported where it is used"),
        ("""        if field == "rank_section_timeouts":
            return yaml.safe_load(value)""",
         """        if field == "rank_section_timeouts":
            import yaml

            return yaml.safe_load(value)""", "yaml imported where it is used"),
    ),
    "watchdog/health.py": (
        ("from typing import Callable, Optional\n", "from typing import Any, Callable, Optional\n",
         "the device arguments"),
        (re.compile(r"class DeviceLivenessCheck\(HealthCheck\):\n.*?return device_liveness_probe"
                    r"\(timeout=self\.timeout\)\n", re.S),
         DEVICE_LIVENESS_CHECK, "the port's probe takes the device (None: the card)"),
        (re.compile(r"class TpuRuntimeCheck\(HealthCheck\):\n.*?\n\n\n(?=class HostMemoryCheck)",
                    re.S), CUDA_RUNTIME_CHECK,
         "TpuRuntimeCheck is answered by CudaRuntimeCheck: device count and mem_get_info "
         "pressure through the CUDA runtime"),
    ),
    "watchdog/monitor_server.py": (
        ("from tpu_resiliency_torch.platform import framing\n",
         "from tpu_resiliency_torch.platform import wire\n", "the monitor channel's wire"),
        ("msg = await framing.read_obj_stream(reader)", "msg = await wire.read_obj_stream(reader)",
         "the monitor channel's wire"),
        ("await framing.write_obj_stream(writer, reply)",
         "await wire.write_obj_stream(writer, reply)", "the monitor channel's wire"),
        ("""        # JAX-threaded parent) pay full interpreter startup, which on TPU images
        # can be several seconds even unloaded.""",
         """        # threaded parent) pay full interpreter startup, which can be several
        # seconds even unloaded.""", "no JAX here"),
        ("""    # A forked monitor must never touch the parent's TPU runtime.
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
""", """    # A forked monitor must never touch the card: no CUDA context here (one
    # would hold device memory and block on a hung card). Hiding the cards makes
    # any CUDA call in this process fail instead of opening one.
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
""", "a monitor opens no CUDA context"),
    ),
    "watchdog/__init__.py": (
        ("    CallbackHealthCheck,\n    DeviceLivenessCheck,\n",
         "    CallbackHealthCheck,\n    CudaRuntimeCheck,\n    DeviceLivenessCheck,\n",
         "the port's runtime check"),
        ("    SysfsCounterCheck,\n    TpuRuntimeCheck,\n)", "    SysfsCounterCheck,\n)",
         "not in the port"),
        ('    "TpuRuntimeCheck",\n', '    "CudaRuntimeCheck",\n', "exported in its place"),
    ),
    "platform/compile_cache.py": (
        ('''#: exported by the launcher; consumed by :func:`apply_from_env` in workers
CACHE_DIR_ENV = "TPU_RESILIENCY_COMPILE_CACHE_DIR"
''', '''#: exported by the launcher; consumed by :func:`apply_from_env` in workers
CACHE_DIR_ENV = "TPU_RESILIENCY_COMPILE_CACHE_DIR"

#: torch.compile's caches, each in a directory of its own under the cache dir
INDUCTOR_CACHE_ENV = "TORCHINDUCTOR_CACHE_DIR"
TRITON_CACHE_ENV = "TRITON_CACHE_DIR"


def compiler_cache_env(path: str) -> dict[str, str]:
    """The compiler cache variables for cache directory ``path``."""
    return {INDUCTOR_CACHE_ENV: os.path.join(path, "inductor"),
            TRITON_CACHE_ENV: os.path.join(path, "triton")}

''', "torch.compile's cache variables, which the launcher exports too"),
        (re.compile(r'    """Sweep ``path``, point JAX.*?caching off\."""', re.S),
         '''    """Sweep ``path``, point torch.compile's Inductor and Triton caches under it
    (:func:`compiler_cache_env`), and register an exit-time manifest refresh.
    Returns the sweep stats.

    Every failure mode degrades to a cold compile: an unusable directory simply
    leaves caching off. The variables are read when a compiler first looks for
    its cache, so apply this before the first ``torch.compile``d call."""''',
         "the docstring describes torch.compile's caches"),
        (re.compile(r'    stats\["enabled"\] = True\n    try:\n        import jax\n.*?'
                    r'        return stats\n    import atexit', re.S),
         '    stats["enabled"] = True\n    os.environ.update(compiler_cache_env(path))\n'
         '    import atexit', "the caches are torch.compile's, set through its variables"),
        (re.compile(r"#: process-level latch.*?        return \[\]\n", re.S),
         '''#: torch.compile's cache directories under the cache dir (``compiler_cache_env``):
#: every file in them, at any depth, is an entry
_COMPILER_DIRS = ("inductor", "triton")

#: files in the compiler directories that are no entries (Inductor's file locks)
_NOT_ENTRY_SUFFIXES = (".lock",)

#: process-level latch: the cache is applied (and its event recorded) once
_applied: Optional[dict] = None


def _entry_names(path: str) -> list[str]:
    """The entries under ``path``, each named by its path relative to ``path``:
    top-level ``*-cache`` files, then every file below the compiler directories."""
    try:
        names = [n for n in os.listdir(path) if n.endswith(_ENTRY_SUFFIX)]
    except OSError:
        return []
    for sub in _COMPILER_DIRS:
        for dirpath, _, files in os.walk(os.path.join(path, sub)):
            rel = os.path.relpath(dirpath, path).replace(os.sep, "/")
            names.extend(f"{rel}/{f}" for f in files if not f.endswith(_NOT_ENTRY_SUFFIXES))
    return sorted(names)
''', "Inductor and Triton keep their entries in subdirectories: scan, sweep and the "
           "manifest walk them, keyed by the path relative to the cache dir"),
        ('            for victim in (p, p[: -len(_ENTRY_SUFFIX)] + "-atime"):',
         '            stamp = [p[: -len(_ENTRY_SUFFIX)] + "-atime"] if "/" not in name else []\n'
         '            for victim in (p, *stamp):',
         "only JAX's top-level entries have an -atime stamp"),
    ),
    "integrations/preemption.py": (
        ("import time\nfrom typing import Any, Callable, Optional\n\n"
         "from tpu_resiliency_torch.integrations.loop",
         "import signal\nimport threading\nimport time\nfrom typing import Any, Callable, Optional\n\n"
         "import torch\n\nfrom tpu_resiliency_torch.integrations.loop",
         "the notice's signal handler, its flag, and the flag's tensor"),
        ("log = get_logger(__name__)\n\n\nclass PreemptionCheckpointCallback(Callback):\n",
         "log = get_logger(__name__)\n\n" + PREEMPTION_NOTICE
         + "class PreemptionCheckpointCallback(Callback):\n",
         "the host flag that SIGTERM sets, and the gloo group the ranks agree over"),
        (re.compile(r'    """Poll the coordination service.*?spurious fatal\.\n    """\n\n', re.S),
         PREEMPTION_CLASS_DOC.replace("\\", "\\\\"),
         "the agreement is the process group's, not the coordination service's"),
        (re.compile(r"    @staticmethod\n    def _reached\(step: int\) -> bool:.*?"
                    r"reached_preemption_sync_point\(step\)\)\n\n", re.S),
         PREEMPTION_REACHED.replace("\\", "\\\\"),
         "multihost_utils' sync point becomes an all_reduce(MAX) of the flag on gloo"),
    ),
    "launcher/park.py": (
        ('    ap.add_argument("--preload", default="jax")',
         '    ap.add_argument("--preload", default="torch")', "spares preload torch"),
        ('    run_dir: str, spare_id: int, preload: str = "jax",',
         '    run_dir: str, spare_id: int, preload: str = "torch",', "spares preload torch"),
        ('        self, size: int, run_dir: str, preload: str = "jax",',
         '        self, size: int, run_dir: str, preload: str = "torch",', "spares preload torch"),
    ),
    "launcher/agent.py": (
        ("log = get_logger(__name__)\n\n\n@dataclasses.dataclass\nclass AgentConfig:",
         "log = get_logger(__name__)\n" + UNPORTED_FEATURES + "\n\n@dataclasses.dataclass\n"
         "class AgentConfig:", "the options whose modules are not ported, and their error"),
        ('    warm_spare_preload: str = "jax"\n', '    warm_spare_preload: str = "torch"\n',
         "spares preload torch"),
        ("""            raise ValueError(
                f"unknown alerts mode {self.alerts!r}: want off | on"
            )
""", """            raise ValueError(
                f"unknown alerts mode {self.alerts!r}: want off | on"
            )
        if self.fleet_dir:
            raise NotImplementedError(unported("fleet_dir"))
""", "a config that asks for the fleet plane fails at construction"),
    ),
    "launcher/launch.py": (
        ("from tpu_resiliency_torch.launcher.agent import AgentConfig, ElasticAgent, WorkersFailed\n",
         "from tpu_resiliency_torch.launcher.agent import (\n    AgentConfig,\n    ElasticAgent,\n"
         "    WorkersFailed,\n    unported,\n)\n", "the refusal's message"),
        ('        description="Fault-tolerant elastic launcher for TPU training workloads.",',
         '        description="Fault-tolerant elastic launcher for PyTorch training workloads "\n'
         '        "on CUDA cards.",', "the port's workloads"),
        ('        "--warm-spare-preload",\n        default="jax",',
         '        "--warm-spare-preload",\n        default="torch",', "spares preload torch"),
        ("""        "'runtime' (platform-safe runtime warmup: plugin discovery, tracing "
        "machinery, CPU/loopback backend pre-init — device grabbing stays "
        "strictly post-promotion), or a custom 'module:function' spec; \"""",
         """        "'runtime' (platform-safe runtime warmup: the port's packages imported, "
        "its built kernel libraries opened, one CPU operation, no CUDA context — "
        "device grabbing stays strictly post-promotion), or a custom "
        "'module:function' spec; \"""", "the port's runtime warmup"),
        ("""        help="persistent XLA compilation cache shared across restart rounds "
        "(exports $JAX_COMPILATION_CACHE_DIR + "
        "$TPU_RESILIENCY_COMPILE_CACHE_DIR to workers): a respawned worker's "
        "first step loads the previous round's executables instead of "
        "re-tracing/re-compiling; corrupt entries are swept to a cold \"""",
         """        help="persistent torch.compile caches shared across restart rounds "
        "(exports $TORCHINDUCTOR_CACHE_DIR, $TRITON_CACHE_DIR and "
        "$TPU_RESILIENCY_COMPILE_CACHE_DIR to workers): a respawned worker's "
        "first compiled step loads the previous round's artifacts instead of "
        "re-compiling; corrupt entries are swept to a cold \"""", "torch.compile's caches"),
        ("""    # Flag validation first: reject before ANY side effects (env mutation,
    # store hosting).
""", """    # Flag validation first: reject before ANY side effects (env mutation,
    # store hosting).
    if args.fleet_dir:
        log.error(f"--fleet-dir: {unported('fleet_dir')}")
        return 2
""", "--fleet-dir, whose modules are not ported, exits with an error naming them"),
        ("""        # JAX_COMPILATION_CACHE_DIR makes plain-JAX workers (no tpu_resiliency
        # import) cache too. Sweep HERE, before any worker starts, so a cache
        # corrupted between jobs is purged exactly once up front.
        os.environ[compile_cache.CACHE_DIR_ENV] = cache_dir
        os.environ["JAX_COMPILATION_CACHE_DIR"] = cache_dir""",
         """        # the compiler variables make workers that never import it cache too.
        # Sweep HERE, before any worker starts, so a cache corrupted between
        # jobs is purged exactly once up front.
        os.environ[compile_cache.CACHE_DIR_ENV] = cache_dir
        os.environ.update(compile_cache.compiler_cache_env(cache_dir))""",
         "torch.compile's cache variables"),
    ),
}


@pytest.mark.parametrize("path", sorted(COPIES))
def test_the_copy_equals_the_reference_but_for_its_listed_edits(path):
    ref = rewrite((REPO / "tpu_resiliency" / path).read_text())
    port = (REPO / "tpu_resiliency_torch" / path).read_text()
    if path in OWN_DOCSTRING:
        assert _DOCSTRING.match(port) and _DOCSTRING.match(ref)
        port = _DOCSTRING.sub(lambda m: _DOCSTRING.match(ref).group(0), port, count=1)
    for old, new, why in COPIES[path]:
        if isinstance(old, re.Pattern):
            assert why and len(old.findall(ref)) == 1, f"{path}: the edit's pattern is not unique"
            ref = old.sub(new, ref)
            continue
        assert why and ref.count(old) == 1, f"{path}: the edit's reference text is not unique"
        ref = ref.replace(old, new)
    if ref != port:
        import difflib

        diff = "".join(difflib.unified_diff(ref.splitlines(True), port.splitlines(True),
                                            "reference (rewritten)", "port", n=1))
        pytest.fail(f"{path} differs from the reference beyond its listed edits:\n{diff[:4000]}")


def test_every_copy_imports_nothing_of_the_reference():
    for path in COPIES:
        text = (REPO / "tpu_resiliency_torch" / path).read_text()
        assert not re.search(r"^\s*(from|import) tpu_resiliency\b(?!_torch)", text, re.M), path


#: The parallel model slice is a port, not a copy: its bodies are torch where the
#: reference's are JAX. Each departure from the reference's behaviour or interface is
#: listed here as (reference file, text only the reference holds, text the port holds
#: in its place, why); the port's file is the reference's path under
#: ``tpu_resiliency_torch/``.
PORT_DEPARTURES = (
    ("tpu_resiliency/parallel/ring_attention.py", "@functools.lru_cache(maxsize=8)",
     "``_cached_sharded_kernel`` cache is\ngone",
     "nothing is compiled: attn_fn looks up the sp group and the placements only"),
    ("tpu_resiliency/parallel/ring_attention.py", "lax.ppermute((k, v), axis_name, perm)",
     "k, v = shift((k, v), group)",
     "torch's send and receive are not differentiable: p2p.shift is the ring hop"),
    ("tpu_resiliency/parallel/pipeline.py", 'f32_boundary = mesh.devices.flat[0].platform == "cpu"',
     "The reference's float32 boundary (a workaround for an XLA CPU miscompile of bf16\n"
     "  all-reduces) is dropped",
     "the miscompile is XLA's; torch has none, so the carries keep their dtypes"),
    ("tpu_resiliency/parallel/pipeline.py", "lax.all_gather(_to_boundary(o), axis_name, axis=0)",
     "buf = read_from(buf, n_stages - 1, group)",
     "a broadcast from the last stage whose gradient reaches that stage once"),
    ("tpu_resiliency/parallel/pipeline.py", "lax.scan(\n                tick,",
     "for t in range(n_ticks):",
     "a Python loop over ticks; a stage skips its layers where it holds no microbatch"),
    ("examples/inprocess_restart_train.py",
     'ap.add_argument("--cpu", action="store_true", default=True)',
     'ap.add_argument("--device", default="",',
     "--cpu defaulted to True and could not be turned off; the card is the default"),
    ("examples/inprocess_restart_train.py", '"--devices-per-rank", type=int, default=1,',
     '"local_devices": 1,',
     "JAX's virtual devices per process have no counterpart: a rank drives one device"),
    ("examples/inprocess_restart_train.py", 'ctx = mp.get_context("fork")',
     'ctx = mp.get_context("spawn")',
     "the parent must not fork a process that may hold CUDA state"),
    ("examples/moe_pipeline_training.py", '"--tpu", action="store_true",',
     'p.add_argument("--world", type=int, default=1, help="rank processes")',
     "one process per rank (gloo with --device cpu) where the reference has 8 virtual "
     "devices in one"),
    ("examples/mesh_telemetry_training.py",
     'ap.add_argument("--coord-port", type=int, required=True,',
     'key = f"mesh_telemetry/group_port/',
     "jax.distributed's coordinator port: the group's address comes through the "
     "launcher's store"),
    ("scripts/bench_model.py", '"mfu_vs_v5e_peak": round(', '"mfu": mfu(n_params),',
     "the MFU is priced at the H100's bf16 peak, beside the matmul-only MFU"),
    ("scripts/bench_model.py", "# No device plane (CPU simulation): fall back to blocking wall clock.",
     '"timer": "cuda_events" if cuda else "host_clock",',
     "no fallback to the wall clock on the card; a CPU run reports no device metric"),
)


@pytest.mark.parametrize("ref_path,ref_text,port_text,why", PORT_DEPARTURES,
                         ids=[f"{p}:{i}" for i, (p, *_) in enumerate(PORT_DEPARTURES)])
def test_the_parallel_ports_list_their_departures(ref_path, ref_text, port_text, why):
    ref = (REPO / ref_path).read_text()
    port = (REPO / "tpu_resiliency_torch" / ref_path.removeprefix("tpu_resiliency/")).read_text()
    assert why and ref.count(ref_text) == 1, f"{ref_path}: {ref_text!r}"
    assert ref_text not in port and port_text in port, f"{ref_path}: {port_text!r}"
