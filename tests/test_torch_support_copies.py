"""Copies stay copies: each module the port copies from the JAX package (the support
of the in-process restart slice, the modules of ``inprocess/`` that hold no JAX, and
the checkpoint layer but for ``checkpoint/state_dict.py`` and ``staging.py``, which
are ports of their own) must equal the reference's text with its imports rewritten from ``tpu_resiliency.``
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
    "inprocess/wrap.py": "says what the port leaves out (the compilation cache)",
}

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
    "inprocess/wrap.py": (
        ('''        self._atomic_lock = threading.RLock()

        # Persistent compilation cache (launcher --compile-cache-dir): applied
        # BEFORE the wrapped fn can trace/compile anything, so a restarted
        # incarnation's first step loads the previous round's executables.
        # One-shot per process; records the compile_cache event
        # (hit / miss / miss_corrupt + bytes) that feeds
        # tpu_compile_cache_total{outcome} and the goodput ledger's restart
        # attribution. Failures degrade to a cold compile, never an error.
        try:
            from tpu_resiliency_torch.platform import compile_cache

            compile_cache.apply_from_env()
        except Exception:
            log.debug("compile cache apply failed", exc_info=True)
''', '''        self._atomic_lock = threading.RLock()
''', "the port has no compiled programs yet: platform/compile_cache.py is not ported"),
    ),
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
