"""Copies stay copies: each module the port copies from the JAX package (the support
of the in-process restart slice and the modules of ``inprocess/`` that hold no JAX)
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
    "platform/framing.py": (
        ('from typing import Any, Optional, Sequence\n\nLEN = ',
         None,  # the crc32c block, checked below
         "the bulk-frame checksum is a copy of the reference container format's "
         "choice: the port imports nothing of the JAX package"),
        ('''        if "crc32c" in header:
            # Layering note: the checksum implementation lives with the
            # container format (one algo tag for disk and wire); import
            # lazily, only for frames that actually carry a CRC.
            from tpu_resiliency_torch.checkpoint.format import CRC_ALGO, crc32c

''', '''        if "crc32c" in header:
''', "crc32c and CRC_ALGO are the module's own"),
    ),
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
}


def _framing_crc_block() -> str:
    """The port's framing.py between its typing import and ``LEN``: the crc32c copy."""
    port = (REPO / "tpu_resiliency_torch/platform/framing.py").read_text()
    head = "from typing import Any, Optional, Sequence\n"
    start = port.index(head) + len(head)
    block = port[start:port.index("\nLEN = ", start) + 1]
    # It is the reference container format's implementation, less its trailer tag.
    fmt = (REPO / "tpu_resiliency/checkpoint/format.py").read_text()
    for line in block.splitlines():
        code = line.strip()
        if code and not code.startswith(("#", '"""')):
            assert code in fmt, f"not from checkpoint/format.py: {line!r}"
    return head + block + "LEN = "


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
        if new is None:
            new = _framing_crc_block()
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
