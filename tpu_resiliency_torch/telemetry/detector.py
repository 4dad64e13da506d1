"""User-facing straggler-detection API: timed sections + callable wrapping + reports.

Port of ``tpu_resiliency/telemetry/detector.py``, the reference's
``straggler.Detector`` class-singleton (``straggler/straggler.py:86-408``):
``initialize`` / ``detection_section`` / ``wrap_callables`` / ``generate_report`` /
``generate_report_if_interval_elapsed`` / ``shutdown``.

- **Device timing.** Host wall time is recorded for every section entry
  (``sec/<name>``). Every ``profiling_interval``-th entry, a section that observed
  tensors synchronizes the current CUDA stream of each device those tensors lie on
  and records the device-inclusive duration (``dev/<name>``); a CPU tensor needs no
  wait. Per-kernel device times come from :mod:`device_profiler` windows as
  ``prog/`` and ``op/`` signals.
- **Aggregation.** With a store and several ranks, every rank publishes its summary
  to the store and the global ``[R, S]`` summary matrix is scored on ``device`` by
  the port's :class:`ReportGenerator`. With a :class:`MeshTelemetry` over the
  default process group (one row per rank, ``device_telemetry``), the store carries
  only the column agreement and the summaries ride the group's collectives.
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from typing import Any, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree

from tpu_resiliency_torch.exceptions import ResiliencyError
from tpu_resiliency_torch.platform.device import resolve_device
from tpu_resiliency_torch.telemetry.interval_tracker import ReportIntervalTracker
from tpu_resiliency_torch.telemetry.name_registry import NameRegistry
from tpu_resiliency_torch.telemetry.reporting import Report, ReportGenerator
from tpu_resiliency_torch.telemetry.ring_buffer import RingView, SignalRings
from tpu_resiliency_torch.utils import tracing
from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)

SECTION_PREFIX = "sec/"
DEVICE_PREFIX = "dev/"
PROGRAM_PREFIX = "prog/"
OP_PREFIX = "op/"


@dataclasses.dataclass(frozen=True)
class CallableId:
    """Identifies a method to wrap (reference ``straggler.py:34``)."""

    obj: Any
    name: str

    @property
    def display_name(self) -> str:
        owner = getattr(self.obj, "__name__", None) or type(self.obj).__name__
        return f"{owner}.{self.name}"


class _Section:
    """Yielded by ``detection_section``; lets user code register device outputs."""

    __slots__ = ("_observed",)

    def __init__(self):
        self._observed: list = []

    def observe(self, value):
        """Register tensors (any nesting of lists, tuples and dicts) produced in this
        section for the device-inclusive time."""
        self._observed.append(value)
        return value


def synchronize_observed(observed) -> None:
    """Wait for the current CUDA stream of every device a tensor in ``observed`` lies
    on; tensors on the CPU, and values that are not tensors, need no wait."""
    devices = {
        leaf.device for leaf in _pytree.tree_leaves(observed)
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"
    }
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


class Detector:
    """Class-level singleton, like the reference (``straggler/straggler.py:86``).

    ``initialize(device=None)`` scores on the CUDA card and raises without one; pass
    ``device="cpu"`` for the plain PyTorch path."""

    initialized: bool = False
    rank: int = 0
    world_size: int = 1
    store = None
    device: Optional[torch.device] = None
    profiling_interval: int = 1
    gather_on_rank0: bool = True
    scores_to_compute: tuple = ("relative_perf_scores", "individual_perf_scores")
    window: int = 128
    max_signals: int = 64

    _registry: Optional[NameRegistry] = None
    _signal_rings: Optional[SignalRings] = None
    _rings: dict = {}
    _entry_counts: dict = {}
    _interval_tracker: Optional[ReportIntervalTracker] = None
    _generator: Optional[ReportGenerator] = None
    _wrapped: list = []
    _use_kernel: bool = False
    _node_name: Optional[str] = None
    _mesh_telemetry = None  # Optional[MeshTelemetry]: the zero-gather report path

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def initialize(
        cls,
        scores_to_compute: Iterable[str] = ("relative_perf_scores", "individual_perf_scores"),
        gather_on_rank0: bool = True,
        profiling_interval: int = 1,
        report_time_interval: float = 60.0,
        *,
        rank: int = 0,
        world_size: int = 1,
        store=None,
        window: int = 128,
        max_signals: int = 64,
        use_kernel: bool = False,
        node_name: Optional[str] = None,
        device_telemetry=None,
        device=None,
    ) -> None:
        """``device_telemetry``: a :class:`~tpu_resiliency_torch.telemetry.sharded.MeshTelemetry`
        over the default process group with one row per Detector rank. When set — and
        the job runs one process per rank in that group (``dist.get_world_size() ==
        world_size``) — ``generate_report`` skips the store summary gather: the store
        carries only the column agreement, and per-rank summaries travel through the
        group's collectives. ``use_kernel`` reduces windows with the port's Hopper
        kernels, as on :class:`ReportGenerator`."""
        if cls.initialized:
            raise ResiliencyError("Detector already initialized")
        dev = resolve_device(device)
        cls.initialized = True
        cls.device = dev
        cls._mesh_telemetry = device_telemetry
        cls.scores_to_compute = tuple(scores_to_compute)
        cls.gather_on_rank0 = gather_on_rank0
        cls.profiling_interval = max(1, profiling_interval)
        cls.rank = rank
        cls.world_size = world_size
        cls.store = store
        cls.window = window
        cls.max_signals = max_signals
        cls._use_kernel = use_kernel
        cls._node_name = node_name
        cls._registry = NameRegistry(max_signals)
        # One pooled collector for every signal; ring index == the registry's
        # column id, so names and storage stay aligned.
        cls._signal_rings = SignalRings(max_signals, window)
        cls._rings = {}
        cls._entry_counts = {}
        cls._wrapped = []
        cls._interval_tracker = ReportIntervalTracker(
            report_time_interval, store=store, world_size=world_size, rank=rank
        )
        cls._generator = ReportGenerator(
            world_size=world_size, max_signals=max_signals, use_kernel=use_kernel, device=dev
        )

    @classmethod
    def shutdown(cls) -> None:
        for obj, name, orig in cls._wrapped:
            setattr(obj, name, orig)
        cls._wrapped = []
        cls._rings = {}
        cls._signal_rings = None
        cls._entry_counts = {}
        cls._registry = None
        cls._generator = None
        cls._interval_tracker = None
        cls._mesh_telemetry = None
        cls.store = None
        cls.device = None
        cls.initialized = False

    # -- recording ---------------------------------------------------------

    @classmethod
    def _ring(cls, signal: str) -> RingView:
        ring = cls._rings.get(signal)
        if ring is None:
            col = cls._registry.get(signal)  # reserve the column
            ring = cls._rings[signal] = cls._signal_rings.view(col)
        return ring

    @classmethod
    def _record(cls, signal: str, seconds: float) -> None:
        cls._ring(signal).push(seconds)

    @classmethod
    @contextmanager
    def detection_section(cls, name: str, profile_device: bool = True):
        """Time a block of code; optionally wait for observed device outputs.

        Reference: ``detection_section`` ctx manager (``straggler.py:288-349``).
        """
        if not cls.initialized:
            raise ResiliencyError("Detector.initialize() must be called first")
        count = cls._entry_counts.get(name, 0)
        cls._entry_counts[name] = count + 1
        profile_now = profile_device and (count % cls.profiling_interval == 0)
        section = _Section()
        start = time.perf_counter_ns()
        try:
            yield section
        finally:
            host_elapsed = (time.perf_counter_ns() - start) * 1e-9
            cls._record(SECTION_PREFIX + name, host_elapsed)
            if profile_now and section._observed:
                synchronize_observed(section._observed)
                dev_elapsed = (time.perf_counter_ns() - start) * 1e-9
                cls._record(DEVICE_PREFIX + name, dev_elapsed)

    @classmethod
    def wrap_callables(cls, callable_ids: Iterable[CallableId], profile_device: bool = True):
        """Monkey-patch methods into detection sections (reference ``straggler.py:368-400``).

        Wrapped callables auto-observe the tensors in their return value, so every
        ``profiling_interval``-th call records a device-inclusive duration.
        """
        for cid in callable_ids:
            orig = getattr(cid.obj, cid.name)
            section_name = cid.display_name

            def make_wrapper(orig_fn, sname):
                def wrapper(*args, **kwargs):
                    with cls.detection_section(sname, profile_device=profile_device) as sec:
                        out = orig_fn(*args, **kwargs)
                        if profile_device:
                            sec.observe(out)
                        return out

                wrapper.__name__ = getattr(orig_fn, "__name__", sname)
                wrapper.__wrapped__ = orig_fn
                return wrapper

            setattr(cid.obj, cid.name, make_wrapper(orig, section_name))
            cls._wrapped.append((cid.obj, cid.name, orig))

    @classmethod
    def record_program_samples(cls, samples: dict[str, list[float]]) -> None:
        """Feed per-region device times (``DeviceTimeProfiler.drain()``) into the
        scored matrix as ``prog/...`` signals (reference ``straggler.py:198-226``
        kernel summaries)."""
        cls._record_samples(PROGRAM_PREFIX, samples)

    @classmethod
    def record_op_samples(cls, samples: dict[str, list[float]]) -> None:
        """Feed per-kernel device times (``DeviceTimeProfiler.drain_ops()``,
        ``collect_ops=True``) into the scored matrix as ``op/...`` signals — the
        reference's per-kernel CUPTI stream (``CuptiProfiler.cpp:168-203``)."""
        cls._record_samples(OP_PREFIX, samples)

    @classmethod
    def _record_samples(cls, prefix: str, samples: dict[str, list[float]]) -> None:
        if not cls.initialized:
            raise ResiliencyError("Detector.initialize() must be called first")
        for name, secs in samples.items():
            ring = cls._ring(prefix + name)
            for sec in secs:
                ring.push(sec)

    # -- summaries ---------------------------------------------------------

    @classmethod
    def local_summary(cls) -> dict[str, dict[str, float | int]]:
        """Per-signal {median, total, count} from the host rings."""
        out = {}
        for name, ring in cls._rings.items():
            if len(ring):
                st = ring.stats()
                out[name] = {
                    "median": st["median"],
                    "total": st["total"],
                    "count": int(st["count"]),
                }
        return out

    @classmethod
    def _reset_rings(cls) -> None:
        for ring in cls._rings.values():
            ring.reset()
        # entry counts persist: profiling cadence continues across reports

    # -- report generation -------------------------------------------------

    COLUMNS_KEY = "telemetry/columns"

    @classmethod
    def _sync_columns(cls) -> tuple[str, ...]:
        """Agree on a global, append-only signal→column order via store CAS.

        Per-rank registries assign indices in first-use order, which differs across
        ranks; the group summary path aligns columns *positionally*, so it needs one
        authoritative order. A CAS loop appends locally-new names (sorted) to a single
        store tuple; every rank then adopts the same list. Append-only ⇒ per-column
        carried state (EWMA / historical min) in the MeshTelemetry stays valid across
        rounds and late joiners.
        """
        local = set(cls._rings)
        while True:
            cur = cls.store.try_get(cls.COLUMNS_KEY)
            cur_t = tuple(cur) if cur else ()
            missing = sorted(local - set(cur_t))
            if not missing:
                break
            ok, _ = cls.store.compare_set(cls.COLUMNS_KEY, cur, cur_t + tuple(missing))
            if ok:
                break
        cls.store.barrier("telemetry/columns_sync", cls.rank, cls.world_size, 300.0)
        return tuple(cls.store.get(cls.COLUMNS_KEY, timeout=60.0))

    @classmethod
    def _generate_mesh_report(cls, local: dict) -> Optional[Report]:
        """The zero-gather report path: store for column names only, summaries ride
        the group (``MeshTelemetry.report_from_summary``)."""
        mt = cls._mesh_telemetry
        names = cls._sync_columns()
        cap = mt.n_signals
        if len(names) > cap:
            # A report round must never take training down. The agreed column list
            # is identical on every rank (store CAS), so every rank makes this same
            # decision for this and all future rounds: drop to the store path.
            log.warning(
                f"{len(names)} signals exceed MeshTelemetry capacity {cap}; "
                "falling back to the store summary path permanently (raise the "
                "mesh signal capacity, or record fewer dynamic signals)"
            )
            cls._mesh_telemetry = None
            return None  # caller retries via the store path
        med = np.full((1, cap), np.inf, dtype=np.float32)
        wgt = np.zeros((1, cap), dtype=np.float32)
        cnt = np.zeros((1, cap), dtype=np.int32)
        col = {n: j for j, n in enumerate(names)}
        for n, st in local.items():
            j = col.get(n)
            if j is None:
                continue
            med[0, j] = st["median"]
            wgt[0, j] = st["total"]
            cnt[0, j] = st["count"]
        report = mt.report_from_summary(med, wgt, cnt, rank=cls.rank, signal_names=names)
        cls._reset_rings()
        if cls.gather_on_rank0 and cls.rank != 0:
            return None
        return report

    @classmethod
    def generate_report(cls) -> Optional[Report]:
        """Aggregate summaries across ranks and run the device scoring round.

        Multi-rank: every rank publishes its summary to the store, joins a barrier,
        then scores the global summary matrix on the device (every rank gets the
        global view; ``gather_on_rank0`` only controls whether non-zero ranks build
        the full Report or return None, for API parity with the reference).
        Reference: ``generate_report`` (``straggler.py:228-245``). Kept in the span
        ring as ``detector.report``: the summary, the scoring and the report built on
        the host.
        """
        with tracing.ring_span("detector.report"):
            return cls._generate_report()

    @classmethod
    def _generate_report(cls) -> Optional[Report]:
        if not cls.initialized:
            raise ResiliencyError("Detector.initialize() must be called first")
        local = cls.local_summary()
        if (
            cls._mesh_telemetry is not None
            and cls.store is not None
            and cls.world_size > 1
            and dist.is_initialized()
            and dist.get_world_size() == cls.world_size
        ):
            report = cls._generate_mesh_report(local)
            if cls._mesh_telemetry is not None:
                return report
            # Capacity fallback tripped mid-round: continue into the store path.
        if cls.store is not None and cls.world_size > 1:
            round_idx = cls._generator.iteration
            ns = f"telemetry/round/{round_idx}"
            cls._registry.publish(cls.store, key=f"{ns}/names")
            cls.store.set(f"{ns}/summary/{cls.rank}", local)
            cls.store.barrier(f"{ns}/publish", cls.rank, cls.world_size, 300.0)
            cls._registry.merge(cls.store, key=f"{ns}/names")
            # One batched fetch, not O(world) sequential round-trips; the barrier
            # above guarantees every rank's summary is present. (prefix_get keys
            # come back relative to the store *view*, so index by full key.)
            raw = cls.store.prefix_get(f"{ns}/summary/")
            summaries = [
                raw.get(f"{ns}/summary/{r}", {}) for r in range(cls.world_size)
            ]
            if cls.rank == 0 and round_idx > 0:
                # Everyone is past round round_idx-1 (they joined this round's
                # barrier), so its namespace is garbage; without this the store
                # grows for the job's lifetime. Trailing '/' keeps round 1 from
                # matching round 10.
                cls.store.prefix_clear(f"telemetry/round/{round_idx - 1}/")
        else:
            summaries = [local]

        names = cls._registry.names()
        s = len(names)
        if s == 0:
            return None
        r_world = max(cls.world_size, 1)
        medians = np.full((r_world, s), np.inf, dtype=np.float32)
        weights = np.zeros((r_world, s), dtype=np.float32)
        counts = np.zeros((r_world, s), dtype=np.int32)
        col = {n: j for j, n in enumerate(names)}
        for r, summary in enumerate(summaries):
            for n, st in summary.items():
                j = col.get(n)
                if j is None:
                    continue
                medians[r, j] = st["median"]
                weights[r, j] = st["total"]
                counts[r, j] = st["count"]

        def put(x):
            return torch.from_numpy(x).to(cls.device)

        report = cls._generator.generate_summary_report(
            put(medians), put(weights), put(counts), names, rank=cls.rank,
        )
        cls._reset_rings()
        if cls.gather_on_rank0 and cls.rank != 0:
            return None
        return report

    @classmethod
    def generate_report_if_interval_elapsed(cls) -> Optional[Report]:
        """Per-iteration hook (reference ``straggler.py:247-262``)."""
        cls._interval_tracker.iter_increase()
        if not cls._interval_tracker.is_interval_elapsed():
            return None
        return cls.generate_report()
