"""Thread-safe metrics registry with Prometheus exposition + events bridge.

The reference NVRx emits torchelastic-style structured events and ``@prof``
timings but ships no aggregation — its own tests grep log lines. This module is
the missing operator surface: Counter / Gauge / Histogram primitives behind a
registry, rendered either as Prometheus text exposition (scrapeable from a
sidecar) or as a JSON snapshot file, and fed from the structured event stream
two ways:

- **live**: :class:`MetricsSink` is an ``events.add_sink`` sink — one
  ``record()`` call feeds both the JSONL stream and the registry;
- **post-hoc**: :func:`aggregate` replays a finished run's JSONL into a fresh
  registry (``tools/metrics_dump.py``), so "how many restarts, p95 rendezvous
  time, checkpoint save latency" never again means replaying raw JSONL by hand.

Both paths share one kind→metric mapping (:func:`observe_record`): the live
sink converts each :class:`~tpu_resiliency_torch.utils.events.Event` to the same flat
record shape the JSONL file holds and routes it through the identical code.
"""

from __future__ import annotations

import bisect
import json
import math
import os
import random
import re
import threading
import time
from typing import Any, Iterable, Optional, Sequence

from tpu_resiliency_torch.utils.events import RESERVED_KEYS
from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)

#: Prometheus histogram bucket upper bounds (seconds) tuned for restart
#: machinery: sub-ms store ops up through multi-minute rendezvous holds.
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)

#: Sample reservoir cap per histogram: quantiles stay exact until a series
#: outgrows this, then degrade to uniform reservoir sampling (bounded RSS on a
#: multi-day run; the Prometheus buckets are exact regardless).
RESERVOIR_SIZE = 8192

#: Bucket bounds (MB/s) for shard-transfer throughput histograms: spans a
#: congested cross-host DCN link up through loopback/NVMe-class rates.
THROUGHPUT_BUCKETS_MBPS = (
    1, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000, 25000,
)

#: Bucket bounds (seconds) for the checkpoint foreground-blocked window: the
#: pipelined engine targets sub-millisecond, the legacy blocking D2H path sits
#: in the tens-of-ms-to-seconds range — both must resolve on one histogram.
FOREGROUND_BUCKETS_S = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

#: Bucket bounds (seconds) for training-step wall clock (``tpu_step_seconds``):
#: toy CPU loops (ms) up through big-model steps (minutes).
STEP_BUCKETS_S = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0, 120.0, 300.0,
)

#: Symmetric bucket bounds (seconds) for the autoscale forecast error
#: (``tpu_autoscale_predicted_vs_realized`` observes realized − predicted):
#: a well-calibrated controller clusters around zero; the signed tails show
#: which direction the cost model misses in.
FORECAST_ERROR_BUCKETS_S = (
    -300.0, -60.0, -10.0, -1.0, -0.1, 0.0, 0.1, 1.0, 10.0, 60.0, 300.0,
)

#: An ``iteration_start`` delta larger than this is not a step — it's a gap
#: (hang, restart, operator pause) and must not pollute the step histogram or
#: the goodput ledger's ``train`` attribution (``utils/goodput.py`` shares it).
#: Default 300 s; tune per workload via ``$TPU_RESILIENCY_STEP_GAP_MAX`` (see
#: :func:`step_gap_max_s`) — a job whose legitimate steps include multi-minute
#: compiles or evals would otherwise see them misattributed as downtime.
STEP_GAP_MAX_S = 300.0

#: Env override for :data:`STEP_GAP_MAX_S` (seconds, must parse > 0).
STEP_GAP_ENV = "TPU_RESILIENCY_STEP_GAP_MAX"


def step_gap_max_s() -> float:
    """The effective step-gap cap: ``$TPU_RESILIENCY_STEP_GAP_MAX`` when it
    parses to a positive number, else the 300 s default. Read per call so the
    live sink, a post-hoc ``aggregate()``, and the goodput ledger all honor
    the same setting without restart-ordering surprises; an unparseable or
    non-positive value falls back rather than raising — a typo'd env var must
    not take down metrics."""
    raw = os.environ.get(STEP_GAP_ENV)
    if raw:
        try:
            v = float(raw)
            if v > 0:
                return v
        except ValueError:
            pass
    return STEP_GAP_MAX_S

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_BAD = re.compile(r"[^a-zA-Z0-9_]")


def _sanitize(name: str) -> str:
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not out or not _NAME_OK.match(out):
        out = "_" + out
    return out


class Counter:
    """Monotonic float counter."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-write-wins instantaneous value.

    Each write stamps ``ts`` (wall clock) so cross-registry merges can keep
    last-writer-wins semantics: :meth:`merge_lww` takes the (ts, value) pair
    with the larger timestamp, value-tiebroken — a commutative, associative
    rule, so a tree of partial merges equals the flat merge.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0
        self.ts = 0.0

    def set(self, v: float, ts: Optional[float] = None) -> None:
        with self._lock:
            self._value = float(v)
            self.ts = time.time() if ts is None else float(ts)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n
            self.ts = time.time()

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    def merge_lww(self, v: float, ts: float) -> None:
        """Adopt ``(v, ts)`` iff it out-ranks the current write."""
        with self._lock:
            if (float(ts), float(v)) > (self.ts, self._value):
                self._value = float(v)
                self.ts = float(ts)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Prometheus-style cumulative-bucket histogram + bounded sample reservoir.

    Buckets give exact exposition-format counts; the reservoir gives quantiles
    (exact below :data:`RESERVOIR_SIZE` observations, sampled beyond — the
    sampler is seeded so aggregating the same JSONL twice answers the same).
    """

    def __init__(self, buckets: Optional[Iterable[float]] = None) -> None:
        self._lock = threading.Lock()
        self.bounds = tuple(sorted(buckets)) if buckets else DEFAULT_BUCKETS
        self.bucket_counts = [0] * (len(self.bounds) + 1)  # +Inf tail
        self.count = 0
        self.sum = 0.0
        self._samples: list[float] = []
        self._rng = random.Random(0x5EED)

    def observe(self, v: float) -> None:
        v = float(v)
        if math.isnan(v):
            return
        with self._lock:
            self.count += 1
            self.sum += v
            self.bucket_counts[bisect.bisect_left(self.bounds, v)] += 1
            if len(self._samples) < RESERVOIR_SIZE:
                self._samples.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < RESERVOIR_SIZE:
                    self._samples[j] = v

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile over the reservoir; NaN when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        with self._lock:
            if not self._samples:
                return float("nan")
            ordered = sorted(self._samples)
        idx = min(len(ordered) - 1, max(0, math.ceil(q * len(ordered)) - 1))
        return ordered[idx]

    def merge_counts(
        self, counts: Sequence[int], count: float, total: float
    ) -> None:
        """Bucket-wise add another histogram's state (same bounds required).

        The reservoir is NOT merged — a merged histogram answers exposition
        (buckets/count/sum) exactly; quantiles stay with the per-process
        registries that observed the raw samples."""
        counts = list(counts)
        if len(counts) != len(self.bucket_counts):
            raise ValueError(
                f"bucket count mismatch: {len(counts)} != "
                f"{len(self.bucket_counts)}"
            )
        with self._lock:
            for i, n in enumerate(counts):
                self.bucket_counts[i] += int(n)
            self.count += int(count)
            self.sum += float(total)


def _plain_json(value: Any) -> Any:
    """Restrict a value tree to plain, strict-JSON types.

    Non-finite floats become ``None`` (``NaN``/``Infinity`` are not JSON and
    don't round-trip), numeric-coercible scalars (numpy, Decimal, ...) are
    coerced to ``float``, and anything else is dropped to ``None`` with a
    warning — so a snapshot consumer (``merge``, a dashboard, a scraper)
    never meets a ``repr``-stringified object where a number belongs."""
    if value is None or isinstance(value, (str, bool, int)):
        return value
    if isinstance(value, float):
        return value if math.isfinite(value) else None
    if isinstance(value, dict):
        return {str(k): _plain_json(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain_json(v) for v in value]
    try:
        f = float(value)
        return f if math.isfinite(f) else None
    except (TypeError, ValueError):
        log.warning(
            f"dropping non-JSON value {type(value).__name__} from metrics snapshot"
        )
        return None


class MetricsRegistry:
    """Name+labels → metric instance; the creation call is the lookup call.

    ``registry.counter("tpu_restarts_total", layer="injob").inc()`` creates the
    series on first use and returns the existing instance after — callers never
    pre-declare. A name is bound to one type and one label-key set for the
    registry's lifetime (Prometheus exposition requires it).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        #: name -> (kind, help)
        self._families: dict[str, tuple[str, str]] = {}
        #: (name, labels_tuple) -> metric
        self._series: dict[tuple, Any] = {}
        #: scratch space for stateful bridge mappings (see :meth:`aux_state`)
        self._aux: dict[str, dict] = {}

    def aux_state(self, key: str) -> dict:
        """Per-registry scratch dict for stateful event→metric mappings.

        ``observe_record`` is mostly stateless, but some derivations need
        memory (e.g. ``tpu_step_seconds`` = delta between consecutive
        ``iteration_start`` records of one pid). Keeping that state ON the
        registry — not module-global — preserves live/post-hoc parity: the
        live sink and a fresh ``aggregate()`` replay each carry their own."""
        with self._lock:
            return self._aux.setdefault(key, {})

    def _get(self, kind: str, ctor, name: str, help: str, labels: dict):
        name = _sanitize(name)
        key = (name, tuple(sorted(
            (_LABEL_BAD.sub("_", k), str(v)) for k, v in labels.items()
        )))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                self._families[name] = (kind, help)
            elif fam[0] != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam[0]}, not {kind}"
                )
            m = self._series.get(key)
            if m is None:
                m = self._series[key] = ctor()
            return m

    # Positional-only metric/help/buckets params: the label namespace is open
    # (``name=...``, ``help=...`` are legitimate label keys).
    def counter(self, name: str, help: str = "", /, **labels) -> Counter:
        return self._get("counter", Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", /, **labels) -> Gauge:
        return self._get("gauge", Gauge, name, help, labels)

    def histogram(
        self, name: str, help: str = "",
        buckets: Optional[Iterable[float]] = None, /, **labels,
    ) -> Histogram:
        return self._get(
            "histogram", lambda: Histogram(buckets), name, help, labels
        )

    def histograms(self, name: str) -> dict[tuple, Histogram]:
        """Every series of histogram family ``name`` keyed by its label tuple."""
        name = _sanitize(name)
        with self._lock:
            return {
                k[1]: m for k, m in self._series.items() if k[0] == name
                and isinstance(m, Histogram)
            }

    # -- rendering ---------------------------------------------------------

    @staticmethod
    def _escape_label_value(v: str) -> str:
        """Prometheus text format 0.0.4 label-value escaping: backslash,
        double-quote, and line-feed — an unescaped peer address or file path
        must never produce unparseable exposition text."""
        return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")

    @staticmethod
    def _escape_help(v: str) -> str:
        """HELP text escaping per 0.0.4: backslash and line-feed only."""
        return v.replace("\\", "\\\\").replace("\n", "\\n")

    @classmethod
    def _label_str(cls, labels: tuple, extra: str = "") -> str:
        parts = [f'{k}="{cls._escape_label_value(str(v))}"' for k, v in labels]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    @staticmethod
    def _fmt(v: float) -> str:
        if v == math.inf:
            return "+Inf"
        if float(v).is_integer():
            return str(int(v))
        return repr(float(v))

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            families = dict(self._families)
            series = dict(self._series)
        lines: list[str] = []
        for name in sorted(families):
            kind, help = families[name]
            if help:
                lines.append(f"# HELP {name} {self._escape_help(help)}")
            lines.append(f"# TYPE {name} {kind}")
            for (sname, labels), m in sorted(series.items()):
                if sname != name:
                    continue
                if isinstance(m, (Counter, Gauge)):
                    lines.append(
                        f"{name}{self._label_str(labels)} {self._fmt(m.value)}"
                    )
                else:
                    cum = 0
                    for bound, n in zip(m.bounds, m.bucket_counts):
                        cum += n
                        le = self._label_str(labels, f'le="{self._fmt(bound)}"')
                        lines.append(f"{name}_bucket{le} {cum}")
                    le = self._label_str(labels, 'le="+Inf"')
                    lines.append(f"{name}_bucket{le} {m.count}")
                    lines.append(
                        f"{name}_sum{self._label_str(labels)} {self._fmt(m.sum)}"
                    )
                    lines.append(
                        f"{name}_count{self._label_str(labels)} {m.count}"
                    )
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> dict:
        """JSON-serializable state: counters/gauges by series, histograms with
        count/sum/quantiles AND raw buckets (the operator's one-call answer, no
        PromQL needed — and :meth:`merge`'s input format).

        Every value is a plain JSON type: non-finite floats become ``null``
        and anything non-coercible is dropped with a warning, so a snapshot
        round-trips through strict JSON and ``merge`` can trust its input."""
        with self._lock:
            families = dict(self._families)
            series = dict(self._series)
        out: dict = {"ts": time.time(), "metrics": {}}
        for (name, labels), m in sorted(series.items()):
            kind, help = families[name]
            entry: dict = {"type": kind, "labels": dict(labels), "help": help}
            if isinstance(m, Counter):
                entry["value"] = m.value
            elif isinstance(m, Gauge):
                entry["value"] = m.value
                entry["ts"] = m.ts
            else:
                entry.update(
                    count=m.count,
                    sum=m.sum,
                    p50=m.quantile(0.50),
                    p90=m.quantile(0.90),
                    p95=m.quantile(0.95),
                    p99=m.quantile(0.99),
                    buckets={
                        "bounds": list(m.bounds),
                        "counts": list(m.bucket_counts),
                    },
                )
            out["metrics"].setdefault(name, []).append(entry)
        return _plain_json(out)

    def merge(self, snapshot: dict, extra_labels: Optional[dict] = None) -> None:
        """Fold one :meth:`snapshot` document into this registry.

        The merge algebra (what makes a tree of partial merges equal the flat
        merge — associative AND commutative):

        - **counters** sum;
        - **gauges** are last-writer-wins by each entry's ``ts`` (value
          tie-break — see :meth:`Gauge.merge_lww`);
        - **histograms** add bucket-wise (bounds must match; count and sum
          add; quantile reservoirs are not transported — buckets are the
          merged truth).

        This is the aggregation step of the push path: every rank publishes
        its snapshot up the store topology and any node can fold the set —
        or a subtree's partial fold — into one job-level registry without
        ever touching another rank's files.

        ``extra_labels`` are stamped onto every series of the incoming
        snapshot *before* the fold (overriding same-named snapshot labels) —
        the fleet-federation step: merging two jobs' snapshots under distinct
        ``job=`` labels keeps their same-named series separate instead of
        summing ``tpu_restarts_total`` across unrelated jobs
        (``tools/fleetd.py``). Series that already carry the label from an
        earlier labelled merge re-merge idempotently, so a tree of labelled
        partial merges still equals the flat labelled merge.
        """
        metrics = snapshot.get("metrics") if isinstance(snapshot, dict) else None
        if not isinstance(metrics, dict):
            raise ValueError("not a metrics snapshot (missing 'metrics' dict)")
        default_ts = snapshot.get("ts")
        if not isinstance(default_ts, (int, float)):
            default_ts = 0.0
        extra = {
            str(k): str(v) for k, v in (extra_labels or {}).items()
        }
        for name, entries in sorted(metrics.items()):
            if not isinstance(entries, list):
                continue
            for e in entries:
                if not isinstance(e, dict):
                    continue
                kind = e.get("type")
                labels = {
                    str(k): str(v)
                    for k, v in (e.get("labels") or {}).items()
                }
                labels.update(extra)
                help = e.get("help") or ""
                if kind == "counter":
                    v = e.get("value")
                    if isinstance(v, (int, float)) and v > 0:
                        self.counter(name, help, **labels).inc(v)
                elif kind == "gauge":
                    v = e.get("value")
                    ts = e.get("ts")
                    if isinstance(v, (int, float)):
                        self.gauge(name, help, **labels).merge_lww(
                            v, ts if isinstance(ts, (int, float)) else default_ts
                        )
                elif kind == "histogram":
                    b = e.get("buckets") or {}
                    bounds = tuple(b.get("bounds") or ())
                    counts = b.get("counts") or []
                    if not bounds or len(counts) != len(bounds) + 1:
                        continue  # pre-merge-format snapshot: not mergeable
                    h = self.histogram(name, help, bounds, **labels)
                    if h.bounds != bounds:
                        raise ValueError(
                            f"histogram {name!r}: bucket bounds mismatch "
                            f"({h.bounds} != {bounds})"
                        )
                    h.merge_counts(counts, e.get("count") or 0, e.get("sum") or 0.0)

    def write_json(self, path: str) -> None:
        """Atomic snapshot-to-file (tmp + rename): a scraper reading the path
        mid-write never sees a torn document. The document is strict JSON
        (``snapshot`` already coerced or dropped anything that isn't)."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.snapshot(), f, indent=2, allow_nan=False)
            f.write("\n")
        os.replace(tmp, path)


_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (what :class:`MetricsSink` feeds)."""
    return _default_registry


# -- events → metrics bridge ------------------------------------------------

def observe_record(rec: dict, reg: MetricsRegistry) -> None:
    """Route one event record (JSONL dict or flattened Event) into metrics.

    The single kind→metric mapping shared by the live sink and the post-hoc
    aggregator; unknown kinds still land in ``tpu_events_total`` so a new
    emitter is visible before this table learns its name.
    """
    kind = rec.get("kind")
    if not isinstance(kind, str):
        return
    reg.counter("tpu_events_total", "structured events by kind", kind=kind).inc()
    if kind == "rendezvous_round":
        reg.counter(
            "tpu_rendezvous_rounds_total", "rendezvous rounds entered"
        ).inc()
        if isinstance(rec.get("world_size"), (int, float)):
            reg.gauge("tpu_world_size", "last observed world size").set(
                rec["world_size"]
            )
        if isinstance(rec.get("round"), (int, float)):
            reg.gauge("tpu_rendezvous_round", "last rendezvous round").set(
                rec["round"]
            )
    elif kind == "iteration_start":
        # Stateful derivation: a step's wall clock is the delta between this
        # rank's consecutive iteration_start markers. State lives on the
        # registry (aux_state) so the live sink and a post-hoc aggregate()
        # replay compute the identical histogram. Only a strictly-consecutive
        # iteration within the gap cap counts — a repeat after an in-process
        # restart, or a multi-minute gap, is downtime, not a step.
        ts, it = rec.get("ts"), rec.get("iteration")
        if isinstance(ts, (int, float)) and isinstance(it, int):
            st = reg.aux_state("step_timing")
            prev = st.get(rec.get("pid"))
            if (
                prev is not None and it == prev[1] + 1
                and 0 < ts - prev[0] <= step_gap_max_s()
            ):
                reg.histogram(
                    "tpu_step_seconds",
                    "training step wall clock (consecutive iteration_start "
                    "deltas per rank)",
                    STEP_BUCKETS_S,
                ).observe(ts - prev[0])
            st[rec.get("pid")] = (ts, it)
    elif kind == "goodput_update":
        # Emitted by the goodput ledger (utils/goodput.py) with per-phase
        # attribution DELTAS since its previous publish, so replaying the
        # stream reconstructs the same monotonic totals the live sink held.
        phases = rec.get("phases")
        if isinstance(phases, dict):
            for phase, delta in sorted(phases.items()):
                if isinstance(delta, (int, float)) and delta > 0:
                    reg.counter(
                        "tpu_time_attributed_seconds_total",
                        "job wall clock attributed by the goodput ledger "
                        "(train | ckpt_stall | restart | incident | "
                        "unattributed)",
                        phase=str(phase),
                    ).inc(delta)
        if isinstance(rec.get("ratio"), (int, float)):
            reg.gauge(
                "tpu_goodput_ratio",
                "fraction of job wall clock attributed to training",
            ).set(rec["ratio"])
    elif kind == "restart_requested":
        reg.counter(
            "tpu_restarts_total", "restart rounds by layer", layer="injob"
        ).inc()
    elif kind == "restart_signalled":
        reg.counter(
            "tpu_restarts_total", "restart rounds by layer", layer="inprocess"
        ).inc()
    elif kind == "restart_budget":
        if isinstance(rec.get("used"), (int, float)):
            reg.gauge(
                "tpu_restart_budget_used", "restart budget consumed"
            ).set(rec["used"])
    elif kind == "worker_failed":
        reg.counter("tpu_worker_failures_total", "worker process failures").inc()
    elif kind == "worker_promoted":
        # outcome: promoted | dead_at_promotion | cold_fallback (pre-label
        # events from older builds read as plain promotions)
        reg.counter(
            "tpu_spare_promotions_total",
            "warm-spare promotion attempts by outcome "
            "(promoted | dead_at_promotion | cold_fallback)",
            outcome=str(rec.get("outcome", "promoted")),
        ).inc()
    elif kind == "warm_spare_pool":
        if isinstance(rec.get("warm"), (int, float)):
            reg.gauge(
                "tpu_warm_spares_warm",
                "parked spares currently warm (ready to promote)",
            ).set(rec["warm"])
    elif kind == "rendezvous_fast_path":
        reg.counter(
            "tpu_rendezvous_fast_path_total",
            "restart fast-path rendezvous attempts by outcome "
            "(reused | shrink | abandoned)",
            outcome=str(rec.get("outcome", "?")),
        ).inc()
    elif kind == "compile_cache":
        reg.counter(
            "tpu_compile_cache_total",
            "persistent compilation cache applications by outcome "
            "(hit | miss | miss_corrupt)",
            outcome=str(rec.get("outcome", "?")),
        ).inc()
        if isinstance(rec.get("bytes"), (int, float)):
            reg.gauge(
                "tpu_compile_cache_bytes",
                "persistent compilation cache size at last application",
            ).set(rec["bytes"])
    elif kind in ("hang_detected", "health_terminated"):
        reg.counter(
            "tpu_rank_terminations_total", "monitor-initiated terminations",
            cause="hang" if kind == "hang_detected" else "health",
        ).inc()
    elif kind == "kill_ladder":
        reg.counter(
            "tpu_kill_ladder_total", "termination signals by step",
            step=str(rec.get("step", "?")),
        ).inc()
    elif kind == "stack_dump":
        reg.counter(
            "tpu_stack_dumps_total",
            "all-thread stack captures by reason (hang forensics)",
            reason=str(rec.get("reason", "?")).split(":", 1)[0],
        ).inc()
    elif kind == "hang_census":
        # One census per hang verdict (the launcher's failure path), not per
        # /hangz scrape — scrapes are read-only so the suspect counter stays
        # "suspects per incident", not "suspects times curl".
        suspects = rec.get("suspects")
        if isinstance(suspects, list):
            for s in suspects:
                r = s.get("rank") if isinstance(s, dict) else s
                if isinstance(r, int):
                    reg.counter(
                        "tpu_hang_suspects_total",
                        "ranks implicated by a hang census, by rank",
                        rank=str(r),
                    ).inc()
        blocked = rec.get("blocked")
        if isinstance(blocked, dict):
            for r, secs in sorted(blocked.items()):
                if isinstance(secs, (int, float)):
                    reg.gauge(
                        "tpu_rank_blocked_seconds",
                        "per-rank stuck duration at the last hang census",
                        rank=str(r),
                    ).set(secs)
        if isinstance(rec.get("barrier_waiters"), (int, float)):
            reg.gauge(
                "tpu_barrier_waiters",
                "ranks parked in open barrier rounds at the last census",
            ).set(rec["barrier_waiters"])
    elif kind == "budget_exhausted":
        reg.counter(
            "tpu_budget_exhausted_total", "restart budget exhaustions"
        ).inc()
    elif kind == "ckpt_saved":
        reg.counter("tpu_ckpt_saves_total", "durable checkpoint saves").inc()
        if isinstance(rec.get("bytes"), (int, float)):
            reg.histogram(
                "tpu_ckpt_bytes", "checkpoint bytes per save",
                (2**10, 2**16, 2**20, 2**24, 2**27, 2**30, 2**33, 2**36),
            ).observe(rec["bytes"])
    elif kind == "ckpt_save_incomplete":
        reg.counter(
            "tpu_ckpt_save_failures_total", "coverage-failed checkpoint saves"
        ).inc()
    elif kind == "ckpt_quarantined":
        # A quarantine IS an integrity failure (stage says where it was
        # caught); the dedicated counter additionally tracks file volume.
        reg.counter(
            "tpu_ckpt_integrity_failures_total",
            "checkpoint integrity failures by ladder stage "
            "(local-read quarantine, peer-retrieve, replicate/stream receive)",
            stage=str(rec.get("stage", "?")),
        ).inc()
        reg.counter(
            "tpu_ckpt_quarantined_total",
            "checkpoint containers quarantined to *.corrupt for forensics",
        ).inc()
    elif kind == "ckpt_integrity_failure":
        reg.counter(
            "tpu_ckpt_integrity_failures_total",
            "checkpoint integrity failures by ladder stage "
            "(local-read quarantine, peer-retrieve, replicate/stream receive)",
            stage=str(rec.get("stage", "?")),
        ).inc()
    elif kind == "ckpt_unverified":
        reg.counter(
            "tpu_ckpt_unverified_total",
            "containers loaded/received without checksum verification "
            "(v1 format or foreign checksum algorithm)",
        ).inc()
    elif kind == "ckpt_fallback":
        reg.counter(
            "tpu_ckpt_fallback_total",
            "recovery-ladder fallbacks to an older checkpoint iteration",
        ).inc()
    elif kind == "ckpt_parity":
        # One event per erasure replication round on the sending rank.
        if isinstance(rec.get("received"), (int, float)):
            reg.counter(
                "tpu_ckpt_parity_blocks_total",
                "erasure blocks exchanged, by direction",
                direction="received",
            ).inc(rec["received"])
        if isinstance(rec.get("sent_blocks"), (int, float)):
            reg.counter(
                "tpu_ckpt_parity_blocks_total",
                "erasure blocks exchanged, by direction",
                direction="sent",
            ).inc(rec["sent_blocks"])
        if isinstance(rec.get("sent_bytes"), (int, float)):
            reg.counter(
                "tpu_ckpt_parity_bytes_total",
                "erasure block bytes shipped to clique peers (the wire cost "
                "that replaces (n-1)x full mirrors)",
            ).inc(rec["sent_bytes"])
    elif kind == "ckpt_parity_reconstruct":
        reg.counter(
            "tpu_ckpt_parity_reconstructions_total",
            "k-of-n shard reconstructions from erasure blocks, by outcome "
            "(a 'failed' outcome degraded to peer retrieve, never a "
            "false-positive container)",
            outcome=str(rec.get("outcome", "?")),
        ).inc()
    elif kind == "ckpt_delta":
        # One event per delta replication round on the sending rank.
        reg.counter(
            "tpu_ckpt_delta_saves_total",
            "replication rounds shipped as chunk-diff delta frames",
        ).inc()
        for label, key in (("shipped", "frame_bytes"), ("full", "full_bytes")):
            if isinstance(rec.get(key), (int, float)):
                reg.counter(
                    "tpu_ckpt_delta_bytes_total",
                    "delta replication byte economy: frame bytes shipped vs "
                    "the full container bytes a mirror round would have moved",
                    kind=label,
                ).inc(rec[key])
        if isinstance(rec.get("chunks_changed"), (int, float)):
            reg.counter(
                "tpu_ckpt_delta_chunks_total",
                "chunks shipped by delta rounds (the dirty set)",
            ).inc(rec["chunks_changed"])
    elif kind == "ckpt_delta_applied":
        reg.counter(
            "tpu_ckpt_delta_applied_total",
            "received delta frames applied against held base containers, by "
            "outcome ('broken' = chain mismatch, mirror dropped for the "
            "round)",
            outcome=str(rec.get("outcome", "?")),
        ).inc()
    elif kind == "world_resized":
        reg.counter(
            "tpu_world_resized_total",
            "elastic world-size transitions across rendezvous rounds, by "
            "direction",
            direction=str(rec.get("direction", "?")),
        ).inc()
    elif kind == "reshard_plan":
        # One event per participating rank per resharded resume, so the
        # counter reads as ranks-through-reshard by direction.
        reg.counter(
            "tpu_reshard_ranks_total",
            "ranks that completed a resharded checkpoint resume, by "
            "direction (shrink / grow / resplit)",
            direction=str(rec.get("direction", "?")),
        ).inc()
    elif kind == "reshard_fetch":
        if isinstance(rec.get("bytes"), (int, float)):
            reg.counter(
                "tpu_reshard_bytes_total",
                "bytes assembled into resharded local shards, by source "
                "(local container slice vs peer ranged fetch)",
                source=str(rec.get("via", "?")),
            ).inc(rec["bytes"])
    elif kind == "reshard_serve":
        reg.counter(
            "tpu_reshard_serve_ranges_total",
            "byte ranges served to resharding peers, by serve mode (parallel "
            "= bounded pread/verify worker pool, serial = single range or "
            "pool disabled)",
            mode=str(rec.get("mode", "?")),
        ).inc(rec.get("ranges", 1) or 1)
    elif kind == "reshard_overlap":
        reg.counter(
            "tpu_reshard_parallel_fetches_total",
            "peer range-fetch batches issued concurrently with local "
            "pread/assembly during resharded resume",
        ).inc(rec.get("fetches", 1) or 1)
        if isinstance(rec.get("duration_s"), (int, float)):
            reg.histogram(
                "tpu_reshard_overlap_seconds",
                "wall time of the overlapped fetch+assembly phase per "
                "resharded resume",
            ).observe(rec["duration_s"])
    elif kind == "ckpt_foreground_blocked":
        if isinstance(rec.get("duration_s"), (int, float)):
            reg.histogram(
                "tpu_ckpt_foreground_blocked_seconds",
                "caller-visible train-loop stall per checkpoint save",
                FOREGROUND_BUCKETS_S, engine=str(rec.get("engine", "?")),
            ).observe(rec["duration_s"])
    elif kind == "staging_pool":
        if isinstance(rec.get("pool_bytes"), (int, float)):
            reg.gauge(
                "tpu_ckpt_staging_pool_bytes",
                "host staging buffer pool size (allocated bytes)",
            ).set(rec["pool_bytes"])
        if isinstance(rec.get("in_use_bytes"), (int, float)):
            reg.gauge(
                "tpu_ckpt_staging_inuse_bytes",
                "host staging bytes currently leased to in-flight saves",
            ).set(rec["in_use_bytes"])
        outcome = rec.get("outcome")
        if outcome in ("hit", "miss", "wait"):
            reg.counter(
                "tpu_ckpt_staging_requests_total",
                "staging lease acquisitions by outcome",
                outcome=str(outcome),
            ).inc()
    elif kind == "ckpt_write_file":
        container = str(rec.get("container", "?"))
        if isinstance(rec.get("bytes"), (int, float)):
            reg.counter(
                "tpu_ckpt_write_bytes_total",
                "container bytes written by content class (main vs "
                "separation-hint file)",
                container=container,
            ).inc(rec["bytes"])
        if isinstance(rec.get("leaves"), (int, float)):
            reg.counter(
                "tpu_ckpt_write_leaves_total",
                "tensor leaves written by content class",
                container=container,
            ).inc(rec["leaves"])
    elif kind == "p2p_transfer":
        d = str(rec.get("direction", "?"))
        if isinstance(rec.get("bytes"), (int, float)):
            reg.counter(
                "tpu_ckpt_replication_bytes_total",
                "checkpoint shard bytes moved over p2p links",
                direction=d,
            ).inc(rec["bytes"])
        if isinstance(rec.get("mbps"), (int, float)):
            reg.histogram(
                "tpu_replication_mbps", "p2p shard transfer throughput (MB/s)",
                THROUGHPUT_BUCKETS_MBPS, direction=d,
            ).observe(rec["mbps"])
    elif kind == "store_stats":
        # Periodic self-telemetry deltas from the coordination store's event
        # loop (platform/store.py + utils/opstats.py): counters carry
        # movement since the previous emit, so replaying the stream
        # reconstructs the live totals exactly.
        ops = rec.get("ops")
        if isinstance(ops, dict):
            for op, n in sorted(ops.items()):
                if isinstance(n, (int, float)) and n > 0:
                    reg.counter(
                        "tpu_store_ops_total",
                        "coordination-store operations served, by op",
                        op=str(op),
                    ).inc(n)
        secs = rec.get("op_seconds")
        if isinstance(secs, dict):
            for op, s in sorted(secs.items()):
                if isinstance(s, (int, float)) and s > 0:
                    reg.counter(
                        "tpu_store_op_seconds",
                        "seconds of store event-loop handle time, by op "
                        "(rate ÷ tpu_store_ops_total rate = mean handle "
                        "latency; quantiles live in the store_stats doc)",
                        op=str(op),
                    ).inc(s)
        for field, direction in (("bytes_in", "in"), ("bytes_out", "out")):
            v = rec.get(field)
            if isinstance(v, (int, float)) and v > 0:
                reg.counter(
                    "tpu_store_bytes_total",
                    "coordination-store wire bytes by direction",
                    direction=direction,
                ).inc(v)
        if isinstance(rec.get("conns"), (int, float)):
            reg.gauge(
                "tpu_store_conns", "live coordination-store connections"
            ).set(rec["conns"])
    elif kind == "byteflow_update":
        # The byte-flow ledger's per-(purpose,direction) attribution deltas
        # (utils/byteflow.py) — same delta discipline as goodput_update.
        flows = rec.get("flows")
        if isinstance(flows, dict):
            for key, nbytes in sorted(flows.items()):
                if not isinstance(nbytes, (int, float)) or nbytes <= 0:
                    continue
                purpose, _, direction = str(key).partition("/")
                reg.counter(
                    "tpu_byteflow_bytes_total",
                    "bytes moved, attributed by the byte-flow ledger "
                    "(purpose: replicate | retrieve | reshard | store | "
                    "ckpt_write | unknown)",
                    purpose=purpose, direction=direction or "?",
                ).inc(nbytes)
        if isinstance(rec.get("residue_bytes"), (int, float)) and rec["residue_bytes"] > 0:
            reg.counter(
                "tpu_byteflow_residue_bytes",
                "bytes the ledger observed but could not attribute to a "
                "purpose (unknown-tag wire traffic) — the gap instrument",
            ).inc(rec["residue_bytes"])
        if isinstance(rec.get("accounted_ratio"), (int, float)):
            reg.gauge(
                "tpu_byteflow_accounted_ratio",
                "fraction of observed bytes the ledger attributed to a "
                "purpose (the ≥0.95 acceptance gate)",
            ).set(rec["accounted_ratio"])
    elif kind == "store_retry":
        reg.counter(
            "tpu_store_retries_total",
            "store-client transparent transport retries by op and outcome "
            "(retried per attempt; recovered/exhausted once per call)",
            op=str(rec.get("op", "?")), outcome=str(rec.get("outcome", "?")),
        ).inc()
    elif kind == "store_failover":
        reg.counter(
            "tpu_store_failover_total",
            "clique-client shard failovers to the successor replica, by "
            "failed shard and outcome (read | mutate | barrier | absorbed "
            "once per failed-over op; replica_skipped once per degraded "
            "mirror write)",
            shard=str(rec.get("shard", "?")),
            outcome=str(rec.get("outcome", "?")),
        ).inc()
    elif kind == "shard_epoch":
        reg.counter(
            "tpu_store_reshards_total",
            "clique shard-map epoch transitions by phase "
            "(migrating | settled | adopted)",
            outcome=str(rec.get("outcome", "?")),
        ).inc()
        if isinstance(rec.get("epoch"), (int, float)):
            reg.gauge(
                "tpu_store_epoch",
                "current clique shard-map epoch (0 = launch map, never "
                "resharded)",
            ).set(rec["epoch"])
    elif kind == "store_auto_reshard":
        reg.counter(
            "tpu_store_auto_reshards_total",
            "automatic shard respawns driven by the launcher supervisor "
            "(--store-auto-reshard), by outcome (ok | failed)",
            outcome=str(rec.get("outcome", "?")),
        ).inc()
    elif kind == "coldtier_spilled":
        reg.counter(
            "tpu_coldtier_spills_total",
            "keyframe containers archived to the cold tier by the async "
            "spiller (one per finalized owner shard)",
        ).inc()
        if isinstance(rec.get("bytes"), (int, float)):
            reg.counter(
                "tpu_coldtier_bytes_total",
                "bytes shipped to the cold tier by the async spiller",
            ).inc(rec["bytes"])
    elif kind == "coldtier_degraded":
        reg.counter(
            "tpu_coldtier_degraded_total",
            "cold-tier spills dropped to local-only, by reason "
            "(upload-failed after retry exhaustion | breaker-open while the "
            "backend circuit breaker cools down); the save itself succeeded",
            reason=str(rec.get("reason", "?")),
        ).inc()
    elif kind == "coldtier_pruned":
        reg.counter(
            "tpu_coldtier_pruned_total",
            "cold-tier artifacts removed by keyframe-aware retention "
            "(--cold-keep), one per (iteration, owner)",
        ).inc()
    elif kind == "coldtier_fetch":
        reg.counter(
            "tpu_coldtier_fetch_total",
            "cold-tier restore fetches by mode (full | header | ranged) and "
            "outcome (ok | corrupt: manifest digest mismatch, restore "
            "refused fail-closed)",
            mode=str(rec.get("mode", "?")),
            outcome=str(rec.get("outcome", "?")),
        ).inc()
    elif kind == "peer_degraded":
        reg.counter(
            "tpu_replication_peer_degraded_total",
            "replication peers dropped for a round after transfer-retry "
            "exhaustion (the save proceeded with reduced redundancy)",
        ).inc()
    elif kind == "chaos_inject":
        reg.counter(
            "chaos_faults_injected_total",
            "network faults injected by the chaos plan",
            kind=str(rec.get("fault", "?")), channel=str(rec.get("channel", "?")),
        ).inc()
    elif kind == "incident_opened":
        reg.counter(
            "tpu_incidents_total",
            "incidents opened by the incident engine, by trigger",
            trigger=str(rec.get("trigger", "?")),
        ).inc()
        reg.gauge(
            "tpu_incidents_open", "incidents currently open"
        ).inc()
    elif kind == "incident_closed":
        reg.gauge("tpu_incidents_open", "incidents currently open").dec()
        # Literal names on purpose: the docs-drift gate
        # (tests/utils/test_metrics_doc.py) extracts them by AST.
        if isinstance(rec.get("time_to_detect_s"), (int, float)):
            reg.histogram(
                "tpu_incident_time_to_detect_seconds",
                "fault evidence -> incident opened, per incident",
            ).observe(rec["time_to_detect_s"])
        if isinstance(rec.get("time_to_decide_s"), (int, float)):
            reg.histogram(
                "tpu_incident_time_to_decide_seconds",
                "incident opened -> first decision, per incident",
            ).observe(rec["time_to_decide_s"])
        if isinstance(rec.get("time_to_recover_s"), (int, float)):
            reg.histogram(
                "tpu_incident_time_to_recover_seconds",
                "fault evidence -> recovered, per incident",
            ).observe(rec["time_to_recover_s"])
        if isinstance(rec.get("steps_lost"), (int, float)):
            reg.counter(
                "tpu_incident_steps_lost_total",
                "training steps lost across incidents (resume gap)",
            ).inc(max(0.0, rec["steps_lost"]))
    elif kind == "autoscale_decision":
        reg.counter(
            "tpu_autoscale_decisions_total",
            "autoscale controller decisions by action and actuation outcome "
            "(advised = advise mode, never acted)",
            action=str(rec.get("action", "?")),
            outcome=str(rec.get("outcome", "?")),
        ).inc()
    elif kind == "autoscale_outcome":
        # One per settled decision: the controller's forecast accuracy as a
        # first-class metric (realized minus predicted goodput delta).
        p, r = rec.get("predicted_delta_s"), rec.get("realized_delta_s")
        if isinstance(p, (int, float)) and isinstance(r, (int, float)):
            reg.histogram(
                "tpu_autoscale_predicted_vs_realized",
                "autoscale forecast error per settled decision "
                "(realized minus predicted goodput delta, seconds)",
                FORECAST_ERROR_BUCKETS_S,
                action=str(rec.get("action", "?")),
            ).observe(r - p)
    elif kind == "preemption_rescinded":
        reg.counter(
            "tpu_preemption_rescinded_total",
            "preemption notices withdrawn before their grace window elapsed "
            "(the deferred drain/save was cancelled)",
        ).inc()
    elif kind == "fleet_scrape":
        # One per fleetd scrape fan-out (tools/fleetd.py): how many jobs the
        # fleet control plane currently sees and what a full scrape costs.
        if isinstance(rec.get("jobs"), (int, float)):
            reg.gauge(
                "tpu_fleet_jobs",
                "jobs with a live discovery lease at the last fleet scrape",
            ).set(rec["jobs"])
        if isinstance(rec.get("unreachable"), (int, float)):
            reg.gauge(
                "tpu_fleet_jobs_unreachable",
                "leased jobs whose telemetry endpoint failed the last scrape",
            ).set(rec["unreachable"])
        if isinstance(rec.get("duration_s"), (int, float)):
            reg.histogram(
                "tpu_fleet_scrape_seconds",
                "wall clock of one full fleet scrape (parallel fan-out over "
                "every live job)",
            ).observe(rec["duration_s"])
    elif kind == "fleet_job_unreachable":
        # One per failed per-job scrape: the job stays on the scoreboard as
        # `unreachable`; this counter is the rate of that degradation.
        reg.counter(
            "tpu_fleet_scrape_errors_total",
            "per-job scrape failures during fleet aggregation, by job "
            "(the job is marked unreachable, the fleet endpoints keep serving)",
            job=str(rec.get("job", "?")),
        ).inc()
    elif kind == "remediation_action":
        reg.counter(
            "tpu_remediation_actions_total",
            "automated remediation actions by action and outcome",
            action=str(rec.get("action", "?")),
            outcome=str(rec.get("outcome", "?")),
        ).inc()
    elif kind == "flight_flush":
        reg.counter(
            "tpu_flight_flushes_total",
            "flight-recorder consolidated dumps by reason",
            reason=str(rec.get("reason", "?")),
        ).inc()
    elif kind == "heartbeat_stats":
        if isinstance(rec.get("max_gap_s"), (int, float)):
            reg.histogram(
                "tpu_heartbeat_gap_seconds", "per-session max heartbeat gap"
            ).observe(rec["max_gap_s"])
    elif kind == "timing":
        d = rec.get("duration_s")
        if isinstance(d, (int, float)):
            reg.histogram(
                "tpu_timing_seconds", "@prof / debug_time durations",
                name=str(rec.get("name", "?")),
            ).observe(d)
        if rec.get("ok") is False:
            reg.counter(
                "tpu_timing_failures_total", "timed blocks that raised",
                name=str(rec.get("name", "?")),
            ).inc()
    elif kind == "span_end":
        d = rec.get("duration_s")
        if isinstance(d, (int, float)):
            reg.histogram(
                "tpu_span_seconds", "span durations by name",
                span=str(rec.get("span", "?")),
            ).observe(d)
        if rec.get("ok") is False:
            reg.counter(
                "tpu_span_failures_total", "spans that raised",
                span=str(rec.get("span", "?")),
            ).inc()
    elif kind == "alert_fired":
        # Watchtower transitions (telemetry/watchtower.py) mirror the
        # incident counter+gauge pattern: total by rule/severity, plus the
        # currently-firing gauge the resolve decrements.
        reg.counter(
            "tpu_alerts_total",
            "watchtower alerts fired, by rule and severity",
            rule=str(rec.get("rule", "?")),
            severity=str(rec.get("severity", "?")),
        ).inc()
        reg.gauge(
            "tpu_alerts_active", "watchtower alerts currently firing"
        ).inc()
    elif kind == "alert_resolved":
        reg.gauge(
            "tpu_alerts_active", "watchtower alerts currently firing"
        ).dec()


def aggregate(
    records: Iterable[dict], reg: Optional[MetricsRegistry] = None
) -> MetricsRegistry:
    """Replay a finished run's records into a (fresh by default) registry."""
    reg = MetricsRegistry() if reg is None else reg
    for rec in records:
        if isinstance(rec, dict):
            observe_record(rec, reg)
    return reg


def flatten_event(event) -> dict:
    """One Event → the flat record shape its JSONL line would carry.

    The single flattening (including the ``p_``-rename of payload keys that
    collide with the envelope) shared by :class:`MetricsSink` and the
    watchtower's sink — live in-process consumers and post-hoc file replays
    must see byte-identical record shapes.
    """
    if hasattr(event, "to_record"):
        return event.to_record()
    rec = {
        "ts": event.ts, "source": event.source, "kind": event.kind,
        "pid": event.pid, "rank": event.rank,
        **{f"p_{k}" if k in RESERVED_KEYS else k: v
           for k, v in event.payload.items()},
    }
    if getattr(event, "job", None) is not None:
        rec["job"] = event.job
    return rec


class MetricsSink:
    """``events.add_sink`` bridge: one ``record()`` call feeds both streams.

    Optionally snapshots the registry to ``json_path`` at most every
    ``snapshot_interval`` seconds (piggybacked on event arrivals — no extra
    thread to leak into forked workers) plus once at interpreter exit, so the
    file always reflects the process's final state.
    """

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        json_path: Optional[str] = None,
        snapshot_interval: float = 10.0,
    ):
        self.registry = registry if registry is not None else get_registry()
        self.json_path = json_path
        self.snapshot_interval = snapshot_interval
        self._last_snapshot = 0.0
        if json_path is not None:
            import atexit

            atexit.register(self._final_snapshot)

    def _final_snapshot(self) -> None:
        try:
            self.registry.write_json(self.json_path)
        except Exception:
            pass  # observability, not control flow

    def __call__(self, event) -> None:
        # Same flat shape as the JSONL line (including the p_-rename of payload
        # keys that collide with the envelope), minus the json round-trip.
        observe_record(flatten_event(event), self.registry)
        if self.json_path is not None:
            now = time.monotonic()
            if now - self._last_snapshot >= self.snapshot_interval:
                self._last_snapshot = now
                self.registry.write_json(self.json_path)


class MetricsPublisher(MetricsSink):
    """``events.add_sink`` bridge that pushes snapshots up the coordination
    store instead of (or alongside) dropping files.

    The scale story: a scraper of an N-rank job must not open N per-rank
    snapshot files. Each rank periodically publishes its registry snapshot to
    one store key (``<prefix><identity>``) — piggybacked on event arrivals
    like :class:`MetricsSink`'s file snapshots, so no thread leaks into forked
    workers — and the launcher's telemetry endpoint folds the key range into
    one job-level registry with :meth:`MetricsRegistry.merge`. Because the
    merge is associative/commutative, intermediate nodes of a large store
    clique can fold subtrees before forwarding (the O(log N) aggregation path
    ROADMAP item 3 builds toward).

    The identity is ``r<rank>-<pid>`` (``p<pid>`` when rankless): a restarted
    rank publishes under a NEW key, and the merge sums both incarnations'
    counters instead of losing the first one to a same-key overwrite.

    A push failure never breaks the workload: errors are contained, and the
    next attempt waits out ``interval`` like a successful push would.
    """

    def __init__(
        self,
        host: str,
        port: int,
        prefix: str = "jobmetrics/default/",
        *,
        registry: Optional[MetricsRegistry] = None,
        interval: float = 2.0,
        identity: Optional[str] = None,
    ):
        # A PRIVATE registry by default: the publisher must not double-count
        # events into the process-wide registry another sink already feeds.
        super().__init__(registry=registry or MetricsRegistry())
        self._host = host
        self._port = port
        self._prefix = prefix
        self._interval = interval
        self._store: Any = None
        self._last_push = 0.0
        if identity is None:
            rank_s = os.environ.get("RANK")
            identity = (
                f"r{rank_s}-{os.getpid()}"
                if rank_s and rank_s.isdigit() else f"p{os.getpid()}"
            )
        self.identity = identity
        import atexit

        atexit.register(self._final_push)

    @classmethod
    def from_env_spec(cls, spec: str) -> "MetricsPublisher":
        """Parse ``host:port[:prefix]`` (the $TPU_RESILIENCY_METRICS_PUSH
        value the launcher exports to its workers)."""
        parts = spec.split(":", 2)
        if len(parts) < 2 or not parts[1].isdigit():
            raise ValueError(f"bad metrics-push spec {spec!r}: want host:port[:prefix]")
        host, port = parts[0] or "127.0.0.1", int(parts[1])
        prefix = parts[2] if len(parts) == 3 and parts[2] else "jobmetrics/default/"
        return cls(host, port, prefix)

    def _connect(self):
        if self._store is None:
            # Lazy import: metrics must not pull the platform layer in at
            # module load (events -> metrics stays the dependency root path).
            from tpu_resiliency_torch.platform.shardstore import connect_store
            from tpu_resiliency_torch.platform.store import AUTH_KEY_ENV

            self._store = connect_store(
                self._host, self._port, prefix=self._prefix,
                timeout=10.0, connect_retries=1, retry_budget=2.0,
                auth_key=os.environ.get(AUTH_KEY_ENV) or None,
            )
        return self._store

    def push(self) -> None:
        """Publish the current snapshot under this process's identity key."""
        self._connect().set(self.identity, self.registry.snapshot())

    def _final_push(self) -> None:
        try:
            self.push()
        except Exception:
            pass  # interpreter exit: the store may already be gone

    def close(self) -> None:
        if self._store is not None:
            try:
                self._store.close()
            except Exception:
                pass
            self._store = None

    def __call__(self, event) -> None:
        super().__call__(event)
        now = time.monotonic()
        if now - self._last_push >= self._interval:
            # Stamp BEFORE attempting: a dead store must not be re-dialed on
            # every single event (the interval is also the failure backoff).
            self._last_push = now
            try:
                self.push()
            except Exception:
                log.debug("metrics snapshot push failed", exc_info=True)
