"""Structured event stream: machine-consumable records of the resiliency story.

A copy of ``tpu_resiliency/utils/events.py`` with the same record schema and the same
variables: a process of either package appends its events, one JSON line each, to the
one stream the launcher names (``TPU_RESILIENCY_EVENTS_FILE``), and every consumer of
the JAX package's stream (``tools/events_summary.py``, ``tools/metrics_dump.py``,
``utils/metrics.py``, ``utils/goodput.py``) reads the port's records as its own.

The environment wires the sinks as the reference wires them: the JSONL stream, the
metrics snapshot (``TPU_RESILIENCY_METRICS_FILE``, a ``MetricsSink``), the metrics
push to the coordination store (``TPU_RESILIENCY_METRICS_PUSH``, a
``MetricsPublisher``) and the flight recorder (``TPU_RESILIENCY_FLIGHT_DIR``).

Design:

- :class:`Event`: ``(ts, source, kind, payload)`` plus process identity (pid, rank
  when known) and, when tracing is active, ``trace_id``/``span_id`` causal context
  (``utils/tracing.py``) — everything JSON-serializable.
- Pluggable sinks registered per process (``add_sink``); the default wiring is
  environment-driven: ``TPU_RESILIENCY_EVENTS_FILE=<path>`` attaches a JSONL sink,
  so a launcher enables one stream for itself and every worker it spawns by
  exporting a single variable. JSONL lines are written in one ``write()`` call —
  atomic under POSIX append semantics for lines < PIPE_BUF, so all processes of a
  node can share one file.
- ``record(source, kind, **payload)``: fire-and-forget; a sink failure never
  breaks the workload (events are observability, not control flow).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Callable, Optional

from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)

EVENTS_FILE_ENV = "TPU_RESILIENCY_EVENTS_FILE"
#: Set to a path to ALSO bridge every record into the metrics registry and
#: snapshot it as JSON (``utils/metrics.py``); ``<pid>`` is inserted before the
#: extension so each process of a node drops its own snapshot (no clobbering).
METRICS_FILE_ENV = "TPU_RESILIENCY_METRICS_FILE"
#: Set to a directory to ALSO keep a crash-surviving flight-recorder ring of
#: this process's recent events (``utils/flight_recorder.py``) — the incident
#: plane's last-seconds-before-death record, persisted continuously so even a
#: SIGKILL leaves a dump behind.
FLIGHT_DIR_ENV = "TPU_RESILIENCY_FLIGHT_DIR"
#: Set to ``host:port[:prefix]`` to ALSO publish this process's metrics
#: snapshot to the coordination store every few seconds
#: (``utils/metrics.py:MetricsPublisher``) — the goodput plane's push path:
#: the launcher's telemetry endpoint merges the published snapshots into one
#: job-level view instead of scraping every rank's files.
METRICS_PUSH_ENV = "TPU_RESILIENCY_METRICS_PUSH"
#: Set to a job identity (the launcher exports its --rdzv-id when --fleet-dir
#: is on) to stamp ``job`` into every event's envelope. Fleet-scope consumers
#: (``tools/fleetd.py``, ``tpu-metrics-dump --job``, ``tpu-events-summary
#: --job``) use it to slice a stream several jobs share back to one job.
JOB_ENV = "TPU_RESILIENCY_JOB"

#: Envelope keys every JSONL record carries; payload keys that collide are
#: renamed ``p_<key>`` by ``to_json``. Consumers (events_summary, trace_export)
#: use this to split envelope from payload — one schema, one place.
#: ``trace_id``/``span_id`` are envelope members too (omitted when tracing is
#: inactive) so a payload key of the same name can never forge causal context;
#: same for ``job`` (fleet federation's job identity, from $TPU_RESILIENCY_JOB).
RESERVED_KEYS = ("ts", "source", "kind", "pid", "rank", "trace_id", "span_id",
                 "job")


@dataclasses.dataclass
class Event:
    ts: float
    source: str
    kind: str
    payload: dict
    pid: int = dataclasses.field(default_factory=os.getpid)
    rank: Optional[int] = None
    #: causal context (``utils/tracing.py``): the run's trace id and the span
    #: active when this event was recorded — None outside any trace
    trace_id: Optional[str] = None
    span_id: Optional[str] = None
    #: fleet job identity ($TPU_RESILIENCY_JOB) — None outside fleet scope
    job: Optional[str] = None

    def to_record(self) -> dict:
        """The flat dict shape a parsed JSONL line has (envelope + payload,
        colliding payload keys renamed ``p_<key>``) — what every stream
        consumer (``observe_record``, the ledgers, ``critpath``) eats, minus
        the JSON round trip. In-process sinks use this to feed the same code
        paths the offline tools run."""
        env = {
            "ts": self.ts,
            "source": self.source,
            "kind": self.kind,
            "pid": self.pid,
            "rank": self.rank,
        }
        # Lean lines: untraced processes pay zero bytes for the trace fields.
        if self.trace_id is not None:
            env["trace_id"] = self.trace_id
        if self.span_id is not None:
            env["span_id"] = self.span_id
        if self.job is not None:
            env["job"] = self.job
        return {
            **env,
            **{f"p_{k}" if k in RESERVED_KEYS else k: v
               for k, v in self.payload.items()},
        }

    def to_json(self) -> str:
        return json.dumps(self.to_record(), default=repr)


class JsonlSink:
    """Appends one JSON line per event. Safe to share across processes: each event
    is a single ``write()`` of one line."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(path, "a", buffering=1)

    def __call__(self, event: Event) -> None:
        with self._lock:
            self._f.write(event.to_json() + "\n")

    def close(self) -> None:
        try:
            self._f.close()
        except Exception:
            pass


class LoggingSink:
    """Mirrors events into the standard log at DEBUG (for interleaved debugging)."""

    def __call__(self, event: Event) -> None:
        log.debug(f"[event] {event.to_json()}")


_sinks: list[Callable[[Event], None]] = []
_sinks_lock = threading.Lock()
_env_wired_for: Optional[str] = None

#: ``() -> (trace_id, span_id)`` supplier consulted by ``record``. The default
#: reads the tracing env vars directly so a process that never imports
#: ``utils/tracing`` still stamps inherited context onto its events;
#: ``utils/tracing`` swaps in its thread-local-aware provider on import.
#: (A hook, not an import: events must stay the dependency root.)
TRACE_ID_ENV = "TPU_RESILIENCY_TRACE_ID"
PARENT_SPAN_ENV = "TPU_RESILIENCY_PARENT_SPAN"


def _env_trace_context() -> tuple[Optional[str], Optional[str]]:
    return (
        os.environ.get(TRACE_ID_ENV) or None,
        os.environ.get(PARENT_SPAN_ENV) or None,
    )


_context_provider: Callable[[], tuple[Optional[str], Optional[str]]] = (
    _env_trace_context
)


def set_context_provider(
    fn: Callable[[], tuple[Optional[str], Optional[str]]]
) -> None:
    """Install the ``(trace_id, span_id)`` supplier stamped onto every event."""
    global _context_provider
    _context_provider = fn


def add_sink(sink: Callable[[Event], None], *, front: bool = False) -> None:
    """Register a sink. ``front=True`` puts it FIRST in dispatch order —
    reserved for crash-surviving sinks (the flight recorder): when a process
    dies mid-``record()`` (e.g. a SIGKILL racing a hang-forensics stack
    dump), the sink that persists the event must be the one that already
    ran."""
    with _sinks_lock:
        if front:
            _sinks.insert(0, sink)
        else:
            _sinks.append(sink)


def remove_sink(sink: Callable[[Event], None]) -> None:
    with _sinks_lock:
        try:
            _sinks.remove(sink)
        except ValueError:
            pass


def clear_sinks() -> None:
    with _sinks_lock:
        _sinks.clear()
    global _env_wired_for, _metrics_wired_for, _flight_wired_for, _push_wired_for
    _env_wired_for = None
    _metrics_wired_for = None
    _flight_wired_for = None
    _push_wired_for = None


_metrics_wired_for: Optional[str] = None
_flight_wired_for: Optional[str] = None
_push_wired_for: Optional[str] = None


def _wire_env_sink() -> None:
    """Attach (once per path) the JSONL sink named by $TPU_RESILIENCY_EVENTS_FILE
    and the metrics bridge named by $TPU_RESILIENCY_METRICS_FILE.
    Re-checked on every record so a launcher exporting the variable after import
    still takes effect, and forked/spawned children wire themselves lazily.
    The flight recorder named by $TPU_RESILIENCY_FLIGHT_DIR rides the same
    lazy wiring (flight_recorder.install registers itself as a sink)."""
    global _env_wired_for, _metrics_wired_for, _flight_wired_for, _push_wired_for
    path = os.environ.get(EVENTS_FILE_ENV)
    if path and path != _env_wired_for:
        with _sinks_lock:
            if _env_wired_for != path:
                try:
                    _sinks.append(JsonlSink(path))
                    _env_wired_for = path
                except OSError as e:
                    log.warning(f"cannot open events file {path!r}: {e}")
                    _env_wired_for = path  # don't retry every event
    mpath = os.environ.get(METRICS_FILE_ENV)
    if mpath and mpath != _metrics_wired_for:
        with _sinks_lock:
            if _metrics_wired_for != mpath:
                try:
                    # Lazy import: events is the dependency root; metrics
                    # imports events, never the reverse at module load.
                    from tpu_resiliency_torch.utils.metrics import MetricsSink

                    base, ext = os.path.splitext(mpath)
                    _sinks.append(
                        MetricsSink(json_path=f"{base}.{os.getpid()}{ext or '.json'}")
                    )
                except Exception as e:
                    log.warning(f"cannot wire metrics snapshots to {mpath!r}: {e}")
                _metrics_wired_for = mpath
    ppath = os.environ.get(METRICS_PUSH_ENV)
    if ppath and ppath != _push_wired_for:
        with _sinks_lock:
            if _push_wired_for != ppath:
                try:
                    # Lazy import, same reason as the metrics bridge: events
                    # stays the dependency root.
                    from tpu_resiliency_torch.utils.metrics import MetricsPublisher

                    _sinks.append(MetricsPublisher.from_env_spec(ppath))
                except Exception as e:
                    log.warning(f"cannot wire metrics push to {ppath!r}: {e}")
                _push_wired_for = ppath
    fpath = os.environ.get(FLIGHT_DIR_ENV)
    if fpath and fpath != _flight_wired_for:
        try:
            # Lazy import for the same reason as the metrics bridge: events
            # stays the dependency root. install() adds the sink itself.
            # Marked wired only on success so a transient mkdir/open failure
            # is retried on the next record, as the lazy wiring promises.
            from tpu_resiliency_torch.utils import flight_recorder

            if flight_recorder.install_from_env() is not None:
                _flight_wired_for = fpath
        except Exception as e:
            log.warning(f"cannot wire flight recorder in {fpath!r}: {e}")


def record(source: str, kind: str, **payload: Any) -> None:
    """Record one event; never raises. ``rank`` is read from $RANK when present."""
    _wire_env_sink()
    with _sinks_lock:
        sinks = list(_sinks)
    if not sinks:
        return
    rank_s = os.environ.get("RANK")
    try:
        trace_id, span_id = _context_provider()
    except Exception:
        trace_id = span_id = None  # context is decoration, never control flow
    ev = Event(
        ts=time.time(),
        source=source,
        kind=kind,
        payload=payload,
        rank=int(rank_s) if rank_s and rank_s.isdigit() else None,
        trace_id=trace_id,
        span_id=span_id,
        job=os.environ.get(JOB_ENV) or None,
    )
    for sink in sinks:
        try:
            sink(ev)
        except Exception:
            log.debug("event sink failed", exc_info=True)


def read_events(
    path: str,
    *,
    since: Optional[float] = None,
    until: Optional[float] = None,
) -> list[dict]:
    """Parse a JSONL event file (tolerates torn trailing lines).

    ``since``/``until`` stream-filter records by their ``ts`` while reading,
    so callers slicing a window out of a long-lived shared file (the incident
    engine closes incidents against a stream that can span days) never
    materialize its full history. When either bound is set, records without a
    numeric ``ts`` are dropped — they cannot be placed in the window."""
    out = []
    bounded = since is not None or until is not None
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if bounded:
                    ts = rec.get("ts")
                    if not isinstance(ts, (int, float)):
                        continue
                    if since is not None and ts < since:
                        continue
                    if until is not None and ts > until:
                        continue
                out.append(rec)
    except OSError:
        pass
    return out
