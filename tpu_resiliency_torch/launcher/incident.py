"""Incident engine: one causally-ordered artifact per fault, with SLO timings.

Before this module, reconstructing "what happened during that fault" meant
grepping per-rank JSONL by hand. The engine automates the postmortem: on every
fault, restart round, checkpoint fallback, or remediation it opens an
**incident**, and on recovery it writes one ``incidents/incident-<ts>.json``
artifact containing

- the **causal chain**: the window's events classified into
  detect → decide → act → recover milestones, ordered by timestamp with
  span-begin-before-member tie-breaking (the trace ids stitched across
  the launcher/worker boundary scope the window to THIS run);
- the relevant processes' **flight-recorder dumps**
  (``utils/flight_recorder.py``) — present even for a SIGKILLed rank, whose
  normal event sink died with it;
- computed **SLO timings**: time-to-detect (first fault evidence → incident
  opened), time-to-decide (opened → first decision), time-to-recover (first
  fault evidence → recovered), and steps lost (last pre-fault iteration →
  first post-recovery iteration), exported as ``tpu_incident_*`` metrics via
  ``incident_opened`` / ``incident_closed`` events.

Two operating modes share one implementation:

- **explicit** (the launcher agent): ``open()`` on worker failure / restart
  round, ``close()`` on round success — the agent knows its own phase machine.
- **auto** (``auto_open=True``, attached as an events sink inside a worker):
  degraded-set transitions, remediation decisions, and checkpoint
  fallbacks/quarantines open incidents; recovery transitions close them. This
  is how telemetry-driven remediation (``telemetry/remediation.py``) gets its
  audit artifact without the launcher in the loop.

``tools/incident_report.py`` renders any artifact as a human postmortem
timeline; schema in ``docs/incidents.md``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import Counter, deque
from typing import Any, Optional

from tpu_resiliency_torch.utils import events as events_mod
from tpu_resiliency_torch.utils import flight_recorder
from tpu_resiliency_torch.utils.events import read_events, record as record_event
from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)

SCHEMA = "tpu-incident-1"

#: how far back the pre-buffer is scanned for fault evidence at open time
FAULT_LOOKBACK_S = 300.0
#: pre-open context included in the artifact's event window
PRE_WINDOW_S = 30.0
#: bounded capture: the artifact's event window and per-process flight dumps
MAX_WINDOW_EVENTS = 2000
MAX_FLIGHT_RECORDS = 600

# -- phase classification -----------------------------------------------------

#: event kinds that are *evidence the fault itself happened* (fault_ts anchors)
FAULT_KINDS = frozenset({
    "worker_failed", "fn_exception", "hang_detected", "health_terminated",
    "rank_terminated", "ckpt_quarantined", "ckpt_integrity_failure",
})

_DETECT = frozenset(FAULT_KINDS | {
    "straggler_report", "degraded_set", "flight_flush",
})
_DECIDE = frozenset({
    "restart_requested", "remediation_decision", "control_request",
    "ckpt_fallback", "budget_exhausted", "restart_budget",
})
_ACT = frozenset({
    "remediation_action", "kill_ladder", "worker_promoted",
    "rendezvous_round", "stood_down",
})
_RECOVER = frozenset({
    "round_succeeded", "completed", "training_finished",
})


def classify_phase(rec: dict) -> Optional[str]:
    """detect | decide | act | recover for chain-worthy kinds, else None."""
    kind = rec.get("kind")
    if kind == "straggler_report":
        flagged = rec.get("stragglers_by_perf") or rec.get("stragglers_by_section")
        return "detect" if flagged else None
    if kind == "degraded_set":
        if rec.get("newly"):
            return "detect"
        if rec.get("recovered"):
            return "recover"
        return None
    if kind == "remediation_action":
        return "recover" if rec.get("action") == "reinstate" else "act"
    if kind in _DETECT:
        return "detect"
    if kind in _DECIDE:
        return "decide"
    if kind in _ACT:
        return "act"
    if kind in _RECOVER:
        return "recover"
    return None


def _order_key(rec: dict) -> tuple:
    # Span begins sort before same-ts members, ends after: the causal
    # guarantee trace ids give us inside one wall-clock domain.
    kind = rec.get("kind")
    order = 0 if kind == "span_begin" else (2 if kind == "span_end" else 1)
    ts = rec.get("ts")
    return (ts if isinstance(ts, (int, float)) else 0.0, order)


@dataclasses.dataclass
class _OpenIncident:
    incident_id: str
    trigger: str
    detail: str
    opened_ts: float
    fault_ts: float
    ranks: list
    decide_ts: Optional[float] = None
    act_ts: Optional[float] = None
    last_iteration_before: Optional[int] = None
    first_iteration_after: Optional[int] = None
    #: hang census captured at open time (``ElasticAgent.hang_census``): who
    #: was stuck where, which barriers were open, who never arrived
    census: Optional[dict] = None


class IncidentEngine:
    """Collects the fault window and writes the postmortem artifact.

    ``attach()`` registers the engine as an events sink: every local event
    lands in a bounded pre-buffer (fault-evidence lookback + fallback window
    when no shared events file exists). The shared JSONL named by
    ``$TPU_RESILIENCY_EVENTS_FILE`` — which carries *every* process's records —
    is read at close time and preferred for the artifact window.
    """

    def __init__(
        self,
        incidents_dir: str,
        *,
        node_id: str = "",
        events_file: Optional[str] = None,
        flight_dir: Optional[str] = None,
        auto_open: bool = False,
    ):
        self.incidents_dir = incidents_dir
        self.node_id = node_id
        self.events_file = events_file if events_file is not None else (
            os.environ.get(events_mod.EVENTS_FILE_ENV) or None
        )
        #: flight dumps live beside the incident artifacts by default — one
        #: directory to ship to the operator
        self.flight_dir = flight_dir or incidents_dir
        self.auto_open = auto_open
        os.makedirs(incidents_dir, exist_ok=True)
        self._prebuffer: deque[dict] = deque(maxlen=MAX_WINDOW_EVENTS)
        self._open: Optional[_OpenIncident] = None
        self._attached = False
        self._seq = 0
        #: artifact paths written this engine's lifetime (tests/operators)
        self.artifacts: list[str] = []

    # -- sink ---------------------------------------------------------------

    def attach(self) -> None:
        if not self._attached:
            events_mod.add_sink(self._sink)
            self._attached = True

    def detach(self) -> None:
        if self._attached:
            events_mod.remove_sink(self._sink)
            self._attached = False

    def _sink(self, event) -> None:
        # Flattened to the JSONL record shape so close-time merging treats
        # captured and file-read records identically.
        rec = {
            "ts": event.ts, "source": event.source, "kind": event.kind,
            "pid": event.pid, "rank": event.rank,
        }
        if event.trace_id is not None:
            rec["trace_id"] = event.trace_id
        if event.span_id is not None:
            rec["span_id"] = event.span_id
        for k, v in event.payload.items():
            rec[f"p_{k}" if k in events_mod.RESERVED_KEYS else k] = v
        self.observe(rec)

    def observe(self, rec: dict) -> None:
        """Feed one flattened record (sink entry; also callable from tests)."""
        if rec.get("kind") in ("incident_opened", "incident_closed"):
            return  # our own narration must not re-trigger us
        self._prebuffer.append(rec)
        inc = self._open
        if inc is not None:
            self._track_milestones(inc, rec)
            if self.auto_open and self._is_auto_close(rec):
                self.close(outcome="recovered", _closing_rec=rec)
            return
        if self.auto_open:
            trigger = self._auto_trigger(rec)
            if trigger is not None:
                self.open(
                    trigger, detail=str(rec.get("kind")),
                    ranks=self._ranks_of(rec),
                )

    @staticmethod
    def _auto_trigger(rec: dict) -> Optional[str]:
        kind = rec.get("kind")
        if kind == "degraded_set" and rec.get("newly"):
            return "degraded"
        if kind == "remediation_decision":
            return "remediation"
        if kind in ("ckpt_fallback", "ckpt_quarantined"):
            return str(kind)
        if kind in FAULT_KINDS:
            return str(kind)
        return None

    @staticmethod
    def _is_auto_close(rec: dict) -> bool:
        kind = rec.get("kind")
        if kind == "degraded_set" and rec.get("recovered") and not rec.get("newly"):
            return True
        if kind == "remediation_action" and rec.get("action") == "reinstate":
            return True
        return kind in ("round_succeeded", "completed", "training_finished")

    @staticmethod
    def _ranks_of(rec: dict) -> list:
        for key in ("newly", "global_rank", "ranks", "rank"):
            v = rec.get(key)
            if isinstance(v, list):
                return sorted(v)
            if isinstance(v, int):
                return [v]
        return []

    def _track_milestones(self, inc: _OpenIncident, rec: dict) -> None:
        phase = classify_phase(rec)
        ts = rec.get("ts")
        if not isinstance(ts, (int, float)):
            return
        if phase == "decide" and inc.decide_ts is None:
            inc.decide_ts = ts
        elif phase == "act" and inc.act_ts is None:
            inc.act_ts = ts
        if rec.get("kind") == "iteration_start" and isinstance(
            rec.get("iteration"), int
        ):
            inc.first_iteration_after = (
                rec["iteration"] if inc.first_iteration_after is None
                else min(inc.first_iteration_after, rec["iteration"])
            )

    # -- lifecycle ----------------------------------------------------------

    @property
    def is_open(self) -> bool:
        return self._open is not None

    def open(
        self,
        trigger: str,
        detail: str = "",
        ranks: Optional[list] = None,
        fault_ts: Optional[float] = None,
        census: Optional[dict] = None,
    ) -> str:
        """Open an incident (idempotent: a second fault folds into the open
        one). Returns the incident id. ``census``: an optional hang-census
        snapshot (per-rank locations, open barriers, suspects) embedded
        verbatim in the artifact."""
        if self._open is not None:
            if ranks:
                self._open.ranks = sorted(set(self._open.ranks) | set(ranks))
            if census is not None and self._open.census is None:
                self._open.census = census
            return self._open.incident_id
        now = time.time()
        if fault_ts is None:
            fault_ts = self._scan_fault_evidence(now)
        self._seq += 1
        incident_id = f"incident-{int(now * 1000)}-{self._seq}"
        self._open = _OpenIncident(
            incident_id=incident_id,
            trigger=trigger,
            detail=detail,
            opened_ts=now,
            fault_ts=min(fault_ts, now),
            ranks=sorted(ranks or []),
            census=census,
        )
        # Iterations seen before the fault — the steps-lost baseline.
        last_iter = None
        for rec in self._prebuffer:
            if rec.get("kind") == "iteration_start" and isinstance(
                rec.get("iteration"), int
            ):
                last_iter = rec["iteration"] if last_iter is None else max(
                    last_iter, rec["iteration"]
                )
        self._open.last_iteration_before = last_iter
        record_event(
            "incident", "incident_opened",
            incident_id=incident_id, trigger=trigger, detail=detail,
            node_id=self.node_id, ranks=self._open.ranks,
            time_to_detect_s=round(now - self._open.fault_ts, 6),
        )
        log.warning(
            f"incident {incident_id} opened: {trigger}"
            + (f" ({detail})" if detail else "")
        )
        return incident_id

    def _scan_fault_evidence(self, now: float) -> float:
        """Earliest fault-evidence timestamp in the lookback window (the
        time-to-detect anchor); the open time when no evidence was captured."""
        earliest = now
        for rec in self._prebuffer:
            ts = rec.get("ts")
            if not isinstance(ts, (int, float)) or ts < now - FAULT_LOOKBACK_S:
                continue
            if classify_phase(rec) == "detect" and ts < earliest:
                earliest = ts
        return earliest

    def close(
        self,
        outcome: str = "recovered",
        resumed_iteration: Optional[int] = None,
        _closing_rec: Optional[dict] = None,
    ) -> Optional[str]:
        """Close the open incident and write its artifact. Returns the
        artifact path (None when no incident was open)."""
        inc = self._open
        if inc is None:
            return None
        self._open = None
        now = time.time()
        if resumed_iteration is not None:
            inc.first_iteration_after = resumed_iteration
        window = self._window(inc, now)
        if _closing_rec is not None and _closing_rec not in window:
            window.append(_closing_rec)
        window.sort(key=_order_key)
        chain = self._chain(window, inc)
        slo = self._slo(inc, now, chain)
        flights = self._flights()
        artifact = {
            "schema": SCHEMA,
            "id": inc.incident_id,
            "trigger": inc.trigger,
            "detail": inc.detail,
            "node_id": self.node_id,
            "trace_id": self._dominant_trace(window),
            "outcome": outcome,
            "ranks": inc.ranks,
            "opened_ts": inc.opened_ts,
            "closed_ts": now,
            "fault_ts": inc.fault_ts,
            "slo": slo,
            "chain": chain,
            "census": inc.census,
            "events": window[-MAX_WINDOW_EVENTS:],
            "flight": flights,
        }
        path = os.path.join(self.incidents_dir, f"{inc.incident_id}.json")
        try:
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(artifact, f, indent=2, default=repr)
                f.write("\n")
            os.replace(tmp, path)
        except OSError as e:
            log.error(f"cannot write incident artifact {path!r}: {e}")
            path = None
        record_event(
            "incident", "incident_closed",
            incident_id=inc.incident_id, trigger=inc.trigger, outcome=outcome,
            node_id=self.node_id, artifact=path, **slo,
        )
        log.warning(
            f"incident {inc.incident_id} closed ({outcome}): "
            f"detect={slo['time_to_detect_s']}s decide={slo['time_to_decide_s']}s "
            f"recover={slo['time_to_recover_s']}s steps_lost={slo['steps_lost']}"
        )
        if path is not None:
            self.artifacts.append(path)
        return path

    # -- artifact assembly ---------------------------------------------------

    def _window(self, inc: _OpenIncident, now: float) -> list[dict]:
        """The incident's event window: the shared JSONL when available
        (every process's records), the local pre-buffer otherwise — sliced to
        [fault - PRE_WINDOW_S, close] and to this run's trace."""
        lo = inc.fault_ts - PRE_WINDOW_S
        recs: list[dict] = []
        if self.events_file:
            # Stream-filtered at read time: the shared file can span many
            # runs/days and must never be materialized whole at close.
            recs = read_events(self.events_file, since=lo, until=now)
        if not recs:
            recs = [
                r for r in self._prebuffer
                if isinstance(r.get("ts"), (int, float)) and lo <= r["ts"] <= now
            ]
        # Dominant trace over the window only — a longer earlier run sharing
        # the stream must not out-vote this incident's own events.
        trace = self._dominant_trace(recs)
        out = []
        for r in recs:
            if trace and r.get("trace_id") not in (None, trace):
                continue  # another run sharing the stream
            if r.get("kind") in ("incident_opened", "incident_closed"):
                continue
            out.append(r)
        return out

    @staticmethod
    def _dominant_trace(recs: list[dict]) -> Optional[str]:
        counts = Counter(
            r["trace_id"] for r in recs if isinstance(r.get("trace_id"), str)
        )
        return counts.most_common(1)[0][0] if counts else None

    @staticmethod
    def _chain(window: list[dict], inc: _OpenIncident) -> list[dict]:
        chain = []
        for r in window:
            phase = classify_phase(r)
            if phase is None:
                continue
            chain.append({
                "phase": phase,
                "ts": r.get("ts"),
                "kind": r.get("kind"),
                "source": r.get("source"),
                "rank": r.get("rank"),
                "pid": r.get("pid"),
                "summary": _summarize(r),
            })
        return chain

    def _slo(self, inc: _OpenIncident, closed_ts: float, chain: list[dict]) -> dict:
        decide_ts = inc.decide_ts
        act_ts = inc.act_ts
        recover_ts: Optional[float] = None
        for m in chain:
            ts = m.get("ts")
            if not isinstance(ts, (int, float)):
                continue
            if decide_ts is None and m["phase"] == "decide" and ts >= inc.fault_ts:
                decide_ts = ts
            if act_ts is None and m["phase"] == "act" and ts >= inc.fault_ts:
                act_ts = ts
            if m["phase"] == "recover":
                recover_ts = ts if recover_ts is None else max(recover_ts, ts)
        if recover_ts is None:
            recover_ts = closed_ts
        steps_lost = None
        if (
            inc.last_iteration_before is not None
            and inc.first_iteration_after is not None
        ):
            steps_lost = max(0, inc.last_iteration_before - inc.first_iteration_after)
        return {
            "time_to_detect_s": round(max(0.0, inc.opened_ts - inc.fault_ts), 6),
            "time_to_decide_s": (
                round(max(0.0, decide_ts - inc.opened_ts), 6)
                if decide_ts is not None else None
            ),
            "time_to_act_s": (
                round(max(0.0, act_ts - inc.opened_ts), 6)
                if act_ts is not None else None
            ),
            "time_to_recover_s": round(max(0.0, recover_ts - inc.fault_ts), 6),
            "steps_lost": steps_lost,
        }

    def _flights(self) -> dict[str, list[dict]]:
        try:
            dumps = flight_recorder.collect(self.flight_dir)
        except Exception:
            return {}
        return {
            ident: records[-MAX_FLIGHT_RECORDS:]
            for ident, records in dumps.items()
        }


def _summarize(rec: dict) -> str:
    """One short human line per chain milestone (mirrors events_summary)."""
    kind = rec.get("kind")
    if kind == "worker_failed":
        return (
            f"rank {rec.get('global_rank')} failed: "
            f"{rec.get('detail', rec.get('exitcode'))}"
        )
    if kind == "degraded_set":
        return (
            f"degraded={rec.get('degraded')} +{rec.get('newly')} "
            f"-{rec.get('recovered')}"
        )
    if kind == "straggler_report":
        return f"stragglers by perf: {rec.get('stragglers_by_perf')}"
    if kind == "remediation_decision":
        return f"plan={rec.get('plan')} for ranks {rec.get('newly')}"
    if kind == "remediation_action":
        return (
            f"{rec.get('action')} -> {rec.get('outcome')}"
            f" (ranks {rec.get('ranks')})"
        )
    if kind == "restart_requested":
        return f"restart requested: {rec.get('reason')}"
    if kind == "rendezvous_round":
        return f"round {rec.get('round')} world={rec.get('world_size')}"
    if kind == "round_succeeded":
        return f"round {rec.get('round')} succeeded"
    if kind == "kill_ladder":
        return f"step {rec.get('step')} -> rank {rec.get('global_rank')}"
    if kind == "ckpt_fallback":
        return (
            f"fallback {rec.get('from_iteration')} -> {rec.get('to_iteration')}"
        )
    if kind == "flight_flush":
        return f"flight dump: {rec.get('reason')}"
    payload = {
        k: v for k, v in rec.items()
        if k not in events_mod.RESERVED_KEYS and k != "kind"
    }
    return " ".join(f"{k}={v}" for k, v in list(payload.items())[:6])


def read_incident(path: str) -> dict:
    """Parse and schema-check one incident artifact (raises ValueError)."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("schema") != SCHEMA:
        raise ValueError(f"{path}: not a {SCHEMA} artifact")
    for key in ("id", "trigger", "outcome", "slo", "chain", "events"):
        if key not in doc:
            raise ValueError(f"{path}: missing {key!r}")
    return doc
