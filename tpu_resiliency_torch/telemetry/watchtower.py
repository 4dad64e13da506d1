"""The SLO watchtower: metric-trajectory rules raising graded early warnings.

Everything upstream of this module detects faults *after* they trip a timeout
(the hang monitor, the health checks); the watchtower looks **forward**: it
retains short metric histories in bounded rings (``utils/timeseries.py``) and
evaluates declarative :class:`AlertRule`\\ s over them — goodput-SLO burn
rate, step-time anomaly (the pre-hang straggler early warning), store p95
regression, byte-flow residue, checkpoint-coverage staleness. Firing and
resolving emit ``alert_fired`` / ``alert_resolved`` events through the
standard bridge (→ ``tpu_alerts_total{rule,severity}`` /
``tpu_alerts_active``), and live state is served at ``GET /alerts``
(``tpu-alerts-1``, folded into ``/snapshot`` so fleetd aggregates it free).

Determinism contract (what makes ``tpu-alerts`` offline replay byte-exact):
the watchtower runs on **stream time**, never wall clock. Rings are fed by
direct per-kind taps that mirror the metrics bridge's derivations (per-pid
step chains under the shared ``step_gap_max_s`` cap, store-stats delta
discipline) without its shadow-registry cost — the refresh hot path pays
roughly the ledgers' own feed price, gated by the slow-marked <5% perf test
— and rule evaluation happens at deterministic stream-clock boundaries:
``observe()`` evaluates every elapsed ``eval_interval`` boundary *before*
ingesting the record that crossed it. Feed the same records in the same order
and you get the identical (rule, fire_ts, resolve_ts) sequence — which is
exactly how the offline replay reproduces a live run from its events JSONL.
The timer thread (:meth:`Watchtower.start`) only *pumps* the feed (tails the
events file via the injected poll function); it never advances the clock.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
from typing import Callable, List, Optional, Tuple

from tpu_resiliency_torch.utils import events as tpu_events
from tpu_resiliency_torch.utils.metrics import (
    MetricsRegistry,
    MetricsSink,
    flatten_event,
    step_gap_max_s,
)
from tpu_resiliency_torch.utils.timeseries import (
    SeriesStore,
    mean_over_time,
    quantile_over_time,
    robust_zscore,
)

ALERTS_SCHEMA = "tpu-alerts-1"

#: JSON rule-override file: ``{"<rule>": {"severity": ..., "for_s": ...,
#: "disabled": ..., <param>: ...}}`` — overrides built-in rule parameters
#: without code.
ALERT_RULES_ENV = "TPU_RESILIENCY_ALERT_RULES"

#: Severity grades, most urgent first (the fleet feed's sort order).
SEVERITY_RANK = {"page": 0, "warn": 1, "info": 2}


@dataclasses.dataclass
class AlertRule:
    """One declarative rule: an expression over ring queries + hold-down.

    ``check(store, now, params)`` returns a human detail string while the
    condition holds and ``None`` while it doesn't; the engine owns the
    ok → pending (``for_s`` hold-down) → firing → resolved state machine.
    A crashing ``check`` degrades to an ``error`` field on the rule's row in
    the ``/alerts`` document — never an engine failure.
    """

    name: str
    check: Callable[[SeriesStore, float, dict], Optional[str]]
    severity: str = "warn"
    for_s: float = 0.0
    labels: dict = dataclasses.field(default_factory=dict)
    params: dict = dataclasses.field(default_factory=dict)


# -- built-in rule expressions ----------------------------------------------

def _check_goodput_burn(store: SeriesStore, now: float, p: dict):
    """Multiwindow SLO burn: error budget consumption over a fast AND a slow
    window of ``tpu_goodput_ratio`` (the classic page-on-fast, confirm-on-slow
    shape — a blip burns the fast window only, a real regression burns both).
    """
    budget = 1.0 - p["slo"]
    if budget <= 0:
        return None
    fast = store.query("tpu_goodput_ratio", start=now - p["fast_window_s"], end=now)
    slow = store.query("tpu_goodput_ratio", start=now - p["slow_window_s"], end=now)
    mf, ms = mean_over_time(fast), mean_over_time(slow)
    if mf is None or ms is None:
        return None
    burn_fast = (1.0 - mf) / budget
    burn_slow = (1.0 - ms) / budget
    if burn_fast >= p["fast_burn"] and burn_slow >= p["slow_burn"]:
        return (
            f"goodput SLO {p['slo']} burning: {burn_fast:.2f}x budget over "
            f"{p['fast_window_s']:g}s, {burn_slow:.2f}x over "
            f"{p['slow_window_s']:g}s"
        )
    return None


def _check_step_anomaly(store: SeriesStore, now: float, p: dict):
    """EWMA+MAD z-score over ``tpu_step_seconds``: the newest ``recent``
    steps must ALL sit ``z_max`` robust sigmas above the window median — a
    straggler slows steps minutes before the hang monitor's verdict, and this
    is the early warning that buys the controller that lead time."""
    s = store.query("tpu_step_seconds", start=now - p["window_s"], end=now)
    recent = int(p["recent"])
    if len(s) < int(p["min_samples"]) + recent:
        return None
    baseline, tail = s[:-recent], s[-recent:]
    zs = [robust_zscore(v, baseline) for _, v in tail]
    if any(z is None for z in zs):
        return None
    if min(zs) >= p["z_max"]:
        return (
            f"step time anomalous: last {recent} steps >= {p['z_max']:g} "
            f"robust sigmas over the {p['window_s']:g}s window "
            f"(z={max(zs):.1f}, step={tail[-1][1]:.3f}s)"
        )
    return None


def _check_store_p95(store: SeriesStore, now: float, p: dict):
    """Store op-latency regression: p95 of the recent mean-handle-latency
    samples (derived from ``store_stats`` deltas, the ``/storez`` op stats'
    stream twin) vs the p95 of the preceding baseline window."""
    recent = store.query(
        "tpu_store_mean_latency", start=now - p["window_s"], end=now
    )
    base = store.query(
        "tpu_store_mean_latency",
        start=now - p["baseline_window_s"], end=now - p["window_s"],
    )
    if len(recent) < int(p["min_samples"]) or len(base) < int(p["min_samples"]):
        return None
    r95 = quantile_over_time(recent, 0.95)
    b95 = quantile_over_time(base, 0.95)
    if b95 is None or b95 <= 0 or r95 is None:
        return None
    if r95 >= p["factor"] * b95 and r95 >= p["floor_s"]:
        return (
            f"store p95 regressed: {r95 * 1e6:.0f}us vs baseline "
            f"{b95 * 1e6:.0f}us (>= {p['factor']:g}x)"
        )
    return None


def _check_byteflow_residue(store: SeriesStore, now: float, p: dict):
    """Byte-flow ledger residue: the accounted ratio (the >= 0.95 acceptance
    gate, live) dropping under the floor means wire traffic the ledger can no
    longer attribute — an instrumentation gap, not a byte-economy win."""
    s = store.query(
        "tpu_byteflow_accounted_ratio", start=now - p["window_s"], end=now
    )
    if not s:
        return None
    ratio = s[-1][1]
    if ratio < p["min_ratio"]:
        return (
            f"byteflow residue: accounted_ratio {ratio:.3f} < "
            f"{p['min_ratio']:g} (unattributed wire bytes)"
        )
    return None


def _check_ckpt_staleness(store: SeriesStore, now: float, p: dict):
    """Checkpoint-coverage staleness: training steps are flowing but no
    durable save has landed within ``max_age_s`` — every additional step is
    uncovered work a restart would replay."""
    steps = store.query("tpu_step_seconds", start=now - p["window_s"], end=now)
    if not steps:
        return None  # idle job: nothing at risk
    saves = store.query("tpu_ckpt_saves", end=now)
    ref = saves[-1][0] if saves else steps[0][0]
    age = now - ref
    if age > p["max_age_s"]:
        return (
            f"checkpoint coverage stale: {age:.0f}s since last durable save "
            f"(> {p['max_age_s']:g}s) with steps still flowing"
        )
    return None


#: name → (check, severity, for_s, params) — the shipped rule table.
BUILTIN_RULES = {
    "goodput_burn": (_check_goodput_burn, "page", 0.0, {
        "slo": 0.90, "fast_window_s": 60.0, "slow_window_s": 600.0,
        "fast_burn": 2.0, "slow_burn": 1.0,
    }),
    "step_anomaly": (_check_step_anomaly, "page", 0.0, {
        "window_s": 600.0, "recent": 3, "min_samples": 8, "z_max": 6.0,
    }),
    "store_p95_regression": (_check_store_p95, "warn", 10.0, {
        "window_s": 60.0, "baseline_window_s": 600.0, "min_samples": 3,
        "factor": 3.0, "floor_s": 0.0005,
    }),
    "byteflow_residue": (_check_byteflow_residue, "warn", 30.0, {
        "window_s": 600.0, "min_ratio": 0.95,
    }),
    "ckpt_staleness": (_check_ckpt_staleness, "warn", 0.0, {
        "window_s": 600.0, "max_age_s": 1800.0,
    }),
}


def load_rule_overrides(
    path: Optional[str] = None,
) -> Tuple[dict, Optional[str]]:
    """Read the ``$TPU_RESILIENCY_ALERT_RULES`` JSON override file.

    Returns ``(overrides, error)`` — a bad file yields an empty override set
    plus the error string (surfaced on the ``/alerts`` document), never an
    exception: alert config must not take down telemetry.
    """
    path = path if path is not None else os.environ.get(ALERT_RULES_ENV)
    if not path:
        return {}, None
    try:
        with open(path) as f:
            doc = json.load(f)
        if not isinstance(doc, dict):
            raise ValueError("override document must be a JSON object")
        return doc, None
    except (OSError, ValueError) as e:
        return {}, f"{path}: {e}"


def default_rules(overrides: Optional[dict] = None) -> List[AlertRule]:
    """The built-in rule table, with per-rule overrides applied.

    Override shape per rule name: ``severity`` / ``for_s`` / ``labels`` /
    ``disabled`` adjust the envelope; any other key overrides that rule's
    expression parameter. Unknown rule names and unknown parameter keys are
    ignored (forward compatibility beats a hard failure here).
    """
    overrides = overrides or {}
    rules = []
    for name, (check, severity, for_s, params) in BUILTIN_RULES.items():
        ov = overrides.get(name)
        ov = dict(ov) if isinstance(ov, dict) else {}
        if ov.pop("disabled", False):
            continue
        merged = dict(params)
        severity = str(ov.pop("severity", severity))
        for_s = float(ov.pop("for_s", for_s))
        labels = ov.pop("labels", None)
        merged.update({
            k: v for k, v in ov.items() if k in params
        })
        rules.append(AlertRule(
            name=name, check=check, severity=severity, for_s=for_s,
            labels=dict(labels) if isinstance(labels, dict) else {},
            params=merged,
        ))
    return rules


class Watchtower:
    """The rule engine: rings + stream clock + alert state machine.

    Feed it flat event records (JSONL dicts or flattened Events) through
    :meth:`observe` — from the telemetry server's events tail live, from a
    file replay offline, from an in-process :class:`WatchtowerSink` in tests.
    """

    def __init__(
        self,
        rules: Optional[List[AlertRule]] = None,
        *,
        eval_interval: float = 5.0,
        ring_capacity: int = 512,
        emit: Optional[Callable[[str, dict], None]] = None,
        history_limit: int = 256,
        job: Optional[str] = None,
    ):
        if rules is None:
            overrides, err = load_rule_overrides()
            rules = default_rules(overrides)
            self.config_error = err
        else:
            self.config_error = None
        self.rules = list(rules)
        self.eval_interval = float(eval_interval)
        self.job = job
        self.store = SeriesStore(capacity=ring_capacity)
        self._emit = emit if emit is not None else self._default_emit
        self._tap_steps: dict = {}   # pid -> (ts, iteration) step-chain state
        self._tap_ckpt = 0           # cumulative ckpt_saved count
        self._tap_store_ops = 0.0    # store_stats deltas pending a sample
        self._tap_store_secs = 0.0
        self._states = {
            r.name: {
                "state": "ok", "since": None, "fire_ts": None,
                "detail": None, "error": None, "fired_total": 0,
            }
            for r in self.rules
        }
        self._history: collections.deque = collections.deque(maxlen=history_limit)
        self._hwm: Optional[float] = None
        self._next_eval: Optional[float] = None
        self._evals = 0
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    @staticmethod
    def _default_emit(kind: str, payload: dict) -> None:
        tpu_events.record("watchtower", kind, **payload)

    # -- feed --------------------------------------------------------------

    def observe(self, rec: dict) -> List[dict]:
        """Ingest one record; returns the alert transitions it caused.

        Clock discipline: every ``eval_interval`` boundary the record's ``ts``
        has passed is evaluated BEFORE the record lands in the rings, so ring
        contents at each boundary are a pure function of record order — the
        replay-parity invariant. A pathological stream gap (> 256 boundaries)
        snaps the clock forward rather than looping; the snap depends only on
        the stream, so replays still agree.
        """
        if not isinstance(rec, dict):
            return []
        ts = rec.get("ts")
        if not isinstance(ts, (int, float)):
            return []
        transitions: List[dict] = []
        with self._lock:
            if self._next_eval is None:
                self._next_eval = ts + self.eval_interval
            guard = 0
            while ts >= self._next_eval and guard < 256:
                transitions.extend(self._evaluate_locked(self._next_eval))
                self._next_eval += self.eval_interval
                guard += 1
            if ts >= self._next_eval:
                self._next_eval = ts + self.eval_interval
            self._hwm = ts if self._hwm is None else max(self._hwm, ts)
            self._ingest_locked(rec, ts)
        for tr in transitions:
            try:
                self._emit(tr["kind"], {k: v for k, v in tr.items() if k != "kind"})
            except Exception:
                pass  # observability, not control flow
        return transitions

    def observe_many(self, records) -> List[dict]:
        out = []
        for rec in records:
            out.extend(self.observe(rec))
        return out

    def _ingest_locked(self, rec: dict, ts: float) -> None:
        # Direct taps on the handful of kinds the rules window over — the
        # SAME derivations the metrics bridge performs (per-pid step chains
        # under the shared gap cap, store-stats delta discipline), inlined so
        # the refresh hot path stays cheap: this runs per record, a full
        # ``observe_record`` into a shadow registry measured ~10x the
        # ledgers' own feed cost. Gauges sample straight from the record to
        # stay on stream time (the registry's gauges stamp wall clock).
        kind = rec.get("kind")
        if kind == "iteration_start":
            # A step = strictly-consecutive iteration within the gap cap;
            # repeats (in-process restart) and long gaps are downtime.
            it = rec.get("iteration")
            if isinstance(it, int):
                pid = rec.get("pid")
                prev = self._tap_steps.get(pid)
                if (
                    prev is not None and it == prev[1] + 1
                    and 0 < ts - prev[0] <= step_gap_max_s()
                ):
                    self.store.observe("tpu_step_seconds", ts, ts - prev[0])
                self._tap_steps[pid] = (ts, it)
        elif kind == "goodput_update":
            if isinstance(rec.get("ratio"), (int, float)):
                self.store.observe("tpu_goodput_ratio", ts, rec["ratio"])
        elif kind == "byteflow_update":
            if isinstance(rec.get("accounted_ratio"), (int, float)):
                self.store.observe(
                    "tpu_byteflow_accounted_ratio", ts, rec["accounted_ratio"]
                )
        elif kind == "ckpt_saved":
            # Cumulative save count at save ts (counter semantics: rate()
            # over the ring gives saves/s; last() gives the freshness tap).
            self._tap_ckpt += 1
            self.store.observe("tpu_ckpt_saves", ts, float(self._tap_ckpt))
        elif kind == "store_stats":
            # The store emits movement-since-last-emit deltas; seconds from
            # an ops-less emit stay pending until ops arrive, matching the
            # cumulative-counter diff the metrics bridge would see.
            ops = rec.get("ops")
            if isinstance(ops, dict):
                self._tap_store_ops += sum(
                    n for n in ops.values()
                    if isinstance(n, (int, float)) and n > 0
                )
            secs = rec.get("op_seconds")
            if isinstance(secs, dict):
                self._tap_store_secs += sum(
                    s for s in secs.values()
                    if isinstance(s, (int, float)) and s > 0
                )
            if self._tap_store_ops > 0:
                self.store.observe(
                    "tpu_store_mean_latency", ts,
                    max(0.0, self._tap_store_secs) / self._tap_store_ops,
                )
                self._tap_store_ops = 0.0
                self._tap_store_secs = 0.0

    # -- evaluation --------------------------------------------------------

    def _evaluate_locked(self, now: float) -> List[dict]:
        self._evals += 1
        out: List[dict] = []
        for rule in self.rules:
            st = self._states[rule.name]
            try:
                detail = rule.check(self.store, now, rule.params)
                st["error"] = None
            except Exception as e:
                # A crashing rule degrades to an error row on /alerts — the
                # other rules, the engine, and the endpoint keep working.
                st["error"] = repr(e)
                continue
            if detail is not None:
                if st["state"] == "ok":
                    st.update(state="pending", since=now, detail=detail)
                if st["state"] == "pending" and now - st["since"] >= rule.for_s:
                    st.update(state="firing", fire_ts=now, detail=detail)
                    st["fired_total"] += 1
                    out.append(self._transition_locked(
                        "alert_fired", rule, st, now,
                    ))
                elif st["state"] == "firing":
                    st["detail"] = detail
            else:
                if st["state"] == "firing":
                    out.append(self._transition_locked(
                        "alert_resolved", rule, st, now,
                    ))
                st.update(state="ok", since=None, fire_ts=None, detail=None)
        return out

    def _transition_locked(
        self, kind: str, rule: AlertRule, st: dict, now: float
    ) -> dict:
        tr = {
            "kind": kind, "rule": rule.name, "severity": rule.severity,
            "for_s": rule.for_s, "fire_ts": st["fire_ts"], "detail": st["detail"],
        }
        if rule.labels:
            tr["labels"] = dict(rule.labels)
        if kind == "alert_resolved":
            tr["resolve_ts"] = now
            tr["duration_s"] = round(now - st["fire_ts"], 6)
        self._history.append(dict(tr))
        return tr

    # -- serving -----------------------------------------------------------

    def active_alerts(self) -> List[dict]:
        """Currently-firing alerts, severity-ranked — the ``ControllerView``
        input that lets a page-grade early warning bias the autoscale
        decision ahead of the hang verdict."""
        with self._lock:
            rows = [
                {
                    "rule": r.name, "severity": r.severity,
                    "fire_ts": st["fire_ts"], "for_s": r.for_s,
                    "detail": st["detail"], "labels": dict(r.labels),
                }
                for r in self.rules
                for st in (self._states[r.name],)
                if st["state"] == "firing"
            ]
        rows.sort(key=lambda a: (SEVERITY_RANK.get(a["severity"], 9), a["rule"]))
        return rows

    def status(self) -> dict:
        """The ``GET /alerts`` document (``tpu-alerts-1``)."""
        with self._lock:
            rules = [
                {
                    "name": r.name, "severity": r.severity, "for_s": r.for_s,
                    "state": st["state"], "since": st["since"],
                    "fire_ts": st["fire_ts"], "detail": st["detail"],
                    "error": st["error"], "fired_total": st["fired_total"],
                    "params": dict(r.params),
                }
                for r in self.rules
                for st in (self._states[r.name],)
            ]
            doc = {
                "schema": ALERTS_SCHEMA,
                "clock": {
                    "hwm": self._hwm, "next_eval": self._next_eval,
                    "eval_interval": self.eval_interval, "evals": self._evals,
                },
                "rules": rules,
                "history": list(self._history)[-50:],
                "rings": self.store.sizes(),
            }
        if self.job is not None:
            doc["job"] = self.job
        if self.config_error:
            doc["config_error"] = self.config_error
        doc["active"] = self.active_alerts()
        return doc

    # -- the timer thread --------------------------------------------------

    def start(
        self,
        poll_fn: Optional[Callable[[], object]] = None,
        interval: float = 2.0,
    ) -> None:
        """Pump the feed on a timer: ``poll_fn`` (typically the telemetry
        server's ``refresh``, which tails the events file into
        :meth:`observe`) runs every ``interval`` seconds so alerts fire and
        resolve even when nobody is scraping. The thread never advances the
        stream clock itself — determinism lives in :meth:`observe`."""
        if self._thread is not None:
            return
        self._stop.clear()

        def run() -> None:
            while not self._stop.wait(interval):
                if poll_fn is not None:
                    try:
                        poll_fn()
                    except Exception:
                        pass  # the next tick retries

        self._thread = threading.Thread(
            target=run, name="watchtower", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)


class WatchtowerSink(MetricsSink):
    """``events.add_sink`` bridge feeding a :class:`Watchtower` in-process.

    Flattens Events exactly like :class:`MetricsSink` (the shared
    ``flatten_event``, including the ``p_``-rename of envelope-colliding
    payload keys) so the sink-fed live path and a JSONL replay see the SAME
    record shapes — the live/post-hoc parity contract.
    """

    def __init__(self, watchtower: Watchtower, registry=None):
        super().__init__(
            registry=registry if registry is not None else MetricsRegistry()
        )
        self.watchtower = watchtower

    def __call__(self, event) -> None:
        self.watchtower.observe(flatten_event(event))


def replay(
    records,
    rules: Optional[List[AlertRule]] = None,
    *,
    eval_interval: float = 5.0,
    ring_capacity: int = 512,
) -> Tuple[Watchtower, List[dict]]:
    """Run the engine over a finished stream; returns ``(tower, sequence)``.

    The sequence is every transition in stream order — what ``tpu-alerts``
    renders offline and what the chaos campaign byte-compares against the
    ``alert_fired`` / ``alert_resolved`` events the live run recorded.
    Recorded alert events in the input stream are inert here (they only feed
    the private registry's event counter), so replaying a live stream does
    not double-fire.
    """
    sequence: List[dict] = []
    tower = Watchtower(
        rules=rules, eval_interval=eval_interval, ring_capacity=ring_capacity,
        emit=lambda kind, payload: sequence.append({"kind": kind, **payload}),
    )
    tower.observe_many(records)
    return tower, sequence
