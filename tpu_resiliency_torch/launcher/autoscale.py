"""Goodput-optimal autoscale controller: close the detect→decide→act loop.

Every plane this stack built stops one step short of autonomy: the goodput
ledger (``utils/goodput.py``) prices every second, the health-vector policy
(``telemetry/policy.py``) names the stragglers, the remediation engine
(``telemetry/remediation.py``) can checkpoint/swap/exclude, elastic resharding
(``checkpoint/reshard.py``) can shrink-and-continue, and warm spares
(``launcher/park.py``) make the transitions cheap — but an operator (or a
hard-coded policy) still decides *whether a straggler is worth a swap* or *a
preemption notice is worth a shrink*. The reference NVRx stack never closes
this loop either: its elastic agent reacts to membership, it never optimizes
a decision.

The :class:`AutoscaleController` closes it. A control loop in the launcher
consumes the signals the planes already emit — straggler scores
(``degraded_set`` events / :class:`~tpu_resiliency_torch.telemetry.policy.
HealthDecision` sink), warm-spare depth (``warm_spare_pool`` events or a
live callable), preemption notices *including later rescinds*
(``preemption_sync_point`` / ``preemption_rescinded``), step cadence and
checkpoint recency (``iteration_start`` / ``ckpt_saved``) — and selects among

====================  =======================================================
action                when it wins
====================  =======================================================
``noop``              every candidate's predicted goodput delta is ≤ 0
``swap``              a straggler gates the job and warm spares exist: pay
                      one warm respawn, shed the slow rank
``exclude``           a straggler gates the job and NO spare exists: reshape
                      around it (capacity loss < straggler loss)
``checkpoint``        a preemption notice is pending and unbanked progress
                      exceeds the proactive save's cost
``shrink``            a notice outlived its rescind window (or its deadline
                      is imminent): shrink via ``load_resharded`` beats dying
                      at the deadline
``expand``            capacity returned, the world is below target, and the
                      hysteresis dwell passed
====================  =======================================================

using an **explicit, testable cost model**: :meth:`CostModel.estimate` turns
one candidate action into a predicted goodput delta in seconds over a fixed
horizon, from constants seeded by the measured benchmarks
(``BENCH_restart.json`` / ``BENCH_reshard.json`` — :meth:`CostModel.
from_bench`) and refined online from realized outcomes
(:meth:`CostModel.note_outcome`, a bounded per-action EWMA correction).

Audit is the contract. Every decision is an ``autoscale_decision`` event
(action, victims, mode, actuation outcome, ``predicted_delta_s``, reason) →
``tpu_autoscale_decisions_total{action,outcome}``; once its measurement
window closes, an ``autoscale_outcome`` event pairs the prediction with the
**realized** delta (training seconds gained versus the decision-time trend)
→ ``tpu_autoscale_predicted_vs_realized{action}`` — the controller's own
forecast accuracy is a first-class metric. Decisions route through the
:class:`~tpu_resiliency_torch.telemetry.remediation.RemediationEngine` actuators
(``execute_action``) with its cooldown/dry-run audit semantics; shrink and
re-expand go through injected callables (the launcher wires restart-round
requests; the workers' ``load_resharded`` makes the new world trainable). A
hysteresis band (minimum predicted gain + a dwell between opposite resizes)
prevents shrink/expand flapping, and a rescinded notice simply removes the
shrink candidate before the dwell expires — the job never pays for a
reclamation that didn't happen.

Modes (the launcher's ``--autoscale`` flag): ``off`` (no controller),
``advise`` — the safe default when enabling: every decision is computed,
audited, and served on ``/autoscale``, but nothing actuates — and ``act``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Callable, Optional

from tpu_resiliency_torch.utils.events import record as record_event
from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)

SCHEMA = "tpu-autoscale-1"

#: action names (the ``action`` label of ``tpu_autoscale_decisions_total``)
ACTION_NOOP = "noop"
ACTION_SWAP = "swap"
ACTION_EXCLUDE = "exclude"
ACTION_CHECKPOINT = "checkpoint"
ACTION_SHRINK = "shrink"
ACTION_EXPAND = "expand"

ACTIONS = (
    ACTION_NOOP, ACTION_SWAP, ACTION_EXCLUDE, ACTION_CHECKPOINT,
    ACTION_SHRINK, ACTION_EXPAND,
)

MODE_OFF = "off"
MODE_ADVISE = "advise"
MODE_ACT = "act"
MODES = (MODE_OFF, MODE_ADVISE, MODE_ACT)

#: actuation outcomes (the ``outcome`` label)
OUTCOME_ADVISED = "advised"
OUTCOME_OK = "ok"
OUTCOME_FAILED = "failed"
OUTCOME_SKIPPED = "skipped"


@dataclasses.dataclass
class Notice:
    """One pending preemption notice. ``deadline`` is an absolute timestamp
    when known (the scheduler's grace window), else None — the rescind grace
    then stands in for it."""

    key: str
    rank: Optional[int] = None
    noticed_at: float = 0.0
    deadline: Optional[float] = None


@dataclasses.dataclass
class ControllerView:
    """One tick's snapshot of every signal the cost model prices. Assembled
    by the controller, but constructible by hand — the cost model and the
    decision function are pure over it (the unit-test surface)."""

    now: float
    world_size: int
    target_world: int
    #: rank -> perf score (1.0 healthy, lower is slower) for currently
    #: degraded ranks
    stragglers: dict[int, float]
    spares: int
    notices: list[Notice]
    #: EWMA training-step wall clock (None before the first delta)
    step_s: Optional[float]
    steps_since_ckpt: int
    #: active watchtower alerts ({rule, severity, ...} rows) — the SLO
    #: plane's early warning, biasing checkpoint/swap ahead of the hang
    #: verdict. Appended last with a default so hand-built views predate it.
    active_alerts: list = dataclasses.field(default_factory=list)

    def page_alerts(self) -> list:
        """The page-severity subset — the only grade the cost model prices."""
        return [
            a for a in self.active_alerts
            if isinstance(a, dict) and a.get("severity") == "page"
        ]


@dataclasses.dataclass
class Decision:
    """One audited controller decision."""

    decision_id: int
    action: str
    victims: list[int]
    predicted_delta_s: float
    reason: str
    ts: float
    mode: str
    outcome: str = OUTCOME_ADVISED
    realized_delta_s: Optional[float] = None
    settled: bool = False


class CostModel:
    """Predicted goodput delta, in seconds over ``horizon_s``, per action.

    The constants are the measured world: ``warm_restart_s`` and
    ``cold_restart_s`` from ``BENCH_restart.json`` (warm-spare vs cold
    respawn chains), ``reshard_s`` from ``BENCH_reshard.json`` (the ranged
    resharded-resume wall time), ``ckpt_s`` the proactive save's
    caller-visible stall. ``estimate`` is pure over a
    :class:`ControllerView`; :meth:`note_outcome` folds realized outcomes
    into a bounded per-action EWMA correction factor so a systematically
    optimistic forecast self-deflates instead of repeating its mistake.
    """

    def __init__(
        self,
        *,
        horizon_s: float = 60.0,
        warm_restart_s: float = 0.06,
        cold_restart_s: float = 0.75,
        reshard_s: float = 0.15,
        ckpt_s: float = 0.10,
        #: probability a notice that reaches its deadline actually reclaims
        #: the capacity (rescinds make this < 1)
        p_preempt: float = 0.7,
        #: probability a page-severity watchtower alert (pre-hang straggler,
        #: SLO burn) escalates into lost progress if nothing is banked
        p_alert_risk: float = 0.35,
        #: extra outage beyond the cold restart when a preemption kills a
        #: rank with no shrink prepared (blocked re-rendezvous, fallback loss)
        preempt_block_s: float = 2.0,
        #: fraction of nominal throughput one excluded/shrunk rank is worth
        #: (data-parallel capacity is roughly linear in ranks)
        capacity_weight: float = 1.0,
        #: EWMA weight of each realized outcome on the per-action correction
        ewma_alpha: float = 0.3,
    ):
        self.horizon_s = horizon_s
        self.warm_restart_s = warm_restart_s
        self.cold_restart_s = cold_restart_s
        self.reshard_s = reshard_s
        self.ckpt_s = ckpt_s
        self.p_preempt = p_preempt
        self.p_alert_risk = p_alert_risk
        self.preempt_block_s = preempt_block_s
        self.capacity_weight = capacity_weight
        self.ewma_alpha = ewma_alpha
        #: per-action multiplicative correction, refined from realized
        #: outcomes and clamped to [0.25, 4.0] so one outlier can neither
        #: mute nor explode the model
        self.corrections: dict[str, float] = {}
        #: per-action (n, sum_predicted, sum_realized) — forecast accuracy
        self.outcomes: dict[str, list[float]] = {}

    @classmethod
    def from_bench(cls, bench_dir: str, **overrides) -> "CostModel":
        """Seed the constants from the repo's measured benchmarks when the
        artifacts exist; silently keep the defaults where they don't (a fresh
        checkout prices conservatively instead of crashing)."""
        kw: dict[str, float] = {}
        try:
            with open(os.path.join(bench_dir, "BENCH_restart.json")) as f:
                b = json.load(f)
            warm = b.get("in_job_warm_spares") or {}
            cold = b.get("in_job") or {}
            w = sum(
                warm.get(k, 0.0) or 0.0
                for k in ("detect_ms", "teardown_ms", "rendezvous_ms",
                          "respawn_ms")
            ) / 1e3
            c = sum(
                cold.get(k, 0.0) or 0.0
                for k in ("detect_ms", "teardown_ms", "rendezvous_ms",
                          "respawn_ms")
            ) / 1e3
            if w > 0:
                kw["warm_restart_s"] = w
            if c > 0:
                kw["cold_restart_s"] = c
        except (OSError, ValueError):
            pass
        try:
            with open(os.path.join(bench_dir, "BENCH_reshard.json")) as f:
                r = json.load(f)
            # Prefer the phase decomposition: plan + fetch is the
            # true per-rank resize stall once serve/fetch/assembly overlap —
            # the top-line ranged_s also charges the local assembly that now
            # hides under the fetch, so pricing from it overstates elasticity
            # cost and the controller under-chooses shrink/expand.
            phases = r.get("phases") or {}
            plan_s = phases.get("plan_s")
            fetch_s = phases.get("fetch_s")
            if (
                isinstance(plan_s, (int, float))
                and isinstance(fetch_s, (int, float))
                and plan_s >= 0 and fetch_s > 0
            ):
                kw["reshard_s"] = float(plan_s) + float(fetch_s)
            elif isinstance(r.get("ranged_s"), (int, float)) and r["ranged_s"] > 0:
                kw["reshard_s"] = float(r["ranged_s"])
        except (OSError, ValueError):
            pass
        kw.update(overrides)
        return cls(**kw)

    # -- the estimates ------------------------------------------------------

    def _corr(self, action: str) -> float:
        return self.corrections.get(action, 1.0)

    @staticmethod
    def _slow_frac(view: ControllerView) -> float:
        """How much of the job's throughput the stragglers eat: synchronous
        training is gated by its slowest rank, so the worst score bounds the
        whole job's step inflation."""
        if not view.stragglers:
            return 0.0
        worst = min(view.stragglers.values())
        return min(1.0, max(0.0, 1.0 - worst))

    def estimate(self, action: str, view: ControllerView) -> float:
        """Predicted goodput delta (training seconds gained over
        ``horizon_s`` versus doing nothing) for ``action`` under ``view``.
        Negative means the action costs more than it saves."""
        H = self.horizon_s
        k = max(1, len(view.stragglers))
        W = max(1, view.world_size)
        if action == ACTION_NOOP:
            return 0.0
        if action == ACTION_SWAP:
            # Shed the straggler for one warm respawn; capacity unchanged.
            return self._slow_frac(view) * H * self._corr(action) - self.warm_restart_s
        if action == ACTION_EXCLUDE:
            # No spare: reshape around the slow ranks. Gain = straggler drag
            # minus the excluded ranks' share of nominal capacity.
            gain = (self._slow_frac(view) - self.capacity_weight * k / W) * H
            return gain * self._corr(action) - self.reshard_s
        if action == ACTION_CHECKPOINT:
            # Bank unbanked progress before a notice can kill the rank — or,
            # absent a notice, before a page-severity watchtower alert
            # (pre-hang straggler, SLO burn) turns into the hang verdict.
            pages = view.page_alerts()
            if view.step_s is None or not (view.notices or pages):
                return -self.ckpt_s
            at_risk = min(view.steps_since_ckpt * view.step_s, H)
            p = self.p_preempt if view.notices else self.p_alert_risk
            return p * at_risk * self._corr(action) - self.ckpt_s
        if action == ACTION_SHRINK:
            # Ride out the reclamation training at W-k instead of dying at
            # the deadline (cold restart + blocked re-rendezvous + the
            # progress the fallback loses). The shrunk ranks' capacity is NOT
            # charged here: the scheduler reclaims them under no-op too — the
            # delta between the branches is only the death it avoids.
            avoided = self.p_preempt * (self.cold_restart_s + self.preempt_block_s)
            return avoided * self._corr(action) - self.reshard_s
        if action == ACTION_EXPAND:
            missing = max(0, view.target_world - view.world_size)
            gain = self.capacity_weight * missing / max(1, view.target_world) * H
            return gain * self._corr(action) - self.reshard_s
        raise ValueError(f"unknown autoscale action {action!r}")

    def note_outcome(self, action: str, predicted: float, realized: float) -> None:
        """Fold one realized outcome into the per-action correction: the
        EWMA of realized/predicted, clamped, applied multiplicatively to
        future estimates of the same action."""
        st = self.outcomes.setdefault(action, [0.0, 0.0, 0.0])
        st[0] += 1
        st[1] += predicted
        st[2] += realized
        if abs(predicted) < 1e-9:
            return
        ratio = max(0.25, min(4.0, realized / predicted))
        prev = self.corrections.get(action, 1.0)
        a = self.ewma_alpha
        self.corrections[action] = max(
            0.25, min(4.0, (1 - a) * prev + a * ratio)
        )

    def constants(self) -> dict:
        """The explicit model, for the ``/autoscale`` document and the docs'
        decision-matrix table."""
        return {
            "horizon_s": self.horizon_s,
            "warm_restart_s": self.warm_restart_s,
            "cold_restart_s": self.cold_restart_s,
            "reshard_s": self.reshard_s,
            "ckpt_s": self.ckpt_s,
            "p_preempt": self.p_preempt,
            "p_alert_risk": self.p_alert_risk,
            "preempt_block_s": self.preempt_block_s,
            "capacity_weight": self.capacity_weight,
            "corrections": {
                a: round(c, 4) for a, c in sorted(self.corrections.items())
            },
        }


class AutoscaleController:
    """The control loop. Feed it signals (``observe`` event records, or the
    direct ``note_*`` calls), tick it (own thread via :meth:`start`, or
    explicitly via :meth:`tick` — the deterministic path the chaos scenario
    drives), and it decides, actuates, and audits.

    Actuation routing (``act`` mode):

    - ``swap`` / ``exclude`` / ``checkpoint`` run through the wired
      :class:`~tpu_resiliency_torch.telemetry.remediation.RemediationEngine`
      (``execute_action``), inheriting its cooldown/dry-run audit semantics —
      one audit trail for policy-driven and controller-driven remediations.
    - ``shrink`` / ``expand`` run the injected ``shrink_fn(victims, reason)``
      / ``expand_fn(reason)`` callables (the launcher wires restart-round
      requests; the workers' ``load_resharded`` resume does the real work).

    ``advise`` mode computes, audits, and serves every decision but actuates
    nothing (``outcome="advised"``) — the safe way to trust the model before
    handing it the keys.

    Realized outcomes: the controller keeps a minimal internal train ledger
    (consecutive ``iteration_start`` deltas, gap-capped) and, once a
    decision's ``outcome_window_s`` elapses, scores it as *training seconds
    gained versus the decision-time trend*::

        realized = (train(t1) - train(t0)) - ratio(t0) * (t1 - t0)

    then feeds (predicted, realized) back into the cost model and emits the
    paired ``autoscale_outcome`` event.
    """

    def __init__(
        self,
        *,
        mode: str = MODE_ADVISE,
        cost_model: Optional[CostModel] = None,
        remediation: Any = None,
        spare_capacity_fn: Optional[Callable[[], int]] = None,
        #: the watchtower's ``active_alerts`` — polled per tick, so the SLO
        #: plane's early warning reaches the view before the hang verdict
        active_alerts_fn: Optional[Callable[[], list]] = None,
        shrink_fn: Optional[Callable[[list, str], None]] = None,
        expand_fn: Optional[Callable[[str], None]] = None,
        target_world: Optional[int] = None,
        events_file: Optional[str] = None,
        interval: float = 1.0,
        #: a notice younger than this is still rescindable — shrink waits it
        #: out (unless an explicit deadline is closer)
        rescind_grace_s: float = 5.0,
        #: shrink this long before a known deadline
        shrink_lead_s: float = 1.0,
        #: hysteresis: minimum predicted gain for a world resize, and the
        #: dwell both resize directions must respect
        hysteresis_s: float = 0.5,
        dwell_s: float = 5.0,
        #: identical (action, victims) decisions inside this window are
        #: suppressed (advise mode would otherwise narrate every tick)
        decision_cooldown_s: float = 30.0,
        #: how long after a decision its realized delta is measured
        outcome_window_s: float = 10.0,
        max_step_s: float = 300.0,
        now_fn: Callable[[], float] = time.time,
    ):
        if mode not in (MODE_ADVISE, MODE_ACT):
            raise ValueError(
                f"autoscale mode {mode!r}: want {MODE_ADVISE!r} or {MODE_ACT!r} "
                f"(off means: no controller)"
            )
        self.mode = mode
        self.model = cost_model if cost_model is not None else CostModel()
        self.remediation = remediation
        self.spare_capacity_fn = spare_capacity_fn
        self.active_alerts_fn = active_alerts_fn
        self.shrink_fn = shrink_fn
        self.expand_fn = expand_fn
        self.target_world = target_world
        self.events_file = events_file
        self.interval = interval
        self.rescind_grace_s = rescind_grace_s
        self.shrink_lead_s = shrink_lead_s
        self.hysteresis_s = hysteresis_s
        self.dwell_s = dwell_s
        self.decision_cooldown_s = decision_cooldown_s
        self.outcome_window_s = outcome_window_s
        self.max_step_s = max_step_s
        self._now = now_fn
        # -- signal state ---------------------------------------------------
        self._lock = threading.RLock()
        self._world_size = 0
        self._stragglers: dict[int, float] = {}
        self._spares_seen = 0
        self._notices: dict[str, Notice] = {}
        self._rescinds = 0
        self._step_ewma: Optional[float] = None
        self._steps_since_ckpt = 0
        self._last_step: dict[Any, tuple[float, int]] = {}
        # -- internal train ledger (realized-outcome scoring) ---------------
        self._wall0: Optional[float] = None
        self._wall1: Optional[float] = None
        self._train_s = 0.0
        # -- audit ----------------------------------------------------------
        self.decisions: list[Decision] = []
        self._next_id = 0
        self._last_decided: dict[tuple, float] = {}
        self._last_resize_ts = float("-inf")
        # -- thread/tail ----------------------------------------------------
        self._offset = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- signal ingestion ---------------------------------------------------

    def observe_many(self, recs) -> None:
        for rec in recs:
            if isinstance(rec, dict):
                self.observe(rec)

    def observe(self, rec: dict) -> None:
        """One flat event record (the JSONL line shape). The controller's
        inputs all ride the same stream everything else narrates to."""
        kind = rec.get("kind")
        ts = rec.get("ts")
        if not isinstance(kind, str) or not isinstance(ts, (int, float)):
            return
        with self._lock:
            if self._wall0 is None or ts < self._wall0:
                self._wall0 = ts
            if self._wall1 is None or ts > self._wall1:
                self._wall1 = ts
            if kind == "iteration_start":
                it = rec.get("iteration")
                if not isinstance(it, int):
                    return
                pid = rec.get("pid")
                prev = self._last_step.get(pid)
                if (
                    prev is not None and it == prev[1] + 1
                    and 0 < ts - prev[0] <= self.max_step_s
                ):
                    d = ts - prev[0]
                    self._train_s += d
                    self._step_ewma = (
                        d if self._step_ewma is None
                        else 0.7 * self._step_ewma + 0.3 * d
                    )
                    self._steps_since_ckpt += 1
                self._last_step[pid] = (ts, it)
            elif kind == "ckpt_saved":
                self._steps_since_ckpt = 0
            elif kind == "degraded_set":
                degraded = rec.get("degraded")
                if isinstance(degraded, list):
                    scores = rec.get("scores") or {}
                    self._stragglers = {
                        int(r): float(scores.get(str(r), scores.get(r, 0.0)))
                        for r in degraded
                    }
            elif kind == "warm_spare_pool":
                if isinstance(rec.get("warm"), (int, float)):
                    self._spares_seen = int(rec["warm"])
            elif kind in ("rendezvous_round", "world_resized"):
                ws = rec.get("world_size", rec.get("to_world"))
                if isinstance(ws, (int, float)) and ws > 0:
                    self._world_size = int(ws)
                    if self.target_world is None or ws > self.target_world:
                        self.target_world = int(ws)
            elif kind == "preemption_sync_point":
                rank = rec.get("rank")
                key = f"r{rank}" if isinstance(rank, int) else f"n{len(self._notices)}"
                self._notices.setdefault(
                    key, Notice(key=key, rank=rank if isinstance(rank, int)
                                else None, noticed_at=ts)
                )
            elif kind == "preemption_rescinded":
                rank = rec.get("rank")
                key = f"r{rank}" if isinstance(rank, int) else None
                if key is not None and key in self._notices:
                    del self._notices[key]
                    self._rescinds += 1
                elif self._notices:
                    # Rankless rescind: clear the oldest notice — a withdrawn
                    # reclamation must stop driving shrink decisions.
                    oldest = min(self._notices.values(), key=lambda n: n.noticed_at)
                    del self._notices[oldest.key]
                    self._rescinds += 1

    # -- direct feeds (launcher wiring / tests) -----------------------------

    def note_health(self, decision) -> None:
        """A :class:`~tpu_resiliency_torch.telemetry.policy.HealthDecision` sink:
        wire as ``HealthVectorPolicy(sinks=[controller.note_health])``."""
        with self._lock:
            scores = decision.scores or {}
            self._stragglers = {
                int(r): float(scores.get(r, 0.0)) for r in decision.degraded
            }

    def note_preemption(
        self, key: str, rank: Optional[int] = None,
        deadline: Optional[float] = None,
    ) -> None:
        with self._lock:
            self._notices.setdefault(
                key, Notice(key=key, rank=rank, noticed_at=self._now(),
                            deadline=deadline)
            )

    def note_rescind(self, key: str) -> None:
        with self._lock:
            if self._notices.pop(key, None) is not None:
                self._rescinds += 1

    def note_world_size(self, world: int) -> None:
        with self._lock:
            self._world_size = int(world)
            if self.target_world is None or world > self.target_world:
                self.target_world = int(world)

    # -- the view -----------------------------------------------------------

    def view(self) -> ControllerView:
        spares = self._spares_seen
        if self.spare_capacity_fn is not None:
            try:
                spares = int(self.spare_capacity_fn())
            except Exception:
                pass
        alerts: list = []
        if self.active_alerts_fn is not None:
            try:
                alerts = list(self.active_alerts_fn())
            except Exception:
                pass  # a watchtower bug must not take the controller down
        with self._lock:
            return ControllerView(
                now=self._now(),
                world_size=self._world_size,
                target_world=self.target_world or self._world_size,
                stragglers=dict(self._stragglers),
                spares=spares,
                notices=sorted(self._notices.values(), key=lambda n: n.noticed_at),
                step_s=self._step_ewma,
                steps_since_ckpt=self._steps_since_ckpt,
                active_alerts=alerts,
            )

    # -- decide -------------------------------------------------------------

    def _candidates(self, view: ControllerView) -> list[tuple[str, list, str]]:
        """(action, victims, reason) triples eligible under ``view`` — the
        cost model prices them; this is only feasibility."""
        out: list[tuple[str, list, str]] = []
        if view.stragglers:
            victims = sorted(view.stragglers)
            worst = min(view.stragglers.values())
            if view.spares > 0:
                out.append((
                    ACTION_SWAP, victims,
                    f"straggler(s) {victims} gate the job at score "
                    f"{worst:.2f}; {view.spares} warm spare(s) standing by",
                ))
            else:
                out.append((
                    ACTION_EXCLUDE, victims,
                    f"straggler(s) {victims} at score {worst:.2f} and no "
                    f"warm capacity; reshape around them",
                ))
        pages = view.page_alerts()
        if pages and not view.notices:
            rules = sorted({str(a.get("rule")) for a in pages})
            out.append((
                ACTION_CHECKPOINT, [],
                f"page alert(s) {rules} firing with "
                f"{view.steps_since_ckpt} unbanked step(s); bank progress "
                f"before the hang verdict lands",
            ))
        if view.notices:
            victims = sorted(
                n.rank for n in view.notices if n.rank is not None
            )
            keys = [n.key for n in view.notices]
            out.append((
                ACTION_CHECKPOINT, victims,
                f"preemption notice(s) {keys} pending with "
                f"{view.steps_since_ckpt} unbanked step(s)",
            ))
            ripe = [
                n for n in view.notices
                if (n.deadline is not None
                    and n.deadline - view.now <= self.shrink_lead_s)
                or (n.deadline is None
                    and view.now - n.noticed_at >= self.rescind_grace_s)
            ]
            if ripe and view.world_size > 1:
                out.append((
                    ACTION_SHRINK,
                    sorted(n.rank for n in ripe if n.rank is not None),
                    f"notice(s) {[n.key for n in ripe]} outlived the rescind "
                    f"window; shrink beats dying at the deadline",
                ))
        if (
            not view.notices
            and not view.stragglers
            and view.target_world
            and view.world_size
            and view.world_size < view.target_world
            and view.spares > 0
        ):
            out.append((
                ACTION_EXPAND, [],
                f"capacity returned ({view.spares} spare(s)); world "
                f"{view.world_size} below target {view.target_world}",
            ))
        return out

    def decide(self, view: Optional[ControllerView] = None) -> Optional[Decision]:
        """Price every feasible candidate, apply hysteresis, pick the best
        positive one. Returns None for no-op (no event — a healthy job's
        controller is silent)."""
        view = self.view() if view is None else view
        best: Optional[tuple[float, str, list, str]] = None
        for action, victims, reason in self._candidates(view):
            predicted = self.model.estimate(action, view)
            threshold = (
                self.hysteresis_s
                if action in (ACTION_SHRINK, ACTION_EXPAND) else 0.0
            )
            if predicted <= threshold:
                continue
            if (
                action in (ACTION_SHRINK, ACTION_EXPAND)
                and view.now - self._last_resize_ts < self.dwell_s
            ):
                continue  # hysteresis dwell: no resize flapping
            key = (action, tuple(victims))
            if view.now - self._last_decided.get(key, float("-inf")) \
                    < self.decision_cooldown_s:
                continue
            if best is None or predicted > best[0]:
                best = (predicted, action, victims, reason)
        if best is None:
            return None
        predicted, action, victims, reason = best
        with self._lock:
            d = Decision(
                decision_id=self._next_id, action=action,
                victims=list(victims),
                predicted_delta_s=round(predicted, 6), reason=reason,
                ts=view.now, mode=self.mode,
            )
            self._next_id += 1
            self._last_decided[(action, tuple(victims))] = view.now
        return d

    # -- act ----------------------------------------------------------------

    def _actuate(self, decision: Decision, view: ControllerView) -> str:
        if self.mode == MODE_ADVISE:
            return OUTCOME_ADVISED
        try:
            if decision.action in (ACTION_SWAP, ACTION_EXCLUDE,
                                   ACTION_CHECKPOINT):
                if self.remediation is None:
                    return OUTCOME_SKIPPED
                from tpu_resiliency_torch.telemetry import remediation as rem

                engine_action = {
                    ACTION_SWAP: rem.ACTION_SPARE_SWAP,
                    ACTION_EXCLUDE: rem.ACTION_EXCLUDE,
                    ACTION_CHECKPOINT: rem.ACTION_CHECKPOINT,
                }[decision.action]
                _, outcome = self.remediation.execute_action(
                    engine_action, decision.victims,
                    scores=view.stragglers or None,
                    reason=decision.reason,
                )
                if outcome == OUTCOME_OK and decision.action in (
                    ACTION_SWAP, ACTION_EXCLUDE,
                ):
                    # Optimistically clear the handled victims: a stale
                    # straggler view must not cascade swap→exclude for the
                    # same ranks before the policy re-scores the new round
                    # (the next degraded_set event re-establishes the truth).
                    with self._lock:
                        for r in decision.victims:
                            self._stragglers.pop(r, None)
                return outcome
            if decision.action == ACTION_SHRINK:
                if self.shrink_fn is None:
                    return OUTCOME_SKIPPED
                self.shrink_fn(decision.victims, decision.reason)
                with self._lock:
                    self._last_resize_ts = view.now
                    # The reclaimed ranks' notices are consumed by the shrink.
                    for n in list(self._notices.values()):
                        if n.rank in decision.victims or not decision.victims:
                            self._notices.pop(n.key, None)
                return OUTCOME_OK
            if decision.action == ACTION_EXPAND:
                if self.expand_fn is None:
                    return OUTCOME_SKIPPED
                self.expand_fn(decision.reason)
                with self._lock:
                    self._last_resize_ts = view.now
                return OUTCOME_OK
        except Exception as e:
            log.warning(f"autoscale actuation {decision.action} failed: {e!r}")
            return OUTCOME_FAILED
        return OUTCOME_SKIPPED

    # -- the loop -----------------------------------------------------------

    def tick(self) -> Optional[Decision]:
        """One decide→act→audit pass plus outcome settlement. The scenario
        and the launcher thread both drive exactly this."""
        self._settle_outcomes()
        view = self.view()
        decision = self.decide(view)
        if decision is None:
            return None
        decision.outcome = self._actuate(decision, view)
        if decision.action == ACTION_CHECKPOINT and decision.outcome == OUTCOME_OK:
            with self._lock:
                self._steps_since_ckpt = 0
        with self._lock:
            decision._train_at = self._train_s  # type: ignore[attr-defined]
            decision._wall_at = (self._wall1 or view.now)  # type: ignore[attr-defined]
            decision._wall0 = (self._wall0 or view.now)  # type: ignore[attr-defined]
            self.decisions.append(decision)
        record_event(
            "autoscale", "autoscale_decision",
            decision_id=decision.decision_id, action=decision.action,
            victims=decision.victims, mode=self.mode,
            outcome=decision.outcome,
            predicted_delta_s=decision.predicted_delta_s,
            reason=decision.reason, world_size=view.world_size,
            spares=view.spares,
        )
        log.info(
            f"autoscale [{self.mode}] #{decision.decision_id} "
            f"{decision.action}{decision.victims or ''}: predicted "
            f"{decision.predicted_delta_s:+.3f}s — {decision.reason} "
            f"({decision.outcome})"
        )
        return decision

    def _settle_outcomes(self, force: bool = False) -> None:
        """Score every decision whose measurement window closed: realized =
        training seconds gained versus the decision-time trend, paired with
        the prediction in one ``autoscale_outcome`` event and folded into the
        cost model's correction."""
        with self._lock:
            now = self._wall1 if self._wall1 is not None else self._now()
            pending = [
                d for d in self.decisions
                if not d.settled
                and (force or now - d.ts >= self.outcome_window_s)
            ]
            train_now, wall_now = self._train_s, (self._wall1 or now)
        for d in pending:
            train_at = getattr(d, "_train_at", 0.0)
            wall_at = getattr(d, "_wall_at", d.ts)
            wall0 = getattr(d, "_wall0", d.ts)
            window = max(1e-9, wall_now - wall_at)
            span = max(1e-9, wall_at - wall0)
            ratio_at = min(1.0, train_at / span) if span > 1e-9 else 1.0
            realized = (train_now - train_at) - ratio_at * window
            d.realized_delta_s = round(realized, 6)
            d.settled = True
            self.model.note_outcome(
                d.action, d.predicted_delta_s, d.realized_delta_s
            )
            record_event(
                "autoscale", "autoscale_outcome",
                decision_id=d.decision_id, action=d.action,
                outcome=d.outcome,
                predicted_delta_s=d.predicted_delta_s,
                realized_delta_s=d.realized_delta_s,
                forecast_error_s=round(
                    d.realized_delta_s - d.predicted_delta_s, 6
                ),
                window_s=round(window, 6),
            )

    def finalize(self) -> None:
        """Settle every still-pending decision with the data observed so far
        — a short advise run still pairs each decision with a realized
        delta before its stream ends."""
        self._settle_outcomes(force=True)

    # -- the /autoscale document --------------------------------------------

    def _alerts_snapshot(self) -> list:
        """Compact {rule, severity} rows from the wired watchtower, for the
        ``/autoscale`` document (empty when none is wired or it misbehaves)."""
        if self.active_alerts_fn is None:
            return []
        try:
            return [
                {"rule": a.get("rule"), "severity": a.get("severity")}
                for a in self.active_alerts_fn()
                if isinstance(a, dict)
            ]
        except Exception:
            return []

    def status(self) -> dict:
        with self._lock:
            decisions = [
                {
                    "decision_id": d.decision_id, "ts": d.ts,
                    "action": d.action, "victims": d.victims,
                    "mode": d.mode, "outcome": d.outcome,
                    "predicted_delta_s": d.predicted_delta_s,
                    "realized_delta_s": d.realized_delta_s,
                    "reason": d.reason,
                }
                for d in self.decisions[-50:]
            ]
            notices = [
                {"key": n.key, "rank": n.rank, "noticed_at": n.noticed_at,
                 "deadline": n.deadline}
                for n in self._notices.values()
            ]
            settled = [d for d in self.decisions if d.settled]
            return {
                "schema": SCHEMA,
                "mode": self.mode,
                "world_size": self._world_size,
                "target_world": self.target_world,
                "stragglers": {str(r): s for r, s in self._stragglers.items()},
                "active_alerts": self._alerts_snapshot(),
                "pending_notices": notices,
                "rescinds": self._rescinds,
                "decisions_total": len(self.decisions),
                "decisions": decisions,
                "forecast": {
                    "settled": len(settled),
                    "mean_abs_error_s": round(
                        sum(
                            abs((d.realized_delta_s or 0.0)
                                - d.predicted_delta_s)
                            for d in settled
                        ) / len(settled), 6
                    ) if settled else None,
                },
                "cost_model": self.model.constants(),
            }

    # -- launcher thread + events tail --------------------------------------

    def start(self) -> None:
        """Launcher mode: tail the shared events file and tick on an
        interval, on a daemon thread. A controller bug degrades to advise-by-
        silence, never to a launcher crash."""
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="autoscale", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        try:
            self.finalize()
        except Exception:
            log.debug("autoscale finalize failed", exc_info=True)

    def poll(self) -> Optional[Decision]:
        """One tail+tick pass (what the thread loops over)."""
        for rec in self._read_new_events():
            self.observe(rec)
        return self.tick()

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.poll()
            except Exception:
                log.exception("autoscale tick failed; loop continues")

    def _read_new_events(self) -> list[dict]:
        """Incremental tail of the shared events JSONL (same torn-tail
        discipline as the telemetry server: only complete lines advance the
        offset)."""
        if not self.events_file:
            return []
        out: list[dict] = []
        try:
            with open(self.events_file, "rb") as f:
                f.seek(self._offset)
                chunk = f.read()
        except OSError:
            return []
        if not chunk:
            return []
        end = chunk.rfind(b"\n")
        if end < 0:
            return []
        self._offset += end + 1
        for line in chunk[: end + 1].splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except (json.JSONDecodeError, UnicodeDecodeError):
                continue
            if isinstance(rec, dict):
                out.append(rec)
        return out
