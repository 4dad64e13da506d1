"""Audited telemetry→action loop: turn health decisions into remediations.

ROADMAP item 5: the telemetry plane detects stragglers (``policy.py`` emits
:class:`~tpu_resiliency_torch.telemetry.policy.HealthDecision`\\ s) and the launcher
holds warm spares (``launcher/park.py``), but until now nothing connected them —
detection ended at a report. The :class:`RemediationEngine` is the connector,
built on one rule: **no automated action without an audit trail**. Every
remediation runs inside ``remediation.decide`` / ``remediation.<action>`` spans
carrying the triggering scores, and emits a ``remediation_action`` event
(→ ``tpu_remediation_actions_total{action,outcome}``) whatever the outcome, so
an operator can replay exactly what the system did and why — the incident
engine (``launcher/incident.py``) folds these records into its causal chain.

The decision matrix (see ``docs/incidents.md``):

1. **proactive checkpoint** — always first when a ``checkpoint_fn`` is wired:
   a degrading rank may die outright next, so bank the progress while every
   rank is still alive (ride the async checkpointer; the call must be cheap).
2. **spare swap** — when ``spare_capacity_fn`` reports warm capacity, demote
   the degraded ranks (publish to the restart coordinator, where
   ``DemoteDegraded`` benches them next round) and request an in-job restart:
   the launcher's warm-spare pool absorbs the respawn cost, so the swap is the
   cheap path (reference NVRx never gets past ``trainer.should_stop``).
3. **exclude and continue** — no spare capacity: publish the degraded set so
   rank assignment reshapes around the slow ranks, and (when a
   ``monitor_client`` is wired and *this* rank is the degraded one) ask the
   launcher to exclude the node entirely (``WorkloadAction.ExcludeThisNode``).

Recoveries are audited too: a decision whose ``recovered`` set is non-empty
emits ``remediation_action{action=reinstate}`` so the end of an incident is as
visible as its start.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from tpu_resiliency_torch.telemetry.policy import HealthDecision
from tpu_resiliency_torch.utils.events import record as record_event
from tpu_resiliency_torch.utils.logging import get_logger
from tpu_resiliency_torch.utils.tracing import span

log = get_logger(__name__)

#: action names (the ``action`` label of ``tpu_remediation_actions_total``)
ACTION_CHECKPOINT = "checkpoint"
ACTION_SPARE_SWAP = "spare_swap"
ACTION_EXCLUDE = "exclude"
ACTION_REINSTATE = "reinstate"

OUTCOME_OK = "ok"
OUTCOME_FAILED = "failed"
OUTCOME_SKIPPED = "skipped"


class RemediationEngine:
    """A :class:`HealthVectorPolicy` sink that drives real actions.

    Wire it as ``HealthVectorPolicy(sinks=[engine])``; it consumes every
    decision whose degraded set changed. All actuators are optional callables —
    the engine degrades to exclude-and-continue (the always-available action:
    publishing the degraded set costs only a store write) when the richer
    paths aren't wired:

    - ``checkpoint_fn()``: trigger a proactive checkpoint (e.g. a closure over
      ``LocalCheckpointManager.save(..., is_async=True)``).
    - ``spare_capacity_fn() -> int``: warm spares available for a swap.
    - ``publish_degraded_fn(frozenset[int])``: hand the degraded set to the
      restart coordinator (``RestartCoordinator.set_degraded``).
    - ``request_restart_fn(reason)``: trigger the in-job restart round that
      actually performs the swap (``StoreRendezvous.request_restart`` or the
      in-process coordinator's interruption record).
    - ``monitor_client``: a :class:`~tpu_resiliency_torch.watchdog.monitor_client.
      RankMonitorClient` used for node exclusion when *this* rank degrades.

    ``cooldown`` (seconds) bounds actuation frequency: a decision landing
    inside the cooldown window is still audited, with ``outcome=skipped`` —
    remediation must not thrash the job faster than it can recover. The
    window is evaluated once per decision (a plan is one remediation), so a
    proactive checkpoint never cools down the swap/exclude in its own plan.
    """

    def __init__(
        self,
        *,
        checkpoint_fn: Optional[Callable[[], object]] = None,
        spare_capacity_fn: Optional[Callable[[], int]] = None,
        publish_degraded_fn: Optional[Callable[[frozenset], None]] = None,
        request_restart_fn: Optional[Callable[[str], None]] = None,
        monitor_client=None,
        self_rank: Optional[int] = None,
        cooldown: float = 0.0,
        dry_run: bool = False,
    ):
        self.checkpoint_fn = checkpoint_fn
        self.spare_capacity_fn = spare_capacity_fn
        self.publish_degraded_fn = publish_degraded_fn
        self.request_restart_fn = request_restart_fn
        self.monitor_client = monitor_client
        self.self_rank = self_rank
        self.cooldown = cooldown
        self.dry_run = dry_run
        self._last_action_ts: float = float("-inf")
        #: audit trail of (action, outcome) pairs, newest last (tests/operators)
        self.history: list[tuple[str, str]] = []

    # -- the sink entry point ----------------------------------------------

    def __call__(self, decision: HealthDecision) -> None:
        try:
            self.remediate(decision)
        except Exception:
            # An actuator bug must never take down the telemetry loop.
            log.exception("remediation failed; detection loop continues")

    # -- core ---------------------------------------------------------------

    def remediate(self, decision: HealthDecision) -> list[tuple[str, str]]:
        """Run the decision matrix for one changed decision. Returns the
        ``(action, outcome)`` pairs taken (also appended to ``history``)."""
        taken: list[tuple[str, str]] = []
        if decision.recovered and not decision.newly_degraded:
            taken.append(self._reinstate(decision))
            self.history.extend(taken)
            return taken
        if not decision.newly_degraded:
            return taken
        scores = {
            str(r): round(float(s), 4)
            for r, s in (decision.scores or {}).items()
        }
        with span(
            "remediation", "remediation.decide",
            degraded=sorted(decision.degraded),
            newly=sorted(decision.newly_degraded),
            scores=scores,
        ):
            plan = self._plan(decision)
            record_event(
                "remediation", "remediation_decision",
                plan=[a for a, _ in plan],
                degraded=sorted(decision.degraded),
                newly=sorted(decision.newly_degraded),
            )
        # Cooldown is evaluated once per decision, not per action: a plan is
        # one remediation (checkpoint → swap/exclude), and stamping after the
        # first step would suppress the rest of its own plan.
        in_cooldown = (
            time.monotonic() - self._last_action_ts
        ) < self.cooldown
        for action, runner in plan:
            taken.append(
                self._execute(action, runner, decision, in_cooldown=in_cooldown)
            )
        if any(outcome == OUTCOME_OK for _, outcome in taken):
            self._last_action_ts = time.monotonic()
        self.history.extend(taken)
        return taken

    def _plan(self, decision: HealthDecision) -> list[tuple[str, Callable]]:
        """The decision matrix, resolved against the wired actuators."""
        plan: list[tuple[str, Callable]] = []
        if self.checkpoint_fn is not None:
            plan.append((ACTION_CHECKPOINT, self._do_checkpoint))
        spares = 0
        if self.spare_capacity_fn is not None:
            try:
                spares = int(self.spare_capacity_fn())
            except Exception:
                spares = 0
        if spares > 0 and self.request_restart_fn is not None:
            plan.append((ACTION_SPARE_SWAP, self._do_spare_swap))
        else:
            plan.append((ACTION_EXCLUDE, self._do_exclude))
        return plan

    def _execute(
        self,
        action: str,
        runner: Callable,
        decision: HealthDecision,
        in_cooldown: bool = False,
        reason: str = "",
    ) -> tuple[str, str]:
        ranks = sorted(decision.newly_degraded)
        why = {"reason": reason} if reason else {}
        if self.dry_run or in_cooldown:
            outcome = OUTCOME_SKIPPED
            detail = "dry_run" if self.dry_run else "cooldown"
            record_event(
                "remediation", "remediation_action", action=action,
                outcome=outcome, ranks=ranks, detail=detail, **why,
            )
            return action, outcome
        with span(
            "remediation", f"remediation.{action}", ranks=ranks,
            degraded=sorted(decision.degraded),
            scores={
                str(r): round(float((decision.scores or {}).get(r, float("nan"))), 4)
                for r in ranks
            },
        ):
            try:
                runner(decision)
                outcome, detail = OUTCOME_OK, ""
            except Exception as e:
                outcome, detail = OUTCOME_FAILED, repr(e)
                log.warning(f"remediation {action} failed: {e!r}")
            record_event(
                "remediation", "remediation_action", action=action,
                outcome=outcome, ranks=ranks,
                **({"detail": detail} if detail else {}), **why,
            )
        return action, outcome

    # -- external drive (the autoscale controller's path) --------------------

    def execute_action(
        self,
        action: str,
        ranks,
        scores: Optional[dict] = None,
        reason: str = "",
    ) -> tuple[str, str]:
        """Run ONE actuator outside a policy-driven plan, with the same
        cooldown/dry-run audit semantics (``launcher/autoscale.py`` routes
        its swap/exclude/checkpoint decisions through here so policy-driven
        and controller-driven remediations share one audit trail). Returns
        the ``(action, outcome)`` pair, also appended to ``history``."""
        runners = {
            ACTION_CHECKPOINT: self._do_checkpoint,
            ACTION_SPARE_SWAP: self._do_spare_swap,
            ACTION_EXCLUDE: self._do_exclude,
        }
        if action not in runners:
            raise ValueError(f"unknown remediation action {action!r}")
        ranks = frozenset(int(r) for r in ranks)
        decision = HealthDecision(
            degraded=ranks, newly_degraded=ranks, recovered=frozenset(),
            flagged=ranks,
            scores={int(r): float(s) for r, s in (scores or {}).items()},
        )
        in_cooldown = (
            time.monotonic() - self._last_action_ts
        ) < self.cooldown
        result = self._execute(
            action, runners[action], decision, in_cooldown=in_cooldown,
            reason=reason,
        )
        if result[1] == OUTCOME_OK:
            self._last_action_ts = time.monotonic()
        self.history.append(result)
        return result

    # -- actuators ----------------------------------------------------------

    def _do_checkpoint(self, decision: HealthDecision) -> None:
        self.checkpoint_fn()

    def _do_spare_swap(self, decision: HealthDecision) -> None:
        if self.publish_degraded_fn is not None:
            self.publish_degraded_fn(decision.degraded)
        self.request_restart_fn(
            f"remediation: swap degraded ranks {sorted(decision.newly_degraded)} "
            f"onto warm spares"
        )

    def _do_exclude(self, decision: HealthDecision) -> None:
        if self.publish_degraded_fn is not None:
            self.publish_degraded_fn(decision.degraded)
        if (
            self.monitor_client is not None
            and self.self_rank is not None
            and self.self_rank in decision.newly_degraded
        ):
            from tpu_resiliency_torch.watchdog.data import WorkloadAction

            self.monitor_client.send_workload_control_request(
                WorkloadAction.ExcludeThisNode,
                reason=(
                    f"rank {self.self_rank} degraded; remediation engine "
                    f"excluding this node"
                ),
            )
        elif self.publish_degraded_fn is None:
            raise RuntimeError(
                "exclude: no actuator wired (need publish_degraded_fn or "
                "monitor_client for a self-degraded rank)"
            )

    def _reinstate(self, decision: HealthDecision) -> tuple[str, str]:
        ranks = sorted(decision.recovered)
        try:
            if self.publish_degraded_fn is not None:
                self.publish_degraded_fn(decision.degraded)
            outcome = OUTCOME_OK
        except Exception as e:
            outcome = OUTCOME_FAILED
            log.warning(f"reinstate publish failed: {e!r}")
        record_event(
            "remediation", "remediation_action", action=ACTION_REINSTATE,
            outcome=outcome, ranks=ranks,
        )
        return ACTION_REINSTATE, outcome
