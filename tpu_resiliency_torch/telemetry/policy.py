"""Health-vector policy: turn telemetry scores into restart/replication decisions.

A copy of ``tpu_resiliency/telemetry/policy.py`` on the port's ``Report`` and
``scoring``. The couplings named below (``RestartCoordinator``, ``DemoteDegraded``,
``ExchangePlan``, the monitor client) are the JAX package's until their slices are
ported; the sinks reach them duck-typed.

BASELINE target 5 names "local-ckpt replication driven by on-device health vector";
the reference's closest coupling is the straggler callback setting
``trainer.should_stop`` (``ptl_resiliency/straggler_det_callback.py:91-98``). This
module closes the loop tighter, without killing anything that still works:

- a :class:`HealthVectorPolicy` watches successive reports and promotes ranks flagged
  ``patience`` consecutive rounds into a *degraded* set (with hysteresis: one clean
  round clears the streak, ``recovery`` clean rounds clears degraded status);
- the degraded set is published to the restart coordinator, where rank reassignment
  (``inprocess/rank_assignment.DemoteDegraded``) turns degraded-but-alive ranks into
  INACTIVE spares on the next restart round — the job sheds a slow rank without
  waiting for it to die;
- checkpoint retrieval avoids degraded holders (``ExchangePlan.build(avoid=...)``) so
  recovery never waits on the slowest disk/NIC in the clique when a healthy mirror
  exists;
- optionally, a rank that sees *itself* degraded asks the launcher to exclude its
  node (``WorkloadControlRequest(ExcludeThisNode)`` — the reference's workload-ctrl
  path, ``_ft_rendezvous.py:785-804``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from tpu_resiliency_torch.telemetry import scoring
from tpu_resiliency_torch.telemetry.reporting import Report
from tpu_resiliency_torch.utils.events import record as record_event
from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class HealthDecision:
    """Outcome of one policy observation."""

    degraded: frozenset[int]  # ranks currently held degraded
    newly_degraded: frozenset[int]  # transitions this round
    recovered: frozenset[int]  # ranks cleared this round
    flagged: frozenset[int]  # raw flags this round (pre-hysteresis)
    #: the per-rank perf scores behind this decision — carried so downstream
    #: consumers (``remediation.py`` spans, incident artifacts) can show WHY a
    #: rank was demoted without re-reading the report
    scores: Optional[dict[int, float]] = None

    @property
    def changed(self) -> bool:
        return bool(self.newly_degraded or self.recovered)


class HealthVectorPolicy:
    """Streak-based promotion of per-round straggler flags into decisions.

    ``patience``: consecutive flagged reports before a rank is degraded (a single
    noisy round must not demote anyone). ``recovery``: consecutive clean reports
    before a degraded rank is reinstated. Sinks receive the :class:`HealthDecision`
    whenever the degraded set changes.
    """

    def __init__(
        self,
        *,
        patience: int = 2,
        recovery: int = 3,
        perf_threshold: float = scoring.DEFAULT_THRESHOLD,
        z_threshold: float = scoring.DEFAULT_Z_THRESHOLD,
        sinks: Optional[list[Callable[[HealthDecision], None]]] = None,
    ):
        if patience < 1 or recovery < 1:
            raise ValueError("patience and recovery must be >= 1")
        self.patience = patience
        self.recovery = recovery
        self.perf_threshold = perf_threshold
        self.z_threshold = z_threshold
        self.sinks = list(sinks or [])
        self._flag_streak: dict[int, int] = {}
        self._clean_streak: dict[int, int] = {}
        self._degraded: set[int] = set()
        #: the most recent decision (changed or not) — embedders that poll
        #: instead of sinking (the autoscale controller's view assembly, the
        #: /autoscale document) read the current verdict here
        self.last_decision: Optional[HealthDecision] = None

    @property
    def degraded(self) -> frozenset[int]:
        return frozenset(self._degraded)

    def observe(self, report: Report) -> HealthDecision:
        stragglers = report.identify_stragglers(
            perf_threshold=self.perf_threshold,
            section_threshold=self.perf_threshold,
            z_threshold=self.z_threshold,
        )
        flagged = {sid.rank for sid in stragglers.by_perf}
        known = set(report.perf_scores or {})
        newly, recovered = set(), set()
        for r in known:
            if r in flagged:
                self._flag_streak[r] = self._flag_streak.get(r, 0) + 1
                self._clean_streak[r] = 0
                if r not in self._degraded and self._flag_streak[r] >= self.patience:
                    self._degraded.add(r)
                    newly.add(r)
            else:
                self._flag_streak[r] = 0
                self._clean_streak[r] = self._clean_streak.get(r, 0) + 1
                if r in self._degraded and self._clean_streak[r] >= self.recovery:
                    self._degraded.discard(r)
                    recovered.add(r)
        decision = HealthDecision(
            degraded=frozenset(self._degraded),
            newly_degraded=frozenset(newly),
            recovered=frozenset(recovered),
            flagged=frozenset(flagged),
            scores={r: float(s) for r, s in (report.perf_scores or {}).items()},
        )
        self.last_decision = decision
        if decision.changed:
            record_event(
                "telemetry", "degraded_set",
                degraded=sorted(decision.degraded),
                newly=sorted(decision.newly_degraded),
                recovered=sorted(decision.recovered),
                scores={
                    str(r): round(float(s), 4)
                    for r, s in (report.perf_scores or {}).items()
                },
            )
            log.warning(
                f"health vector: degraded={sorted(decision.degraded)} "
                f"(+{sorted(newly)} -{sorted(recovered)})"
            )
            for sink in self.sinks:
                try:
                    sink(decision)
                except Exception:
                    log.exception("health-policy sink failed")
        return decision

    def note_restart(self) -> None:
        """A restart round happened: in-flight streak evidence is void.

        Ranks were reassigned, respawned, or benched — a pre-restart clean
        streak must not count toward reinstating a degraded rank (the respawned
        incarnation has proven nothing yet), and a pre-restart flag streak must
        not demote a rank on its first post-restart wobble. Degraded *status*
        persists: hysteresis restarts, the verdict does not."""
        self._flag_streak.clear()
        self._clean_streak.clear()
        if self._degraded:
            record_event(
                "telemetry", "degraded_set",
                degraded=sorted(self._degraded), newly=[], recovered=[],
                reason="restart: streaks reset, degraded set carried",
            )


# -- stock sinks -----------------------------------------------------------


def coordinator_sink(coord) -> Callable[[HealthDecision], None]:
    """Publish the degraded set to a restart coordinator
    (the JAX package's ``inprocess.coordination.RestartCoordinator``), where
    ``DemoteDegraded`` rank assignment picks it up on the next restart round."""

    def sink(decision: HealthDecision) -> None:
        coord.set_degraded(decision.degraded)

    return sink


def exclude_self_sink(monitor_client, rank: int) -> Callable[[HealthDecision], None]:
    """When *this* rank is degraded, request node exclusion from the launcher
    (reference ``WorkloadAction.ExcludeThisNode``)."""
    from tpu_resiliency_torch.watchdog.data import WorkloadAction

    def sink(decision: HealthDecision) -> None:
        if rank in decision.newly_degraded:
            monitor_client.send_workload_control_request(
                WorkloadAction.ExcludeThisNode,
                reason=f"rank {rank} degraded by health-vector policy",
            )

    return sink
