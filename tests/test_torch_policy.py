"""The health-vector policy of both packages: ``tests/telemetry/test_policy.py``'s
scenarios run against ``tpu_resiliency.telemetry.policy`` and the port's copy,
``tpu_resiliency_torch.telemetry.policy`` (on the port's ``Report``), and a seeded
sequence of reports must give both the same decisions, round by round.

The restart coordinator behind ``coordinator_sink`` is the JAX package's (the sink
is duck-typed; the port has no coordinator yet).
"""

import dataclasses
import types

import numpy as np
import pytest

import tpu_resiliency.telemetry.policy as ref_policy
import tpu_resiliency.telemetry.reporting as ref_reporting
import tpu_resiliency.utils.events as ref_events
import tpu_resiliency.watchdog.data as ref_data
import tpu_resiliency_torch.telemetry.policy as port_policy
import tpu_resiliency_torch.telemetry.reporting as port_reporting
import tpu_resiliency_torch.utils.events as port_events
import tpu_resiliency_torch.watchdog.data as port_data

PACKAGES = {
    "jax": types.SimpleNamespace(policy=ref_policy, Report=ref_reporting.Report,
                                 events=ref_events, WorkloadAction=ref_data.WorkloadAction),
    "torch": types.SimpleNamespace(policy=port_policy, Report=port_reporting.Report,
                                   events=port_events, WorkloadAction=port_data.WorkloadAction),
}

HEALTHY = {0: 1.0, 1: 0.98, 2: 0.99, 3: 1.0}
SLOW2 = {0: 1.0, 1: 0.98, 2: 0.4, 3: 1.0}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def make_report(pkg, perf, z=None):
    return pkg.Report(
        rank=0, world_size=len(perf), iteration=0, section_names=("step",),
        relative_section_scores={"step": perf[0]}, individual_section_scores={"step": 1.0},
        perf_scores=dict(perf), z_scores=dict(z or {r: 0.0 for r in perf}),
        ewma_scores=dict(perf),
    )


def test_patience_before_degraded(pkg):
    p = pkg.policy.HealthVectorPolicy(patience=2, recovery=2)
    d1 = p.observe(make_report(pkg, SLOW2))
    assert d1.flagged == {2} and d1.degraded == frozenset()
    d2 = p.observe(make_report(pkg, SLOW2))
    assert d2.newly_degraded == {2} and p.degraded == {2}


def test_single_noisy_round_does_not_degrade(pkg):
    p = pkg.policy.HealthVectorPolicy(patience=2, recovery=2)
    p.observe(make_report(pkg, SLOW2))
    assert p.observe(make_report(pkg, HEALTHY)).degraded == frozenset()
    p.observe(make_report(pkg, SLOW2))
    assert p.degraded == frozenset()


def test_recovery_hysteresis(pkg):
    p = pkg.policy.HealthVectorPolicy(patience=1, recovery=3)
    p.observe(make_report(pkg, SLOW2))
    p.observe(make_report(pkg, HEALTHY))
    p.observe(make_report(pkg, HEALTHY))
    assert p.degraded == {2}
    d = p.observe(make_report(pkg, HEALTHY))
    assert d.recovered == {2} and p.degraded == frozenset()


def test_sink_called_on_change_only(pkg):
    seen = []
    p = pkg.policy.HealthVectorPolicy(patience=1, recovery=1, sinks=[seen.append])
    for perf in (SLOW2, SLOW2, HEALTHY):
        p.observe(make_report(pkg, perf))
    assert [d.newly_degraded for d in seen] == [{2}, frozenset()]
    assert seen[1].recovered == {2}


def test_a_failing_sink_never_breaks_the_policy(pkg):
    def boom(decision):
        raise RuntimeError("sink down")

    seen = []
    p = pkg.policy.HealthVectorPolicy(patience=1, recovery=1, sinks=[boom, seen.append])
    assert p.observe(make_report(pkg, SLOW2)).newly_degraded == {2}
    assert len(seen) == 1


def test_coordinator_sink_publishes(pkg, coord_store):
    from tpu_resiliency.inprocess.coordination import RestartCoordinator

    coord = RestartCoordinator(coord_store, world_size=4)
    p = pkg.policy.HealthVectorPolicy(patience=1, recovery=1,
                                      sinks=[pkg.policy.coordinator_sink(coord)])
    p.observe(make_report(pkg, SLOW2))
    assert coord.degraded_ranks() == {2}
    p.observe(make_report(pkg, HEALTHY))
    assert coord.degraded_ranks() == frozenset()


def test_validation(pkg):
    with pytest.raises(ValueError):
        pkg.policy.HealthVectorPolicy(patience=0)
    with pytest.raises(ValueError):
        pkg.policy.HealthVectorPolicy(recovery=0)


def test_streaks_do_not_survive_a_restart_round(pkg):
    p = pkg.policy.HealthVectorPolicy(patience=1, recovery=3)
    p.observe(make_report(pkg, SLOW2))
    p.observe(make_report(pkg, HEALTHY))
    p.observe(make_report(pkg, HEALTHY))
    p.note_restart()
    p.observe(make_report(pkg, HEALTHY))
    assert p.degraded == {2}, "pre-restart clean streak wrongly carried"
    p.observe(make_report(pkg, HEALTHY))
    p.observe(make_report(pkg, HEALTHY))
    assert p.degraded == frozenset()
    q = pkg.policy.HealthVectorPolicy(patience=2, recovery=1)
    q.observe(make_report(pkg, SLOW2))
    q.note_restart()
    assert q.observe(make_report(pkg, SLOW2)).degraded == frozenset()
    assert q.observe(make_report(pkg, SLOW2)).newly_degraded == {2}


def test_simultaneous_degrade_and_recover(pkg):
    p = pkg.policy.HealthVectorPolicy(patience=1, recovery=1)
    p.observe(make_report(pkg, SLOW2))
    d = p.observe(make_report(pkg, {0: 1.0, 1: 0.4, 2: 1.0, 3: 1.0}))
    assert (d.newly_degraded, d.recovered, d.degraded, d.changed) == ({1}, {2}, {1}, True)


def test_every_transition_emits_its_event(pkg):
    seen = []
    pkg.events.add_sink(seen.append)
    try:
        p = pkg.policy.HealthVectorPolicy(patience=1, recovery=1)
        for perf in (SLOW2, SLOW2, HEALTHY, HEALTHY):
            p.observe(make_report(pkg, perf))
        p.note_restart()
    finally:
        pkg.events.remove_sink(seen.append)
    transitions = [e for e in seen if e.kind == "degraded_set"]
    assert [t.payload["newly"] for t in transitions] == [[2], []]
    assert transitions[1].payload["recovered"] == [2]
    assert transitions[0].payload["scores"]["2"] == pytest.approx(0.4)
    assert all(e.source == "telemetry" for e in transitions)


def test_exclude_self_sink_fires_only_on_own_demotion(pkg):
    class FakeClient:
        def __init__(self):
            self.sent = []

        def send_workload_control_request(self, action, reason=""):
            self.sent.append((action, reason))

    client = FakeClient()
    p = pkg.policy.HealthVectorPolicy(
        patience=1, recovery=1, sinks=[pkg.policy.exclude_self_sink(client, rank=2)])
    p.observe(make_report(pkg, SLOW2))
    assert len(client.sent) == 1 and client.sent[0][0] is pkg.WorkloadAction.ExcludeThisNode
    p.observe(make_report(pkg, HEALTHY))
    assert len(client.sent) == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_both_packages_decide_alike_on_seeded_reports(seed):
    rng = np.random.default_rng(seed)
    policies = {name: p.policy.HealthVectorPolicy(patience=2, recovery=2)
                for name, p in PACKAGES.items()}
    for round_ in range(30):
        perf = {r: float(rng.choice([1.0, 0.97, 0.6, 0.3], p=[0.5, 0.3, 0.1, 0.1]))
                for r in range(6)}
        z = {r: float(rng.normal(0.0, 2.0)) for r in range(6)}
        if round_ == 15:
            for p in policies.values():
                p.note_restart()
        decisions = [policies[n].observe(make_report(PACKAGES[n], perf, z)) for n in policies]
        assert dataclasses.asdict(decisions[0]) == dataclasses.asdict(decisions[1])
