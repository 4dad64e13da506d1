"""Both packages' observability planes on one stream: the same seeded event records (a
numpy seed and a fake clock: two ranks stepping, a slow stretch, checkpoints, a goodput
burn, a degraded rank and its recovery, a preemption notice and its rescind, a failed
worker and a promoted spare) go through the JAX package's and the port's

- ``GoodputLedger`` (the attribution),
- ``aggregate`` (the registry's snapshot),
- the watchtower's replay (the alert transitions and the rule states),
- ``AutoscaleController`` in advise mode on the stream's clock (its decisions and their
  realized deltas) and ``CostModel.estimate`` of every action under one view,
- ``IncidentEngine`` in auto mode on the stream's clock (each artifact's chain and SLO
  timings),

and their outputs must be equal: counts, names and actions exactly, float seconds to
1e-9 relative.
"""

import math

import numpy as np
import pytest

import tpu_resiliency.launcher.autoscale as ref_autoscale
import tpu_resiliency.launcher.incident as ref_incident
import tpu_resiliency.telemetry.watchtower as ref_watchtower
import tpu_resiliency.utils.goodput as ref_goodput
import tpu_resiliency.utils.metrics as ref_metrics
import tpu_resiliency_torch.launcher.autoscale as port_autoscale
import tpu_resiliency_torch.launcher.incident as port_incident
import tpu_resiliency_torch.telemetry.watchtower as port_watchtower
import tpu_resiliency_torch.utils.goodput as port_goodput
import tpu_resiliency_torch.utils.metrics as port_metrics

PACKAGES = {
    "ref": (ref_goodput, ref_metrics, ref_watchtower, ref_autoscale, ref_incident),
    "port": (port_goodput, port_metrics, port_watchtower, port_autoscale, port_incident),
}
RTOL = 1e-9
T0 = 1_700_000_000.0  # the fake clock's start
STEPS = 300


def stream(seed: int = 0) -> list[dict]:
    """The seeded event records, in time order."""
    rng = np.random.default_rng(seed)
    recs = []

    def rec(ts, kind, pid, rank, source="worker", **payload):
        recs.append({"ts": float(ts), "source": source, "kind": kind, "pid": pid,
                     "rank": rank, **payload})

    rec(T0, "rendezvous_round", 900, None, source="launcher", round=0, world_size=2,
        active=["n0"], seconds=0.25)
    rec(T0 + 0.01, "warm_spare_pool", 900, None, source="launcher", warm=1, size=1)
    pids = {0: 1000, 1: 1001}
    t = {0: T0 + 1.0, 1: T0 + 1.0 + rng.uniform(0, 0.01)}
    start = {0: 0, 1: 0}
    for i in range(STEPS):
        ratio = 0.96 if i < 100 or i >= 220 else 0.55
        for r in (0, 1):
            dt = 0.5 * (1.0 + 0.05 * rng.standard_normal())
            if 120 <= i < 126:
                dt *= 4.0  # a slow stretch: the step-anomaly rule's evidence
            if r == 1 and 150 <= i < 230:
                dt *= 1.6  # rank 1 straggles
            t[r] += dt
            if r == 1 and i == 260:
                # rank 1's worker dies; a spare is promoted and resumes from 250
                rec(t[r], "worker_failed", 900, None, source="launcher", round=0,
                    global_rank=1, exitcode=1, detail="rank 1 exited 1")
                rec(t[r] + 0.001, "failure_detected", 900, None, source="launcher", round=0)
                rec(t[r] + 0.002, "restart_requested", 900, None, source="launcher",
                    round=0, reason="worker failed")
                t[r] += 3.0 + rng.uniform(0, 0.5)
                rec(t[r], "rendezvous_round", 900, None, source="launcher", round=1,
                    world_size=2, active=["n0"], seconds=0.3)
                rec(t[r] + 0.01, "worker_promoted", 900, None, source="launcher", round=1,
                    outcome="promoted", local_rank=1, seconds=0.05)
                pids[1], start[1] = 1002, i - 10
                t[r] += 1.5
            it = i - start[r] if pids[r] == 1002 else i
            rec(t[r], "iteration_start", pids[r], r, source="inprocess", iteration=it)
            if i % 50 == 49:
                d = float(rng.uniform(0.02, 0.08))
                rec(t[r] + 0.001, "ckpt_foreground_blocked", pids[r], r, source="checkpoint",
                    duration_s=d, iteration=i)
                rec(t[r] + d, "ckpt_saved", pids[r], r, source="checkpoint", iteration=i,
                    bytes=int(rng.integers(1 << 20, 1 << 24)), seconds=d)
        if i % 10 == 0:
            rec(max(t.values()) + 0.002, "goodput_update", 900, None, source="launcher",
                ratio=ratio, train_s=float(i), wall_s=float(i) / ratio)
        if i == 160:
            rec(t[1] + 0.003, "degraded_set", pids[1], 1, source="telemetry", degraded=[1],
                newly=[1], recovered=[], scores={"0": 1.0, "1": 0.5542})
            rec(t[1] + 0.004, "remediation_decision", 900, None, source="remediation",
                plan=["spare_swap"], degraded=[1], newly=[1])
            rec(t[1] + 0.005, "remediation_action", 900, None, source="remediation",
                action="spare_swap", outcome="ok", ranks=[1])
        if i == 180:
            rec(t[0] + 0.003, "preemption_sync_point", pids[0], 0, source="preemption",
                step=i)
        if i == 186:
            rec(t[0] + 0.003, "preemption_rescinded", pids[0], 0, source="preemption",
                step=i)
        if i == 240:
            rec(t[1] + 0.003, "degraded_set", pids[1], 1, source="telemetry", degraded=[],
                newly=[], recovered=[1], scores={"0": 1.0, "1": 0.98})
            rec(t[1] + 0.004, "remediation_action", 900, None, source="remediation",
                action="reinstate", outcome="ok", ranks=[1])
    end = max(t.values()) + 0.1
    rec(end, "training_finished", pids[0], 0, source="ft", step=STEPS)
    rec(end + 0.05, "round_succeeded", 900, None, source="launcher", round=1,
        exitcodes={"0": 0, "1": 0})
    return sorted(recs, key=lambda r: r["ts"])


def assert_same(a, b, path="$"):
    """Equal structure; floats within RTOL relative (NaN equals NaN)."""
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), (path, a, b)
        if math.isnan(a) or math.isnan(b):
            assert math.isnan(a) and math.isnan(b), (path, a, b)
        else:
            assert math.isclose(a, b, rel_tol=RTOL, abs_tol=1e-12), (path, a, b)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


@pytest.fixture(scope="module")
def recs():
    return stream(seed=0)


def test_the_stream_exercises_every_plane(recs):
    kinds = {r["kind"] for r in recs}
    assert {"iteration_start", "degraded_set", "worker_failed", "ckpt_saved",
            "goodput_update", "preemption_sync_point"} <= kinds
    assert len(recs) > 2 * STEPS


def test_goodput_attribution_is_equal(recs):
    out = {}
    for name, (goodput, *_) in PACKAGES.items():
        ledger = goodput.GoodputLedger()
        ledger.observe_many(recs)
        out[name] = ledger.summary()
    assert out["ref"]["phases"]["train"] > 0 and out["ref"]["phases"]["restart"] > 0
    assert out["ref"]["phases"]["ckpt_stall"] > 0 and out["ref"]["phases"]["incident"] == 0
    assert_same(out["ref"], out["port"])


def test_aggregate_registry_is_equal(recs):
    out = {}
    for name, (_, metrics, *_) in PACKAGES.items():
        snap = metrics.aggregate(recs).snapshot()
        snap.pop("ts")
        for series in snap["metrics"].values():  # gauges stamp the wall clock
            for entry in series:
                entry.pop("ts", None)
        out[name] = (snap, metrics.aggregate(recs).to_prometheus())
    assert "tpu_step_seconds" in out["ref"][0]["metrics"]
    assert "tpu_remediation_actions_total" in out["ref"][0]["metrics"]
    assert_same(out["ref"][0], out["port"][0])
    assert out["ref"][1] == out["port"][1]


def test_watchtower_alerts_are_equal(recs):
    out = {}
    for name, (_, _, watchtower, *_) in PACKAGES.items():
        tower, sequence = watchtower.replay(recs)
        status = tower.status()
        out[name] = (sequence, status["rules"], status["active"], tower.active_alerts())
    fired = {tr["rule"] for tr in out["ref"][0] if tr["kind"] == "alert_fired"}
    assert {"goodput_burn", "step_anomaly"} <= fired, out["ref"][0]
    assert_same(out["ref"], out["port"])


class FakeClock:
    """``time.time`` on the stream's clock: the current record's timestamp."""

    def __init__(self):
        self.now = T0

    def time(self):
        return self.now


def test_autoscale_decisions_are_equal(recs):
    out = {}
    for name, (*_, autoscale, _) in PACKAGES.items():
        clock = FakeClock()
        ctl = autoscale.AutoscaleController(mode="advise", now_fn=clock.time,
                                            target_world=2)
        for rec in recs:
            clock.now = rec["ts"]
            ctl.observe(rec)
            ctl.tick()
        ctl.finalize()
        status = ctl.status()
        out[name] = ([(d.decision_id, d.action, d.victims, d.predicted_delta_s, d.reason,
                       d.ts, d.outcome, d.realized_delta_s) for d in ctl.decisions],
                     status["forecast"], status["cost_model"], status["rescinds"])
    actions = {d[1] for d in out["ref"][0]}
    assert {"swap", "checkpoint"} <= actions, out["ref"][0]
    assert_same(out["ref"], out["port"])


@pytest.mark.parametrize("action", ref_autoscale.ACTIONS)
def test_cost_model_estimates_are_equal(action):
    out = {}
    for name, (*_, autoscale, _) in PACKAGES.items():
        model = autoscale.CostModel(warm_restart_s=10.03, cold_restart_s=15.55)
        model.note_outcome("swap", 12.5, -6.25)
        view = autoscale.ControllerView(
            now=T0, world_size=3, target_world=4, stragglers={1: 0.625, 2: 0.71},
            spares=1, notices=[autoscale.Notice(key="r2", rank=2, noticed_at=T0 - 7.0)],
            step_s=0.512, steps_since_ckpt=37,
            active_alerts=[{"rule": "step_anomaly", "severity": "page"}])
        out[name] = (model.estimate(action, view), model.constants())
    assert_same(out["ref"], out["port"])


def test_incident_chains_are_equal(recs, tmp_path, monkeypatch):
    out = {}
    for name, (*_, incident) in PACKAGES.items():
        clock = FakeClock()
        monkeypatch.setattr(incident, "time", clock)
        engine = incident.IncidentEngine(str(tmp_path / name), node_id="n0",
                                         events_file=None, auto_open=True)
        for rec in recs:
            clock.now = rec["ts"]
            engine.observe(rec)
        docs = [incident.read_incident(p) for p in engine.artifacts]
        out[name] = [{k: d[k] for k in ("trigger", "detail", "outcome", "ranks", "opened_ts",
                                         "closed_ts", "fault_ts", "slo", "chain")}
                     for d in docs]
    assert [d["trigger"] for d in out["ref"]] == ["degraded", "worker_failed"]
    assert all(d["outcome"] == "recovered" for d in out["ref"])
    assert_same(out["ref"], out["port"])
