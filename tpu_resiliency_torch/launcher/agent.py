"""Per-host elastic agent: rendezvous → spawn monitors + workers → supervise → restart.

Re-design of the reference's launcher/agent stack (``fault_tolerance/launcher.py``
``LocalElasticAgent:126`` / ``_invoke_run_with_*_policy:281,350`` +
``_torch_elastic_compat/agent/server/api.py`` ``SimpleElasticAgent``) on TPU-native
substrate: membership and restart signalling ride the coordination KV store
(``rendezvous.py``) instead of a c10d TCPStore fork; per-rank hang detection is the
``watchdog`` monitor process (UDS), reference ``launcher.py:454 setup_rank_monitors``;
rank control requests (exclude-node / shutdown, reference
``_handle_control_requests_from_rank``, ``_ft_rendezvous.py:785-804``) arrive on the
launcher's UDS socket.

Restart policies (reference ``launcher.py:270-449``):

- ``any-failed``: any worker failure anywhere triggers a full restart round.
- ``min-healthy``: a failed node reports unhealthy and the job restarts only once at
  least ``min_nodes`` healthy nodes are available — no thrash while hosts churn.
"""

from __future__ import annotations

import dataclasses
import os
import socket as socketmod
import threading
import time
import uuid
from typing import Optional

from tpu_resiliency_torch.exceptions import FaultToleranceError, StoreError
from tpu_resiliency_torch.launcher.proc import GroupState, WorkerGroup
from tpu_resiliency_torch.launcher.rendezvous import (
    RendezvousOutcome,
    RendezvousSettings,
    StoreRendezvous,
)
from tpu_resiliency_torch.platform import ipc
from tpu_resiliency_torch.platform.store import StoreView
from tpu_resiliency_torch.utils.events import record as record_event
from tpu_resiliency_torch.utils.logging import get_logger
from tpu_resiliency_torch.utils.tracing import child_env, span
from tpu_resiliency_torch.watchdog.config import FaultToleranceConfig
from tpu_resiliency_torch.watchdog.data import WorkloadAction, WorkloadControlRequest
from tpu_resiliency_torch.watchdog.monitor_server import RankMonitorServer
from tpu_resiliency_torch.watchdog.state_machine import RestarterStateMachine

log = get_logger(__name__)

#: Options of the JAX package's agent whose modules the port does not hold yet, and
#: those modules: a config or a launcher flag that asks for one fails, never is
#: silently ignored.
UNPORTED_FEATURES = {
    "incidents_dir": "tpu_resiliency/launcher/incident.py",
    "telemetry_port": "tpu_resiliency/launcher/telemetry.py",
    "fleet_dir": "tpu_resiliency/launcher/telemetry.py and tpu_resiliency/fleet/",
    "autoscale": "tpu_resiliency/launcher/autoscale.py and "
                 "tpu_resiliency/telemetry/remediation.py",
    "alerts": "tpu_resiliency/telemetry/watchtower.py",
    "metrics_file": "tpu_resiliency/utils/metrics.py",
}


def unported(option: str) -> str:
    """The error for an option whose module is not ported yet."""
    return (f"{option} needs {UNPORTED_FEATURES[option]}, which is not ported to "
            f"tpu_resiliency_torch yet")


@dataclasses.dataclass
class AgentConfig:
    argv: list[str]
    nproc_per_node: int = 1
    min_nodes: int = 1
    max_nodes: int = 1
    node_id: str = ""
    max_restarts: int = 3
    restart_policy: str = "any-failed"  # or "min-healthy"
    monitor_interval: float = 0.5
    last_call_timeout: float = 1.0
    keep_alive_interval: float = 2.0
    keep_alive_timeout: float = 20.0
    upscaling_enabled: bool = False
    term_grace: float = 15.0
    run_dir: str = ""
    log_dir: Optional[str] = None
    use_python: bool = True
    enable_ft_monitors: bool = True
    store_host: str = "127.0.0.1"
    store_port: int = 0
    #: parked pre-imported interpreters kept warm per node: restart rounds
    #: promote one instead of paying the measured multi-second spawn+import
    #: serialization (BENCH_restart.json decomposition). 0 disables.
    warm_spares: int = 0
    warm_spare_preload: str = "torch"
    #: park phase for spares: "imports" (preloads only), "runtime" (the
    #: platform-safe device.warm_runtime pre-init), or a custom
    #: "module:function" spec. Deeper-warmed spares are promoted first.
    warm_spare_warmup: str = "imports"
    #: restart fast-path rendezvous (round reuse): replacement rounds with
    #: unchanged agent membership close with one CAS + one barrier instead of
    #: the full open/join/close ladder
    rdzv_fast_path: bool = True
    #: directory for incident artifacts + flight-recorder dumps; empty
    #: disables the incident plane (``launcher/incident.py``). Exported to
    #: workers as $TPU_RESILIENCY_FLIGHT_DIR so every rank keeps a
    #: crash-surviving ring of its last events.
    incidents_dir: str = ""
    #: None disables the live telemetry endpoint (``launcher/telemetry.py``);
    #: 0 binds an ephemeral port (the bound port lands in
    #: ``<run_dir>/telemetry.port`` — the port-file handshake). Enabling it
    #: also exports $TPU_RESILIENCY_METRICS_PUSH to workers so every rank
    #: publishes its metrics snapshot up the coordination store for the
    #: merged job-level /metrics view.
    telemetry_port: Optional[int] = None
    #: store key prefix the ranks publish metrics snapshots under (namespaced
    #: by --rdzv-id at the CLI so jobs sharing a store endpoint never merge
    #: each other's metrics)
    metrics_push_prefix: str = "jobmetrics/default/"
    #: fleet-federation discovery directory (``--fleet-dir``): the telemetry
    #: server registers this job's endpoint as a heartbeat-refreshed lease
    #: file there so ``tpu-fleetd`` can scrape it (``fleet/registry.py``);
    #: empty disables registration. Requires telemetry to be enabled.
    fleet_dir: str = ""
    #: fleet job identity (the CLI passes --rdzv-id): the lease's job key and
    #: the ``job=`` label fleetd injects when merging this job's metrics
    job_id: str = "default"
    #: goodput-optimal autoscale controller (``launcher/autoscale.py``):
    #: "off" disables it; "advise" computes and audits every decision but
    #: actuates nothing (the safe mode to trust the model first); "act"
    #: routes decisions through the remediation actuators and restart rounds.
    autoscale: str = "off"
    #: SLO watchtower (``telemetry/watchtower.py``): "on" runs the burn-rate
    #: alert engine off the telemetry server's events tail and serves it at
    #: ``GET /alerts``; "off" disables it. Requires telemetry to be enabled
    #: to matter. Rule overrides ride $TPU_RESILIENCY_ALERT_RULES.
    alerts: str = "on"

    def __post_init__(self):
        if not self.node_id:
            self.node_id = f"{socketmod.gethostname()}-{uuid.uuid4().hex[:8]}"
        if not self.run_dir:
            self.run_dir = os.path.join(
                os.environ.get("TMPDIR", "/tmp"), f"tpu_ft_{os.getpid()}"
            )
        if self.restart_policy not in ("any-failed", "min-healthy"):
            raise ValueError(f"unknown restart policy {self.restart_policy!r}")
        if self.autoscale not in ("off", "advise", "act"):
            raise ValueError(
                f"unknown autoscale mode {self.autoscale!r}: "
                f"want off | advise | act"
            )
        if self.alerts not in ("off", "on"):
            raise ValueError(
                f"unknown alerts mode {self.alerts!r}: want off | on"
            )
        asked = [name for name, on in (
            ("incidents_dir", bool(self.incidents_dir)),
            ("telemetry_port", self.telemetry_port is not None),
            ("fleet_dir", bool(self.fleet_dir)),
            ("autoscale", self.autoscale != "off"),
        ) if on]
        if asked:
            raise NotImplementedError("; ".join(unported(name) for name in asked))


class WorkersFailed(RuntimeError):
    def __init__(self, message: str, exitcodes: dict):
        super().__init__(message)
        self.exitcodes = exitcodes


class ElasticAgent:
    def __init__(self, cfg: AgentConfig, ft_cfg: FaultToleranceConfig, store: StoreView):
        self.cfg = cfg
        self.ft = ft_cfg
        self.store = store
        self.rdzv = StoreRendezvous(
            store.scoped("rdzv"),
            cfg.node_id,
            RendezvousSettings(
                min_nodes=cfg.min_nodes,
                max_nodes=cfg.max_nodes,
                last_call_timeout=cfg.last_call_timeout,
                keep_alive_interval=cfg.keep_alive_interval,
                keep_alive_timeout=cfg.keep_alive_timeout,
                upscaling_enabled=cfg.upscaling_enabled,
                fast_path=cfg.rdzv_fast_path,
            ),
        )
        self.restarter = RestarterStateMachine("InJob", strict=False)
        self._monitors: list = []
        self._monitor_sockets: list[str] = []
        self._ipc: Optional[ipc.IpcReceiver] = None
        self._launcher_socket = os.path.join(self.cfg.run_dir, "launcher.sock")
        self._restarts_used = 0
        self._last_exitcodes: dict[int, int] = {}
        #: last placed round's world size — a delta means the job elastically
        #: shrank (partial-slice preemption, exclusion) or re-expanded (spares
        #: returned); the resharded resume inside the workers is what makes
        #: the new world trainable, the launcher records the transition.
        self._last_world_size: Optional[int] = None
        self._spare_pool = None
        #: set by restart watchers so spare/completion waits wake on a peer's
        #: restart request instead of sleeping out their poll tick
        self._wake = threading.Event()
        #: the health decision /healthz reflects: True while the last round's
        #: workers were healthy, False from a worker failure until the
        #: replacement round's workers spawn
        self._healthy = True
        self.telemetry = None
        self.autoscale = None
        self.watchtower = None
        self._metrics_store = None
        #: the incident plane (``launcher/incident.py``) is not ported:
        #: AgentConfig refuses ``incidents_dir``
        self.incidents = None

    def _pause(self, timeout: float) -> None:
        if self._wake.wait(timeout):
            self._wake.clear()

    # -- telemetry ---------------------------------------------------------

    def _start_telemetry(self) -> None:
        raise NotImplementedError(unported("telemetry_port"))

    # -- autoscale ---------------------------------------------------------

    def _spare_capacity(self) -> int:
        if self._spare_pool is None:
            return 0
        try:
            return int(self._spare_pool.stats().get("warm", 0))
        except Exception:
            return 0

    def _start_autoscale(self) -> None:
        raise NotImplementedError(unported("autoscale"))

    # -- hang forensics ----------------------------------------------------

    def hang_census(self) -> dict:
        """The live blocked-collective census (the ``/hangz`` document).

        Three sources folded into one answer to "who is stuck where, and who
        never arrived": every rank monitor's ``StatusMsg`` (last-known
        location beacon + heartbeat staleness), the coordination store's
        ``barrier_census`` op (open barrier rounds with waiter ages and
        missing ranks), and a deterministic suspect ranking over both.
        Best-effort by design: an unreachable monitor or store degrades the
        census, never the caller.
        """
        from tpu_resiliency_torch.utils import location as location_mod

        ranks: list[dict] = []
        for path in list(self._monitor_sockets):
            payload = self._monitor_status(path)
            if not payload:
                continue
            stuck = payload.get("last_hb_age_s")
            if not isinstance(stuck, (int, float)):
                stuck = payload.get("connected_age_s")
            ranks.append({
                "rank": payload.get("rank"),
                "pid": payload.get("pid"),
                "stuck_s": round(stuck, 3) if isinstance(stuck, (int, float)) else None,
                "last_hb_age_s": payload.get("last_hb_age_s"),
                "hb_timeout_s": payload.get("hb_timeout_s"),
                "location": payload.get("location"),
                "location_age_s": payload.get("location_age_s"),
                "where": location_mod.describe(
                    payload.get("location"), age_s=payload.get("location_age_s")
                ) or None,
                "open_sections": payload.get("open_sections"),
                "terminated": payload.get("terminated"),
                "kill_pending": payload.get("kill_pending"),
            })
        ranks.sort(key=lambda r: (r["rank"] is None, r["rank"]))
        barriers: list[dict] = []
        census_error = None
        try:
            raw = self.store.client.barrier_census()
        except Exception as e:  # store wedged/gone: serve what we have
            raw, census_error = {}, repr(e)
        for name in sorted(raw):
            b = raw[name]
            arrived = b.get("arrived") or {}
            barriers.append({
                "name": name,
                "generation": b.get("generation"),
                "world_size": b.get("world_size"),
                "arrived": arrived,
                "missing": b.get("missing") or [],
                "absent": b.get("absent") or [],
                "waiters": len(arrived),
                "oldest_wait_s": max(arrived.values(), default=0.0),
                "open_age_s": b.get("open_age_s"),
            })
        doc = {
            "schema": "tpu-hangz-1",
            "ts": time.time(),
            "node_id": self.cfg.node_id,
            "ranks": ranks,
            "barriers": barriers,
            "barrier_waiters": sum(b["waiters"] for b in barriers),
            "suspects": self._rank_suspects(ranks, barriers),
        }
        if census_error:
            doc["barrier_census_error"] = census_error
        return doc

    @staticmethod
    def _monitor_status(path: str) -> Optional[dict]:
        from tpu_resiliency_torch.watchdog.data import StatusMsg

        try:
            sock = ipc.connect(path, timeout=1.0)
        except (OSError, ConnectionError):
            return None
        try:
            sock.settimeout(2.0)
            ipc.write_object(sock, StatusMsg())
            reply = ipc.read_object(sock)
        except (OSError, EOFError, ConnectionError):
            return None
        finally:
            try:
                sock.close()
            except OSError:
                pass
        payload = getattr(reply, "payload", None)
        if isinstance(payload, dict) and payload.get("connected"):
            return payload
        return None

    @staticmethod
    def _rank_suspects(ranks: list[dict], barriers: list[dict]) -> list[dict]:
        """Deterministic suspect ranking: a rank missing from barriers that
        others are parked in is the prime suspect; heartbeat silence past the
        timeout and a watchdog verdict corroborate."""
        scores: dict[int, float] = {}
        reasons: dict[int, list[str]] = {}

        def implicate(rank, weight: float, why: str) -> None:
            if not isinstance(rank, int):
                return
            scores[rank] = scores.get(rank, 0.0) + weight
            reasons.setdefault(rank, []).append(why)

        for b in barriers:
            if not b["waiters"]:
                continue  # nobody is blocked on this round yet
            for r in b["missing"]:
                implicate(
                    r, 2.0,
                    f"missing from barrier {b['name']!r} "
                    f"({b['waiters']} waiting, oldest {b['oldest_wait_s']:.0f}s)",
                )
        for row in ranks:
            r = row.get("rank")
            hb_age, hb_timeout = row.get("last_hb_age_s"), row.get("hb_timeout_s")
            if (
                isinstance(hb_age, (int, float))
                and isinstance(hb_timeout, (int, float))
                and hb_age > hb_timeout
            ):
                implicate(
                    r, 1.0,
                    f"heartbeat silent for {hb_age:.0f}s (timeout {hb_timeout:.0f}s)",
                )
            if row.get("kill_pending"):
                implicate(r, 3.0, f"watchdog verdict: {row['kill_pending']}")
            elif row.get("terminated"):
                implicate(r, 3.0, "terminated by watchdog")
        return [
            {"rank": r, "score": round(scores[r], 3), "reasons": reasons[r]}
            for r in sorted(scores, key=lambda r: (-scores[r], r))
        ]

    def health(self) -> dict:
        """The /healthz document: this agent's current health decision."""
        budget_ok = self._restarts_used <= self.cfg.max_restarts
        doc = {
            "healthy": bool(self._healthy and budget_ok),
            "node_id": self.cfg.node_id,
            "workers_healthy": bool(self._healthy),
            "restarts_used": self._restarts_used,
            "max_restarts": self.cfg.max_restarts,
            "restart_budget_ok": budget_ok,
        }
        if self.incidents is not None:
            doc["incident_open"] = bool(self.incidents.is_open)
        if self._spare_pool is not None:
            # Warm-spare pool state: is there standby capacity for the next
            # restart round, and how deep is it warmed?
            try:
                doc["warm_spares"] = self._spare_pool.stats()
            except Exception:
                pass
        return doc

    # -- lifecycle ---------------------------------------------------------

    def run(self) -> dict[int, int]:
        """Supervise until success, shutdown, exclusion, or restart budget exhausted.
        Returns {global_rank: exitcode} of this node's last round on success."""
        os.makedirs(self.cfg.run_dir, exist_ok=True)
        self._ipc = ipc.IpcReceiver(self._launcher_socket)
        self._ipc.start()
        # --fleet-dir implies telemetry: a fleet registration without an
        # endpoint to scrape would be a lease pointing at nothing.
        if self.cfg.telemetry_port is not None or self.cfg.fleet_dir:
            self._start_telemetry()
        if self.cfg.autoscale != "off":
            self._start_autoscale()
        self.restarter.initialize()
        prev_round = -1
        try:
            # Inside the try: an exception anywhere past this point must run
            # the finally's pool.close() (spares also self-release on the
            # pipe-EOF tether if this process dies outright).
            if self.cfg.warm_spares > 0 and self.cfg.use_python:
                from tpu_resiliency_torch.launcher.park import WarmSparePool

                self._spare_pool = WarmSparePool(
                    self.cfg.warm_spares,
                    self.cfg.run_dir,
                    preload=self.cfg.warm_spare_preload,
                    warmup=self.cfg.warm_spare_warmup,
                )
            while True:
                try:
                    outcome = self.rdzv.next_round(prev_round)
                except (StoreError, FaultToleranceError):
                    # Store lost while re-entering rendezvous. If we carry no
                    # failure of our own — our last round's workers all
                    # succeeded, or we were a spare that never ran any — the
                    # likeliest story is "the job finished and the
                    # store-hosting agent left while a late restart request
                    # was pulling us back in": the same benign race
                    # _await_group_completion and _spare_loop already treat
                    # as completion. A node re-rendezvousing to retry its own
                    # FAILED round keeps this fatal.
                    if prev_round >= 0 and all(
                        c == 0 for c in self._last_exitcodes.values()
                    ):
                        log.info(
                            f"[{self.cfg.node_id}] store gone while "
                            f"re-rendezvousing after round {prev_round} with no "
                            f"local failure; treating job as complete"
                        )
                        return self._last_exitcodes
                    raise
                # The restart budget is charged once per restart *round*, whoever
                # caused it — a job whose failures rotate across N nodes must not
                # get N × max_restarts rounds, and a correlated k-node failure that
                # bumps the epoch k times is still one round. Round numbers are
                # global and bump exactly once per re-rendezvous, so the delta is
                # the right unit (upscale rounds count too; they are rare and the
                # alternative lets an epoch-less reopened round slip uncharged).
                if prev_round >= 0 and outcome.round > prev_round:
                    self._restarts_used += outcome.round - prev_round
                    record_event(
                        "launcher", "restart_budget", round=outcome.round,
                        node_id=self.cfg.node_id, used=self._restarts_used,
                        max=self.cfg.max_restarts,
                    )
                prev_round = outcome.round
                if self._restarts_used > self.cfg.max_restarts:
                    self.rdzv.request_shutdown(
                        f"restart budget exhausted ({self.cfg.max_restarts})"
                    )
                    self.restarter.aborted()
                    record_event(
                        "launcher", "budget_exhausted",
                        node_id=self.cfg.node_id, max_restarts=self.cfg.max_restarts,
                    )
                    raise WorkersFailed(
                        f"restart budget ({self.cfg.max_restarts}) exhausted", {}
                    )
                reason = self.rdzv.shutdown_reason()
                if reason is not None:
                    raise WorkersFailed(f"workload shut down: {reason}", {})
                if outcome.is_spare:
                    action = self._wait_as_spare(outcome)
                else:
                    action = self._run_round(outcome)
                if action == "done":
                    return self._last_exitcodes
                if action == "excluded":
                    log.info(f"[{self.cfg.node_id}] leaving the job (excluded)")
                    if self.incidents is not None and self.incidents.is_open:
                        self.incidents.close(outcome="excluded")
                    self.rdzv.leave()
                    return {}
                # action == "restart": loop into the next rendezvous round
        finally:
            if self.incidents is not None and self.incidents.is_open:
                # Leaving run() with an incident still open means the job never
                # recovered from it (budget exhausted, shutdown, store loss) —
                # the artifact must say so rather than silently vanish.
                try:
                    self.incidents.close(outcome="unrecovered")
                except Exception:
                    pass
            if self.incidents is not None:
                self.incidents.detach()
            try:
                self.rdzv.mark_exited()
            except Exception:
                pass
            self.rdzv.stop_keepalive()
            if self._ipc is not None:
                self._ipc.stop()
            if self._spare_pool is not None:
                self._spare_pool.close()
            if self.autoscale is not None:
                try:
                    # stop() finalizes pending outcomes so every decision the
                    # run audited carries a realized delta in the stream.
                    self.autoscale.stop()
                except Exception:
                    pass
                self.autoscale = None
            if self.telemetry is not None:
                try:
                    self.telemetry.stop()
                except Exception:
                    pass
                self.telemetry = None
            if self._metrics_store is not None:
                try:
                    self._metrics_store.close()
                except Exception:
                    pass
                self._metrics_store = None

    # -- spare path --------------------------------------------------------

    def _wait_as_spare(self, outcome: RendezvousOutcome) -> str:
        """Idle in reserve: poll for a restart round (our chance to be promoted),
        shutdown, or job completion (reference redundancy ranks,
        ``_ft_rendezvous.py:302-338``)."""
        log.info(f"[{self.cfg.node_id}] spare for round {outcome.round}; standing by")
        epoch0 = outcome.epoch
        try:
            watcher = self.rdzv.watch_restart(self._wake.set)
        except Exception:
            watcher = None  # accelerator only; polling still covers it
        try:
            # Standby time is a first-class phase: in the trace it shows how
            # long warm capacity sat idle before promotion (or job end).
            with span(
                "launcher", "launcher.spare_wait",
                round=outcome.round, node_id=self.cfg.node_id,
            ):
                return self._spare_loop(outcome, epoch0)
        finally:
            if watcher is not None:
                watcher.stop()

    def _spare_loop(self, outcome: RendezvousOutcome, epoch0: int) -> str:
        while True:
            self._pause(self.cfg.monitor_interval)
            try:
                if self.rdzv.shutdown_reason() is not None:
                    self._last_exitcodes = {}
                    return "done"
                if self.rdzv.restart_epoch() != epoch0:
                    return "restart"
                done = self.rdzv.done_nodes(outcome.round)
                if done and set(outcome.active) <= done:
                    self._last_exitcodes = {}
                    return "done"
                # A spare must also watch active liveness: if every active died at
                # once (host loss), no survivor is left to request the restart that
                # would promote us.
                dead = self.rdzv.dead_nodes() & set(outcome.active)
                if dead - done:
                    self.rdzv.request_restart(
                        f"spare {self.cfg.node_id} saw dead actives: {sorted(dead - done)}"
                    )
                    return "restart"
            except StoreError:
                # The store host left — the job is over; spares have nothing to do.
                self._last_exitcodes = {}
                return "done"
            req = self._poll_control()
            if req == "excluded":
                return "excluded"

    # -- active path -------------------------------------------------------

    def _run_round(self, outcome: RendezvousOutcome) -> str:
        # One span per placed round: workers spawned inside inherit it as their
        # parent (child_env below), so a restart's causal chain — fault →
        # restart request → next round → respawn — nests under round spans in
        # the exported trace.
        with span(
            "launcher", "launcher.round", round=outcome.round,
            node_rank=outcome.node_rank, node_id=self.cfg.node_id,
        ):
            return self._run_placed_round(outcome)

    def _run_placed_round(self, outcome: RendezvousOutcome) -> str:
        cfg = self.cfg
        node_rank = outcome.node_rank
        world_size = outcome.num_nodes * cfg.nproc_per_node
        first_rank = node_rank * cfg.nproc_per_node
        log.info(
            f"[{cfg.node_id}] round {outcome.round}: node_rank={node_rank} "
            f"world={world_size} nodes={outcome.active} spares={outcome.spares}"
        )
        record_event(
            "launcher", "rendezvous_round", round=outcome.round,
            node_id=cfg.node_id, node_rank=node_rank, world_size=world_size,
            active=list(outcome.active), spares=list(outcome.spares),
            fast=bool(outcome.fast),
        )
        if (
            self._last_world_size is not None
            and world_size != self._last_world_size
        ):
            # The elastic transition itself: the workers' resharded resume
            # makes the new world trainable; this record ties the shrink /
            # re-expand to the round that performed it.
            record_event(
                "launcher", "world_resized", round=outcome.round,
                node_id=cfg.node_id,
                direction="shrink" if world_size < self._last_world_size
                else "grow",
                from_world=self._last_world_size, to_world=world_size,
            )
        self._last_world_size = world_size
        base_env = {
            "NODE_RANK": str(node_rank),
            "GROUP_RANK": str(node_rank),
            "TPU_RESILIENCY_STORE_HOST": cfg.store_host,
            "TPU_RESILIENCY_STORE_PORT": str(cfg.store_port),
            # Tells an inprocess.Wrapper in the worker to ride this store as a
            # client (scoped by launcher round) instead of hosting its own —
            # the layered in-job + in-process coupling.
            "TPU_RESILIENCY_STORE_EXTERNAL": "1",
            ipc.LAUNCHER_SOCKET_ENV: self._launcher_socket,
            # Workers' events/spans parent to THIS round's span, not to
            # whatever the env held when the launcher started.
            **child_env(),
        }
        if self.telemetry is not None:
            from tpu_resiliency_torch.utils.events import METRICS_PUSH_ENV

            # Each rank publishes its metrics snapshot up the coordination
            # store (utils/metrics.py:MetricsPublisher); the telemetry
            # server's /metrics merges the published set into the job view.
            base_env[METRICS_PUSH_ENV] = (
                f"{cfg.store_host}:{cfg.store_port}:{cfg.metrics_push_prefix}"
            )
        group = WorkerGroup(
            argv=cfg.argv,
            nproc=cfg.nproc_per_node,
            base_env=base_env,
            run_dir=cfg.run_dir,
            log_dir=cfg.log_dir,
            use_python=cfg.use_python,
            spare_pool=self._spare_pool,
        )
        watcher = None
        try:
            # The spawn segment is the restart-latency hot path (BENCH_restart
            # decomposition) — give it its own slice in the trace.
            with span(
                "launcher", "worker.spawn",
                round=outcome.round, nproc=cfg.nproc_per_node,
            ):
                self._start_monitors(outcome.round)
                if self._monitor_sockets:
                    sockets = list(self._monitor_sockets)
                    group.per_rank_env = (
                        lambda local: {ipc.MONITOR_SOCKET_ENV: sockets[local]}
                    )
                group.start(outcome.round, first_rank, world_size)
            if self.incidents is not None and self.incidents.is_open:
                # The fault's replacement round is up and training again:
                # that IS the recovery the SLO clock measures (waiting for the
                # round to *succeed* would count hours of healthy training as
                # time-to-recover on long jobs).
                self.incidents.close(outcome="recovered")
            # A peer's restart request wakes the supervise loop through the
            # same event as a local worker death: multi-node respawn is then
            # notification-bound on every surviving node, not poll-bound.
            try:
                watcher = self.rdzv.watch_restart(
                    lambda: (group.notify_change(), self._wake.set())
                )
            except Exception:
                watcher = None  # accelerator only; polling still covers it
            self.restarter.handling_start(f"round={outcome.round}")
            self.restarter.handling_processing()
            result = self._supervise(group, outcome)
            self.restarter.handling_completed()
            return result
        finally:
            if watcher is not None:
                watcher.stop()
            if group.workers and group.poll() is GroupState.RUNNING:
                # Unwinding on an exception (e.g. store loss) must not orphan the
                # round's workers — they'd keep holding the TPU devices.
                group.stop(cfg.term_grace)
            self._stop_monitors()
            # Post-round: re-digest the compile-cache manifest so entries this
            # round's workers wrote are integrity-covered even if the workers
            # died without their exit hooks (SIGKILL, OOM). On a thread — a
            # large cache's CRC pass must not sit on the restart path.
            try:
                from tpu_resiliency_torch.platform import compile_cache

                threading.Thread(
                    target=compile_cache.refresh_manifest_from_env,
                    daemon=True, name="compile-cache-manifest",
                ).start()
            except Exception:
                pass

    def _supervise(self, group: WorkerGroup, outcome: RendezvousOutcome) -> str:
        cfg = self.cfg
        epoch0 = outcome.epoch
        i_am_leader = outcome.node_rank == 0
        self._healthy = True  # this round's workers are up: /healthz recovers
        self.rdzv.set_health(True)
        while True:
            # Event-driven: a worker exit wakes this immediately (ms detection
            # on the respawn path); the timeout bounds control-plane polling.
            group.wait_change(cfg.monitor_interval)
            state = group.poll()
            if state is GroupState.SUCCEEDED:
                group.reap()
                self._last_exitcodes = {k: v for k, v in group.exitcodes().items()}
                self.rdzv.mark_done(outcome.round)
                record_event(
                    "launcher", "round_succeeded", round=outcome.round,
                    node_id=cfg.node_id, exitcodes=dict(self._last_exitcodes),
                )
                return self._await_group_completion(outcome, epoch0)
            if state is GroupState.FAILED:
                # Stamped the instant wait_change returned with a failure —
                # BEFORE error-file reads, the hang census, or teardown — so
                # the bench's "detect" segment measures exactly fault
                # injection → reaper-event wakeup, on cold and promoted
                # workers alike.
                record_event(
                    "launcher", "failure_detected", round=outcome.round,
                    node_id=cfg.node_id,
                )
                return self._handle_failure(group, outcome)
            # -- running: watch the control plane --------------------------
            if self.rdzv.shutdown_reason() is not None:
                group.stop(cfg.term_grace)
                raise WorkersFailed(
                    f"workload shut down: {self.rdzv.shutdown_reason()}", group.exitcodes()
                )
            if self.rdzv.restart_epoch() != epoch0:
                log.info(f"[{cfg.node_id}] restart requested elsewhere; stopping workers")
                group.stop(cfg.term_grace)
                return "restart"
            req = self._poll_control()
            if req == "excluded":
                if self.incidents is not None and not self.incidents.is_open:
                    # Rank-requested exclusion (often the remediation engine's
                    # doing) is an incident even though no worker died here.
                    self.incidents.open("exclude_request")
                group.stop(cfg.term_grace)
                self.rdzv.request_restart(f"node {cfg.node_id} excluded by rank request")
                return "excluded"
            if req == "shutdown":
                group.stop(cfg.term_grace)
                raise WorkersFailed("workload shut down by rank request", group.exitcodes())
            if i_am_leader:
                self._leader_duties(outcome)

    def _await_group_completion(self, outcome: RendezvousOutcome, epoch0: int) -> str:
        """Local workers succeeded; hold until every active node reports done (or a
        failure elsewhere pulls us into another round — any-failed semantics)."""
        while True:
            try:
                done = self.rdzv.done_nodes(outcome.round)
                if set(outcome.active) <= done:
                    return "done"
                if self.rdzv.shutdown_reason() is not None:
                    return "done"
                if self.rdzv.restart_epoch() != epoch0:
                    return "restart"
                dead = self.rdzv.dead_nodes() & set(outcome.active)
                if dead - done:
                    self.rdzv.request_restart(f"nodes died after our completion: {dead - done}")
                    return "restart"
            except StoreError:
                # Store host gone after our own success ⇒ treat the round as done.
                return "done"
            # The round watcher (still active here) wakes this on a restart.
            self._pause(self.cfg.monitor_interval)

    def _handle_failure(self, group: WorkerGroup, outcome: RendezvousOutcome) -> str:
        cfg = self.cfg
        self._healthy = False  # /healthz reports 503 until the next round spawns
        failures = group.failures()
        for f in failures:
            log.error(f"[{cfg.node_id}] worker failed: {f.describe()}")
            record_event(
                "launcher", "worker_failed", round=outcome.round,
                node_id=cfg.node_id, global_rank=f.global_rank,
                exitcode=f.exitcode, detail=f.describe(),
            )
        # Snapshot the hang census NOW, while the surviving ranks' monitors
        # still hold their sessions and the blocked barriers are still open —
        # group.stop() below destroys both halves of the evidence. One
        # ``hang_census`` record per failure (not per /hangz scrape) feeds
        # tpu_hang_suspects_total / tpu_rank_blocked_seconds.
        census: Optional[dict] = None
        if self._monitor_sockets:
            try:
                census = self.hang_census()
                record_event(
                    "launcher", "hang_census",
                    node_id=cfg.node_id, round=outcome.round,
                    suspects=census.get("suspects"),
                    blocked={
                        str(r["rank"]): r["stuck_s"]
                        for r in census.get("ranks", [])
                        if r.get("rank") is not None and r.get("stuck_s") is not None
                    },
                    barrier_waiters=census.get("barrier_waiters"),
                    open_barriers=len(census.get("barriers", [])),
                )
            except Exception:
                log.exception("hang census at failure time failed; continuing")
        if self.incidents is not None:
            # After the worker_failed records: the engine's pre-buffer scan
            # anchors time-to-detect on the earliest fault evidence.
            self.incidents.open(
                "worker_failed",
                detail="; ".join(f.describe() for f in failures),
                ranks=sorted(f.global_rank for f in failures),
                census=census,
            )
        group.stop(cfg.term_grace)
        # Budget accounting lives in run() (epoch deltas); here we only pre-check
        # whether the round we are about to request would bust it.
        if self._restarts_used + 1 > cfg.max_restarts:
            self.rdzv.request_shutdown(
                f"restart budget exhausted ({cfg.max_restarts}) after: "
                f"{failures[0].describe() if failures else 'unknown'}"
            )
            self.restarter.aborted()
            raise WorkersFailed(
                f"workers failed and restart budget ({cfg.max_restarts}) exhausted: "
                + "; ".join(f.describe() for f in failures),
                group.exitcodes(),
            )
        if cfg.restart_policy == "min-healthy":
            self.rdzv.set_health(False, failures[0].describe() if failures else "")
            self._wait_min_healthy()
        record_event(
            "launcher", "restart_requested", round=outcome.round, node_id=cfg.node_id,
            reason="; ".join(f.describe() for f in failures),
        )
        self.rdzv.request_restart(
            f"node {cfg.node_id}: " + "; ".join(f.describe() for f in failures)
        )
        return "restart"

    def _wait_min_healthy(self) -> None:
        """min-healthy policy: hold the restart until at least ``min_nodes`` *live*
        agents exist (reference ``_invoke_run_with_min_healthy_policy``,
        ``launcher.py:350``). Liveness — a fresh keep-alive — is the criterion, not
        last round's health flags: after a correlated failure every node flags
        unhealthy, yet all of them are alive and ready for the next round; counting
        flags would deadlock the whole fleet."""
        cfg = self.cfg
        epoch0 = self.rdzv.restart_epoch()
        while True:
            live = self.rdzv.live_nodes()
            if len(live) >= cfg.min_nodes:
                return
            if self.rdzv.shutdown_reason() is not None:
                return
            if self.rdzv.restart_epoch() != epoch0:
                return  # someone else already judged the fleet ready
            log.info(
                f"[{cfg.node_id}] min-healthy hold: {len(live)}/{cfg.min_nodes} live agents"
            )
            time.sleep(max(cfg.monitor_interval, 1.0))

    def _leader_duties(self, outcome: RendezvousOutcome) -> None:
        """Node-rank-0 extras each tick: evict dead nodes, trigger upscale rounds."""
        dead = self.rdzv.dead_nodes() & set(outcome.active)
        if dead:
            self.rdzv.request_restart(f"dead nodes: {sorted(dead)}")
            return
        if self.cfg.upscaling_enabled and len(outcome.active) < self.cfg.max_nodes:
            if self.rdzv.waiting_count() > 0:
                self.rdzv.request_restart("upscale: new nodes waiting")

    # -- control requests --------------------------------------------------

    def _poll_control(self) -> Optional[str]:
        """Drain rank → launcher control messages (reference
        ``_handle_control_requests_from_rank``, ``_ft_rendezvous.py:785-804``)."""
        if self._ipc is None:
            return None
        for msg in self._ipc.fetch():
            if not isinstance(msg, WorkloadControlRequest):
                log.warning(f"ignoring unknown control message {type(msg).__name__}")
                continue
            log.info(
                f"[{self.cfg.node_id}] control request {msg.action.name} "
                f"from rank {msg.sender.global_rank if msg.sender else '?'}: {msg.reason}"
            )
            record_event(
                "launcher", "control_request", node_id=self.cfg.node_id,
                action=msg.action.name, reason=msg.reason,
                sender=msg.sender.global_rank if msg.sender else None,
            )
            if msg.action is WorkloadAction.ExcludeThisNode:
                return "excluded"
            if msg.action is WorkloadAction.ShutdownWorkload:
                self.rdzv.request_shutdown(f"rank requested shutdown: {msg.reason}")
                return "shutdown"
        return None

    # -- per-rank FT monitors ----------------------------------------------

    def _start_monitors(self, round_no: int) -> None:
        if not self.cfg.enable_ft_monitors:
            return
        self._monitor_sockets = []
        for local in range(self.cfg.nproc_per_node):
            path = os.path.join(self.cfg.run_dir, f"monitor_{local}.sock")
            proc = RankMonitorServer.run_in_subprocess(self.ft, path)
            self._monitors.append(proc)
            self._monitor_sockets.append(path)

    def _stop_monitors(self) -> None:
        for proc in self._monitors:
            proc.terminate()
        for proc in self._monitors:
            proc.join(timeout=10.0)
            if proc.is_alive():
                proc.kill()
        self._monitors = []
        self._monitor_sockets = []
