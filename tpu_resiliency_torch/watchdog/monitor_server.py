"""Per-rank monitor process: Unix-socket server + periodic timeout/health checks.

Analogue of the reference's ``RankMonitorServer`` (``fault_tolerance/rank_monitor_server.py``):
one asyncio process per rank, forked by the launcher (``:488-512``); handles
Init/Heartbeat/Section/UpdateTimeouts messages (``:307-340``); a periodic task checks
heartbeat timeout (``_is_hb_timeout_elapsed:349``), section / out-of-section timeouts
(``:369``) and optional health checks (``:411-414``); on violation it sends SIGCONT +
the configured termination signal to the rank PID (``_shutdown_rank:176``) so the
launcher's worker poll sees the death and triggers an in-job restart.
"""

from __future__ import annotations

import asyncio
import dataclasses
import glob
import multiprocessing as mp
import os
import signal
import threading
import time
from typing import Optional

from tpu_resiliency_torch.platform import wire
from tpu_resiliency_torch.utils import location as location_mod
from tpu_resiliency_torch.utils.events import record as record_event
from tpu_resiliency_torch.utils.logging import RankLoggerAdapter, get_logger
from tpu_resiliency_torch.watchdog.config import FaultToleranceConfig
from tpu_resiliency_torch.watchdog.data import (
    DumpStacksMsg,
    ErrorMsg,
    HeartbeatMsg,
    HeartbeatTimeouts,
    InitMsg,
    InitReplyMsg,
    OkMsg,
    RankInfo,
    SectionAction,
    SectionMsg,
    SectionTimeouts,
    StatusMsg,
    UpdateTimeoutsMsg,
    WaitDumpMsg,
)
from tpu_resiliency_torch.watchdog.health import (
    HealthCheck,
    PeriodicHealthMonitor,
    checks_from_config,
)
from tpu_resiliency_torch.watchdog.state_machine import RestarterStateMachine, RestarterState

log = get_logger(__name__)


@dataclasses.dataclass
class _RankSession:
    info: RankInfo
    connected_at: float
    last_hb: Optional[float] = None
    open_sections: dict = dataclasses.field(default_factory=dict)  # name -> open ts
    last_section_activity: Optional[float] = None
    terminated: bool = False
    #: heartbeat statistics for the disconnect-time ``heartbeat_stats`` record:
    #: observed gap distribution is what calibrated timeouts are judged against
    hb_count: int = 0
    max_hb_gap: float = 0.0
    #: last location beacon received (``utils/location.py`` payload) and the
    #: monotonic instant it arrived — the hang-forensics "last seen" record
    location: Optional[dict] = None
    location_rx: float = 0.0
    #: whether the rank installed a SIGUSR1 dump trigger (InitMsg
    #: capabilities): gates the signal nudge — SIGUSR1's default disposition
    #: kills, so a rank that never declared a handler is never signalled
    dump_signal_ok: bool = False
    #: violation pending the pre-kill stack-dump grace:
    #: (reason, cause, via) + the deadline the kill ladder fires at
    kill_pending: Optional[tuple] = None
    dump_deadline: float = 0.0


class RankMonitorServer:
    def __init__(
        self,
        cfg: FaultToleranceConfig,
        socket_path: str,
        health_checks: Optional[list[HealthCheck]] = None,
    ):
        self.cfg = cfg
        self.socket_path = socket_path
        self.session: Optional[_RankSession] = None
        self.hb_timeouts = HeartbeatTimeouts(
            initial=cfg.initial_rank_heartbeat_timeout,
            subsequent=cfg.rank_heartbeat_timeout,
            calculated=False,
        )
        self.section_timeouts = SectionTimeouts(
            section=dict(cfg.rank_section_timeouts),
            out_of_section=cfg.rank_out_of_section_timeout,
        )
        if health_checks is None:
            # Config-enabled built-ins (host memory floor, ICI link counters) —
            # explicit lists override, an explicit [] disables.
            health_checks = checks_from_config(cfg)
        self.health_checks = health_checks
        self._health_monitor: Optional[PeriodicHealthMonitor] = None
        self._health_failure: Optional[str] = None
        self.restarter = RestarterStateMachine("InJob", strict=False)
        self.log = RankLoggerAdapter(log, role="monitor")
        self._stop_event: Optional[asyncio.Event] = None
        #: stack-dump request generation: every request bumps it; the rank's
        #: WaitDumpMsg long-poll parks until the generation moves
        self._dump_gen = 0
        self._dump_reason = ""
        self._dump_event: Optional[asyncio.Event] = None

    # -- lifecycle ---------------------------------------------------------

    async def serve(self) -> None:
        self._stop_event = asyncio.Event()
        self._dump_event = asyncio.Event()
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        os.makedirs(os.path.dirname(self.socket_path) or ".", exist_ok=True)
        server = await asyncio.start_unix_server(self._handle_conn, path=self.socket_path)
        self.restarter.initialize()
        if self.health_checks and self.cfg.enable_health_checks:
            self._health_monitor = PeriodicHealthMonitor(
                self.health_checks,
                self.cfg.health_check_interval,
                self._on_health_failure,
            )
            self._health_monitor.start()
        checker = asyncio.create_task(self._periodic_check())
        try:
            async with server:
                await self._stop_event.wait()
        finally:
            checker.cancel()
            if self._health_monitor:
                self._health_monitor.stop()
            if os.path.exists(self.socket_path):
                try:
                    os.unlink(self.socket_path)
                except OSError:
                    pass

    def run(self) -> None:
        asyncio.run(self.serve())

    @classmethod
    def run_in_subprocess(
        cls,
        cfg: FaultToleranceConfig,
        socket_path: str,
        health_checks: Optional[list[HealthCheck]] = None,
        start_method: str = "fork",
    ) -> mp.Process:
        """Fork a monitor process (reference ``rank_monitor_server.py:488-512``).

        Waits until the server socket exists so the worker can connect immediately.
        """
        ctx = mp.get_context(start_method)
        # A stale socket file from a SIGKILLed predecessor would satisfy the readiness
        # poll below before the child has actually bound its listener.
        if os.path.exists(socket_path):
            try:
                os.unlink(socket_path)
            except OSError:
                pass
        proc = ctx.Process(
            target=_monitor_main, args=(cfg, socket_path, health_checks), daemon=True
        )
        proc.start()
        # Generous: spawn-started monitors (used by tests to avoid forking a
        # threaded parent) pay full interpreter startup, which can be several
        # seconds even unloaded.
        deadline = time.monotonic() + 60.0
        while not os.path.exists(socket_path):
            if time.monotonic() > deadline or not proc.is_alive():
                raise RuntimeError(f"rank monitor failed to start on {socket_path}")
            time.sleep(0.01)
        return proc

    # -- connection handling ----------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        # Only the connection that carried this session's InitMsg narrates the
        # rank's disconnect: the socket now also serves dump long-polls,
        # status probes (/hangz census), and sibling dump broadcasts, whose
        # closes must not fabricate heartbeat_stats records.
        inited = False
        try:
            while True:
                try:
                    msg = await wire.read_obj_stream(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                if isinstance(msg, InitMsg):
                    inited = True
                if isinstance(msg, WaitDumpMsg):
                    # Parks this connection's coroutine only; other
                    # connections (heartbeats, probes) keep being served.
                    reply = await self._wait_dump(msg)
                else:
                    reply = self._dispatch(msg)
                await wire.write_obj_stream(writer, reply)
        finally:
            if inited and self.session is not None:
                s = self.session
                self.log.info(
                    f"rank {s.info.global_rank} disconnected from monitor"
                )
                if s.hb_count:
                    # One summary record per monitored session, not one per
                    # heartbeat: the max gap is the margin-to-timeout an
                    # operator tunes ``rank_heartbeat_timeout`` against.
                    record_event(
                        "watchdog", "heartbeat_stats",
                        global_rank=s.info.global_rank,
                        heartbeats=s.hb_count,
                        max_gap_s=round(s.max_hb_gap, 6),
                        timeout_s=self.hb_timeouts.subsequent,
                    )
            writer.close()

    def _dispatch(self, msg):
        try:
            if isinstance(msg, InitMsg):
                return self._on_init(msg)
            if isinstance(msg, HeartbeatMsg):
                return self._on_heartbeat(msg)
            if isinstance(msg, SectionMsg):
                return self._on_section(msg)
            if isinstance(msg, UpdateTimeoutsMsg):
                return self._on_update_timeouts(msg)
            if isinstance(msg, DumpStacksMsg):
                self.request_stack_dump(getattr(msg, "reason", "operator"))
                return OkMsg(payload={"gen": self._dump_gen})
            if isinstance(msg, StatusMsg):
                return OkMsg(payload=self.status())
            return ErrorMsg(f"unknown message {type(msg).__name__}")
        except Exception as e:
            self.log.exception("monitor dispatch failed")
            return ErrorMsg(repr(e))

    def _on_init(self, msg: InitMsg):
        prev = self.session
        self.session = _RankSession(info=msg.rank_info, connected_at=time.monotonic())
        caps = getattr(msg, "capabilities", None)
        if isinstance(caps, dict):
            self.session.dump_signal_ok = bool(caps.get("dump_signal"))
        if prev is not None and prev.info.pid == msg.rank_info.pid:
            # A reconnect re-init (client self-heal) keeps the forensics
            # story: the last beacon must survive the socket blip.
            self.session.location = prev.location
            self.session.location_rx = prev.location_rx
        if msg.client_state:
            hb = msg.client_state.get("hb_timeouts")
            if hb is not None:
                self.hb_timeouts = hb
            st = msg.client_state.get("section_timeouts")
            if st is not None:
                self.section_timeouts = st
        self.log.rank = msg.rank_info.global_rank
        self.log.info(f"monitoring rank {msg.rank_info.global_rank} pid {msg.rank_info.pid}")
        return InitReplyMsg(
            config=self.cfg,
            hb_timeouts=self.hb_timeouts,
            section_timeouts=self.section_timeouts,
        )

    @staticmethod
    def _absorb_location(s: _RankSession, msg, now: float) -> None:
        """Version-skew-tolerant beacon intake: a location-less message from
        an old-build worker (or a non-dict payload from a confused one) is
        simply no update — the watchdog keeps its last good beacon."""
        loc = getattr(msg, "location", None)
        if isinstance(loc, dict):
            s.location = loc
            s.location_rx = now

    def _on_heartbeat(self, msg: HeartbeatMsg):
        if self.session is None:
            return ErrorMsg("heartbeat before init")
        s = self.session
        now = time.monotonic()
        if s.last_hb is not None:
            s.max_hb_gap = max(s.max_hb_gap, now - s.last_hb)
        s.hb_count += 1
        s.last_hb = now
        self._absorb_location(s, msg, now)
        return OkMsg()

    def _on_section(self, msg: SectionMsg):
        if self.session is None:
            return ErrorMsg("section message before init")
        now = time.monotonic()
        s = self.session
        self._absorb_location(s, msg, now)
        if msg.action is SectionAction.OPEN:
            if msg.name in s.open_sections:
                return ErrorMsg(f"section {msg.name!r} already open")
            s.open_sections[msg.name] = now
        elif msg.action is SectionAction.CLOSE:
            if msg.name not in s.open_sections:
                return ErrorMsg(f"section {msg.name!r} not open")
            del s.open_sections[msg.name]
        elif msg.action is SectionAction.CLOSE_ALL:
            s.open_sections.clear()
        s.last_section_activity = now
        return OkMsg()

    def _on_update_timeouts(self, msg: UpdateTimeoutsMsg):
        if msg.hb_timeouts is not None:
            self.hb_timeouts = msg.hb_timeouts
        if msg.section_timeouts is not None:
            self.section_timeouts = msg.section_timeouts
        self.log.info(
            f"timeouts updated: hb={self.hb_timeouts} sections={self.section_timeouts}"
        )
        return OkMsg()

    # -- hang forensics: stack dumps + status -------------------------------

    def request_stack_dump(self, reason: str) -> None:
        """Ask the monitored rank for an all-thread stack dump (loop thread).

        Two delivery paths, because each covers the other's blind spot: the
        parked ``WaitDumpMsg`` long-poll (works when the main thread is stuck
        in a GIL-releasing native call, where a Python signal handler can
        never run) and a SIGUSR1 nudge (works for a rank that skipped the
        listener but installed the signal trigger)."""
        self._dump_gen += 1
        self._dump_reason = reason
        if self._dump_event is not None:
            # set() resolves every currently-parked waiter; the immediate
            # clear() re-arms for the next request (gen-compare catches any
            # request landing between a waiter's polls).
            self._dump_event.set()
            self._dump_event.clear()
        s = self.session
        if s is not None and s.dump_signal_ok and not s.terminated:
            try:
                from tpu_resiliency_torch.utils import stackdump

                os.kill(s.info.pid, stackdump.DUMP_SIGNAL)
            except (ProcessLookupError, PermissionError):
                pass

    async def _wait_dump(self, msg: WaitDumpMsg) -> OkMsg:
        """Park the rank's dump-listener long-poll until the dump generation
        moves past ``seen_gen`` or the poll times out (reply carries the
        current generation either way)."""
        timeout = min(max(float(getattr(msg, "timeout", 0.0) or 0.0), 0.0), 300.0)
        seen = getattr(msg, "seen_gen", 0)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while self._dump_gen == seen:
            remaining = deadline - loop.time()
            if remaining <= 0:
                break
            try:
                await asyncio.wait_for(self._dump_event.wait(), remaining)
            except asyncio.TimeoutError:
                break
        return OkMsg(
            payload={"gen": self._dump_gen, "reason": self._dump_reason or None}
        )

    def _broadcast_dump_request(self, reason: str) -> None:
        """Fan a ``DumpStacksMsg`` out to every sibling monitor socket in this
        run dir — in a collective hang the *waiting* ranks' stacks are as
        diagnostic as the victim's. Best-effort, off the event loop (a stuck
        sibling must not stall our own rank's dump delivery)."""
        pattern = os.path.join(
            os.path.dirname(self.socket_path) or ".", "monitor_*.sock"
        )

        def fan_out() -> None:
            from tpu_resiliency_torch.platform import ipc

            for path in sorted(glob.glob(pattern)):
                if os.path.abspath(path) == os.path.abspath(self.socket_path):
                    continue
                try:
                    sock = ipc.connect(path, timeout=2.0)
                    try:
                        sock.settimeout(2.0)
                        ipc.write_object(sock, DumpStacksMsg(reason=reason))
                        ipc.read_object(sock)
                    finally:
                        sock.close()
                except (OSError, EOFError, ConnectionError):
                    continue

        threading.Thread(
            target=fan_out, name="monitor-dump-fanout", daemon=True
        ).start()

    def status(self) -> dict:
        """The per-rank census document for the launcher's ``/hangz``."""
        s = self.session
        if s is None:
            return {"connected": False}
        now = time.monotonic()
        return {
            "connected": True,
            "rank": s.info.global_rank,
            "pid": s.info.pid,
            "host": s.info.host,
            "terminated": s.terminated,
            "last_hb_age_s": (
                round(now - s.last_hb, 3) if s.last_hb is not None else None
            ),
            "connected_age_s": round(now - s.connected_at, 3),
            "open_sections": {
                name: round(now - opened, 3)
                for name, opened in s.open_sections.items()
            },
            "location": s.location,
            "location_age_s": self._location_age(s, now),
            "hb_timeout_s": self.hb_timeouts.subsequent,
            "kill_pending": s.kill_pending[0] if s.kill_pending else None,
        }

    @staticmethod
    def _location_age(s: _RankSession, now: float) -> Optional[float]:
        """Seconds the rank has been in its beacon's location: the beacon's
        own age at send time plus how long ago we received it."""
        if s.location is None:
            return None
        base = 0.0
        for key in ("barrier_age_s", "section_age_s", "step_age_s"):
            v = s.location.get(key)
            if isinstance(v, (int, float)):
                base = float(v)
                break
        return round(base + max(0.0, now - s.location_rx), 3)

    def _location_line(self, s: _RankSession, now: float) -> str:
        """``; last seen in section=step barrier=... for 612s`` or ''."""
        frag = location_mod.describe(s.location, age_s=self._location_age(s, now))
        return f"; last seen in {frag}" if frag else ""

    # -- periodic checks ---------------------------------------------------

    def _hb_timeout_elapsed(self, now: float) -> Optional[str]:
        s = self.session
        if s.last_hb is None:
            t = self.hb_timeouts.initial
            if t is not None and now - s.connected_at > t:
                return f"no initial heartbeat within {t:.1f}s"
        else:
            t = self.hb_timeouts.subsequent
            if t is not None and now - s.last_hb > t:
                return f"heartbeat gap exceeded {t:.1f}s"
        return None

    def _section_timeout_elapsed(self, now: float) -> Optional[str]:
        s = self.session
        for name, opened in s.open_sections.items():
            t = self.section_timeouts.section.get(name)
            if t is not None and now - opened > t:
                return f"section {name!r} open for more than {t:.1f}s"
        t = self.section_timeouts.out_of_section
        if t is not None and not s.open_sections and s.last_section_activity is not None:
            if now - s.last_section_activity > t:
                return f"out-of-section for more than {t:.1f}s"
        return None

    async def _periodic_check(self) -> None:
        while True:
            await asyncio.sleep(self.cfg.workload_check_interval)
            try:
                s = self.session
                if s is None or s.terminated:
                    continue
                now = time.monotonic()
                if s.kill_pending is not None:
                    # Dump grace in progress: the ladder fires at the
                    # deadline whether or not the dumps landed (a dead rank
                    # must not stay undead because forensics is slow).
                    if now >= s.dump_deadline:
                        self._terminate_rank(*s.kill_pending)
                    continue
                cause = "hang"
                via = "heartbeat"
                reason = self._hb_timeout_elapsed(now)
                if reason is None:
                    reason = self._section_timeout_elapsed(now)
                    via = "section"
                if reason is None and self._health_failure is not None:
                    reason = f"health check failed: {self._health_failure}"
                    cause, via = "health", "health"
                if reason is not None:
                    grace = float(getattr(self.cfg, "stack_dump_grace", 0.0) or 0.0)
                    if cause == "hang" and grace > 0 and getattr(
                        self.cfg, "stack_dump_on_hang", True
                    ):
                        # Capture-before-kill: request stacks from this rank
                        # AND every sibling rank's monitor (the blocked
                        # waiters are half the story), then give the dumps
                        # one grace window before the ladder.
                        s.kill_pending = (reason, cause, via)
                        s.dump_deadline = now + grace
                        self.log.error(
                            f"hang detected for rank {s.info.global_rank} "
                            f"({reason}); capturing stacks for {grace:.1f}s "
                            f"before the kill ladder"
                        )
                        self.request_stack_dump(f"hang: {reason}")
                        self._broadcast_dump_request(
                            f"peer-hang: rank {s.info.global_rank}: {reason}"
                        )
                    else:
                        self._terminate_rank(reason, cause, via)
            except asyncio.CancelledError:
                raise
            except Exception:
                # The checker must survive anything (e.g. os.kill PermissionError on a
                # reused PID) — a dead checker silently disables hang detection.
                self.log.exception("periodic check iteration failed; continuing")

    def _on_health_failure(self, check: HealthCheck) -> None:
        self._health_failure = check.describe()

    def _terminate_rank(self, reason: str, cause: str = "hang", via: str = "?") -> None:
        s = self.session
        s.terminated = True
        now = time.monotonic()
        # Fold the last-known-location beacon into the cause the operator
        # reads: "heartbeat gap exceeded 45s; last seen in section=step
        # barrier=rdzv/round-3 for 612s" answers the postmortem's first
        # question at detection time.
        reason = reason + self._location_line(s, now)
        blocked_s = now - (s.last_hb if s.last_hb is not None else s.connected_at)
        # Distinct kinds: hang (heartbeat/section timeout) vs health (device/node
        # check failure) — consumers triage the two very differently. ``via``
        # splits the hang kind further (heartbeat gap vs section timeout).
        record_event(
            "watchdog",
            "hang_detected" if cause == "hang" else "health_terminated",
            global_rank=s.info.global_rank,
            pid=s.info.pid, reason=reason, via=via,
            blocked_s=round(max(0.0, blocked_s), 3),
            location=s.location,
        )
        # The monitor holds the heartbeat/section story the dying rank cannot
        # tell: snapshot this process's ring before the kill ladder runs, so
        # the incident artifact carries the detection side even if the
        # monitor itself is torn down right after.
        from tpu_resiliency_torch.utils import flight_recorder

        flight_recorder.flush(
            "kill_ladder", detail=f"rank {s.info.global_rank}: {reason}"
        )
        self.restarter.handling_start(f"reason={reason!r}")
        self.log.error(f"terminating rank {s.info.global_rank} (pid {s.info.pid}): {reason}")
        self.restarter.handling_processing()
        try:
            # Each rung of the kill ladder is its own record: the step that
            # actually ended the rank (this signal, or the launcher's later
            # SIGKILL escalation) is reconstructable from the stream.
            os.kill(s.info.pid, signal.SIGCONT)  # wake a stopped process first
            self._record_kill("SIGCONT", s)
            term = self.cfg.rank_termination_signal
            os.kill(s.info.pid, term)
            try:
                term_name = signal.Signals(term).name
            except ValueError:
                term_name = str(term)
            self._record_kill(term_name, s)
        except ProcessLookupError:
            self.log.info("rank process already gone")
        self.restarter.handling_completed()

    @staticmethod
    def _record_kill(step: str, s: _RankSession) -> None:
        record_event(
            "watchdog", "kill_ladder", step=step,
            global_rank=s.info.global_rank, pid=s.info.pid,
        )

    def request_stop(self) -> None:
        if self._stop_event is not None:
            self._stop_event.set()


def _monitor_main(cfg, socket_path, health_checks) -> None:
    # A forked monitor must never touch the card: no CUDA context here (one
    # would hold device memory and block on a hung card). Hiding the cards makes
    # any CUDA call in this process fail instead of opening one.
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    RankMonitorServer(cfg, socket_path, health_checks).run()
