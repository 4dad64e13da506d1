"""Out-of-process watcher: one daemonized monitor per rank.

Analogue of reference ``inprocess/monitor_process.py`` (double-fork ``daemonize_fn``
``:78-118``, message protocol ``:37-44``, soft/hard timeout enforcement ``:242-258``,
dead-main barrier completion ``:260-282``) fused with ``sibling_monitor.py`` (ring
heartbeat ``:26-57,110-151``) — on TPU hosts both jobs are host-side watchers over the
same store, so they share one loop.

The monitor is double-forked (setsid between forks) so it survives its rank's death and
is outside the rank's process group — a SIGKILL storm that takes out the trainer leaves
the watcher standing. It talks to its rank over an inherited socketpair:

- ``{"kind":"ts"}``            progress timestamps from the :class:`ProgressWatchdog`
- ``{"kind":"phase"}``         ``running`` (fn active; soft/hard timeouts armed) vs
                               ``coord`` (restart coordination; timeouts suspended —
                               barrier/store timeouts cover that phase)
- ``{"kind":"iter"}``          iteration starts
- ``{"kind":"shutdown"}``      clean exit

Duties each tick: forward own heartbeat into the store; watch the ring neighbor's
heartbeat (rank+1 mod N) and report it UNRESPONSIVE when stale, completing barriers on
its behalf; enforce soft (record interruption) and hard (record terminated + SIGCONT +
termination signal, then SIGKILL) progress timeouts; on main-process death, become its
barrier proxy: mark it terminated and complete every subsequent iteration's barriers
until the job ends.
"""

from __future__ import annotations

import dataclasses
import os
import select
import signal
import socket
import time
from typing import Optional

from tpu_resiliency_torch.inprocess.attribution import Interruption
from tpu_resiliency_torch.inprocess.coordination import RestartCoordinator
from tpu_resiliency_torch.platform import framing
from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)


@dataclasses.dataclass
class MonitorConfig:
    rank: int
    world_size: int
    store_host: str
    store_port: int
    store_prefix: str
    monitor_interval: float = 1.0
    heartbeat_interval: float = 1.0
    heartbeat_timeout: float = 30.0
    soft_timeout: float = 60.0
    hard_timeout: float = 90.0
    termination_signal: int = int(signal.SIGTERM)
    sigkill_grace: float = 15.0
    auth_key: Optional[str] = None
    #: monitor log destination; None = /dev/null (a detached daemon MUST drop the
    #: inherited stdio — holding the parent's pipes open makes `cmd | tail` style
    #: consumers wait forever for EOF)
    log_file: Optional[str] = None
    #: proxy gives up when the job makes no progress for this long (defense in depth
    #: against orphan daemons outliving a wedged job)
    proxy_idle_limit: float = 600.0


class MonitorProcess:
    """Parent-side handle: forks the daemonized watcher and streams messages to it."""

    def __init__(self, cfg: MonitorConfig):
        self.cfg = cfg
        self._sock: Optional[socket.socket] = None
        self.pid: Optional[int] = None

    def start(self) -> None:
        parent_sock, child_sock = socket.socketpair()
        main_pid = os.getpid()
        first = os.fork()
        if first == 0:
            # First child: new session, fork again, exit — grandchild is reparented
            # to init and detached from the rank's session/process group.
            try:
                parent_sock.close()
                os.setsid()
                second = os.fork()
                if second == 0:
                    try:
                        _detach_stdio(self.cfg.log_file)
                        # Drop every other inherited fd — most critically rank 0's
                        # KVServer listening socket: holding it would keep the store
                        # port bound (EADDRINUSE on relaunch) and park peers'
                        # reconnects in a dead socket's backlog after the rank dies.
                        _close_fds_except({child_sock.fileno(), 0, 1, 2})
                        _monitor_loop(self.cfg, child_sock, main_pid)
                    finally:
                        os._exit(0)
            finally:
                os._exit(0)
        child_sock.close()
        os.waitpid(first, 0)  # reap the intermediate child
        self._sock = parent_sock

    def _send(self, msg: dict) -> None:
        if self._sock is None:
            return
        try:
            framing.send_obj(self._sock, msg)
        except (BrokenPipeError, ConnectionError, OSError):
            log.warning("monitor process link lost")
            self._sock = None

    def report_timestamp(self, kind: str, t: float) -> None:
        self._send({"kind": "ts", "source": kind, "t": t})

    def set_phase(self, phase: str) -> None:
        self._send({"kind": "phase", "phase": phase})

    def start_iteration(self, iteration: int) -> None:
        self._send({"kind": "iter", "iteration": iteration})

    def shutdown(self) -> None:
        self._send({"kind": "shutdown"})
        self.abandon()

    def abandon(self) -> None:
        """Drop the link without a goodbye: the monitor sees EOF, treats the rank as
        dead, and becomes its barrier proxy — how a rank leaves the job for good."""
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None


def _detach_stdio(log_file: Optional[str]) -> None:
    """Drop inherited stdio: a reparented daemon keeping the parent's stdout pipe
    open blocks every downstream pipe reader's EOF."""
    devnull = os.open(os.devnull, os.O_RDWR)
    if log_file:
        target = os.open(log_file, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    else:
        target = devnull
    os.dup2(devnull, 0)
    os.dup2(target, 1)
    os.dup2(target, 2)
    if target is not devnull and target > 2:
        os.close(target)
    if devnull > 2:
        os.close(devnull)


def _close_fds_except(keep: set[int]) -> None:
    """Close every open fd not in `keep` (the daemonization hygiene step)."""
    try:
        open_fds = [int(fd) for fd in os.listdir("/proc/self/fd")]
    except OSError:
        open_fds = range(3, 1024)
    for fd in open_fds:
        if fd in keep:
            continue
        try:
            os.close(fd)
        except OSError:
            pass


def _monitor_loop(cfg: MonitorConfig, sock: socket.socket, main_pid: int) -> None:
    """Watcher body (grandchild process)."""
    from tpu_resiliency_torch.platform.shardstore import connect_store

    try:
        store = connect_store(
            cfg.store_host,
            cfg.store_port,
            prefix=cfg.store_prefix,
            timeout=60.0,
            auth_key=cfg.auth_key,
        )
    except Exception:
        log.exception("monitor: cannot connect to store; exiting")
        return
    coord = RestartCoordinator(store, cfg.world_size)

    last_ts = time.monotonic()
    phase = "coord"
    iteration = 0
    main_dead = False
    soft_reported_iter: Optional[int] = None
    hard_fired_at: Optional[float] = None
    reported_stale: set[int] = set()
    last_hb = 0.0
    consecutive_failures = 0

    def now() -> float:
        return time.monotonic()

    while True:
        # -- receive messages from the rank --------------------------------
        if not main_dead:
            try:
                ready, _, _ = select.select([sock], [], [], cfg.monitor_interval)
            except OSError:
                ready = []
            if ready:
                try:
                    msg = framing.recv_obj(sock)
                except (EOFError, ConnectionError, OSError):
                    main_dead = True
                    msg = None
                if msg is not None:
                    kind = msg.get("kind")
                    if kind == "ts":
                        last_ts = now()
                    elif kind == "phase":
                        phase = msg["phase"]
                        last_ts = now()
                    elif kind == "iter":
                        iteration = msg["iteration"]
                        soft_reported_iter = None
                        hard_fired_at = None
                        last_ts = now()
                    elif kind == "shutdown":
                        log.info(f"monitor[{cfg.rank}]: clean shutdown")
                        return
        else:
            time.sleep(cfg.monitor_interval)

        try:
            # -- own heartbeat + sibling ring -------------------------------
            if now() - last_hb >= cfg.heartbeat_interval:
                coord.heartbeat(cfg.rank)
                last_hb = now()
                if cfg.world_size > 1:
                    _check_peers(cfg, coord, reported_stale)

            if coord.job_done():
                log.info(f"monitor[{cfg.rank}]: job done; exiting")
                return

            cur = coord.current_iteration()
            if cur is not None and cur > iteration and main_dead:
                iteration = cur

            # -- main-process death: become the rank's barrier proxy --------
            if not main_dead and not _pid_alive(main_pid):
                main_dead = True
            if main_dead:
                coord.record_terminated([cfg.rank])
                coord.record_interruption(
                    iteration if cur is None else cur,
                    cfg.rank,
                    Interruption.TERMINATED,
                    "main process exited",
                )
                _proxy_barriers_until_done(cfg, coord, iteration)
                return

            # -- progress timeouts (only while the wrapped fn runs) ---------
            stale = now() - last_ts
            if phase == "running":
                if stale > cfg.hard_timeout and hard_fired_at is None:
                    log.error(
                        f"monitor[{cfg.rank}]: hard timeout ({stale:.1f}s); signalling"
                    )
                    coord.record_interruption(
                        iteration, cfg.rank, Interruption.HARD_TIMEOUT, f"{stale:.1f}s"
                    )
                    coord.record_terminated([cfg.rank])
                    coord.complete_barriers_for(iteration, cfg.rank)
                    _signal_rank(main_pid, cfg.termination_signal)
                    hard_fired_at = now()
                elif stale > cfg.soft_timeout and soft_reported_iter != iteration:
                    log.warning(
                        f"monitor[{cfg.rank}]: soft timeout ({stale:.1f}s); reporting"
                    )
                    coord.record_interruption(
                        iteration, cfg.rank, Interruption.SOFT_TIMEOUT, f"{stale:.1f}s"
                    )
                    soft_reported_iter = iteration
            if hard_fired_at is not None and now() - hard_fired_at > cfg.sigkill_grace:
                if _pid_alive(main_pid):
                    log.error(f"monitor[{cfg.rank}]: escalating to SIGKILL")
                    _signal_rank(main_pid, signal.SIGKILL)
                hard_fired_at = now() + 3600.0  # fire SIGKILL once
            consecutive_failures = 0
        except Exception:
            # The watcher must outlive *transient* store failures — but a store
            # that never comes back (rank 0 died) means the job is over; a
            # detached daemon must not spin forever.
            consecutive_failures += 1
            if consecutive_failures >= 30:
                log.error(
                    f"monitor[{cfg.rank}]: store unreachable for "
                    f"{consecutive_failures} ticks; assuming job over"
                )
                return
            log.exception(f"monitor[{cfg.rank}]: tick failed; continuing")


def _check_peers(
    cfg: MonitorConfig,
    coord: RestartCoordinator,
    reported_stale: set[int],
) -> None:
    """Watch every peer's heartbeat; report and barrier-proxy stale ones.

    A pure ring (watch rank+1 only) leaves ranks unwatched when a whole host with
    multiple ranks dies — their watchers die with them and their barriers are never
    proxied, deadlocking the survivors. So every watcher asks the server for the
    *stale set*: ages are computed against the server clock (immune to cross-host
    NTP offset) and the response carries only stale ranks, keeping N watchers' polls
    O(stale) on the wire instead of O(N²) full-table scans. Duplicate reports from
    concurrent watchers are tolerated: termination is a set union and on-behalf
    barrier joins are idempotent.
    """
    stale_now = coord.stale_peers(cfg.heartbeat_timeout)
    reported_stale.difference_update(
        r for r in list(reported_stale) if r not in stale_now
    )
    terminated: Optional[frozenset[int]] = None
    cur = coord.current_iteration()
    for peer, age in stale_now.items():
        if peer == cfg.rank:
            continue
        if terminated is None:
            terminated = coord.terminated_ranks()
        if peer in terminated:
            # Known-dead: don't re-report (spurious restarts), but keep proxying —
            # its own monitor may have died with the host.
            if cur is not None:
                coord.complete_barriers_for(cur, peer)
            continue
        if peer not in reported_stale:
            log.error(
                f"monitor[{cfg.rank}]: rank {peer} heartbeat stale "
                f"({age:.1f}s); reporting UNRESPONSIVE"
            )
            coord.record_interruption(
                cur or 0, peer, Interruption.UNRESPONSIVE, f"heartbeat stale {age:.1f}s"
            )
            coord.record_terminated([peer])
            reported_stale.add(peer)
        if cur is not None:
            coord.complete_barriers_for(cur, peer)


def _proxy_barriers_until_done(
    cfg: MonitorConfig, coord: RestartCoordinator, start_iteration: int
) -> None:
    """After main death: complete every iteration's barriers until the job ends."""
    iteration = start_iteration
    last_progress = time.monotonic()
    while time.monotonic() - last_progress < cfg.proxy_idle_limit:
        try:
            coord.complete_barriers_for(iteration, cfg.rank)
            if coord.job_done():
                return
            cur = coord.current_iteration()
            if cur is not None and cur > iteration:
                iteration = cur
                last_progress = time.monotonic()
                continue
        except Exception:
            # Store gone ⇒ the job is over.
            return
        time.sleep(cfg.monitor_interval)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


def _signal_rank(pid: int, sig: int) -> None:
    try:
        os.kill(pid, signal.SIGCONT)  # wake a stopped process first
        os.kill(pid, sig)
    except (ProcessLookupError, PermissionError) as e:
        log.warning(f"signal {sig} to pid {pid} failed: {e!r}")
