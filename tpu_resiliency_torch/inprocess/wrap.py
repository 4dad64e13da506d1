"""The in-process restart engine: ``Wrapper`` decorator + ``CallWrapper`` loop.

A copy of ``tpu_resiliency/inprocess/wrap.py`` for the port, which drives PyTorch
training functions on the card: the abort chain takes ``AbortTorchDistributed``
(NCCL communicators aborted, process groups destroyed) and the health check
``CudaHealthCheck``; the persistent compilation cache it applies at engine start is
torch.compile's (``platform/compile_cache.py``). Its docstring follows.

Re-design of the reference's ``inprocess/wrap.py`` (``Wrapper:75``, ``CallWrapper:246``,
restart loop ``:394-588``) for JAX/TPU training functions. The contract preserved
(SURVEY §7): any fault — local exception, peer interruption record, monitor soft/hard
timeout, sibling-detected death — routes every surviving rank through

    abort → finalize → health check → iteration barrier → rank reassignment → re-enter

with per-iteration store scoping, while spare (INACTIVE) ranks wait in reserve and
barrier membership stays fixed at the initial world size (dead ranks' barriers are
completed by their monitor proxies — see ``coordination.py``).

What is TPU-native here: the abort chain tears down the JAX distributed client and
compiled-program caches instead of NCCL communicators (``abort.py``); the health check
is a compiled-probe liveness test (``health_check.py``); rank reassignment can use ICI
topology keys (``rank_assignment.Tree``); and the wrapped fn re-creates its mesh and
re-jits against the new world on re-entry (XLA recompiles; weights come back from the
local checkpoint layer).

Faults the engine does NOT try to unwind in place: an XLA program truly stuck on device
has no abort path — the escalation ladder ends with the monitor process signalling the
OS process and the in-job launcher restarting it (same ladder as the reference,
``monitor_process.py:242-258``).
"""

from __future__ import annotations

import dataclasses
import gc
import inspect
import os
import signal
import threading
import time
from typing import Any, Callable, Optional

from tpu_resiliency_torch.exceptions import (
    BarrierOverflow,
    BarrierTimeout,
    HealthCheckError,
    RestartAbort,
    StoreError,
)
from tpu_resiliency_torch.inprocess.attribution import Interruption
from tpu_resiliency_torch.inprocess.coordination import CompletionInterrupted, RestartCoordinator
from tpu_resiliency_torch.inprocess.monitor_process import MonitorConfig, MonitorProcess
from tpu_resiliency_torch.inprocess.monitor_thread import MonitorThread, RankShouldRestart
from tpu_resiliency_torch.inprocess.progress_watchdog import ProgressWatchdog
from tpu_resiliency_torch.inprocess.rank_assignment import (
    RankAssignmentCtx,
    ShiftRanks,
)
from tpu_resiliency_torch.inprocess.state import Mode, State
from tpu_resiliency_torch.platform.store import host_store, store_addr_from_env
from tpu_resiliency_torch.utils import flight_recorder, location
from tpu_resiliency_torch.utils.events import record as record_event
from tpu_resiliency_torch.utils.logging import get_logger
from tpu_resiliency_torch.utils.tracing import span

log = get_logger(__name__)


@dataclasses.dataclass
class Wrapper:
    """Decorator configuring the restart engine (reference ``wrap.py:75-236``).

    Pluggable chains receive and return ``FrozenState`` and may be composed with
    :class:`~tpu_resiliency_torch.inprocess.compose.Compose`. Timeout ordering is validated
    at construction (reference ``wrap.py:184-191``).
    """

    initialize: Optional[Callable] = None
    abort: Optional[Callable] = None
    finalize: Optional[Callable] = None
    health_check: Optional[Callable] = None
    rank_assignment: Callable = dataclasses.field(default_factory=ShiftRanks)
    completion: Optional[Callable] = None
    terminate: Optional[Callable] = None

    monitor_interval: float = 1.0
    last_call_wait: float = 1.0
    soft_timeout: float = 60.0
    hard_timeout: float = 90.0
    heartbeat_interval: float = 1.0
    heartbeat_timeout: float = 30.0
    barrier_timeout: float = 120.0
    completion_timeout: float = 120.0
    termination_signal: int = int(signal.SIGTERM)
    #: How long the rank hosting the coordination server keeps it alive after a
    #: clean completion, so a straggler that was proxy-completed (declared dead
    #: under load but actually alive) can still read ``job_done`` and stand down
    #: instead of crashing on a dead socket.
    server_linger: float = 5.0

    enable_monitor_process: bool = True
    store_host: Optional[str] = None
    store_port: Optional[int] = None
    store_prefix: str = "inprocess/"

    def __post_init__(self) -> None:
        checks = [
            (self.monitor_interval <= self.soft_timeout, "monitor_interval <= soft_timeout"),
            (self.soft_timeout < self.hard_timeout, "soft_timeout < hard_timeout"),
            (self.heartbeat_interval < self.heartbeat_timeout, "heartbeat_interval < heartbeat_timeout"),
            (self.heartbeat_timeout <= self.barrier_timeout, "heartbeat_timeout <= barrier_timeout"),
            (self.hard_timeout <= self.barrier_timeout, "hard_timeout <= barrier_timeout"),
            (self.last_call_wait < self.soft_timeout, "last_call_wait < soft_timeout"),
        ]
        for ok, what in checks:
            if not ok:
                raise ValueError(f"timeout ordering violated: require {what}")

    def __call__(self, fn: Callable) -> Callable:
        def wrapped(*args, **kwargs):
            return CallWrapper(self, fn, args, kwargs).run()

        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        wrapped.__wrapped__ = fn
        return wrapped


class CallWrapper:
    """One wrapped invocation: owns the store, monitors, and the restart loop.

    Public API usable from inside the wrapped fn (injected when the fn has a parameter
    annotated ``CallWrapper`` — reference param injection, ``wrap.py:426-433``):

    - ``atomic()``: reentrant critical section shielded from async restart injection
      (reference ``wrap.py:372-391``).
    - ``ping()``: manual progress mark feeding the watchdog.
    - ``state``: this rank's frozen state (iteration, active rank/world, mode).
    """

    def __init__(self, wrapper: Wrapper, fn: Callable, args: tuple, kwargs: dict):
        self.w = wrapper
        self.fn = fn
        self.fn_args = args
        self.fn_kwargs = kwargs

        self.state = State.from_env()
        self._atomic_lock = threading.RLock()

        # Persistent compilation cache (launcher --compile-cache-dir): applied
        # BEFORE the wrapped fn can trace/compile anything, so a restarted
        # incarnation's first step loads the previous round's executables.
        # One-shot per process; records the compile_cache event
        # (hit / miss / miss_corrupt + bytes) that feeds
        # tpu_compile_cache_total{outcome} and the goodput ledger's restart
        # attribution. Failures degrade to a cold compile, never an error.
        try:
            from tpu_resiliency_torch.platform import compile_cache

            compile_cache.apply_from_env()
        except Exception:
            log.debug("compile cache apply failed", exc_info=True)

        host, port = store_addr_from_env()
        if wrapper.store_host is not None:
            host = wrapper.store_host
        if wrapper.store_port is not None:
            port = wrapper.store_port
        prefix = wrapper.store_prefix
        external = os.environ.get("TPU_RESILIENCY_STORE_EXTERNAL") == "1"
        if external:
            # Layered restart: we run under a launcher that already hosts the
            # coordination store — connect as a client (rank 0 must NOT bind the
            # port again), and scope this incarnation's restart state by the
            # launcher round so a respawned process never sees its dead
            # predecessor's terminated/interrupted records (the in-job ↔
            # in-process coupling, reference ``in_job_and_in_process_example``).
            launcher_round = os.environ.get("TPU_FT_RESTART_COUNT", "0")
            prefix = f"{prefix}r{launcher_round}/"
            # Factory, not the constructor: under a launcher-hosted store
            # CLIQUE ($TPU_RESILIENCY_STORE_SHARDS) every key must route
            # through the same shard map the launcher's clients use.
            from tpu_resiliency_torch.platform.shardstore import connect_store

            self.store = connect_store(host, port, prefix=prefix)
            self.server = None
        else:
            self.store, self.server = host_store(
                self.state.rank, host, port, prefix=prefix
            )
            if self.server is not None:
                # Overwrite, not setdefault: when WE host, the env must carry
                # the port actually bound — a caller-provided "0" (host on an
                # ephemeral port) left in place would send any descendant that
                # resolves store_addr_from_env() to 127.0.0.1:0.
                os.environ["TPU_RESILIENCY_STORE_PORT"] = str(self.server.port)
        # Resolved coordinator address, for the fresh-connection job_done probe a
        # rank makes when its persistent client hits a dead server mid-restart.
        self._store_addr = (
            ("127.0.0.1", self.server.port) if self.server is not None else (host, port)
        )
        self._store_prefix = prefix
        self.coord = RestartCoordinator(self.store, self.state.world_size)

        self.monitor_process: Optional[MonitorProcess] = None
        if wrapper.enable_monitor_process:
            self.monitor_process = MonitorProcess(
                MonitorConfig(
                    rank=self.state.rank,
                    world_size=self.state.world_size,
                    store_host="127.0.0.1" if self.server is not None else host,
                    store_port=self.server.port if self.server is not None else port,
                    store_prefix=wrapper.store_prefix,
                    monitor_interval=wrapper.monitor_interval,
                    heartbeat_interval=wrapper.heartbeat_interval,
                    heartbeat_timeout=wrapper.heartbeat_timeout,
                    soft_timeout=wrapper.soft_timeout,
                    hard_timeout=wrapper.hard_timeout,
                    termination_signal=wrapper.termination_signal,
                )
            )
            self.monitor_process.start()

        self.watchdog = ProgressWatchdog(
            interval=wrapper.heartbeat_interval, report=self._report_progress
        )
        self.watchdog.start()

        # All ranks meet before the first iteration (reference initial_barrier,
        # ``store.py:293``). Span'd: the wait is the cross-rank skew at start
        # (and a straggling peer shows up as THIS rank's long barrier slice).
        with span("inprocess", "barrier.initial", rank=self.state.rank):
            self.store.barrier_join(
                "barrier/initial", self.state.rank, self.state.world_size,
                wrapper.barrier_timeout,
            )

    # -- API exposed to the wrapped fn -------------------------------------

    def atomic(self):
        return self._atomic_lock

    def ping(self) -> None:
        self.watchdog.ping()

    @property
    def frozen_state(self):
        return self.state.freeze()

    @property
    def iteration(self) -> int:
        return self.state.iteration

    # -- internals ---------------------------------------------------------

    def _report_progress(self, kind: str, t: float) -> None:
        if self.monitor_process is not None:
            self.monitor_process.report_timestamp(kind, t)

    def _chain(self, chain: Optional[Callable], frozen):
        return frozen if chain is None else chain(frozen)

    def _maybe_inject_self(self, kwargs: dict) -> dict:
        try:
            sig = inspect.signature(self.fn)
        except (TypeError, ValueError):
            return kwargs
        for name, param in sig.parameters.items():
            if name in kwargs:
                continue
            if param.annotation is CallWrapper or param.annotation == "CallWrapper":
                kwargs = dict(kwargs)
                kwargs[name] = self
        return kwargs

    def _reserve_wait(self, iteration: int) -> bool:
        """INACTIVE spare: wait until some active rank completes or a fault occurs
        (reference ``reserve_fn``, ``wrap.py:57-72``). Returns True if the job
        completed while the coordinator went away (stand down — the caller must
        skip the completion coordination). A transient transport hiccup (server
        still reachable) resumes polling; a genuinely lost coordinator raises
        :class:`RestartAbort` so an idle spare never masks a failed job with a
        clean exit."""
        while True:
            try:
                if self.coord.is_completed(iteration):
                    return False
                if self.coord.is_interrupted(iteration):
                    raise RankShouldRestart
            except StoreError as se:
                done = self._probe_job_done()
                if done is True:
                    return True
                if done is None:
                    raise RestartAbort(
                        f"coordination store lost while in reserve: {se!r}"
                    ) from se
                # Reachable but not done: transient hiccup — keep reserving (the
                # persistent client reconnects on the next call).
            time.sleep(self.w.monitor_interval)

    def _leave(self) -> None:
        """This rank permanently exits the job: peers' barriers are proxied by our
        monitor process from now on."""
        try:
            self.coord.record_terminated([self.state.rank])
        except StoreError:
            pass  # coordinator already gone — nothing left to tell
        self.watchdog.shutdown()
        if self.monitor_process is not None:
            # Dropping the link makes the monitor treat us as dead → barrier proxy.
            self.monitor_process.abandon()

    @staticmethod
    def _quiesce(monitor) -> None:
        """Retry ``monitor.acknowledge()`` through late async deliveries: an
        injection scheduled just before the handler ran can land on the CALL
        bytecode itself or anywhere inside acknowledge — catch it here and go
        again (acknowledge is idempotent). Convergence: every retry re-clears
        ``_armed``/re-sets ``_ack``, and the monitor never schedules a new
        injection once ack is set, so the pending count only falls."""
        while True:
            try:
                monitor.acknowledge()
                return
            except (RankShouldRestart, SystemError):
                continue

    def _terminate_and_leave(self, monitor, state) -> None:
        """Rank-departure cleanup shared by the abort and BaseException exits:
        silence the monitor, run the terminate chain, and leave the job. Full
        quiesce (not a bare acknowledge): this is also the exit for fn-raised
        RestartAbort/HealthCheckError, which bypasses the restart handler's
        quiesce — a pending injection must not tear the terminate chain or the
        record_terminated store write."""
        self._quiesce(monitor)
        try:
            monitor.shutdown()
        except Exception:
            pass
        self._chain(self.w.terminate, state.freeze())
        self._leave()

    def _shutdown_clean(self) -> None:
        try:
            self.coord.set_job_done()
        except Exception:
            pass  # rank 0 may already have torn the server down
        self.watchdog.shutdown()
        if self.monitor_process is not None:
            self.monitor_process.shutdown()
        self.store.close()
        if self.server is not None:
            # All ranks are past the completion barrier. The server lingers briefly
            # (daemon timer; dies with the process either way) so a proxy-completed
            # straggler can still read job_done and stand down cleanly.
            if self.w.server_linger > 0:
                t = threading.Timer(self.w.server_linger, self.server.close)
                t.daemon = True
                t.start()
            else:
                self.server.close()

    def _probe_job_done(self) -> Optional[bool]:
        """The persistent store client hit a transport error. Probe with a fresh
        short-lived connection: ``True`` — job completed without us (we were
        declared dead during a completion round; stand down). ``False`` — server
        reachable, job not done (transient hiccup). ``None`` — coordinator
        unreachable (genuinely lost; surface loudly)."""
        from tpu_resiliency_torch.platform.shardstore import connect_store

        host, port = self._store_addr
        try:
            probe = connect_store(
                host, port, prefix=self._store_prefix, timeout=2.0, connect_retries=2
            )
            try:
                return bool(probe.try_get("job_done", False))
            finally:
                probe.close()
        except StoreError:
            return None

    def _stand_down(self, monitor, iteration: int, reason: str) -> None:
        """Exit cleanly as the odd rank out of a completed job: the coordinator is
        gone and ``job_done`` (or reserve-loss semantics) says the job finished
        without us."""
        log.warning(f"rank {self.state.rank}: standing down (iter {iteration}): {reason}")
        record_event(
            "inprocess", "stood_down", iteration=iteration,
            initial_rank=self.state.initial_rank, reason=reason,
        )
        try:
            monitor.shutdown()
        except Exception:
            pass
        self.watchdog.shutdown()
        if self.monitor_process is not None:
            self.monitor_process.shutdown()
        self.store.close()
        if self.server is not None:
            self.server.close()

    # -- the restart loop --------------------------------------------------

    def _restart_transition(self, monitor, abort_fn, state, iteration: int):
        """Everything between a fault and re-entering the wrapped fn: finalize →
        health check → iteration barrier → rank reassignment → advance.

        Returns the advanced state, or ``None`` when this rank stood down (the
        job completed without it); raises ``RestartAbort``/``HealthCheckError``
        to leave the restart loop."""
        w, coord = self.w, self.coord
        if self.monitor_process is not None:
            self.monitor_process.set_phase("coord")
        monitor.shutdown()
        if abort_fn is not None and not monitor.fired:
            # Local exception path: the monitor thread never ran the abort
            # chain (we acknowledged before it fired) — run it here so abort
            # semantics hold on every restart (reference routes local
            # exceptions through the monitor for the same guarantee).
            with self._atomic_lock:
                abort_fn()
        frozen = state.freeze()
        self._chain(w.finalize, frozen)
        self._chain(w.health_check, frozen)  # raises to exclude this rank
        # Check the terminated set BEFORE joining: a falsely-declared-dead
        # rank's barriers were already proxy-joined, so a waiting join here
        # would overflow rather than surface the real condition.
        try:
            # Job already completed without us? (We were proxy-completed out
            # of a finishing round after being starved.) Checking BEFORE the
            # barrier join is what makes the server_linger rescue work: a
            # straggler that parks on the next round's barrier would only be
            # kicked out at teardown, when the job_done probe can no longer
            # answer.
            if coord.job_done():
                self._stand_down(
                    monitor, iteration, "job completed while this rank restarted"
                )
                return None
            if state.initial_rank in coord.terminated_ranks():
                raise RestartAbort(
                    f"rank {state.initial_rank} was declared terminated by peers"
                )
            try:
                # The barrier wait is where a restart stalls when a peer is
                # slow to unwind — its own slice inside inprocess.restart.
                with span("inprocess", "barrier.iteration", iteration=iteration):
                    coord.join_iteration_barrier(
                        iteration, state.rank, w.barrier_timeout
                    )
            except BarrierOverflow as e:
                # Our slot was proxy-joined between the check and the join.
                raise RestartAbort(
                    f"rank {state.initial_rank} was declared terminated by peers"
                ) from e
            except BarrierTimeout as e:
                raise RestartAbort(
                    f"iteration barrier timed out after {w.barrier_timeout}s: "
                    f"unproxied dead ranks or store loss"
                ) from e
            terminated = coord.terminated_ranks()
            degraded = coord.degraded_ranks()
        except StoreError as se:
            # The coordinator is gone. A rank that was proxy-completed out
            # of a finishing round (declared dead under load but actually
            # alive) lands here when rank 0 tears the store down: stand
            # down if the job completed, abort loudly otherwise.
            if self._probe_job_done() is True:
                self._stand_down(
                    monitor, iteration, "coordinator gone mid-restart; job done"
                )
                return None
            raise RestartAbort(
                f"coordination store lost mid-restart: {se!r}"
            ) from se
        ctx = RankAssignmentCtx(state, terminated, degraded)
        state = w.rank_assignment(ctx).state
        if state.mode == Mode.TERMINATED:
            raise RestartAbort("excluded by rank assignment")
        state.advance()
        state.set_distributed_vars()
        self.state = state
        if state.rank == 0 and iteration > 0:
            # The round-(i) resync barrier released, so nothing can touch
            # round i-1 anymore: reclaim its records/flags/barriers.
            coord.cleanup_iteration(iteration - 1)
        gc.collect()
        return state

    def run(self) -> Any:
        w, state, coord = self.w, self.state, self.coord

        # Initial assignment (reference ``wrap.py:404-406``).
        ctx = RankAssignmentCtx(
            state, coord.terminated_ranks(), coord.degraded_ranks()
        )
        state = w.rank_assignment(ctx).state
        state.set_distributed_vars()

        while True:
            iteration = state.iteration
            coord.publish_iteration(iteration)
            if self.monitor_process is not None:
                self.monitor_process.start_iteration(iteration)

            frozen = state.freeze()
            location.note_step(iteration)
            record_event(
                "inprocess", "iteration_start", iteration=iteration,
                initial_rank=state.initial_rank, active_rank=state.active_rank,
                active_world=state.active_world_size, mode=state.mode.name,
            )
            abort_fn = (
                (lambda: self._chain(w.abort, state.freeze())) if w.abort else None
            )
            monitor = MonitorThread(
                coord,
                iteration,
                threading.main_thread().ident,
                self._atomic_lock,
                abort_fn=abort_fn,
                interval=w.monitor_interval,
                last_call_wait=w.last_call_wait,
            )
            monitor.start()
            restart = False
            try:
                try:
                    self._chain(w.initialize, frozen)
                    state.set_distributed_vars()
                    if self.monitor_process is not None:
                        self.monitor_process.set_phase("running")
                    monitor.arm()
                    if state.mode in (Mode.ACTIVE, Mode.INITIALIZED):
                        kwargs = self._maybe_inject_self(self.fn_kwargs)
                        ret = self.fn(*self.fn_args, **kwargs)
                    else:
                        if self._reserve_wait(iteration):
                            monitor.disarm()
                            self._stand_down(
                                monitor, iteration, "coordinator gone while in reserve"
                            )
                            return None
                        ret = None
                    monitor.disarm()
                    if self.monitor_process is not None:
                        self.monitor_process.set_phase("coord")
                    try:
                        coord.mark_completed(iteration)
                        with span(
                            "inprocess", "barrier.completion", iteration=iteration
                        ):
                            coord.join_completion_barrier(
                                iteration, state.rank, w.completion_timeout
                            )
                    except CompletionInterrupted:
                        # A peer faulted while we were completing; fall back into
                        # the restart path with everyone else immediately — sitting
                        # out the full barrier timeout here would outlast the faulted
                        # rank's iteration-barrier wait and eject a healthy rank.
                        raise RankShouldRestart from None
                    except StoreError as se:
                        # Coordinator died while we completed. If the job is done
                        # (peers completed and tore the store down), our own result
                        # stands; otherwise the loss is fatal (a retry of the
                        # completion join after a half-registered arrival would
                        # overflow, so a reachable-but-unfinished server is fatal
                        # here too).
                        if self._probe_job_done() is True:
                            self._stand_down(
                                monitor, iteration, "coordinator gone at completion"
                            )
                            return ret
                        raise RestartAbort(
                            f"coordination store lost at completion: {se!r}"
                        ) from se
                    self._chain(w.completion, state.freeze())
                    record_event(
                        "inprocess", "completed", iteration=iteration,
                        initial_rank=state.initial_rank,
                    )
                    monitor.shutdown()  # before the store closes under its poll loop
                    self._shutdown_clean()
                    return ret
                except (RestartAbort, HealthCheckError):
                    raise
                except BaseException as e:
                    # ONE handler for every other unwind — restart signal, user
                    # exception, process-leaving BaseException — so the uncovered
                    # async-delivery window is a single handler entry, not three.
                    # Quiesce BEFORE any store traffic: while the monitor is armed,
                    # an injection can land inside the store client and escape this
                    # handler, killing a healthy rank (the round-2 delivery race).
                    # After _quiesce() the thread is acknowledged and drained, so
                    # the coordination calls below cannot be torn.
                    self._quiesce(monitor)
                    if isinstance(e, RankShouldRestart) or (
                        isinstance(e, SystemError) and monitor.fired
                    ):
                        # A mangled delivery (SystemError out of a returning C call
                        # while an injection was pending) is the restart signal it
                        # was meant to be — this rank is healthy.
                        log.info(
                            f"rank {state.rank}: restart signalled (iter {iteration}, {e!r})"
                        )
                        record_event(
                            "inprocess", "restart_signalled", iteration=iteration,
                            initial_rank=state.initial_rank,
                        )
                        restart = True
                    elif isinstance(e, Exception):
                        state.fn_exception = e
                        try:
                            coord.record_interruption(
                                iteration, state.rank, Interruption.EXCEPTION, repr(e)
                            )
                        except StoreError:
                            pass  # dead coordinator: the restart transition resolves it
                        log.warning(
                            f"rank {state.rank}: wrapped fn raised {e!r} (iter {iteration})"
                        )
                        record_event(
                            "inprocess", "fn_exception", iteration=iteration,
                            initial_rank=state.initial_rank, error=repr(e),
                        )
                        # The last seconds before this exception are exactly
                        # what a postmortem wants — snapshot them now, while
                        # this incarnation still owns its ring.
                        flight_recorder.flush("fn_exception", detail=repr(e))
                        restart = True
                    else:
                        # SystemExit / KeyboardInterrupt mean the rank is leaving,
                        # not restarting: record it terminated so peers restart
                        # without us, run the terminate chain, and re-raise
                        # (reference restarts only on Exception; its outer handler
                        # re-raises, ``wrap.py:558``).
                        state.fn_exception = e
                        try:
                            coord.record_interruption(
                                iteration, state.rank, Interruption.TERMINATED, repr(e)
                            )
                        except StoreError:
                            pass  # dead coordinator — still run the local exit path
                        log.warning(
                            f"rank {state.rank}: wrapped fn raised {e!r} — terminating rank"
                        )
                        record_event(
                            "inprocess", "rank_terminated", iteration=iteration,
                            initial_rank=state.initial_rank, error=repr(e),
                        )
                        flight_recorder.flush("rank_terminated", detail=repr(e))
                        self._terminate_and_leave(monitor, state)
                        raise

                # ---- restart path ----
                # One span per restart transition: its duration is the
                # fault→re-entry recovery time (abort chain ran already in the
                # monitor; this covers finalize → health check → barrier →
                # reassignment), the headline the paper's restart benchmarks
                # decompose.
                with span(
                    "inprocess", "inprocess.restart", iteration=iteration,
                    initial_rank=state.initial_rank,
                ):
                    new_state = self._restart_transition(
                        monitor, abort_fn, state, iteration
                    )
                if new_state is None:
                    return None  # stood down: job completed without us
                state = new_state
            except (RestartAbort, HealthCheckError) as e:
                log.error(f"rank {state.rank}: leaving restart loop: {e!r}")
                flight_recorder.flush("restart_abort", detail=repr(e))
                self._terminate_and_leave(monitor, state)
                raise
            finally:
                if not restart and monitor._thread.is_alive():
                    try:
                        monitor.shutdown()
                    except Exception:
                        pass
