"""In-rank client API for workload monitoring.

Analogue of the reference's ``RankMonitorClient`` (``fault_tolerance/rank_monitor_client.py``):
``init_workload_monitoring`` connects to the per-rank monitor socket and receives the
effective config (``:281-321``); ``send_heartbeat`` (``:333``) and
``start_section``/``end_section``/``end_all_sections`` (``:339-367``) are the per-step
signals; ``calculate_and_set_*_timeouts`` auto-calibrate from observed behavior
(``:144-219``); ``state_dict``/``load_state_dict`` persist calculated timeouts across
restarts (``:369-423``); ``send_workload_control_request`` messages the launcher
(``:425``).
"""

from __future__ import annotations

import os
import socket
import threading
from typing import Optional

from tpu_resiliency_torch.exceptions import FaultToleranceError
from tpu_resiliency_torch.platform import ipc
from tpu_resiliency_torch.utils import location as location_mod
from tpu_resiliency_torch.utils import stackdump
from tpu_resiliency_torch.utils.logging import RankLoggerAdapter, get_logger
from tpu_resiliency_torch.watchdog.data import (
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
    UpdateTimeoutsMsg,
    WaitDumpMsg,
    WorkloadAction,
    WorkloadControlRequest,
)
from tpu_resiliency_torch.watchdog.timeouts import TimeoutsCalc

log = get_logger(__name__)

#: server-side park per dump long-poll; the listener's socket timeout rides
#: comfortably above it
DUMP_POLL_S = 20.0


class RankMonitorClient:
    #: reconnect-and-retry attempts per request on a transport fault (the
    #: monitor's UDS link is an out-of-band channel: a reset must not crash the
    #: rank it exists to protect). The server re-inits sessions on reconnect.
    RECONNECT_RETRIES = 2

    def __init__(self, enable_stack_dumps: bool = True):
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._socket_path: Optional[str] = None
        self.rank_info: Optional[RankInfo] = None
        self.cfg = None
        self.hb_timeouts: Optional[HeartbeatTimeouts] = None
        self.section_timeouts: Optional[SectionTimeouts] = None
        self.timeouts_calc: Optional[TimeoutsCalc] = None
        self._loaded_state: Optional[dict] = None
        #: hang forensics: SIGUSR1 trigger + dump-listener long-poll thread
        self.enable_stack_dumps = enable_stack_dumps
        self._dump_stop = threading.Event()
        self._dump_thread: Optional[threading.Thread] = None
        self._dump_sock: Optional[socket.socket] = None
        self.log = RankLoggerAdapter(log, role="client")

    @property
    def is_initialized(self) -> bool:
        return self._sock is not None

    # -- lifecycle ---------------------------------------------------------

    def init_workload_monitoring(
        self,
        socket_path: Optional[str] = None,
        rank_info: Optional[RankInfo] = None,
    ) -> None:
        if self.is_initialized:
            raise FaultToleranceError("workload monitoring already initialized")
        socket_path = socket_path or os.environ.get(ipc.MONITOR_SOCKET_ENV)
        if not socket_path:
            raise FaultToleranceError(
                f"no monitor socket: pass socket_path or set ${ipc.MONITOR_SOCKET_ENV}"
            )
        if rank_info is None:
            rank_info = RankInfo.of_current_process(
                global_rank=int(os.environ.get("RANK", "0")),
                local_rank=int(os.environ.get("LOCAL_RANK", "0")),
            )
        self.rank_info = rank_info
        self.log.rank = rank_info.global_rank
        self._socket_path = socket_path
        # Install the operator dump path BEFORE the session exists: once the
        # monitor sees our InitMsg capabilities it may SIGUSR1 us, so the
        # handler must already be chained (main-thread init only; elsewhere
        # the capability is simply not declared).
        signal_ok = (
            stackdump.install_signal_trigger() if self.enable_stack_dumps else False
        )
        self._sock = ipc.connect(socket_path)
        reply = self._request(InitMsg(
            rank_info=rank_info,
            client_state=self._loaded_state,
            capabilities={
                "dump_signal": signal_ok,
                "dump_poll": self.enable_stack_dumps,
            },
        ))
        if not isinstance(reply, InitReplyMsg):
            raise FaultToleranceError(f"bad init reply: {reply!r}")
        self.cfg = reply.config
        self.hb_timeouts = reply.hb_timeouts
        self.section_timeouts = reply.section_timeouts
        self.timeouts_calc = TimeoutsCalc(safety_factor=self.cfg.safety_factor)
        self.timeouts_calc.reset()
        if self.enable_stack_dumps:
            self._dump_stop.clear()
            self._dump_thread = threading.Thread(
                target=self._dump_listener, args=(socket_path,),
                name="monitor-dump-listener", daemon=True,
            )
            self._dump_thread.start()
        self.log.info(f"workload monitoring initialized via {socket_path}")

    def shutdown_workload_monitoring(self) -> None:
        self._dump_stop.set()
        dump_sock = self._dump_sock
        if dump_sock is not None:
            try:
                dump_sock.close()  # unblocks the listener's parked recv
            except OSError:
                pass
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                finally:
                    self._sock = None

    def _dump_listener(self, socket_path: str) -> None:
        """Long-poll the monitor for stack-dump requests on a DEDICATED
        connection (the shared request socket must stay free for heartbeats).

        This thread is the capture path that works when the main thread is
        parked in a GIL-releasing native wait (a wedged collective,
        ``block_until_ready``) where CPython can never run a signal handler;
        a genuinely GIL-holding hang defers the capture to the next moment
        the GIL frees (see ``utils/stackdump.py``)."""
        seen: Optional[int] = None
        while not self._dump_stop.is_set():
            try:
                sock = ipc.connect(socket_path, timeout=5.0)
            except (OSError, ConnectionError):
                if self._dump_stop.wait(2.0):
                    return
                continue
            self._dump_sock = sock
            try:
                sock.settimeout(DUMP_POLL_S + 30.0)
                while not self._dump_stop.is_set():
                    # First poll syncs to the server's current generation
                    # without dumping: a request fired before we attached
                    # belongs to a previous incarnation.
                    ipc.write_object(
                        sock,
                        WaitDumpMsg(
                            seen_gen=-1 if seen is None else seen,
                            timeout=0.0 if seen is None else DUMP_POLL_S,
                        ),
                    )
                    reply = ipc.read_object(sock)
                    payload = getattr(reply, "payload", None)
                    if not isinstance(payload, dict):
                        continue
                    gen = payload.get("gen")
                    if not isinstance(gen, int):
                        continue
                    if seen is not None and gen != seen:
                        stackdump.dump_stacks(
                            str(payload.get("reason") or "monitor_request")
                        )
                    seen = gen
            except (OSError, EOFError, ConnectionError):
                pass
            finally:
                self._dump_sock = None
                try:
                    sock.close()
                except OSError:
                    pass
            if self._dump_stop.wait(0.5):
                return

    def _request(self, msg):
        """One request/reply round trip, self-healing across transport faults.

        A reset or truncated reply on the monitor link reconnects, replays the
        session ``InitMsg`` (the server rebuilds its ``_RankSession`` — same
        re-init path a fresh client takes), and reissues ``msg`` — bounded by
        :data:`RECONNECT_RETRIES`. Heartbeats and section signals are
        idempotent per-session, so replay is safe; the alternative (raising
        into the training loop) converts a socket blip into a rank death.
        """
        with self._lock:
            if self._sock is None:
                raise FaultToleranceError("monitor client is not initialized")
            for attempt in range(self.RECONNECT_RETRIES + 1):
                try:
                    ipc.write_object(self._sock, msg)
                    reply = ipc.read_object(self._sock)
                    break
                except (OSError, EOFError) as e:
                    if attempt >= self.RECONNECT_RETRIES:
                        raise FaultToleranceError(
                            f"monitor link failed after {attempt + 1} attempts: {e!r}"
                        ) from e
                    self.log.warning(
                        f"monitor link fault ({e!r}); reconnecting "
                        f"({attempt + 1}/{self.RECONNECT_RETRIES})"
                    )
                    try:
                        self._reconnect_locked()
                    except (OSError, EOFError):
                        # Reconnect itself faulted: the next attempt's write
                        # fails fast on the dead socket and burns one retry.
                        pass
        if isinstance(reply, ErrorMsg):
            raise FaultToleranceError(f"monitor error: {reply.error}")
        return reply

    def _reconnect_locked(self) -> None:
        """Dial a fresh connection and re-init the session (lock held). If the
        caller's message WAS an InitMsg the follow-up resend is a harmless
        second re-init."""
        try:
            self._sock.close()
        except OSError:
            pass
        # Short dial budget: a monitor that is genuinely gone should surface
        # within the retry window, not block a train step for 30 s per attempt.
        self._sock = ipc.connect(self._socket_path, timeout=5.0)
        if self.rank_info is not None and self.cfg is not None:
            # Re-establish the session the dead connection carried; skipped
            # during the very first init (no reply processed yet) where the
            # retried InitMsg itself re-inits.
            ipc.write_object(
                self._sock,
                InitMsg(
                    rank_info=self.rank_info,
                    client_state=self.state_dict(),
                    capabilities={
                        "dump_signal": self.enable_stack_dumps
                        and stackdump._trigger_pipe is not None,
                        "dump_poll": self.enable_stack_dumps,
                    },
                ),
            )
            reply = ipc.read_object(self._sock)
            if not isinstance(reply, InitReplyMsg):
                raise FaultToleranceError(f"bad re-init reply: {reply!r}")

    # -- per-step signals --------------------------------------------------

    def send_heartbeat(self) -> None:
        # Every heartbeat carries the last-known-location beacon: the
        # monitor's "last seen in ..." hang diagnosis is only as fresh as the
        # final message that got through before the stall.
        self._request(HeartbeatMsg(
            rank=self.rank_info.global_rank, location=location_mod.snapshot(),
        ))
        self.timeouts_calc.update_on_heartbeat()

    def start_section(self, name: str) -> None:
        location_mod.enter_section(name)
        self._request(SectionMsg(
            rank=self.rank_info.global_rank, action=SectionAction.OPEN,
            name=name, location=location_mod.snapshot(),
        ))
        self.timeouts_calc.update_on_section_open(name)

    def end_section(self, name: str) -> None:
        location_mod.exit_section(name)
        self._request(SectionMsg(
            rank=self.rank_info.global_rank, action=SectionAction.CLOSE,
            name=name, location=location_mod.snapshot(),
        ))
        self.timeouts_calc.update_on_section_close(name)

    def end_all_sections(self) -> None:
        location_mod.exit_section(None)
        self._request(SectionMsg(
            rank=self.rank_info.global_rank, action=SectionAction.CLOSE_ALL,
            location=location_mod.snapshot(),
        ))
        for name in list(self.timeouts_calc.section_open_since):
            self.timeouts_calc.update_on_section_close(name)

    # -- timeout calibration ----------------------------------------------

    def calculate_and_set_hb_timeouts(
        self, store=None, rank: int = 0, world_size: int = 1
    ) -> HeartbeatTimeouts:
        """safety_factor × max observed gaps (cross-rank MAX via store when given),
        EMA-merged with previous calculated values, pushed to the monitor."""
        self.timeouts_calc.synchronize_all(store, rank, world_size)
        new = self.timeouts_calc.get_hb_timeouts(previous=self.hb_timeouts)
        self.hb_timeouts = new
        self._request(UpdateTimeoutsMsg(hb_timeouts=new))
        return new

    def calculate_and_set_section_timeouts(
        self, store=None, rank: int = 0, world_size: int = 1
    ) -> SectionTimeouts:
        self.timeouts_calc.synchronize_all(store, rank, world_size)
        new = self.timeouts_calc.get_section_timeouts(previous=self.section_timeouts)
        self.section_timeouts = new
        self._request(UpdateTimeoutsMsg(section_timeouts=new))
        return new

    # -- persistence -------------------------------------------------------

    def state_dict(self) -> dict:
        return {
            "hb_timeouts": self.hb_timeouts,
            "section_timeouts": self.section_timeouts,
        }

    def load_state_dict(self, state: dict) -> None:
        """Apply persisted calculated timeouts; if already connected, push them to the
        monitor immediately, otherwise they ride the next InitMsg."""
        self._loaded_state = state
        if self.is_initialized:
            hb = state.get("hb_timeouts")
            st = state.get("section_timeouts")
            if hb is not None:
                self.hb_timeouts = hb
            if st is not None:
                self.section_timeouts = st
            self._request(UpdateTimeoutsMsg(hb_timeouts=hb, section_timeouts=st))

    # -- launcher control --------------------------------------------------

    def send_workload_control_request(
        self, action: WorkloadAction, reason: str = ""
    ) -> None:
        """Fire a control request at the launcher's IPC socket
        (reference ``rank_monitor_client.py:425``)."""
        path = os.environ.get(ipc.LAUNCHER_SOCKET_ENV)
        if not path:
            raise FaultToleranceError(f"${ipc.LAUNCHER_SOCKET_ENV} is not set")
        ipc.send_to(
            path, WorkloadControlRequest(action=action, sender=self.rank_info, reason=reason)
        )
