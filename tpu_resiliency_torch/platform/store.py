"""Coordination key-value store with first-class distributed barriers.

This is the control-plane substrate of the framework — the TPU-native re-design of the
reference's ``torch.distributed.TCPStore`` + ``StoreMixin`` barrier protocol
(``inprocess/store.py:48-368``) and of the c10d store used by its rendezvous. Unlike the
reference, which builds barriers *client-side* out of add/get primitives (and needs careful
key hygiene, overflow checks, and "monitor completes the barrier for dead ranks" tricks),
this store implements barriers, sets, lists and heartbeats as *server-side* operations:

- reentrant generation-counted barriers (the reference's ``reentrant_barrier``,
  ``iteration_barrier``, ``termination_barrier``; ``store.py:180-311``),
- joining a barrier **on behalf of another rank** without blocking — how a monitor process
  completes barriers for a dead main process (reference ``monitor_process.py:260-282``),
- interruption records and terminated-rank sets (``store.py`` record APIs),
- per-rank heartbeat timestamps with prefix scans (``sibling_monitor.py:26-57``).

Security: frames are pickled, so deserialization is code execution. The server therefore
binds loopback-only unless an ``auth_key`` is provided, in which case every connection
must complete an HMAC-SHA256 challenge/response before any frame is processed (the
analogue of the reference's ``AuthkeyMsg`` handshake, ``fault_tolerance/data.py:141``).
The launcher generates the key and hands it to workers via ``TPU_RESILIENCY_STORE_KEY``.

Concurrency: each client keeps one persistent socket for fast non-blocking ops; any
operation that may block server-side for more than a few seconds (barrier joins, waiting
``get``\\ s) runs on its own one-shot connection so heartbeats and other control traffic
are never starved behind it. A transport error invalidates the persistent socket (framing
can no longer be trusted); the next call transparently reconnects.

Rank 0 hosts the server in-process, exactly as the reference's rank 0 hosts the TCPStore
(``inprocess/store.py:311,345-353``). This store carries only small control messages
(bytes–KBs at restart boundaries); per-step telemetry rides the ICI mesh as JAX
collectives instead (see ``telemetry``).
"""

from __future__ import annotations

import collections
import dataclasses
import errno
import hashlib
import hmac
import itertools
import os
import secrets
import selectors
import socket
import threading
import time
from typing import Any, Callable, Iterable, Optional

from tpu_resiliency_torch.exceptions import (
    BarrierOverflow,
    BarrierTimeout,
    StoreError,
    StoreShutdownError,
    StoreTimeoutError,
    StoreTransportError,
)
from tpu_resiliency_torch.platform import chaos, framing
from tpu_resiliency_torch.utils.events import record as record_event
from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)

AUTH_KEY_ENV = "TPU_RESILIENCY_STORE_KEY"

#: Serving-backend identity reported by ``store_stats`` (``backend`` field).
#: The thread-per-connection ancestor predates the field, so readers map a
#: missing field to ``"threaded"`` — version-skew stays one `.get()` away.
BACKEND = "epoll"

# Ops whose server-side wait can exceed this run on a dedicated one-shot connection so
# they never hold the persistent socket's lock across a long block.
_BLOCKING_THRESHOLD_S = 5.0

_LOOPBACK_HOSTS = ("127.0.0.1", "localhost", "::1", "")

#: Ops whose server-side effect is safe to apply twice: the client transparently
#: reconnect-and-retries these on a transport failure (a lost *response* just
#: repeats the read/overwrite). Mutations here are last-writer-wins (set/touch)
#: or set-union (set_add) — reapplication is a no-op.
_IDEMPOTENT_OPS = frozenset({
    "ping", "get", "getv", "check", "set", "delete", "touch", "stale",
    "prefix_get", "prefix_clear", "num_keys", "keys", "barriers",
    "wait_changed", "list_get", "list_clear", "set_get", "set_add",
    "barrier_status", "barrier_del", "barrier_census", "store_stats",
})

#: Ops where a blind retry double-applies (increment, append, CAS, barrier
#: arrival): the client mints a per-call ``req_id`` nonce and the server dedups
#: (bounded LRU), giving at-most-once application under the same retry loop.
_NONIDEMPOTENT_OPS = frozenset({"add", "cas", "list_append", "barrier"})
assert not (_IDEMPOTENT_OPS & _NONIDEMPOTENT_OPS)

#: Server-side request-dedup LRU capacity. Sized for in-flight retries, not
#: history: an entry is only ever consulted within one client call's retry
#: budget (seconds), and each entry is a small response dict.
_DEDUP_MAX = 4096


def _retry_event(op: str, outcome: str) -> None:
    """One ``store_retry`` record per retry decision (→
    ``tpu_store_retries_total{op,outcome}`` via the events→metrics bridge).
    Retries only happen on transport faults, so the volume is per-fault, not
    per-op."""
    record_event("store", "store_retry", op=op, outcome=outcome)


#: Process-wide circuit breakers, keyed by (host, port): the monotonic instant
#: until which calls to that endpoint fail fast instead of burning a retry
#: budget. An agent holds several clients to one store (rendezvous, jobs
#: registry, restart watcher); when the store host legitimately exits, ONE of
#: them paying one budget is diagnosis enough — teardown must not serialize
#: N × retry_budget of sleeps. Shared state, not per-client, for that reason.
_breakers: dict[tuple[str, int], float] = {}
#: Consecutive trips per endpoint since the last success. Each re-trip doubles
#: the cooldown (capped): an endpoint that stays dead gets probed with
#: exponentially decaying frequency instead of costing one full retry budget
#: per cooldown window — under HA failover routing that re-probe IS the
#: steady-state degraded tail, so its frequency is the p95.
_breaker_streaks: dict[tuple[str, int], int] = {}
_breakers_lock = threading.Lock()
_BREAKER_COOLDOWN_CAP = 30.0


def _breaker_open(host: str, port: int) -> bool:
    with _breakers_lock:
        return time.monotonic() < _breakers.get((host, port), 0.0)


def _breaker_trip(host: str, port: int, cooldown: float) -> None:
    with _breakers_lock:
        streak = _breaker_streaks.get((host, port), 0) + 1
        _breaker_streaks[(host, port)] = streak
        eff = min(cooldown * (2 ** min(streak - 1, 16)),
                  max(cooldown, _BREAKER_COOLDOWN_CAP))
        _breakers[(host, port)] = time.monotonic() + eff


def _breaker_clear(host: str, port: int) -> None:
    with _breakers_lock:
        _breakers.pop((host, port), None)
        _breaker_streaks.pop((host, port), None)


def breaker_open(host: str, port: int) -> bool:
    """Public read-only view of the endpoint circuit breaker. The HA clique
    client (``platform/shardstore.py``) routes around a shard whose breaker
    is open — straight to the successor replica — instead of paying even the
    fail-fast round trip on every op while the shard is down."""
    return _breaker_open(host, port)


def _hmac(key: str, nonce: bytes) -> bytes:
    return hmac.new(key.encode(), nonce, hashlib.sha256).digest()


def _client_hello(sock: socket.socket, auth_key: str | None) -> None:
    """Client side of the server hello (+ optional HMAC challenge). The ONE
    definition of the wire handshake shared by the persistent client and the
    liveness probe — a protocol change updated in only one place would make
    ``store_answers`` silently report every live store as dead."""
    hello = framing.recv_obj(sock, max_frame=1024)
    if not isinstance(hello, dict) or "auth" not in hello:
        raise StoreError("malformed store hello")
    if hello["auth"]:
        if not auth_key:
            raise StoreError(
                f"store requires authentication; set ${AUTH_KEY_ENV} or pass auth_key"
            )
        framing.send_obj(sock, {"mac": _hmac(auth_key, hello["nonce"])})


@dataclasses.dataclass
class _Barrier:
    generation: int = 0
    arrived: set = dataclasses.field(default_factory=set)
    world_size: int = 0
    #: ranks marked absent by on-behalf (proxy) joins — sticky across generations:
    #: a dead rank stays dead for every subsequent round of this barrier name, so
    #: watchers need not — but may, idempotently — re-proxy each round. Reset when a
    #: round opens with a different world size (elastic membership change).
    absent: set = dataclasses.field(default_factory=set)
    #: world size of the last round that opened, for detecting elastic changes
    last_world: int = 0
    #: per-rank arrival instants of the in-progress round (server monotonic) —
    #: the ``barrier_census`` waiter-age source; cleared on release
    arrived_at: dict = dataclasses.field(default_factory=dict)
    #: when the in-progress round opened (first join); 0 between rounds
    opened_at: float = 0.0


@dataclasses.dataclass
class _Park:
    """A blocking request parked on the event loop under a wait key: re-checked
    when that key is notified by a mutation (``ready`` returns the response once
    satisfied) and expired at ``deadline`` (responding ``{"status": "timeout"}``)."""

    ready: Callable[[], Optional[dict]]
    deadline: float
    wait_key: tuple


class _Conn:
    """Per-connection state on the event loop: incremental frame parser, pending
    write buffer, auth state, and at most one parked request (the client protocol
    is strictly request/response per socket)."""

    __slots__ = ("sock", "rbuf", "wbuf", "awaiting_mac", "nonce", "park",
                 "auth_deadline", "recv_ts", "frame_bytes")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.rbuf = bytearray()
        self.wbuf = bytearray()
        self.awaiting_mac = False
        self.nonce: bytes = b""
        self.park: Optional[_Park] = None
        self.auth_deadline: float = 0.0
        #: op-telemetry stamps: when the request's bytes landed on the socket
        #: (queue wait = dispatch - recv_ts) and the parsed frame's wire size
        self.recv_ts: float = 0.0
        self.frame_bytes: int = 0


class KVServer:
    """Event-loop TCP server holding the coordination state.

    One instance per job, hosted by the coordinator (rank 0 or the launcher). A
    single selector thread owns all state — no locks, no thread-per-connection:
    every operation is a pure in-memory mutation, and operations that must wait
    (``get`` with a timeout, blocking barrier joins) are *parked* as continuations
    re-evaluated after each mutation instead of parking a thread in a condition
    wait. Thousands of persistent connections therefore cost file descriptors, not
    stacks, and the op rate is bounded by one core's dict-op throughput rather than
    lock convoys.

    **Scale model (measured — ``tests/platform/test_store_scale.py``):** on one
    modest host, 1024 → 4096 live persistent clients: connect storm 0.14 → 0.37 s,
    ~26k small ops/s *flat in client count* (idle connections cost nothing per
    op — parked-deadline scans touch only parked requests), full-world barrier
    release 0.05 → 0.30 s, batched world-size prefix scan 1.3 → 4.2 ms. Every hot
    path batches (``prefix_get``, server-side ``stale_keys`` scans, per-round
    namespace GC) so per-tick traffic is O(1) requests per rank, not per key.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        auth_key: str | None = None,
        auth_timeout: float = 30.0,
        stats_enabled: bool = True,
        stats_interval: float = 10.0,
    ):
        if auth_key is None:
            auth_key = os.environ.get(AUTH_KEY_ENV) or None
        if host not in _LOOPBACK_HOSTS and not auth_key:
            raise ValueError(
                f"refusing to bind KVServer on non-loopback {host!r} without an auth_key "
                f"(frames are pickled; unauthenticated exposure is remote code execution). "
                f"Pass auth_key= or set ${AUTH_KEY_ENV}."
            )
        self.auth_key = auth_key
        self.auth_timeout = auth_timeout
        self._data: dict[str, Any] = {}
        #: key → value of the GLOBAL mutation clock at the key's last write
        #: (set/add/cas/touch bump it): ``wait_changed`` parks against it so
        #: clients can watch a key for ANY change — including back to a
        #: previously-seen value — without polling. Deletion drops the entry
        #: (version reverts to 0, itself a visible change, and the global
        #: clock makes a later re-create differ from every earlier version),
        #: so the table's size is bounded by live keys. One blind spot by
        #: design: a create+delete pair completing entirely between a
        #: watcher's reads looks like "never existed".
        self._versions: dict[str, int] = {}
        self._version_clock = 0
        self._lists: dict[str, list] = {}
        self._sets: dict[str, set] = {}
        self._barriers: dict[str, _Barrier] = {}
        self._stale_cache: dict[tuple[str, float], tuple[float, dict]] = {}
        #: request-dedup LRU: req_id → ("resp", response_dict) once the
        #: response exists, or ("barrier", (name, gen)) while a blocking join
        #: that already *applied* its arrival is still parked. Gives retried
        #: non-idempotent ops (add/cas/list_append/barrier) at-most-once
        #: application across reconnects: apply + cache happen atomically on
        #: the single loop thread, so a retry either replays the cached
        #: response or finds nothing applied at all.
        self._dedup: collections.OrderedDict[str, tuple] = collections.OrderedDict()
        self._shutdown = threading.Event()
        #: op telemetry (utils/opstats.py): loop-thread-owned, lock-free. A
        #: collector exception disables stats for the server's lifetime and
        #: degrades the store_stats document — never the op path.
        self._opstats = None
        self._stats_error: Optional[str] = None
        self.stats_interval = stats_interval
        self._last_stats_emit = time.monotonic()
        #: countdown to the next sampled (clocked) op; starts at 1 so the
        #: very first op is sampled and a short-lived store gets quantiles.
        #: The reload is jittered (LCG) — a fixed stride aliases with
        #: periodic workloads (a strict set/get alternation would put EVERY
        #: sample on the same op and double-count it).
        self._stats_tick = 1
        self._stats_seed = 0x5EED
        #: set by a sampled op so _send attributes exactly that op's
        #: response bytes (scaled); False costs one short-circuit per send
        self._stats_armed = False
        if stats_enabled:
            from tpu_resiliency_torch.utils.opstats import OpStats

            self._opstats = OpStats()

        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # A fixed port may still be held by a previous job's lingering server
        # (wrap.py server_linger keeps it listening briefly after completion) or
        # by a close() whose loop thread has not yet released the fd —
        # SO_REUSEADDR does not allow a second live listener. Retry briefly so
        # back-to-back jobs on one host don't die on EADDRINUSE.
        deadline = time.monotonic() + (8.0 if port != 0 else 0.0)
        while True:
            try:
                self._sock.bind((host, port))
                break
            except OSError as e:
                if e.errno != errno.EADDRINUSE or time.monotonic() >= deadline:
                    raise
                time.sleep(0.25)
        self._sock.listen(1024)
        self._sock.setblocking(False)
        self.port = self._sock.getsockname()[1]
        self.host = host

        # Self-pipe so close() (any thread) can wake the loop immediately.
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)

        # Reserve fd for fd-exhaustion shedding: when accept() hits EMFILE, the
        # pending connection would re-fire the level-triggered selector forever.
        # Closing the reserve frees one fd to accept-and-close the peer (it sees a
        # clean disconnect and can retry), then the reserve is reopened.
        try:
            self._reserve_fd = os.open(os.devnull, os.O_RDONLY)
        except OSError:
            self._reserve_fd = None

        self._sel = selectors.DefaultSelector()
        self._sel.register(self._sock, selectors.EVENT_READ, "accept")
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        self._conns: dict[socket.socket, _Conn] = {}
        self._parked: set[_Conn] = set()  # conns with a parked request (O(parked) scans)
        #: wait-key → parked conns; mutations notify only their own key's waiters,
        #: so a full-world blocking barrier does not tax unrelated traffic.
        self._waiters: dict[tuple, set[_Conn]] = {}
        self._awaiting_auth: set[_Conn] = set()

        self._loop_thread = threading.Thread(
            target=self._loop, name="kvstore-loop", daemon=True
        )
        self._loop_thread.start()

    # -- lifecycle ---------------------------------------------------------

    def close(self, join: bool = True, timeout: float = 5.0) -> None:
        """Signal the loop thread to tear down. With ``join`` (default) block
        until the listening socket is actually released, so a successor server
        can bind the same fixed port immediately."""
        self._shutdown.set()
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass
        if join and threading.current_thread() is not self._loop_thread:
            self._loop_thread.join(timeout)

    # -- event loop --------------------------------------------------------

    def _loop(self) -> None:
        try:
            while not self._shutdown.is_set():
                timeout = 1.0
                now = time.monotonic()
                for c in self._parked:
                    timeout = min(timeout, max(0.0, c.park.deadline - now))
                for c in self._awaiting_auth:
                    timeout = min(timeout, max(0.0, c.auth_deadline - now))
                try:
                    for key, events in self._sel.select(timeout=timeout):
                        if key.data == "accept":
                            self._accept()
                        elif key.data == "wake":
                            try:
                                self._wake_r.recv(4096)
                            except OSError:
                                pass
                        else:
                            conn: _Conn = key.data
                            if events & selectors.EVENT_WRITE:
                                self._flush(conn)
                            if events & selectors.EVENT_READ:
                                self._read(conn)
                    self._expire_parked()
                    # `now` is the loop-top stamp — stale by at most one
                    # select, irrelevant at a multi-second emit interval and
                    # one fewer clock read per wakeup.
                    if (
                        self._opstats is not None
                        and now - self._last_stats_emit >= self.stats_interval
                    ):
                        self._emit_stats()
                except Exception:
                    # A coordinator must not die on one bad connection; per-conn
                    # errors are handled inline, so this is a genuine bug — log it
                    # and keep serving.
                    log.exception("store: event-loop error (continuing)")
        finally:
            self._teardown()

    # -- op telemetry ------------------------------------------------------

    def _stats_disable(self, e: Exception) -> None:
        """First collector exception wins: stop paying for a broken collector
        and surface the failure through the stats document, never the op."""
        self._stats_error = repr(e)
        self._opstats = None
        log.warning(f"store: op-stats collector failed; stats disabled: {e!r}")

    def _emit_stats(self) -> None:
        """One ``store_stats`` event with counter deltas (loop thread) — the
        live/post-hoc parity path: replaying the stream reconstructs the same
        ``tpu_store_*`` totals the live registry holds. Called when the loop's
        interval check fires, and once at teardown so even a short-lived
        store leaves its totals behind."""
        st = self._opstats
        if st is None:
            return
        self._last_stats_emit = time.monotonic()
        try:
            deltas = st.take_deltas()
        except Exception as e:
            self._stats_disable(e)
            return
        if deltas is None:
            return
        record_event(
            "store", "store_stats",
            conns=len(self._conns), parked=len(self._parked), **deltas,
        )

    def _teardown(self) -> None:
        self._emit_stats()
        shutdown_resp = {"status": "error", "error": repr(RuntimeError("store shut down"))}
        for conn in list(self._conns.values()):
            if conn.park is not None:
                conn.park = None
                self._parked.discard(conn)
                try:  # best-effort: tell blocked clients rather than hang them
                    conn.sock.setblocking(True)
                    conn.sock.settimeout(1.0)
                    # Drain any buffered response bytes first: writing the
                    # shutdown frame past an undrained wbuf would interleave
                    # frames and corrupt the client's stream.
                    if conn.wbuf:
                        conn.sock.sendall(conn.wbuf)
                        conn.wbuf.clear()
                    framing.send_obj(conn.sock, shutdown_resp)
                except OSError:
                    pass
            self._drop(conn)
        for s in (self._sock, self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass
        if self._reserve_fd is not None:
            try:
                os.close(self._reserve_fd)
            except OSError:
                pass
            self._reserve_fd = None
        self._sel.close()

    def _accept(self) -> None:
        while True:
            try:
                sock, _ = self._sock.accept()
            except BlockingIOError:
                return
            except OSError as e:
                if e.errno in (errno.EMFILE, errno.ENFILE):
                    if self._reserve_fd is None:
                        # A previous shed lost the race to reopen the reserve;
                        # keep trying so shedding never stays disabled for life.
                        try:
                            self._reserve_fd = os.open(os.devnull, os.O_RDONLY)
                        except OSError:
                            return
                    # Shed the pending connection via the reserve fd so the
                    # selector doesn't busy-spin on the still-readable listener.
                    os.close(self._reserve_fd)
                    self._reserve_fd = None
                    try:
                        shed, _ = self._sock.accept()
                        shed.close()
                        log.warning("store: fd limit reached; shed one connection")
                    except OSError:
                        pass
                    finally:
                        try:
                            self._reserve_fd = os.open(os.devnull, os.O_RDONLY)
                        except OSError:
                            self._reserve_fd = None
                    continue
                return
            if chaos.check_accept("store"):
                # Injected EOF-on-accept: the client sees a clean close before
                # any frame and retries its connect.
                sock.close()
                continue
            sock.setblocking(False)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Conn(sock)
            self._conns[sock] = conn
            self._sel.register(sock, selectors.EVENT_READ, conn)
            if self._opstats is not None:
                try:
                    self._opstats.note_conn(len(self._conns))
                except Exception as e:
                    self._stats_disable(e)
            # Connection hello; challenge/response when auth is on. A peer that
            # never completes the challenge is dropped at the deadline (the
            # threaded server's 30 s handshake timeout).
            conn.nonce = secrets.token_bytes(16)
            if self.auth_key is not None:
                conn.awaiting_mac = True
                conn.auth_deadline = time.monotonic() + self.auth_timeout
                self._awaiting_auth.add(conn)
            self._send(
                conn, {"v": 1, "auth": self.auth_key is not None, "nonce": conn.nonce}
            )

    def _drop(self, conn: _Conn) -> None:
        if conn.park is not None:
            waiters = self._waiters.get(conn.park.wait_key)
            if waiters is not None:
                waiters.discard(conn)
                if not waiters:
                    self._waiters.pop(conn.park.wait_key, None)
        self._parked.discard(conn)
        self._awaiting_auth.discard(conn)
        self._conns.pop(conn.sock, None)
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass

    #: Per-connection buffer caps — the backpressure the threaded design got for
    #: free from blocking sockets. A legitimate client has at most one request in
    #: flight and drains responses promptly; a peer violating either is dropped.
    _MAX_RBUF = framing.DEFAULT_MAX_FRAME + 65536
    _MAX_WBUF = 4 * framing.DEFAULT_MAX_FRAME

    def _send(self, conn: _Conn, obj: Any) -> None:
        frame = framing.encode_obj(obj)
        if self._stats_armed:
            # Sampled-scaled outbound byte tally: exactly the sampled op's
            # response, ×SAMPLE — same estimate semantics as the op tallies.
            self._stats_armed = False
            if self._opstats is not None:
                self._opstats.bytes_out += len(frame) * self._opstats.SAMPLE
        conn.wbuf += frame
        if len(conn.wbuf) > self._MAX_WBUF:
            log.warning("store: dropping connection with %d B of undrained responses",
                        len(conn.wbuf))
            self._drop(conn)
            return
        self._flush(conn)

    def _flush(self, conn: _Conn) -> None:
        try:
            while conn.wbuf:
                sent = conn.sock.send(conn.wbuf)
                del conn.wbuf[:sent]
        except BlockingIOError:
            pass
        except OSError:
            self._drop(conn)
            return
        events = selectors.EVENT_READ | (selectors.EVENT_WRITE if conn.wbuf else 0)
        try:
            self._sel.modify(conn.sock, events, conn)
        except (KeyError, ValueError):
            pass

    def _read(self, conn: _Conn) -> None:
        try:
            chunk = conn.sock.recv(256 * 1024)
        except BlockingIOError:
            return
        except OSError:
            self._drop(conn)
            return
        if not chunk:
            self._drop(conn)  # peer gone; any parked request dies with it
            return
        if self._opstats is not None and self._stats_tick <= 1:
            # Queue-wait anchor, read only by the next (sampled) op. A frame
            # that crosses the sample boundary mid-chunk finds recv_ts == 0
            # and skips its wait observation — under-sampling, never a stale
            # stamp.
            conn.recv_ts = time.perf_counter()
        conn.rbuf += chunk
        if len(conn.rbuf) > self._MAX_RBUF:
            log.warning("store: dropping connection with %d B of unparsed input",
                        len(conn.rbuf))
            self._drop(conn)
            return
        self._parse(conn)

    def _parse(self, conn: _Conn) -> None:
        """Consume complete frames from the read buffer. A connection with a parked
        request stops parsing (strict request/response: the next frame is only
        legal after our reply) but keeps buffering."""
        while conn.park is None and conn.sock in self._conns:
            max_frame = 1024 if conn.awaiting_mac else framing.DEFAULT_MAX_FRAME
            try:
                decoded = framing.decode_frame(conn.rbuf, max_frame=max_frame)
            except Exception:  # oversized or unpicklable frame
                self._drop(conn)
                return
            if decoded is None:
                return
            obj, consumed = decoded
            del conn.rbuf[:consumed]
            conn.frame_bytes = consumed
            if conn.awaiting_mac:
                mac = obj.get("mac", b"") if isinstance(obj, dict) else b""
                ok = isinstance(mac, (bytes, bytearray)) and hmac.compare_digest(
                    bytes(mac), _hmac(self.auth_key, conn.nonce)
                )
                if not ok:
                    log.warning("store: rejected connection with bad auth")
                    self._drop(conn)
                    return
                conn.awaiting_mac = False
                self._awaiting_auth.discard(conn)
                continue
            self._handle_request(conn, obj)

    def _handle_request(self, conn: _Conn, req: Any) -> None:
        # Op telemetry, fully sampled: 1 op in OpStats.SAMPLE pays the whole
        # accounting (op/error/byte tallies scaled by SAMPLE, queue wait =
        # socket readable → here, handle = the dispatch itself — a park is a
        # wait, not work, and parks aren't re-counted on wake); the other
        # SAMPLE-1 ops pay ONE counter decrement. Exact per-op counting was
        # measured at 2-4 µs/op of py3.10 attribute traffic — a >5% tax on a
        # ~35 µs loopback op, which is why every figure in the doc is a
        # sampled estimate and the knob stays ON by default. Contained: a
        # collector bug disables stats, the response still goes out.
        sampled = False
        t0 = 0.0
        if self._opstats is not None:
            self._stats_tick -= 1
            if self._stats_tick <= 0:
                # Jittered reload, mean SAMPLE (6..10): breaks phase lock
                # with periodic op mixes.
                seed = (self._stats_seed * 1103515245 + 12345) & 0x7FFFFFFF
                self._stats_seed = seed
                self._stats_tick = self._opstats.SAMPLE - 2 + seed % 5
                self._stats_armed = True
                sampled = True
                t0 = time.perf_counter()
        try:
            resp = self._dispatch(req)
        except BarrierOverflow as e:
            resp = {"status": "overflow", "error": str(e)}
        except TimeoutError:
            resp = {"status": "timeout"}
        except Exception as e:  # surface server-side faults to the client
            resp = {"status": "error", "error": repr(e)}
        if sampled and self._opstats is not None:
            try:
                is_dict = type(req) is dict
                self._opstats.note_op(
                    req.get("op", "?") if is_dict else "?",
                    (t0 - conn.recv_ts) if conn.recv_ts else -1.0,
                    time.perf_counter() - t0,
                    conn.frame_bytes,
                    req if is_dict else None,
                    type(resp) is dict
                    and resp.get("status") not in ("ok", None),
                )
                conn.recv_ts = 0.0  # consumed: never reused as a stale anchor
            except Exception as e:
                self._stats_disable(e)
        if isinstance(resp, _Park):
            ready = resp.ready()
            if ready is not None:
                self._send(conn, ready)
            elif resp.deadline <= time.monotonic():
                self._send(conn, {"status": "timeout"})
            else:
                conn.park = resp
                self._parked.add(conn)
                self._waiters.setdefault(resp.wait_key, set()).add(conn)
        else:
            self._send(conn, resp)

    def _notify(self, wait_key: tuple) -> None:
        """Wake the parked requests waiting on `wait_key` (called by the mutation
        that may have satisfied them); each re-checks its condition."""
        waiters = self._waiters.get(wait_key)
        if not waiters:
            return
        for conn in list(waiters):
            if conn.park is None:
                continue
            resp = conn.park.ready()
            if resp is not None:
                self._unpark(conn)
                self._send(conn, resp)
                self._parse(conn)  # drain any frames buffered while parked

    def _unpark(self, conn: _Conn) -> None:
        waiters = self._waiters.get(conn.park.wait_key)
        if waiters is not None:
            waiters.discard(conn)
            if not waiters:
                self._waiters.pop(conn.park.wait_key, None)
        conn.park = None
        self._parked.discard(conn)

    def _expire_parked(self) -> None:
        now = time.monotonic()
        for conn in list(self._parked):
            if conn.park is not None and conn.park.deadline <= now:
                self._unpark(conn)
                self._send(conn, {"status": "timeout"})
                self._parse(conn)
        for conn in list(self._awaiting_auth):
            if conn.awaiting_mac and conn.auth_deadline <= now:
                log.warning("store: dropping connection that never authenticated")
                self._drop(conn)

    # -- operation dispatch ------------------------------------------------

    def _dispatch(self, req: dict) -> Any:
        op = req["op"]
        handler = getattr(self, f"_op_{op}", None)
        if handler is None:
            return {"status": "error", "error": f"unknown op {op!r}"}
        req_id = req.get("req_id")
        if req_id is not None:
            hit = self._dedup.get(req_id)
            st = self._opstats
            if st is not None:  # inline attribute adds: this is a hot path
                st.dedup_lookups += 1
                if hit is not None and hit[0] == "resp":
                    st.dedup_hits += 1
            if hit is not None and hit[0] == "resp":
                # Retry of a request that fully applied; replay the recorded
                # response instead of re-applying the mutation.
                self._dedup.move_to_end(req_id)
                return hit[1]
        resp = handler(req)
        if req_id is not None:
            if isinstance(resp, _Park):
                resp = self._park_caching(req_id, resp)
            else:
                self._dedup_put(req_id, ("resp", resp))
        return resp

    def _dedup_put(self, req_id: str, entry: tuple) -> None:
        od = self._dedup
        od[req_id] = entry
        od.move_to_end(req_id)
        while len(od) > _DEDUP_MAX:
            od.popitem(last=False)

    def _park_caching(self, req_id: str, park: _Park) -> _Park:
        """Wrap a park so its eventual response is recorded under ``req_id``
        the moment it materializes (release via ``_notify``) — a retry arriving
        after the release replays it instead of re-joining."""
        inner = park.ready

        def ready() -> Optional[dict]:
            r = inner()
            if r is not None:
                self._dedup_put(req_id, ("resp", r))
            return r

        return _Park(ready=ready, deadline=park.deadline, wait_key=park.wait_key)

    @staticmethod
    def _ok(value: Any = None) -> dict:
        return {"status": "ok", "value": value}

    def _op_ping(self, req: dict) -> dict:
        return self._ok("pong")

    def _bump(self, key: str) -> int:
        self._version_clock += 1
        self._versions[key] = self._version_clock
        return self._version_clock

    def _op_set(self, req: dict) -> dict:
        self._data[req["key"]] = req["value"]
        self._bump(req["key"])
        self._notify(("k", req["key"]))
        return self._ok()

    def _op_get(self, req: dict) -> Any:
        deadline = time.monotonic() + req.get("timeout", 0.0)
        key = req["key"]

        def ready() -> Optional[dict]:
            if key in self._data:
                return self._ok(self._data[key])
            return None

        return _Park(ready=ready, deadline=deadline, wait_key=("k", key))

    def _op_check(self, req: dict) -> dict:
        return self._ok(all(k in self._data for k in req["keys"]))

    def _op_delete(self, req: dict) -> dict:
        existed = req["key"] in self._data
        self._data.pop(req["key"], None)
        if existed:
            # Drop (not bump): version reverts to 0 — different from whatever
            # any watcher saw — and the table stays bounded by live keys.
            self._versions.pop(req["key"], None)
            self._notify(("k", req["key"]))
        return self._ok(existed)

    def _op_add(self, req: dict) -> dict:
        new = int(self._data.get(req["key"], 0)) + int(req["amount"])
        self._data[req["key"]] = new
        self._bump(req["key"])
        self._notify(("k", req["key"]))
        return self._ok(new)

    def _op_cas(self, req: dict) -> dict:
        """Compare-and-set: set key to `desired` iff current == `expected`.

        `expected=None` means "key must be absent". Returns (success, current_value).
        Analogue of the c10d rendezvous backend's CAS state blob
        (reference ``rendezvous/c10d_rendezvous_backend.py``).
        """
        current = self._data.get(req["key"])
        if current == req["expected"]:
            self._data[req["key"]] = req["desired"]
            self._bump(req["key"])
            self._notify(("k", req["key"]))
            return self._ok((True, req["desired"]))
        return self._ok((False, current))

    def _op_getv(self, req: dict) -> dict:
        key = req["key"]
        return self._ok((self._data.get(key), self._versions.get(key, 0)))

    def _op_wait_changed(self, req: dict) -> Any:
        """Park until ``key``'s mutation version differs from ``seen_version``
        (set/add/cas/delete all count, even back to the same value), then
        return ``(value, new_version)`` — the event-driven alternative to
        polling a CAS state blob (rendezvous close detection rides this)."""
        deadline = time.monotonic() + req.get("timeout", 0.0)
        key, seen = req["key"], req["seen_version"]

        def ready() -> Optional[dict]:
            v = self._versions.get(key, 0)
            if v != seen:
                return self._ok((self._data.get(key), v))
            return None

        return _Park(ready=ready, deadline=deadline, wait_key=("k", key))

    def _op_prefix_get(self, req: dict) -> dict:
        prefix = req["prefix"]
        return self._ok({k: v for k, v in self._data.items() if k.startswith(prefix)})

    def _op_num_keys(self, req: dict) -> dict:
        return self._ok(len(self._data))

    def _op_keys(self, req: dict) -> dict:
        """Key names only under a prefix — introspection without hauling
        values (prefix_get on a 4096-rank job's store moves megabytes)."""
        prefix = req.get("prefix", "")
        return self._ok(sorted(k for k in self._data if k.startswith(prefix)))

    def _op_barriers(self, req: dict) -> dict:
        """Names of live barriers (states via ``barrier_status``)."""
        return self._ok(sorted(self._barriers))

    def _op_list_append(self, req: dict) -> dict:
        self._lists.setdefault(req["key"], []).append(req["value"])
        return self._ok()

    def _op_list_get(self, req: dict) -> dict:
        return self._ok(list(self._lists.get(req["key"], [])))

    def _op_list_clear(self, req: dict) -> dict:
        self._lists.pop(req["key"], None)
        return self._ok()

    def _op_set_add(self, req: dict) -> dict:
        s = self._sets.setdefault(req["key"], set())
        s.update(req["values"])
        return self._ok(len(s))

    def _op_set_get(self, req: dict) -> dict:
        return self._ok(set(self._sets.get(req["key"], set())))

    @staticmethod
    def _barrier_maybe_release(b: _Barrier) -> bool:
        covered = len(b.arrived | b.absent)
        if b.world_size and covered >= b.world_size:
            b.generation += 1
            b.arrived = set()  # absent stays: dead ranks stay dead for future rounds
            b.arrived_at = {}
            b.world_size = 0
            b.opened_at = 0.0
            return True
        return False

    def _op_barrier(self, req: dict) -> Any:
        """Join barrier `name` as `rank`; release when `world_size` ranks are covered.

        Three join modes:

        - ``wait=True`` — arrive and block until the round releases (the normal join).
        - ``wait=False`` — *register* arrival and return immediately; the caller polls
          ``barrier_status`` for the release (how completers overlap the barrier wait
          with interruption watching). Duplicate registrations are no-ops.
        - ``on_behalf=True`` — proxy join *for a dead rank*: the rank is marked absent
          stickily, counting toward this and every future round of the name until the
          world size changes (reference ``monitor_process.py:260-282``). Repeats are
          no-ops; release fires only on a coverage *transition*, so a late duplicate
          proxy can neither plant a phantom arrival nor re-release a finished round.

        A dead-marked rank arriving itself gets :class:`BarrierOverflow` — the
        falsely-declared-dead signal the restart loop converts into exclusion.
        Reentrant: each completed round bumps the generation (reference
        ``reentrant_barrier``, ``store.py:244``); a round opening with a different
        world size (elastic shrink/grow) resets the absent set, since rank identities
        were remapped by reassignment.

        A blocking join parks on the *barrier object* (not the name): if the barrier
        is deleted and recreated while a waiter is parked, the waiter keeps waiting on
        the old object until its deadline — same behavior as the threaded server had.
        On timeout the arrival stays in place: a late joiner may still release
        everyone; callers treat barrier timeout as fatal anyway.
        """
        name, rank = req["name"], req["rank"]
        world_size = int(req["world_size"])
        deadline = time.monotonic() + req.get("timeout", 0.0)
        req_id = req.get("req_id")
        if req_id is not None:
            hit = self._dedup.get(req_id)
            if hit is not None and hit[0] == "barrier":
                # Retry of a blocking join whose arrival already landed (the
                # first attempt's connection died while parked). Re-wait on
                # the same round without re-applying — a blind re-join would
                # surface as a spurious "joined twice" overflow.
                bname, gen0 = hit[1]
                b0 = self._barriers.get(bname)
                if b0 is None:
                    return self._ok(None)
                if b0.generation != gen0:
                    return self._ok(b0.generation)

                def replay_ready() -> Optional[dict]:
                    if b0.generation != gen0:
                        return self._ok(b0.generation)
                    return None

                return _Park(
                    ready=replay_ready, deadline=deadline, wait_key=("b", id(b0))
                )
        b = self._barriers.setdefault(name, _Barrier())
        if b.world_size and b.world_size != world_size:
            # Mismatch within an in-progress round is a protocol error.
            if b.arrived:
                raise BarrierOverflow(
                    f"barrier {name!r}: world_size {world_size} != in-progress "
                    f"round's {b.world_size}"
                )
            # Proxy-only round (world size held open by on_behalf joins with no
            # real arrivals): a join under a different world size re-opens the
            # round; the first-join branch below then clears the stale absences
            # (last_world != world_size always holds here), which must not
            # phantom-cover the new rank numbering.
            b.world_size = 0
        if b.world_size == 0:  # first join of a round
            if b.last_world and b.last_world != world_size:
                # Elastic membership change: stale absences refer to the old
                # rank numbering and must not count toward the new round.
                b.absent = set()
            b.last_world = world_size
            b.opened_at = time.monotonic()
        b.world_size = world_size
        gen = b.generation
        if req.get("on_behalf", False):
            if rank not in b.absent:
                b.absent.add(rank)
                if self._barrier_maybe_release(b):
                    self._notify(("b", id(b)))
            return self._ok(None)
        if rank in b.absent:
            raise BarrierOverflow(
                f"barrier {name!r}: rank {rank} was proxied as dead"
            )
        if rank in b.arrived:
            if not req.get("wait", True):
                return self._ok(None)  # idempotent re-registration
            raise BarrierOverflow(f"barrier {name!r}: rank {rank} joined twice")
        b.arrived.add(rank)
        b.arrived_at[rank] = time.monotonic()
        if len(b.arrived | b.absent) > world_size:
            raise BarrierOverflow(
                f"barrier {name!r}: {len(b.arrived | b.absent)} arrivals > "
                f"world {world_size}"
            )
        if req_id is not None and req.get("wait", True):
            # Arrival applied but the response may be a long way off (park):
            # mark it so a retried join re-waits instead of double-arriving.
            # Overwritten with the real response when it materializes.
            self._dedup_put(req_id, ("barrier", (name, gen)))
        if self._barrier_maybe_release(b):
            self._notify(("b", id(b)))
            return self._ok(b.generation)
        if not req.get("wait", True):
            return self._ok(None)

        def ready() -> Optional[dict]:
            if b.generation != gen:
                return self._ok(b.generation)
            return None

        return _Park(ready=ready, deadline=deadline, wait_key=("b", id(b)))

    def _op_barrier_del(self, req: dict) -> dict:
        """Drop barrier `name` exactly (no prefix semantics — ``barrier/iter/1`` must
        not take ``barrier/iter/10`` with it)."""
        existed = self._barriers.pop(req["name"], None) is not None
        return self._ok(existed)

    def _op_barrier_status(self, req: dict) -> dict:
        b = self._barriers.get(req["name"])
        if b is None:
            return self._ok(None)
        return self._ok(
            {
                "generation": b.generation,
                "arrived": set(b.arrived),
                "absent": set(b.absent),
                "world_size": b.world_size,
            }
        )

    def _op_barrier_census(self, req: dict) -> dict:
        """Snapshot of every barrier with an in-progress round: who arrived
        (with waiter ages), who is proxied absent, and — the hang-forensics
        payoff — who is *missing*: the ranks the waiters are blocked on.

        ``prefix`` optionally scopes the scan. One response answers "what is
        the job waiting on, and on whom" without touching any value keys —
        the live half of the ``/hangz`` census and ``tpu-store-info
        --barriers``.
        """
        prefix = req.get("prefix", "")
        now = time.monotonic()
        out = {}
        for name, b in self._barriers.items():
            if prefix and not name.startswith(prefix):
                continue
            if not b.world_size:
                continue  # between rounds: nobody is waiting here
            arrived = {
                int(r): round(max(0.0, now - ts), 3)
                for r, ts in b.arrived_at.items()
                if r in b.arrived
            }
            known = set(b.arrived) | set(b.absent)
            missing = sorted(
                r for r in range(b.world_size) if r not in known
            )
            out[name] = {
                "generation": b.generation,
                "world_size": b.world_size,
                "arrived": arrived,
                "absent": sorted(b.absent),
                "missing": missing,
                "open_age_s": round(max(0.0, now - b.opened_at), 3)
                if b.opened_at else 0.0,
            }
        return self._ok(out)

    def _op_touch(self, req: dict) -> dict:
        """Store the *server's* wall time under `key`. Heartbeat freshness must be
        judged by one clock — comparing a peer host's ``time.time()`` against the local
        one turns NTP offset into false UNRESPONSIVE verdicts."""
        self._data[req["key"]] = time.time()
        self._bump(req["key"])
        self._notify(("k", req["key"]))
        return self._ok()

    def _op_stale(self, req: dict) -> dict:
        """Return ``{key: age}`` for keys under `prefix` whose touch-stamp is older
        than `max_age` seconds by the server clock.

        This is the watchers' liveness query: the response carries only the *stale*
        entries, so N watchers polling every second costs O(stale) wire traffic, not
        O(N²) full-table transfers. Scans are coalesced through a short-lived cache —
        liveness tolerates a second of slack, the event loop does not tolerate
        N full scans per second.
        """
        prefix, max_age = req["prefix"], float(req["max_age"])
        cached = self._stale_cache.get((prefix, max_age))
        now = time.time()
        if cached is not None and now - cached[0] < 1.0:
            return self._ok(dict(cached[1]))
        out = {}
        for k, v in self._data.items():
            # bool is an int subclass: a True/False flag under the prefix must
            # not be read as a ~epoch-0 timestamp and reported forever-stale.
            if k.startswith(prefix) and isinstance(v, (int, float)) and not isinstance(v, bool):
                age = now - v
                if age > max_age:
                    out[k] = age
        self._stale_cache[(prefix, max_age)] = (now, out)
        return self._ok(dict(out))

    def _op_prefix_clear(self, req: dict) -> dict:
        """Delete every datum, list, set, and barrier whose key starts with `prefix` —
        the GC hook that keeps per-iteration restart state (interruption records,
        completion flags, old barriers) from accumulating for the job's lifetime."""
        prefix = req["prefix"]
        removed = 0
        for table in (self._data, self._lists, self._sets, self._barriers):
            dead = [k for k in table if k.startswith(prefix)]
            for k in dead:
                del table[k]
                if table is self._data:
                    self._versions.pop(k, None)
                    self._notify(("k", k))
            removed += len(dead)
        self._stale_cache.clear()
        return self._ok(removed)

    def _op_store_stats(self, req: dict) -> dict:
        """The server's self-telemetry document (schema ``tpu-store-stats-1``):
        per-op latency (queue wait vs handle split), bytes in/out, connection
        counts, dedup-LRU hit rate, barrier park depth, hot key prefixes.

        Idempotent and read-only. A broken/disabled collector degrades the
        document (``enabled: false`` + ``error``), never the op — this is the
        instrument the perf work is judged with, so it must answer even when
        it has nothing to say."""
        base = {
            # Serving-backend identity for skew-aware tooling: this server is
            # the selectors event loop; a document with NO backend field is a
            # pre-epoll (thread-per-connection) build — tpu-store-info renders
            # the absence as "threaded".
            "backend": BACKEND,
            "conns": len(self._conns),
            "parked": len(self._parked),
            "barriers_open": sum(
                1 for b in self._barriers.values() if b.world_size
            ),
            "keys": len(self._data),
            "dedup_entries": len(self._dedup),
        }
        if self._opstats is None:
            from tpu_resiliency_torch.utils.opstats import SCHEMA as STATS_SCHEMA

            doc = {"schema": STATS_SCHEMA, "enabled": False, **base}
            if self._stats_error:
                doc["error"] = self._stats_error
            return self._ok(doc)
        try:
            doc = self._opstats.snapshot()
        except Exception as e:
            self._stats_disable(e)
            from tpu_resiliency_torch.utils.opstats import SCHEMA as STATS_SCHEMA

            return self._ok({
                "schema": STATS_SCHEMA, "enabled": False,
                "error": self._stats_error, **base,
            })
        doc.update(base)
        return self._ok(doc)


class KVClient:
    """Client for :class:`KVServer`: one persistent connection for fast ops, one-shot
    connections for long-blocking ops. Thread-safe."""

    def __init__(
        self,
        host: str,
        port: int,
        timeout: float = 300.0,
        connect_retries: int = 60,
        auth_key: str | None = None,
        retry_budget: float = 8.0,
    ):
        self.host, self.port = host, port
        self.default_timeout = timeout
        #: total wall-clock budget for transparent transport-failure retries of
        #: one call (exponential backoff 50ms → 1s). 0 disables retrying.
        self.retry_budget = retry_budget
        if auth_key is None:
            auth_key = os.environ.get(AUTH_KEY_ENV) or None
        self.auth_key = auth_key
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._closed = False
        #: req_id prefix unique to this client instance; the sequence makes
        #: each non-idempotent call's nonce unique for the server's dedup LRU.
        self._client_id = secrets.token_hex(8)
        self._req_seq = itertools.count()
        self._sock = self._connect(connect_retries)

    def _connect(self, retries: int = 3) -> socket.socket:
        # Breaker open: one probe, no sleep ladder. Only clamps the small
        # in-call reconnect (an explicit high-retry construction — e.g. the
        # in-process Wrapper waiting out a store re-host — keeps its patience).
        if retries <= 3 and _breaker_open(self.host, self.port):
            retries = 1
        delay = 0.05
        last: Exception | None = None
        for _ in range(max(1, retries)):
            if self._closed:
                # close() raced the retry loop: stop reconnecting a client
                # nobody will ever use instead of sleeping out the budget.
                raise StoreError("store client is closed")
            try:
                chaos.check_connect("store", peer=f"{self.host}:{self.port}")
                sock = socket.create_connection((self.host, self.port), timeout=30.0)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                sock = chaos.wrap(sock, "store", peer=f"{self.host}:{self.port}")
                self._client_handshake(sock)
                return sock
            except (OSError, EOFError, StoreError, ValueError) as e:
                last = e
                time.sleep(delay)
                delay = min(delay * 1.7, 2.0)
        # Constructor-path connects raise from HERE, never reaching _call's
        # exhaustion bookkeeping — without this trip, a lazily-(re)constructed
        # client to a dead endpoint pays the full connect ladder on EVERY op
        # and the HA routing layer, which keys off the breaker, never learns
        # the shard is down.
        if self.retry_budget > 0:
            _breaker_trip(self.host, self.port, self.retry_budget)
        raise StoreTransportError(
            f"cannot connect to store at {self.host}:{self.port}: {last!r}"
        )

    def _client_handshake(self, sock: socket.socket) -> None:
        _client_hello(sock, self.auth_key)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._sock is not None:
                try:
                    self._sock.close()
                finally:
                    self._sock = None

    def _call(self, req: dict, *, op_timeout: float | None = None) -> Any:
        """One request/response round-trip, transparently retried across
        transport faults.

        Fast ops share the persistent socket; ops whose server-side wait can be long run
        on their own one-shot connection so they never starve concurrent control traffic
        (e.g. a heartbeat behind a 300 s barrier join). The socket timeout exceeds the
        server-side operation timeout so server waits surface as protocol timeouts.
        Any transport error invalidates the persistent socket — a half-read frame means
        framing can no longer be trusted — and the call reconnect-and-retries under
        ``retry_budget`` with exponential backoff. Idempotent ops
        (:data:`_IDEMPOTENT_OPS`) reissue blindly; non-idempotent ops
        (:data:`_NONIDEMPOTENT_OPS`) carry a client-minted ``req_id`` nonce the
        server dedups, so a retry whose first attempt *did* land replays the
        recorded response instead of double-applying. Server-side error
        responses are never retried — only the wire is.
        """
        op = req.get("op")
        if op in _NONIDEMPOTENT_OPS and "req_id" not in req:
            req = dict(req, req_id=f"{self._client_id}:{next(self._req_seq)}")
        wait_s = op_timeout or 0.0
        breaker_open = _breaker_open(self.host, self.port)
        deadline = time.monotonic() + (0.0 if breaker_open else self.retry_budget)
        delay = 0.05
        failed = False
        while True:
            try:
                if wait_s > _BLOCKING_THRESHOLD_S:
                    out = self._call_oneshot(req, wait_s)
                else:
                    out = self._call_persistent(req, wait_s)
                if failed or breaker_open:
                    _breaker_clear(self.host, self.port)
                if failed:
                    _retry_event(op, "recovered")
                return out
            except StoreShutdownError:
                # Definitive: the server said goodbye. Reconnect-retrying this
                # endpoint inside the call buys nothing — open the breaker so
                # every client of it fails fast and HA routing moves on.
                if not breaker_open:
                    _breaker_trip(self.host, self.port, self.retry_budget)
                    _retry_event(op, "exhausted")
                raise
            except StoreTransportError:
                failed = True
                if self._closed or time.monotonic() + delay >= deadline:
                    if not breaker_open:
                        # A whole budget spent without one successful
                        # reconnect: open the breaker so subsequent calls (any
                        # client of this endpoint) fail fast instead of each
                        # burning a fresh budget against a server that is gone.
                        _breaker_trip(self.host, self.port, self.retry_budget)
                        _retry_event(op, "exhausted")
                    raise
                _retry_event(op, "retried")
                time.sleep(delay)
                delay = min(delay * 1.7, 1.0)

    def _call_persistent(self, req: dict, wait_s: float) -> Any:
        with self._lock:
            if self._closed:
                raise StoreError("store client is closed")
            if self._sock is None:
                self._sock = self._connect()
            self._sock.settimeout(wait_s + 60.0)
            try:
                framing.send_obj(self._sock, req)
                resp = framing.recv_obj(self._sock)
            except (ConnectionError, EOFError, OSError) as e:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
                raise StoreTransportError(f"store transport failure: {e!r}") from e
            except BaseException:
                # An exception raised into this thread mid-call (the in-process
                # Wrapper's restart signal, a KeyboardInterrupt) leaves this call's
                # reply unread on the socket, where the next call would read it as
                # its own: drop the socket.
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
                raise
        return self._parse(req, resp)

    def _call_oneshot(self, req: dict, wait_s: float) -> Any:
        sock = self._connect()
        try:
            sock.settimeout(wait_s + 60.0)
            try:
                framing.send_obj(sock, req)
                resp = framing.recv_obj(sock)
            except (ConnectionError, EOFError, OSError) as e:
                raise StoreTransportError(f"store transport failure: {e!r}") from e
        finally:
            try:
                sock.close()
            except OSError:
                pass
        return self._parse(req, resp)

    @staticmethod
    def _parse(req: dict, resp: Any) -> Any:
        if not isinstance(resp, dict):
            raise StoreError("malformed store response")
        status = resp.get("status")
        if status == "ok":
            return resp.get("value")
        if status == "timeout":
            raise StoreTimeoutError(f"store op {req.get('op')} timed out")
        if status == "overflow":
            raise BarrierOverflow(resp.get("error", ""))
        err = resp.get("error")
        if isinstance(err, str) and "store shut down" in err:
            # Teardown cut a parked op loose: the op did NOT complete and the
            # endpoint is going away. That is a transport-class failure, not a
            # server-side verdict — surfacing it as one lets HA clique clients
            # fail a graceful shard shutdown over to the successor exactly
            # like a SIGKILL'd shard.
            raise StoreShutdownError(
                f"store op {req.get('op')} aborted by server shutdown"
            )
        raise StoreError(f"store op {req.get('op')} failed: {resp.get('error')}")

    # -- primitive ops -----------------------------------------------------

    def ping(self) -> bool:
        return self._call({"op": "ping"}) == "pong"

    def set(self, key: str, value: Any) -> None:
        self._call({"op": "set", "key": key, "value": value})

    def get(self, key: str, timeout: float | None = None) -> Any:
        t = self.default_timeout if timeout is None else timeout
        return self._call({"op": "get", "key": key, "timeout": t}, op_timeout=t)

    def try_get(self, key: str, default: Any = None) -> Any:
        """Opportunistic read: ``default`` on a missing key *or* a transport
        failure (retry budget exhausted against a dead socket/server). Callers
        use this for best-effort probes — they must never crash on a blip."""
        try:
            return self.get(key, timeout=0.0)
        except StoreTimeoutError:
            return default
        except StoreError:
            if self._closed:
                raise
            return default

    def check(self, keys: Iterable[str]) -> bool:
        return self._call({"op": "check", "keys": list(keys)})

    def delete(self, key: str) -> bool:
        return self._call({"op": "delete", "key": key})

    def add(self, key: str, amount: int = 1) -> int:
        return self._call({"op": "add", "key": key, "amount": amount})

    def compare_set(self, key: str, expected: Any, desired: Any) -> tuple[bool, Any]:
        return tuple(self._call({"op": "cas", "key": key, "expected": expected, "desired": desired}))

    def get_versioned(self, key: str) -> tuple[Any, int]:
        """``(value_or_None, mutation_version)`` — the version feeds
        :meth:`wait_changed`."""
        return tuple(self._call({"op": "getv", "key": key}))

    def wait_changed(
        self, key: str, seen_version: int, timeout: float
    ) -> tuple[bool, Any, int]:
        """Block until ``key`` mutates past ``seen_version`` (any set/add/cas/
        delete) or ``timeout`` elapses. Returns ``(changed, value, version)``;
        on timeout ``(False, None, seen_version)``. Event-driven replacement
        for sleep-polling a state key."""
        try:
            value, version = self._call(
                {
                    "op": "wait_changed",
                    "key": key,
                    "seen_version": seen_version,
                    "timeout": timeout,
                },
                op_timeout=timeout,
            )
            return True, value, version
        except StoreTimeoutError:
            return False, None, seen_version

    def prefix_get(self, prefix: str) -> dict[str, Any]:
        return self._call({"op": "prefix_get", "prefix": prefix})

    def prefix_clear(self, prefix: str) -> int:
        return self._call({"op": "prefix_clear", "prefix": prefix})

    def touch(self, key: str) -> None:
        self._call({"op": "touch", "key": key})

    def stale_keys(self, prefix: str, max_age: float) -> dict[str, float]:
        return self._call({"op": "stale", "prefix": prefix, "max_age": max_age})

    def num_keys(self) -> int:
        return self._call({"op": "num_keys"})

    def keys(self, prefix: str = "") -> list[str]:
        """Key names under ``prefix`` — values stay server-side."""
        return self._call({"op": "keys", "prefix": prefix})

    def barrier_names(self) -> list[str]:
        return self._call({"op": "barriers"})

    def list_append(self, key: str, value: Any) -> None:
        self._call({"op": "list_append", "key": key, "value": value})

    def list_get(self, key: str) -> list:
        return self._call({"op": "list_get", "key": key})

    def list_clear(self, key: str) -> None:
        self._call({"op": "list_clear", "key": key})

    def set_add(self, key: str, values: Iterable) -> int:
        return self._call({"op": "set_add", "key": key, "values": list(values)})

    def set_get(self, key: str) -> set:
        return self._call({"op": "set_get", "key": key})

    def barrier_join(
        self,
        name: str,
        rank: int,
        world_size: int,
        timeout: float,
        wait: bool = True,
        on_behalf: bool = False,
    ) -> Optional[int]:
        req = {
            "op": "barrier",
            "name": name,
            "rank": rank,
            "world_size": world_size,
            "timeout": timeout,
            "wait": wait,
            "on_behalf": on_behalf,
        }
        if wait and not on_behalf:
            # A blocking join is THE place a rank gets stuck in a collective:
            # tag the process's location beacon for the duration so the
            # watchdog's hang diagnosis can name the barrier.
            from tpu_resiliency_torch.utils import location as location_mod

            with location_mod.barrier(name):
                return self._barrier_call(req, name, timeout)
        return self._barrier_call(req, name, timeout if wait else 0.0)

    def _barrier_call(self, req: dict, name: str, timeout: float) -> Optional[int]:
        try:
            return self._call(req, op_timeout=timeout)
        except StoreTimeoutError as e:
            raise BarrierTimeout(f"barrier {name!r} timed out after {timeout}s") from e

    def barrier_status(self, name: str) -> Optional[dict]:
        return self._call({"op": "barrier_status", "name": name})

    def barrier_census(self, prefix: str = "") -> dict[str, dict]:
        """Every in-progress barrier round under ``prefix``: arrived ranks
        with waiter ages, proxied-absent ranks, and the missing ranks the
        round is blocked on (``platform/store.py:_op_barrier_census``)."""
        return self._call({"op": "barrier_census", "prefix": prefix})

    def barrier_del(self, name: str) -> bool:
        return self._call({"op": "barrier_del", "name": name})

    def store_stats(self) -> dict:
        """The server's self-telemetry document (``tpu-store-stats-1``;
        ``platform/store.py:_op_store_stats``). Raises :class:`StoreError`
        against a pre-stats server — server-side *error responses* are never
        retried, so the unknown-op reply costs one round trip, not a retry
        budget (version-skew containment, tested both directions)."""
        return self._call({"op": "store_stats"})


class StoreView:
    """A prefix-scoped coordination API over a :class:`KVClient`.

    Provides the primitive surface of the reference's ``StoreMixin``
    (``inprocess/store.py:48-311``): namespaced KV ops, named reentrant barriers, and
    on-behalf barrier completion. The restart-protocol schema on top (interruption
    records, terminated sets, heartbeats) lives in
    ``inprocess/coordination.py:RestartCoordinator``. ``scoped()`` derives a deeper
    view, the per-restart-iteration namespace pattern (reference ``store.py:360
    PrefixStore``, ``wrap.py:417``).
    """

    def __init__(self, client: KVClient, prefix: str = ""):
        self.client = client
        self.prefix = prefix

    def _k(self, key: str) -> str:
        return f"{self.prefix}{key}"

    def scoped(self, prefix: str) -> "StoreView":
        return StoreView(self.client, f"{self.prefix}{prefix}/")

    # -- namespaced primitives --------------------------------------------

    def ping(self) -> bool:
        return self.client.ping()

    def set(self, key: str, value: Any) -> None:
        self.client.set(self._k(key), value)

    def get(self, key: str, timeout: float | None = None) -> Any:
        return self.client.get(self._k(key), timeout)

    def try_get(self, key: str, default: Any = None) -> Any:
        return self.client.try_get(self._k(key), default)

    def check(self, keys: Iterable[str]) -> bool:
        return self.client.check([self._k(k) for k in keys])

    def delete(self, key: str) -> bool:
        return self.client.delete(self._k(key))

    def add(self, key: str, amount: int = 1) -> int:
        return self.client.add(self._k(key), amount)

    def compare_set(self, key: str, expected: Any, desired: Any) -> tuple[bool, Any]:
        return self.client.compare_set(self._k(key), expected, desired)

    def get_versioned(self, key: str) -> tuple[Any, int]:
        return self.client.get_versioned(self._k(key))

    def wait_changed(
        self, key: str, seen_version: int, timeout: float
    ) -> tuple[bool, Any, int]:
        return self.client.wait_changed(self._k(key), seen_version, timeout)

    def prefix_get(self, prefix: str = "") -> dict[str, Any]:
        """Scan keys under this view; returned keys are relative to the view."""
        full = self._k(prefix)
        raw = self.client.prefix_get(full)
        start = len(self.prefix)
        return {k[start:]: v for k, v in raw.items()}

    def prefix_clear(self, prefix: str) -> int:
        return self.client.prefix_clear(self._k(prefix))

    def touch(self, key: str) -> None:
        self.client.touch(self._k(key))

    def stale_keys(self, prefix: str, max_age: float) -> dict[str, float]:
        raw = self.client.stale_keys(self._k(prefix), max_age)
        start = len(self.prefix)
        return {k[start:]: v for k, v in raw.items()}

    def list_append(self, key: str, value: Any) -> None:
        self.client.list_append(self._k(key), value)

    def list_get(self, key: str) -> list:
        return self.client.list_get(self._k(key))

    def list_clear(self, key: str) -> None:
        self.client.list_clear(self._k(key))

    def set_add(self, key: str, values: Iterable) -> int:
        return self.client.set_add(self._k(key), values)

    def set_get(self, key: str) -> set:
        return self.client.set_get(self._k(key))

    def barrier_join(self, name, rank, world_size, timeout, wait=True, on_behalf=False):
        return self.client.barrier_join(
            self._k(name), rank, world_size, timeout, wait, on_behalf
        )

    def barrier_status(self, name: str) -> Optional[dict]:
        return self.client.barrier_status(self._k(name))

    def barrier_census(self, prefix: str = "") -> dict[str, dict]:
        """Census of this view's in-progress barriers, names view-relative."""
        raw = self.client.barrier_census(self._k(prefix))
        start = len(self.prefix)
        return {k[start:]: v for k, v in raw.items()}

    def barrier_del(self, name: str) -> bool:
        return self.client.barrier_del(self._k(name))

    # -- restart-coordination API -----------------------------------------

    def barrier(self, name: str, rank: int, world_size: int, timeout: float) -> None:
        self.barrier_join(name, rank, world_size, timeout)

    def complete_barrier_for(self, name: str, rank: int, world_size: int) -> None:
        """Join `name` on behalf of (possibly dead) `rank` without blocking."""
        self.barrier_join(name, rank, world_size, timeout=0.0, wait=False, on_behalf=True)


class CoordStore(StoreView):
    """A :class:`StoreView` that owns its connection — the usual entry point."""

    def __init__(
        self,
        host: str,
        port: int,
        prefix: str = "",
        timeout: float = 300.0,
        connect_retries: int = 60,
        auth_key: str | None = None,
        retry_budget: float = 8.0,
    ):
        client = KVClient(
            host, port, timeout=timeout, connect_retries=connect_retries,
            auth_key=auth_key, retry_budget=retry_budget,
        )
        super().__init__(client, prefix)

    def close(self) -> None:
        self.client.close()


def host_store(
    rank: int,
    host: str,
    port: int,
    *,
    prefix: str = "",
    timeout: float = 300.0,
    auth_key: str | None = None,
) -> tuple[CoordStore, Optional[KVServer]]:
    """Rank 0 hosts a :class:`KVServer` and every rank connects a :class:`CoordStore`.

    Mirrors the reference pattern where rank 0 hosts the TCPStore
    (``inprocess/store.py:311,345-353``). Single-host jobs bind loopback; multi-host
    jobs must provide ``auth_key`` (or ``$TPU_RESILIENCY_STORE_KEY``) and a reachable
    ``host``. Returns ``(client, server_or_None)``.
    """
    server = None
    if rank == 0:
        effective_key = auth_key or os.environ.get(AUTH_KEY_ENV) or None
        bind_host = "0.0.0.0" if effective_key else "127.0.0.1"
        server = KVServer(host=bind_host, port=port, auth_key=effective_key)
        host = "127.0.0.1"
        port = server.port
    client = CoordStore(host, port, prefix=prefix, timeout=timeout, auth_key=auth_key)
    return client, server


def store_answers(
    host: str, port: int, *, auth_key: str | None = None, timeout: float = 1.0
) -> bool:
    """True iff a live :class:`KVServer` completes a handshake and answers
    ``ping`` within ``timeout``.

    Distinguishes a legitimately live store on a busy port (another job on a
    shared ``--rdzv-id`` endpoint — connect to it) from a lingering listener
    mid-teardown, which holds the port but never answers (wait out the bind
    retry). A would-be client can therefore decide instantly instead of paying
    the hosting path's EADDRINUSE retry window."""
    if auth_key is None:
        auth_key = os.environ.get(AUTH_KEY_ENV) or None
    try:
        sock = socket.create_connection((host, port), timeout=timeout)
    except OSError:
        return False
    try:
        sock.settimeout(timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        _client_hello(sock, auth_key)
        framing.send_obj(sock, {"op": "ping"})
        resp = framing.recv_obj(sock)
        return isinstance(resp, dict) and resp.get("value") == "pong"
    except (OSError, EOFError, ValueError, StoreError):
        return False
    finally:
        try:
            sock.close()
        except OSError:
            pass


def store_addr_from_env() -> tuple[str, int]:
    """Read the coordinator address from the environment (set by the launcher)."""
    host = os.environ.get("TPU_RESILIENCY_STORE_HOST", os.environ.get("MASTER_ADDR", "127.0.0.1"))
    port = int(os.environ.get("TPU_RESILIENCY_STORE_PORT", os.environ.get("MASTER_PORT", "29511")))
    return host, port


def _serve_forever(argv: Optional[list[str]] = None) -> int:
    """Standalone store server: ``python -m tpu_resiliency_torch.platform.store
    [HOST:]PORT`` — a coordination store that OUTLIVES any one job, for
    multi-job endpoints (``tpu-ft-launcher --rdzv-id``) where a job-hosted
    store would die with the first job to finish. Runs until SIGTERM/SIGINT."""
    import argparse
    import signal as _signal

    ap = argparse.ArgumentParser(description=_serve_forever.__doc__)
    ap.add_argument("endpoint", nargs="?", default="127.0.0.1:29511")
    args = ap.parse_args(argv)
    host, _, port_s = args.endpoint.rpartition(":")
    server = KVServer(host=host or "127.0.0.1", port=int(port_s))
    print(f"store serving on {server.host}:{server.port}", flush=True)
    done = threading.Event()
    for sig in (_signal.SIGTERM, _signal.SIGINT):
        _signal.signal(sig, lambda *_: done.set())
    done.wait()
    server.close()
    return 0


if __name__ == "__main__":
    import sys as _sys

    _sys.exit(_serve_forever())
