"""Host-side group communication for checkpoint coordination and replication.

The reference rides ``torch.distributed`` for three distinct things the checkpoint layer
needs (SURVEY §2.1/§2.6): small-object collectives (``all_gather_object`` for ckpt-ID
coverage, 1-int all-reduce for async-done agreement), process-group barriers, and
point-to-point tensor sends for shard retrieval (``group_utils.py:394-465``). On TPU the
accelerator interconnect is reserved for the training program; checkpoint coordination is
**host-side control plane**, so both live here, over TCP:

- :class:`StoreComm` — object collectives + barriers on the coordination KV store
  (``platform/store.py``). Fine for metadata (IDs, plans, flags): bytes to KBs.
- :class:`PeerExchange` — direct rank↔rank TCP links for tensor payloads (checkpoint
  shards are MBs–GBs and must not transit the KV server). Each rank listens on an
  ephemeral port published in the store under ``p2p/{rank}``; frames carry raw array
  bytes via the checkpoint container encoding (``checkpoint/format.py``).
"""

from __future__ import annotations

import hmac
import itertools
import os
import pickle
import secrets
import socket
import struct
import threading
import time
from typing import Any, Callable, Optional, Sequence

from tpu_resiliency_torch.exceptions import CheckpointError, StoreTimeoutError
from tpu_resiliency_torch.platform import chaos, framing
from tpu_resiliency_torch.platform.store import AUTH_KEY_ENV, StoreView, _hmac
from tpu_resiliency_torch.utils.events import record as record_event
from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)

# Checkpoint shards can be large; allow 16 GB frames on p2p links.
P2P_MAX_FRAME = 16 * 1024**3

#: length prefix framing inside a ranged-read reply payload (header pickle).
_RR_LEN = struct.Struct("<Q")


def _transfer_event(direction: str, nbytes: int, dt: float, **extra) -> None:
    """One ``p2p_transfer`` event per shard move — the volume is one per peer
    per replication round (minutes apart), so per-transfer events are cheap and
    feed both the live metrics sink and post-hoc aggregation
    (``utils/metrics.py:observe_record`` maps them to
    ``tpu_ckpt_replication_bytes_total`` and ``tpu_replication_mbps``)."""
    record_event(
        "checkpoint", "p2p_transfer",
        direction=direction, bytes=nbytes, duration_s=dt,
        mbps=(nbytes / dt / 1e6) if dt > 0 else 0.0, **extra,
    )


def _reachable_host() -> str:
    """Best-effort address peers on other hosts can dial: the address the kernel
    would route external traffic from, falling back to hostname resolution, then
    loopback (single-host case)."""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect(("10.255.255.255", 1))  # no packets sent; just picks a route
            return s.getsockname()[0]
    except OSError:
        pass
    try:
        addr = socket.gethostbyname(socket.gethostname())
        if not addr.startswith("127."):
            return addr
    except OSError:
        pass
    return "127.0.0.1"


class StoreComm:
    """Object collectives over the coordination store, scoped to a rank group.

    Every member must call each collective the same number of times in the same order
    (the usual collective contract). Data keys are namespaced by a per-tag round
    counter and deleted by the leader once every member has read them; barriers use
    **fixed** names per tag — the server's generation-counted reentrant barriers exist
    precisely so a steady-state poll loop doesn't mint unbounded server state.
    """

    def __init__(
        self,
        store: StoreView,
        rank: int,
        ranks: list[int],
        timeout: float = 300.0,
        generation: int = 0,
        tree_fanout: Optional[int] = None,
        tree_min_world: Optional[int] = None,
    ):
        if rank not in ranks:
            raise ValueError(f"rank {rank} not in group {ranks}")
        # ``generation`` isolates server-side barrier/round state across restart
        # rounds: a gather that timed out against a dead peer leaves its barrier
        # arrivals in place, and a later comm over the SAME membership (the peer
        # rejoined) would collide with them. Pass the restart iteration when
        # rebuilding groups after reassignment.
        self.store = store.scoped(
            f"comm/g{generation}/{'-'.join(map(str, sorted(ranks)))}"
        )
        self.rank = rank
        self.ranks = sorted(ranks)
        self.timeout = timeout
        self._rounds: dict[str, int] = {}
        # Tree collectives above a world-size floor (platform/treecomm.py):
        # the flat shapes put O(world) work on one store event loop per round;
        # the tree's critical path is O(fanout · log_fanout world) and its
        # edge keys hash across a sharded clique. Small groups stay flat —
        # fewer round trips, and identical behavior to every pre-tree build.
        # Every member MUST resolve the same fanout/floor (the env pair is
        # launcher-exported, same as the store address).
        from tpu_resiliency_torch.platform import treecomm

        self.tree_fanout = int(
            tree_fanout
            if tree_fanout is not None
            else os.environ.get(treecomm.TREE_FANOUT_ENV, treecomm.DEFAULT_FANOUT)
        )
        self.tree_min_world = int(
            tree_min_world
            if tree_min_world is not None
            else os.environ.get(treecomm.TREE_MIN_ENV, treecomm.DEFAULT_TREE_MIN)
        )
        self._tree: Optional[treecomm.TreeComm] = None
        if len(self.ranks) >= self.tree_min_world:
            self._tree = treecomm.TreeComm(
                self.store.scoped("tree"),
                self.ranks.index(rank),
                len(self.ranks),
                fanout=self.tree_fanout,
            )

    @property
    def world_size(self) -> int:
        return len(self.ranks)

    @property
    def is_leader(self) -> bool:
        return self.rank == self.ranks[0]

    def _round(self, tag: str) -> int:
        r = self._rounds.get(tag, 0)
        self._rounds[tag] = r + 1
        return r

    def barrier(self, tag: str = "barrier", timeout: Optional[float] = None) -> None:
        if self._tree is not None:
            self._tree.barrier(tag, timeout or self.timeout)
            return
        self.store.barrier_join(tag, self.rank, self.world_size, timeout or self.timeout)

    def all_gather(self, obj: Any, tag: str = "ag", timeout: Optional[float] = None) -> list:
        """Returns ``[obj_from_rank]`` ordered by group rank index.

        Flat shape (small groups): exactly one value-fetch round trip per
        collective — the entry barrier guarantees every member's value is
        set, so a single server-side ``prefix_get`` scan replaces N
        sequential polled ``get``\\ s (whose round-trip latency dominated the
        collective at any real group size). Two barriers total — entry
        (values complete) and exit (the leader's batched ``prefix_clear``
        only runs after everyone has read).

        Tree shape (world ≥ ``tree_min_world``): fan-in/fan-out through
        ``platform/treecomm.py`` — O(fanout · log world) critical-path hops,
        edge keys sharded across a store clique. Same return value, same
        ordering, same timeout-is-fatal contract.
        """
        t = timeout or self.timeout
        if self._tree is not None:
            return self._tree.all_gather(obj, tag=tag, timeout=t)
        r = self._round(tag)
        base = f"{tag}/{r}"
        self.store.set(f"{base}/{self.rank}", obj)
        self.store.barrier_join(f"{tag}/b0", self.rank, self.world_size, t)
        vals = self.store.prefix_get(f"{base}/")
        try:
            out = [vals[f"{base}/{peer}"] for peer in self.ranks]
        except KeyError as e:
            # Every member set its value before joining b0; a hole means the
            # store lost state (restarted mid-collective) — surface it.
            raise CheckpointError(
                f"all_gather {tag!r} round {r}: missing value for key {e} "
                f"(got {sorted(vals)})"
            ) from None
        # Exit barrier so the leader only deletes after everyone has read.
        self.store.barrier_join(f"{tag}/b1", self.rank, self.world_size, t)
        if self.is_leader:
            self.store.prefix_clear(f"{base}/")
        return out

    def broadcast(self, obj: Any, src: int, tag: str = "bc", timeout: Optional[float] = None) -> Any:
        """One value from ``src`` to every member.

        Flat shape (small groups): one source ``set``, everyone parks on the
        same key, one exit barrier. Tree shape (world ≥ ``tree_min_world``):
        the value fans out parent→child on per-child keys
        (``treecomm.broadcast``) so a reshard header broadcast at 4096 ranks
        is O(fanout · log N) hops instead of N waiters parked on one shard's
        event loop."""
        t = timeout or self.timeout
        if self._tree is not None:
            return self._tree.broadcast(
                obj, self.ranks.index(src), tag=tag, timeout=t
            )
        r = self._round(tag)
        base = f"{tag}/{r}"
        if self.rank == src:
            self.store.set(f"{base}/v", obj)
        value = self.store.get(f"{base}/v", timeout=t)
        self.store.barrier_join(f"{tag}/b", self.rank, self.world_size, t)
        if self.is_leader:
            self.store.delete(f"{base}/v")
        return value

    def all_reduce_and(self, value: bool, tag: str = "and") -> bool:
        """The reference's 1-int "is everyone done" agreement (``core.py:152-164``)."""
        return all(self.all_gather(bool(value), tag=tag))

    def all_reduce_max(self, value, tag: str = "max"):
        return max(self.all_gather(value, tag=tag))

    def all_reduce_min(self, value, tag: str = "min"):
        """Group-wide minimum — the recovery ladder's fallback-iteration
        agreement: every rank proposes its newest passing iteration and all
        adopt the smallest, so no rank can resume ahead of a peer whose disk
        lost more."""
        return min(self.all_gather(value, tag=tag))

    def make_sync_fn(self):
        """Adapter for :class:`AsyncCallsQueue`'s ``sync_fn``."""

        def sync_fn(local_done: bool) -> bool:
            return self.all_reduce_and(local_done, tag="ckpt-done")

        return sync_fn


class PeerExchange:
    """Rank↔rank bulk transfer channel for checkpoint shards.

    ``start()`` binds an ephemeral listener and publishes its address in the store;
    ``send(dst, tag, blob)`` pushes raw bytes to a peer; ``recv(src, tag)`` blocks for a
    matching frame. Message matching is (src, tag) so concurrent replication rounds with
    distinct tags don't cross. Analogue of the reference's isend/irecv shard routing
    (``checkpointing/local/replication/group_utils.py:394-465``).

    **Wire protocol (v2).** The hello each side already exchanges carries ``v``;
    a v2→v2 link moves payloads as raw bulk frames (small pickled header + raw
    bytes, ``framing.send_bulk``): the sender scatter-gathers the caller's
    buffers straight onto the socket (:meth:`send_parts`) or splices a file with
    ``os.sendfile`` (:meth:`send_file`); the receiver lands the payload in ONE
    preallocated buffer — a registered :meth:`recv_into` destination when the
    caller provided one. Talking to a v1 peer (hello ``v`` < 2, or this side
    constructed with ``protocol=1``) transparently falls back to the pickled
    ``{"src", "tag", "blob"}`` object frame, and a v2 receiver accepts both
    kinds on one stream — mixed-version cliques round-trip byte-identically.
    """

    def __init__(
        self,
        store: StoreView,
        rank: int,
        timeout: float = 300.0,
        auth_key: Optional[str] = None,
        protocol: Optional[int] = None,
        send_retries: int = 3,
        wire_checksums: bool = False,
    ):
        self.store = store.scoped("p2p")
        self.rank = rank
        self.timeout = timeout
        #: Stamp a payload CRC into every ``send_parts`` bulk-frame header;
        #: the receiving side (``framing.recv_any``) verifies it and drops a
        #: mismatching frame like any malformed one (the sender-side retry /
        #: degraded-peer machinery then owns recovery). Off by default: v2
        #: checkpoint containers already carry end-to-end trailer checksums
        #: that cover the wire for free, and the extra CRC pass costs a full
        #: memory read per send. Turn on for non-container payloads or
        #: belt-and-braces wire auditing. ``send_file``/streamed sends never
        #: stamp one (the header is gone before the payload is known).
        self.wire_checksums = bool(wire_checksums)
        #: dial-and-send attempts per peer before a send surfaces
        #: :class:`CheckpointError`. Each retry re-resolves the peer's address
        #: from the store and re-runs the hello handshake, so a peer that
        #: restarted (new ephemeral port) is picked up mid-round.
        self.send_retries = max(1, send_retries)
        if auth_key is None:
            auth_key = os.environ.get(AUTH_KEY_ENV) or None
        self.auth_key = auth_key
        #: Advertised/spoken protocol version; ``protocol=1`` pins this end to
        #: the legacy pickled-blob frames (rolling upgrades, benchmarks).
        self.protocol = min(framing.PROTO_VERSION, protocol or framing.PROTO_VERSION)
        self._sock: Optional[socket.socket] = None
        self._inbox: dict[tuple[int, str], list] = {}
        #: (src, tag) → caller-registered receive buffers (``recv_into``): the
        #: accept thread lands a matching bulk payload directly in one of these
        #: instead of allocating.
        self._pending: dict[tuple[int, str], list[memoryview]] = {}
        self._cond = threading.Condition()
        self._shutdown = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None
        self._addr_cache: dict[int, tuple[str, int]] = {}
        #: ranged-read server: ``handler(request) -> (extra_header, parts)``
        #: registered by :meth:`serve_ranges` (the local checkpoint manager
        #: wires its shard files in); requests arrive as ``op: range_read``
        #: frames and are answered by dialing the requester back.
        self._range_handler: Optional[Callable] = None
        self._rr_counter = itertools.count()

    def start(self, host: Optional[str] = None, advertise_host: Optional[str] = None) -> None:
        """Bind the listener and publish its address.

        Frames are pickled, so an unauthenticated off-host listener would be remote
        code execution. The rules mirror :class:`KVServer`: with an auth key (arg or
        ``$TPU_RESILIENCY_STORE_KEY``) the default bind is ``0.0.0.0`` and every
        accepted connection must pass an HMAC challenge; without one the default is
        loopback, and an explicit non-loopback bind raises.
        """
        if host is None:
            host = "0.0.0.0" if self.auth_key else "127.0.0.1"
            if not self.auth_key:
                log.warning(
                    "PeerExchange: no auth key set — binding loopback only; "
                    f"cross-host replication requires ${AUTH_KEY_ENV}"
                )
        elif host not in ("127.0.0.1", "localhost", "::1") and not self.auth_key:
            raise ValueError(
                f"refusing to bind PeerExchange on non-loopback {host!r} without an "
                f"auth key (frames are pickled; unauthenticated exposure is remote "
                f"code execution). Pass auth_key= or set ${AUTH_KEY_ENV}."
            )
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, 0))
        self._sock.listen(128)
        port = self._sock.getsockname()[1]
        if advertise_host is None:
            # Replication cliques span hosts by design (replication_jump), so the
            # advertised address must be reachable off-host: a wildcard bind
            # advertises this host's resolvable name, a specific bind advertises
            # itself.
            advertise_host = _reachable_host() if host == "0.0.0.0" else host
        self.store.set(f"addr/{self.rank}", (advertise_host, port))
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"p2p-accept-{self.rank}", daemon=True
        )
        self._accept_thread.start()

    def close(self) -> None:
        self._shutdown.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        with self._cond:
            self._cond.notify_all()

    def _accept_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            if chaos.check_accept("p2p"):
                conn.close()  # injected EOF-on-accept; the sender retries
                continue
            conn = chaos.wrap(conn, "p2p")
            threading.Thread(
                target=self._recv_conn, args=(conn,), daemon=True, name="p2p-recv"
            ).start()

    def _claim_buffer(self, header: dict) -> Optional[memoryview]:
        """Accept-thread side of :meth:`recv_into`: pop a registered destination
        buffer for this frame's (src, tag) if one fits, else None (fresh alloc)."""
        try:
            key = (header["src"], header["tag"])
            nbytes = int(header["nbytes"])
        except (KeyError, TypeError, ValueError):
            return None
        with self._cond:
            bufs = self._pending.get(key)
            if not bufs:
                return None
            for i, view in enumerate(bufs):
                if view.nbytes >= nbytes:
                    return bufs.pop(i)
            log.warning(
                f"p2p: registered recv_into buffer(s) for {key} too small for "
                f"{nbytes} B frame; receiving into a fresh buffer"
            )
            return None

    def _recv_conn(self, conn: socket.socket) -> None:
        try:
            if not self._handshake_server(conn):
                return
            t0 = time.perf_counter()
            kind, msg, payload = framing.recv_any(
                conn, max_frame=P2P_MAX_FRAME, alloc=self._claim_buffer
            )
            if kind == "bulk":
                src, tag = msg["src"], msg["tag"]
            elif isinstance(msg, dict) and msg.get("op") == "range_read":
                # Request/response op, not inbox traffic: serve it on this
                # connection's thread (the reply dials the requester back).
                self._handle_range_read(msg)
                return
            else:
                src, tag, payload = msg["src"], msg["tag"], msg["blob"]
            nbytes = memoryview(payload).cast("B").nbytes if payload is not None else 0
            _transfer_event(
                "recv", nbytes, time.perf_counter() - t0, src=src, frame=kind,
                tag=tag,
            )
            with self._cond:
                self._inbox.setdefault((src, tag), []).append(payload)
                self._cond.notify_all()
        except (ConnectionError, EOFError, OSError, KeyError, TypeError, ValueError):
            log.warning("p2p: dropped malformed incoming frame", exc_info=True)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _handshake_server(self, conn: socket.socket) -> bool:
        """Challenge/response before any pickled payload is parsed (same hello
        protocol as ``KVServer`` — see its ``_accept``/``_parse`` auth path). No-op
        when auth is off (loopback-only bind). The hello's ``v`` advertises this
        end's protocol ceiling; the connecting sender picks the frame format."""
        nonce = secrets.token_bytes(16)
        framing.send_obj(
            conn, {"v": self.protocol, "auth": self.auth_key is not None, "nonce": nonce}
        )
        if self.auth_key is None:
            return True
        conn.settimeout(30.0)
        reply = framing.recv_obj(conn, max_frame=1024)
        ok = isinstance(reply, dict) and hmac.compare_digest(
            reply.get("mac", b""), _hmac(self.auth_key, nonce)
        )
        if not ok:
            log.warning("p2p: rejected connection with bad auth")
        conn.settimeout(None)
        return ok

    def _handshake_client(self, conn: socket.socket) -> int:
        """Returns the peer's advertised protocol version (1 for pre-versioned
        hellos — every peer has sent ``v`` since v1, but default defensively)."""
        hello = framing.recv_obj(conn, max_frame=1024)
        peer_v = 1
        if isinstance(hello, dict):
            try:
                peer_v = int(hello.get("v", 1))
            except (TypeError, ValueError):
                peer_v = 1
            if hello.get("auth"):
                if self.auth_key is None:
                    raise CheckpointError(
                        f"p2p peer requires authentication; set ${AUTH_KEY_ENV}"
                    )
                framing.send_obj(conn, {"mac": _hmac(self.auth_key, hello["nonce"])})
        return peer_v

    def _peer_addr(self, peer: int) -> tuple[str, int]:
        if peer not in self._addr_cache:
            try:
                self._addr_cache[peer] = tuple(
                    self.store.get(f"addr/{peer}", timeout=self.timeout)
                )
            except StoreTimeoutError as e:
                raise CheckpointError(f"p2p: no address published for rank {peer}") from e
        return self._addr_cache[peer]

    def _dial(self, dst: int) -> tuple[socket.socket, int]:
        """Connect + handshake; returns ``(socket, peer_protocol_version)``."""
        host, port = self._peer_addr(dst)
        chaos.check_connect("p2p", peer=str(dst))
        conn = socket.create_connection((host, port), timeout=self.timeout)
        conn = chaos.wrap(conn, "p2p", peer=str(dst))
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            peer_v = self._handshake_client(conn)
        except BaseException:
            conn.close()
            raise
        return conn, peer_v

    def _use_bulk(self, peer_v: int) -> bool:
        return peer_v >= framing.PROTO_V2 and self.protocol >= framing.PROTO_V2

    def _retry_send(self, dst: int, what: str, attempt_fn):
        """Run one dial-and-send attempt factory under the per-peer retry
        policy: a transport fault (reset, EOF mid-handshake, truncated frame)
        invalidates the cached peer address — the peer may have restarted on a
        new port — backs off, re-dials with a fresh hello, and reissues the
        whole send. Frames are delivered whole or not at all (a truncated bulk
        frame reads as EOF and is dropped by the receiver), so a re-send can
        duplicate a frame but never corrupt one; receivers treat a duplicate
        (src, tag) frame as inbox surplus that ``purge`` reclaims.
        """
        delay = 0.05
        last: Exception | None = None
        for attempt in range(self.send_retries):
            try:
                return attempt_fn()
            except (OSError, EOFError) as e:
                last = e
                self._addr_cache.pop(dst, None)
                if attempt + 1 >= self.send_retries:
                    break
                log.warning(
                    f"p2p: {what} to rank {dst} failed ({e!r}); "
                    f"retry {attempt + 1}/{self.send_retries - 1}"
                )
                record_event(
                    "checkpoint", "p2p_retry", dst=dst, what=what,
                    attempt=attempt + 1, error=repr(e),
                )
                time.sleep(delay)
                delay = min(delay * 2.0, 1.0)
        raise CheckpointError(
            f"p2p: {what} to rank {dst} failed after "
            f"{self.send_retries} attempt(s): {last!r}"
        ) from last

    def send(self, dst: int, tag: str, blob) -> None:
        """Push one bytes-like payload to a peer (sugar over :meth:`send_parts`)."""
        self.send_parts(dst, tag, [blob])

    def send_parts(self, dst: int, tag: str, parts: Sequence[Any]) -> int:
        """Send a payload as its constituent buffers, never joining them.

        On a v2 link the parts go out as one bulk frame, scatter-gathered from
        the caller's buffers (``socket.sendmsg``) — zero userspace copies. A v1
        peer gets the legacy pickled ``{"src", "tag", "blob"}`` frame (one join,
        the price of compatibility). Transient transport faults are absorbed by
        the per-peer retry policy (``send_retries``). Returns payload bytes sent.
        """
        return self._retry_send(
            dst, f"send({tag!r})", lambda: self._send_parts_once(dst, tag, parts)
        )

    def _send_parts_once(self, dst: int, tag: str, parts: Sequence[Any]) -> int:
        conn, peer_v = self._dial(dst)
        t0 = time.perf_counter()
        with conn:
            if self._use_bulk(peer_v):
                header = {"src": self.rank, "tag": tag}
                if self.wire_checksums:
                    from tpu_resiliency_torch.checkpoint import format as ckpt_format

                    crc = 0
                    for p in parts:
                        crc = ckpt_format.crc32c(p, crc)
                    # The algo rides along so a receiver built with the OTHER
                    # checksum implementation skips verification instead of
                    # dropping every frame as a false mismatch.
                    header["crc32c"] = crc
                    header["crc_algo"] = ckpt_format.CRC_ALGO
                nbytes = framing.send_bulk(conn, header, parts)
                frame = "bulk"
            else:
                blob = b"".join(bytes(memoryview(p).cast("B")) for p in parts)
                framing.send_obj(conn, {"src": self.rank, "tag": tag, "blob": blob})
                nbytes = len(blob)
                frame = "obj"
        _transfer_event("send", nbytes, time.perf_counter() - t0, dst=dst,
                        frame=frame, tag=tag)
        return nbytes

    def open_send_stream(self, dst: int, tag: str, nbytes: int) -> "StreamSend":
        """Open a send whose payload is pushed in chunks as it materializes —
        the pipelined-save primitive: the bulk preamble (total ``nbytes``)
        goes out immediately, then each checkpoint leaf hits the socket the
        moment its D2H transfer lands, overlapping device copies with the wire.

        On a v2 link the chunks stream straight onto the open connection; a v1
        peer can only accept whole pickled frames, so chunks are buffered and
        sent as one legacy frame at ``close()`` (compatibility, not speed).
        Always ``close()`` (success) or ``abort()`` (failure) the handle — an
        under-sent bulk frame otherwise desyncs the peer's stream. The open
        (dial + preamble) is retried like any send; once chunks are flowing a
        fault aborts the stream (the caller's leaves are transient — replaying
        them is the save engine's call, not this layer's)."""

        def attempt():
            conn, peer_v = self._dial(dst)
            use_bulk = self._use_bulk(peer_v)
            try:
                if use_bulk:
                    framing.send_bulk_start(
                        conn, {"src": self.rank, "tag": tag}, nbytes
                    )
            except BaseException:
                conn.close()
                raise
            return StreamSend(self, conn, use_bulk, dst, tag, nbytes)

        return self._retry_send(dst, f"stream open({tag!r})", attempt)

    def send_file(self, dst: int, tag: str, path: str) -> int:
        """Stream an on-disk payload to a peer.

        On a v2 link the file is spliced kernel-side with ``os.sendfile`` — the
        shard never enters userspace. A v1 peer forces the legacy whole-blob
        frame (read + pickle). Transient transport faults are absorbed by the
        per-peer retry policy (the file is still there — a re-send is free).
        Returns payload bytes sent.
        """
        return self._retry_send(
            dst, f"send_file({path!r})", lambda: self._send_file_once(dst, tag, path)
        )

    def _send_file_once(self, dst: int, tag: str, path: str) -> int:
        conn, peer_v = self._dial(dst)
        t0 = time.perf_counter()
        with conn:
            if self._use_bulk(peer_v):
                nbytes = framing.send_bulk_file(
                    conn, {"src": self.rank, "tag": tag}, path
                )
                frame = "file"
            else:
                with open(path, "rb") as f:
                    blob = f.read()
                framing.send_obj(conn, {"src": self.rank, "tag": tag, "blob": blob})
                nbytes = len(blob)
                frame = "obj"
        _transfer_event("send", nbytes, time.perf_counter() - t0, dst=dst,
                        frame=frame, tag=tag)
        return nbytes

    def recv(self, src: int, tag: str, timeout: Optional[float] = None):
        """Block for a matching frame; returns its payload (bytes-like: ``bytes``
        from a v1 frame, a ``memoryview`` over the receive buffer from a bulk
        frame — pass it to ``format.deserialize_from_buffer`` / ``write_parts``
        without copying)."""
        deadline = time.monotonic() + (timeout or self.timeout)
        key = (src, tag)
        with self._cond:
            while not self._inbox.get(key):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise CheckpointError(f"p2p: timed out waiting for {tag!r} from rank {src}")
                self._cond.wait(timeout=min(remaining, 1.0))
            return self._inbox[key].pop(0)

    def recv_into(self, src: int, tag: str, buf, timeout: Optional[float] = None) -> int:
        """Receive a matching frame directly into ``buf``; returns payload size.

        Registering ``buf`` before the frame arrives lets the accept thread
        ``recv_into`` the wire payload straight into it — zero extra allocation
        and zero copies. If the frame raced ahead of the registration (already
        in the inbox) or came from a v1 peer, the payload lands with one copy.
        At most one in-flight frame per (src, tag) is supported on this path —
        the per-round unique-tag discipline the replication layer follows.
        """
        base = buf.obj if isinstance(buf, memoryview) else buf
        view = memoryview(buf).cast("B")
        key = (src, tag)
        with self._cond:
            self._pending.setdefault(key, []).append(view)
        try:
            got = self.recv(src, tag, timeout)
        finally:
            with self._cond:
                bufs = self._pending.get(key)
                if bufs is not None:
                    try:
                        bufs.remove(view)
                    except ValueError:
                        pass  # claimed by the accept thread — the fast path
                    if not bufs:
                        self._pending.pop(key, None)
        gv = memoryview(got).cast("B")
        n = gv.nbytes
        if gv.obj is base:
            return n  # landed in place
        if n > view.nbytes:
            raise CheckpointError(
                f"p2p: recv_into buffer too small for {tag!r} from rank {src}: "
                f"{view.nbytes} < {n}"
            )
        view[:n] = gv
        return n

    # -- ranged reads (the elastic-reshard wire op) ------------------------

    def serve_ranges(self, handler: Optional[Callable]) -> None:
        """Register (or clear, with ``None``) the ranged-read server.

        ``handler(request: dict) -> (extra_header: dict, parts: list)`` runs
        on a p2p connection thread for every incoming ``range_read`` frame:
        it resolves the request (for checkpoints: an ``(owner, iteration)``
        container plus leaf-relative byte ranges — see
        ``LocalCheckpointManager``) and returns the byte parts to ship back.
        Exceptions become structured error replies, never dropped requests.
        """
        self._range_handler = handler

    def fetch_ranges(
        self, dst: int, request: dict, timeout: Optional[float] = None
    ) -> tuple[dict, list[memoryview]]:
        """Read byte ranges from a peer: one small request frame out, one bulk
        reply back, each part CRC-verified (the PR-5 checksummer) before it is
        returned. The reshard load path fetches ONLY the ranges a rank newly
        owns this way, instead of retrieving whole mirror containers.

        Returns ``(reply_header, parts)`` — parts are zero-copy views over the
        reply's receive buffer, ordered like ``request["ranges"]``. Raises
        :class:`CheckpointError` on a structured error reply, a checksum
        mismatch, or transport failure (after the per-peer retry policy).
        """
        tag = f"rread/{self.rank}/{next(self._rr_counter)}"
        frame = {"op": "range_read", "src": self.rank, "reply_tag": tag,
                 "req": request}

        def attempt():
            conn, _ = self._dial(dst)
            with conn:
                framing.send_obj(conn, frame)

        self._retry_send(dst, f"range_read({tag!r})", attempt)
        payload = self.recv(dst, tag, timeout)
        return self._parse_range_reply(payload, dst)

    def _parse_range_reply(
        self, payload, src: int
    ) -> tuple[dict, list[memoryview]]:
        from tpu_resiliency_torch.checkpoint import format as ckpt_format

        mv = memoryview(payload).cast("B")
        try:
            (hlen,) = _RR_LEN.unpack(mv[: _RR_LEN.size])
            header = pickle.loads(mv[_RR_LEN.size : _RR_LEN.size + hlen])
        except Exception as e:
            raise CheckpointError(
                f"p2p: malformed range_read reply from rank {src} ({e!r})"
            ) from e
        if not header.get("ok"):
            raise CheckpointError(
                f"p2p: range_read against rank {src} failed: "
                f"{header.get('error', 'unknown error')}"
            )
        parts: list[memoryview] = []
        off = _RR_LEN.size + hlen
        lengths = header.get("lengths") or []
        crcs = header.get("crc32c") or []
        verify = header.get("crc_algo") == ckpt_format.CRC_ALGO and len(
            crcs
        ) == len(lengths)
        for i, n in enumerate(lengths):
            n = int(n)
            if off + n > mv.nbytes:
                raise CheckpointError(
                    f"p2p: truncated range_read reply from rank {src} "
                    f"(part {i} wants {n} bytes past the frame)"
                )
            window = mv[off : off + n]
            # Per-range verification: each range is checksummed by the sender
            # and re-checked here before the caller ever sees the bytes.
            if verify and ckpt_format.crc32c(window) != crcs[i]:
                raise CheckpointError(
                    f"p2p: range_read part {i} from rank {src} failed its "
                    f"checksum (range corrupted in flight)"
                )
            parts.append(window)
            off += n
        return header, parts

    def _handle_range_read(self, msg: dict) -> None:
        from tpu_resiliency_torch.checkpoint import format as ckpt_format

        try:
            src, tag = int(msg["src"]), str(msg["reply_tag"])
        except (KeyError, TypeError, ValueError):
            log.warning("p2p: dropped malformed range_read request")
            return
        handler = self._range_handler
        views: list[memoryview] = []
        try:
            if handler is None:
                raise CheckpointError(
                    f"rank {self.rank} serves no ranged reads (no local "
                    f"checkpoint manager registered)"
                )
            extra, parts = handler(msg.get("req") or {})
            views = [memoryview(p).cast("B") for p in parts]
            header = {
                "ok": True,
                "lengths": [v.nbytes for v in views],
                "crc32c": [ckpt_format.crc32c(v) for v in views],
                "crc_algo": ckpt_format.CRC_ALGO,
                **(extra or {}),
            }
        except Exception as e:
            header, views = {"ok": False, "error": str(e)}, []
        blob = pickle.dumps(header, protocol=pickle.HIGHEST_PROTOCOL)
        try:
            self.send_parts(src, tag, [_RR_LEN.pack(len(blob)), blob, *views])
        except CheckpointError as e:
            # The requester timed out / died; it owns its own recovery.
            log.warning(f"p2p: range_read reply to rank {src} failed: {e}")

    def purge(self, tag_prefix: str) -> int:
        """Drop queued frames (and pending ``recv_into`` registrations) whose tag
        starts with ``tag_prefix``; returns the number of frames dropped.

        Frames nobody ever ``recv``\\ s — a peer restarted mid-round, an
        abandoned replication round — would otherwise pin their multi-GB
        payloads in ``_inbox`` for the process's lifetime, and stale frames
        under a reused tag would be mis-delivered to the next round.
        ``CliqueReplicationStrategy.rebuild`` calls this when it resets its
        round counter.
        """
        with self._cond:
            dead = [k for k in self._inbox if k[1].startswith(tag_prefix)]
            n = sum(len(self._inbox[k]) for k in dead)
            for k in dead:
                del self._inbox[k]
            for k in [k for k in self._pending if k[1].startswith(tag_prefix)]:
                del self._pending[k]
        if n:
            log.info(f"p2p: purged {n} stale frame(s) under tag prefix {tag_prefix!r}")
        return n


class StreamSend:
    """One open, chunked payload send (see :meth:`PeerExchange.open_send_stream`).

    ``send_chunk`` pushes raw bytes onto the wire (v2) or buffers them (v1
    peer). ``close()`` completes the frame — it verifies exactly the promised
    byte count was sent (an under-sent bulk frame would desync the receiver's
    stream) and emits the ``p2p_transfer`` event. ``abort()`` tears the
    connection down so the peer sees EOF instead of a stuck partial frame.
    """

    def __init__(
        self,
        ex: PeerExchange,
        conn: socket.socket,
        use_bulk: bool,
        dst: int,
        tag: str,
        nbytes: int,
    ):
        self._ex = ex
        self._conn = conn
        self._use_bulk = use_bulk
        self.dst = dst
        self.tag = tag
        self.nbytes = nbytes
        self._sent = 0
        self._t0 = time.perf_counter()
        self._chunks: list[bytes] = []  # v1 fallback buffer
        self._closed = False

    def send_chunk(self, chunk) -> int:
        v = memoryview(chunk).cast("B")
        if self._sent + v.nbytes > self.nbytes:
            raise CheckpointError(
                f"p2p: stream to rank {self.dst} overran its declared size "
                f"({self._sent + v.nbytes} > {self.nbytes})"
            )
        try:
            if self._use_bulk:
                self._conn.sendall(v)
            else:
                self._chunks.append(bytes(v))
        except OSError as e:
            self.abort()
            raise CheckpointError(
                f"p2p: stream send to rank {self.dst} failed: {e!r}"
            ) from e
        self._sent += v.nbytes
        return v.nbytes

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            if self._sent != self.nbytes:
                raise CheckpointError(
                    f"p2p: stream to rank {self.dst} closed after {self._sent} of "
                    f"{self.nbytes} bytes"
                )
            if not self._use_bulk:
                framing.send_obj(
                    self._conn,
                    {"src": self._ex.rank, "tag": self.tag,
                     "blob": b"".join(self._chunks)},
                )
        except OSError as e:
            raise CheckpointError(
                f"p2p: stream close to rank {self.dst} failed: {e!r}"
            ) from e
        finally:
            self._chunks = []
            try:
                self._conn.close()
            except OSError:
                pass
        _transfer_event(
            "send", self.nbytes, time.perf_counter() - self._t0,
            dst=self.dst, frame="bulk" if self._use_bulk else "obj",
            tag=self.tag,
        )

    def abort(self) -> None:
        """Drop the connection mid-frame; the peer's receive loop sees EOF and
        discards the partial payload."""
        self._closed = True
        self._chunks = []
        try:
            self._conn.close()
        except OSError:
            pass

    def __enter__(self) -> "StreamSend":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:
            self.abort()
