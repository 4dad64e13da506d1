"""Shared wire framing: 8-byte big-endian length prefix + pickle payload.

Single implementation used by the TCP coordination store (``platform/store.py``), the
local UDS IPC (``platform/ipc.py``), and the checkpoint peer-exchange links
(``checkpoint/comm.py``) so the wire protocol evolves in one place. The length prefix
is 64-bit because peer-exchange frames carry whole checkpoint shards (multi-GB).

Because every channel funnels through these helpers, this is also the boundary
where deterministic network fault injection applies: ``platform/chaos.py`` wraps
the sockets handed to these functions (resets, mid-frame truncation, stalls —
see ``docs/chaos.md``), and the channels' retry layers are tested against it.

Two frame kinds share one stream (version 2 of the p2p protocol):

- **object frame** (v1, unchanged): ``len(!Q) | pickle`` — control messages and
  small payloads, and the compatibility format for whole-shard blobs.
- **bulk frame** (v2): ``BULK_MAGIC(8) | header_len(!Q) | header pickle | raw
  payload bytes`` — the streaming path for multi-GB shards. The header is a small
  pickled dict carrying routing metadata plus ``nbytes``; the payload never
  transits pickle. Senders scatter-gather an iovec list straight onto the socket
  (:func:`send_bulk`) or splice a file with ``os.sendfile`` (:func:`send_bulk_file`);
  receivers :func:`recv_any` into ONE preallocated buffer. ``BULK_MAGIC`` read as a
  v1 length prefix is ~6.1e18 bytes — beyond any ``max_frame`` — so an old receiver
  rejects a bulk frame cleanly instead of misparsing it, and a v1 length can never
  alias the magic.
"""

from __future__ import annotations

import asyncio
import os
import pickle
import socket
import struct
from typing import Any, Optional, Sequence

LEN = struct.Struct("!Q")
DEFAULT_MAX_FRAME = 64 * 1024 * 1024

#: p2p protocol versions, negotiated via the hello's ``v`` field: a v2 sender
#: talking to a v1 receiver falls back to object frames; a v1 sender's object
#: frames are always accepted by a v2 receiver (``recv_any``).
PROTO_V1 = 1
PROTO_V2 = 2
PROTO_VERSION = PROTO_V2

#: Interpreted as a !Q length this is 6075449640710064946 — rejected by every
#: ``max_frame`` check a v1 peer could hold, so the two frame kinds are
#: self-discriminating on the first 8 bytes.
BULK_MAGIC = b"TPUBULK2"
assert LEN.unpack(BULK_MAGIC)[0] > (1 << 62)

#: Max pickled-header size of a bulk frame (routing metadata only, never payload).
MAX_BULK_HEADER = 1 << 20

#: Linux UIO_MAXIOV is 1024; batch sendmsg iovecs below it.
_IOV_MAX = 1000

#: Chunk size for the sendfile fallback read loop (no sendfile support / EINVAL).
_FILE_CHUNK = 4 * 1024 * 1024


def encode_obj(obj: Any) -> bytes:
    """One frame, ready for the wire."""
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    return LEN.pack(len(payload)) + payload


def decode_frame(buf, max_frame: int = DEFAULT_MAX_FRAME):
    """Incremental counterpart of :func:`recv_obj` for event-loop readers: try to
    decode one frame from the head of ``buf`` (any bytes-like). Returns
    ``(obj, bytes_consumed)``, or ``None`` if the frame is still incomplete.
    Raises ``ValueError`` on an oversized frame (the caller should drop the peer).
    """
    if len(buf) < LEN.size:
        return None
    (length,) = LEN.unpack(bytes(buf[: LEN.size]))
    if length > max_frame:
        raise ValueError(f"frame too large: {length} > {max_frame}")
    end = LEN.size + length
    if len(buf) < end:
        return None
    return pickle.loads(bytes(buf[LEN.size : end])), end


def send_obj(sock: socket.socket, obj: Any) -> None:
    sock.sendall(encode_obj(obj))


def recv_exact_into(sock: socket.socket, view: memoryview) -> None:
    """Fill ``view`` completely from the socket — the single receive primitive
    every channel shares. ``recv_into`` writes straight into the caller's buffer,
    so no intermediate chunk objects or joins exist at any payload size."""
    while view.nbytes:
        n = sock.recv_into(view)
        if n == 0:
            raise EOFError("peer closed connection")
        view = view[n:]


def recv_exact(sock: socket.socket, n: int) -> memoryview:
    """Exactly ``n`` bytes as a view over one preallocated buffer.

    Returns a ``memoryview`` (bytes-like; fine for ``pickle.loads`` /
    ``struct.unpack``) rather than ``bytes`` — the historical
    ``bytes(bytearray)`` tail copied every payload a second time, which on the
    p2p channel meant an extra multi-GB allocation per shard.
    """
    buf = memoryview(bytearray(n))
    recv_exact_into(sock, buf)
    return buf


def recv_obj(sock: socket.socket, max_frame: int = DEFAULT_MAX_FRAME) -> Any:
    (length,) = LEN.unpack(recv_exact(sock, LEN.size))
    if length > max_frame:
        raise ValueError(f"frame too large: {length} > {max_frame}")
    return pickle.loads(recv_exact(sock, length))


async def read_obj_stream(reader: asyncio.StreamReader, max_frame: int = DEFAULT_MAX_FRAME) -> Any:
    header = await reader.readexactly(LEN.size)
    (length,) = LEN.unpack(header)
    if length > max_frame:
        raise ValueError(f"frame too large: {length} > {max_frame}")
    return pickle.loads(await reader.readexactly(length))


async def write_obj_stream(writer: asyncio.StreamWriter, obj: Any) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    writer.write(LEN.pack(len(payload)) + payload)
    await writer.drain()


# -- bulk (raw payload) frames ----------------------------------------------


def _byte_views(parts: Sequence[Any]) -> list[memoryview]:
    """Normalize bytes-like parts to flat uint8 views; drops empties."""
    views = []
    for p in parts:
        v = memoryview(p).cast("B")
        if v.nbytes:
            views.append(v)
    return views


def _sendmsg_all(sock: socket.socket, views: list[memoryview]) -> None:
    """Scatter-gather sendall: every byte of every view, no join.

    Handles partial sends (advance within a view) and iovec-count limits
    (batches of ``_IOV_MAX``). Falls back to per-view ``sendall`` where
    ``sendmsg`` is unavailable.
    """
    if not hasattr(sock, "sendmsg"):
        for v in views:
            sock.sendall(v)
        return
    idx = 0
    while idx < len(views):
        sent = sock.sendmsg(views[idx : idx + _IOV_MAX])
        while sent > 0:
            v = views[idx]
            if sent >= v.nbytes:
                sent -= v.nbytes
                idx += 1
            else:
                views[idx] = v[sent:]
                sent = 0


def _bulk_preamble(header: dict, nbytes: int) -> tuple[bytes, dict]:
    hdr = dict(header)
    hdr["nbytes"] = nbytes
    hb = pickle.dumps(hdr, protocol=pickle.HIGHEST_PROTOCOL)
    if len(hb) > MAX_BULK_HEADER:
        raise ValueError(f"bulk header too large: {len(hb)} > {MAX_BULK_HEADER}")
    return BULK_MAGIC + LEN.pack(len(hb)) + hb, hdr


def send_bulk(sock: socket.socket, header: dict, parts: Sequence[Any]) -> int:
    """One bulk frame: pickled ``header`` (stamped with ``nbytes``) + the raw
    bytes of ``parts``, scatter-gathered from the caller's buffers. No joined
    payload ever exists on the send side. Returns payload bytes sent."""
    views = _byte_views(parts)
    nbytes = sum(v.nbytes for v in views)
    pre, _ = _bulk_preamble(header, nbytes)
    _sendmsg_all(sock, [memoryview(pre), *views])
    return nbytes


def send_bulk_start(sock: socket.socket, header: dict, nbytes: int) -> None:
    """Open a bulk frame whose payload will be streamed in chunks.

    Sends the preamble (magic + pickled ``header`` stamped with the TOTAL
    ``nbytes``) and returns; the caller then pushes exactly ``nbytes`` payload
    bytes with plain ``sendall`` as they become available — e.g. checkpoint
    leaves resolving off the D2H queue. The receiver cannot tell a streamed
    frame from a :func:`send_bulk` one: ``recv_any`` just fills its buffer as
    bytes arrive, so the two ends pipeline naturally. Under-sending desyncs
    the stream — the caller must either complete the payload or close the
    socket (the receiver sees EOF and drops the frame)."""
    pre, _ = _bulk_preamble(header, nbytes)
    sock.sendall(pre)


def send_bulk_file(
    sock: socket.socket,
    header: dict,
    path: str,
    offset: int = 0,
    count: Optional[int] = None,
) -> int:
    """Bulk frame whose payload is spliced from ``path`` with ``os.sendfile`` —
    zero userspace copies for shards already on disk (mirror re-spreads, shard
    routing). Falls back to a bounded read/sendall loop where sendfile is
    unsupported. Returns payload bytes sent."""
    nbytes = (os.path.getsize(path) - offset) if count is None else count
    pre, _ = _bulk_preamble(header, nbytes)
    sock.sendall(pre)
    with open(path, "rb") as f:
        off, remaining = offset, nbytes
        use_sendfile = hasattr(os, "sendfile")
        while remaining:
            if use_sendfile:
                try:
                    sent = os.sendfile(sock.fileno(), f.fileno(), off, remaining)
                except OSError:
                    # EINVAL/ENOSYS (fs or platform without support): degrade to
                    # the copy loop for the rest of this payload.
                    use_sendfile = False
                    continue
                if sent == 0:
                    raise EOFError("peer closed connection during sendfile")
                off += sent
                remaining -= sent
            else:
                f.seek(off)
                chunk = f.read(min(_FILE_CHUNK, remaining))
                if not chunk:
                    raise EOFError(f"{path}: truncated during send")
                sock.sendall(chunk)
                off += len(chunk)
                remaining -= len(chunk)
    return nbytes


def recv_any(
    sock: socket.socket,
    max_frame: int = DEFAULT_MAX_FRAME,
    alloc=None,
):
    """Receive either frame kind from a stream that may carry both.

    Returns ``("obj", obj, None)`` for a v1 object frame or
    ``("bulk", header, payload_view)`` for a bulk frame. ``alloc(header)`` may
    return a writable preallocated buffer of at least ``header["nbytes"]`` bytes
    (a registered ``recv_into`` destination); returning ``None`` — or a too-small
    buffer — falls back to a fresh allocation. Either way the payload is received
    by ``recv_into`` directly into its final buffer: one allocation, zero copies.

    A bulk header carrying ``crc32c`` (senders opt in —
    ``PeerExchange(wire_checksums=True)``) is verified against the landed
    payload; a mismatch raises ``ValueError`` like any malformed frame, so the
    receive loop drops it and the sender-side retry/degrade machinery owns
    recovery. Verification is skipped (not failed) when the header's
    ``crc_algo`` is not the one this host computes.
    """
    head = recv_exact(sock, LEN.size)
    if bytes(head) == BULK_MAGIC:
        (hlen,) = LEN.unpack(recv_exact(sock, LEN.size))
        if hlen > MAX_BULK_HEADER:
            raise ValueError(f"bulk header too large: {hlen} > {MAX_BULK_HEADER}")
        header = pickle.loads(recv_exact(sock, hlen))
        nbytes = int(header["nbytes"])
        if nbytes > max_frame:
            raise ValueError(f"frame too large: {nbytes} > {max_frame}")
        buf = alloc(header) if alloc is not None else None
        if buf is not None:
            view = memoryview(buf).cast("B")
            if view.nbytes < nbytes:
                buf = None
        if buf is None:
            view = memoryview(bytearray(nbytes))
        payload = view[:nbytes]
        recv_exact_into(sock, payload)
        if "crc32c" in header:
            # Layering note: the checksum implementation lives with the
            # container format (one algo tag for disk and wire); import
            # lazily, only for frames that actually carry a CRC.
            from tpu_resiliency_torch.checkpoint.format import CRC_ALGO, crc32c

            if header.get("crc_algo", CRC_ALGO) == CRC_ALGO and crc32c(
                payload
            ) != int(header["crc32c"]):
                raise ValueError(
                    f"bulk frame payload checksum mismatch "
                    f"({nbytes} bytes from src={header.get('src')!r})"
                )
        return "bulk", header, payload
    (length,) = LEN.unpack(head)
    if length > max_frame:
        raise ValueError(f"frame too large: {length} > {max_frame}")
    return "obj", pickle.loads(recv_exact(sock, length)), None
