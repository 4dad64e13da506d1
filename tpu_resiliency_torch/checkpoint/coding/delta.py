"""Delta checkpoints: ship only chunks that changed since the last save.

Steady-state training mutates a small fraction of the state between
checkpoint intervals (optimizer moments and touched parameters), yet the
mirror strategy re-ships every byte every round — BENCH_ckpt_save.json shows
the 1 GB save bandwidth-bound on exactly that. The ``TPURES03`` chunk
manifest (``checkpoint/format.py``) makes consecutive saves diffable for
free: the per-chunk CRCs both saves already compute ARE the diff input.

Protocol: between full **keyframes** (every ``delta_interval``-th save, and
whenever the tree signature changes), replication ships a **delta frame**
instead of the container::

    TPUDLT01 | header_len(8 LE) | header pickle | changed chunk bytes...

The header carries the new container's full prefix and trailer (they are
small and change every save — the iteration rides in meta), the base
iteration + base container digest (the chain link), the chunk size, per-leaf
sizes, and the changed ``(leaf, chunk)`` list. A receiver holding the base
container applies the delta as ranged writes: unchanged chunks stream from
its base copy, changed chunks from the frame, new prefix/trailer verbatim —
producing the exact bytes of the sender's container (METADATA-validated: the
base's digest must match the frame's chain link and every unchanged chunk's
manifest CRC must be identical between base and new trailers, so a stale or
corrupt base can never silently assemble a wrong container).

A broken chain (receiver lacks the base, digests disagree) drops that
mirror for the round — one ``ckpt_delta_applied{outcome=broken}`` event —
and the shard simply has fewer mirrors until the next keyframe re-bases
everyone; at load time the existing group-agreed fallback ladder owns any
resulting coverage gap, falling back to the newest loadable keyframe chain.
"""

from __future__ import annotations

import os
import pickle
import struct
from typing import Any, Optional, Sequence

from tpu_resiliency_torch.checkpoint import format as ckpt_format
from tpu_resiliency_torch.exceptions import CheckpointError
from tpu_resiliency_torch.utils.events import record as record_event
from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)

DELTA_MAGIC = b"TPUDLT01"
DELTA_SCHEMA = "tpu-ckpt-delta-1"
_LEN = struct.Struct("<Q")

#: Env default for the manager's ``delta_interval`` knob (0/1 = off; N means
#: one keyframe then up to N-1 delta saves per cycle).
DELTA_ENV = "TPU_RESILIENCY_CKPT_DELTA"


def interval_from_env(value: Optional[int] = None) -> int:
    if value is not None:
        return max(0, int(value))
    try:
        return max(0, int(os.environ.get(DELTA_ENV, "0")))
    except ValueError:
        return 0


def is_delta(buf) -> bool:
    mv = memoryview(buf)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    return (
        mv.nbytes >= len(DELTA_MAGIC)
        and bytes(mv[: len(DELTA_MAGIC)]) == DELTA_MAGIC
    )


class DeltaTracker:
    """Per-manager memory of the previous save's chunk manifest.

    ``eligible()`` answers the foreground question — can the NEXT save ship a
    delta? — from the leaf signature alone; ``note_saved()`` records a
    completed save's manifest (every save, keyframe or delta, re-bases the
    chain on its own new manifest, so consecutive deltas chain
    base→base→...→keyframe)."""

    def __init__(self, interval: Optional[int] = None):
        self.interval = interval_from_env(interval)
        self._base: Optional[dict] = None
        self._since_keyframe = 0

    @property
    def enabled(self) -> bool:
        return self.interval > 1

    def eligible(self, leaf_sizes: Sequence[int]) -> Optional[dict]:
        """The base descriptor when the next save may ship a delta, else
        ``None`` (keyframe due, no base yet, or the tree signature moved)."""
        if not self.enabled or self._base is None:
            return None
        if self._since_keyframe >= self.interval - 1:
            return None
        if list(self._base["leaf_sizes"]) != [int(n) for n in leaf_sizes]:
            return None
        return self._base

    def note_saved(
        self,
        iteration: int,
        leaf_sizes: Sequence[int],
        chunk_size: int,
        leaf_chunks: Sequence[Sequence[int]],
        container_crc: int,
        keyframe: bool,
    ) -> None:
        self._since_keyframe = 0 if keyframe else self._since_keyframe + 1
        self._base = {
            "iteration": int(iteration),
            "leaf_sizes": [int(n) for n in leaf_sizes],
            "chunk_size": int(chunk_size),
            "leaf_chunks": [list(c) for c in leaf_chunks],
            "container_crc": int(container_crc),
        }

    def reset(self) -> None:
        """Drop the chain (group rebuild, reshard) — next save keyframes."""
        self._base = None
        self._since_keyframe = 0


def encode_delta(
    owner: int,
    iteration: int,
    base: dict,
    prefix: bytes,
    leaf_views: Sequence[Any],
    trailer: bytes,
) -> tuple[bytes, dict]:
    """Build a delta frame for the container ``prefix + leaf_views + trailer``
    against ``base`` (a :class:`DeltaTracker` descriptor). Returns
    ``(frame_bytes, stats)`` with ``stats`` carrying the byte economy
    (``full_bytes`` vs ``frame_bytes``, chunk counts) for events/benches.

    Raises :class:`CheckpointError` when the new container is not chain-
    compatible with the base (manifest geometry moved) — callers fall back
    to a keyframe."""
    info = ckpt_format.parse_trailer_v3(trailer, source="delta-encode")
    leaf_sizes = [memoryview(v).nbytes for v in leaf_views]
    if (
        info.chunk_size != base["chunk_size"]
        or leaf_sizes != base["leaf_sizes"]
    ):
        raise CheckpointError(
            "delta: new container's chunk geometry does not match the base"
        )
    new_chunks = info.leaf_chunk_crcs(leaf_sizes)
    changed: list[tuple[int, int]] = []
    for leaf, (old, new) in enumerate(zip(base["leaf_chunks"], new_chunks)):
        if len(old) != len(new):
            raise CheckpointError("delta: chunk count moved between saves")
        for ci, (a, b) in enumerate(zip(old, new)):
            if a != b:
                changed.append((leaf, ci))
    header = {
        "schema": DELTA_SCHEMA,
        "owner": int(owner),
        "iteration": int(iteration),
        "base_iteration": base["iteration"],
        "base_container_crc": base["container_crc"],
        "chunk_size": info.chunk_size,
        "leaf_sizes": leaf_sizes,
        "changed": changed,
        "prefix": bytes(prefix),
        "trailer": bytes(trailer),
    }
    hb = pickle.dumps(header, protocol=pickle.HIGHEST_PROTOCOL)
    parts: list[Any] = [DELTA_MAGIC + _LEN.pack(len(hb)) + hb]
    cs = info.chunk_size
    sent = 0
    for leaf, ci in changed:
        mv = memoryview(leaf_views[leaf])
        if mv.ndim != 1 or mv.itemsize != 1:
            mv = mv.cast("B")
        window = mv[ci * cs : min((ci + 1) * cs, leaf_sizes[leaf])]
        parts.append(window)
        sent += window.nbytes
    full = len(prefix) + sum(leaf_sizes) + len(trailer)
    frame = b"".join(bytes(p) if not isinstance(p, bytes) else p for p in parts)
    stats = {
        "full_bytes": full,
        "frame_bytes": len(frame),
        "chunks_total": len(info.chunk_crcs),
        "chunks_changed": len(changed),
        "changed_bytes": sent,
    }
    return frame, stats


def parse_delta(buf, source: str = "delta") -> tuple[dict, memoryview]:
    """``(header, changed_bytes_view)`` with structural validation."""
    mv = memoryview(buf)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    head = len(DELTA_MAGIC) + _LEN.size
    if mv.nbytes < head or bytes(mv[: len(DELTA_MAGIC)]) != DELTA_MAGIC:
        raise CheckpointError(f"{source}: not a delta frame")
    (hlen,) = _LEN.unpack(mv[len(DELTA_MAGIC) : head])
    if head + hlen > mv.nbytes:
        raise CheckpointError(f"{source}: truncated delta frame header")
    try:
        header = pickle.loads(mv[head : head + hlen])
        assert header.get("schema") == DELTA_SCHEMA
        int(header["iteration"]); int(header["base_iteration"])
        list(header["changed"]); list(header["leaf_sizes"])
    except Exception as e:
        raise CheckpointError(f"{source}: corrupt delta frame header ({e!r})") from e
    return header, mv[head + hlen :]


def apply_delta(frame, base_path: str, out_path: str) -> int:
    """Materialize the full new container at ``out_path`` from ``frame`` + the
    base container at ``base_path``; returns bytes written.

    Chain validation is metadata-only (O(trailer), no payload scan): the
    base's recorded container digest must equal the frame's chain link, and
    every UNCHANGED chunk's CRC must be identical between the base and new
    manifests (changed chunks arrive in the frame and are checked against
    the new manifest as they are written). Any disagreement raises
    :class:`CheckpointError` — a broken chain never assembles a container."""
    header, payload = parse_delta(frame, source=os.path.basename(out_path))
    try:
        base_header, base_prefix_len, base_info = ckpt_format.read_trailer(
            base_path
        )
    except (CheckpointError, OSError) as e:
        raise CheckpointError(
            f"delta: base container {base_path} unusable ({e})"
        ) from e
    if base_info is None or base_info.chunk_crcs is None:
        raise CheckpointError(
            f"delta: base container {base_path} carries no chunk manifest"
        )
    if base_info.container_crc != header["base_container_crc"]:
        raise CheckpointError(
            f"delta: base container {base_path} is not the frame's base "
            f"(digest mismatch — stale or divergent chain)"
        )
    leaf_sizes = [int(n) for n in header["leaf_sizes"]]
    base_sizes = [int(s["nbytes"]) for s in base_header["leaves"]]
    cs = int(header["chunk_size"])
    if base_sizes != leaf_sizes or base_info.chunk_size != cs:
        raise CheckpointError(
            f"delta: base container {base_path} geometry mismatch"
        )
    new_info = ckpt_format.parse_trailer_v3(
        header["trailer"], source=os.path.basename(out_path)
    )
    new_chunks = new_info.leaf_chunk_crcs(leaf_sizes)
    base_chunks = base_info.leaf_chunk_crcs(leaf_sizes)
    changed = {(int(l), int(c)) for l, c in header["changed"]}
    for leaf, (old, new) in enumerate(zip(base_chunks, new_chunks)):
        for ci, (a, b) in enumerate(zip(old, new)):
            if (leaf, ci) in changed:
                continue
            if a != b:
                raise CheckpointError(
                    f"delta: unchanged chunk (leaf {leaf}, chunk {ci}) "
                    f"disagrees between base and new manifests — broken chain"
                )
    # Frame payload offsets per changed chunk, in header['changed'] order.
    frame_off: dict[tuple[int, int], tuple[int, int]] = {}
    pos = 0
    for l, c in header["changed"]:
        l, c = int(l), int(c)
        n = min(cs, leaf_sizes[l] - c * cs)
        frame_off[(l, c)] = (pos, n)
        pos += n
    if pos > memoryview(payload).nbytes:
        raise CheckpointError("delta: frame payload shorter than its manifest")

    def chunks():
        yield header["prefix"]
        with open(base_path, "rb") as bf:
            base_offs = []
            p = base_prefix_len
            for n in leaf_sizes:
                base_offs.append(p)
                p += n
            for leaf, n in enumerate(leaf_sizes):
                for ci in range(ckpt_format.leaf_chunk_count(n, cs)):
                    clen = min(cs, n - ci * cs)
                    if (leaf, ci) in changed:
                        off, fn = frame_off[(leaf, ci)]
                        window = memoryview(payload)[off : off + fn]
                        if ckpt_format.crc32c(window) != new_chunks[leaf][ci]:
                            raise CheckpointError(
                                f"delta: shipped chunk (leaf {leaf}, chunk "
                                f"{ci}) fails its manifest CRC"
                            )
                        yield window
                    else:
                        bf.seek(base_offs[leaf] + ci * cs)
                        buf = bf.read(clen)
                        if len(buf) != clen:
                            raise CheckpointError(
                                f"delta: base container short read at leaf "
                                f"{leaf} chunk {ci}"
                            )
                        yield buf
        yield header["trailer"]

    return ckpt_format.write_stream(out_path, chunks())


def record_applied(owner: int, iteration: int, outcome: str, **extra) -> None:
    """One ``ckpt_delta_applied`` event per received delta frame →
    ``tpu_ckpt_delta_applied_total{outcome}``."""
    record_event(
        "checkpoint", "ckpt_delta_applied",
        owner=owner, iteration=iteration, outcome=outcome, **extra,
    )
