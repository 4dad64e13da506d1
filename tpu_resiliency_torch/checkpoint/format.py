"""Single-file checkpoint container: pickled hollow skeleton + raw array payload.

The write path the reference implements with per-bucket writer processes over torch-DCP
files (``checkpointing/async_ckpt/filesystem_async.py:102-334``) collapses on TPU hosts
to: hollow metadata (small pickle) followed by each leaf's raw bytes, streamed
sequentially — large contiguous writes are how you saturate local NVMe, and the hollow /
payload split means the metadata can be read without touching the payload.

**Measured justification for single-stream (the reference fans out per-bucket
writers, ``filesystem_async.py:232-334,558``):** on this class of host storage,
writing a 1 GiB tree (fsync'd, warm, alternating runs —
``scripts/bench_ckpt_io.py``) measured single-stream at 0.30 GB/s median vs 0.16
GB/s for a 4-way thread fan-out: concurrent streams halve throughput by
interleaving what would be contiguous writes. Writes here are also already
asynchronous to the train loop (``async_core``), so writer parallelism buys no
step-time; it would only shorten the background window.

The capability exists anyway, behind the ``$TPU_RESILIENCY_CKPT_STRIPES``
storage-class knob (``stripes=`` on :func:`write_payload`/:func:`write_blob`):
N threads pwrite byte-balanced contiguous leaf groups at their final offsets in
the SAME container, so the striped file is byte-identical to the sequential one
and the read path never changes. Measured on this host (0.5 GiB, 64 leaves,
``scripts/bench_ckpt_io.py``): single-stream 0.59 GB/s vs 4-way striped 0.61
GB/s — a wash here, hence default 1; on striped NVMe arrays or parallel
filesystems re-run the script and set the env for the measured winner.

Atomicity follows the reference's ``.dirty``-then-rename protocol
(``checkpointing/local/ckpt_managers/local_manager.py:110-131``): write to
``<path>.dirty``, fsync, ``os.replace``. A crash leaves only ``.dirty`` files, which
cleanup removes; a visible file is always complete.

**Integrity (format v2, ``TPURES02``).** Atomic renames protect against torn
*writes*, not against what storage does to committed bytes: a flipped bit on
worn NVMe, a post-crash tail loss, a torn rename all yield a structurally
plausible container that deserializes into silently wrong weights. v2
containers therefore carry end-to-end checksums, computed streaming in every
write path and verified streaming on every read path:

- **per-leaf CRC32C** — recorded in the header leaf specs when the writer has
  the payload in hand (:func:`write_payload`, :func:`serialize_parts`), and
  ALWAYS in the trailer (the pipelined save only learns a leaf's CRC as its
  D2H copy resolves, after the header is long gone down the wire);
- **a whole-file trailer digest** — CRC over the container head extended with
  each leaf's packed CRC (a digest-of-digests: every byte of the file is
  covered in ONE streaming pass over the payload, no second read).

``TPURES01`` containers still load — verification is skipped and a
``ckpt_unverified`` event is recorded, so a fleet can tell "old format" from
"verified" in its metrics. The CRC implementation is ``google_crc32c`` when
the host has it, gated down to stdlib ``zlib.crc32`` otherwise; the trailer
records which algorithm signed the file, and a reader lacking that algorithm
degrades to unverified-with-event rather than failing the load.

This module is also the **disk-fault injection boundary**: every container
write and every ``.dirty``→visible commit funnels through a patchable IO shim
(:func:`_disk_write`, :func:`_commit_atomic`) that consults the chaos plan's
``disk`` channel (``platform/chaos.py``: seeded bit flips, post-commit
truncation, torn renames, ENOSPC, slow IO), so corruption scenarios reproduce
from a seed exactly like network fault plans.

**Chunk manifest (format v3, ``TPURES03``).** v2's unit of verification is the
*leaf* — fine for whole-container reads, hostile to ranged ones: serving a
4 KB reshard range out of a 256 MB leaf forced a CRC pass over the entire
container (BENCH_reshard.json's 0.42 speedup was exactly that stall). v3
additionally records a **per-chunk CRC manifest** in the trailer: every leaf's
payload is cut into fixed-size, leaf-aligned chunks (``chunk_size`` rides in
the trailer; chunks never span leaves, the last chunk of a leaf is short) and
each chunk is individually signed. Any byte range now verifies in O(range):
read the covering chunks, check their CRCs, done — :func:`chunk_spans` names
the covering chunks, the local manager's ranged-read server and the reshard
load path verify exactly those. The chunk manifest is also what the
byte-economy planes are built on: delta checkpoints diff per-chunk CRCs to
ship only changed chunks (``checkpoint/coding/delta.py``), and erasure blocks
verify without whole-container scans (``checkpoint/coding/strategy.py``).

``TPURES02`` containers still load fully verified (whole-leaf CRCs + digest);
they simply cannot serve chunk-granular verification, so ranged readers fall
back to the one-time whole-file pass. ``TPURES01`` loads unverified with a
``ckpt_unverified`` event, as before.

Layout (v3)::

    MAGIC(8) | header_len(8 LE) | header pickle | leaf 0 bytes | ... |
    TRAILER_MAGIC_V3(8) | algo(4) | chunk_size(4 LE) | nleaves(4 LE) |
    nchunks(4 LE) | leaf_crc32c(4 LE)*nleaves | chunk_crc32c(4 LE)*nchunks |
    container_crc(4 LE)

(v2 trailer, still read: ``TPURES02`` head + ``TRAILER_MAGIC(8) | algo(4) |
nleaves(4 LE) | leaf_crc32c(4 LE)*n | container_crc(4 LE)``.)

Header: ``{"hollow": bytes, "leaves": [{"shape", "dtype", "nbytes"[, "crc32c"]},
...], "meta": {}}``.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import struct
from typing import Any, Optional, Sequence

import numpy as np

from tpu_resiliency_torch.exceptions import CheckpointError
from tpu_resiliency_torch.platform import chaos
from tpu_resiliency_torch.utils.events import record as record_event

#: Current container version: v3 adds the per-chunk CRC manifest (O(range)
#: verification for ranged reads, the chunk-diff substrate for delta saves).
MAGIC = b"TPURES03"
#: v2 containers (leaf CRCs + trailer digest, no chunk manifest) still load
#: fully verified — ranged readers fall back to whole-file verification.
MAGIC_V2 = b"TPURES02"
#: v1 containers (pre-integrity) still load, unverified (``ckpt_unverified``).
MAGIC_V1 = b"TPURES01"
_MAGICS = (MAGIC, MAGIC_V2, MAGIC_V1)
TRAILER_MAGIC = b"TPURESCK"
TRAILER_MAGIC_V3 = b"TPURESC3"
_LEN = struct.Struct("<Q")
_U32 = struct.Struct("<I")
DIRTY_SUFFIX = ".dirty"
#: Quarantine suffix the recovery ladder renames corrupt containers to.
CORRUPT_SUFFIX = ".corrupt"

# -- checksum implementation --------------------------------------------------
#
# CRC32C (Castagnoli) via google_crc32c when the image ships it; stdlib
# zlib.crc32 (IEEE) otherwise — no new dependencies either way. The trailer
# records the signing algorithm, so readers on a host with the OTHER
# implementation degrade to unverified-with-event instead of false alarms.
try:
    import google_crc32c as _crc_impl

    CRC_ALGO = "crc32c"
    _ALGO_TAG = b"c32c"
    #: google_crc32c's C binding only accepts ``bytes``; chunk the copy so the
    #: transient allocation stays bounded at any payload size. 256 KiB keeps
    #: the steady-state pipelined save's peak transient under the <1 MB
    #: alloc gate even though the v3 manifest CRCs one whole chunk at a time.
    _CRC_CHUNK = 1 << 18

    def crc32c(data, crc: int = 0) -> int:
        """Streaming checksum update over any bytes-like (CRC32C here; the
        gated zlib fallback keeps the same signature and the trailer's algo
        tag tells readers which one signed the file)."""
        if isinstance(data, bytes):
            return _crc_impl.extend(crc, data)
        view = memoryview(data)
        if view.ndim != 1 or view.itemsize != 1:
            view = view.cast("B")
        for i in range(0, view.nbytes, _CRC_CHUNK):
            crc = _crc_impl.extend(crc, bytes(view[i : i + _CRC_CHUNK]))
        return crc

except ImportError:  # pragma: no cover - exercised only on hosts without it
    import zlib as _crc_impl

    CRC_ALGO = "crc32"
    _ALGO_TAG = b"zl32"

    def crc32c(data, crc: int = 0) -> int:
        """Streaming checksum update (stdlib CRC32 fallback — see module doc)."""
        if not isinstance(data, (bytes, bytearray, memoryview)):
            data = memoryview(data)
        if isinstance(data, memoryview) and (data.ndim != 1 or data.itemsize != 1):
            data = data.cast("B")
        return _crc_impl.crc32(data, crc) & 0xFFFFFFFF


#: algo tag → can THIS host verify it (only its own tag; the two algorithms
#: are different polynomials, not interchangeable).
_VERIFIABLE_TAGS = (_ALGO_TAG,)

#: Storage-class knob for writer parallelism (reference analogue: per-bucket
#: writer fan-out, ``filesystem_async.py:232-334``). Default 1: on this class of
#: host storage one stream saturates the device and a fan-out HALVES throughput
#: (measured, see module docstring). Set >1 only after ``scripts/bench_ckpt_io.py``
#: shows a win on the target storage (striped NVMe arrays, parallel filesystems).
STRIPES_ENV = "TPU_RESILIENCY_CKPT_STRIPES"


def _effective_stripes(stripes: Optional[int]) -> int:
    if stripes is None:
        try:
            stripes = int(os.environ.get(STRIPES_ENV, "1"))
        except ValueError:
            stripes = 1
    return max(1, int(stripes))


# -- chunk geometry -----------------------------------------------------------
#
# Chunks are LEAF-ALIGNED: each leaf's payload is independently cut into
# ``chunk_size`` pieces (the last one short), so a chunk never spans two
# leaves and leaf-relative range math never crosses a leaf boundary. The
# manifest orders chunks leaf-major (leaf 0's chunks, then leaf 1's, ...).

#: Default chunk size (1 MiB): a 1 GB container carries a 4 KB manifest, and
#: a 4 KB ranged read verifies at most two 1 MiB chunks instead of the file.
DEFAULT_CHUNK = 1 << 20
#: Storage-class override (bytes); floor 4 KiB so manifests stay bounded.
CHUNK_ENV = "TPU_RESILIENCY_CKPT_CHUNK"


def _effective_chunk(chunk_size: Optional[int]) -> int:
    if chunk_size is None:
        try:
            chunk_size = int(os.environ.get(CHUNK_ENV, str(DEFAULT_CHUNK)))
        except ValueError:
            chunk_size = DEFAULT_CHUNK
    return max(1 << 12, int(chunk_size))


def leaf_chunk_count(nbytes: int, chunk_size: int) -> int:
    """Chunks in one leaf's payload (0 for an empty leaf)."""
    return (int(nbytes) + chunk_size - 1) // chunk_size


def total_chunks(leaf_sizes: Sequence[int], chunk_size: int) -> int:
    return sum(leaf_chunk_count(n, chunk_size) for n in leaf_sizes)


def chunk_spans(
    nbytes: int, chunk_size: int, off: int, length: int
) -> tuple[int, int]:
    """Covering chunk index range ``[first, last)`` of a leaf-relative byte
    range ``[off, off+length)`` inside a leaf of ``nbytes`` bytes."""
    if length <= 0:
        return 0, 0
    first = off // chunk_size
    last = min((off + length - 1) // chunk_size + 1,
               leaf_chunk_count(nbytes, chunk_size))
    return first, last


# -- integrity trailer --------------------------------------------------------


def trailer_size(nleaves: int) -> int:
    """On-disk size of a v2 integrity trailer for ``nleaves`` leaves (kept for
    reading ``TPURES02`` containers; v3 writers use :func:`trailer_size_v3`)."""
    return len(TRAILER_MAGIC) + 4 + _U32.size * (nleaves + 2)


#: v3 trailer fixed head: magic | algo | chunk_size | nleaves | nchunks.
_V3_FIXED = len(TRAILER_MAGIC_V3) + 4 + 3 * _U32.size


def trailer_size_v3(nleaves: int, nchunks: int) -> int:
    """On-disk size of a v3 trailer — fixed given leaf count + chunk count,
    which the leaf specs and chunk size determine, so the pipelined save can
    still declare its total container size before any payload byte exists."""
    return _V3_FIXED + _U32.size * (nleaves + nchunks + 1)


def trailer_size_for(
    leaf_sizes: Sequence[int], chunk_size: Optional[int] = None
) -> int:
    """v3 trailer size straight from leaf byte sizes (spec-only, no payload)."""
    cs = _effective_chunk(chunk_size)
    return trailer_size_v3(len(leaf_sizes), total_chunks(leaf_sizes, cs))


def build_trailer(leaf_crcs: Sequence[int], container_crc: int) -> bytes:
    """Serialize the trailer: magic, algo tag, leaf count, per-leaf CRCs, and
    the whole-container digest."""
    return b"".join(
        [
            TRAILER_MAGIC,
            _ALGO_TAG,
            _U32.pack(len(leaf_crcs)),
            *(_U32.pack(c) for c in leaf_crcs),
            _U32.pack(container_crc),
        ]
    )


def parse_trailer(buf, source: str = "container") -> tuple[bytes, list[int], int]:
    """Parse a v2 trailer blob → ``(algo_tag, leaf_crcs, container_crc)``;
    raises :class:`CheckpointError` naming ``source`` when the trailer is
    missing or structurally damaged (the usual signature of tail truncation)."""
    mv = memoryview(buf)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    fixed = len(TRAILER_MAGIC) + 4 + _U32.size
    if mv.nbytes < fixed or bytes(mv[: len(TRAILER_MAGIC)]) != TRAILER_MAGIC:
        raise CheckpointError(
            f"{source}: integrity trailer missing or corrupt (truncated file?)"
        )
    algo = bytes(mv[len(TRAILER_MAGIC) : len(TRAILER_MAGIC) + 4])
    (n,) = _U32.unpack(mv[len(TRAILER_MAGIC) + 4 : fixed])
    if mv.nbytes != trailer_size(n):
        raise CheckpointError(
            f"{source}: integrity trailer truncated "
            f"({mv.nbytes} bytes for {n} leaves, want {trailer_size(n)})"
        )
    crcs = (
        list(struct.unpack(f"<{n}I", mv[fixed : fixed + 4 * n])) if n else []
    )
    (container_crc,) = _U32.unpack(mv[fixed + 4 * n :])
    return algo, crcs, container_crc


def build_trailer_v3(
    leaf_crcs: Sequence[int],
    chunk_crcs: Sequence[int],
    chunk_size: int,
    container_crc: int,
) -> bytes:
    """Serialize a v3 trailer: the v2 record plus the chunk manifest
    (chunk size + leaf-major per-chunk CRCs)."""
    return b"".join(
        [
            TRAILER_MAGIC_V3,
            _ALGO_TAG,
            _U32.pack(chunk_size),
            _U32.pack(len(leaf_crcs)),
            _U32.pack(len(chunk_crcs)),
            *(_U32.pack(c) for c in leaf_crcs),
            *(_U32.pack(c) for c in chunk_crcs),
            _U32.pack(container_crc),
        ]
    )


@dataclasses.dataclass
class TrailerInfo:
    """Version-neutral view of a container's integrity record. ``chunk_size``
    / ``chunk_crcs`` are ``None`` for v2 containers (no manifest — whole-leaf
    verification only)."""

    algo: bytes
    leaf_crcs: list[int]
    container_crc: int
    chunk_size: Optional[int] = None
    chunk_crcs: Optional[list[int]] = None

    @property
    def verifiable(self) -> bool:
        return self.algo in _VERIFIABLE_TAGS

    def leaf_chunk_crcs(self, leaf_sizes: Sequence[int]) -> list[list[int]]:
        """The manifest re-grouped per leaf (leaf-major flat order → lists)."""
        if self.chunk_crcs is None or self.chunk_size is None:
            raise CheckpointError("container carries no chunk manifest (v2)")
        out, pos = [], 0
        for n in leaf_sizes:
            cnt = leaf_chunk_count(int(n), self.chunk_size)
            out.append(self.chunk_crcs[pos : pos + cnt])
            pos += cnt
        return out


def parse_trailer_v3(buf, source: str = "container") -> TrailerInfo:
    mv = memoryview(buf)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    if mv.nbytes < _V3_FIXED or bytes(
        mv[: len(TRAILER_MAGIC_V3)]
    ) != TRAILER_MAGIC_V3:
        raise CheckpointError(
            f"{source}: v3 integrity trailer missing or corrupt "
            f"(truncated file?)"
        )
    off = len(TRAILER_MAGIC_V3)
    algo = bytes(mv[off : off + 4])
    off += 4
    chunk_size, nleaves, nchunks = struct.unpack(
        "<3I", mv[off : off + 3 * _U32.size]
    )
    if chunk_size < 1 or mv.nbytes != trailer_size_v3(nleaves, nchunks):
        raise CheckpointError(
            f"{source}: trailer size mismatch ({mv.nbytes} bytes for "
            f"{nleaves} leaves / {nchunks} chunks) — truncated or torn file"
        )
    off = _V3_FIXED
    leaf_crcs = list(
        struct.unpack(f"<{nleaves}I", mv[off : off + 4 * nleaves])
    ) if nleaves else []
    off += 4 * nleaves
    chunk_crcs = list(
        struct.unpack(f"<{nchunks}I", mv[off : off + 4 * nchunks])
    ) if nchunks else []
    off += 4 * nchunks
    (container_crc,) = _U32.unpack(mv[off:])
    return TrailerInfo(
        algo=algo, leaf_crcs=leaf_crcs, container_crc=container_crc,
        chunk_size=chunk_size, chunk_crcs=chunk_crcs,
    )


def parse_trailer_any(
    buf, magic: bytes, leaf_sizes: Sequence[int], source: str = "container"
) -> TrailerInfo:
    """Parse whichever trailer ``magic``'s container version carries, with
    structural cross-checks against the header's leaf sizes."""
    if magic == MAGIC_V2:
        algo, leaf_crcs, container_crc = parse_trailer(buf, source)
        if len(leaf_crcs) != len(leaf_sizes):
            raise CheckpointError(
                f"{source}: trailer records {len(leaf_crcs)} leaves, header "
                f"declares {len(leaf_sizes)}"
            )
        return TrailerInfo(algo=algo, leaf_crcs=leaf_crcs,
                           container_crc=container_crc)
    info = parse_trailer_v3(buf, source)
    if len(info.leaf_crcs) != len(leaf_sizes) or len(
        info.chunk_crcs
    ) != total_chunks(leaf_sizes, info.chunk_size):
        raise CheckpointError(
            f"{source}: trailer manifest disagrees with header leaf sizes "
            f"({len(info.leaf_crcs)} leaves / {len(info.chunk_crcs)} chunks "
            f"@ {info.chunk_size} B chunk)"
        )
    return info


def _container_crc(prefix, leaf_crcs: Sequence[int]) -> int:
    """The v2 whole-file digest: CRC over the container head (magic + header
    len + header pickle) extended with each leaf's packed CRC — a digest of
    digests, so the entire file is covered by ONE streaming pass over the
    payload (the leaf CRCs double as the file digest's input)."""
    crc = crc32c(prefix)
    for c in leaf_crcs:
        crc = crc32c(_U32.pack(c), crc)
    return crc


def _container_crc_v3(
    prefix, leaf_crcs: Sequence[int], chunk_crcs: Sequence[int]
) -> int:
    """v3 digest: the v2 digest-of-digests extended with the packed chunk
    manifest, so a flipped bit in ANY trailer entry (leaf or chunk CRC) is
    caught by the digest check."""
    crc = _container_crc(prefix, leaf_crcs)
    for c in chunk_crcs:
        crc = crc32c(_U32.pack(c), crc)
    return crc


def _expected_digest(info: TrailerInfo, prefix) -> int:
    if info.chunk_crcs is None:
        return _container_crc(prefix, info.leaf_crcs)
    return _container_crc_v3(prefix, info.leaf_crcs, info.chunk_crcs)


class Checksummer:
    """Streaming v3 integrity state for writers that see the container as
    prefix-then-leaves (the pipelined save, the durable stream writer): feed
    the header prefix at construction and each leaf view exactly once as it
    resolves, then emit the trailer chunk. One IO pass, no buffering — each
    leaf's bytes are CRC'd per chunk (manifest) and across the leaf (leaf
    record) as they stream through."""

    def __init__(self, prefix: bytes, chunk_size: Optional[int] = None):
        self.chunk_size = _effective_chunk(chunk_size)
        self.leaf_crcs: list[int] = []
        #: leaf-major flat manifest (the trailer's chunk section)
        self.chunk_crcs: list[int] = []
        #: per-leaf manifest slices — the delta tracker's diff input
        self.leaf_chunks: list[list[int]] = []
        self._prefix_crc = crc32c(prefix)

    def add_leaf(self, view) -> int:
        mv = memoryview(view)
        if mv.ndim != 1 or mv.itemsize != 1:
            mv = mv.cast("B")
        leaf_crc = 0
        chunks: list[int] = []
        for off in range(0, mv.nbytes, self.chunk_size):
            window = mv[off : off + self.chunk_size]
            chunks.append(crc32c(window))
            leaf_crc = crc32c(window, leaf_crc)
        self.leaf_crcs.append(leaf_crc)
        self.chunk_crcs.extend(chunks)
        self.leaf_chunks.append(chunks)
        return leaf_crc

    def trailer(self) -> bytes:
        crc = self._prefix_crc
        for c in self.leaf_crcs:
            crc = crc32c(_U32.pack(c), crc)
        for c in self.chunk_crcs:
            crc = crc32c(_U32.pack(c), crc)
        return build_trailer_v3(
            self.leaf_crcs, self.chunk_crcs, self.chunk_size, crc
        )


def _record_unverified(source: str, reason: str) -> None:
    """One ``ckpt_unverified`` event per skipped verification (v1 container or
    foreign checksum algorithm) → ``tpu_ckpt_unverified_total``."""
    record_event(
        "checkpoint", "ckpt_unverified", container=str(source), reason=reason
    )


# -- chaos-injectable IO shim -------------------------------------------------


def _disk_write(f, data, path: str) -> int:
    """Every buffered container write funnels here: the chaos ``disk`` channel
    may corrupt the buffer (bitflip), stall, or raise ENOSPC. ``path`` is the
    FINAL path (not the ``.dirty`` temp) so rules target the file a reader
    would see. Returns bytes written."""
    data = chaos.on_disk_write(path, data)
    f.write(data)
    return memoryview(data).nbytes


def _commit_atomic(tmp: str, path: str, fsync: bool) -> None:
    """The ``.dirty``-then-rename commit tail shared by every writer: make the
    file visible only complete, and persist the rename itself. The chaos
    ``disk.commit`` hook injects torn renames (temp truncated before the
    rename) and post-commit tail truncation here."""
    post_fault = chaos.on_disk_commit(tmp, path)
    os.replace(tmp, path)
    if post_fault is not None:
        post_fault()
    if fsync:
        dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)


def _pwrite_full(fd: int, view: memoryview, offset: int, path: Optional[str] = None) -> None:
    if path is not None:
        out = chaos.on_disk_write(path, view)
        view = memoryview(out) if not isinstance(out, memoryview) else out
        if view.ndim != 1 or view.itemsize != 1:
            view = view.cast("B")
    while view.nbytes:
        n = os.pwrite(fd, view, offset)
        view = view[n:]
        offset += n


def _partition_by_bytes(arrays, stripes: int):
    """Equal BYTE ranges of the concatenated payload: ``[(offset, view), ...]``
    per stripe. Ranges ignore leaf boundaries (pwrite only sees bytes), so the
    knob works even when one huge fused-parameter leaf dominates the payload —
    whole-leaf grouping would leave every other writer idle."""
    total = sum(a.nbytes for a in arrays)
    bounds = [total * k // stripes for k in range(stripes + 1)]
    groups: list[list[tuple[int, memoryview]]] = [[] for _ in range(stripes)]
    off = 0
    k = 0
    for a in arrays:
        view = _raw_view(a)
        start, end = off, off + a.nbytes
        while start < end:
            while bounds[k + 1] <= start:
                k += 1
            take = min(end, bounds[k + 1]) - start
            groups[k].append((start, view[start - off : start - off + take]))
            start += take
        off = end
    return [g for g in groups if g]


def _leaf_to_numpy(leaf: Any) -> np.ndarray:
    arr = np.asarray(leaf)
    if not arr.flags["C_CONTIGUOUS"]:
        arr = np.ascontiguousarray(arr)
    return arr


#: Dtypes numpy lacks, by the name the header records (the JAX package's name,
#: which is torch's too): host arrays carry them as raw unsigned integers of the
#: same width, tagged with that name in the dtype's metadata, so headers keep it
#: and containers interchange without ``ml_dtypes``.
RAW_DTYPES = {
    "bfloat16": np.uint16,
    "float8_e4m3fn": np.uint8,
    "float8_e4m3fnuz": np.uint8,
    "float8_e5m2": np.uint8,
    "float8_e5m2fnuz": np.uint8,
}


def _dtype_name(dtype: np.dtype) -> str:
    # `.str` is lossy for extension dtypes (bfloat16 → "<V2"); the name round-trips,
    # and a raw stand-in carries the name of the dtype it stands for.
    return (dtype.metadata or {}).get("name", dtype.name)


def resolve_dtype(name: str) -> np.dtype:
    """Resolve a dtype name; a name numpy lacks (bfloat16, fp8...) resolves to its
    raw stand-in of the same width, tagged with the name (``RAW_DTYPES``)."""
    try:
        return np.dtype(name)
    except TypeError:
        if name not in RAW_DTYPES:
            raise
        return np.dtype(RAW_DTYPES[name], metadata={"name": name})


def _raw_view(a: np.ndarray) -> memoryview:
    # Extension dtypes (bfloat16) don't support the buffer protocol; uint8 view does.
    # Flatten first: a 0-d array can't change dtype via view.
    return memoryview(np.ascontiguousarray(a).reshape(-1).view(np.uint8)).cast("B")


def write_payload(
    path: str,
    hollow_bytes: bytes,
    tensors: Sequence[Any],
    meta: Optional[dict] = None,
    fsync: bool = True,
    stripes: Optional[int] = None,
) -> int:
    """Atomically write a checkpoint file; returns bytes written.

    ``stripes`` > 1 fans the payload out over N writer threads pwrite-ing
    byte-balanced contiguous leaf groups at their final offsets in the SAME
    container — the file an N-way write produces is byte-identical to the
    sequential one, so the read path never changes. ``None`` reads the
    ``$TPU_RESILIENCY_CKPT_STRIPES`` storage-class default (1).
    """
    stripes = _effective_stripes(stripes)
    arrays = [_leaf_to_numpy(t) for t in tensors]
    # Per-leaf + per-chunk CRCs computed from the source buffers BEFORE
    # anything touches disk: the checksums sign what the caller handed us, so
    # corruption anywhere downstream (the write path itself included) is
    # detectable.
    ck = Checksummer(b"")
    for a in arrays:
        ck.add_leaf(_raw_view(a))
    leaf_crcs = ck.leaf_crcs
    header = {
        "hollow": hollow_bytes,
        "leaves": [
            {
                "shape": a.shape,
                "dtype": _dtype_name(a.dtype),
                "nbytes": a.nbytes,
                "crc32c": c,
            }
            for a, c in zip(arrays, leaf_crcs)
        ],
        "meta": meta or {},
    }
    header_bytes = pickle.dumps(header, protocol=pickle.HIGHEST_PROTOCOL)
    prefix = MAGIC + _LEN.pack(len(header_bytes)) + header_bytes
    trailer = build_trailer_v3(
        leaf_crcs, ck.chunk_crcs, ck.chunk_size,
        _container_crc_v3(prefix, leaf_crcs, ck.chunk_crcs),
    )
    tmp = path + DIRTY_SUFFIX
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    base = len(prefix)
    payload = sum(a.nbytes for a in arrays)
    written = base + payload + len(trailer)
    with open(tmp, "wb") as f:
        _disk_write(f, prefix, path)
        # Byte-range striping splits within leaves, so even a single fused-
        # parameter leaf stripes; an all-empty payload yields no groups.
        groups = _partition_by_bytes(arrays, stripes) if stripes > 1 else []
        if not groups:
            for a in arrays:
                _disk_write(f, _raw_view(a), path)
        else:
            # Header leaves the buffered stream before any pwrite lands beyond it.
            f.flush()
            import concurrent.futures as cf

            fd = f.fileno()

            def run(group):
                for off, view in group:
                    _pwrite_full(fd, view, base + off, path)

            with cf.ThreadPoolExecutor(len(groups)) as pool:
                list(pool.map(run, groups))
            # The buffered stream's position is still at the header; land the
            # trailer after the pwrite-extended payload.
            f.seek(base + payload)
        _disk_write(f, trailer, path)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    _commit_atomic(tmp, path, fsync)
    return written


def write_blob(path: str, blob: bytes, fsync: bool = True, stripes: Optional[int] = None) -> None:
    """Atomically write an already-serialized container blob (its integrity
    trailer, when it is a v2 container, rides inside the blob verbatim),
    optionally striped (N threads pwrite-ing byte ranges — same knob and
    rationale as :func:`write_payload`)."""
    stripes = _effective_stripes(stripes)
    tmp = path + DIRTY_SUFFIX
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if stripes == 1 or len(blob) < (1 << 20):
        with open(tmp, "wb") as f:
            _disk_write(f, blob, path)
            f.flush()
            if fsync:
                os.fsync(f.fileno())
    else:
        import concurrent.futures as cf

        view = memoryview(blob)
        chunk = (len(blob) + stripes - 1) // stripes
        with open(tmp, "wb") as f:
            fd = f.fileno()

            def run(i: int) -> None:
                _pwrite_full(fd, view[i * chunk : (i + 1) * chunk], i * chunk, path)

            with cf.ThreadPoolExecutor(stripes) as pool:
                list(pool.map(run, range(stripes)))
            if fsync:
                os.fsync(fd)
    _commit_atomic(tmp, path, fsync)


def _read_prefix(f, source: str) -> tuple[bytes, dict, bytes]:
    """Read and parse the container head; returns ``(magic, header,
    raw_prefix_bytes)``. Every structural failure — wrong magic, truncated
    length field, undecodable header pickle — surfaces as
    :class:`CheckpointError` naming ``source``, so callers classify disk
    damage uniformly instead of leaking ``struct``/``pickle`` internals."""
    magic = f.read(len(MAGIC))
    if magic not in _MAGICS:
        raise CheckpointError(
            f"{source}: bad magic {magic[:8]!r} (not a tpu_resiliency checkpoint)"
        )
    raw_len = f.read(_LEN.size)
    if len(raw_len) != _LEN.size:
        raise CheckpointError(f"{source}: truncated container (no header length)")
    (hlen,) = _LEN.unpack(raw_len)
    header_bytes = f.read(hlen)
    if len(header_bytes) != hlen:
        raise CheckpointError(f"{source}: truncated container header")
    try:
        header = pickle.loads(header_bytes)
        for s in header["leaves"]:  # structural sanity before any payload read
            int(s["nbytes"])
    except Exception as e:
        raise CheckpointError(f"{source}: corrupt container header ({e!r})") from e
    return magic, header, magic + raw_len + header_bytes


def read_header(path: str) -> dict:
    with open(path, "rb") as f:
        return _read_prefix(f, path)[1]


def read_payload(path: str, verify: bool = True) -> tuple[bytes, list[np.ndarray], dict]:
    """Read (hollow_bytes, tensors, meta). Tensors come back as numpy arrays.

    v2 containers are verified streaming as they are read: each leaf's CRC is
    checked the moment its bytes leave the file, then the whole-file trailer
    digest; any mismatch raises :class:`CheckpointError` naming the path and
    the failing leaf. v1 containers (and v2 files signed by a checksum
    algorithm this host lacks) load with verification skipped and a
    ``ckpt_unverified`` event. ``verify=False`` skips checksum comparison
    (callers that already verified the same bytes, e.g. after a
    verify-on-receive retrieve)."""
    with open(path, "rb") as f:
        magic, header, prefix = _read_prefix(f, path)
        specs = header["leaves"]
        payload = sum(int(s["nbytes"]) for s in specs)
        info = None
        if magic != MAGIC_V1:
            info = _read_file_trailer(f, magic, specs, len(prefix), path)
            f.seek(len(prefix))
            if verify and not info.verifiable:
                _record_unverified(path, reason=f"algo:{info.algo!r}")
                info = None
            elif not verify:
                info = None
        elif verify:
            _record_unverified(path, reason="format-v1")
        leaf_crcs = info.leaf_crcs if info is not None else None
        tensors = []
        for i, spec in enumerate(specs):
            buf = f.read(spec["nbytes"])
            if len(buf) != spec["nbytes"]:
                raise CheckpointError(f"{path}: truncated payload")
            if leaf_crcs is not None and crc32c(buf) != leaf_crcs[i]:
                raise CheckpointError(
                    f"{path}: leaf {i} checksum mismatch (payload corrupted)"
                )
            tensors.append(
                np.frombuffer(buf, dtype=resolve_dtype(spec["dtype"])).reshape(spec["shape"])
            )
        if info is not None and _expected_digest(info, prefix) != info.container_crc:
            raise CheckpointError(
                f"{path}: container digest mismatch (header or trailer corrupted)"
            )
    return header["hollow"], tensors, header.get("meta", {})


def _read_file_trailer(
    f, magic: bytes, specs: Sequence[dict], prefix_len: int, source: str
) -> TrailerInfo:
    """Seek-and-parse a v2/v3 file trailer with the size cross-check (the
    truncation/torn-file detector); leaves the file position at the trailer."""
    leaf_sizes = [int(s["nbytes"]) for s in specs]
    payload = sum(leaf_sizes)
    size = os.fstat(f.fileno()).st_size
    tsize = size - prefix_len - payload
    want = (
        trailer_size(len(specs)) if magic == MAGIC_V2
        else None  # v3 trailer size depends on the recorded chunk size
    )
    if tsize <= 0 or (want is not None and tsize != want):
        raise CheckpointError(
            f"{source}: container size mismatch ({size} bytes for "
            f"{prefix_len + payload} of head+payload) — truncated or torn file"
        )
    f.seek(prefix_len + payload)
    info = parse_trailer_any(f.read(tsize), magic, leaf_sizes, source)
    if magic == MAGIC and tsize != trailer_size_v3(
        len(leaf_sizes), len(info.chunk_crcs)
    ):
        raise CheckpointError(
            f"{source}: container size mismatch (trailer region {tsize} B "
            f"disagrees with manifest) — truncated or torn file"
        )
    return info


def header_prefix(
    hollow_bytes: bytes, specs: Sequence[dict], meta: dict | None = None
) -> bytes:
    """The ``MAGIC | header_len | header`` container head built from leaf SPECS
    alone (``{"shape", "dtype", "nbytes"}`` per leaf) — no host arrays needed.

    This is what lets the pipelined save commit to the container layout while
    every leaf's D2H transfer is still in flight: specs come straight off the
    device arrays' metadata, the prefix goes out to files and peer streams
    first, and the payload bytes follow as they resolve. Writers building a
    prefix this way learn leaf CRCs only as leaves resolve, so their specs
    carry no ``crc32c`` keys — the trailer (fed by a :class:`Checksummer`
    over the same pass) is the authoritative checksum record; specs FROM
    materialized writers pass their known CRCs through."""
    header = {
        "hollow": hollow_bytes,
        "leaves": [
            {
                "shape": tuple(s["shape"]),
                "dtype": str(s["dtype"]),
                "nbytes": int(s["nbytes"]),
                **({"crc32c": int(s["crc32c"])} if "crc32c" in s else {}),
            }
            for s in specs
        ],
        "meta": meta or {},
    }
    header_bytes = pickle.dumps(header, protocol=pickle.HIGHEST_PROTOCOL)
    return MAGIC + _LEN.pack(len(header_bytes)) + header_bytes


def serialize_parts(
    hollow_bytes: bytes, tensors: Sequence[Any], meta: dict | None = None
) -> tuple[bytes, list[memoryview]]:
    """Container as ``(prefix_bytes, [leaf byte views])`` — the zero-copy form.

    The prefix is the small ``MAGIC | header_len | header`` head; the views are
    raw uint8 windows over each leaf's host buffer, followed by one small
    ``bytes`` part: the v2 integrity trailer (per-leaf CRCs + whole-file
    digest, computed here from the source buffers). Concatenating
    ``prefix + views`` yields exactly :func:`serialize_to_bytes`'s blob, but no
    joined copy ever exists: senders scatter-gather the parts straight onto a
    socket (``framing.send_bulk``) and writers stream them to a file
    (:func:`write_parts`). The views alias the input tensors — keep those alive
    (and unmutated) until the parts are consumed: the recorded CRCs sign the
    bytes as they are NOW.
    """
    arrays = [_leaf_to_numpy(t) for t in tensors]
    views = [_raw_view(a) for a in arrays]
    ck = Checksummer(b"")
    for v in views:
        ck.add_leaf(v)
    leaf_crcs = ck.leaf_crcs
    prefix = header_prefix(
        hollow_bytes,
        [
            {
                "shape": a.shape,
                "dtype": _dtype_name(a.dtype),
                "nbytes": a.nbytes,
                "crc32c": c,
            }
            for a, c in zip(arrays, leaf_crcs)
        ],
        meta,
    )
    trailer = build_trailer_v3(
        leaf_crcs, ck.chunk_crcs, ck.chunk_size,
        _container_crc_v3(prefix, leaf_crcs, ck.chunk_crcs),
    )
    return prefix, [*views, trailer]


def parts_nbytes(prefix: bytes, views: Sequence[Any]) -> int:
    """Total container size of a :func:`serialize_parts` result."""
    return len(prefix) + sum(memoryview(v).cast("B").nbytes for v in views)


def serialize_to_bytes(hollow_bytes: bytes, tensors: Sequence[Any], meta: dict | None = None) -> bytes:
    """In-memory form of the container (compat path for whole-blob consumers;
    the replication hot path uses :func:`serialize_parts` and never joins)."""
    prefix, views = serialize_parts(hollow_bytes, tensors, meta)
    return b"".join([prefix, *views])


def _chunk_view(chunk: Any) -> memoryview:
    """Flat uint8 view of any stream chunk — bytes-likes directly, numpy arrays
    through the extension-dtype-safe reinterpret (bfloat16 has no buffer
    protocol)."""
    if isinstance(chunk, np.ndarray):
        return _raw_view(chunk)
    return memoryview(chunk).cast("B")


def write_stream(path: str, chunks, fsync: bool = True) -> int:
    """Atomically stream container chunks to ``path`` as they become available.

    ``chunks`` is any iterable of bytes-likes or numpy arrays — typically a
    header prefix followed by leaves resolving off the D2H queue, which is how
    the pipelined save overlaps disk IO with the device transfers: each leaf
    hits the file the moment its DMA lands, not after a full-tree barrier.
    Same ``.dirty``-then-rename commit as every other writer: a producer
    raising mid-stream leaves only the ``.dirty`` temp file (the crash contract
    startup cleanup already handles), never a torn visible container. Chunks
    are written verbatim — a v2 producer appends its own trailer chunk (drive
    a :class:`Checksummer` over the prefix and leaves, then yield
    ``ck.trailer()`` last). Returns bytes written."""
    tmp = path + DIRTY_SUFFIX
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    written = 0
    with open(tmp, "wb") as f:
        for chunk in chunks:
            written += _disk_write(f, _chunk_view(chunk), path)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    _commit_atomic(tmp, path, fsync)
    return written


def write_parts(path: str, parts: Sequence[Any], fsync: bool = True) -> int:
    """Atomically stream already-serialized container parts to ``path`` — the
    ``.dirty``-then-rename protocol of :func:`write_blob` without requiring a
    joined blob (a receive buffer, a :func:`serialize_parts` result, or any mix
    of bytes-likes). Returns bytes written."""
    return write_stream(path, parts, fsync=fsync)


def _parse_buffer_prefix(mv: memoryview, source: str) -> tuple[bytes, dict, int]:
    """Buffer counterpart of :func:`_read_prefix`; returns ``(magic, header,
    payload_offset)`` with the same uniform :class:`CheckpointError`
    classification."""
    if mv.nbytes < len(MAGIC) + _LEN.size:
        raise CheckpointError(f"{source}: truncated serialized checkpoint blob")
    magic = bytes(mv[: len(MAGIC)])
    if magic not in _MAGICS:
        raise CheckpointError(f"{source}: bad magic in serialized checkpoint blob")
    off = len(MAGIC)
    (hlen,) = _LEN.unpack(mv[off : off + _LEN.size])
    off += _LEN.size
    if off + hlen > mv.nbytes:
        raise CheckpointError(f"{source}: truncated serialized checkpoint blob")
    try:
        header = pickle.loads(mv[off : off + hlen])
        for s in header["leaves"]:
            int(s["nbytes"])
    except Exception as e:
        raise CheckpointError(f"{source}: corrupt container header ({e!r})") from e
    return magic, header, off + hlen


def deserialize_from_buffer(
    buf, verify: bool = True, source: str = "buffer"
) -> tuple[bytes, list[np.ndarray], dict]:
    """Zero-copy deserialization: tensors come back as views over ``buf``.

    ``buf`` is any bytes-like (typically the single receive buffer a bulk frame
    landed in); each leaf is ``np.frombuffer`` over a ``memoryview`` slice, so
    no per-leaf copies are made. The arrays alias ``buf`` — they are read-only
    when ``buf`` is, and mutating ``buf`` mutates them. Callers that outlive the
    buffer (or need writable tensors from an immutable source) copy explicitly.

    v2 blobs are checksum-verified against their trailer (one streaming pass;
    mismatch raises :class:`CheckpointError`); pass ``verify=False`` when the
    same bytes were already verified (e.g. by a verify-on-receive retrieve).
    v1 blobs load unverified with a ``ckpt_unverified`` event.
    """
    mv = memoryview(buf).cast("B")
    magic, header, off = _parse_buffer_prefix(mv, source)
    prefix = mv[:off]
    info = None
    if magic != MAGIC_V1:
        payload = sum(int(s["nbytes"]) for s in header["leaves"])
        info = _buffer_trailer(mv, magic, header["leaves"], off, payload, source)
        if verify and not info.verifiable:
            _record_unverified(source, reason=f"algo:{info.algo!r}")
            info = None
        elif not verify:
            info = None
    elif verify:
        _record_unverified(source, reason="format-v1")
    leaf_crcs = info.leaf_crcs if info is not None else None
    tensors = []
    for i, spec in enumerate(header["leaves"]):
        n = spec["nbytes"]
        if off + n > mv.nbytes:
            raise CheckpointError(f"{source}: truncated serialized checkpoint blob")
        window = mv[off : off + n]
        if leaf_crcs is not None and crc32c(window) != leaf_crcs[i]:
            raise CheckpointError(
                f"{source}: leaf {i} checksum mismatch (payload corrupted)"
            )
        tensors.append(
            np.frombuffer(window, dtype=resolve_dtype(spec["dtype"])).reshape(
                spec["shape"]
            )
        )
        off += n
    if info is not None and _expected_digest(info, prefix) != info.container_crc:
        raise CheckpointError(
            f"{source}: container digest mismatch (header or trailer corrupted)"
        )
    return header["hollow"], tensors, header.get("meta", {})


def _buffer_trailer(
    mv: memoryview, magic: bytes, specs: Sequence[dict], off: int,
    payload: int, source: str,
) -> TrailerInfo:
    """Locate and parse the trailer inside a serialized blob (the blob may
    carry a surplus tail — an oversized registered receive buffer)."""
    leaf_sizes = [int(s["nbytes"]) for s in specs]
    start = off + payload
    if magic == MAGIC_V2:
        tsize = trailer_size(len(specs))
    else:
        if start + _V3_FIXED > mv.nbytes:
            raise CheckpointError(
                f"{source}: truncated serialized checkpoint blob"
            )
        head = mv[start : start + _V3_FIXED]
        if bytes(head[: len(TRAILER_MAGIC_V3)]) != TRAILER_MAGIC_V3:
            raise CheckpointError(
                f"{source}: v3 integrity trailer missing or corrupt"
            )
        _, nleaves, nchunks = struct.unpack(
            "<3I", head[len(TRAILER_MAGIC_V3) + 4 :]
        )
        tsize = trailer_size_v3(nleaves, nchunks)
    if start + tsize > mv.nbytes:
        raise CheckpointError(f"{source}: truncated serialized checkpoint blob")
    return parse_trailer_any(mv[start : start + tsize], magic, leaf_sizes, source)


def deserialize_from_bytes(blob) -> tuple[bytes, list[np.ndarray], dict]:
    """Alias of :func:`deserialize_from_buffer` (kept for callers written against
    the pre-streaming API; both are zero-copy over the input buffer now)."""
    return deserialize_from_buffer(blob)


# -- standalone verification --------------------------------------------------


def verify_container(buf, source: str = "frame") -> bool:
    """Integrity-check a serialized container without materializing tensors —
    the verify-on-receive primitive replication receivers run on every frame.

    Returns ``True`` when every leaf CRC and the container digest verified;
    ``False`` when the payload is unverifiable — a v1 container (one
    ``ckpt_unverified`` event), a v2 file signed by a checksum algorithm this
    host lacks, or not a container at all (replication also moves raw blobs
    in tests/tools). Raises :class:`CheckpointError` on checksum mismatch or
    structural corruption of a v2 container."""
    mv = memoryview(buf)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    if mv.nbytes < len(MAGIC) or bytes(mv[: len(MAGIC)]) not in _MAGICS:
        return False
    magic, header, off = _parse_buffer_prefix(mv, source)
    if magic == MAGIC_V1:
        _record_unverified(source, reason="format-v1")
        return False
    specs = header["leaves"]
    payload = sum(int(s["nbytes"]) for s in specs)
    info = _buffer_trailer(mv, magic, specs, off, payload, source)
    if not info.verifiable:
        _record_unverified(source, reason=f"algo:{info.algo!r}")
        return False
    pos = off
    for i, spec in enumerate(specs):
        n = int(spec["nbytes"])
        if crc32c(mv[pos : pos + n]) != info.leaf_crcs[i]:
            raise CheckpointError(
                f"{source}: leaf {i} checksum mismatch (payload corrupted)"
            )
        pos += n
    if _expected_digest(info, mv[:off]) != info.container_crc:
        raise CheckpointError(
            f"{source}: container digest mismatch (header or trailer corrupted)"
        )
    return True


def verify_file(path: str, chunk: int = 4 << 20) -> tuple[str, str]:
    """Stream-verify one container file with bounded memory (``chunk`` bytes
    at a time regardless of leaf sizes) — the ``ckpt_info --verify`` engine.

    Returns ``(status, detail)`` with status one of ``"ok"`` (every CRC
    verified), ``"unverified"`` (v1 container or foreign checksum algorithm —
    structurally intact but unsigned for this host), or ``"corrupt"``
    (checksum mismatch, truncation, or structural damage). Never raises for
    a damaged file — the verdict IS the result."""
    try:
        with open(path, "rb") as f:
            magic, header, prefix = _read_prefix(f, path)
            specs = header["leaves"]
            payload = sum(int(s["nbytes"]) for s in specs)
            size = os.fstat(f.fileno()).st_size
            if magic == MAGIC_V1:
                if size < len(prefix) + payload:
                    return "corrupt", (
                        f"truncated v1 payload ({size} bytes, want at least "
                        f"{len(prefix) + payload})"
                    )
                return "unverified", "format v1 (no checksums recorded)"
            info = _read_file_trailer(f, magic, specs, len(prefix), path)
            if not info.verifiable:
                return "unverified", (
                    f"signed with algorithm tag {info.algo!r}; this host "
                    f"verifies {_ALGO_TAG!r} ({CRC_ALGO})"
                )
            f.seek(len(prefix))
            if info.chunk_crcs is not None:
                # v3: one streaming pass checks the chunk manifest AND the
                # leaf records (a chunk-aligned read feeds both).
                flat = 0
                for i, spec in enumerate(specs):
                    remaining = int(spec["nbytes"])
                    crc = 0
                    while remaining:
                        buf = f.read(min(info.chunk_size, remaining))
                        if not buf:
                            return "corrupt", f"leaf {i}: short read"
                        if crc32c(buf) != info.chunk_crcs[flat]:
                            return "corrupt", (
                                f"leaf {i} chunk {flat} checksum mismatch"
                            )
                        flat += 1
                        crc = crc32c(buf, crc)
                        remaining -= len(buf)
                    if crc != info.leaf_crcs[i]:
                        return "corrupt", f"leaf {i} checksum mismatch"
            else:
                for i, spec in enumerate(specs):
                    remaining = int(spec["nbytes"])
                    crc = 0
                    while remaining:
                        buf = f.read(min(chunk, remaining))
                        if not buf:
                            return "corrupt", f"leaf {i}: short read"
                        crc = crc32c(buf, crc)
                        remaining -= len(buf)
                    if crc != info.leaf_crcs[i]:
                        return "corrupt", f"leaf {i} checksum mismatch"
            if _expected_digest(info, prefix) != info.container_crc:
                return "corrupt", "container digest mismatch (header/trailer)"
            detail = f"{len(specs)} leaves, {payload} payload bytes ({CRC_ALGO})"
            if info.chunk_crcs is not None:
                detail += (
                    f", {len(info.chunk_crcs)} chunks @ {info.chunk_size} B"
                )
            return "ok", detail
    except CheckpointError as e:
        return "corrupt", str(e)
    except OSError as e:
        return "corrupt", f"unreadable: {e}"


def read_trailer(path: str) -> tuple[dict, int, Optional[TrailerInfo]]:
    """Parse a container's header AND trailer without touching the payload:
    ``(header, prefix_len, TrailerInfo-or-None)`` — two small reads. This is
    the chunk-granular serve path's geometry source: a v3 container's chunk
    manifest loads in O(trailer) so ranged reads can verify O(range) instead
    of paying a whole-file pass. ``None`` trailer = a v1 container."""
    with open(path, "rb") as f:
        magic, header, prefix = _read_prefix(f, path)
        if magic == MAGIC_V1:
            return header, len(prefix), None
        info = _read_file_trailer(f, magic, header["leaves"], len(prefix), path)
        # The digest covers the trailer entries themselves: recompute it from
        # the parsed records so a bit-flipped manifest can't vouch for chunks.
        if info.verifiable and _expected_digest(info, prefix) != info.container_crc:
            raise CheckpointError(
                f"{path}: container digest mismatch (header or trailer corrupted)"
            )
        return header, len(prefix), info


def chunk_report(path: str) -> dict:
    """Per-chunk verification report (the ``ckpt_info --chunks`` engine):
    ``{"status", "chunk_size", "leaves": [{"nbytes", "chunks", "bad": [...]}]}``
    — v2/v1 containers report ``chunk_size: None`` (no manifest)."""
    status, detail = verify_file(path)
    out: dict = {"status": status, "detail": detail, "chunk_size": None,
                 "leaves": []}
    try:
        header, prefix_len, info = read_trailer(path)
    except (CheckpointError, OSError):
        return out
    if info is None or info.chunk_crcs is None or not info.verifiable:
        return out
    out["chunk_size"] = info.chunk_size
    with open(path, "rb") as f:
        f.seek(prefix_len)
        flat = 0
        for spec in header["leaves"]:
            remaining = int(spec["nbytes"])
            nchunks = leaf_chunk_count(remaining, info.chunk_size)
            bad: list[int] = []
            for c in range(nchunks):
                buf = f.read(min(info.chunk_size, remaining))
                if len(buf) != min(info.chunk_size, remaining) or crc32c(
                    buf
                ) != info.chunk_crcs[flat]:
                    bad.append(c)
                flat += 1
                remaining -= len(buf)
            out["leaves"].append(
                {"nbytes": int(spec["nbytes"]), "chunks": nchunks, "bad": bad}
            )
    return out
