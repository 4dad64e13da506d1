"""Durable cold tier: checkpoints that outlive the job.

Everything PR 15/17 built — TPURES03 containers, erasure blocks, delta
chains — lives on clique peers' *local* disks, so a correlated failure (a
whole-slice preemption, the production norm on TPU pods) loses every copy at
once and a fresh job cannot bootstrap from a dead one's state. This module
adds the third durability tier below local copies and parity reconstruction:
an :class:`ObjectStore`-backed archive a FRESH launcher with an empty workdir
can restore from, on any world size.

Two halves share the store layout:

- :class:`ColdTier` **spill side** — an async background spiller hanging off
  :class:`~tpu_resiliency_torch.checkpoint.local_manager.LocalCheckpointManager`'s
  save-finalize hook. Finalized keyframe containers are enqueued and shipped
  by a daemon thread, NEVER on the save critical path: uploads stream in
  fixed slices through the chaos ``cold`` channel, commit under tmp+rename
  semantics, and become *visible* only when the ``tpu-coldtier-1`` manifest
  doc lands beside the artifact — a torn upload leaves no manifest, so
  readers can never see it. Failures retry with bounded backoff; a
  persistently dead backend trips a per-store circuit breaker and the tier
  degrades to local-only with ``coldtier_degraded`` events — a dead object
  store never fails a save.
- **Restore side** — manifest-driven: :meth:`ColdTier.coverage` names which
  ``(iteration, owner)`` shards the cold tier holds (the third rung of
  ``find_latest``'s coverage ladder), :meth:`ColdTier.fetch` pulls a whole
  container (whole-file digest verified fail-closed before a byte becomes
  visible locally), and :meth:`ColdTier.fetch_ranges` pulls only the byte
  ranges a reshard plan names — the manifest's chunk CRCs make partial
  restore O(needed bytes), each covering chunk verified before its slice is
  handed back.

Store layout (keys under the backend root)::

    s<session>/iter_<iteration:07d>/owner_<owner>.ckpt   # the container bytes
    s<session>/iter_<iteration:07d>/owner_<owner>.json   # tpu-coldtier-1 manifest

Manifest schema (``tpu-coldtier-1``)::

    {"format": "tpu-coldtier-1", "session": S, "iteration": N, "owner": O,
     "key": "<artifact key>", "bytes": TOTAL, "file_crc32c": C,
     "prefix_len": P, "prefix_crc32c": C, "chunk_size": Z | null,
     "leaves": [{"nbytes": N, "crc32c": C, "chunks": [C, ...]} ...],
     "keyframe": true, "delta_base": M | null}

Every digest in the manifest is computed from the bytes the spiller streamed
(plus the container's own recomputed trailer record), so a reader verifies
fetched bytes against the manifest, then the container's own integrity
record — two independent fail-closed gates.
"""

from __future__ import annotations

import errno
import io
import json
import os
import queue
import re
import threading
import time
from typing import Iterable, Optional

from tpu_resiliency_torch.checkpoint import format as ckpt_format
from tpu_resiliency_torch.exceptions import CheckpointError
from tpu_resiliency_torch.platform import chaos
from tpu_resiliency_torch.utils.events import record as record_event
from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)

#: Launcher-exported envs the default wiring reads (``cold_from_env``).
COLD_DIR_ENV = "TPU_RESILIENCY_COLD_DIR"
COLD_KEEP_ENV = "TPU_RESILIENCY_COLD_KEEP"

MANIFEST_FORMAT = "tpu-coldtier-1"

_MANIFEST_RE = re.compile(r"^s(\d+)/iter_(\d{7})/owner_(\d+)\.json$")


def artifact_key(session: int, iteration: int, owner: int) -> str:
    return f"s{session}/iter_{iteration:07d}/owner_{owner}.ckpt"


def manifest_key(session: int, iteration: int, owner: int) -> str:
    return f"s{session}/iter_{iteration:07d}/owner_{owner}.json"


# -- object store abstraction -------------------------------------------------


class ObjectStore:
    """Minimal pluggable blob interface the cold tier is written against.

    ``put`` MUST be atomic-visible (tmp+rename-equivalent: a reader never
    observes a partially-written object under its final key) and route its
    bytes through the chaos ``cold`` channel so fault plans can corrupt,
    stall, and ENOSPC uploads deterministically per seed.
    """

    def put(self, key: str, slices: Iterable[bytes]) -> int:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def get_range(self, key: str, offset: int, nbytes: int) -> bytes:
        raise NotImplementedError

    def stat(self, key: str) -> int:
        """Object size in bytes; raises ``FileNotFoundError`` when absent."""
        raise NotImplementedError

    def list(self, prefix: str = "") -> list[str]:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__


class FilesystemStore(ObjectStore):
    """Filesystem backend: keys are relative paths under ``root`` (an NFS /
    FUSE-mounted bucket in production, a plain directory in tests). Writes
    land on a same-directory temp file, each slice passing through
    ``chaos.on_cold_write``, and commit via ``chaos.on_cold_commit`` +
    ``os.replace`` — the same patchable discipline as ``format._disk_write``,
    on the ``cold`` channel."""

    def __init__(self, root: str, fsync: bool = False):
        self.root = os.path.abspath(root)
        self.fsync = fsync
        os.makedirs(self.root, exist_ok=True)

    def describe(self) -> str:
        return f"fs:{self.root}"

    def _path(self, key: str) -> str:
        if key.startswith("/") or any(
            part in ("", ".", "..") for part in key.split("/")
        ):
            raise ValueError(f"cold tier: malformed object key {key!r}")
        return os.path.join(self.root, *key.split("/"))

    def put(self, key: str, slices: Iterable[bytes]) -> int:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".upload"
        written = 0
        try:
            with open(tmp, "wb") as f:
                for piece in slices:
                    out = chaos.on_cold_write(key, tmp, piece)
                    f.write(out)
                    written += memoryview(out).nbytes
                if self.fsync:
                    os.fsync(f.fileno())
                else:
                    # Page-cache hygiene: the spiller must not leave
                    # gigabytes of dirty pages for the kernel to write back
                    # while the training loop runs (writeback throttling
                    # stalls the FOREGROUND's writes) nor evict the job's
                    # warm working set. Pay the writeback debt here, in the
                    # demoted worker thread, then drop the cached pages.
                    try:
                        os.fdatasync(f.fileno())
                        os.posix_fadvise(
                            f.fileno(), 0, 0, os.POSIX_FADV_DONTNEED
                        )
                    except (AttributeError, OSError):
                        pass
            post_fault = chaos.on_cold_commit(tmp, key, path)
            os.replace(tmp, path)
            if post_fault is not None:
                post_fault()
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return written

    def get(self, key: str) -> bytes:
        with open(self._path(key), "rb") as f:
            return f.read()

    def get_range(self, key: str, offset: int, nbytes: int) -> bytes:
        with open(self._path(key), "rb") as f:
            return os.pread(f.fileno(), nbytes, offset)

    def stat(self, key: str) -> int:
        return os.path.getsize(self._path(key))

    def list(self, prefix: str = "") -> list[str]:
        out = []
        for dirpath, _, names in os.walk(self.root):
            rel = os.path.relpath(dirpath, self.root).replace(os.sep, "/")
            for name in names:
                key = name if rel == "." else f"{rel}/{name}"
                if key.startswith(prefix) and not key.endswith(".upload"):
                    out.append(key)
        return sorted(out)

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass


# -- the tier -----------------------------------------------------------------


class _Breaker:
    """Per-backend circuit breaker: ``threshold`` consecutive upload failures
    open it for ``cooldown_s``; while open, spills drop immediately (degraded
    to local-only) instead of hammering a dead store. Half-opens after the
    cooldown — the next spill probes the backend."""

    def __init__(self, threshold: int, cooldown_s: float):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.failures = 0
        self.open_until = 0.0

    @property
    def is_open(self) -> bool:
        return time.monotonic() < self.open_until

    def success(self) -> None:
        self.failures = 0
        self.open_until = 0.0

    def failure(self) -> bool:
        """Record a failure; True when this one opened (or re-armed) the
        breaker."""
        self.failures += 1
        if self.failures >= self.threshold:
            self.open_until = time.monotonic() + self.cooldown_s
            return True
        return False


class ColdTier:
    """Async spiller + manifest-driven reader over one :class:`ObjectStore`.

    One instance per rank; restore-side methods (:meth:`coverage`,
    :meth:`fetch`, :meth:`fetch_ranges`) need no worker thread and are safe
    from any process that can reach the store — including ``tpu-ckpt-info
    --cold`` on a machine where the job never ran.
    """

    def __init__(
        self,
        store: ObjectStore,
        session: int = 0,
        rank: int = 0,
        keep: Optional[int] = None,
        slice_size: int = 1 << 20,
        retries: int = 3,
        backoff_s: float = 0.05,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 30.0,
    ):
        if keep is not None and keep < 1:
            raise ValueError(f"cold tier: keep must be >= 1, got {keep}")
        self.store = store
        self.session = session
        self.rank = rank
        self.keep = keep
        self.slice_size = max(1, int(slice_size))
        self.retries = max(1, int(retries))
        self.backoff_s = backoff_s
        self._breaker = _Breaker(breaker_threshold, breaker_cooldown_s)
        self._q: "queue.Queue" = queue.Queue()
        self._pending = 0
        self._cv = threading.Condition()
        self._closed = False
        self._thread: Optional[threading.Thread] = None

    # -- spill side ---------------------------------------------------------

    def spill(
        self,
        iteration: int,
        owner: int,
        path: str,
        keyframe: bool = True,
        delta_base: Optional[int] = None,
    ) -> bool:
        """Enqueue one finalized local container for upload; returns
        immediately (the worker thread does the IO). Delta frames are skipped
        — the cold tier archives self-contained keyframes only, so a restore
        never chases a chain whose base was pruned. Returns True when
        enqueued."""
        if not keyframe:
            return False
        with self._cv:
            if self._closed:
                return False
            self._pending += 1
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._worker, daemon=True, name="coldtier-spill"
                )
                self._thread.start()
        self._q.put((iteration, owner, path, delta_base))
        return True

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until every enqueued spill finished (uploaded, degraded, or
        dropped). True when drained within ``timeout``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._pending:
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(remaining)
        return True

    def close(self, drain: bool = True, timeout: Optional[float] = 30.0) -> None:
        if drain:
            self.flush(timeout)
        with self._cv:
            self._closed = True
            thread = self._thread
        if thread is not None:
            self._q.put(None)
            thread.join(timeout)

    def _worker(self) -> None:
        # The spiller must stay off the critical path in WALL CLOCK, not just
        # in call graph: on a small host the CRC + copy work of a 1 GB
        # artifact competes with the foreground save for cores (the CRC
        # backends release the GIL, so this is kernel scheduling, not lock
        # convoy). Demote this thread to the lowest priority so it only
        # consumes cycles the training loop isn't using.
        try:
            os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 19)
        except (AttributeError, OSError):
            pass
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                self._spill_one(*item)
            except BaseException as e:  # absolute backstop: never kill saves
                log.error(f"cold tier: unexpected spill failure: {e!r}")
            finally:
                with self._cv:
                    self._pending -= 1
                    self._cv.notify_all()

    def _spill_one(
        self, iteration: int, owner: int, path: str, delta_base: Optional[int]
    ) -> None:
        if self._breaker.is_open:
            record_event(
                "coldtier", "coldtier_degraded", rank=self.rank,
                iteration=iteration, owner=owner, reason="breaker-open",
                store=self.store.describe(),
            )
            return
        last_err: Optional[str] = None
        for attempt in range(self.retries):
            if attempt:
                time.sleep(self.backoff_s * (2 ** (attempt - 1)))
            try:
                nbytes = self._upload(iteration, owner, path, delta_base)
            except FileNotFoundError:
                # Pruned locally between finalize and spill (tiny keep with a
                # slow store) — nothing to archive, not a backend failure.
                return
            except (OSError, CheckpointError, ValueError) as e:
                last_err = repr(e)
                continue
            self._breaker.success()
            record_event(
                "coldtier", "coldtier_spilled", rank=self.rank,
                iteration=iteration, owner=owner, bytes=nbytes,
                key=artifact_key(self.session, iteration, owner),
            )
            self._prune()
            return
        opened = self._breaker.failure()
        log.warning(
            f"cold tier: spill of iter {iteration} owner {owner} failed "
            f"after {self.retries} attempts ({last_err}); degrading to "
            f"local-only" + (" [breaker open]" if opened else "")
        )
        record_event(
            "coldtier", "coldtier_degraded", rank=self.rank,
            iteration=iteration, owner=owner, reason="upload-failed",
            error=last_err, breaker_open=opened, store=self.store.describe(),
        )

    def _upload(
        self, iteration: int, owner: int, path: str, delta_base: Optional[int]
    ) -> int:
        """Stream one local container to the store and commit its manifest.
        The manifest is written LAST — it is the visibility point, so any
        torn/failed artifact upload leaves nothing a reader would trust."""
        header, prefix_len, info = ckpt_format.read_trailer(path)
        if info is None or not info.verifiable:
            raise CheckpointError(
                f"{path}: container carries no verifiable integrity record "
                f"(v1 or foreign algorithm) — refusing unverifiable archive"
            )
        leaf_sizes = [int(s["nbytes"]) for s in header["leaves"]]
        akey = artifact_key(self.session, iteration, owner)

        crc_state = {"file": 0, "prefix": 0, "total": 0}

        def slices():
            with open(path, "rb") as f:
                while True:
                    piece = f.read(self.slice_size)
                    if not piece:
                        # Don't let streaming a multi-GB container evict the
                        # training loop's warm pages (re-reading it later
                        # costs one cold read; evicting the job's working
                        # set costs every step until it refills).
                        try:
                            os.posix_fadvise(
                                f.fileno(), 0, 0, os.POSIX_FADV_DONTNEED
                            )
                        except (AttributeError, OSError):
                            pass
                        return
                    off = crc_state["total"]
                    if off < prefix_len:
                        head = piece[: prefix_len - off]
                        crc_state["prefix"] = ckpt_format.crc32c(
                            head, crc_state["prefix"]
                        )
                    crc_state["file"] = ckpt_format.crc32c(
                        piece, crc_state["file"]
                    )
                    crc_state["total"] += len(piece)
                    yield piece

        self.store.put(akey, slices())
        # Containment gate: a torn commit (rename journaled, tail lost) shows
        # up as a size mismatch — fail the attempt before any manifest lands.
        landed = self.store.stat(akey)
        if landed != crc_state["total"]:
            try:  # never leave torn bytes at a key a retry would trust
                self.store.delete(akey)
            except OSError:
                pass
            raise CheckpointError(
                f"cold tier: {akey} landed torn ({landed} of "
                f"{crc_state['total']} bytes)"
            )
        chunk_lists = (
            info.leaf_chunk_crcs(leaf_sizes)
            if info.chunk_crcs is not None
            else [None] * len(leaf_sizes)
        )
        manifest = {
            "format": MANIFEST_FORMAT,
            "session": self.session,
            "iteration": iteration,
            "owner": owner,
            "key": akey,
            "bytes": crc_state["total"],
            "file_crc32c": crc_state["file"],
            "prefix_len": prefix_len,
            "prefix_crc32c": crc_state["prefix"],
            "chunk_size": info.chunk_size,
            "leaves": [
                {"nbytes": n, "crc32c": int(info.leaf_crcs[i]),
                 **({"chunks": [int(c) for c in chunk_lists[i]]}
                    if chunk_lists[i] is not None else {})}
                for i, n in enumerate(leaf_sizes)
            ],
            "keyframe": True,
            "delta_base": delta_base,
        }
        doc = json.dumps(manifest, sort_keys=True).encode()
        self.store.put(manifest_key(self.session, iteration, owner), [doc])
        return crc_state["total"]

    # -- retention ----------------------------------------------------------

    def _prune(self) -> None:
        """Keyframe-aware retention: keep the newest ``keep`` cold iterations
        (across ALL owners — retention is a per-tier property, not
        per-shard), never pruning an iteration some retained manifest names
        as its ``delta_base``. Manifests are deleted BEFORE artifacts so a
        concurrent reader can never trust a half-deleted iteration."""
        if self.keep is None:
            return
        try:
            manifests = self.manifests()
        except OSError as e:
            log.warning(f"cold tier: retention scan failed: {e!r}")
            return
        iterations = sorted(manifests, reverse=True)
        retained = set(iterations[: self.keep])
        for it in iterations[self.keep:]:
            bases = {
                m.get("delta_base")
                for kept in retained
                for m in manifests.get(kept, {}).values()
            }
            if it in bases:
                retained.add(it)  # a retained chain's base is never orphaned
                continue
            for owner in sorted(manifests[it]):
                try:
                    self.store.delete(manifest_key(self.session, it, owner))
                    self.store.delete(artifact_key(self.session, it, owner))
                except OSError as e:
                    log.warning(
                        f"cold tier: pruning iter {it} owner {owner} "
                        f"failed: {e!r}"
                    )
                    continue
                record_event(
                    "coldtier", "coldtier_pruned", rank=self.rank,
                    iteration=it, owner=owner,
                )

    # -- restore side -------------------------------------------------------

    def manifests(self) -> dict[int, dict[int, dict]]:
        """``{iteration: {owner: manifest}}`` for every VALID manifest in this
        session's cold prefix. Unparseable or wrong-format docs are skipped
        (fail-closed: a torn manifest upload makes its iteration invisible,
        never trusted)."""
        out: dict[int, dict[int, dict]] = {}
        for key in self.store.list(prefix=f"s{self.session}/iter_"):
            m = _MANIFEST_RE.match(key)
            if m is None or int(m.group(1)) != self.session:
                continue
            it, owner = int(m.group(2)), int(m.group(3))
            doc = self._read_manifest(key, it, owner)
            if doc is not None:
                out.setdefault(it, {})[owner] = doc
        return out

    def _read_manifest(self, key: str, it: int, owner: int) -> Optional[dict]:
        try:
            doc = json.loads(self.store.get(key))
        except (OSError, ValueError):
            return None
        if (
            not isinstance(doc, dict)
            or doc.get("format") != MANIFEST_FORMAT
            or int(doc.get("iteration", -1)) != it
            or int(doc.get("owner", -1)) != owner
            or not isinstance(doc.get("leaves"), list)
        ):
            return None
        return doc

    def coverage(self) -> dict[int, set[int]]:
        """``{iteration: {owners archived}}`` — the coverage ladder's third
        rung input."""
        return {it: set(per) for it, per in self.manifests().items()}

    def manifest(self, iteration: int, owner: int) -> Optional[dict]:
        return self._read_manifest(
            manifest_key(self.session, iteration, owner), iteration, owner
        )

    def fetch(self, iteration: int, owner: int, dest_path: str) -> dict:
        """Fetch one whole container to ``dest_path`` (atomic local commit
        through the ``disk`` chaos shim, like any other container write).
        The bytes are verified against the manifest's whole-file digest
        BEFORE anything becomes visible locally; a mismatch raises and emits
        ``coldtier_fetch`` outcome=corrupt. Returns the manifest."""
        doc = self.manifest(iteration, owner)
        if doc is None:
            raise CheckpointError(
                f"cold tier: no manifest for iter {iteration} owner {owner}"
            )
        key = str(doc["key"])
        try:
            blob = self.store.get(key)
        except OSError as e:
            raise CheckpointError(f"cold tier: fetch of {key} failed: {e}") from e
        if len(blob) != int(doc["bytes"]) or ckpt_format.crc32c(blob) != int(
            doc["file_crc32c"]
        ):
            record_event(
                "coldtier", "coldtier_fetch", rank=self.rank,
                iteration=iteration, owner=owner, mode="full",
                bytes=len(blob), outcome="corrupt",
            )
            raise CheckpointError(
                f"cold tier: {key} fails manifest digest "
                f"({len(blob)} bytes) — refusing corrupt restore"
            )
        tmp = dest_path + ckpt_format.DIRTY_SUFFIX
        os.makedirs(os.path.dirname(dest_path) or ".", exist_ok=True)
        with open(tmp, "wb") as f:
            ckpt_format._disk_write(f, blob, dest_path)
        ckpt_format._commit_atomic(tmp, dest_path, fsync=True)
        record_event(
            "coldtier", "coldtier_fetch", rank=self.rank, iteration=iteration,
            owner=owner, mode="full", bytes=len(blob), outcome="ok",
        )
        return doc

    def fetch_header(self, iteration: int, owner: int) -> tuple[dict, dict]:
        """Ranged-fetch and parse a container's head only: ``(manifest,
        header)``. The prefix bytes are verified against the manifest's
        prefix digest fail-closed — a reshard bootstrap learns the saved
        layout in O(header), not O(container)."""
        doc = self.manifest(iteration, owner)
        if doc is None:
            raise CheckpointError(
                f"cold tier: no manifest for iter {iteration} owner {owner}"
            )
        plen = int(doc["prefix_len"])
        prefix = self.store.get_range(str(doc["key"]), 0, plen)
        if len(prefix) != plen or ckpt_format.crc32c(prefix) != int(
            doc["prefix_crc32c"]
        ):
            record_event(
                "coldtier", "coldtier_fetch", rank=self.rank,
                iteration=iteration, owner=owner, mode="header",
                bytes=len(prefix), outcome="corrupt",
            )
            raise CheckpointError(
                f"cold tier: {doc['key']} header fails manifest digest"
            )
        _, header, _ = ckpt_format._read_prefix(
            io.BytesIO(prefix), str(doc["key"])
        )
        return doc, header

    def fetch_ranges(
        self, iteration: int, owner: int, ranges: list[tuple[int, int, int]]
    ) -> list[bytes]:
        """Ranged payload fetch: ``ranges`` are leaf-relative ``(leaf, off,
        nbytes)`` like the peer serve path. Each request pulls only the
        covering chunk span and verifies every covering chunk against the
        manifest before slicing — O(needed bytes), fail-closed. Containers
        archived without a chunk manifest (v2-era) fall back to whole-leaf
        fetch+verify."""
        doc = self.manifest(iteration, owner)
        if doc is None:
            raise CheckpointError(
                f"cold tier: no manifest for iter {iteration} owner {owner}"
            )
        key = str(doc["key"])
        leaves = doc["leaves"]
        offsets = []
        pos = int(doc["prefix_len"])
        for spec in leaves:
            offsets.append(pos)
            pos += int(spec["nbytes"])
        cs = doc.get("chunk_size")
        out: list[bytes] = []
        total = 0
        for leaf, off, nbytes in ranges:
            leaf, off, nbytes = int(leaf), int(off), int(nbytes)
            if leaf < 0 or leaf >= len(leaves):
                raise CheckpointError(
                    f"cold tier: {key} has no leaf {leaf}"
                )
            leaf_nbytes = int(leaves[leaf]["nbytes"])
            if off < 0 or nbytes < 0 or off + nbytes > leaf_nbytes:
                raise CheckpointError(
                    f"cold tier: {key} range [{off}, {off + nbytes}) outside "
                    f"leaf {leaf} payload of {leaf_nbytes} bytes"
                )
            chunks = leaves[leaf].get("chunks")
            if cs and chunks is not None:
                if nbytes == 0:
                    out.append(b"")
                    continue
                first, last = ckpt_format.chunk_spans(leaf_nbytes, cs, off, nbytes)
                span_start = first * cs
                span_end = min(last * cs, leaf_nbytes)
                blob = self.store.get_range(
                    key, offsets[leaf] + span_start, span_end - span_start
                )
                if len(blob) != span_end - span_start:
                    raise CheckpointError(
                        f"cold tier: {key} short read in leaf {leaf}"
                    )
                mv = memoryview(blob)
                for c in range(first, last):
                    w = mv[c * cs - span_start:
                           min((c + 1) * cs, leaf_nbytes) - span_start]
                    if ckpt_format.crc32c(w) != int(chunks[c]):
                        record_event(
                            "coldtier", "coldtier_fetch", rank=self.rank,
                            iteration=iteration, owner=owner, mode="ranged",
                            bytes=len(blob), outcome="corrupt",
                        )
                        raise CheckpointError(
                            f"cold tier: {key} leaf {leaf} chunk {c} fails "
                            f"manifest digest — refusing corrupt restore"
                        )
                out.append(bytes(mv[off - span_start: off - span_start + nbytes]))
            else:
                blob = self.store.get_range(key, offsets[leaf], leaf_nbytes)
                if len(blob) != leaf_nbytes or ckpt_format.crc32c(blob) != int(
                    leaves[leaf]["crc32c"]
                ):
                    record_event(
                        "coldtier", "coldtier_fetch", rank=self.rank,
                        iteration=iteration, owner=owner, mode="ranged",
                        bytes=len(blob), outcome="corrupt",
                    )
                    raise CheckpointError(
                        f"cold tier: {key} leaf {leaf} fails manifest digest"
                    )
                out.append(blob[off: off + nbytes])
            total += nbytes
        record_event(
            "coldtier", "coldtier_fetch", rank=self.rank, iteration=iteration,
            owner=owner, mode="ranged", bytes=total, outcome="ok",
        )
        return out

    def verify(self, iteration: int, owner: int) -> tuple[str, str]:
        """Offline digest check of one archived artifact against its manifest
        (the ``tpu-ckpt-info --cold --verify`` engine): ``("ok"|"corrupt",
        detail)`` — like ``format.verify_file``, never raises."""
        try:
            doc = self.manifest(iteration, owner)
            if doc is None:
                return "corrupt", "manifest missing or unparseable"
            blob = self.store.get(str(doc["key"]))
        except OSError as e:
            return "corrupt", f"unreadable: {e}"
        if len(blob) != int(doc["bytes"]):
            return "corrupt", (
                f"size mismatch ({len(blob)} of {doc['bytes']} bytes)"
            )
        if ckpt_format.crc32c(blob) != int(doc["file_crc32c"]):
            return "corrupt", "whole-file digest mismatch"
        return "ok", f"{len(blob)} bytes, {len(doc['leaves'])} leaves"


def cold_from_env(
    session: int = 0, rank: int = 0, keep: Optional[int] = None, **kwargs
) -> Optional[ColdTier]:
    """The launcher wiring: a :class:`ColdTier` over a
    :class:`FilesystemStore` at ``$TPU_RESILIENCY_COLD_DIR``, retention from
    ``$TPU_RESILIENCY_COLD_KEEP``; None when the env is unset (cold tier
    off)."""
    root = os.environ.get(COLD_DIR_ENV)
    if not root:
        return None
    if keep is None:
        raw = os.environ.get(COLD_KEEP_ENV)
        keep = int(raw) if raw else None
    return ColdTier(
        FilesystemStore(root), session=session, rank=rank, keep=keep, **kwargs
    )
