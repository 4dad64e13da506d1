"""Local (node-storage) checkpoint manager with replication and coverage tracking.

Re-design of the reference's local checkpointing
(``checkpointing/local/ckpt_managers/base_manager.py:35-318`` and
``local_manager.py:38-178``): each rank persists its shard to node-local storage (NVMe /
ramdisk) every few minutes; cliques mirror shards across hosts; after a restart —
possibly with ranks moved between hosts — ``find_latest`` agrees on the newest iteration
whose shards **cover every rank**, and ``load`` routes missing shards from their mirrors.

Checkpoint identity is ``CkptID = (iteration, owner_rank, session)``
(``base_manager.py:86-101``). Files are ``iter_{it:07d}_{owner}_local.ckpt`` under
``root/s{session}/r{rank}/`` — the directory names the *holder*, the filename the
*owner*, so a rank's dir holds its own shard plus its clique mirrors. Writes are
``.dirty``-then-rename atomic (``local_manager.py:110-131``); saves run through
:class:`~tpu_resiliency_torch.checkpoint.async_core.AsyncCallsQueue` with a finalize step
that re-checks cross-rank coverage and prunes superseded iterations
(``base_manager.py:277-304``).

**Recovery ladder.** ``load`` no longer trusts disk: every shard read is
checksum-verified (container format v2, ``checkpoint/format.py``), and a rank
whose copy fails climbs a ladder instead of raising —

1. **quarantine** the damaged file (rename to ``*.corrupt-<ts>``, one
   ``ckpt_quarantined`` event → ``tpu_ckpt_integrity_failures_total{stage}``),
   so retries and coverage math never re-trust it and forensics keep the bytes;
2. **peer retrieve**: the existing collective exchange routes the shard from a
   clique mirror, verify-on-receive (a corrupt mirror is treated like PR 4's
   degraded peer — dropped, not loaded);
3. **cold-tier fetch** (``checkpoint/coldtier.py``): when no live peer can
   serve the shard — including a FRESH job with an empty workdir after a
   correlated failure — the durable object-store archive supplies it, every
   fetched byte verified fail-closed against the ``tpu-coldtier-1`` manifest
   digests before the container's own verify;
4. **fall back** to the next older iteration whose shards pass, agreed across
   the group with a :class:`StoreComm` round (``all_reduce_min``) so every rank
   loads the SAME iteration instead of diverging.

Ladder depth is bounded by the ``keep`` retention knob (how many covered
iterations survive pruning; default 1 preserves the reference's
newest-only policy — set ``keep>=2`` to give the ladder a rung to fall to).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import re
import shutil
import threading
import time
from typing import Any, Optional

from tpu_resiliency_torch.checkpoint import coldtier as coldtier_mod
from tpu_resiliency_torch.checkpoint import format as ckpt_format
from tpu_resiliency_torch.checkpoint import reshard as reshard_mod
from tpu_resiliency_torch.checkpoint.async_core import AsyncCallsQueue, AsyncRequest
from tpu_resiliency_torch.checkpoint.coding import delta as ckpt_delta
from tpu_resiliency_torch.checkpoint.coding import strategy as ckpt_coding
from tpu_resiliency_torch.checkpoint.comm import StoreComm
from tpu_resiliency_torch.checkpoint.replication import CliqueReplicationStrategy
from tpu_resiliency_torch.checkpoint.staging import HostStagingPool
from tpu_resiliency_torch.checkpoint.state_dict import PyTreeStateDict
from tpu_resiliency_torch.exceptions import CheckpointError
from tpu_resiliency_torch.utils.events import record as record_event
from tpu_resiliency_torch.utils.timers import debug_time
from tpu_resiliency_torch.utils.tracing import span
from tpu_resiliency_torch.utils.logging import get_logger

from tpu_resiliency_torch.checkpoint import hollow_pickle as pickle

log = get_logger(__name__)

_FILE_RE = re.compile(r"^iter_(\d{7})_(\d+)_local\.ckpt$")
#: Erasure block artifact (``checkpoint/coding/strategy.py``): the filename
#: self-describes ``(iteration, owner, index, k, m)`` so coverage math and
#: retention never parse artifact headers.
_BLOCK_RE = re.compile(
    r"^iter_(\d{7})_(\d+)_b(\d+)k(\d+)m(\d+)_local\.ecblk$"
)
#: Quarantined container: ``<container-name>.corrupt-<hex-ts>`` (the suffix
#: orders same-id quarantines; cleanup keeps the newest per container name).
_CORRUPT_RE = re.compile(
    r"^(iter_\d{7}_\d+_local\.ckpt)\.corrupt(?:-[0-9a-f]+)?$"
)


def block_filename(iteration: int, owner: int, index: int, k: int, m: int) -> str:
    return f"iter_{iteration:07d}_{owner}_b{index}k{k}m{m}_local.ecblk"


@dataclasses.dataclass(frozen=True, order=True)
class CkptID:
    iteration: int
    owner: int
    session: int = 0

    def filename(self) -> str:
        return f"iter_{self.iteration:07d}_{self.owner}_local.ckpt"


def _write_blobs(paths_and_blobs: list[tuple[str, Any]]) -> None:
    """Async-part worker: write each payload atomically (module-level: picklable).

    Each value is a single bytes-like (a receive buffer) or a list of parts (a
    ``serialize_parts`` result) — either way the payload streams to disk with no
    joined copy (``format.write_parts``). Writer parallelism for single blobs
    follows the ``$TPU_RESILIENCY_CKPT_STRIPES`` storage-class knob
    (``format.write_blob``); default is single-stream, the measured winner on
    plain host storage."""
    import time as _time

    t0 = _time.perf_counter()
    total = sum(
        sum(len(p) for p in b) if isinstance(b, list) else len(b)
        for _, b in paths_and_blobs
    )
    try:
        for path, blob in paths_and_blobs:
            if isinstance(blob, list):
                ckpt_format.write_parts(path, blob)
            else:
                ckpt_format.write_blob(path, blob)
    except BaseException as e:
        record_event(
            "checkpoint", "timing", name="ckpt.save.write",
            duration_s=_time.perf_counter() - t0, ok=False, error=repr(e),
            bytes=total, files=len(paths_and_blobs),
        )
        raise
    # Completes the save decomposition (d2h → serialize → replicate → write):
    # this is the disk-bound half, with the volume that explains its latency.
    record_event(
        "checkpoint", "timing", name="ckpt.save.write",
        duration_s=_time.perf_counter() - t0, ok=True,
        bytes=total, files=len(paths_and_blobs),
    )


def _persist_artifacts(items: list[tuple]) -> None:
    """Async-part worker for byte-economy payloads (module-level: picklable).

    ``items`` mix three shapes: ``("blob", path, payload)`` — a container or
    erasure-block artifact written verbatim; ``("parts", path, parts)`` — a
    ``serialize_parts`` result streamed with no join; ``("delta", out_path,
    frame, base_path, owner, iteration)`` — a delta frame applied against the
    held base container. A broken delta chain (missing/stale base) drops
    THAT mirror with a ``ckpt_delta_applied{outcome=broken}`` event instead
    of failing the save — the shard simply has fewer mirrors until the next
    keyframe re-bases the clique."""
    plain: list[tuple[str, Any]] = []
    for item in items:
        if item[0] == "delta":
            _, out_path, frame, base_path, owner, iteration = item
            try:
                written = ckpt_delta.apply_delta(frame, base_path, out_path)
                ckpt_delta.record_applied(
                    owner, iteration, "ok", bytes=written,
                    frame_bytes=memoryview(frame).nbytes,
                )
            except CheckpointError as e:
                log.warning(
                    f"delta mirror for owner {owner} @ iteration {iteration} "
                    f"dropped: {e}"
                )
                ckpt_delta.record_applied(
                    owner, iteration, "broken", error=repr(e)
                )
        else:
            plain.append((item[1], item[2]))
    if plain:
        _write_blobs(plain)


def _items_nbytes(items: list[tuple]) -> int:
    total = 0
    for item in items:
        payload = item[2]
        if isinstance(payload, list):
            total += sum(memoryview(p).cast("B").nbytes for p in payload)
        else:
            total += memoryview(payload).cast("B").nbytes
    return total


class LocalCheckpointManager:
    """Per-rank local checkpoint manager.

    Single-rank operation: pass ``comm=None`` (no coverage agreement, no replication).
    Distributed: pass a :class:`StoreComm` over all ranks, and optionally a
    :class:`CliqueReplicationStrategy` built on the same store.
    """

    def __init__(
        self,
        root: str,
        rank: int = 0,
        session: int = 0,
        comm: Optional[StoreComm] = None,
        replication: Optional[CliqueReplicationStrategy] = None,
        caller: str = "thread",
        pipelined: Optional[bool] = None,
        staging: Optional[HostStagingPool] = None,
        keep: int = 1,
        delta_interval: Optional[int] = None,
        cold: Optional[Any] = None,
    ):
        self.root = root
        self.rank = rank
        self.session = session
        self.comm = comm
        self.replication = replication
        self._caller_kind = caller
        #: Durable cold tier (``checkpoint/coldtier.py``): ``None`` wires from
        #: ``$TPU_RESILIENCY_COLD_DIR`` (off when unset), ``False`` forces off,
        #: or pass a :class:`~tpu_resiliency_torch.checkpoint.coldtier.ColdTier`.
        #: Finalized keyframe saves spill asynchronously; coverage agreement
        #: and the recovery ladder gain a third rung below reconstruct-from-
        #: parity — fetch-from-cold-tier.
        if cold is None:
            cold = coldtier_mod.cold_from_env(session=session, rank=rank)
        self.cold = cold or None
        #: Delta-checkpoint chain state (``checkpoint/coding/delta.py``):
        #: ``delta_interval`` N > 1 ships up to N-1 chunk-diff replication
        #: rounds between full keyframes (default: ``$TPU_RESILIENCY_CKPT_DELTA``,
        #: off). Composes with erasure replication: a delta round codes the
        #: FRAME (not the container), so each peer holds a ``frame/k``-sized
        #: block — ~(dirty-fraction)/k of the payload — with 1-of-k loss
        #: tolerance on top. Reconstruction yields the frame, which is applied
        #: against this rank's own base container; a lost/stale base breaks
        #: the chain for that iteration and the agreed fallback ladder walks
        #: back to the newest loadable generation (keyframes every
        #: ``delta_interval`` saves bound the walk).
        self._delta = ckpt_delta.DeltaTracker(delta_interval)
        #: Covered iterations retained after a successful save. 1 = the
        #: reference's newest-only recovery buffer; >=2 additionally keeps
        #: older rungs for the recovery ladder to fall back to when the newest
        #: iteration's shards fail their checksums on every holder.
        self.keep = max(1, int(keep))
        #: Pipelined snapshot engine (default: on for the thread caller): the
        #: caller-visible window of an async save is enqueue + skeleton pickle;
        #: D2H resolution, the replication fan-out, and the shard write all
        #: stream leaf by leaf in the background, staged through the pool.
        self.pipelined = caller == "thread" if pipelined is None else pipelined
        if self.pipelined and caller != "thread":
            raise CheckpointError(
                "pipelined saves require caller='thread' (the snapshot holds "
                "live device references and pool-leased buffers)"
            )
        self.staging = staging if staging is not None else HostStagingPool()
        self.queue = AsyncCallsQueue(
            caller=caller, sync_fn=comm.make_sync_fn() if comm is not None else None
        )
        self._dir = os.path.join(root, f"s{session}", f"r{rank}")
        os.makedirs(self._dir, exist_ok=True)
        self._cleanup_dirty()
        #: (path, mtime, size) → parsed container geometry + verify verdict,
        #: shared by the reshard read path and the ranged-read server so each
        #: container pays its header parse + integrity pass once.
        self._reshard_cache: dict[str, tuple] = {}
        if self.replication is not None:
            # Serve ranged reads off this rank's shard files: the wire op the
            # elastic reshard load path fetches newly-owned byte ranges over.
            self.replication.exchange.serve_ranges(self._serve_ranges)

    # -- local inventory ---------------------------------------------------

    def _cleanup_dirty(self) -> None:
        """Sweep crash/corruption residue at startup: every ``.dirty`` temp
        file goes; of the ``.corrupt`` quarantine files, the NEWEST per
        container name is kept for forensics (the operator gets one exemplar
        of what storage did to each shard) and older duplicates go."""
        newest_corrupt: dict[str, tuple[float, str]] = {}
        doomed: list[str] = []
        for name in os.listdir(self._dir):
            if name.endswith(ckpt_format.DIRTY_SUFFIX):
                doomed.append(name)
                continue
            m = _CORRUPT_RE.match(name)
            if not m:
                continue
            try:
                mtime = os.path.getmtime(os.path.join(self._dir, name))
            except OSError:
                continue
            base = m.group(1)
            prev = newest_corrupt.get(base)
            if prev is None or (mtime, name) > prev:
                if prev is not None:
                    doomed.append(prev[1])
                newest_corrupt[base] = (mtime, name)
            else:
                doomed.append(name)
        for name in doomed:
            try:
                os.unlink(os.path.join(self._dir, name))
            except OSError:
                pass

    def _quarantine(
        self, path: str, stage: str, iteration: int, owner: int, error=None
    ) -> Optional[str]:
        """Move a checksum-failed/unreadable container out of the inventory
        (``*.corrupt-<ts>``): retries and coverage math must never re-trust
        it, and the bytes stay on disk for forensics. Returns the quarantine
        path (None when the rename itself failed — file already gone)."""
        suffix = f"{ckpt_format.CORRUPT_SUFFIX}-{int(time.time() * 1000):x}"
        qpath = path + suffix
        n = 0
        while os.path.exists(qpath):  # same-ms double quarantine
            n += 1
            qpath = f"{path}{suffix}{n:x}"
        try:
            os.replace(path, qpath)
        except OSError:
            qpath = None
        log.error(
            f"rank {self.rank}: quarantined corrupt checkpoint {path} "
            f"(stage={stage}, error={error!r}) -> {qpath}"
        )
        record_event(
            "checkpoint", "ckpt_quarantined",
            path=os.path.basename(path), stage=stage, iteration=iteration,
            owner=owner, rank=self.rank,
            **({"error": repr(error)} if error is not None else {}),
        )
        return qpath

    def local_ids(self) -> set[CkptID]:
        """Checkpoint IDs held in this rank's directory (own shard + mirrors)."""
        out = set()
        for name in os.listdir(self._dir):
            m = _FILE_RE.match(name)
            if m:
                out.add(CkptID(int(m.group(1)), int(m.group(2)), self.session))
        return out

    def block_ids(self) -> set[tuple[int, int, int, int, int]]:
        """Erasure block artifacts on this rank's disk:
        ``(iteration, owner, index, k, m)`` — the filenames self-describe."""
        out = set()
        for name in os.listdir(self._dir):
            m = _BLOCK_RE.match(name)
            if m:
                out.add(tuple(int(g) for g in m.groups()))
        return out

    def _block_path(
        self, iteration: int, owner: int, index: int, k: int, m: int
    ) -> str:
        return os.path.join(
            self._dir, block_filename(iteration, owner, index, k, m)
        )

    def _read_block(self, iteration: int, owner: int, index: int) -> bytes:
        """Load one held block artifact (code geometry resolved from the
        filename inventory)."""
        for it, o, idx, k, m in self.block_ids():
            if (it, o, idx) == (iteration, owner, index):
                path = self._block_path(it, o, idx, k, m)
                try:
                    with open(path, "rb") as f:
                        return f.read()
                except OSError as e:
                    raise CheckpointError(
                        f"{path}: unreadable block artifact ({e!r})"
                    ) from e
        raise CheckpointError(
            f"rank {self.rank} holds no block (owner {owner}, index {index}) "
            f"@ iteration {iteration}"
        )

    def _path(self, ckpt_id: CkptID) -> str:
        return os.path.join(self._dir, ckpt_id.filename())

    # -- save --------------------------------------------------------------

    def save(
        self,
        iteration: int,
        state_dict: PyTreeStateDict,
        is_async: bool = True,
        meta: Optional[dict] = None,
        layout: Optional["reshard_mod.TreeLayout"] = None,
    ) -> Optional[AsyncRequest]:
        """Replicate + persist this rank's shard for ``iteration``.

        ``layout`` (a :class:`~tpu_resiliency_torch.checkpoint.reshard.TreeLayout`)
        embeds the saving world's partition map in the container header meta,
        which is what makes the checkpoint resumable on a DIFFERENT world via
        :meth:`load_resharded` — any single surviving container then describes
        every rank's blocks.

        Pipelined (default, async + thread caller): synchronous on the caller
        is only enqueue-D2H + skeleton pickle + replication-round bookkeeping;
        the background worker resolves each leaf as its DMA lands and streams
        it simultaneously to the local shard file and every clique peer — D2H,
        disk IO, and peer sockets overlap leaf by leaf. Legacy (sync saves,
        process/fork callers): pop tensors → one blocking batched D2H → clique
        exchange → async file writes. Finalization (all ranks) is identical:
        coverage verification + pruning of older iterations
        (``base_manager.py:236-318``).
        """
        if layout is not None:
            meta = {**(meta or {}), reshard_mod.LAYOUT_META_KEY: layout.to_meta()}
        if self.pipelined and is_async:
            return self._save_pipelined(iteration, state_dict, meta)
        return self._save_materialized(iteration, state_dict, is_async, meta)

    def _check_layout(self, meta: Optional[dict], specs: list) -> None:
        """Fail a layout-bearing save LOUDLY when the declared layout does not
        match the tensors actually being written (the classic mistake: layout
        leaves listed in tree-insertion order while pytrees flatten in
        sorted-key order). Catching it here turns a later unexplainable
        "no live holder" reshard failure into a save-time geometry error."""
        layout = reshard_mod.extract_layout(meta or {})
        if layout is None:
            return
        if len(layout.leaves) != len(specs):
            raise CheckpointError(
                f"save(layout=): layout describes {len(layout.leaves)} leaves "
                f"but the state dict has {len(specs)} tensor leaves (pytree "
                f"leaves flatten in sorted-key order)"
            )
        for i, spec in enumerate(specs):
            box = layout.box(i, self.rank)
            want_dtype = layout.leaves[i].dtype
            if tuple(spec["shape"]) != box.shape or str(spec["dtype"]) != want_dtype:
                raise CheckpointError(
                    f"save(layout=): leaf {i} is {tuple(spec['shape'])}/"
                    f"{spec['dtype']} but the layout puts rank {self.rank}'s "
                    f"block at {box.shape}/{want_dtype} — layout leaves must "
                    f"follow the pytree flatten (sorted-key) order"
                )

    def _save_pipelined(
        self, iteration: int, state_dict: PyTreeStateDict, meta: Optional[dict]
    ) -> AsyncRequest:
        t0 = time.perf_counter()
        with span("checkpoint", "ckpt.save.enqueue", iteration=iteration):
            if not state_dict.is_hollow:
                state_dict.pop_tensors()
            snapshot = state_dict.copy_tensors_to_host_async(pool=self.staging)
            self._check_layout(meta, snapshot.specs)
            hollow_bytes = pickle.dumps(
                state_dict.hollow_tree, protocol=pickle.HIGHEST_PROTOCOL
            )
            prefix = ckpt_format.header_prefix(
                hollow_bytes, snapshot.specs,
                meta={"iteration": iteration, **(meta or {})},
            )
            # Total container size includes the integrity trailer — its size
            # is fixed by the leaf specs + chunk size, so the stream can
            # declare it before any D2H byte lands (the CRCs themselves
            # resolve leaf by leaf).
            total = (
                len(prefix) + snapshot.nbytes
                + ckpt_format.trailer_size_for(
                    [s["nbytes"] for s in snapshot.specs]
                )
            )
            # Round tag minted HERE, in save-call order, so concurrent
            # background rounds stay aligned across ranks — whether the round
            # is a leaf-streaming mirror fan-out (stream), an erasure block
            # exchange, or a delta frame (pending): all three consume the
            # same per-strategy round counter in foreground order.
            repl = (
                self.replication
                if self.replication is not None and self.replication.enabled
                else None
            )
            stream = pending = delta_base = None
            if repl is not None:
                if self._delta.enabled and not self.queue.unfinalized_indices:
                    delta_base = self._delta.eligible(
                        [int(s["nbytes"]) for s in snapshot.specs]
                    )
                if repl.coded or delta_base is not None:
                    pending = repl.start_round()
                    pending.iteration = iteration
                else:
                    stream = repl.start_stream(total)
            own_path = self._path(CkptID(iteration, self.rank, self.session))
            # The worker fills in the final on-disk volume (own shard +
            # received mirrors); finalize reads it after the async part is done.
            sizes: dict = {}
            req = AsyncRequest(
                async_fn=self._pipelined_worker,
                async_fn_args=(
                    own_path, prefix, snapshot, stream, pending, delta_base,
                    iteration, sizes,
                ),
                cleanup_fns=(snapshot.release,),
                finalize_fns=(
                    lambda: self._finalize_save(
                        iteration, sizes.get("bytes"),
                        keyframe=sizes.get("keyframe", True),
                    ),
                ),
            )
            try:
                self.queue.schedule_async_request(req)
            except BaseException:
                snapshot.release()
                if stream is not None:
                    stream.abort()
                raise
        record_event(
            "checkpoint", "ckpt_foreground_blocked",
            duration_s=time.perf_counter() - t0,
            engine="pipelined", iteration=iteration,
        )
        return req

    def _pipelined_worker(
        self, own_path: str, prefix: bytes, snapshot, stream, pending,
        delta_base, iteration: int, sizes: dict,
    ) -> None:
        """Background half of a pipelined save: one pass over the leaves in
        D2H order, each resolved leaf going to the local shard file (and, in
        mirror-stream mode, every clique peer) before the next is touched.
        The same pass feeds the
        :class:`~tpu_resiliency_torch.checkpoint.format.Checksummer`, so the
        integrity trailer (leaf CRCs + chunk manifest) costs zero extra
        reads. ``pending`` rounds (erasure blocks / delta frames) run their
        exchange AFTER the local write, off the already-resolved staged
        views — the byte-economy payloads need the full manifest first."""
        t0 = time.perf_counter()
        total = (
            len(prefix) + snapshot.nbytes
            + ckpt_format.trailer_size_for([s["nbytes"] for s in snapshot.specs])
        )
        try:
            if stream is not None:
                stream.open()
            state: dict = {}
            encoder = None
            if (
                pending is not None
                and delta_base is None
                and getattr(self.replication, "coded", False)
            ):
                # Erasure parity accumulates on the SAME leaf pass the
                # Checksummer rides, so the block exchange after the local
                # write starts with its encode already done — no second
                # payload walk, no payload-sized split copy.
                encoder = self.replication.start_encode(pending, total)

            def chunks():
                ck = ckpt_format.Checksummer(prefix)
                state["ck"] = ck
                if stream is not None:
                    stream.send_chunk(prefix)
                if encoder is not None:
                    encoder.update(prefix)
                yield prefix
                for i in range(len(snapshot)):
                    view = snapshot.resolve_view(i)
                    ck.add_leaf(view)
                    if stream is not None:
                        stream.send_chunk(view)
                    if encoder is not None:
                        encoder.update(view)
                    yield view
                trailer = ck.trailer()
                state["trailer"] = trailer
                if stream is not None:
                    stream.send_chunk(trailer)
                if encoder is not None:
                    encoder.update(trailer)
                yield trailer

            ckpt_format.write_stream(own_path, chunks())
            sent_delta = False
            if stream is not None:
                received = stream.finish()
            elif pending is not None:
                views = [
                    snapshot.resolve_view(i) for i in range(len(snapshot))
                ]
                trailer = state["trailer"]
                payload: list = [prefix, *views, trailer]
                if delta_base is not None:
                    try:
                        frame, stats = ckpt_delta.encode_delta(
                            self.rank, iteration, delta_base, prefix, views,
                            trailer,
                        )
                        record_event(
                            "checkpoint", "ckpt_delta",
                            iteration=iteration, rank=self.rank,
                            base_iteration=delta_base["iteration"], **stats,
                        )
                        payload = [frame]
                        sent_delta = True
                    except CheckpointError as e:
                        log.warning(
                            f"rank {self.rank}: delta encode @ iteration "
                            f"{iteration} fell back to keyframe: {e}"
                        )
                if encoder is not None:
                    received = self.replication.exchange_round(
                        pending, payload, encoder=encoder
                    )
                else:
                    received = self.replication.exchange_round(pending, payload)
            else:
                received = {}
            if self._delta.enabled and self.replication is not None:
                ck = state["ck"]
                self._delta.note_saved(
                    iteration,
                    [int(s["nbytes"]) for s in snapshot.specs],
                    ck.chunk_size, ck.leaf_chunks,
                    ckpt_format._U32.unpack(state["trailer"][-4:])[0],
                    keyframe=not sent_delta,
                )
            sizes["keyframe"] = not sent_delta
            items = self._received_items(iteration, received)
            if items:
                _persist_artifacts(items)
        except BaseException as e:
            if stream is not None:
                stream.abort()
            record_event(
                "checkpoint", "timing", name="ckpt.save.stream",
                duration_s=time.perf_counter() - t0, ok=False, error=repr(e),
                bytes=total, files=1,
            )
            raise
        sizes["bytes"] = total + sum(
            memoryview(b).cast("B").nbytes for b in received.values()
        )
        # The whole pipelined background half (d2h-resolve + fan-out + writes):
        # with the foreground ``ckpt.save.enqueue`` span this decomposes a
        # pipelined save end to end; mirror writes inside still emit their own
        # ``ckpt.save.write``.
        record_event(
            "checkpoint", "timing", name="ckpt.save.stream",
            duration_s=time.perf_counter() - t0, ok=True,
            bytes=sizes["bytes"], files=1 + len(received),
        )

    def _save_materialized(
        self,
        iteration: int,
        state_dict: PyTreeStateDict,
        is_async: bool,
        meta: Optional[dict],
    ) -> Optional[AsyncRequest]:
        with debug_time("ckpt.save.d2h", source="checkpoint"):
            if not state_dict.is_hollow:
                state_dict.pop_tensors()
            state_dict.copy_tensors_to_host()
        if meta and reshard_mod.LAYOUT_META_KEY in meta:
            from tpu_resiliency_torch.checkpoint.state_dict import leaf_specs

            self._check_layout(meta, leaf_specs(state_dict.tensors()))
        with debug_time("ckpt.save.serialize", source="checkpoint"):
            hollow_bytes = pickle.dumps(
                state_dict.hollow_tree, protocol=pickle.HIGHEST_PROTOCOL
            )
            # Parts, not a joined blob: the container exists only as the header
            # prefix plus views over the host tensors. Replication scatter-
            # gathers these straight onto the peer sockets and the writer
            # streams them to disk — the only whole-shard buffers ever
            # materialized are the peers' single receive buffers.
            prefix, views = ckpt_format.serialize_parts(
                hollow_bytes, state_dict.tensors(), meta={"iteration": iteration, **(meta or {})}
            )
            parts = [prefix, *views]
            if self._caller_kind != "thread":
                # Process/fork callers pickle the async args; materialize the
                # views (thread caller — the default — stays zero-copy).
                parts = [prefix] + [bytes(v) for v in views]
        repl = (
            self.replication
            if self.replication is not None and self.replication.enabled
            else None
        )
        frame = None
        with debug_time("ckpt.save.replicate", source="checkpoint"):
            if repl is None:
                received = {}
            else:
                pending = repl.start_round()
                pending.iteration = iteration
                payload: list[Any] = parts
                frame = self._maybe_delta_frame(iteration, prefix, views)
                if frame is not None:
                    payload = [frame]
                received = repl.exchange_round(pending, payload)
        self._note_delta_base(iteration, views, repl, keyframe=frame is None)
        items: list[tuple] = [
            ("parts", self._path(CkptID(iteration, self.rank, self.session)),
             parts)
        ]
        items += self._received_items(iteration, received)
        total_bytes = _items_nbytes(items)
        req = AsyncRequest(
            async_fn=_persist_artifacts,
            async_fn_args=(items,),
            finalize_fns=(
                lambda: self._finalize_save(
                    iteration, total_bytes, keyframe=frame is None
                ),
            ),
        )
        if is_async:
            self.queue.schedule_async_request(req)
            return req
        req.execute_sync()
        return None

    def _maybe_delta_frame(
        self, iteration: int, prefix: bytes, views: list
    ) -> Optional[bytes]:
        """Encode this save's replication payload as a delta frame when the
        chain allows (delta enabled, base manifest matches, previous save
        fully finalized — overlapping in-flight saves keyframe so a peer can
        never be asked to apply against a base it hasn't persisted). Under
        the mirror strategy peers apply the frame immediately; under erasure
        the frame itself is what gets coded into blocks. ``views`` is a
        ``serialize_parts`` view list (leaves then trailer)."""
        if not self._delta.enabled:
            return None
        if self.queue.unfinalized_indices:
            return None
        leaf_sizes = [memoryview(v).cast("B").nbytes for v in views[:-1]]
        base = self._delta.eligible(leaf_sizes)
        if base is None:
            return None
        try:
            frame, stats = ckpt_delta.encode_delta(
                self.rank, iteration, base, prefix, views[:-1],
                bytes(memoryview(views[-1]).cast("B")),
            )
        except CheckpointError as e:
            log.warning(
                f"rank {self.rank}: delta encode @ iteration {iteration} "
                f"fell back to keyframe: {e}"
            )
            return None
        record_event(
            "checkpoint", "ckpt_delta",
            iteration=iteration, rank=self.rank,
            base_iteration=base["iteration"], **stats,
        )
        return frame

    def _note_delta_base(
        self, iteration: int, views: list, repl, keyframe: bool
    ) -> None:
        """Record this save's chunk manifest as the next delta's base (the
        trailer part already carries it — pure metadata)."""
        if not self._delta.enabled or repl is None:
            return
        try:
            info = ckpt_format.parse_trailer_v3(
                memoryview(views[-1]).cast("B"), source="delta-base"
            )
        except CheckpointError:
            self._delta.reset()
            return
        leaf_sizes = [memoryview(v).cast("B").nbytes for v in views[:-1]]
        self._delta.note_saved(
            iteration, leaf_sizes, info.chunk_size,
            info.leaf_chunk_crcs(leaf_sizes), info.container_crc,
            keyframe=keyframe,
        )

    def _received_items(self, iteration: int, received: dict) -> list[tuple]:
        """Route a replication round's received payloads to persistence ops:
        mirrors by (iteration, owner) path, erasure blocks by their
        self-described identity, delta frames to an apply against the held
        base container."""
        items: list[tuple] = []
        for owner, blob in received.items():
            if self._caller_kind != "thread" and not isinstance(blob, bytes):
                blob = bytes(blob)
            if ckpt_coding.is_block(blob):
                try:
                    it, o, idx, k, m = ckpt_coding.block_identity(blob)
                except CheckpointError as e:
                    log.warning(
                        f"dropping malformed block artifact from owner "
                        f"{owner}: {e}"
                    )
                    continue
                items.append(("blob", self._block_path(it, o, idx, k, m), blob))
            elif ckpt_delta.is_delta(blob):
                try:
                    header, _ = ckpt_delta.parse_delta(blob)
                except CheckpointError as e:
                    log.warning(
                        f"dropping malformed delta frame from owner "
                        f"{owner}: {e}"
                    )
                    continue
                base_path = self._path(
                    CkptID(int(header["base_iteration"]), owner, self.session)
                )
                items.append((
                    "delta",
                    self._path(CkptID(iteration, owner, self.session)),
                    blob, base_path, owner, iteration,
                ))
            else:
                items.append((
                    "blob",
                    self._path(CkptID(iteration, owner, self.session)),
                    blob,
                ))
        return items

    def _finalize_save(
        self, iteration: int, total_bytes: Optional[int] = None,
        keyframe: bool = True,
    ) -> None:
        """Verify coverage of ``iteration`` across ranks, then prune older iterations."""
        covered = self._covered_iterations()
        if iteration not in covered:
            record_event(
                "checkpoint", "ckpt_save_incomplete", iteration=iteration,
                owner_rank=self.rank, covered=sorted(covered)[-3:],
            )
            raise CheckpointError(
                f"checkpoint iteration {iteration} incomplete after save "
                f"(covered: {sorted(covered)[-3:]})"
            )
        # Only after coverage verification: ckpt_saved is a durability signal.
        # ``bytes`` = this rank's on-disk volume for the iteration (own shard +
        # mirrors), the cost side of the replication policy.
        record_event(
            "checkpoint", "ckpt_saved", iteration=iteration, owner_rank=self.rank,
            held=sorted(i.owner for i in self.local_ids() if i.iteration == iteration),
            **({"bytes": total_bytes} if total_bytes is not None else {}),
        )
        # Cold-tier spill: enqueue-only (the spiller's daemon thread ships the
        # bytes), so the save path pays a queue put and nothing else. Own
        # shards are always self-contained containers; the keyframe flag
        # carries the delta chain's cadence — delta rounds skip the upload.
        if self.cold is not None:
            own = self._path(CkptID(iteration, self.rank, self.session))
            if os.path.exists(own):
                self.cold.spill(
                    iteration, self.rank, own, keyframe=keyframe,
                )
        # Keep the newest ``keep`` iterations (the reference's retention policy
        # is keep=1 — local ckpts are a recovery buffer, not an archive;
        # keep>=2 funds the recovery ladder's fallback rung).
        retained = sorted(
            {i.iteration for i in self.local_ids()}, reverse=True
        )[: self.keep]
        for ckpt_id in self.local_ids():
            if ckpt_id.iteration < iteration and ckpt_id.iteration not in retained:
                try:
                    os.unlink(self._path(ckpt_id))
                except OSError:
                    pass
        # Erasure block artifacts follow the same retention horizon.
        for it, owner, index, k, m in self.block_ids():
            if it < iteration and it not in retained:
                try:
                    os.unlink(self._block_path(it, owner, index, k, m))
                except OSError:
                    pass

    # -- coverage / find_latest -------------------------------------------

    def _cold_pairs(self) -> list[tuple[int, int]]:
        """``(iteration, owner)`` shards the cold tier archives — the
        coverage ladder's third rung input. Empty on any store failure (a
        dead backend degrades coverage to the local tiers, never raises)."""
        if self.cold is None:
            return []
        try:
            return sorted(
                (it, o)
                for it, owners in self.cold.coverage().items()
                for o in owners
            )
        except OSError as e:
            log.warning(f"cold tier: coverage scan failed: {e!r}")
            return []

    def _covered_iterations(self) -> set[int]:
        """Iterations for which the union of all ranks' holdings covers every
        rank — where "covers" means a full container somewhere OR enough
        erasure blocks (≥ k distinct indices of one generation) to
        reconstruct one, OR an archived cold-tier container (the third rung:
        fetchable by any rank, including a fresh workdir that holds
        nothing), so coverage math matches what the recovery ladder can
        actually deliver."""
        if self.comm is None:
            out = {i.iteration for i in self.local_ids() if i.owner == self.rank}
            out.update(
                it for it, o in self._cold_pairs() if o == self.rank
            )
            return out
        gathered = self.comm.all_gather(
            (
                sorted((i.iteration, i.owner) for i in self.local_ids()),
                sorted(self.block_ids()),
                self._cold_pairs(),
            ),
            tag="coverage",
        )
        by_iter: dict[int, set[int]] = {}
        blocks: dict[tuple[int, int], set[int]] = {}
        kof: dict[tuple[int, int], int] = {}
        for holdings, block_holdings, cold_pairs in gathered:
            for it, owner in holdings:
                by_iter.setdefault(it, set()).add(owner)
            for it, owner, index, k, m in (tuple(b) for b in block_holdings):
                blocks.setdefault((it, owner), set()).add(index)
                kof[(it, owner)] = k
            # Union across ranks: a manifest any ONE rank observed counts (the
            # store is shared; scans may race an in-flight upload).
            for it, owner in (tuple(p) for p in cold_pairs):
                by_iter.setdefault(it, set()).add(owner)
        for (it, owner), indices in blocks.items():
            if len(indices) >= kof[(it, owner)]:
                by_iter.setdefault(it, set()).add(owner)
        world = set(self.comm.ranks)  # the group's actual rank ids, not range(world)
        return {it for it, owners in by_iter.items() if world <= owners}

    def rebuild_group(self, comm: StoreComm, remirror: bool = True) -> None:
        """Adopt a new rank group after reassignment; re-mirror within new cliques.

        Collective over the NEW group (every surviving/joining rank calls this with
        the same comm — construct it with ``generation=<restart iteration>`` so
        server-side barrier state from a gather that timed out against the dead
        world can never collide with the new group's). After a restart round
        changes the active world — a rank died, a degraded rank was demoted, a
        spare was promoted — the old cliques are stale: coverage agreement would
        all-gather over a group containing dead peers, and a shard whose only
        mirror died is one failure away from loss.
        This rebuilds the clique math over the new membership and (by default)
        re-mirrors each rank's newest own shard so the NEXT failure is covered.
        The reference fixes groups for the job's lifetime and so never faces this
        (``strategies.py:76-140``); health-driven replication owns it.
        """
        # Saves in flight were scheduled against the OLD group: their collective
        # finalization would hang on dead peers (or wrongly judge coverage in the
        # new world). Keep their local writes, drop their finalization.
        self.queue.abandon()
        self.comm = comm
        self.queue.set_sync_fn(comm.make_sync_fn() if comm is not None else None)
        # The delta chain is clique-scoped: new membership means peers whose
        # base inventory this rank cannot reason about — next save keyframes.
        self._delta.reset()
        if self.replication is None:
            return
        self.replication.rebuild(comm)
        if not (remirror and self.replication.enabled):
            return
        own = [i.iteration for i in self.local_ids() if i.owner == self.rank]
        newest = max(own) if own else None
        kwargs = {}
        if getattr(self.replication, "coded", False):
            kwargs = dict(
                held_blocks={
                    (o, it, idx, k, m)
                    for it, o, idx, k, m in self.block_ids()
                },
                get_block=lambda o, it, idx: self._read_block(it, o, idx),
            )
        received = self.replication.remirror(
            newest,
            lambda owner, it: self._read_blob(it, owner),
            held={(i.owner, i.iteration) for i in self.local_ids()},
            # On-disk shards stream file→socket via sendfile (no userspace copy).
            get_path=lambda owner, it: self._path(CkptID(it, owner, self.session)),
            **kwargs,
        )
        items: list[tuple] = []
        for owner, (it, blob) in received.items():
            if ckpt_coding.is_block(blob):
                try:
                    bit, o, idx, k, m = ckpt_coding.block_identity(blob)
                except CheckpointError as e:
                    log.warning(f"remirror: dropping malformed block ({e})")
                    continue
                items.append(("blob", self._block_path(bit, o, idx, k, m), blob))
            else:
                items.append(
                    ("blob", self._path(CkptID(it, owner, self.session)), blob)
                )
        if items:
            _persist_artifacts(items)
        record_event(
            "checkpoint", "ckpt_group_rebuilt", rank=self.rank,
            group=self.replication.my_group, remirrored=sorted(received),
        )

    def find_latest(self) -> int:
        """Newest iteration fully covered by the group's holdings, or -1.

        Mirrors reference ``base_manager.py:156-203`` (all-gather available IDs, pick
        the max iteration every rank can be served for).
        """
        covered = self._covered_iterations()
        return max(covered) if covered else -1

    # -- load --------------------------------------------------------------

    def load(self, iteration: Optional[int] = None) -> tuple[Any, list, dict]:
        """Load this rank's shard for ``iteration`` (default: ``find_latest()``),
        climbing the recovery ladder on integrity failure (module docstring):
        quarantine → peer retrieve (verify-on-receive) → group-agreed fallback
        to the next older iteration whose shards pass.

        Returns ``(hollow_tree, host_tensors, meta)`` — caller re-inserts and restores
        device placement (shardings belong to the *new* mesh after a restart). Routes
        through clique retrieval when the shard isn't held locally
        (``base_manager.py:205-234``).
        """
        with debug_time("ckpt.local_load", source="checkpoint"):
            return self._load(iteration)

    def _load(self, iteration: Optional[int]) -> tuple[Any, list, dict]:
        if iteration is None:
            iteration = self.find_latest()
        if iteration < 0:
            raise CheckpointError("no fully-covered local checkpoint found")
        requested = iteration
        while True:
            result, ok = self._load_attempt(iteration)
            if self.comm is None:
                agreed_ok = ok
            else:
                # The ladder is collective: every rank reports its verdict and
                # either all return iteration's tree or all fall back together.
                agreed_ok = all(
                    self.comm.all_gather(ok, tag="ckpt-ladder")
                )
            if agreed_ok:
                return result
            fallback = self._agree_fallback(iteration)
            if fallback is None:
                detail = (
                    "" if self.replication is not None or self.comm is None
                    else " (replication is disabled)"
                )
                raise CheckpointError(
                    f"rank {self.rank}: no intact checkpoint at or below "
                    f"iteration {requested}{detail} — newest attempt "
                    f"{iteration} failed integrity on some rank and no older "
                    f"covered iteration remains"
                )
            record_event(
                "checkpoint", "ckpt_fallback", rank=self.rank,
                from_iteration=iteration, to_iteration=fallback,
            )
            log.warning(
                f"rank {self.rank}: checkpoint ladder falling back from "
                f"iteration {iteration} to {fallback}"
            )
            iteration = fallback

    def _load_attempt(self, iteration: int) -> tuple[Optional[tuple], bool]:
        """One collective rung of the ladder: verify the local shard (or
        quarantine it), run the group retrieve, verify whatever arrived.
        Returns ``(result, ok)``; never raises for integrity failures — the
        caller's agreement round owns the fallback decision."""
        path = self._path(CkptID(iteration, self.rank, self.session))
        get_path = lambda o: self._path(CkptID(iteration, o, self.session))  # noqa: E731
        result = None
        needed: Optional[int] = None
        if os.path.exists(path):
            try:
                result = self._read_local_shard(iteration, self.rank)
            except CheckpointError as e:
                self._quarantine(
                    path, stage="local-read", iteration=iteration,
                    owner=self.rank, error=e,
                )
                needed = self.rank
        else:
            needed = self.rank
        if self.comm is None or self.replication is None:
            # No group/no replication: the cold tier is the only rung below
            # the local verdict (a distributed-but-unreplicated group still
            # runs the agreement round in _load, so ranks fall back in
            # lockstep).
            if result is None:
                result = self._cold_restore(iteration)
            return result, result is not None
        try:
            # The coded strategy's retrieve runs the reconstruct-from-parity
            # rung first (quarantine → reconstruct → peer retrieve →
            # fallback); feed it this rank's block inventory for the
            # iteration. The mirror strategy keeps its classic signature.
            kwargs = {}
            if getattr(self.replication, "coded", False):
                kwargs = dict(
                    my_held_blocks={
                        (o, idx, k, m)
                        for it, o, idx, k, m in self.block_ids()
                        if it == iteration
                    },
                    get_block=lambda o, idx: self._read_block(iteration, o, idx),
                )
            blob = self.replication.retrieve(
                needed, self._held_owners(iteration),
                lambda o: self._read_blob(iteration, o), get_path=get_path,
                **kwargs,
            )
        except CheckpointError as e:
            # "No live holder" (raised on every rank, deterministically) or a
            # transfer failure: locally-satisfied ranks keep their result; a
            # needy rank reports failure into the agreement round.
            log.warning(
                f"rank {self.rank}: retrieve for iteration {iteration} "
                f"failed: {e}"
            )
            blob = None
        if needed is None:
            return result, result is not None
        if blob is None:
            # Third rung: no live holder and no reconstructible parity — a
            # cold-tier archive (verified fail-closed against its manifest)
            # still satisfies this rank before the group falls back.
            result = self._cold_restore(iteration)
            return result, result is not None
        if ckpt_delta.is_delta(blob):
            # A coded delta generation reconstructs to the FRAME; materialize
            # the container by applying it against this rank's own base
            # container. A missing/stale base is a broken chain: report
            # failure into the agreement round so the ladder falls back to
            # the newest loadable generation — a wrong base can never
            # assemble a container (apply_delta fails closed on the digest
            # chain link).
            try:
                header, _ = ckpt_delta.parse_delta(
                    blob, source=f"retrieve(iter={iteration})"
                )
                base_path = self._path(CkptID(
                    int(header["base_iteration"]), self.rank, self.session
                ))
                ckpt_delta.apply_delta(blob, base_path, path)
                ckpt_delta.record_applied(
                    self.rank, iteration, "ok", stage="retrieve",
                )
            except CheckpointError as e:
                ckpt_delta.record_applied(
                    self.rank, iteration, "broken", stage="retrieve",
                    error=repr(e),
                )
                log.warning(
                    f"rank {self.rank}: recovered delta frame for iteration "
                    f"{iteration} did not apply ({e}); falling back"
                )
                return None, False
            try:
                result = self._read_local_shard(iteration, self.rank)
            except CheckpointError as e:
                self._quarantine(
                    path, stage="delta-apply", iteration=iteration,
                    owner=self.rank, error=e,
                )
                return None, False
            return result, True
        # Verified on receive by the replication layer; deserialize without a
        # second checksum pass. Re-persist the recovered shard so the next
        # restart is served locally and the clique regains redundancy.
        try:
            hollow_b, tensors, meta = ckpt_format.deserialize_from_buffer(
                blob, verify=False, source=f"retrieve(iter={iteration})"
            )
            result = (self._loads_hollow(hollow_b, path), tensors, meta)
        except CheckpointError as e:
            record_event(
                "checkpoint", "ckpt_integrity_failure", stage="peer-retrieve",
                iteration=iteration, owner=self.rank, rank=self.rank,
                error=repr(e),
            )
            return None, False
        try:
            ckpt_format.write_blob(path, blob)
        except OSError as e:
            log.warning(f"could not re-persist recovered shard {path}: {e!r}")
        return result, True

    def _cold_restore(self, iteration: int) -> Optional[tuple]:
        """Fetch this rank's shard for ``iteration`` from the cold tier into
        the local directory and read it back through the normal verify path.
        Returns the ``(hollow, tensors, meta)`` result or ``None`` — never
        raises (the ladder's agreement round owns the fallback decision).
        Both gates are fail-closed: the fetch verifies the manifest's
        whole-file digest before a byte becomes visible, and the local read
        re-verifies the container's own integrity record."""
        if self.cold is None:
            return None
        path = self._path(CkptID(iteration, self.rank, self.session))
        try:
            if self.cold.manifest(iteration, self.rank) is None:
                return None
            self.cold.fetch(iteration, self.rank, path)
            return self._read_local_shard(iteration, self.rank)
        except (CheckpointError, OSError) as e:
            log.warning(
                f"rank {self.rank}: cold-tier restore of iteration "
                f"{iteration} failed: {e}"
            )
            if os.path.exists(path):
                self._quarantine(
                    path, stage="cold-fetch", iteration=iteration,
                    owner=self.rank, error=e,
                )
            return None

    def _agree_fallback(self, failed_iteration: int) -> Optional[int]:
        """The fallback rung every rank agrees on: the newest covered iteration
        older than the failed one, converged with an explicit ``StoreComm``
        agreement round so no rank can diverge on a stale coverage view."""
        if self.comm is None:
            covered = self._covered_iterations()
            older = [it for it in covered if it < failed_iteration]
            return max(older) if older else None
        covered = self._covered_iterations()
        older = [it for it in covered if it < failed_iteration]
        candidate = max(older) if older else -1
        agreed = self.comm.all_reduce_min(candidate, tag="ckpt-fallback")
        return agreed if agreed >= 0 else None

    def load_tree(
        self,
        iteration: Optional[int] = None,
        shardings=None,
        device=None,
    ) -> tuple[Any, dict]:
        """``load`` + rebuild: returns ``(tree, meta)`` with tensors re-inserted and
        placed per ``shardings``/``device`` (or the default device)."""
        from tpu_resiliency_torch.checkpoint.state_dict import PyTreeStateDict

        hollow, tensors, meta = self.load(iteration)
        sd = PyTreeStateDict.from_hollow(hollow, tensors, shardings=shardings, device=device)
        return sd.tree, meta

    def load_resharded_tree(
        self,
        target: Optional["reshard_mod.TreeLayout"] = None,
        iteration: Optional[int] = None,
        axes=None,
        shardings=None,
        device=None,
    ) -> tuple[Any, dict]:
        """``load_resharded`` + rebuild: the mesh-aware restore in one call.
        ``shardings`` belong to the NEW mesh (e.g.
        ``mesh.tree_shardings(new_mesh, specs)``); placeholder shapes are
        already synced to the target world, so shape-driven spec functions
        see the resharded truth."""
        from tpu_resiliency_torch.checkpoint.state_dict import PyTreeStateDict

        hollow, tensors, meta = self.load_resharded(
            target=target, iteration=iteration, axes=axes
        )
        sd = PyTreeStateDict.from_hollow(
            hollow, tensors, shardings=shardings, device=device
        )
        return sd.tree, meta

    def load_shard(
        self, owner: int, iteration: Optional[int] = None
    ) -> tuple[Any, list, dict]:
        """Load a locally-held shard belonging to ``owner`` (own shard or a clique
        mirror) — the reshard path after a world shrink: a survivor reconstructs a
        departed rank's state from the mirror its replication clique left on this
        rank's disk. Strictly local, no collective participation — including the
        default ``iteration``, which is the newest iteration whose ``owner`` shard
        is on this rank's disk (NOT ``find_latest()``, whose coverage agreement
        would all-gather over a group that may contain the dead peer). Returns
        ``(hollow_tree, host_tensors, meta)`` like :meth:`load`."""
        if iteration is None:
            held = [i.iteration for i in self.local_ids() if i.owner == owner]
            if not held:
                raise CheckpointError(
                    f"rank {self.rank} holds no shards for owner {owner}"
                )
            iteration = max(held)
        return self._read_local_shard(iteration, owner)

    def _read_local_shard(self, iteration: int, owner: int) -> tuple[Any, list, dict]:
        """Shared local-disk read tail for :meth:`load` / :meth:`load_shard`.

        Every failure mode of a damaged container — checksum mismatch,
        truncation, unreadable file, corrupt hollow pickle — surfaces as
        :class:`CheckpointError` naming the path, so the recovery ladder and
        callers classify disk damage uniformly."""
        path = self._path(CkptID(iteration, owner, self.session))
        if not os.path.exists(path):
            raise CheckpointError(
                f"rank {self.rank} holds no shard for owner {owner} @ iteration "
                f"{iteration} (held: {sorted(self._held_owners(iteration))})"
            )
        try:
            hollow_b, tensors, meta = ckpt_format.read_payload(path)
        except CheckpointError:
            raise
        except OSError as e:
            raise CheckpointError(f"{path}: unreadable shard ({e!r})") from e
        return self._loads_hollow(hollow_b, path), tensors, meta

    @staticmethod
    def _loads_hollow(hollow_b: bytes, source: str) -> Any:
        """Unpickle a hollow skeleton; damage surfaces as CheckpointError
        naming the source (pickle raises half a dozen exception types)."""
        try:
            return pickle.loads(hollow_b)
        except Exception as e:
            raise CheckpointError(
                f"{source}: corrupt hollow skeleton ({e!r})"
            ) from e

    def _held_owners(self, iteration: int) -> set[int]:
        return {i.owner for i in self.local_ids() if i.iteration == iteration}

    def _read_blob(self, iteration: int, owner: int) -> bytes:
        path = self._path(CkptID(iteration, owner, self.session))
        try:
            with open(path, "rb") as f:
                return f.read()
        except OSError as e:
            raise CheckpointError(f"{path}: unreadable shard ({e!r})") from e

    # -- elastic reshard ---------------------------------------------------

    def _container_geometry(self, iteration: int, owner: int) -> dict:
        """Parse (once per file version) a held container's geometry: header
        prefix length, per-leaf payload offsets/specs, hollow bytes and meta.

        Integrity is version-aware: a ``TPURES03`` container's chunk manifest
        loads here in O(trailer) — two small reads — and every byte the
        reshard path later serves or slices is verified CHUNK-GRANULAR on
        first touch (``_read_ranges``), so serving a 4 KB range never pays a
        whole-container CRC scan (the serve-side stall BENCH_reshard.json
        measured). Pre-chunk containers (``TPURES02``/v1/foreign algo) keep
        the one-time full streaming pass. A corrupt container is quarantined
        and surfaces as CheckpointError either way."""
        path = self._path(CkptID(iteration, owner, self.session))
        try:
            st = os.stat(path)
        except OSError as e:
            raise CheckpointError(f"{path}: unreadable shard ({e!r})") from e
        key = (st.st_mtime_ns, st.st_size)
        cached = self._reshard_cache.get(path)
        if cached is not None and cached[0] == key:
            return cached[1]
        header = info = None
        try:
            header, prefix_len, info = ckpt_format.read_trailer(path)
        except CheckpointError as e:
            self._quarantine(
                path, stage="reshard-verify", iteration=iteration, owner=owner,
                error=e,
            )
            self._reshard_cache.pop(path, None)
            raise CheckpointError(f"{path}: corrupt container ({e})") from e
        except OSError as e:
            raise CheckpointError(f"{path}: unreadable shard ({e!r})") from e
        chunked = (
            info is not None and info.chunk_crcs is not None and info.verifiable
        )
        if not chunked:
            # No chunk manifest to verify ranges against: fall back to the
            # one-time whole-file pass (old behavior, cached per file version).
            status, detail = ckpt_format.verify_file(path)
            if status == "corrupt":
                self._quarantine(
                    path, stage="reshard-verify", iteration=iteration,
                    owner=owner, error=detail,
                )
                self._reshard_cache.pop(path, None)
                raise CheckpointError(f"{path}: corrupt container ({detail})")
        offs, pos = [], prefix_len
        for spec in header["leaves"]:
            offs.append(pos)
            pos += int(spec["nbytes"])
        geom = {
            "path": path,
            "iteration": iteration,
            "owner": owner,
            "leaf_offsets": offs,
            "leaf_specs": header["leaves"],
            "hollow": header["hollow"],
            "meta": header.get("meta", {}),
            "verified": not chunked,
            "chunk_size": info.chunk_size if chunked else None,
            "chunk_crcs": (
                info.leaf_chunk_crcs(
                    [int(s["nbytes"]) for s in header["leaves"]]
                )
                if chunked else None
            ),
            #: (leaf, chunk) pairs that passed their CRC — chunk-granular
            #: verification state, grows as ranges are touched.
            "verified_chunks": set(),
            #: guards ``verified_chunks`` — ranges are served off a bounded
            #: worker pool and p2p connection threads concurrently.
            "lock": threading.Lock(),
        }
        self._reshard_cache[path] = (key, geom)
        return geom

    @staticmethod
    def _reshard_io_threads() -> int:
        """Bounded worker count for the reshard hot path (serve-side pread +
        chunk-verify fan-out, load-side peer-fetch overlap). Tunable via
        ``TPU_RESILIENCY_RESHARD_IO_THREADS``; ``1`` restores the serial
        path exactly."""
        try:
            n = int(os.environ.get("TPU_RESILIENCY_RESHARD_IO_THREADS", "4"))
        except ValueError:
            n = 4
        return max(1, n)

    def _read_ranges(
        self, iteration: int, owner: int, ranges: list
    ) -> list[bytes]:
        """pread leaf-relative byte ranges out of a locally-held container;
        ``ranges`` items are ``(leaf, src_off, nbytes)``.

        Verification is O(range) on chunked (``TPURES03``) containers: only
        the chunks covering each requested range are CRC-checked, on first
        touch (verdicts cached per file version). Pre-chunk containers were
        verified whole by ``_container_geometry``. A chunk that fails its CRC
        quarantines the container and raises — the caller's degraded-holder /
        recovery machinery owns the retry.

        Multi-range requests run over a bounded worker pool: pread and CRC
        passes for distinct ranges overlap (the CRC is pure compute, the
        pread is kernel time — both release the GIL), while the returned
        parts keep request order. Single ranges stay on the calling thread.
        """
        geom = self._container_geometry(iteration, owner)
        checked = []
        for leaf, off, nbytes in ranges:
            leaf, off, nbytes = int(leaf), int(off), int(nbytes)
            if not 0 <= leaf < len(geom["leaf_offsets"]):
                raise CheckpointError(
                    f"{geom['path']}: range names leaf {leaf} of "
                    f"{len(geom['leaf_offsets'])}"
                )
            limit = int(geom["leaf_specs"][leaf]["nbytes"])
            if off < 0 or nbytes < 0 or off + nbytes > limit:
                raise CheckpointError(
                    f"{geom['path']}: range [{off}, {off + nbytes}) outside "
                    f"leaf {leaf} payload of {limit} bytes"
                )
            checked.append((leaf, off, nbytes))
        with open(geom["path"], "rb") as f:
            fd = f.fileno()

            def read_one(rng: tuple) -> bytes:
                leaf, off, nbytes = rng
                if geom["chunk_size"] is not None:
                    return self._pread_chunk_verified(fd, geom, leaf, off, nbytes)
                buf = os.pread(fd, nbytes, geom["leaf_offsets"][leaf] + off)
                if len(buf) != nbytes:
                    raise CheckpointError(
                        f"{geom['path']}: short read in leaf {leaf} "
                        f"({len(buf)} of {nbytes} bytes)"
                    )
                return buf

            workers = min(self._reshard_io_threads(), len(checked))
            if workers > 1:
                with concurrent.futures.ThreadPoolExecutor(
                    max_workers=workers, thread_name_prefix="reshard-io"
                ) as pool:
                    # map() preserves request order and re-raises the first
                    # worker exception (quarantine already happened inside).
                    out = list(pool.map(read_one, checked))
            else:
                out = [read_one(rng) for rng in checked]
        return out

    def _pread_chunk_verified(
        self, fd: int, geom: dict, leaf: int, off: int, nbytes: int
    ) -> bytes:
        """One leaf-relative range off a chunked container: pread the covering
        chunk span, CRC any not-yet-verified covering chunk against the
        manifest, slice the requested bytes out. Already-verified spans pread
        exactly the requested range."""
        if nbytes == 0:
            return b""
        cs = geom["chunk_size"]
        leaf_nbytes = int(geom["leaf_specs"][leaf]["nbytes"])
        base = geom["leaf_offsets"][leaf]
        first, last = ckpt_format.chunk_spans(leaf_nbytes, cs, off, nbytes)
        vset = geom["verified_chunks"]
        lock = geom["lock"]
        with lock:
            verified = all((leaf, c) in vset for c in range(first, last))
        if verified:
            buf = os.pread(fd, nbytes, base + off)
            if len(buf) != nbytes:
                raise CheckpointError(
                    f"{geom['path']}: short read in leaf {leaf} "
                    f"({len(buf)} of {nbytes} bytes)"
                )
            return buf
        span_start = first * cs
        span_end = min(last * cs, leaf_nbytes)
        blob = os.pread(fd, span_end - span_start, base + span_start)
        if len(blob) != span_end - span_start:
            raise CheckpointError(
                f"{geom['path']}: short read in leaf {leaf} chunk span "
                f"({len(blob)} of {span_end - span_start} bytes)"
            )
        mv = memoryview(blob)
        crcs = geom["chunk_crcs"][leaf]
        for c in range(first, last):
            with lock:
                if (leaf, c) in vset:
                    continue
            # CRC runs outside the lock (two workers may race on the same
            # chunk; the duplicate check is cheaper than serializing them).
            w = mv[c * cs - span_start : min((c + 1) * cs, leaf_nbytes) - span_start]
            if ckpt_format.crc32c(w) != crcs[c]:
                self._quarantine(
                    geom["path"], stage="chunk-verify",
                    iteration=geom["iteration"], owner=geom["owner"],
                    error=f"leaf {leaf} chunk {c} checksum mismatch",
                )
                self._reshard_cache.pop(geom["path"], None)
                raise CheckpointError(
                    f"{geom['path']}: leaf {leaf} chunk {c} checksum mismatch "
                    f"(payload corrupted)"
                )
            with lock:
                vset.add((leaf, c))
        return bytes(mv[off - span_start : off - span_start + nbytes])

    def _serve_ranges(self, request: dict) -> tuple[dict, list]:
        """``PeerExchange.serve_ranges`` handler: answer a peer's ranged read
        against a container this rank holds (own shard or clique mirror).
        Runs on a p2p connection thread; every reply range comes from a
        container that passed (or is re-verified through) the streaming
        integrity check, and the exchange stamps per-range CRCs on the way
        out."""
        try:
            session = int(request.get("session", self.session))
            iteration = int(request["iteration"])
            owner = int(request["owner"])
            ranges = list(request.get("ranges") or [])
        except (KeyError, TypeError, ValueError) as e:
            raise CheckpointError(f"malformed range request ({e!r})") from e
        if session != self.session:
            raise CheckpointError(
                f"rank {self.rank} serves session {self.session}, "
                f"not {session}"
            )
        parts = self._read_ranges(iteration, owner, ranges)
        workers = min(self._reshard_io_threads(), max(1, len(ranges)))
        record_event(
            "checkpoint", "reshard_serve", rank=self.rank, iteration=iteration,
            owner=owner, ranges=len(ranges),
            bytes=sum(len(p) for p in parts), workers=workers,
            mode="parallel" if workers > 1 else "serial",
        )
        extra = {"owner": owner, "iteration": iteration}
        if request.get("want_header"):
            geom = self._container_geometry(iteration, owner)
            extra["hollow"] = geom["hollow"]
            extra["meta"] = geom["meta"]
        return extra, parts

    def load_resharded(
        self,
        target: Optional["reshard_mod.TreeLayout"] = None,
        iteration: Optional[int] = None,
        axes=None,
    ) -> tuple[Any, list, dict]:
        """Load on a world that need NOT match the saving world's sharding.

        Collective over ``self.comm`` (the NEW world's group — after a shrink
        or grow, construct it over the surviving/joining ranks and
        ``rebuild_group`` first). The newest iteration whose containers carry
        a layout (saved with ``save(..., layout=...)``) and whose surviving
        copies cover the target world is chosen — older iterations are tried
        when a newer one's coverage is impossible; an explicitly requested
        ``iteration`` fails hard instead of falling back.

        ``target`` defaults to the SOURCE layout retargeted onto this comm's
        ranks (``axes`` overrides the dp-rescale rule — pass a dict like
        ``{"dp": 2, "tp": 2}`` for a changed model split). Bytes this rank
        already holds (its own shard, clique mirrors) are sliced locally;
        everything else is ranged-fetched from peers — strictly the byte
        ranges newly owned, never whole mirror containers.

        Returns ``(hollow_tree, host_tensors, meta)`` like :meth:`load`; the
        returned ``meta["layout"]`` describes the TARGET world, ready to pass
        back into the next ``save(..., layout=...)``.
        """
        with debug_time("ckpt.reshard_load", source="checkpoint"):
            return self._load_resharded(target, iteration, axes)

    def _load_resharded(self, target, iteration, axes) -> tuple[Any, list, dict]:
        t0 = time.perf_counter()
        held = sorted((i.iteration, i.owner) for i in self.local_ids())
        if self.comm is None:
            gathered = [(self.rank, held, self._cold_pairs())]
            world = [self.rank]
        else:
            gathered = self.comm.all_gather(
                (self.rank, held, self._cold_pairs()), tag="reshard-meta"
            )
            world = list(self.comm.ranks)
        holders: dict[tuple[int, int], list[int]] = {}
        # (iteration -> owners) archived in the cold tier, unioned across the
        # gather so every rank reasons from the same third-rung inventory —
        # this is what lets a FRESH world with empty workdirs bootstrap.
        cold_owners: dict[int, set[int]] = {}
        for r, pairs, cold_pairs in gathered:
            for it, owner in pairs:
                holders.setdefault((int(it), int(owner)), []).append(int(r))
            for it, owner in (tuple(p) for p in cold_pairs):
                cold_owners.setdefault(int(it), set()).add(int(owner))
        candidates = sorted(
            {it for it, _ in holders} | set(cold_owners), reverse=True
        )
        if iteration is not None:
            candidates = [it for it in candidates if it == iteration]
            if not candidates:
                raise CheckpointError(
                    f"reshard: no rank holds any container for iteration "
                    f"{iteration}"
                )
        errors: list[str] = []
        for it in candidates:
            picked = self._reshard_candidate(
                it, holders, world, target, axes, errors, cold_owners
            )
            if picked is None:
                if iteration is not None:
                    raise CheckpointError(
                        f"reshard: iteration {iteration} not resumable on "
                        f"world {world}: {'; '.join(errors)}"
                    )
                continue
            plan, tgt, hollow_b, meta = picked
            with span(
                "checkpoint", "reshard.plan",
                iteration=it, direction=plan.direction,
                source_world=plan.source.world_size,
                target_world=plan.target.world_size,
            ):
                summary = plan.summary(
                    rank=self.rank,
                    local_owners={
                        self.rank: {o for i2, o in held if i2 == it}
                    },
                )
            record_event(
                "checkpoint", "reshard_plan", iteration=it, rank=self.rank,
                direction=plan.direction,
                source_world=plan.source.world_size,
                target_world=plan.target.world_size,
                local_bytes=summary["local_bytes"],
                peer_bytes=summary["peer_bytes"],
                ranges=summary["ranges"],
            )
            try:
                tensors = self._execute_reshard(plan, it, holders, cold_owners)
                exec_err: Optional[CheckpointError] = None
            except CheckpointError as e:
                tensors, exec_err = None, e
            if self.comm is not None:
                # Exit barrier: a rank whose assembly was all-local must keep
                # serving ranged reads until every peer has fetched its share.
                self.comm.barrier(tag="reshard-done")
                # Commit agreement: assembly is all-or-nothing across the
                # group. A rank whose fetch failed fail-closed (a cold
                # artifact flunking its manifest digest, every holder of a
                # segment dead) votes no and EVERY rank discards and climbs
                # to the next older candidate — corrupt bytes are never
                # restored, and no rank diverges onto a different iteration.
                oks = self.comm.all_gather(exec_err is None, tag="reshard-commit")
                if not all(oks):
                    errors.append(
                        f"iter {it}: assembly failed on some rank"
                        + (f" ({exec_err})" if exec_err is not None else "")
                    )
                    if iteration is not None:
                        raise CheckpointError(
                            f"reshard: iteration {iteration} not assemblable "
                            f"on world {world}: {'; '.join(errors)}"
                        )
                    continue
            elif exec_err is not None:
                errors.append(f"iter {it}: {exec_err}")
                if iteration is not None:
                    raise CheckpointError(
                        f"reshard: iteration {iteration} not assemblable: "
                        f"{'; '.join(errors)}"
                    )
                continue
            meta = {
                **meta,
                "iteration": meta.get("iteration", it),
                reshard_mod.LAYOUT_META_KEY: tgt.to_meta(),
            }
            record_event(
                "checkpoint", "timing", name="ckpt.reshard_load",
                duration_s=time.perf_counter() - t0, ok=True,
                bytes=summary["total_bytes"],
            )
            hollow = self._loads_hollow(hollow_b, f"reshard(iter={it})")
            try:
                from tpu_resiliency_torch.checkpoint.state_dict import (
                    sync_placeholder_shapes,
                )

                # Placeholders still carry the SAVING world's local shapes;
                # shape-driven restores (make_restore_shardings spec fns)
                # must see the target world's.
                sync_placeholder_shapes(hollow, tensors)
            except ImportError:  # pragma: no cover - jax-less tooling host
                pass
            return hollow, tensors, meta
        raise CheckpointError(
            "reshard: no resharded-resumable iteration found"
            + (f" ({'; '.join(errors)})" if errors else " (no layout-bearing "
               "containers on any rank — save with save(..., layout=...))")
        )

    def _reshard_candidate(
        self, it, holders, world, target, axes, errors, cold_owners=None
    ):
        """One collective attempt at iteration ``it``: the lowest holder rank
        (or, when NO rank holds a container — the fresh-bootstrap case — the
        lowest live rank) reads+broadcasts a container's layout/hollow/meta;
        every rank builds the same plan and the same coverage verdict. The
        designated rank sources the header from a held container first, then
        from a cold-tier ranged header fetch (manifest-digest verified, paid
        in O(header) bytes). Returns ``(plan, target, hollow, meta)`` or None
        (verdict recorded in ``errors``)."""
        cold = (cold_owners or {}).get(it, set())
        holder_ranks = sorted(
            {r for (i2, _), rs in holders.items() if i2 == it for r in rs}
        )
        designated = holder_ranks[0] if holder_ranks else min(world)
        payload: dict = {}
        if self.rank == designated:
            owned = sorted(
                o for (i2, o) in holders
                if i2 == it and self.rank in holders[(i2, o)]
            )
            last_err = "no held container"
            for owner in owned:
                # Any intact container describes the whole world; a corrupt
                # one was just quarantined — try the next held copy.
                try:
                    geom = self._container_geometry(it, owner)
                except CheckpointError as e:
                    last_err = str(e)
                    continue
                raw = geom["meta"].get(reshard_mod.LAYOUT_META_KEY)
                if raw is None:
                    last_err = (
                        f"iteration {it}: containers carry no layout meta"
                    )
                    continue
                mismatch = self._layout_header_mismatch(raw, geom, owner)
                if mismatch:
                    last_err = f"iteration {it}: {mismatch}"
                    continue
                payload = {
                    "layout": raw, "hollow": geom["hollow"],
                    "meta": geom["meta"],
                }
                break
            else:
                payload = self._cold_header_payload(it, sorted(cold), last_err)
        if self.comm is not None:
            payload = self.comm.broadcast(
                payload, src=designated, tag="reshard-hdr"
            )
        if payload.get("error"):
            errors.append(f"iter {it}: {payload['error']}")
            return None
        try:
            source = reshard_mod.TreeLayout.from_meta(payload["layout"])
            tgt = (
                target
                if target is not None
                else source.retarget(world, axes=axes)
            )
            plan = reshard_mod.build_plan(source, tgt)
            available = {o for (i2, o) in holders if i2 == it} | cold
            plan.require_available(available)
        except CheckpointError as e:
            errors.append(f"iter {it}: {e}")
            return None
        return plan, tgt, payload["hollow"], dict(payload.get("meta") or {})

    def _cold_header_payload(
        self, it: int, cold_sorted: list, last_err: str
    ) -> dict:
        """The designated rank's cold-tier header source: ranged-fetch one
        archived owner's container head, cross-check its layout meta against
        the manifest's leaf sizes. Returns the broadcast payload (or an
        ``{"error": ...}`` verdict)."""
        if self.cold is None or not cold_sorted:
            return {"error": last_err}
        for owner in cold_sorted:
            try:
                doc, header = self.cold.fetch_header(it, owner)
            except (CheckpointError, OSError) as e:
                last_err = f"iteration {it}: cold header fetch failed ({e})"
                continue
            raw = (header.get("meta") or {}).get(reshard_mod.LAYOUT_META_KEY)
            if raw is None:
                last_err = (
                    f"iteration {it}: cold containers carry no layout meta"
                )
                continue
            mismatch = self._layout_header_mismatch(
                raw, {"leaf_specs": header["leaves"]}, owner
            )
            if mismatch:
                last_err = f"iteration {it}: {mismatch}"
                continue
            return {
                "layout": raw, "hollow": header["hollow"],
                "meta": dict(header.get("meta") or {}),
            }
        return {"error": last_err}

    @staticmethod
    def _layout_header_mismatch(raw_layout, geom: dict, owner: int):
        """Cross-check an embedded layout against the container's OWN header
        leaf specs (save-time validation exists too, but metas written by
        older code — or hand-edited — must not send the executor chasing
        ranges outside real payloads). Returns a description or None."""
        try:
            layout = reshard_mod.TreeLayout.from_meta(raw_layout)
        except CheckpointError as e:
            return str(e)
        specs = geom["leaf_specs"]
        if len(layout.leaves) != len(specs):
            return (
                f"layout describes {len(layout.leaves)} leaves, container "
                f"has {len(specs)}"
            )
        for i, spec in enumerate(specs):
            box = layout.box(i, owner)
            if tuple(spec["shape"]) != box.shape or (
                str(spec["dtype"]) != layout.leaves[i].dtype
            ):
                return (
                    f"layout leaf {i} puts owner {owner}'s block at "
                    f"{box.shape}/{layout.leaves[i].dtype} but the container "
                    f"holds {tuple(spec['shape'])}/{spec['dtype']}"
                )
        return None

    def _execute_reshard(
        self, plan: "reshard_mod.ReshardPlan", it: int, holders: dict,
        cold_owners: Optional[dict] = None,
    ) -> list:
        """Assemble this rank's target-local leaves: local pread for ranges a
        held container covers, ranged peer fetch for the rest, ranged
        cold-tier fetch (manifest chunk CRCs verified per covering chunk —
        O(needed bytes)) when no live peer holds a source. The cold rung is
        how a fresh world with empty workdirs assembles at all: every
        segment routes to the archive.

        Peer fetches run over a bounded worker pool and OVERLAP the local
        pread/assembly pass — the wire drains while this thread slices its
        own containers, instead of back-to-back phases. Determinism survives
        the concurrency: assignment happens up front in plan order (same
        load-balanced ``min(pairs, ...)`` choice as the serial path, byte
        for byte), workers only move bytes into disjoint buffer slices, and
        failed holders are re-placed round-by-round in sorted batch order —
        never in wall-clock completion order. Cold batches ride the same
        pool under the sentinel holder ``-1``."""
        import numpy as np

        rp = plan.for_rank(self.rank)
        buffers = [
            np.empty(shape, dtype=ckpt_format.resolve_dtype(spec.dtype))
            for shape, spec in zip(rp.local_shapes, plan.target.leaves)
        ]
        flats = [b.reshape(-1).view(np.uint8) for b in buffers]
        my_owners = {
            o for (i2, o), rs in holders.items() if i2 == it and self.rank in rs
        }
        cold = set((cold_owners or {}).get(it, set())) if self.cold is not None else set()
        local_bytes = 0
        # (holder, owner) -> [segments]; holder -1 = the cold tier
        remote: dict[tuple[int, int], list] = {}
        load: dict[int, int] = {}
        dead: set[int] = set()
        dead_cold: set[int] = set()
        avoid = set(
            self.replication.last_degraded if self.replication is not None else ()
        )

        def assign(seg) -> bool:
            """Route one segment: local queue when a held container covers it,
            the deterministic load-balanced holder choice when a live peer
            has one, else the cold tier. No I/O — returns True for local,
            False for remote/cold."""
            if set(seg.owners) & my_owners:
                return True
            pairs = sorted(
                (h, o)
                for o in seg.owners
                for h in holders.get((it, o), [])
                if h != self.rank and h not in dead
            ) if self.replication is not None else []
            if not pairs:
                cold_avail = sorted((set(seg.owners) & cold) - dead_cold)
                if cold_avail:
                    o = cold_avail[0]
                    load[-1] = load.get(-1, 0) + len(seg.ranges)
                    remote.setdefault((-1, o), []).append(seg)
                    return False
                if self.replication is None and any(
                    holders.get((it, o)) for o in seg.owners
                ):
                    raise CheckpointError(
                        f"reshard: leaf {seg.leaf} cell owned by "
                        f"{list(seg.owners)} is only on peer ranks and this "
                        f"manager has no replication exchange to fetch over"
                    )
                raise CheckpointError(
                    f"reshard: no live holder left for leaf {seg.leaf} cell "
                    f"owned by {list(seg.owners)} @ iteration {it} (cold "
                    f"tier: {'exhausted' if dead_cold else 'no copy'})"
                )
            h, o = min(
                pairs, key=lambda p: (p[0] in avoid, load.get(p[0], 0), p)
            )
            load[h] = load.get(h, 0) + len(seg.ranges)
            remote.setdefault((h, o), []).append(seg)
            return False

        def read_local(seg) -> bool:
            """Fill one locally-covered segment; False when every held copy
            failed (those owners are discarded — the caller re-assigns)."""
            nonlocal local_bytes
            for owner in sorted(set(seg.owners) & my_owners):
                try:
                    got = self._read_ranges(
                        it, owner,
                        [(seg.leaf, r.src_off, r.nbytes) for r in seg.ranges],
                    )
                except CheckpointError as e:
                    # Local copy corrupt/unreadable (already quarantined by
                    # the geometry pass): stop trusting it and fall through
                    # to the peer path for this and every later segment.
                    log.warning(
                        f"rank {self.rank}: local reshard read of owner "
                        f"{owner} @ iter {it} failed: {e}"
                    )
                    my_owners.discard(owner)
                    continue
                for r, buf in zip(seg.ranges, got):
                    flats[seg.leaf][r.dst_off : r.dst_off + r.nbytes] = (
                        np.frombuffer(buf, dtype=np.uint8)
                    )
                    local_bytes += r.nbytes
                return True
            return False

        def fetch_batch(holder: int, owner: int, segs: list) -> list:
            ranges = [
                (seg.leaf, r.src_off, r.nbytes)
                for seg in segs for r in seg.ranges
            ]
            if holder < 0:
                # Cold rung: every covering chunk verified against the
                # manifest before its slice comes back — fail-closed.
                return self.cold.fetch_ranges(it, owner, ranges)
            _, parts = self.replication.fetch_ranges(
                holder,
                {"session": self.session, "iteration": it, "owner": owner,
                 "ranges": ranges},
            )
            return parts

        local_q = [seg for seg in rp.segments if assign(seg)]
        t0 = time.perf_counter()
        fetches = 0
        pool = None
        workers = 0
        try:
            while local_q or remote:
                batches = sorted(remote.items())
                remote.clear()
                futs = []
                if batches:
                    if pool is None:
                        workers = min(self._reshard_io_threads(), len(batches))
                        pool = concurrent.futures.ThreadPoolExecutor(
                            max_workers=max(1, workers),
                            thread_name_prefix="reshard-fetch",
                        )
                    futs = [
                        ((h, o), segs, pool.submit(fetch_batch, h, o, segs))
                        for (h, o), segs in batches
                    ]
                    fetches += len(futs)
                # Local pread/assembly overlaps the in-flight fetches.
                while local_q:
                    seg = local_q.pop(0)
                    if not read_local(seg):
                        # All held copies failed — their owners were just
                        # discarded, so assign() now routes this to a peer
                        # (fetched next round).
                        assign(seg)
                for (holder, owner), segs, fut in futs:
                    try:
                        parts = fut.result()
                    except CheckpointError as e:
                        log.warning(
                            f"rank {self.rank}: reshard fetch from "
                            f"{'cold tier' if holder < 0 else f'holder {holder}'}"
                            f" (owner {owner}) failed: {e}; trying "
                            f"another source"
                        )
                        record_event(
                            "checkpoint", "ckpt_integrity_failure",
                            stage="cold-reshard-fetch" if holder < 0
                            else "reshard-fetch",
                            iteration=it, owner=owner,
                            rank=self.rank, error=repr(e),
                        )
                        if holder < 0:
                            dead_cold.add(owner)
                        else:
                            dead.add(holder)
                        for seg in segs:
                            if assign(seg):
                                local_q.append(seg)
                        continue
                    i = 0
                    nbytes = 0
                    for seg in segs:
                        for r in seg.ranges:
                            buf = memoryview(parts[i]).cast("B")
                            i += 1
                            if buf.nbytes != r.nbytes:
                                raise CheckpointError(
                                    f"reshard: holder {holder} returned "
                                    f"{buf.nbytes} bytes for a "
                                    f"{r.nbytes}-byte range"
                                )
                            flats[seg.leaf][r.dst_off : r.dst_off + r.nbytes] = (
                                np.frombuffer(buf, dtype=np.uint8)
                            )
                            nbytes += r.nbytes
                    record_event(
                        "checkpoint", "reshard_fetch",
                        via="cold" if holder < 0 else "peer",
                        rank=self.rank, iteration=it, holder=holder,
                        owner=owner, bytes=nbytes,
                    )
        finally:
            if pool is not None:
                pool.shutdown(wait=True)
        if local_bytes:
            record_event(
                "checkpoint", "reshard_fetch", via="local", rank=self.rank,
                iteration=it, bytes=local_bytes,
            )
        if fetches:
            record_event(
                "checkpoint", "reshard_overlap", rank=self.rank, iteration=it,
                fetches=fetches, workers=workers, local_bytes=local_bytes,
                duration_s=time.perf_counter() - t0,
            )
        return buffers

    # -- lifecycle ---------------------------------------------------------

    def maybe_finalize(self, blocking: bool = False) -> list[int]:
        return self.queue.maybe_finalize_async_calls(blocking=blocking)

    def close(self) -> None:
        # NOTE: the ranged-read registration outlives close() on purpose —
        # serving only needs the shard files, and a peer mid-reshard must not
        # lose its source because this rank assembled (and closed) first. The
        # registration dies with the exchange.
        self.queue.close()

    def wipe(self) -> None:
        """Remove this rank's local checkpoint directory (tests / teardown)."""
        shutil.rmtree(self._dir, ignore_errors=True)
        os.makedirs(self._dir, exist_ok=True)
