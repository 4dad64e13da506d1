"""Whole-pytree async checkpointing to durable storage.

The reference wraps ``torch.save`` in pinned-memory preload + an ``AsyncRequest``
(``checkpointing/async_ckpt/torch_ckpt.py:31-76``) and splits torch-DCP's save into a
foreground plan/metadata phase and a background write phase with plan caching
(``state_dict_saver.py:53-231``). The TPU-native equivalent below:

- Foreground (fast): split the pytree (``PyTreeStateDict``), one batched D2H.
- Background: stream the container file (``checkpoint/format.py``) to the target dir.
- The reference's ``CheckpointMetadataCache`` exists to skip *collectives* (plan +
  metadata exchange). This design has no per-save collectives to skip — the hollow
  skeleton is pickled fresh each save (it is KBs and may contain changing non-array
  leaves like step counters, so caching it would write stale values).

Sharded arrays: each rank saves its own addressable shards; ``rank`` lands in the
filename, and load reassembles per-rank files. (Full global-array gather/scatter is the
job of orbax-style global checkpointing; local resiliency needs the per-rank form.)
"""

from __future__ import annotations

import os
import time
from typing import Any, Optional

from tpu_resiliency_torch.checkpoint import format as ckpt_format
from tpu_resiliency_torch.checkpoint import hollow_pickle as pickle
from tpu_resiliency_torch.checkpoint.async_core import AsyncCallsQueue, AsyncRequest
from tpu_resiliency_torch.checkpoint.staging import HostStagingPool
from tpu_resiliency_torch.checkpoint.state_dict import PyTreeStateDict
from tpu_resiliency_torch.exceptions import CheckpointError
from tpu_resiliency_torch.utils.events import record as record_event
from tpu_resiliency_torch.utils.logging import get_logger
from tpu_resiliency_torch.utils.timers import debug_time
from tpu_resiliency_torch.utils.tracing import span

log = get_logger(__name__)


def _payload_bytes(writes) -> int:
    """Total bytes a write set will put on disk (hollow pickles + tensor data)."""
    total = 0
    for _, hollow_bytes, tensors, _, _ in writes:
        total += len(hollow_bytes)
        for t in tensors:
            total += int(getattr(t, "nbytes", 0) or 0)
    return total


def _prune_stale(cleanup) -> None:
    """``(glob_pattern, keep_path)`` pairs, processed only AFTER every write
    committed — prunes superseded token-named hint files. Best-effort: a crash
    mid-cleanup strands stale files (harmless; next save prunes them), never a
    loadable generation."""
    import glob as _glob

    for pattern, keep in cleanup:
        for stale in _glob.glob(pattern):
            if stale != keep:
                try:
                    os.unlink(stale)
                except OSError:
                    pass


def _write_containers(writes, cleanup=()) -> None:
    """Async-part worker (module-level: picklable). Order matters for
    separation_hint pairs: the LAST write's rename is the commit point.

    Emits one ``ckpt_write_file`` record per container (leaf count + bytes,
    labeled main/hint) so ``metrics_dump`` can attribute save volume to the
    separation-hint container vs the main one, plus the aggregate
    ``ckpt.async_write`` timing."""
    # One pass up front — the success and failure events report the same
    # volume, so computing it twice (once per event path) was pure waste.
    total_bytes = _payload_bytes(writes)
    t0 = time.perf_counter()
    try:
        for path, hollow_bytes, tensors, meta, container in writes:
            written = ckpt_format.write_payload(path, hollow_bytes, tensors, meta=meta)
            record_event(
                "checkpoint", "ckpt_write_file",
                file=os.path.basename(path), container=container,
                bytes=written, leaves=len(tensors),
            )
    except BaseException as e:
        record_event(
            "checkpoint", "timing", name="ckpt.async_write",
            duration_s=time.perf_counter() - t0, ok=False, error=repr(e),
            bytes=total_bytes, files=len(writes),
        )
        raise
    # The background-half latency + volume: with the foreground
    # ``ckpt.async_save`` timing this decomposes a save end to end.
    record_event(
        "checkpoint", "timing", name="ckpt.async_write",
        duration_s=time.perf_counter() - t0, ok=True,
        bytes=total_bytes, files=len(writes),
    )
    _prune_stale(cleanup)


def _write_containers_stream(writes, snapshot, cleanup=()) -> None:
    """Pipelined async-part worker: leaf-STREAMING container writes.

    ``writes`` entries carry leaf INDICES into ``snapshot`` instead of
    materialized tensors; each leaf hits the file the moment its D2H transfer
    resolves (``HostSnapshot.resolve_view``), so device copies and disk IO
    overlap instead of serializing behind a full-tree ``device_get`` barrier.
    Write order still commits separation-hint pairs correctly (last rename is
    the commit point). Thread-caller only — the snapshot holds live device
    references and pool-leased buffers, neither of which crosses a process
    boundary."""
    total_bytes = sum(
        len(hollow_bytes) + sum(snapshot.specs[i]["nbytes"] for i in indices)
        for _, hollow_bytes, indices, _, _ in writes
    )

    def chunks(prefix, indices):
        # One pass feeds both the file and the integrity trailer: each leaf's
        # CRC is taken from the same resolved view the writer streams, so the
        # v2 checksums cost no extra payload read.
        ck = ckpt_format.Checksummer(prefix)
        yield prefix
        for i in indices:
            view = snapshot.resolve_view(i)
            ck.add_leaf(view)
            yield view
        yield ck.trailer()

    t0 = time.perf_counter()
    try:
        for path, hollow_bytes, indices, meta, container in writes:
            prefix = ckpt_format.header_prefix(
                hollow_bytes, [snapshot.specs[i] for i in indices], meta
            )
            written = ckpt_format.write_stream(path, chunks(prefix, indices))
            record_event(
                "checkpoint", "ckpt_write_file",
                file=os.path.basename(path), container=container,
                bytes=written, leaves=len(indices),
            )
    except BaseException as e:
        record_event(
            "checkpoint", "timing", name="ckpt.async_write",
            duration_s=time.perf_counter() - t0, ok=False, error=repr(e),
            bytes=total_bytes, files=len(writes),
        )
        raise
    record_event(
        "checkpoint", "timing", name="ckpt.async_write",
        duration_s=time.perf_counter() - t0, ok=True,
        bytes=total_bytes, files=len(writes),
    )
    _prune_stale(cleanup)


def _split_hollow(full: dict, tensors: list, hint: str):
    """Split a hollowed mapping tree into ``(hinted, rest)`` parts with
    re-indexed placeholders — ONE batched D2H serves both container files."""
    import dataclasses as _dc

    from tpu_resiliency_torch.checkpoint.state_dict import (
        TensorPlaceholder,
        tree_flatten,
        tree_unflatten,
    )

    parts = []
    for subtree in ({hint: full[hint]}, {k: v for k, v in full.items() if k != hint}):
        leaves, treedef = tree_flatten(subtree)
        part_tensors: list = []
        new_leaves = []
        for leaf in leaves:
            if isinstance(leaf, TensorPlaceholder):
                new_leaves.append(_dc.replace(leaf, index=len(part_tensors)))
                part_tensors.append(tensors[leaf.index])
            else:
                new_leaves.append(leaf)
        parts.append(
            (tree_unflatten(treedef, new_leaves), part_tensors)
        )
    return parts


class AsyncCheckpointer:
    """Asynchronous whole-tree save/load with structure caching.

    ``async_save`` returns immediately after D2H; call ``maybe_finalize()`` from the
    train loop (the reference's ``maybe_finalize_async_calls``, ``core.py:541``) or
    ``finalize_all()`` before exit.
    """

    #: Bounded-backoff schedule for :meth:`_serialize_conflicting`: start at
    #: 1 ms (a local write usually clears within a few), cap at 250 ms so a
    #: long cross-rank finalize isn't hammered with all-reduces.
    CONFLICT_BACKOFF_INITIAL = 0.001
    CONFLICT_BACKOFF_MAX = 0.25

    def __init__(
        self,
        caller: str = "thread",
        sync_fn=None,
        pipelined: Optional[bool] = None,
        staging: Optional[HostStagingPool] = None,
        conflict_timeout: float = 600.0,
    ):
        """``pipelined`` (default: auto — on for the thread caller) runs the
        snapshot engine: ``async_save``'s caller-visible window is enqueue +
        skeleton pickle; D2H resolution and container writes stream leaf by
        leaf in the background, staged through ``staging`` (a
        :class:`HostStagingPool`, created double-buffered when omitted) so
        steady-state saves allocate no large host buffers. Process/fork
        callers can't share the snapshot (live device refs + pooled buffers)
        and keep the materialize-then-schedule path.

        ``conflict_timeout``: seconds :meth:`async_save` will wait for an
        in-flight save to the same path before raising ``CheckpointError``.
        """
        self.queue = AsyncCallsQueue(caller=caller, sync_fn=sync_fn)
        self.pipelined = caller == "thread" if pipelined is None else pipelined
        if self.pipelined and caller != "thread":
            raise CheckpointError(
                "pipelined snapshots require caller='thread' (the snapshot "
                "holds live device references and pool-leased buffers that "
                "cannot cross a process boundary)"
            )
        self.staging = staging if staging is not None else HostStagingPool()
        self.conflict_timeout = conflict_timeout
        #: schedule idx → the file paths that save touches. Two in-flight saves
        #: to one path would race on the shared ``.dirty`` tmp file AND the
        #: hint-file cleanup (one save pruning the other's just-written hint),
        #: so overlapping targets serialize on the earlier save.
        self._inflight_paths: dict[int, frozenset] = {}

    def _serialize_conflicting(
        self, targets: frozenset, timeout: Optional[float] = None
    ) -> None:
        timeout = self.conflict_timeout if timeout is None else timeout
        deadline = time.monotonic() + timeout
        delay = self.CONFLICT_BACKOFF_INITIAL
        while True:
            live = set(self.queue.unfinalized_indices)
            self._inflight_paths = {
                i: p for i, p in self._inflight_paths.items() if i in live
            }
            conflicting = sorted(
                set().union(
                    *(targets & paths for paths in self._inflight_paths.values()),
                    frozenset(),
                )
            )
            if not conflicting:
                return
            if time.monotonic() >= deadline:
                # A save that can never clear (peer rank dead mid-finalize, a
                # wedged writer) must surface, not spin the train loop forever.
                raise CheckpointError(
                    f"timed out after {timeout:g}s waiting for in-flight save(s) "
                    f"to finalize before reusing path(s): {conflicting}"
                )
            self.queue.maybe_finalize_async_calls(blocking=True)
            # One blocking call need not drain: a cross-rank sync_fn vetoes
            # finalization until EVERY rank's write finished, so keep retrying
            # until the conflicting save is truly gone — scheduling anyway
            # would race on the shared .dirty tmp file. Exponential backoff
            # (1 ms → 250 ms cap) instead of a hot 10 ms spin: the all-reduce
            # behind a cross-rank sync_fn is not free to hammer.
            time.sleep(min(delay, max(0.0, deadline - time.monotonic())))
            delay = min(delay * 2, self.CONFLICT_BACKOFF_MAX)

    @staticmethod
    def _hollow_bytes(sd: PyTreeStateDict) -> bytes:
        # Always pickled fresh: the skeleton carries non-array leaves (step counters,
        # schedules) whose values change between saves with an identical treedef.
        return pickle.dumps(sd.hollow_tree, protocol=pickle.HIGHEST_PROTOCOL)

    def async_save(
        self,
        tree: Any,
        path: str,
        meta: Optional[dict] = None,
        rank: Optional[int] = None,
        separation_hint: Optional[str] = None,
    ) -> AsyncRequest:
        """``tree`` may be a raw pytree or an already-hollowed ``PyTreeStateDict``
        (lets a caller saving to several tiers pay the D2H copy once).

        ``separation_hint``: name of a top-level mapping key (e.g.
        ``"opt_state"``) routed to its OWN container file
        ``<base>.<hint>.<token><ext>`` — the reference's ``separation_hint``
        (``filesystem_async.py:558``), letting storage policy differ per content
        class (keep every model file, prune optimizer files early; put optimizer
        state on cheaper storage). The tree's top level must be a mapping
        containing the key; pass the same hint to :meth:`load`. The
        hollow/payload split happens once (one batched D2H).

        Durability contract: the hint file is named by the save's unique pair
        token and written FIRST; the main file (whose meta records the token)
        renames LAST and is the sole commit point. A crash anywhere in between
        leaves the previous generation's main+hint pair fully loadable — the old
        token-named hint file is pruned only after the new main file committed.
        """
        # Foreground half: the caller-visible stall a train loop pays per
        # save. Pipelined, that is enqueue + skeleton pickle + schedule (D2H
        # resolution happens leaf-streaming in the background); legacy, it
        # includes the blocking whole-tree D2H. Both are measured here — the
        # ``ckpt.save.enqueue`` span and ``ckpt_foreground_blocked`` record are
        # what the foreground-window regression gate and
        # ``tpu_ckpt_foreground_blocked_seconds`` aggregate.
        t0 = time.perf_counter()
        with span("checkpoint", "ckpt.save.enqueue", path=os.path.basename(path)):
            with debug_time("ckpt.async_save", source="checkpoint"):
                req = self._async_save(tree, path, meta, rank, separation_hint)
        record_event(
            "checkpoint", "ckpt_foreground_blocked",
            duration_s=time.perf_counter() - t0,
            engine="pipelined" if self.pipelined else "sync",
            path=os.path.basename(path),
        )
        return req

    def _async_save(
        self,
        tree: Any,
        path: str,
        meta: Optional[dict],
        rank: Optional[int],
        separation_hint: Optional[str],
    ) -> AsyncRequest:
        if isinstance(tree, PyTreeStateDict):
            sd = tree
            if not sd.is_hollow:
                sd.pop_tensors()
        else:
            sd = PyTreeStateDict(tree)
            sd.pop_tensors()
        if self.pipelined:
            # Enqueue every leaf's D2H without blocking; the background worker
            # resolves + writes leaf by leaf out of the pooled staging buffers.
            snapshot = sd.copy_tensors_to_host_async(pool=self.staging)
            payload = list(range(len(snapshot)))
        else:
            sd.copy_tensors_to_host()
            snapshot = None
            payload = sd.tensors()
        if separation_hint is None:
            writes = [
                (
                    self._rank_path(path, rank),
                    self._hollow_bytes(sd),
                    payload,
                    meta or {},
                    "main",
                )
            ]
            cleanup = ()
        else:
            full = sd.hollow_tree
            if not isinstance(full, dict) or separation_hint not in full:
                if snapshot is not None:
                    snapshot.release()
                raise CheckpointError(
                    f"separation_hint {separation_hint!r} is not a top-level "
                    f"mapping key of the tree "
                    f"({sorted(full) if isinstance(full, dict) else type(full).__name__})"
                )
            import secrets

            # The token both NAMES the hint file and rides in each meta: the
            # main file commits last and points at exactly one hint file, so a
            # crash between the two renames can never shadow or tear the
            # previous generation — user-supplied meta alone can't carry this
            # (meta=None is the common case).
            token = secrets.token_hex(8)
            meta_w = {**(meta or {}), "_pair_token": token}
            # Hinted file FIRST: the main file's rename is the commit point.
            # Splitting over the identity payload (pipelined: leaf indices)
            # routes each file's leaves without materializing anything.
            (hint_tree, hint_payload), (rest_tree, rest_payload) = _split_hollow(
                full, payload, separation_hint
            )
            hint_target = self._rank_path(
                self._hint_path(path, separation_hint, token), rank
            )
            writes = [
                (
                    hint_target,
                    pickle.dumps(hint_tree, protocol=pickle.HIGHEST_PROTOCOL),
                    hint_payload,
                    meta_w,
                    "hint",
                ),
                (
                    self._rank_path(path, rank),
                    pickle.dumps(rest_tree, protocol=pickle.HIGHEST_PROTOCOL),
                    rest_payload,
                    meta_w,
                    "main",
                ),
            ]
            cleanup = ((self._hint_glob(path, separation_hint, rank), hint_target),)
        if snapshot is not None:
            req = AsyncRequest(
                async_fn=_write_containers_stream,
                async_fn_args=(writes, snapshot, cleanup),
                cleanup_fns=(snapshot.release,),
            )
        else:
            req = AsyncRequest(
                async_fn=_write_containers, async_fn_args=(writes, cleanup)
            )
        targets = frozenset(w[0] for w in writes)
        try:
            self._serialize_conflicting(targets)
            idx = self.queue.schedule_async_request(req)
        except BaseException:
            if snapshot is not None:
                snapshot.release()
            raise
        self._inflight_paths[idx] = targets
        return req

    @debug_time("ckpt.save_sync", source="checkpoint")
    def save(self, tree: Any, path: str, meta: Optional[dict] = None, rank: Optional[int] = None) -> None:
        sd = PyTreeStateDict(tree)
        sd.pop_tensors()
        sd.copy_tensors_to_host()
        _write_containers(
            [
                (
                    self._rank_path(path, rank),
                    pickle.dumps(sd.hollow_tree, protocol=pickle.HIGHEST_PROTOCOL),
                    sd.tensors(),
                    meta or {},
                    "main",
                )
            ]
        )

    @staticmethod
    def _rank_path(path: str, rank: Optional[int]) -> str:
        if rank is None:
            return path
        base, ext = os.path.splitext(path)
        return f"{base}.r{rank}{ext}"

    @staticmethod
    def _hint_path(path: str, hint: str, token: str) -> str:
        base, ext = os.path.splitext(path)
        return f"{base}.{hint}.{token}{ext}"

    @staticmethod
    def _hint_glob(path: str, hint: str, rank: Optional[int]) -> str:
        """Glob matching every generation's hint file for this (path, hint,
        rank) — 16 lowercase-hex chars, the exact shape of ``token_hex(8)``,
        so sibling ranks and other hints never match. The user-controlled parts
        are glob-escaped: metacharacters in a sweep dir like ``run[1]/`` must
        match literally, not as character classes."""
        import glob as _glob

        base, ext = os.path.splitext(path)
        rank_sfx = "" if rank is None else f".r{rank}"
        return (
            _glob.escape(f"{base}.{hint}.")
            + "[0-9a-f]" * 16
            + _glob.escape(f"{rank_sfx}{ext}")
        )

    @staticmethod
    def load(
        path: str,
        rank: Optional[int] = None,
        shardings=None,
        device=None,
        separation_hint: Optional[str] = None,
    ) -> tuple[Any, dict]:
        """Returns (tree, meta); arrays placed per ``shardings``/``device`` if given.

        Pass the ``separation_hint`` the save used to also read the routed file
        and merge it back under its key. ``shardings`` must then be a mapping
        that mirrors the saved tree minus-or-plus the hint key: the hint entry
        may be omitted (its file gets default placement), every other key must
        match the main file's tree exactly (the flat per-tensor-sequence form
        cannot be split across two files)."""
        # Restore latency is half the recovery-time story — record it like save.
        with debug_time("ckpt.load", source="checkpoint"):
            return AsyncCheckpointer._load(
                path, rank, shardings, device, separation_hint
            )

    @staticmethod
    def _load(
        path: str,
        rank: Optional[int],
        shardings,
        device,
        separation_hint: Optional[str],
    ) -> tuple[Any, dict]:
        if separation_hint is not None:
            shard_rest = shard_hint = None
            if shardings is not None:
                if not isinstance(shardings, dict):
                    raise CheckpointError(
                        "separation_hint load needs shardings as a mapping "
                        "(flat per-tensor sequences cannot be split across the "
                        f"routed files); got {type(shardings).__name__}"
                    )
                shard_rest = {
                    k: v for k, v in shardings.items() if k != separation_hint
                } or None
                if separation_hint in shardings:
                    shard_hint = {separation_hint: shardings[separation_hint]}
            # The committed main file names its pair: its meta token selects
            # the one hint file written in the same save, so a crash between
            # the two renames (new hint landed, old main still committed)
            # resolves to the OLD, complete pair instead of a torn merge.
            rest, meta_raw = AsyncCheckpointer._load_file(
                AsyncCheckpointer._rank_path(path, rank), shard_rest, device
            )
            token = meta_raw.get("_pair_token")
            if not isinstance(token, str):
                raise CheckpointError(
                    f"{path} was not written with separation_hint="
                    f"{separation_hint!r} (no pair token in its meta)"
                )
            hint_file = AsyncCheckpointer._rank_path(
                AsyncCheckpointer._hint_path(path, separation_hint, token), rank
            )
            hinted, hint_raw = AsyncCheckpointer._load_file(
                hint_file, shard_hint, device
            )
            # Compare ONLY the tokens: they are unique per save, so equality is
            # sufficient — and user meta may hold numpy arrays, whose dict
            # inequality raises instead of answering.
            if hint_raw.get("_pair_token") != token:
                raise CheckpointError(
                    f"separated checkpoint pair is torn: {hint_file} carries "
                    f"token {hint_raw.get('_pair_token')!r}, main expects {token!r}"
                )
            meta = {k: v for k, v in meta_raw.items() if k != "_pair_token"}
            return {**rest, **hinted}, meta
        tree, meta_raw = AsyncCheckpointer._load_file(
            AsyncCheckpointer._rank_path(path, rank), shardings, device
        )
        # The pair token is save-internal plumbing; user meta stays clean even
        # when one file of a separated pair is loaded directly.
        return tree, {k: v for k, v in meta_raw.items() if k != "_pair_token"}

    @staticmethod
    def _load_file(target: str, shardings, device) -> tuple[Any, dict]:
        """One container read; returns the RAW meta (token intact — the hint
        path's torn-pair comparison needs it)."""
        if not os.path.exists(target):
            raise CheckpointError(f"no checkpoint at {target}")
        hollow_b, tensors, meta = ckpt_format.read_payload(target)
        sd = PyTreeStateDict.from_hollow(
            pickle.loads(hollow_b), tensors, shardings=shardings, device=device
        )
        return sd.tree, meta

    def maybe_finalize(self, blocking: bool = False) -> list[int]:
        return self.queue.maybe_finalize_async_calls(blocking=blocking)

    def finalize_all(self) -> list[int]:
        return self.queue.finalize_all()

    def close(self) -> None:
        self.queue.close()
