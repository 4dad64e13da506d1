"""Asynchronous checkpoint execution: requests, callers, and the finalization queue.

Re-design of the reference's async core (``checkpointing/async_ckpt/core.py``):
``AsyncRequest`` (``core.py:37``), ``TemporalAsyncCaller`` fork-per-save
(``core.py:176-276``), ``PersistentAsyncCaller`` spawn-once worker (``core.py:279-473``),
and ``AsyncCallsQueue`` with its distributed is-done agreement (``core.py:152-164``) and
finalize-on-all-ranks step (``core.py:541-570``).

TPU-first changes:

- **Default caller is a thread, not a fork.** Forking a process that holds a live TPU
  runtime client is unsafe (the child inherits device handles it must never touch). By
  the time a request is scheduled the payload is already host numpy (see
  ``PyTreeStateDict.copy_tensors_to_host``), and file writes release the GIL, so a
  daemon thread gets fork-level overlap without the hazard.
- **Process caller uses spawn, started eagerly.** The spawn-once persistent worker
  (started before any request, so it inherits nothing) matches the reference's
  ``PersistentAsyncCaller``; payloads cross via the queue, which is why the thread
  caller is the default — use the process caller when GIL contention in the trainer
  matters more than the one extra copy.
- **Distributed agreement is pluggable.** The reference all-reduces ``is_alive`` over
  NCCL/Gloo; here any callable ``(bool) -> bool`` works — the store-backed group comm
  (``checkpoint/comm.py``) provides one; single-process callers pass nothing.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import queue as queue_mod
import threading
import time
from typing import Any, Callable, Optional, Sequence

from tpu_resiliency_torch.exceptions import CheckpointError
from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class AsyncRequest:
    """A checkpoint save split into an async part and on-all-ranks finalization.

    Mirrors reference ``core.py:37-123``: ``async_fn(*async_fn_args)`` runs in the
    background caller; ``finalize_fns`` run synchronously on every rank once all ranks'
    async parts are done; ``preload_fn`` (if any) runs synchronously *before* the async
    part is scheduled (D2H staging).

    ``cleanup_fns`` run in the SAME context as the async part, immediately after
    it, on success AND on failure — resource reclamation that must not depend on
    finalization happening (a staging-lease release must fire even when the save
    failed or the queue was ``abandon``\\ ed, or the pool leaks a full-tree
    buffer per incident). Process/fork callers require them picklable, like
    ``async_fn`` itself.
    """

    async_fn: Optional[Callable]
    async_fn_args: tuple = ()
    async_fn_kwargs: dict = dataclasses.field(default_factory=dict)
    finalize_fns: tuple = ()
    preload_fn: Optional[Callable] = None
    cleanup_fns: tuple = ()

    def add_finalize_fn(self, fn: Callable) -> "AsyncRequest":
        return dataclasses.replace(self, finalize_fns=tuple(self.finalize_fns) + (fn,))

    def run_async_part(self) -> None:
        """``async_fn`` then ``cleanup_fns`` (unconditionally) — the one body
        every caller executes in its background context."""
        try:
            if self.async_fn is not None:
                self.async_fn(*self.async_fn_args, **self.async_fn_kwargs)
        finally:
            for fn in self.cleanup_fns:
                try:
                    fn()
                except Exception:
                    log.warning("async-save cleanup_fn failed", exc_info=True)

    def execute_sync(self) -> None:
        """Debug/fallback path: run everything inline."""
        if self.preload_fn is not None:
            self.preload_fn()
        self.run_async_part()
        for fn in self.finalize_fns:
            fn()


class AsyncCaller:
    """Interface: run an async_fn in the background, poll or await completion."""

    def schedule(self, req: AsyncRequest) -> None:
        raise NotImplementedError

    def is_done(self) -> bool:
        raise NotImplementedError

    def wait(self, timeout: Optional[float] = None) -> bool:
        raise NotImplementedError

    def raise_if_failed(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class ThreadAsyncCaller(AsyncCaller):
    """One daemon thread per scheduled save (the TPU-safe default)."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def schedule(self, req: AsyncRequest) -> None:
        if self._thread is not None and self._thread.is_alive():
            raise CheckpointError("previous async save still running")
        self._error = None

        def run() -> None:
            try:
                req.run_async_part()
            except BaseException as e:  # propagated from raise_if_failed
                self._error = e

        self._thread = threading.Thread(target=run, name="ckpt-async-save", daemon=True)
        self._thread.start()

    def is_done(self) -> bool:
        return self._thread is None or not self._thread.is_alive()

    def wait(self, timeout: Optional[float] = None) -> bool:
        if self._thread is None:
            return True
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def raise_if_failed(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise CheckpointError(f"async checkpoint save failed: {err!r}") from err


def _worker_loop(req_q, done_q) -> None:
    """Persistent spawn-worker body (module-level for picklability)."""
    while True:
        item = req_q.get()
        if item is None:
            return
        idx, fn, args, kwargs, cleanups = item
        try:
            try:
                fn(*args, **kwargs)
            finally:
                for c in cleanups:
                    try:
                        c()
                    except Exception:
                        pass
            done_q.put((idx, None))
        except BaseException as e:
            done_q.put((idx, repr(e)))


class ProcessAsyncCaller(AsyncCaller):
    """Spawn-once persistent worker process (reference ``PersistentAsyncCaller``).

    Started eagerly at construction — before the parent accumulates TPU state worth
    worrying about — and fed via a queue. ``async_fn`` and its args must be picklable.
    """

    def __init__(self) -> None:
        ctx = multiprocessing.get_context("spawn")
        self._req_q = ctx.Queue()
        self._done_q = ctx.Queue()
        self._proc = ctx.Process(
            target=_worker_loop, args=(self._req_q, self._done_q), daemon=True
        )
        self._proc.start()
        self._next_idx = 0
        self._pending: Optional[int] = None
        self._error: Optional[str] = None

    def schedule(self, req: AsyncRequest) -> None:
        if self._pending is not None:
            raise CheckpointError("previous async save still running")
        if not self._proc.is_alive():
            raise CheckpointError("checkpoint worker process died")
        idx = self._next_idx
        self._next_idx += 1
        self._req_q.put(
            (idx, req.async_fn, req.async_fn_args, req.async_fn_kwargs,
             tuple(req.cleanup_fns))
        )
        self._pending = idx

    def _drain(self, timeout: Optional[float]) -> None:
        if self._pending is None:
            return
        try:
            idx, err = self._done_q.get(timeout=timeout)
        except queue_mod.Empty:
            return
        if idx == self._pending:
            self._pending = None
            self._error = err

    def is_done(self) -> bool:
        self._drain(timeout=0.0 if self._pending is not None else None)
        return self._pending is None

    def wait(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        while self._pending is not None:
            if not self._proc.is_alive():
                self._pending = None
                self._error = "checkpoint worker process died"
                break
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            self._drain(timeout=min(0.5, remaining) if remaining is not None else 0.5)
            if remaining is not None and remaining <= 0:
                break
        return self._pending is None

    def raise_if_failed(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise CheckpointError(f"async checkpoint save failed in worker: {err}")

    def close(self) -> None:
        try:
            self._req_q.put(None)
            self._proc.join(timeout=5.0)
            if self._proc.is_alive():
                self._proc.terminate()
        except (ValueError, OSError):
            pass


def _cuda_initialized() -> bool:
    """True when this process has initialised CUDA (without initialising it by
    asking): a forked child of such a process inherits a CUDA context it cannot use."""
    import sys

    if "torch" not in sys.modules:
        return False
    import torch

    return torch.cuda.is_initialized()


class ForkAsyncCaller(AsyncCaller):
    """Fork-per-save (reference ``TemporalAsyncCaller``). Zero-copy via COW.

    Only safe when the parent has **not initialised CUDA** (e.g. a CPU-host data
    orchestrator) — forking a process with an initialized accelerator client is
    undefined behavior (runtime threads and device handles are duplicated into a
    child that never reaps them). ``schedule`` therefore REFUSES to fork once
    CUDA is initialized in this process, unless constructed with
    ``unsafe_allow_fork_with_backend=True`` (you own the consequences; CPU-only
    backends mostly tolerate it). Provided for parity; the thread caller is the
    default.
    """

    def __init__(self, unsafe_allow_fork_with_backend: bool = False) -> None:
        self._proc: Optional[multiprocessing.Process] = None
        self._failed = False
        self._allow_backend = unsafe_allow_fork_with_backend

    def schedule(self, req: AsyncRequest) -> None:
        if self._proc is not None and self._proc.is_alive():
            raise CheckpointError("previous async save still running")
        if not self._allow_backend and _cuda_initialized():
            raise CheckpointError(
                "refusing to fork a checkpoint writer: this process has "
                "initialized CUDA (forking duplicates runtime threads and "
                "device handles — undefined behavior). Use caller='thread' or "
                "'process' (spawn), or opt in with caller='fork_unsafe' / "
                "ForkAsyncCaller(unsafe_allow_fork_with_backend=True)."
            )
        ctx = multiprocessing.get_context("fork")
        self._proc = ctx.Process(
            target=req.run_async_part,
            daemon=True,
            name="ckpt-fork-save",
        )
        self._failed = False
        self._proc.start()

    def is_done(self) -> bool:
        return self._proc is None or not self._proc.is_alive()

    def wait(self, timeout: Optional[float] = None) -> bool:
        if self._proc is None:
            return True
        self._proc.join(timeout)
        done = not self._proc.is_alive()
        if done and self._proc.exitcode not in (0, None):
            self._failed = True
        return done

    def raise_if_failed(self) -> None:
        if self._proc is not None and not self._proc.is_alive():
            if self._proc.exitcode not in (0, None) or self._failed:
                code = self._proc.exitcode
                self._failed = False
                raise CheckpointError(f"forked checkpoint save exited with code {code}")


_CALLERS = {
    "thread": ThreadAsyncCaller,
    "process": ProcessAsyncCaller,
    "fork": ForkAsyncCaller,
    # The escape hatch, reachable through the string-registry surface too:
    # AsyncCallsQueue(caller="fork_unsafe") forks even over a live JAX backend.
    "fork_unsafe": lambda: ForkAsyncCaller(unsafe_allow_fork_with_backend=True),
}


@dataclasses.dataclass
class _ActiveCall:
    idx: int
    request: AsyncRequest
    caller: AsyncCaller
    start_time: float


class AsyncCallsQueue:
    """FIFO of in-flight async saves with distributed finalization.

    Mirrors reference ``AsyncCallsQueue`` (``core.py:491-580``): saves finalize in
    schedule order; a save finalizes only when **all ranks** report it done (so no rank
    observes a checkpoint as complete while a peer is still writing), after which its
    ``finalize_fns`` run on every rank.

    ``sync_fn(local_done: bool) -> bool`` implements the cross-rank agreement (the
    reference's 1-int all-reduce of ``is_alive``, ``core.py:152-164``); ``None`` means
    single-rank operation.
    """

    def __init__(
        self,
        caller: str = "thread",
        sync_fn: Optional[Callable[[bool], bool]] = None,
        persistent: bool = False,
    ):
        if caller not in _CALLERS:
            raise ValueError(f"unknown caller {caller!r}; one of {sorted(_CALLERS)}")
        self._caller_kind = caller
        self._persistent_caller: Optional[AsyncCaller] = (
            _CALLERS[caller]() if persistent or caller == "process" else None
        )
        self._sync_fn = sync_fn
        self._active: list[_ActiveCall] = []
        self._next_idx = 0

    @property
    def num_unfinalized_calls(self) -> int:
        return len(self._active)

    @property
    def unfinalized_indices(self) -> list[int]:
        """Schedule indices still in flight (FIFO order) — lets callers track
        per-request bookkeeping across finalize/failure paths without guessing
        which indices the last finalize consumed."""
        return [c.idx for c in self._active]

    def schedule_async_request(self, req: AsyncRequest) -> int:
        """Run preload synchronously, then hand the async part to a caller."""
        if req.preload_fn is not None:
            req.preload_fn()
        caller = self._persistent_caller or _CALLERS[self._caller_kind]()
        if self._persistent_caller is not None and self._active:
            # A persistent caller runs one save at a time; wait out the previous one.
            self.maybe_finalize_async_calls(blocking=True)
        caller.schedule(req)
        idx = self._next_idx
        self._next_idx += 1
        self._active.append(_ActiveCall(idx, req, caller, time.monotonic()))
        return idx

    def _call_done(self, call: _ActiveCall, blocking: bool) -> bool:
        local_done = call.caller.wait(None) if blocking else call.caller.is_done()
        if self._sync_fn is not None:
            # All ranks must agree; a blocking caller that is locally done may still
            # need to wait for peers, which the sync_fn's own loop handles.
            return bool(self._sync_fn(local_done))
        return local_done

    def maybe_finalize_async_calls(self, blocking: bool = False) -> list[int]:
        """Finalize completed saves in FIFO order; returns finalized indices."""
        finalized: list[int] = []
        while self._active:
            call = self._active[0]
            if not self._call_done(call, blocking):
                break
            try:
                call.caller.raise_if_failed()
            except Exception:
                # A failed save must not stay queued: the next poll would see it done
                # with its error already consumed and finalize it as a success.
                self._active.pop(0)
                if call.caller is not self._persistent_caller:
                    call.caller.close()
                raise
            for fn in call.request.finalize_fns:
                fn()
            if call.caller is not self._persistent_caller:
                call.caller.close()
            self._active.pop(0)
            finalized.append(call.idx)
        return finalized

    def finalize_all(self) -> list[int]:
        return self.maybe_finalize_async_calls(blocking=True)

    def set_sync_fn(self, sync_fn: Optional[Callable[[bool], bool]]) -> None:
        """Swap the cross-rank agreement function (after the rank group changed).

        Only legal with no in-flight saves: a pending save's agreement was
        entered against the OLD group and must not finalize against the new one
        — :meth:`abandon` first.
        """
        if self._active:
            raise CheckpointError(
                f"{len(self._active)} in-flight saves were scheduled against the "
                "previous rank group; abandon() or finalize them before swapping "
                "sync_fn"
            )
        self._sync_fn = sync_fn

    def abandon(self) -> list[int]:
        """Drop queued saves WITHOUT the collective finalization — for restart
        paths where the group the saves were scheduled against no longer exists
        (dead peers would hang the agreement; a new-world agreement would judge
        the old iteration uncovered). Local async work (file writes) is waited
        out so shards land on disk; coverage verification and pruning are
        skipped — the next successful save re-establishes both. Returns the
        abandoned indices."""
        abandoned: list[int] = []
        while self._active:
            call = self._active.pop(0)
            try:
                call.caller.wait(None)
                call.caller.raise_if_failed()
            except Exception as e:
                log.warning(f"abandoned save {call.idx} had failed locally: {e!r}")
            finally:
                if call.caller is not self._persistent_caller:
                    call.caller.close()
            abandoned.append(call.idx)
        if abandoned:
            log.info(f"abandoned {len(abandoned)} in-flight saves (group change)")
        return abandoned

    def close(self) -> None:
        self.finalize_all()
        if self._persistent_caller is not None:
            self._persistent_caller.close()
