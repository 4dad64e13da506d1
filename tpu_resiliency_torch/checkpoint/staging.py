"""Pinned host staging buffer pool for pipelined checkpoint snapshots.

Port of ``tpu_resiliency/checkpoint/staging.py``. Every async save needs a
full-state-size set of host buffers to land the D2H copies in. Allocating them
fresh per save costs a pinned allocation (``cudaHostAlloc``) over the whole payload
on EVERY checkpoint interval — the reference amortizes this with pinned-memory
tensors it reuses across saves (``checkpointing/utils.py:85``). Buffers are keyed
by the tree's **leaf signature** (shape/dtype per leaf, in pop order) and recycled
across saves, so the steady-state save performs no large host allocations at all.

Double buffering is the default (``depth=2``): save N+1 can acquire a second
buffer set while save N's background half is still writing/replicating out of
the first, so the train loop never waits on the previous save's IO to reclaim
staging memory. A third concurrent save of the same signature blocks in
``acquire`` until a lease frees — bounding staging memory at
``depth × tree_bytes`` instead of growing with queue depth.

Each lease is one ``torch.uint8`` backing buffer, pinned when the machine has a
CUDA card, cut into 64-byte-aligned windows: typed views as
torch tensors (what ``fill`` copies into, ``non_blocking`` from the card with one
event per leaf) and raw uint8 memoryviews (what the zero-copy
``format.serialize_parts`` / ``PeerExchange.send_parts`` path consumes). Pool
traffic is narrated to the event stream (``staging_pool`` records →
``tpu_ckpt_staging_pool_bytes`` gauge and
``tpu_ckpt_staging_requests_total{outcome}``).
"""

from __future__ import annotations

import threading
from typing import Any, Optional, Sequence

import numpy as np
import torch

from tpu_resiliency_torch.exceptions import CheckpointError
from tpu_resiliency_torch.utils.events import record as record_event
from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)

#: Leaf offsets within a lease's backing buffer are rounded up to this, so every
#: staged view is cacheline/SIMD aligned regardless of its neighbors' sizes.
_ALIGN = 64


def leaf_signature(specs: Sequence[dict]) -> tuple:
    """Hashable pool key for a leaf-spec list (shape + dtype per leaf, in order)."""
    return tuple((tuple(s["shape"]), str(s["dtype"]), int(s["nbytes"])) for s in specs)


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _lease_bytes(key: tuple) -> int:
    # One extra alignment quantum: the lease skews its first offset so leaf
    # views sit on 64-aligned addresses regardless of the backing's base.
    return sum(_aligned(n) for _, _, n in key) + _ALIGN


def _allocate(nbytes: int) -> torch.Tensor:
    """Uninitialised host backing (no O(bytes) zeroing: pages fault in as ``fill``
    first touches them), pinned when the machine has a CUDA card."""
    from tpu_resiliency_torch.checkpoint.state_dict import host_empty

    return host_empty((nbytes,), torch.uint8, pin=torch.cuda.is_available())


class StagingLease:
    """One leased buffer set: typed tensor views + raw uint8 windows over one
    backing buffer. Release returns it to the pool (idempotent); the views must not
    be used after release — the next save of the same signature will overwrite
    them. ``pool=None`` makes a lease of its own (:meth:`unpooled`)."""

    def __init__(self, pool: Optional["HostStagingPool"], key: tuple, backing: torch.Tensor):
        from tpu_resiliency_torch.checkpoint.state_dict import torch_dtype

        self._pool = pool
        self.key = key
        self._backing = backing
        self.pinned = backing.is_pinned()
        self.views: list[torch.Tensor] = []
        self.raw_views: list[memoryview] = []
        self._events: list = [None] * len(key)
        # The backing allocation's payload may not be 64-aligned; skew the first
        # offset so every leaf view lands on an aligned ADDRESS (the buffer is
        # overallocated by one alignment quantum for exactly this).
        off = (-backing.data_ptr()) % _ALIGN
        flat = backing.numpy()
        for shape, dtype, nbytes in key:
            window = backing[off : off + nbytes]
            self.raw_views.append(memoryview(flat[off : off + nbytes]))
            self.views.append(window.view(torch_dtype(dtype)).view(shape))
            off += _aligned(nbytes)
        self.nbytes = sum(n for _, _, n in key)
        self._released = False

    @classmethod
    def unpooled(cls, specs: Sequence[dict]) -> "StagingLease":
        """A lease of its own for one snapshot (no pool): pinned when a card exists."""
        key = leaf_signature(specs)
        return cls(None, key, _allocate(_lease_bytes(key)))

    def fill(self, index: int, src: Any) -> torch.Tensor:
        """Copy one leaf into its staged window; returns the staged typed view. A
        card tensor is copied ``non_blocking`` on the current stream, which then
        records the leaf's event (:meth:`wait` blocks on it); a host tensor or array
        is copied at once, by numpy: one memcpy in the calling thread, which drops the
        GIL, so background staging never stalls the train-loop thread. torch's CPU
        copy would split a large leaf over its intra-op threads, and two copies at
        once (a clique's ranks in one process, or a save's foreground beside another
        save's background) oversubscribe that pool and stall."""
        from tpu_resiliency_torch.checkpoint.state_dict import from_numpy, to_numpy

        if not isinstance(src, torch.Tensor):
            src = np.asarray(src)  # (np.ascontiguousarray would make a 0-d leaf 1-d)
            src = from_numpy(src if src.flags.c_contiguous else src.copy(order="C"))
        dst = self.views[index]
        nbytes = src.numel() * src.element_size()
        if nbytes != self.key[index][2]:
            raise CheckpointError(
                f"staging lease leaf {index}: got {nbytes} B, "
                f"signature says {self.key[index][2]} B"
            )
        if not src.is_cuda:
            np.copyto(to_numpy(dst), to_numpy(src.detach()))
            return dst
        try:
            dst.copy_(src, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        except RuntimeError as e:
            raise CheckpointError(f"staging lease leaf {index}: D2H copy failed ({e})") from e
        self._events[index] = event
        return dst

    def wait(self, index: int) -> None:
        """Block until leaf ``index``'s copy has landed (at once for a host leaf)."""
        event = self._events[index]
        if event is not None:
            event.synchronize()
            self._events[index] = None

    def wait_all(self) -> None:
        for i in range(len(self._events)):
            self.wait(i)

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        if self._pool is not None:
            self._pool._release(self.key, self._backing)


class HostStagingPool:
    """Signature-keyed pool of reusable host snapshot buffers.

    ``acquire(specs)`` returns a :class:`StagingLease` — a pooled buffer on a
    hit, a freshly allocated one while fewer than ``depth`` leases of that
    signature exist, and otherwise blocks until a lease releases (``timeout``
    seconds, then :class:`CheckpointError`). ``try_acquire(specs)`` returns a pooled
    buffer or ``None`` at once (a save's foreground). Thread-safe; leases release from
    background writer threads. The buffers are pinned when the machine has a CUDA
    card, so a card leaf is only ever staged into pinned memory.
    """

    def __init__(self, depth: int = 2, timeout: float = 600.0):
        if depth < 1:
            raise ValueError("staging pool depth must be >= 1")
        self.depth = depth
        self.timeout = timeout
        self._cond = threading.Condition()
        self._free: dict[tuple, list[torch.Tensor]] = {}
        self._count: dict[tuple, int] = {}
        #: cumulative stats — the pool-hit acceptance check reads these
        self.hits = 0
        self.misses = 0
        self.total_bytes = 0
        self.in_use_bytes = 0

    def acquire(
        self, specs: Sequence[dict], timeout: Optional[float] = None
    ) -> StagingLease:
        key = leaf_signature(specs)
        need = _lease_bytes(key)
        deadline = None
        outcome = "hit"
        with self._cond:
            while True:
                free = self._free.get(key)
                if free:
                    backing = free.pop()
                    break
                if self._count.get(key, 0) < self.depth:
                    # Misses run once per signature per depth slot — never
                    # steady state.
                    backing = _allocate(need)
                    self._count[key] = self._count.get(key, 0) + 1
                    self.total_bytes += need
                    outcome = "miss"
                    break
                if deadline is None:
                    import time as _time

                    deadline = _time.monotonic() + (
                        self.timeout if timeout is None else timeout
                    )
                    outcome = "wait"
                import time as _time

                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    raise CheckpointError(
                        f"staging pool: all {self.depth} buffer(s) for this tree "
                        f"signature still leased after {self.timeout if timeout is None else timeout}s "
                        f"(previous saves' background halves have not released)"
                    )
                self._cond.wait(timeout=min(remaining, 1.0))
            if outcome == "miss":
                self.misses += 1
            else:
                self.hits += 1
            self.in_use_bytes += need
            pool_bytes, in_use = self.total_bytes, self.in_use_bytes
        record_event(
            "checkpoint", "staging_pool",
            outcome=outcome, nbytes=need, pool_bytes=pool_bytes,
            in_use_bytes=in_use,
        )
        return StagingLease(self, key, backing)

    def try_acquire(self, specs: Sequence[dict]) -> Optional[StagingLease]:
        """A released buffer of this signature, or ``None`` at once: never allocates,
        never waits. The pipelined save's foreground snapshots host leaves straight
        into it; without one it clones them fresh and acquires in the background."""
        key = leaf_signature(specs)
        need = _lease_bytes(key)
        with self._cond:
            free = self._free.get(key)
            if not free:
                return None
            backing = free.pop()
            self.hits += 1
            self.in_use_bytes += need
            pool_bytes, in_use = self.total_bytes, self.in_use_bytes
        record_event(
            "checkpoint", "staging_pool",
            outcome="hit", nbytes=need, pool_bytes=pool_bytes, in_use_bytes=in_use,
        )
        return StagingLease(self, key, backing)

    def _release(self, key: tuple, backing: torch.Tensor) -> None:
        with self._cond:
            self._free.setdefault(key, []).append(backing)
            self.in_use_bytes -= _lease_bytes(key)
            pool_bytes, in_use = self.total_bytes, self.in_use_bytes
            self._cond.notify_all()
        record_event(
            "checkpoint", "staging_pool",
            outcome="release", nbytes=_lease_bytes(key),
            pool_bytes=pool_bytes, in_use_bytes=in_use,
        )

    def trim(self) -> int:
        """Drop every idle buffer (e.g. after the tree signature changed for
        good — a resharding restart). Returns bytes freed; leased buffers are
        untouched and rejoin the pool on release."""
        with self._cond:
            freed = 0
            for key, bufs in self._free.items():
                freed += _lease_bytes(key) * len(bufs)
                self._count[key] = self._count.get(key, 0) - len(bufs)
            self._free.clear()
            self.total_bytes -= freed
        if freed:
            log.info(f"staging pool trimmed {freed} idle bytes")
        return freed

    def stats(self) -> dict:
        with self._cond:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "total_bytes": self.total_bytes,
                "in_use_bytes": self.in_use_bytes,
                "signatures": len(self._count),
            }
