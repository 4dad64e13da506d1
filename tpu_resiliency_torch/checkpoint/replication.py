"""Clique replication of local checkpoint shards across ranks.

Re-design of the reference's replication layer
(``checkpointing/local/replication/strategies.py:76-188`` and ``group_utils.py``): local
checkpoints live on node-local storage, so a lost node loses its shard — unless each
shard is mirrored within a small *clique* of ranks chosen to span failure domains.
``replication_jump`` spaces clique members apart (set it to ranks-per-host so mirrors
land on different hosts / ICI slices); ``replication_factor`` is the mirror count.

Data moves over :class:`~tpu_resiliency_torch.checkpoint.comm.PeerExchange` TCP links (DCN,
not ICI — the training mesh never sees checkpoint traffic); membership math is pure
Python. Retrieval builds an :class:`ExchangePlan` — who sends which shard to whom —
from a store-gathered availability map, mirroring ``group_utils.py:57,466``.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import time
from typing import Any, Callable, Optional, Sequence

from tpu_resiliency_torch.checkpoint import format as ckpt_format
from tpu_resiliency_torch.checkpoint.comm import PeerExchange, StoreComm
from tpu_resiliency_torch.exceptions import CheckpointError
from tpu_resiliency_torch.utils.events import record as record_event
from tpu_resiliency_torch.utils.logging import get_logger
from tpu_resiliency_torch.utils.tracing import span

log = get_logger(__name__)


def _verify_received(payload, src: int, stage: str) -> bool:
    """Verify-on-receive: checksum a peer-delivered container against its v2
    trailer. Returns True to keep the payload; False (after one
    ``ckpt_integrity_failure`` event → ``tpu_ckpt_integrity_failures_total``)
    to treat the frame like a degraded peer's — dropped, never loaded.
    Payloads that aren't v2 containers (v1 format, raw blobs) pass through
    unverified; the format layer records those separately."""
    try:
        ckpt_format.verify_container(payload, source=f"{stage}<-rank{src}")
        return True
    except CheckpointError as e:
        log.warning(
            f"replication: dropping corrupt frame from rank {src} "
            f"({stage}): {e}"
        )
        record_event(
            "checkpoint", "ckpt_integrity_failure", stage=stage, src=src,
            error=repr(e),
        )
        return False


def _fan_out(sends: list[Callable[[], Any]]) -> None:
    """Run peer sends concurrently; first failure propagates.

    The serial peer loop paid full wire time per peer; concurrent sends overlap
    them so a round's send side costs ~one shard transfer regardless of clique
    size (the network analogue of the reference's per-bucket writer fan-out,
    ``filesystem_async.py:232-334``). Per-call executor: rounds are minutes
    apart and move GBs — thread spawn is noise, and there is no pool lifecycle
    to leak.
    """
    if not sends:
        return
    if len(sends) == 1:
        sends[0]()
        return
    with cf.ThreadPoolExecutor(max_workers=len(sends)) as pool:
        for f in [pool.submit(s) for s in sends]:
            f.result()


def parse_group_sequence(
    replication_jump: int, replication_factor: int, world_size: int
) -> list[list[int]]:
    """Partition ``range(world_size)`` into cliques of ``replication_factor`` ranks
    spaced ``replication_jump`` apart (reference ``group_utils.py:124``).

    Example: jump=2, factor=2, world=8 → [[0,2],[1,3],[4,6],[5,7]].
    """
    if replication_factor < 1:
        raise ValueError("replication_factor must be >= 1")
    if replication_jump < 1:
        raise ValueError("replication_jump must be >= 1")
    block = replication_jump * replication_factor
    if world_size % block != 0:
        raise ValueError(
            f"world_size {world_size} not divisible by "
            f"replication_jump*replication_factor = {block}"
        )
    return group_sequence_for(range(world_size), replication_jump, replication_factor)


def group_sequence_for(
    active_ranks: Sequence[int], replication_jump: int, replication_factor: int
) -> list[list[int]]:
    """Cliques over an ARBITRARY active rank set — the post-reassignment worlds
    this framework produces are rarely ``range(n)`` and rarely divisible.

    Full blocks follow :func:`parse_group_sequence`'s jump spacing over *positions*
    in the sorted active list (positions, not rank ids: after a shrink the
    survivors' ids have gaps, but failure domains follow physical placement order).
    Remainder ranks merge into the last full-spacing clique when one exists
    (slightly larger clique beats an unmirrored shard); with no full block they
    form consecutive cliques of up to ``replication_factor``.
    """
    if replication_factor < 1:
        raise ValueError("replication_factor must be >= 1")
    if replication_jump < 1:
        raise ValueError("replication_jump must be >= 1")
    ranks = sorted(active_ranks)
    n = len(ranks)
    block = replication_jump * replication_factor
    full_end = (n // block) * block
    groups: list[list[int]] = []
    for base in range(0, full_end, block):
        for offset in range(replication_jump):
            groups.append(
                [
                    ranks[base + offset + k * replication_jump]
                    for k in range(replication_factor)
                ]
            )
    rem = ranks[full_end:]
    if rem:
        if groups:
            groups[-1].extend(rem)
        else:
            for i in range(0, len(rem), replication_factor):
                groups.append(rem[i : i + replication_factor])
            # A singleton tail clique would hold ZERO mirrors — the data loss
            # replication exists to prevent. Fold it into its neighbor.
            if len(groups) >= 2 and len(groups[-1]) == 1:
                groups[-2].extend(groups.pop())
    return groups


def group_of(rank: int, groups: Sequence[Sequence[int]]) -> list[int]:
    for g in groups:
        if rank in g:
            return list(g)
    raise ValueError(f"rank {rank} not in any replication group")


@dataclasses.dataclass
class ExchangePlan:
    """Shard routing for retrieval: per-rank send and receive lists.

    ``sends[r]`` = list of ``(dst_rank, shard_owner_rank)`` that rank ``r`` must send;
    ``recvs[r]`` = list of ``(src_rank, shard_owner_rank)`` that rank ``r`` will receive.
    """

    sends: dict[int, list[tuple[int, int]]]
    recvs: dict[int, list[tuple[int, int]]]

    @staticmethod
    def build(
        wanted: dict[int, int],
        holders: dict[int, set[int]],
        avoid: frozenset[int] | set[int] = frozenset(),
    ) -> "ExchangePlan":
        """``wanted[rank] = owner_rank_of_needed_shard`` (skip ranks that hold their own);
        ``holders[rank] = set of owner-ranks whose shards rank holds locally``.

        Holder choice is deterministic and load-balanced: among candidates, pick the one
        with the fewest sends assigned so far, ties broken by rank order (the reference
        picks a random live holder, ``strategies.py:142-188``; deterministic choice keeps
        every rank's independently-computed plan identical without a broadcast).

        ``avoid``: ranks the health-vector policy holds degraded — they are chosen as
        senders only when no healthy holder exists (recovery should never queue behind
        the slowest NIC in the clique; BASELINE target 5).
        """
        sends: dict[int, list[tuple[int, int]]] = {}
        recvs: dict[int, list[tuple[int, int]]] = {}
        load: dict[int, int] = {}
        for dst in sorted(wanted):
            owner = wanted[dst]
            candidates = sorted(r for r, held in holders.items() if owner in held and r != dst)
            if not candidates:
                raise CheckpointError(
                    f"no live holder for shard of rank {owner} needed by rank {dst}"
                )
            src = min(candidates, key=lambda r: (r in avoid, load.get(r, 0), r))
            load[src] = load.get(src, 0) + 1
            sends.setdefault(src, []).append((dst, owner))
            recvs.setdefault(dst, []).append((src, owner))
        return ExchangePlan(sends=sends, recvs=recvs)


@dataclasses.dataclass
class PendingRound:
    """A minted-but-not-yet-run replication round (tag agreement done on the
    caller thread, transfer deferred — see ``start_round``). Inert when the
    strategy is disabled or the clique has no peers. ``iteration`` is stamped
    by the caller when the payload must self-describe (erasure block
    artifacts carry it); the mirror strategy ignores it."""

    tag: Optional[str]
    peers: list[int]
    round: int
    iteration: int = -1

    @property
    def active(self) -> bool:
        return self.tag is not None and bool(self.peers)


class CliqueReplicationStrategy:
    """Mirror each rank's shard across its clique; route shards back after rank loss.

    ``replicate(blob)`` returns ``{owner_rank: blob}`` for every clique member — the
    caller persists all of them locally (reference ``strategies.py:87-140``'s hollow
    all-gather + batched tensor all-gather, collapsed into whole-shard exchange over
    host TCP links).

    ``retrieve(wanted, available, payload_fn)`` executes a global exchange plan so every
    rank ends up holding the shard it needs (reference ``strategies.py:142-188``).
    """

    def __init__(
        self,
        comm: Optional[StoreComm],
        exchange: PeerExchange,
        replication_jump: int = 1,
        replication_factor: int = 2,
    ):
        self.comm = comm
        self.exchange = exchange
        self.jump = replication_jump
        self.factor = replication_factor
        #: Exchange tags embed this counter; every member of a group must agree
        #: on it (same number of replicate/retrieve/remirror calls), or peers
        #: wait on tags that are never sent. ``rebuild`` resets it so survivors
        #: and freshly constructed joiners re-align at 0.
        self._round = 0
        #: Peers that exhausted their transfer retries in the LAST replicate
        #: round — that round saved with reduced redundancy instead of failing.
        #: Callers feed this into :meth:`retrieve`'s ``avoid`` set (the
        #: ``ExchangePlan`` deprioritizes degraded senders) and should treat a
        #: persistently non-empty set as a health signal.
        self.last_degraded: set[int] = set()
        if comm is not None:
            self._set_groups(comm.ranks)
        else:
            self.groups = None
            self.my_group = None

    def _set_groups(self, active_ranks: Sequence[int]) -> None:
        self.groups = group_sequence_for(active_ranks, self.jump, self.factor)
        self.my_group = group_of(self.comm.rank, self.groups)

    def rebuild(self, comm: StoreComm) -> None:
        """Recompute cliques after rank reassignment.

        Call collectively from every surviving rank with the NEW group's comm
        (the old group includes dead ranks, whose barriers would hang). The
        reference sidesteps this by fixing groups for the job's lifetime
        (``strategies.py:76-140``); a framework whose health policy *changes* the
        active set owns the rebuild. Follow with :meth:`remirror` so shards whose
        old mirrors died are covered again before the next failure.
        """
        self.comm = comm
        self._set_groups(comm.ranks)
        # Survivors carry arbitrary _round values; joiners constructed fresh sit
        # at 0. Tags must agree across the new group, and rebuild is the one
        # moment every member is provably at the same point — re-align here.
        self._round = 0
        self.last_degraded = set()  # the old world's degradations are history
        # Tags restart at 0, so frames from abandoned pre-rebuild rounds (a peer
        # died mid-replicate; nobody will ever recv them) must not linger: they
        # pin multi-GB payloads in the exchange inbox forever AND would be
        # mis-delivered to the new world's round 0 under the reused tag.
        for prefix in ("repl/", "retr/", "remir/"):
            self.exchange.purge(prefix)
        log.info(
            f"replication cliques rebuilt over {comm.ranks}: my_group={self.my_group}"
        )

    def remirror(
        self,
        my_iteration: Optional[int],
        get_blob,
        held: frozenset[tuple[int, int]] | set[tuple[int, int]] = frozenset(),
        get_path=None,
    ) -> dict[int, tuple[int, bytes]]:
        """Re-mirror shards within the (rebuilt) cliques. Collective over the comm.

        ``my_iteration``: newest iteration of this rank's OWN shard on local disk
        (``None`` when it has none — a fresh joiner participates as receiver
        only). ``get_blob(owner, iteration)`` loads a locally-held shard's bytes;
        ``get_path(owner, iteration)`` (optional) names its on-disk file, letting
        sends splice file→socket via ``sendfile`` with zero userspace copies.
        ``held``: the ``(owner, iteration)`` pairs already on this rank's disk —
        a peer that already holds a mirror is skipped (after a shrink, surviving
        clique pairs keep their existing multi-GB mirrors; only shards that lost
        redundancy move). Two passes:

        1. every active rank's OWN shard is mirrored to clique peers lacking it;
        2. mirrors whose OWNER left the active set (the departed rank's state —
           the copy the ``load_shard`` reshard path consumes) are re-spread from
           a deterministic primary holder to its clique, so the next failure
           can't destroy the sole surviving copy.

        Returns ``{owner_rank: (iteration, blob)}`` of mirrors received — the
        caller persists them. Unlike :meth:`replicate`, participation is
        asymmetric by design: after an upscale some members have nothing to send.
        """
        self._ensure_groups()
        rank = self.comm.rank
        gathered = self.comm.all_gather(
            (rank, my_iteration, sorted(held)), tag="remirror-meta"
        )
        have = {r: it for r, it, _ in gathered if it is not None}
        peer_held = {r: {tuple(p) for p in h} for r, _, h in gathered}
        if not self.enabled:
            return {}
        tag = f"remir/{self._round}"
        self._round += 1
        received: dict[int, tuple[int, bytes]] = {}
        # Pass 1: own shards — sends fan out concurrently, file-spliced when the
        # caller names the on-disk path.
        if rank in have:
            targets = [
                peer
                for peer in self.my_group
                if peer != rank and (rank, have[rank]) not in peer_held[peer]
            ]
            if targets:
                _fan_out(self._shard_senders(
                    targets, f"{tag}/{rank}", rank, have[rank], get_blob, get_path
                ))
        for peer in self.my_group:
            if (
                peer != rank
                and peer in have
                and (peer, have[peer]) not in peer_held[rank]
            ):
                received[peer] = (have[peer], self.exchange.recv(peer, f"{tag}/{peer}"))
        # Pass 2: orphaned mirrors (owner no longer active). Every rank computes
        # the same plan from the gathered holdings; the lowest-ranked holder of
        # the newest copy re-spreads it within its own clique.
        active = set(self.comm.ranks)
        orphans: dict[int, int] = {}
        for _, _, h in gathered:
            for o, it in (tuple(p) for p in h):
                if o not in active:
                    orphans[o] = max(orphans.get(o, it), it)
        for owner in sorted(orphans):
            it = orphans[owner]
            holders = sorted(r for r in active if (owner, it) in peer_held[r])
            if not holders:
                continue
            primary = holders[0]
            grp = group_of(primary, self.groups)
            dsts = [d for d in grp if d != primary and (owner, it) not in peer_held[d]]
            if rank == primary:
                _fan_out(self._shard_senders(
                    dsts, f"{tag}/orph/{owner}", owner, it, get_blob, get_path
                ))
            elif rank in dsts:
                received[owner] = (
                    it,
                    self.exchange.recv(primary, f"{tag}/orph/{owner}"),
                )
        return received

    def _shard_senders(
        self, peers: Sequence[int], tag: str, owner: int, iteration: int,
        get_blob, get_path,
    ) -> list:
        """Per-peer send thunks for one locally-held shard: ``sendfile`` splices
        straight from disk when the caller names the path; otherwise the blob is
        loaded ONCE and shared across the fan-out."""
        if not peers:
            return []
        if get_path is not None:
            path = get_path(owner, iteration)
            return [
                (lambda p=peer: self.exchange.send_file(p, tag, path))
                for peer in peers
            ]
        blob = get_blob(owner, iteration)
        return [(lambda p=peer: self.exchange.send(p, tag, blob)) for peer in peers]

    @property
    def enabled(self) -> bool:
        return self.factor > 1

    #: Erasure subclass flips this: callers that must route block/section
    #: callbacks (the local manager's ladder) gate on it.
    coded = False

    def replicate(self, blob: bytes) -> dict[int, bytes]:
        """Exchange shard blobs within the clique. Returns {owner_rank: blob}."""
        self._ensure_groups()
        held = {self.comm.rank: blob}
        held.update(self.replicate_parts([blob]))
        return held

    def start_round(self) -> "PendingRound":
        """Mint a replication round WITHOUT moving bytes — the tag-agreement
        half of a round, split out so a background worker can run the
        transfer later while tags keep getting minted in save-call order on
        the caller thread (the same ordering contract as
        :meth:`start_stream`). Pair with :meth:`exchange_round`."""
        self._ensure_groups()
        if not self.enabled:
            return PendingRound(None, [], -1)
        tag = f"repl/{self._round}"
        rnd = self._round
        self._round += 1
        peers = [p for p in self.my_group if p != self.comm.rank]
        return PendingRound(tag, peers, rnd)

    def replicate_parts(self, parts: Sequence[Any]) -> dict[int, Any]:
        """Exchange this rank's shard (as its constituent buffers) within the
        clique; returns ``{peer_owner: received_payload}`` — this rank's own
        entry is NOT included (the caller already holds the parts).

        The streaming hot path: sends scatter-gather ``parts`` straight from the
        caller's buffers (no joined blob ever exists), fan out over a thread
        pool so a round costs ~one shard transfer regardless of clique size, and
        overlap with the receives draining concurrently on this thread. Received
        payloads are single receive buffers (`bytes`-like) ready for
        ``format.write_parts`` / ``deserialize_from_buffer``.

        **Degraded peers do not fail the save.** A peer whose send exhausted
        its retries, or whose mirror never arrived within the round deadline,
        is dropped from the returned map and recorded in :attr:`last_degraded`
        (one ``peer_degraded`` event each → ``tpu_replication_peer_degraded_total``):
        this round's shard simply has fewer mirrors — strictly better than
        aborting the checkpoint because one clique member's NIC blipped. All
        receive waits share ONE round deadline (``exchange.timeout``), so k
        degraded peers cost one timeout, not k.
        """
        return self.exchange_round(self.start_round(), parts)

    def exchange_round(
        self, pending: "PendingRound", parts: Sequence[Any]
    ) -> dict[int, Any]:
        """The transfer half of a replication round minted by
        :meth:`start_round` — same semantics as :meth:`replicate_parts`
        (symmetric clique exchange, degraded peers dropped not fatal), but
        runnable on a background thread after the foreground agreed the tag."""
        if not pending.active:
            return {}
        tag, rnd, peers = pending.tag, pending.round, pending.peers
        nbytes = sum(memoryview(p).cast("B").nbytes for p in parts)
        received: dict[int, Any] = {}
        degraded: set[int] = set()
        deadline = time.monotonic() + self.exchange.timeout
        with span(
            "checkpoint", "ckpt.replicate.fanout",
            round=rnd, peers=len(peers), bytes=nbytes,
        ):
            with cf.ThreadPoolExecutor(max_workers=len(peers)) as pool:
                futs = {
                    peer: pool.submit(self.exchange.send_parts, peer, tag, parts)
                    for peer in peers
                }
                for peer in peers:
                    try:
                        got = self.exchange.recv(
                            peer, tag,
                            timeout=max(0.05, deadline - time.monotonic()),
                        )
                        # Verify-on-receive: a checksum-failed mirror is a
                        # degraded peer, not a stored-then-trusted liability.
                        if _verify_received(got, peer, stage="replicate-recv"):
                            received[peer] = got
                        else:
                            degraded.add(peer)
                    except CheckpointError:
                        degraded.add(peer)
                for peer, f in futs.items():
                    try:
                        f.result()
                    except CheckpointError:
                        degraded.add(peer)
        self._mark_degraded(degraded, rnd)
        return received

    def _mark_degraded(self, degraded: set[int], rnd: int) -> None:
        self.last_degraded = set(degraded)
        for peer in sorted(degraded):
            log.warning(
                f"replication round {rnd}: peer {peer} degraded "
                f"(transfer retries exhausted); saving with reduced redundancy"
            )
            record_event(
                "checkpoint", "peer_degraded", peer=peer, round=rnd,
            )

    def start_stream(self, nbytes: int) -> "ReplicationStream":
        """Foreground half of a leaf-streaming replication round.

        Allocates the round tag (call ORDER is the cross-rank agreement — do
        this on the caller thread, in save order, before handing the stream to
        a background worker; concurrent background rounds then stay aligned
        across ranks because their tags were minted in matching order) and
        captures the clique fan-out. ``nbytes`` is the total container size,
        known from the leaf specs before any D2H byte lands. All transfer work
        happens on the returned :class:`ReplicationStream`; with replication
        disabled or no peers it is an inert no-op handle.
        """
        self._ensure_groups()
        rank = self.comm.rank
        if not self.enabled:
            return ReplicationStream(self, None, [], nbytes, -1)
        tag = f"repl/{self._round}"
        rnd = self._round
        self._round += 1
        peers = [p for p in self.my_group if p != rank]
        return ReplicationStream(self, tag, peers, nbytes, rnd)

    def _ensure_groups(self) -> None:
        """Hook for the lazy subclass; the eager strategy's groups always exist."""

    def retrieve(
        self,
        my_needed_owner: Optional[int],
        my_held_owners: set[int],
        get_blob,
        avoid: frozenset[int] | set[int] = frozenset(),
        get_path=None,
    ) -> Optional[bytes]:
        """Global shard routing after rank loss / reassignment.

        ``my_needed_owner``: owner-rank of the shard this rank needs but does not hold
        (``None`` if satisfied locally). ``my_held_owners``: owner-ranks of shards held
        locally. ``get_blob(owner)`` loads a held shard's bytes for sending;
        ``get_path(owner)`` (optional) names its on-disk file so sends splice
        file→socket via ``sendfile``. All ranks must call this collectively with
        the same ``avoid`` set (degraded ranks are deprioritized as senders).
        Returns the received blob, or ``None``.
        """
        self._ensure_groups()
        gathered = self.comm.all_gather(
            (self.comm.rank, my_needed_owner, sorted(my_held_owners)), tag="retrieve-meta"
        )
        wanted = {r: need for r, need, _ in gathered if need is not None}
        holders = {r: set(held) for r, _, held in gathered}
        if not wanted:
            return None
        plan = ExchangePlan.build(wanted, holders, avoid=avoid)
        tag = f"retr/{self._round}"
        self._round += 1
        sends = []
        for dst, owner in plan.sends.get(self.comm.rank, []):
            if get_path is not None:
                sends.append(
                    lambda d=dst, o=owner, p=get_path(owner): self.exchange.send_file(
                        d, f"{tag}/{o}", p
                    )
                )
            else:
                sends.append(
                    lambda d=dst, o=owner, b=get_blob(owner): self.exchange.send(
                        d, f"{tag}/{o}", b
                    )
                )
        _fan_out(sends)
        blob = None
        for src, owner in plan.recvs.get(self.comm.rank, []):
            got = self.exchange.recv(src, f"{tag}/{owner}")
            # Verify-on-receive (per-leaf CRCs + container digest): a bad
            # frame is treated like a degraded peer — the sender is
            # deprioritized for future exchange plans and the caller's
            # recovery ladder falls back instead of loading corruption.
            if _verify_received(got, src, stage="retrieve-recv"):
                blob = got
            else:
                self.last_degraded.add(src)
        return blob

    def fetch_ranges(
        self, holder: int, request: dict, timeout: Optional[float] = None
    ) -> tuple[dict, list]:
        """Ranged read against one peer's locally-held container — the elastic
        reshard fetch: move only the byte ranges this rank newly owns, not the
        whole mirror. Point-to-point (no collective participation; the holder
        serves off its accept thread), per-range checksum-verified by the
        exchange. A failed holder is marked degraded (deprioritized for
        future plans) before the error propagates — the caller retries
        against the next replica holder."""
        self._ensure_groups()
        with span(
            "checkpoint", "reshard.fetch",
            holder=holder, owner=request.get("owner"),
            ranges=len(request.get("ranges") or []),
        ):
            try:
                return self.exchange.fetch_ranges(holder, request, timeout=timeout)
            except CheckpointError:
                self.last_degraded.add(holder)
                raise


class ReplicationStream:
    """One in-flight leaf-streaming replication round (see
    :meth:`CliqueReplicationStrategy.start_stream`).

    ``open()`` dials every clique peer and sends the bulk preambles;
    ``send_chunk(view)`` fans one resolved leaf out to all peers concurrently
    (per-chunk thread fan-out keeps per-peer byte order while overlapping the
    wires); ``finish()`` closes the sends, drains the matching receives, and
    returns ``{peer_owner: payload}`` exactly like ``replicate_parts``. The
    whole object lives on the background save thread after ``start_stream``
    minted its tag on the caller thread.
    """

    def __init__(self, strategy, tag, peers: Sequence[int], nbytes: int, rnd: int):
        self._strategy = strategy
        self.tag = tag
        self.peers = list(peers)
        self.nbytes = nbytes
        self._round = rnd
        self._streams: list = []
        self._pool = None
        self._span = None

    @property
    def active(self) -> bool:
        return bool(self.peers) and self.tag is not None

    def open(self) -> "ReplicationStream":
        if not self.active:
            return self
        self._span = span(
            "checkpoint", "ckpt.replicate.fanout",
            round=self._round, peers=len(self.peers), bytes=self.nbytes,
            streaming=True,
        )
        self._span.__enter__()
        try:
            ex = self._strategy.exchange
            self._streams = [
                ex.open_send_stream(p, self.tag, self.nbytes) for p in self.peers
            ]
            if len(self._streams) > 1:
                self._pool = cf.ThreadPoolExecutor(max_workers=len(self._streams))
        except BaseException as e:
            self._teardown(e)
            raise
        return self

    def send_chunk(self, view) -> None:
        if not self._streams:
            return
        try:
            if self._pool is None:
                self._streams[0].send_chunk(view)
            else:
                # One leaf, all peers at once; waiting per chunk preserves each
                # peer's byte order while the wires overlap.
                for f in [
                    self._pool.submit(s.send_chunk, view) for s in self._streams
                ]:
                    f.result()
        except BaseException as e:
            self._teardown(e)
            raise

    def finish(self) -> dict[int, Any]:
        """Complete sends, collect every peer's mirror (verify-on-receive: a
        checksum-failed mirror is dropped and its peer degraded, exactly like
        ``replicate_parts``); returns {owner: payload}."""
        if not self.active:
            return {}
        received: dict[int, Any] = {}
        dropped: set[int] = set()
        try:
            for s in self._streams:
                s.close()
            for peer in self.peers:
                got = self._strategy.exchange.recv(peer, self.tag)
                if _verify_received(got, peer, stage="stream-recv"):
                    received[peer] = got
                else:
                    dropped.add(peer)
        except BaseException as e:
            self._teardown(e)
            raise
        if dropped:
            self._strategy._mark_degraded(dropped, self._round)
        self._teardown(None)
        return received

    def abort(self) -> None:
        self._teardown(RuntimeError("replication stream aborted"))

    def _teardown(self, exc) -> None:
        for s in self._streams:
            try:
                s.abort()
            except Exception:
                pass
        self._streams = []
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        if self._span is not None:
            sp, self._span = self._span, None
            if exc is None:
                sp.__exit__(None, None, None)
            else:
                sp.__exit__(type(exc), exc, None)


class LazyCliqueReplicationStrategy(CliqueReplicationStrategy):
    """Clique construction deferred to first use (reference parity:
    ``checkpointing/local/replication/strategies.py:190-``).

    Matters when world membership is not final at strategy-construction time —
    spares still promoting, rank assignment still settling after a restart round.
    ``comm_fn()`` is invoked once, at the first ``replicate``/``retrieve``/
    ``remirror``, and must return the group comm for the world that exists THEN.
    ``rebuild`` still works afterwards, exactly as on the eager strategy.
    """

    def __init__(
        self,
        comm_fn,
        exchange: PeerExchange,
        replication_jump: int = 1,
        replication_factor: int = 2,
    ):
        super().__init__(None, exchange, replication_jump, replication_factor)
        self._comm_fn = comm_fn

    def _ensure_groups(self) -> None:
        if self.comm is None:
            self.comm = self._comm_fn()
            self._set_groups(self.comm.ranks)
            log.info(
                f"lazy replication bound to world {self.comm.ranks}: "
                f"my_group={self.my_group}"
            )
