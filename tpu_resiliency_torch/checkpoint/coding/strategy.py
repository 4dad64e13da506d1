"""Erasure-coded clique replication: parity blocks instead of full mirrors.

``CliqueReplicationStrategy`` moves ``(n-1)×`` the payload per save (every
clique peer gets a whole mirror). This strategy moves ``~(1 + (m-1)/k)×``:
the shard is RS-coded into ``k`` data + ``m`` parity blocks
(``checkpoint/coding/rs.py``; ``k = clique_size - m``, default ``m=1`` so
``k = n-1``), each clique member is assigned the coded block matching its
position in the sorted clique, and the owner ships every member its one
``payload/k``-sized block — the owner's own assigned block is implicit in the
full container it keeps locally. Losing the owner leaves ``k+m-1 ≥ k``
surviving blocks, so the shard reconstructs **byte-identically** from any
``k`` of them; the reconstruct rung slots into the recovery ladder between
"local verify" and "peer retrieve" (a clique that also holds real mirrors —
mixed-version peers, previously recovered containers — still serves them in
the peer-retrieve rung, which is also the degrade path when a corrupt parity
block breaks reconstruction: the container-level verify after reassembly
makes a false-positive reconstruction structurally impossible).

Block artifacts persist on peer disks as self-describing containers
(``TPUECB01 | header_len | header pickle | block bytes``; the header carries
the code geometry, the block CRC, and the source container's digest so
mismatched generations can never be mixed into one reconstruction).

Surface parity: ``replicate`` / ``replicate_parts`` / ``exchange_round`` /
``remirror`` / ``retrieve`` / ``rebuild`` keep the
:class:`~tpu_resiliency_torch.checkpoint.replication.CliqueReplicationStrategy`
contract — payloads returned to the caller are simply block artifacts
instead of mirrors, and the local manager routes them by magic.
"""

from __future__ import annotations

import pickle
import struct
import time
from typing import Any, Optional, Sequence

import numpy as np

from tpu_resiliency_torch.checkpoint import format as ckpt_format
from tpu_resiliency_torch.checkpoint.coding import delta as ckpt_delta
from tpu_resiliency_torch.checkpoint.coding import rs
from tpu_resiliency_torch.checkpoint.replication import (
    CliqueReplicationStrategy,
    ExchangePlan,
    PendingRound,
    _fan_out,
    _verify_received,
    group_of,
)
from tpu_resiliency_torch.exceptions import CheckpointError
from tpu_resiliency_torch.utils.events import record as record_event
from tpu_resiliency_torch.utils.logging import get_logger
from tpu_resiliency_torch.utils.tracing import span

log = get_logger(__name__)

ECB_MAGIC = b"TPUECB01"
ECB_SCHEMA = "tpu-ecblk-1"
_LEN = struct.Struct("<Q")


# -- block artifact codec ------------------------------------------------------


def build_block_parts(
    owner: int,
    iteration: int,
    k: int,
    m: int,
    index: int,
    block,
    orig_len: int,
    container_crc: int,
    payload_kind: str = "container",
    base_iteration: Optional[int] = None,
) -> list:
    """One block artifact as send-ready parts (header bytes + block views —
    no join; concatenated they ARE the on-disk artifact).

    ``block`` is one bytes-like (parity) or a sequence of views — a data
    block served as verbatim byte ranges of the streamed payload, so the
    systematic half of the code never pays a backing copy. ``payload_kind``
    records what the coded payload IS (``container`` or a ``delta`` frame,
    with ``base_iteration`` as the chain hint) so reconstruction runs the
    right verification; absent in pre-delta artifacts, which read as
    ``container``."""
    pieces = list(block) if isinstance(block, (list, tuple)) else [block]
    crc = 0
    block_len = 0
    for p in pieces:
        crc = ckpt_format.crc32c(p, crc)
        block_len += memoryview(p).nbytes
    header = {
        "schema": ECB_SCHEMA,
        "owner": int(owner),
        "iteration": int(iteration),
        "k": int(k),
        "m": int(m),
        "index": int(index),
        "block_len": int(block_len),
        "orig_len": int(orig_len),
        "algo": ckpt_format.CRC_ALGO,
        "crc": crc,
        "container_crc": int(container_crc),
        "payload": str(payload_kind),
    }
    if base_iteration is not None:
        header["base_iteration"] = int(base_iteration)
    hb = pickle.dumps(header, protocol=pickle.HIGHEST_PROTOCOL)
    return [ECB_MAGIC + _LEN.pack(len(hb)) + hb, *pieces]


def is_block(buf) -> bool:
    mv = memoryview(buf)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    return mv.nbytes >= len(ECB_MAGIC) and bytes(mv[: len(ECB_MAGIC)]) == ECB_MAGIC


def parse_block(buf, source: str = "ecblk") -> tuple[dict, memoryview]:
    """``(header, block_view)`` with structural + CRC validation; raises
    :class:`CheckpointError` on any damage — a corrupt parity block must be
    REJECTED here, long before it could poison a reconstruction."""
    mv = memoryview(buf)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    head = len(ECB_MAGIC) + _LEN.size
    if mv.nbytes < head or bytes(mv[: len(ECB_MAGIC)]) != ECB_MAGIC:
        raise CheckpointError(f"{source}: not an erasure block artifact")
    (hlen,) = _LEN.unpack(mv[len(ECB_MAGIC) : head])
    if head + hlen > mv.nbytes:
        raise CheckpointError(f"{source}: truncated erasure block header")
    try:
        header = pickle.loads(mv[head : head + hlen])
        k, m, index = int(header["k"]), int(header["m"]), int(header["index"])
        block_len = int(header["block_len"])
    except Exception as e:
        raise CheckpointError(
            f"{source}: corrupt erasure block header ({e!r})"
        ) from e
    if header.get("schema") != ECB_SCHEMA or not 0 <= index < k + m:
        raise CheckpointError(f"{source}: malformed erasure block header")
    block = mv[head + hlen : head + hlen + block_len]
    if block.nbytes != block_len:
        raise CheckpointError(
            f"{source}: truncated erasure block ({block.nbytes} of "
            f"{block_len} bytes)"
        )
    if header.get("algo") == ckpt_format.CRC_ALGO and ckpt_format.crc32c(
        block
    ) != header.get("crc"):
        raise CheckpointError(
            f"{source}: erasure block checksum mismatch (index {index})"
        )
    return header, block


def block_identity(buf) -> tuple[int, int, int, int, int]:
    """``(iteration, owner, index, k, m)`` off an artifact's header — the
    local manager's filename router."""
    header, _ = parse_block(buf)
    return (
        header["iteration"], header["owner"], header["index"], header["k"],
        header["m"],
    )


def reconstruct_container(
    artifacts: Sequence[Any], source: str = "parity"
) -> bytes:
    """Reassemble a container from block artifacts (any ``k`` of one
    generation). Every artifact is CRC-validated, the geometry and the source
    container's digest must agree across artifacts, and the reassembled bytes
    are container-verified before they are returned — the three fences that
    make a false-positive reconstruction impossible."""
    parsed = []
    for a in artifacts:
        parsed.append(parse_block(a, source=source))
    if not parsed:
        raise CheckpointError(f"{source}: no erasure blocks to reconstruct from")
    ref = parsed[0][0]
    k, m = ref["k"], ref["m"]
    have: dict[int, np.ndarray] = {}
    for header, block in parsed:
        if (
            header["k"] != k
            or header["m"] != m
            or header["orig_len"] != ref["orig_len"]
            or header["container_crc"] != ref["container_crc"]
            or header["iteration"] != ref["iteration"]
            or header["owner"] != ref["owner"]
        ):
            raise CheckpointError(
                f"{source}: erasure blocks from mismatched generations "
                f"(owner {ref['owner']} iter {ref['iteration']})"
            )
        have[header["index"]] = np.frombuffer(block, dtype=np.uint8)
    data = rs.reconstruct(k, m, have, want=list(range(k)))
    blob = bytes(rs.join([data[i] for i in range(k)], ref["orig_len"]))
    if ref.get("payload", "container") == "delta" or ckpt_delta.is_delta(blob):
        # A delta frame has no container trailer: its generation identity is
        # a CRC over the whole frame, and verification here is structural
        # (parse) + that digest. The chained base validation — frame applies
        # only to the exact base container it names — happens at apply time
        # in the local manager; a missing/stale base degrades to the agreed
        # fallback ladder, never to a wrong container.
        if ckpt_format.crc32c(blob) != ref["container_crc"]:
            raise CheckpointError(
                f"{source}: reconstructed delta frame digest mismatch "
                f"(owner {ref['owner']} iter {ref['iteration']})"
            )
        try:
            ckpt_delta.parse_delta(blob, source=f"{source}-reconstruct")
        except CheckpointError as e:
            raise CheckpointError(
                f"{source}: reconstructed delta frame failed validation ({e})"
            ) from e
        return blob
    try:
        ok = ckpt_format.verify_container(
            blob, source=f"{source}(owner={ref['owner']})"
        )
    except CheckpointError as e:
        raise CheckpointError(
            f"{source}: reconstructed container failed verification ({e})"
        ) from e
    if not ok:
        # Unverifiable (v1 container / foreign algo): fall back on the digest
        # the artifacts recorded — the last 4 trailer bytes are the container
        # digest in every signed format version.
        if len(blob) < 4 or struct.unpack("<I", blob[-4:])[0] != ref[
            "container_crc"
        ]:
            raise CheckpointError(
                f"{source}: reconstructed container digest mismatch"
            )
    return blob


def _split_parts(parts: Sequence[Any], k: int) -> tuple[list[np.ndarray], int]:
    """rs.split over a multi-part payload: one padded backing fill, block
    views over it. Superseded on the hot path by :func:`encode_payload`
    (which never materializes the payload-sized backing copy); kept as the
    reference implementation the byte-identity tests compare against."""
    views = []
    total = 0
    for p in parts:
        mv = memoryview(p)
        if mv.ndim != 1 or mv.itemsize != 1:
            mv = mv.cast("B")
        views.append(mv)
        total += mv.nbytes
    block_len = max(1, (total + k - 1) // k)
    backing = np.zeros(block_len * k, dtype=np.uint8)
    pos = 0
    for mv in views:
        backing[pos : pos + mv.nbytes] = np.frombuffer(mv, dtype=np.uint8)
        pos += mv.nbytes
    return [backing[i * block_len : (i + 1) * block_len] for i in range(k)], total


def encode_payload(
    parts: Sequence[Any], k: int, m: int, encoder=None
) -> tuple[list, int, int, list[np.ndarray]]:
    """Streaming split+encode over a multi-part payload: ``(views, total,
    block_len, parity)``.

    Data block ``i`` is the verbatim byte range ``[i·block_len,
    (i+1)·block_len)`` of the concatenated views (tail zero-padded) —
    materialize it as views with :func:`data_block_views`; only the parity
    blocks are new allocations (``m·block_len``, not ``k+m``). When
    ``encoder`` is a pre-fed :class:`rs.StreamingEncoder` whose geometry and
    byte count match, its parity is reused — the pipelined save feeds it
    during the Checksummer pass, making the encode here free; any mismatch
    (group moved between mint and exchange) falls back to a fresh streaming
    pass."""
    views = []
    total = 0
    for p in parts:
        mv = memoryview(p)
        if mv.ndim != 1 or mv.itemsize != 1:
            mv = mv.cast("B")
        views.append(mv)
        total += mv.nbytes
    if (
        encoder is not None
        and encoder.total == total
        and encoder.k == k
        and encoder.m == m
    ):
        return views, total, encoder.block_len, encoder.parity_blocks()
    enc = rs.StreamingEncoder(total, k, m)
    for mv in views:
        enc.update(mv)
    return views, total, enc.block_len, enc.parity_blocks()


def data_block_views(
    views: Sequence[Any], total: int, block_len: int, index: int
) -> list:
    """Data block ``index`` as a list of views over the payload parts, plus
    a zeros tail on the final block — the <k-byte pad ``rs.split`` would
    have charged a payload-sized backing copy for."""
    start = index * block_len
    end = min(start + block_len, total)
    out = []
    pos = 0
    for mv in views:
        nxt = pos + mv.nbytes
        if nxt > start and pos < end:
            out.append(mv[max(start - pos, 0) : min(end - pos, mv.nbytes)])
        pos = nxt
    pad = block_len - max(0, end - start)
    if pad > 0:
        out.append(np.zeros(pad, dtype=np.uint8))
    return out


def coded_block(
    views: Sequence[Any],
    total: int,
    block_len: int,
    parity: Sequence[np.ndarray],
    k: int,
    index: int,
):
    """Coded block ``index``: a data-block view list below ``k``, a parity
    ndarray at/above — the shape :func:`build_block_parts` accepts either of."""
    if index < k:
        return data_block_views(views, total, block_len, index)
    return parity[index - k]


def _container_digest(parts: Sequence[Any]) -> int:
    """The container's trailer digest = the last 4 bytes of the serialized
    container (both trailer versions end with it) — the generation identity
    stamped into every block artifact."""
    tail = memoryview(parts[-1])
    if tail.ndim != 1 or tail.itemsize != 1:
        tail = tail.cast("B")
    if tail.nbytes < 4:
        raise CheckpointError("erasure: container trailer part too short")
    return struct.unpack("<I", tail[-4:])[0]


def _payload_meta(parts: Sequence[Any]) -> dict:
    """Digest + kind + chain hint for the payload a round is about to code:
    ``{digest, payload_kind[, base_iteration]}``. Containers keep the trailer
    digest identity; a delta frame (single-part, by construction of the save
    path) is identified by a CRC over the whole frame since it carries no
    trailer digest of its own."""
    if len(parts) == 1 and ckpt_delta.is_delta(parts[0]):
        header, _ = ckpt_delta.parse_delta(parts[0], source="parity-encode")
        crc = ckpt_format.crc32c(parts[0])
        return {
            "digest": crc,
            "payload_kind": "delta",
            "base_iteration": int(header["base_iteration"]),
        }
    return {"digest": _container_digest(parts), "payload_kind": "container"}


# -- the strategy --------------------------------------------------------------


class ErasureReplicationStrategy(CliqueReplicationStrategy):
    """k-of-n replication over the existing clique machinery.

    ``parity`` (default 1) is ``m``; ``k`` adapts per clique as
    ``len(clique) - m`` (a remainder-merged clique simply gets a wider
    stripe). ``replication_factor`` keeps its meaning — clique width — and
    must exceed ``parity`` so at least one data block exists. Tolerance:
    the owner plus ``m-1`` peers may be lost before the shard is
    unrecoverable from blocks alone (full mirrors held by mixed-version
    peers extend that, and the retrieve rung uses them automatically).
    """

    coded = True

    def __init__(
        self,
        comm,
        exchange,
        replication_jump: int = 1,
        replication_factor: int = 2,
        parity: int = 1,
    ):
        if parity < 1:
            raise CheckpointError("erasure: parity must be >= 1")
        if replication_factor <= parity:
            raise CheckpointError(
                f"erasure: replication_factor ({replication_factor}) must "
                f"exceed parity ({parity}) — at least one data block"
            )
        self.parity = int(parity)
        super().__init__(comm, exchange, replication_jump, replication_factor)

    # -- geometry ----------------------------------------------------------

    def _code_geometry(self, group: Sequence[int]) -> tuple[int, int]:
        n = len(group)
        m = min(self.parity, n - 1) if n > 1 else 0
        return max(1, n - m), m

    def _position(self, rank: int, group: Sequence[int]) -> int:
        return sorted(group).index(rank)

    # -- replicate ---------------------------------------------------------

    def start_encode(self, pending: PendingRound, total: int):
        """A :class:`rs.StreamingEncoder` sized for this round's payload, or
        ``None`` when the round is inert. The pipelined save feeds it chunk
        by chunk alongside the Checksummer so the parity pass of
        :meth:`exchange_round` is already done when the worker gets there."""
        if not pending.active:
            return None
        group = sorted([self.comm.rank, *pending.peers])
        k, m = self._code_geometry(group)
        return rs.StreamingEncoder(total, k, m)

    def exchange_round(
        self, pending: PendingRound, parts: Sequence[Any], encoder=None
    ) -> dict[int, Any]:
        """Erasure round: encode this rank's payload (container or delta
        frame) into coded blocks, ship each peer its positionally-assigned
        block, receive each peer's assigned block of THEIR payload. Returned
        payloads are block artifacts ``{owner: artifact}`` — the caller
        persists them like mirrors (the magic routes the filename).
        Degraded-peer semantics match the mirror strategy exactly.

        Data blocks go on the wire as views over ``parts`` (systematic code,
        no backing copy); ``encoder``, when pre-fed by the save pipeline,
        makes the parity pass free here."""
        if not pending.active:
            return {}
        rank = self.comm.rank
        group = sorted([rank, *pending.peers])
        k, m = self._code_geometry(group)
        with span(
            "checkpoint", "ckpt.parity.encode",
            round=pending.round, k=k, m=m,
        ):
            views, orig_len, block_len, parity = encode_payload(
                parts, k, m, encoder=encoder
            )
            meta = _payload_meta(parts)
            digest = meta.pop("digest")
        sent = 0
        received: dict[int, Any] = {}
        degraded: set[int] = set()
        deadline = time.monotonic() + self.exchange.timeout
        import concurrent.futures as cf

        with span(
            "checkpoint", "ckpt.replicate.fanout",
            round=pending.round, peers=len(pending.peers),
            bytes=len(pending.peers) * block_len, erasure=True,
        ):
            with cf.ThreadPoolExecutor(max_workers=len(pending.peers)) as pool:
                futs = {}
                for peer in pending.peers:
                    idx = self._position(peer, group)
                    art = build_block_parts(
                        rank, pending.iteration, k, m, idx,
                        coded_block(views, orig_len, block_len, parity, k, idx),
                        orig_len, digest, **meta,
                    )
                    sent += sum(memoryview(p).nbytes for p in art)
                    futs[peer] = pool.submit(
                        self.exchange.send_parts, peer, pending.tag, art
                    )
                for peer in pending.peers:
                    try:
                        got = self.exchange.recv(
                            peer, pending.tag,
                            timeout=max(0.05, deadline - time.monotonic()),
                        )
                        parse_block(got, source=f"replicate<-rank{peer}")
                        received[peer] = got
                    except CheckpointError as e:
                        log.warning(
                            f"erasure replicate round {pending.round}: "
                            f"dropping peer {peer} ({e})"
                        )
                        record_event(
                            "checkpoint", "ckpt_integrity_failure",
                            stage="parity-recv", src=peer, error=repr(e),
                        )
                        degraded.add(peer)
                for peer, f in futs.items():
                    try:
                        f.result()
                    except CheckpointError:
                        degraded.add(peer)
        self._mark_degraded(degraded, pending.round)
        record_event(
            "checkpoint", "ckpt_parity",
            k=k, m=m, round=pending.round, block_bytes=block_len,
            sent_bytes=sent, sent_blocks=len(pending.peers),
            received=len(received), payload_bytes=orig_len,
        )
        return received

    # -- retrieve (the ladder's reconstruct + peer-retrieve rungs) ---------

    def retrieve(
        self,
        my_needed_owner: Optional[int],
        my_held_owners: set[int],
        get_blob,
        avoid: frozenset[int] | set[int] = frozenset(),
        get_path=None,
        my_held_blocks: frozenset | set = frozenset(),
        get_block=None,
    ) -> Optional[bytes]:
        """Collective shard recovery, erasure-aware. Two agreed sub-phases:

        1. **reconstruct-from-parity**: ranks holding blocks of a needed
           owner's shard send them (k per needy rank, data blocks preferred,
           deterministic holder choice); the needy rank reconstructs and
           VERIFIES. 2. **peer retrieve**: a second agreement round gathers
           who is still unsatisfied (no blocks, or reconstruction failed —
           e.g. a corrupt parity block) and runs the classic whole-mirror
           exchange over ranks that hold real containers. Only if both rungs
           fail does the caller's ladder fall back an iteration.

        ``my_held_blocks``: this rank's ``(owner, index, k, m)`` artifact
        inventory for the iteration; ``get_block(owner, index)`` loads one
        artifact's bytes.
        """
        self._ensure_groups()
        rank = self.comm.rank
        gathered = self.comm.all_gather(
            (rank, my_needed_owner, sorted(my_held_owners),
             sorted(tuple(b) for b in my_held_blocks)),
            tag="retrieve-meta",
        )
        wanted = {r: need for r, need, _, _ in gathered if need is not None}
        holders = {r: set(held) for r, _, held, _ in gathered}
        #: owner -> index -> sorted holder ranks
        block_holders: dict[int, dict[int, list[int]]] = {}
        geometry: dict[int, tuple[int, int]] = {}
        for r, _, _, blks in gathered:
            for owner, index, bk, bm in (tuple(b) for b in blks):
                block_holders.setdefault(owner, {}).setdefault(index, []).append(r)
                geometry[owner] = (bk, bm)
        if not wanted:
            return None
        tag = f"retr/{self._round}"
        self._round += 1
        # Phase 1 plan: per needy rank, the k chosen (index, src) pairs —
        # identical on every rank (sorted inputs, deterministic choice).
        plan_sends: dict[int, list[tuple[int, int, int]]] = {}
        recon_for: dict[int, list[tuple[int, int]]] = {}
        load: dict[int, int] = {}
        for dst in sorted(wanted):
            owner = wanted[dst]
            idx_holders = block_holders.get(owner, {})
            if owner not in geometry:
                continue
            k, m = geometry[owner]
            usable = {
                i: sorted(h for h in hs if h != dst)
                for i, hs in idx_holders.items()
            }
            usable = {i: hs for i, hs in usable.items() if hs}
            mine = {i for i, hs in idx_holders.items() if dst in hs}
            needed_n = max(0, k - len(mine))
            candidates = [i for i in sorted(
                usable, key=lambda i: (i >= k, i)) if i not in mine]
            if len(mine) + len(candidates) < k:
                continue  # not reconstructible from blocks; phase 2 owns it
            picks: list[tuple[int, int]] = []
            for i in candidates[:needed_n]:
                src = min(
                    usable[i], key=lambda r: (r in avoid, load.get(r, 0), r)
                )
                load[src] = load.get(src, 0) + 1
                picks.append((i, src))
                plan_sends.setdefault(src, []).append((dst, owner, i))
            recon_for[dst] = picks
        sends = []
        for dst, owner, index in plan_sends.get(rank, []):
            sends.append(
                lambda d=dst, o=owner, i=index: self.exchange.send(
                    d, f"{tag}/b/{o}/{i}", get_block(o, i)
                )
            )
        _fan_out(sends)
        blob: Optional[bytes] = None
        if rank in recon_for and my_needed_owner is not None:
            owner = my_needed_owner
            arts = []
            for index, src in recon_for[rank]:
                arts.append(self.exchange.recv(src, f"{tag}/b/{owner}/{index}"))
            for owner_i, index, bk, bm in (
                tuple(b) for b in sorted(my_held_blocks)
            ):
                if owner_i == owner:
                    arts.append(get_block(owner, index))
            try:
                with span("checkpoint", "ckpt.parity.reconstruct", owner=owner):
                    blob = reconstruct_container(
                        arts, source=f"reconstruct(owner={owner})"
                    )
                record_event(
                    "checkpoint", "ckpt_parity_reconstruct",
                    owner=owner, outcome="ok", blocks=len(arts),
                    bytes=len(blob),
                )
            except CheckpointError as e:
                log.warning(
                    f"rank {rank}: parity reconstruction of owner {owner} "
                    f"failed ({e}); degrading to peer retrieve"
                )
                record_event(
                    "checkpoint", "ckpt_parity_reconstruct",
                    owner=owner, outcome="failed", blocks=len(arts),
                    error=repr(e),
                )
                blob = None
        # Phase 2: who is STILL unsatisfied (reconstruction failed or no
        # blocks)? Classic mirror exchange over real container holders.
        still_needed = my_needed_owner if blob is None else None
        gathered2 = self.comm.all_gather((rank, still_needed), tag="retrieve-resid")
        wanted2 = {r: need for r, need in gathered2 if need is not None}
        if wanted2:
            plan = ExchangePlan.build(wanted2, holders, avoid=avoid)
            sends = []
            for dst, owner in plan.sends.get(rank, []):
                if get_path is not None:
                    sends.append(
                        lambda d=dst, o=owner, p=get_path(owner):
                        self.exchange.send_file(d, f"{tag}/m/{o}", p)
                    )
                else:
                    sends.append(
                        lambda d=dst, o=owner, b=get_blob(owner):
                        self.exchange.send(d, f"{tag}/m/{o}", b)
                    )
            _fan_out(sends)
            for src, owner in plan.recvs.get(rank, []):
                got = self.exchange.recv(src, f"{tag}/m/{owner}")
                if _verify_received(got, src, stage="retrieve-recv"):
                    blob = got
                else:
                    self.last_degraded.add(src)
        return blob

    # -- remirror ----------------------------------------------------------

    def remirror(
        self,
        my_iteration: Optional[int],
        get_blob,
        held: frozenset | set = frozenset(),
        get_path=None,
        held_blocks: frozenset | set = frozenset(),
        get_block=None,
    ) -> dict[int, tuple[int, Any]]:
        """Re-establish block redundancy after a clique rebuild. Collective.

        Pass 1: every active rank re-encodes its own newest shard and ships
        clique peers the assigned blocks they lack. Pass 2: orphaned owners
        (departed ranks) — when a real container survives somewhere, its
        lowest-ranked holder re-encodes and spreads blocks within its own
        clique; when only blocks survive (≥ k of one generation), they are
        routed to the lowest-ranked active holder, which reconstructs and
        returns the container for persistence (its next remirror spreads
        blocks again). Returns ``{owner: (iteration, artifact-or-container)}``
        for the caller to persist."""
        self._ensure_groups()
        rank = self.comm.rank
        gathered = self.comm.all_gather(
            (rank, my_iteration, sorted(held),
             sorted(tuple(b) for b in held_blocks)),
            tag="remirror-meta",
        )
        have = {r: it for r, it, _, _ in gathered if it is not None}
        peer_held = {r: {tuple(p) for p in h} for r, _, h, _ in gathered}
        #: rank -> {(owner, iteration, index, k, m)}
        peer_blocks = {r: {tuple(b) for b in blks} for r, _, _, blks in gathered}
        if not self.enabled:
            return {}
        tag = f"remir/{self._round}"
        self._round += 1
        received: dict[int, tuple[int, Any]] = {}
        group = sorted(self.my_group)
        k, m = self._code_geometry(group)
        # Pass 1: own shards → assigned blocks to clique peers lacking them.
        if rank in have:
            it = have[rank]
            targets = [
                peer for peer in group
                if peer != rank and not any(
                    b[0] == rank and b[1] == it and b[2] == self._position(peer, group)
                    for b in peer_blocks.get(peer, ())
                )
            ]
            if targets:
                parts = [get_blob(rank, it)]
                views, orig_len, block_len, parity = encode_payload(parts, k, m)
                meta = _payload_meta(parts)
                digest = meta.pop("digest")
                _fan_out([
                    (lambda p=peer, i=self._position(peer, group):
                     self.exchange.send_parts(
                         p, f"{tag}/{rank}",
                         build_block_parts(
                             rank, it, k, m, i,
                             coded_block(views, orig_len, block_len, parity,
                                         k, i),
                             orig_len, digest, **meta)))
                    for peer in targets
                ])
        for peer in group:
            if peer == rank or peer not in have:
                continue
            it = have[peer]
            mine = self._position(rank, sorted(group))
            if any(
                b[0] == peer and b[1] == it and b[2] == mine
                for b in peer_blocks.get(rank, ())
            ):
                continue
            received[peer] = (it, self.exchange.recv(peer, f"{tag}/{peer}"))
        # Pass 2: orphaned owners.
        active = set(self.comm.ranks)
        orphans: dict[int, int] = {}
        for r, _, h, blks in gathered:
            for o, it in (tuple(p) for p in h):
                if o not in active:
                    orphans[o] = max(orphans.get(o, it), it)
            for o, it, _, _, _ in (tuple(b) for b in blks):
                if o not in active:
                    orphans[o] = max(orphans.get(o, it), it)
        for owner in sorted(orphans):
            it = orphans[owner]
            c_holders = sorted(
                r for r in active if (owner, it) in peer_held[r]
            )
            if c_holders:
                primary = c_holders[0]
                grp = sorted(group_of(primary, self.groups))
                gk, gm = self._code_geometry(grp)
                dsts = [
                    d for d in grp
                    if d != primary and not any(
                        b[0] == owner and b[1] == it
                        and b[2] == self._position(d, grp)
                        for b in peer_blocks.get(d, ())
                    )
                ]
                if rank == primary and dsts:
                    parts = [get_blob(owner, it)]
                    views, orig_len, block_len, parity = encode_payload(
                        parts, gk, gm
                    )
                    meta = _payload_meta(parts)
                    digest = meta.pop("digest")
                    _fan_out([
                        (lambda p=d, i=self._position(d, grp):
                         self.exchange.send_parts(
                             p, f"{tag}/orph/{owner}",
                             build_block_parts(
                                 owner, it, gk, gm, i,
                                 coded_block(views, orig_len, block_len,
                                             parity, gk, i),
                                 orig_len, digest, **meta)))
                        for d in dsts
                    ])
                elif rank in dsts:
                    received[owner] = (
                        it, self.exchange.recv(primary, f"{tag}/orph/{owner}")
                    )
                continue
            # Blocks only: route them to the elected reconstructor.
            idx_holders: dict[int, list[int]] = {}
            geo = None
            for r in sorted(active):
                for o, bit, index, bk, bm in (
                    tuple(b) for b in peer_blocks.get(r, ())
                ):
                    if o == owner and bit == it:
                        idx_holders.setdefault(index, []).append(r)
                        geo = (bk, bm)
            if geo is None:
                continue
            bk, bm = geo
            holders_any = sorted({r for hs in idx_holders.values() for r in hs})
            primary = holders_any[0]
            mine = {
                i for i, hs in idx_holders.items() if primary in hs
            }
            candidates = [
                i for i in sorted(idx_holders, key=lambda i: (i >= bk, i))
                if i not in mine
            ]
            picks = []
            for i in candidates[: max(0, bk - len(mine))]:
                src = min(h for h in idx_holders[i] if h != primary)
                picks.append((i, src))
            if len(mine) + len(picks) < bk:
                continue  # unrecoverable from blocks; nothing to do
            if rank == primary:
                arts = [get_block(owner, it, i) for i in sorted(mine)]
                for i, src in picks:
                    arts.append(
                        self.exchange.recv(src, f"{tag}/rb/{owner}/{i}")
                    )
                try:
                    blob = reconstruct_container(
                        arts, source=f"remirror(owner={owner})"
                    )
                    received[owner] = (it, blob)
                    record_event(
                        "checkpoint", "ckpt_parity_reconstruct",
                        owner=owner, outcome="ok", blocks=len(arts),
                        bytes=len(blob), stage="remirror",
                    )
                except CheckpointError as e:
                    record_event(
                        "checkpoint", "ckpt_parity_reconstruct",
                        owner=owner, outcome="failed", blocks=len(arts),
                        error=repr(e), stage="remirror",
                    )
            else:
                sends = []
                for i, src in picks:
                    if src == rank:
                        sends.append(
                            lambda o=owner, it2=it, i2=i: self.exchange.send(
                                primary, f"{tag}/rb/{o}/{i2}",
                                get_block(o, it2, i2),
                            )
                        )
                _fan_out(sends)
        return received
