"""Deterministic network + disk fault injection for the out-of-band planes.

``inprocess/tools/inject_fault.py`` covers process- and device-level faults
(SIGKILL, GIL lockup, device hang); this module covers the faults a real
pod-slice *network* produces — connection resets, mid-frame truncation,
latency/jitter, short-read stalls, EOF on accept, and partition of a named
peer — injected at the socket boundary shared by all three out-of-band
channels (``platform/framing.py`` callers):

- ``store``  — the :class:`~tpu_resiliency_torch.platform.store.KVClient` /
  ``KVServer`` coordination channel (client sockets + server accepts),
- ``p2p``    — :class:`~tpu_resiliency_torch.checkpoint.comm.PeerExchange`
  replication links (dial, send/recv, accepts),
- ``ipc``    — the UDS channel (``platform/ipc.py``: ``connect``, receiver
  accepts/reads),

plus a fourth, **disk**, channel covering the faults node-local *storage*
produces against checkpoint containers (``checkpoint/format.py``'s patchable
IO shim): silent bit flips, post-commit tail truncation, torn renames
(rename journaled, data blocks lost), ``ENOSPC``, and slow IO. Disk rules use
``op`` = ``write`` (every container write call: header prefix, each leaf,
trailer, striped pwrites) or ``commit`` (the ``.dirty``→visible rename), and
their ``peer=`` names the target file as its final
``<holder-dir>/<filename>`` path pair (e.g.
``peer=r0/iter_0000002_0_local.ckpt``) so one rank's copy of one shard can be
corrupted while its clique mirrors stay intact. Disk call indices (``at=``)
count per *file*, not per process — each container is written sequentially by
one thread, so disk schedules reproduce even under racy cross-rank timing.

A fifth channel, **cold**, mirrors the disk channel for the durable cold tier
(``checkpoint/coldtier.py``'s :class:`ObjectStore` backends): same ``write``/
``commit`` ops and fault kinds, but ``peer=`` names the *object key* (e.g.
``peer=s0/iter_0000002/owner_0.ckpt``) and — like disk — call indices count
per key, so one artifact upload can be corrupted while the manifest beside it
lands intact. Uploads stream in fixed-size slices, so ``at=N`` picks the
N-th slice of one object deterministically.

Faults are *planned*, not sprayed: a :class:`ChaosPlan` is parsed from
``$TPU_RESILIENCY_CHAOS`` (``"<seed>:<rule>[;<rule>...]"``) or installed
programmatically, holds a seeded RNG, and decides per channel, per op, by
exact call index (``at=``) or probability (``p=``). Every injection is
recorded as a structured ``chaos_inject`` event (→
``chaos_faults_injected_total{kind,channel}`` via the events→metrics bridge)
and on the plan's ``injected`` list, so a surviving run's injection schedule
is inspectable and — for ``at=`` rules — exactly reproducible from the seed:
the per-``(channel, op)`` call counters are process-local and advance once
per operation regardless of thread interleaving.

Rule grammar (see ``docs/chaos.md`` for the channel × fault coverage matrix)::

    rule    := <channel>.<op>.<kind>[@param[,param...]]
    channel := store | p2p | ipc | disk | cold | *
    op      := connect | accept | send | recv | write | commit | *
    kind    := reset | truncate | eof | delay | stall | partition
             | bitflip | torn-rename | enospc | slow-io
    param   := at=N[+N...] | p=FLOAT | n=N | peer=NAME | delay=S | jitter=S

Examples::

    TPU_RESILIENCY_CHAOS="42:store.send.reset@at=3;p2p.send.truncate@at=1+5"
    TPU_RESILIENCY_CHAOS="7:p2p.connect.partition@peer=2,n=4;ipc.recv.delay@p=0.2,delay=0.05"
    TPU_RESILIENCY_CHAOS="9:disk.write.bitflip@peer=r0/iter_0000002_0_local.ckpt"
    TPU_RESILIENCY_CHAOS="3:disk.commit.torn-rename@at=1;disk.write.enospc@p=0.01"

``n=`` bounds total injections of a rule (defaults: one per ``at=`` index;
unbounded for ``p=`` rules; ``partition`` and the disk-only kinds default to
``p=1.0`` so a peer-scoped rule fires without an explicit schedule). Chaos is
for tests of THIS framework only; with the variable unset every hook is a
no-op returning the socket (or write buffer) unchanged.
"""

from __future__ import annotations

import dataclasses
import errno
import os
import random
import socket
import threading
import time
from typing import Any, Optional, Sequence

from tpu_resiliency_torch.utils.events import record as record_event
from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)

CHAOS_ENV = "TPU_RESILIENCY_CHAOS"

CHANNELS = ("store", "p2p", "ipc", "disk", "cold")
OPS = ("connect", "accept", "send", "recv", "write", "commit")
KINDS = (
    "reset", "truncate", "eof", "delay", "stall", "partition",
    "bitflip", "torn-rename", "enospc", "slow-io",
)

#: Kinds a rule may apply at each disk op; hooks skip rules outside these sets
#: (a wildcard ``*.*.reset`` must never "reset" a file write).
DISK_WRITE_KINDS = ("bitflip", "enospc", "slow-io", "delay")
DISK_COMMIT_KINDS = ("truncate", "torn-rename", "slow-io", "delay")
#: Kinds that default to ``p=1.0`` when a rule gives neither ``at=`` nor
#: ``p=`` — they are scoped by ``peer=``/``n=`` instead of a schedule.
_ALWAYS_ON_KINDS = ("partition", "bitflip", "torn-rename", "enospc", "slow-io")


@dataclasses.dataclass
class Rule:
    channel: str
    op: str
    kind: str
    at: Optional[frozenset[int]] = None
    p: Optional[float] = None
    #: remaining injection budget; None = unbounded
    n: Optional[int] = None
    peer: Optional[str] = None
    delay: float = 0.05
    jitter: float = 0.0

    def matches(self, channel: str, op: str, peer: Optional[str]) -> bool:
        if self.channel != "*" and self.channel != channel:
            return False
        if self.op != "*" and self.op != op:
            return False
        if self.peer is not None and peer is not None and self.peer != str(peer):
            return False
        # A peer-scoped rule never fires on an op whose peer is unknown.
        if self.peer is not None and peer is None:
            return False
        return True


def _parse_rule(text: str) -> Rule:
    head, _, params = text.partition("@")
    parts = head.strip().split(".")
    if len(parts) != 3:
        raise ValueError(f"chaos rule {text!r}: expected channel.op.kind")
    channel, op, kind = (p.strip() for p in parts)
    if channel != "*" and channel not in CHANNELS:
        raise ValueError(f"chaos rule {text!r}: unknown channel {channel!r}")
    if op != "*" and op not in OPS:
        raise ValueError(f"chaos rule {text!r}: unknown op {op!r}")
    if kind not in KINDS:
        raise ValueError(f"chaos rule {text!r}: unknown fault kind {kind!r}")
    rule = Rule(channel=channel, op=op, kind=kind)
    for item in filter(None, (s.strip() for s in params.split(","))):
        key, _, val = item.partition("=")
        if key == "at":
            rule.at = frozenset(int(v) for v in val.split("+"))
        elif key == "p":
            rule.p = float(val)
        elif key == "n":
            rule.n = int(val)
        elif key == "peer":
            rule.peer = val
        elif key == "delay":
            rule.delay = float(val)
        elif key == "jitter":
            rule.jitter = float(val)
        else:
            raise ValueError(f"chaos rule {text!r}: unknown param {key!r}")
    if rule.at is None and rule.p is None:
        if rule.kind in _ALWAYS_ON_KINDS:
            rule.p = 1.0  # holds until the n= budget runs out / peer scope ends
        else:
            raise ValueError(f"chaos rule {text!r}: needs at= or p=")
    if rule.n is None and rule.at is not None:
        rule.n = len(rule.at)
    return rule


@dataclasses.dataclass(frozen=True)
class Injection:
    """One executed injection — the reproducible schedule unit."""

    channel: str
    op: str
    kind: str
    index: int
    peer: Optional[str] = None


class ChaosPlan:
    """A parsed, seeded fault plan. ``check()`` is the single decision point
    every hook funnels through; it advances the per-``(channel, op)`` call
    counter exactly once per operation, so ``at=`` schedules are deterministic
    under any thread interleaving, and probabilistic draws come from the one
    seeded RNG."""

    def __init__(self, seed: int, rules: Sequence[Rule], spec: str = ""):
        self.seed = seed
        self.rules = list(rules)
        self.spec = spec
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._counters: dict[tuple[str, str], int] = {}
        self.injected: list[Injection] = []

    @classmethod
    def parse(cls, spec: str) -> "ChaosPlan":
        seed_s, sep, rules_s = spec.partition(":")
        if not sep:
            raise ValueError(f"chaos spec {spec!r}: expected '<seed>:<rules>'")
        rules = [_parse_rule(r) for r in filter(None, (s.strip() for s in rules_s.split(";")))]
        return cls(int(seed_s), rules, spec=spec)

    def check(
        self, channel: str, op: str, peer: Optional[str] = None,
        kinds: Optional[Sequence[str]] = None,
    ) -> Optional[Rule]:
        """Advance the ``(channel, op)`` counter; return the rule to apply to
        this operation, or None. At most one rule fires per op (first match in
        spec order wins). ``kinds`` restricts which fault kinds this hook can
        apply (non-matching rules are skipped, their budget untouched)."""
        return self.check_injection(channel, op, peer, kinds)[0]

    def check_injection(
        self, channel: str, op: str, peer: Optional[str] = None,
        kinds: Optional[Sequence[str]] = None,
    ) -> tuple[Optional[Rule], Optional[Injection]]:
        """Like :meth:`check` but also returns the :class:`Injection` record —
        hooks that derive deterministic fault parameters (a bit-flip offset)
        key them off the injection's ``(peer, index)`` identity.

        Counter scope: network channels count per ``(channel, op)`` process-
        wide; the ``disk`` and ``cold`` channels count per ``(channel, op,
        peer)`` — i.e. per target file / object key — because each container
        (or upload) is written sequentially by one thread, which makes
        per-file ``at=`` schedules deterministic where a process-global write
        counter would race across ranks."""
        with self._lock:
            key = (channel, op, peer) if channel in ("disk", "cold") else (channel, op)
            idx = self._counters.get(key, 0)
            self._counters[key] = idx + 1
            for rule in self.rules:
                if rule.n == 0 or not rule.matches(channel, op, peer):
                    continue
                if kinds is not None and rule.kind not in kinds:
                    continue
                hit = False
                if rule.at is not None:
                    hit = idx in rule.at
                elif rule.p is not None:
                    hit = self._rng.random() < rule.p
                if not hit:
                    continue
                if rule.n is not None:
                    rule.n -= 1
                inj = Injection(channel, op, rule.kind, idx, peer)
                self.injected.append(inj)
                self._record(inj)
                return rule, inj
        return None, None

    @staticmethod
    def _record(inj: Injection) -> None:
        log.warning(
            f"chaos: injecting {inj.kind} into {inj.channel}.{inj.op}"
            f"[{inj.index}]" + (f" peer={inj.peer}" if inj.peer else "")
        )
        record_event(
            "chaos", "chaos_inject",
            fault=inj.kind, channel=inj.channel, op=inj.op,
            index=inj.index, peer=inj.peer,
        )

    def schedule(self) -> list[tuple[str, str, str, int]]:
        """The executed injection schedule as sorted ``(channel, op, kind,
        index)`` tuples — the reproducibility artifact two same-seed runs must
        agree on. Sorted, not append-ordered: the schedule is a mapping of
        op-index → fault, and which *thread* reaches its index first is racy
        even though the injection points themselves are not."""
        with self._lock:
            return sorted((i.channel, i.op, i.kind, i.index) for i in self.injected)


# -- process-global plan -----------------------------------------------------

_plan: Optional[ChaosPlan] = None
#: env string the current plan was parsed from; _INSTALLED marks a
#: programmatically installed plan (env is ignored until cleared)
_INSTALLED = object()
_plan_env: Any = None
_plan_lock = threading.Lock()


def active_plan() -> Optional[ChaosPlan]:
    """The installed plan, else the one lazily parsed from ``$TPU_RESILIENCY_CHAOS``
    (re-checked each call so spawned children and late exports take effect)."""
    global _plan, _plan_env
    if _plan_env is _INSTALLED:
        return _plan
    spec = os.environ.get(CHAOS_ENV) or None
    if spec != _plan_env:
        with _plan_lock:
            if spec != _plan_env and _plan_env is not _INSTALLED:
                if spec is None:
                    _plan = None
                else:
                    try:
                        _plan = ChaosPlan.parse(spec)
                        log.warning(f"chaos plan active: {spec!r}")
                    except ValueError as e:
                        log.error(f"ignoring malformed ${CHAOS_ENV}: {e}")
                        _plan = None
                _plan_env = spec
    return _plan


def install_plan(plan: Optional[ChaosPlan]) -> Optional[ChaosPlan]:
    """Install ``plan`` process-wide (tests); pass None to clear (the env var
    becomes authoritative again). Returns the previous plan."""
    global _plan, _plan_env
    with _plan_lock:
        prev = _plan
        _plan = plan
        _plan_env = _INSTALLED if plan is not None else None
    return prev


def clear_plan() -> None:
    install_plan(None)


# -- hook points -------------------------------------------------------------


def _apply_connect(rule: Rule) -> None:
    if rule.kind in ("delay", "stall"):
        time.sleep(rule.delay + rule.jitter * random.random())
        return
    # reset / eof / partition / truncate at connect: the dial fails.
    raise ConnectionRefusedError(
        errno.ECONNREFUSED, f"chaos: injected {rule.kind} on connect"
    )


def check_connect(channel: str, peer: Optional[str] = None) -> None:
    """Call before dialing; raises ``ConnectionRefusedError`` to simulate a
    failed/partitioned dial, or sleeps for a delay fault."""
    plan = active_plan()
    if plan is None:
        return
    rule = plan.check(channel, "connect", peer)
    if rule is not None:
        _apply_connect(rule)


def check_accept(channel: str, peer: Optional[str] = None) -> bool:
    """Call after accepting; True means "close this connection immediately"
    (the peer observes EOF before any frame — EOF-on-accept)."""
    plan = active_plan()
    if plan is None:
        return False
    rule = plan.check(channel, "accept", peer)
    if rule is None:
        return False
    if rule.kind in ("delay", "stall"):
        time.sleep(rule.delay + rule.jitter * random.random())
        return False
    return True  # reset/eof/truncate/partition on accept: drop the conn


# -- disk channel hooks (consumed by checkpoint/format.py's IO shim) ---------


def disk_peer(path: str) -> str:
    """Stable rule-targetable name for a container path: the final
    ``<holder-dir>/<filename>`` pair, with any ``.dirty`` suffix stripped —
    ``/ssd/ckpt/s0/r1/iter_0000002_0_local.ckpt.dirty`` →
    ``r1/iter_0000002_0_local.ckpt``. The holder dir is part of the name so a
    rule can corrupt one rank's copy of a shard without touching its clique
    mirrors (same filename, different holder dir)."""
    if path.endswith(".dirty"):
        path = path[: -len(".dirty")]
    parts = path.replace(os.sep, "/").rstrip("/").split("/")
    return "/".join(parts[-2:])


def _deterministic_rng(plan: ChaosPlan, inj: Injection) -> random.Random:
    """Fault parameters (bit offsets, truncation points) come from an RNG
    seeded by ``(seed, file, injection index)`` — NOT the plan's shared RNG,
    whose draw order is racy across threads. Same seed → same corruption."""
    return random.Random((plan.seed, inj.peer, inj.index))


def _on_storage_write(channel: str, peer: str, path: str, data):
    """Shared body of :func:`on_disk_write` / :func:`on_cold_write` — the two
    channels differ only in how the rule-targetable peer name is derived."""
    plan = active_plan()
    if plan is None:
        return data
    rule, inj = plan.check_injection(
        channel, "write", peer=peer, kinds=DISK_WRITE_KINDS
    )
    if rule is None:
        return data
    if rule.kind == "enospc":
        raise OSError(errno.ENOSPC, f"chaos: injected enospc writing {path}")
    if rule.kind in ("slow-io", "delay"):
        time.sleep(rule.delay + rule.jitter * random.random())
        return data
    # bitflip: corrupt a copy, never the caller's buffer (it may be a live
    # staging-pool view feeding peer sockets that should stay intact).
    view = memoryview(data)
    if view.ndim != 1 or view.itemsize != 1:
        view = view.cast("B")
    out = bytearray(view)
    if out:
        rng = _deterministic_rng(plan, inj)
        pos = rng.randrange(len(out))
        out[pos] ^= 1 << rng.randrange(8)
    return out


def on_disk_write(path: str, data):
    """Chaos hook for one container write call (header prefix, a leaf, the
    trailer, or one striped pwrite range). Returns the buffer to actually put
    on disk — a copy with one deterministically chosen bit flipped under
    ``bitflip`` — sleeps under ``slow-io``/``delay``, raises
    ``OSError(ENOSPC)`` under ``enospc``. Identity when no plan is active."""
    plan = active_plan()
    if plan is None:
        return data
    return _on_storage_write("disk", disk_peer(path), path, data)


def on_disk_commit(tmp: str, path: str):
    """Chaos hook before the ``.dirty``→visible rename. ``torn-rename``
    truncates the temp file before the rename lands (the rename was journaled
    but the data blocks never hit the platter — the visible file is torn);
    ``truncate`` returns a post-rename action that cuts the *visible* file's
    tail (post-commit corruption); ``slow-io``/``delay`` sleep. Returns a
    callable to run after ``os.replace``, or None."""
    plan = active_plan()
    if plan is None:
        return None
    rule, inj = plan.check_injection(
        "disk", "commit", peer=disk_peer(path), kinds=DISK_COMMIT_KINDS
    )
    if rule is None:
        return None
    if rule.kind in ("slow-io", "delay"):
        time.sleep(rule.delay + rule.jitter * random.random())
        return None
    rng = _deterministic_rng(plan, inj)
    if rule.kind == "torn-rename":
        _truncate_tail(tmp, rng)
        return None
    return lambda: _truncate_tail(path, rng)  # post-commit truncate


def on_cold_write(key: str, path: str, data):
    """Chaos hook for one cold-tier upload slice. ``key`` is the object key
    (the rule's ``peer=`` target); ``path`` is the backend's physical temp
    path, only used for error text. Same fault kinds and semantics as
    :func:`on_disk_write`."""
    return _on_storage_write("cold", key, path, data)


def on_cold_commit(tmp: str, key: str, path: str):
    """Chaos hook before a cold-tier upload's tmp→visible rename. Mirrors
    :func:`on_disk_commit`, with rules targeting the object ``key``; the
    returned post-commit action (under ``truncate``) cuts the tail of the
    visible ``path``."""
    plan = active_plan()
    if plan is None:
        return None
    rule, inj = plan.check_injection(
        "cold", "commit", peer=key, kinds=DISK_COMMIT_KINDS
    )
    if rule is None:
        return None
    if rule.kind in ("slow-io", "delay"):
        time.sleep(rule.delay + rule.jitter * random.random())
        return None
    rng = _deterministic_rng(plan, inj)
    if rule.kind == "torn-rename":
        _truncate_tail(tmp, rng)
        return None
    return lambda: _truncate_tail(path, rng)  # post-commit truncate


def _truncate_tail(path: str, rng: random.Random) -> None:
    """Cut a deterministic 1..half-of-file tail off ``path`` (at least one
    byte, so the loss is always detectable)."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return
    if size <= 1:
        return
    keep = rng.randrange(max(1, size // 2), size)
    with open(path, "r+b") as f:
        f.truncate(keep)


def wrap(sock: socket.socket, channel: str, peer: Optional[str] = None):
    """Wrap a connected socket with fault-injecting send/recv; identity when
    no plan is active (zero overhead on the unchaosed hot path)."""
    plan = active_plan()
    if plan is None:
        return sock
    return ChaosSocket(sock, plan, channel, peer)


class ChaosSocket:
    """Fault-injecting proxy over a connected socket.

    Intercepts the data-plane calls the framing layer uses (``send``,
    ``sendall``, ``sendmsg``, ``recv``, ``recv_into``); everything else —
    ``settimeout``, ``close``, ``fileno``, ... — delegates to the wrapped
    socket. ``os.sendfile`` payloads bypass the wrapper (they ride the raw
    fd); the bulk preamble still goes through ``sendall``, so file sends are
    reset/truncate-injectable at the frame boundary.
    """

    def __init__(self, sock: socket.socket, plan: ChaosPlan, channel: str,
                 peer: Optional[str] = None):
        self._sock = sock
        self._plan = plan
        self._channel = channel
        self._peer = peer

    def __getattr__(self, name: str) -> Any:
        return getattr(self._sock, name)

    def __enter__(self) -> "ChaosSocket":
        return self

    def __exit__(self, *exc) -> None:
        self._sock.close()

    # -- fault application -------------------------------------------------

    def _kill(self, kind: str) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
        raise ConnectionResetError(
            errno.ECONNRESET, f"chaos: injected {kind}"
        )

    def _sleep(self, rule: Rule) -> None:
        time.sleep(rule.delay + rule.jitter * random.random())

    def _check_send(self, data) -> Optional[memoryview]:
        """Returns a truncated prefix to really send before dying, or None to
        proceed with the faultless path (after any delay)."""
        rule = self._plan.check(self._channel, "send", self._peer)
        if rule is None:
            return None
        if rule.kind in ("delay", "stall"):
            self._sleep(rule)
            return None
        if rule.kind == "truncate":
            v = memoryview(data).cast("B") if data is not None else memoryview(b"")
            # Deliver a genuine partial frame: at least 1 byte, at most half.
            return v[: max(1, v.nbytes // 2)]
        self._kill(rule.kind)  # reset / eof / partition
        raise AssertionError("unreachable")

    # -- send side ---------------------------------------------------------

    def sendall(self, data, *args) -> None:
        prefix = self._check_send(data)
        if prefix is None:
            return self._sock.sendall(data, *args)
        try:
            self._sock.sendall(prefix)
        except OSError:
            pass
        self._kill("truncate")

    def send(self, data, *args) -> int:
        prefix = self._check_send(data)
        if prefix is None:
            return self._sock.send(data, *args)
        try:
            self._sock.sendall(prefix)
        except OSError:
            pass
        self._kill("truncate")
        raise AssertionError("unreachable")

    def sendmsg(self, buffers, *args):
        bufs = list(buffers)
        first = bufs[0] if bufs else b""
        prefix = self._check_send(first)
        if prefix is None:
            return self._sock.sendmsg(bufs, *args)
        try:
            self._sock.sendall(prefix)
        except OSError:
            pass
        self._kill("truncate")

    # -- recv side ---------------------------------------------------------

    def _check_recv(self) -> Optional[Rule]:
        rule = self._plan.check(self._channel, "recv", self._peer)
        if rule is None:
            return None
        if rule.kind == "reset":
            self._kill("reset")
        if rule.kind in ("truncate", "eof"):
            # Observed from the read side, a truncated frame is a premature
            # close: deliver EOF (framing raises EOFError mid-frame).
            try:
                self._sock.close()
            except OSError:
                pass
            return rule
        self._sleep(rule)  # delay / stall
        return rule if rule.kind == "stall" else None

    def recv(self, bufsize: int, *args) -> bytes:
        rule = self._check_recv()
        if rule is not None and rule.kind in ("truncate", "eof"):
            return b""
        if rule is not None and rule.kind == "stall":
            bufsize = 1  # short read: one byte this call
        return self._sock.recv(bufsize, *args)

    def recv_into(self, buffer, nbytes: int = 0, *args) -> int:
        rule = self._check_recv()
        if rule is not None and rule.kind in ("truncate", "eof"):
            return 0
        if rule is not None and rule.kind == "stall":
            nbytes = 1  # short read: one byte this call
        return self._sock.recv_into(buffer, nbytes, *args)


# -- plan generation ---------------------------------------------------------


def random_spec(
    seed: int,
    channels: Sequence[str] = CHANNELS,
    ops: Sequence[str] = ("send", "connect"),
    kinds: Sequence[str] = ("reset", "truncate", "delay"),
    faults_per_channel: int = 2,
    max_index: int = 12,
) -> str:
    """Generate a randomized-but-seeded ``at=``-only spec string: the soak
    harness's fault plans. Deterministic in ``seed``; every channel receives
    ``faults_per_channel`` faults at early call indices (truncate rules are
    pinned to ``send`` — a connect can't truncate mid-frame)."""
    rng = random.Random(seed)
    rules = []
    for ch in channels:
        picked_kinds = list(kinds[:faults_per_channel]) + [
            rng.choice(kinds) for _ in range(max(0, faults_per_channel - len(kinds)))
        ]
        for kind in picked_kinds[:faults_per_channel]:
            op = "send" if kind == "truncate" else rng.choice(list(ops))
            idx = rng.randrange(1, max_index)
            rules.append(f"{ch}.{op}.{kind}@at={idx}")
    return f"{seed}:" + ";".join(rules)
