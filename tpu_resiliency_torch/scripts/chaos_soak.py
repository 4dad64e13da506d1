"""Chaos soak: drive the coordination and storage planes through seeded fault plans.

Each scenario asserts the job converges to a CORRECT final state
despite injected faults (`tpu_resiliency/platform/chaos.py`):

- **store**: N client threads hammer one ``KVServer`` (sets, shared counter
  adds, reentrant barriers) while resets/truncations/EOF-on-accept hit the
  channel. Convergence = every key present, the counter EXACT (at-most-once
  adds under retry — the req_id dedup), barriers released the right number of
  times.
- **replication**: a 3-clique ``replicate()`` + ``retrieve()`` round under p2p
  faults. Convergence = every surviving mirror and every routed shard is
  byte-identical to the payload its owner saved.
- **disk**: two ranks save two replicated checkpoint iterations while a seeded
  ``disk.write.bitflip`` plan corrupts one rank's newest shard at write time;
  ``LocalCheckpointManager.load()`` must climb the recovery ladder. With only
  the rank's own copy corrupt: quarantine → peer retrieve → byte-identical
  tree, no exception. With the clique mirror ALSO corrupt (``--fallback``
  variant): every rank agrees on and loads the older iteration. Both variants
  assert ``ckpt_quarantined`` events and ``tpu_ckpt_integrity_failures_total``
  in the aggregated metrics.
- **coding**: the byte-economy campaign — a 4-rank erasure clique saves under
  network pressure, then a victim death + a holder death + a seeded parity
  bitflip force the recovery ladder to ATTEMPT reconstruction, fail CLOSED
  (never a false-positive container), and agree the keyframe fallback, which
  reconstructs byte-identically; a 2-rank delta chain then breaks its base
  and must drop exactly one mirror (``ckpt_delta_applied{broken}``) while
  saves/loads stay healthy. The full seeded fault-identity tuple reproduces.
- **elastic**: the shrink-and-continue chain — a 4-rank dp world checkpoints
  with layout meta, the seed-chosen victim is preempted (disk gone), the
  survivors resume resharded (``load_resharded``) and save at the shrunken
  layout, then the victim returns wiped and the wide world reshards back up.
  Convergence = every resumed world byte-identical, the shrink's peer traffic
  strictly less than whole mirrors, ``tpu_reshard_*`` metrics aggregate.
- **cold-start**: checkpoints that outlive the job — a 3-rank job archives two
  keyframes to the durable cold tier (``checkpoint/coldtier.py``), then its
  ENTIRE process tree is SIGKILLed mid-training. A fresh 2-rank world with an
  EMPTY workdir resumes from the cold tier alone, byte-identical. The seeded
  bitflip variant corrupts one archived payload byte (victim owner + offset
  derived from the seed): the fresh world refuses it fail-closed
  (``coldtier_fetch{outcome="corrupt"}``) and the group agrees to climb to the
  next-older covered iteration. Outcome tuple reproduces run-to-run per seed.
- **launcher**: the real ``tpu-ft-launcher`` restart chain (worker fails round
  0, succeeds round 1) with FT monitors on, under env-propagated chaos hitting
  the store AND ipc channels. Convergence = exit 0 + the events file shows at
  least one reset and one truncation injected per channel.
- **mixed**: the multi-fault campaign — an injected straggler driving the
  policy → remediation loop, a store reset, and a disk bitflip landing during
  an active save — with the incident plane watching. Convergence = recovery
  byte-identical, every incident artifact carries the detect→decide→act→
  recover chain and renders through ``incident_report``, the
  ``tpu_incident_*`` / ``tpu_remediation_actions_total`` metrics aggregate
  from the events stream, and the goodput ledger charges the campaign's
  open→close windows to the ``incident`` phase.
- **hang**: the forensics chain — a seed-chosen rank wedges in a GIL-holding
  sleep while its peer blocks in a barrier it never reaches. Convergence =
  ``/hangz`` names the victim mid-stall (census saved to ``hangz.json``),
  ``hang_detected`` carries the location beacon, the victim captured a
  ``stack_dump``, the ``hang_census`` implicates it, and the job restarts to
  a successful round — with an identical forensics schedule across the two
  per-seed runs.
- **autoscale**: the detect→decide→act acceptance — fluctuating capacity
  (a preemption notice that rescinds, then one that doesn't) + a seeded
  straggler + a disk bitflip, run through the goodput-optimal
  ``AutoscaleController`` (act mode) and through a no-controller baseline
  with today's hard-coded reactions. Convergence = the controlled arm's
  measured goodput ratio STRICTLY beats the baseline of the same seed, the
  (decision, action, victim) schedule reproduces across two controlled
  runs, every ``autoscale_decision`` pairs with an ``autoscale_outcome``
  carrying predicted AND realized deltas, and the ``tpu_autoscale_*``
  metrics aggregate.

Every in-process scenario runs TWICE with the same seed and asserts the two
injection schedules are identical — the reproducibility contract: a failure
seen once is a failure you can replay.

    python -m tpu_resiliency_torch.scripts.chaos_soak --smoke         # fast fixed-seed pass
    python -m tpu_resiliency_torch.scripts.chaos_soak --seed 7        # one full seeded pass
    python -m tpu_resiliency_torch.scripts.chaos_soak --soak-runs 10  # randomized soak

Exit 0 iff every scenario converged.
"""

import argparse
import concurrent.futures as cf
import json
import os
import subprocess
import sys
import tempfile
import textwrap
import threading
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO_ROOT)

os.environ.setdefault("JAX_PLATFORMS", "cpu")

from tpu_resiliency_torch.checkpoint.comm import PeerExchange, StoreComm  # noqa: E402
from tpu_resiliency_torch.checkpoint.replication import (  # noqa: E402
    CliqueReplicationStrategy,
)
from tpu_resiliency_torch.platform import chaos  # noqa: E402
from tpu_resiliency_torch.platform.store import CoordStore, KVServer  # noqa: E402
from tpu_resiliency_torch.utils.events import read_events  # noqa: E402


def _assert_byteflow_accounts(seen, min_frac: float = 0.95) -> None:
    """The byte-flow acceptance gate: the ledger (``utils/byteflow.py``) must
    attribute ≥95% of every byte this scenario moved to a purpose, and the
    residue must surface as a metric through the same events→metrics path
    everything else uses. Runs inside the chaos scenarios so every smoke and
    e2e repro inherits the gate."""
    from tpu_resiliency_torch.utils.byteflow import ByteFlowLedger
    from tpu_resiliency_torch.utils.metrics import aggregate as _aggregate

    ledger = ByteFlowLedger()
    ledger.observe_many(e.to_record() for e in seen)
    bf = ledger.summary()
    assert bf["total_bytes"] > 0, "scenario moved no accountable bytes"
    assert bf["accounted_frac"] >= min_frac, (
        f"byte-flow ledger attributed only "
        f"{100 * bf['accounted_frac']:.1f}% of {bf['total_bytes']} bytes "
        f"(residue {bf['residue_bytes']}): {bf['families']}"
    )
    pub: list = []
    ledger.publish(lambda source, kind, **p: pub.append({"kind": kind, **p}))
    prom = _aggregate(pub).to_prometheus()
    assert "tpu_byteflow_bytes_total" in prom, prom[:2000]
    assert "tpu_byteflow_accounted_ratio" in prom, prom[:2000]


# -- scenario: coordination store -------------------------------------------

STORE_SPEC = (
    "{seed}:store.send.reset@at=4;store.send.truncate@at=11;"
    "store.recv.reset@at=9;store.recv.truncate@at=20;store.accept.eof@at=2"
)


def scenario_store(seed: int, clients: int = 3, keys: int = 8, rounds: int = 3,
                   spec: str | None = None):
    """Returns the injection schedule; raises on any divergence."""
    plan = chaos.ChaosPlan.parse(spec or STORE_SPEC.format(seed=seed))
    chaos.install_plan(plan)
    srv = KVServer(host="127.0.0.1", port=0)
    stores = []
    try:
        def body(cid: int):
            st = CoordStore("127.0.0.1", srv.port, timeout=30.0)
            stores.append(st)
            for r in range(rounds):
                for k in range(keys):
                    st.set(f"c{cid}/k{k}", (cid, r, k))
                st.add("counter", 1)
                st.barrier(f"round", cid, clients, timeout=30.0)

        with cf.ThreadPoolExecutor(max_workers=clients) as pool:
            for f in [pool.submit(body, c) for c in range(clients)]:
                f.result(timeout=120)

        probe = CoordStore("127.0.0.1", srv.port, timeout=10.0)
        stores.append(probe)
        counter = probe.get("counter", timeout=5.0)
        assert counter == clients * rounds, (
            f"counter diverged: {counter} != {clients * rounds} "
            f"(a retried add double- or under-applied)"
        )
        data = probe.prefix_get("")
        for cid in range(clients):
            for k in range(keys):
                key = f"c{cid}/k{k}"
                assert data.get(key) == (cid, rounds - 1, k), (key, data.get(key))
        status = probe.barrier_status("round")
        assert status["generation"] == rounds, status
    finally:
        chaos.clear_plan()
        for s in stores:
            s.close()
        srv.close()
    return plan.schedule()


# -- scenario: sharded clique + tree collectives ----------------------------

#: Faults timed to land MID-tree-gather and MID-shard-fanout: the first
#: resets hit while edge values are flowing up the tree, the truncations
#:  while the prefix fan-out reads every shard. Every op on these paths is
#: idempotent (set/get/prefix_get) or req_id-deduped (barrier arrivals), so
#: the client's reconnect-retry ladder must absorb all of it byte-identically.
STORE_SCALE_SPEC = (
    "{seed}:store.send.reset@at=5;store.send.truncate@at=13;"
    "store.recv.reset@at=8;store.recv.truncate@at=21;store.accept.eof@at=3;"
    "store.send.reset@at=34;store.recv.truncate@at=55"
)


def scenario_store_scale(seed: int, world: int = 9, shards: int = 2,
                         rounds: int = 2, spec: str | None = None):
    """Tree collectives over a sharded store clique under seeded faults.

    ``world`` member threads run ``StoreComm`` with the TREE paths forced on
    (fanout 2 → a 3-level tree at world 9) over a ``shards``-wide
    ``LocalClique``; per round every member all_gathers a distinct payload,
    crosses a tree barrier, and the leader does a shard-fanout ``prefix_get``
    census. Convergence: every member's every gather is byte-identical to the
    expected list (same values, same order — the flat contract), the census
    sees every member's key across all shards, and two runs of one seed
    produce the identical injection schedule AND identical gathered bytes.
    Returns ``(schedule, gathered_digest)``.
    """
    import hashlib
    import pickle

    from tpu_resiliency_torch.platform.shardstore import LocalClique

    plan = chaos.ChaosPlan.parse(spec or STORE_SCALE_SPEC.format(seed=seed))
    chaos.install_plan(plan)
    clique = LocalClique(shards)
    stores = []
    results: dict[int, list] = {}
    try:
        def body(rank: int):
            st = clique.client(prefix="soak/")
            stores.append(st)
            comm = StoreComm(
                st, rank, list(range(world)), timeout=60.0,
                tree_fanout=2, tree_min_world=2,  # force the tree shape
            )
            gathered = []
            for r in range(rounds):
                st.set(f"census/{rank}/r{r}", (rank, r))
                gathered.append(comm.all_gather((rank, r, b"x" * (rank + 1)),
                                                tag="ag"))
                comm.barrier("bar", timeout=60.0)
                if comm.is_leader:
                    # Peers may already be writing round r+1 keys (the
                    # barrier releases them forward), so assert the fan-out
                    # found EVERY key owed so far, not an exact count.
                    census = st.prefix_get("census/")
                    owed = {
                        f"census/{k}/r{j}"
                        for k in range(world) for j in range(r + 1)
                    }
                    assert owed <= set(census), (
                        f"shard-fanout census lost keys: "
                        f"{sorted(owed - set(census))}"
                    )
            results[rank] = gathered

        with cf.ThreadPoolExecutor(max_workers=world) as pool:
            for f in [pool.submit(body, rank) for rank in range(world)]:
                f.result(timeout=180)

        for r in range(rounds):
            expect = [(peer, r, b"x" * (peer + 1)) for peer in range(world)]
            for rank in range(world):
                assert results[rank][r] == expect, (
                    f"tree gather diverged at rank {rank} round {r}: "
                    f"{results[rank][r]!r}"
                )
        digest = hashlib.sha256(
            pickle.dumps([results[rank] for rank in range(world)])
        ).hexdigest()
    finally:
        chaos.clear_plan()
        for s in stores:
            s.close()
        clique.close()
    return plan.schedule(), digest


# -- scenario: replicated-clique failover (SIGKILL a shard) ------------------


def scenario_store_failover(seed: int, world: int = 4, shards: int = 3,
                            rounds: int = 6):
    """SIGKILL one shard of a successor-replicated clique mid-barrier-storm,
    then again mid-rendezvous; every store guarantee must survive failover.

    Leg 1 (barrier storm): ``world`` replicated clients run ``rounds`` of
    set + deduped ``add`` + a fresh named barrier per round over a
    ``shards``-wide :class:`SpawnedClique`. The victim is the shard that
    OWNS the seed-chosen mid-storm barrier, SIGKILLed by worker 0 right
    before its own join — the other workers are already parked on the dying
    primary, so their joins must fail over to the successor's mirrored
    arrival ledger. Every barrier must still open exactly once per joiner
    (no double-fires: each client returns from exactly one blocking join),
    the counter must be EXACT (at-most-once dedup composed with the
    double-write), and the final keyspace complete via dead-shard
    absorption on the fan-out read.

    Leg 2 (rendezvous): ``world`` nodes run a store rendezvous over a fresh
    replicated clique with the seeded victim killed while joins are in
    flight; all nodes must land in one round with unique contiguous ranks.

    Returns ``(kill_round, victims, counter, kv_digest, rdzv_outcome)`` —
    all deterministic per seed; the caller runs the scenario twice and
    compares.
    """
    import hashlib
    import pickle
    import random

    from tpu_resiliency_torch.launcher.rendezvous import (
        RendezvousSettings,
        StoreRendezvous,
    )
    from tpu_resiliency_torch.platform import store as store_mod
    from tpu_resiliency_torch.platform.shardstore import SpawnedClique, shard_of
    from tpu_resiliency_torch.utils import events as tpu_events
    from tpu_resiliency_torch.utils.metrics import aggregate

    rng = random.Random(seed)
    kill_round = rng.randrange(1, rounds - 1)
    # The victim is the shard the mid-storm barrier hashes to, so the
    # parked-join failover path is exercised on EVERY seed (which shard that
    # is still varies with the seeded round choice).
    victim_storm = shard_of(f"fo/storm-{kill_round}", shards)
    victim_rdzv = rng.randrange(shards)
    seen: list = []
    tpu_events.add_sink(seen.append)

    clique = SpawnedClique(shards)
    stores: list = []
    try:
        def body(w: int):
            st = clique.client(prefix="fo/", timeout=60.0,
                               connect_retries=3, retry_budget=1.0,
                               replicate=True)
            stores.append(st)
            for r in range(rounds):
                st.set(f"w{w}/k{r}", (w, r))
                st.add("counter", 1)
                if w == 0 and r == kill_round:
                    # Give peers time to park on this round's barrier, then
                    # SIGKILL its owning shard mid-round.
                    time.sleep(0.3)
                    clique.procs[victim_storm].kill()
                st.barrier(f"storm-{r}", w, world, timeout=120.0)

        with cf.ThreadPoolExecutor(max_workers=world) as pool:
            for f in [pool.submit(body, w) for w in range(world)]:
                f.result(timeout=240)

        probe = clique.client(prefix="fo/", timeout=60.0,
                              connect_retries=3, retry_budget=1.0,
                              replicate=True)
        stores.append(probe)
        counter = probe.get("counter", timeout=10.0)
        assert counter == world * rounds, (
            f"counter diverged through failover: {counter} != {world * rounds}"
            f" (a failed-over add double- or under-applied)"
        )
        data = probe.prefix_get("")
        for w in range(world):
            for r in range(rounds):
                assert data.get(f"w{w}/k{r}") == (w, r), (
                    f"key w{w}/k{r} lost through failover: "
                    f"{data.get(f'w{w}/k{r}')!r}"
                )
        kv_digest = hashlib.sha256(
            pickle.dumps(sorted(
                (k, v) for k, v in data.items() if k != "counter"
            ))
        ).hexdigest()
        fo = [e for e in seen if e.kind == "store_failover"]
        assert fo, "SIGKILLed shard produced no store_failover events"
        outcomes = {e.payload.get("outcome") for e in fo}
        assert "barrier" in outcomes, (
            f"parked joins on the dead barrier shard never failed over "
            f"(outcomes {sorted(outcomes)})"
        )
        prom = aggregate(
            [{"kind": e.kind, **e.payload} for e in seen]
        ).to_prometheus()
        assert "tpu_store_failover_total" in prom, prom[:2000]
    finally:
        for s in stores:
            try:
                s.close()
            except Exception:
                pass
        for h, p in clique.endpoints:
            store_mod._breaker_clear(h, p)
        clique.close()

    # -- leg 2: SIGKILL mid-rendezvous --------------------------------------
    clique2 = SpawnedClique(shards)
    stores2: list = []
    outs: dict = {}
    try:
        def join(i: int):
            st = clique2.client(prefix="rdzv/", timeout=60.0,
                                connect_retries=3, retry_budget=1.0,
                                replicate=True)
            stores2.append(st)
            rdzv = StoreRendezvous(st, f"n{i}", RendezvousSettings(
                min_nodes=world, max_nodes=world, join_timeout=120.0,
                last_call_timeout=0.3, keep_alive_interval=0.1,
                keep_alive_timeout=5.0, poll_interval=0.05,
            ))
            outs[f"n{i}"] = rdzv.next_round()
            rdzv.stop_keepalive()

        threads = [threading.Thread(target=join, args=(i,))
                   for i in range(world)]
        for t in threads:
            t.start()
            time.sleep(0.05)
        time.sleep(0.1)  # joins in flight
        clique2.procs[victim_rdzv].kill()
        for t in threads:
            t.join(180.0)
        assert len(outs) == world, (
            f"rendezvous lost nodes through failover: {sorted(outs)}"
        )
        rounds_seen = sorted({o.round for o in outs.values()})
        assert len(rounds_seen) == 1, f"split-brain rounds: {rounds_seen}"
        assert not any(o.is_spare for o in outs.values())
        ranks = sorted(o.node_rank for o in outs.values())
        assert ranks == list(range(world)), (
            f"failover broke rank assignment: {ranks}"
        )
        rdzv_outcome = (sorted(outs), world, rounds_seen)
    finally:
        for s in stores2:
            try:
                s.close()
            except Exception:
                pass
        for h, p in clique2.endpoints:
            store_mod._breaker_clear(h, p)
        clique2.close()
        tpu_events.remove_sink(seen.append)
    return (kill_round, (victim_storm, victim_rdzv), counter, kv_digest,
            rdzv_outcome)


# -- scenario: clique replication -------------------------------------------

#: Send-side faults are retried by the sender and MUST converge; a recv-side
#: payload truncation is silent loss from the sender's view (it already
#: completed) and legitimately degrades the peer instead — that path is
#: covered by tests/checkpoint/test_replication_chaos.py, not this
#: convergence scenario.
REPL_SPEC = (
    "{seed}:p2p.send.reset@at=2;p2p.send.truncate@at=7;p2p.connect.reset@at=5"
)


def scenario_replication(seed: int, world: int = 3, mb: int = 1,
                         spec: str | None = None):
    plan = chaos.ChaosPlan.parse(spec or REPL_SPEC.format(seed=seed))
    chaos.install_plan(plan)
    srv = KVServer(host="127.0.0.1", port=0)
    stores = []
    payloads = {
        r: bytes(bytearray((r * 7 + i) % 251 for i in range(mb << 20)))
        for r in range(world)
    }
    try:
        def mk():
            s = CoordStore("127.0.0.1", srv.port, timeout=60.0)
            stores.append(s)
            return s

        def body(rank: int):
            comm = StoreComm(mk(), rank, list(range(world)), timeout=60.0)
            ex = PeerExchange(mk(), rank, timeout=30.0)
            ex.start()
            try:
                strat = CliqueReplicationStrategy(
                    comm, ex, replication_jump=1, replication_factor=world
                )
                held = strat.replicate(payloads[rank])
                assert not strat.last_degraded, (
                    f"rank {rank}: peers {strat.last_degraded} degraded — "
                    f"retries should have absorbed this plan's faults"
                )
                for owner, blob in held.items():
                    assert bytes(blob) == payloads[owner], (
                        f"rank {rank}: mirror of {owner} not byte-identical"
                    )
                # Retrieval: rank 0 pretends it lost its own shard; a clique
                # holder must route it back intact.
                needed = 0 if rank == 0 else None
                held_owners = set(held) - ({0} if rank == 0 else set())
                blob = strat.retrieve(
                    needed, held_owners, get_blob=lambda o: bytes(held[o])
                )
                if rank == 0:
                    assert blob is not None and bytes(blob) == payloads[0], (
                        "retrieved shard not byte-identical"
                    )
                return set(held)
            finally:
                ex.close()

        with cf.ThreadPoolExecutor(max_workers=world) as pool:
            helds = [
                f.result(timeout=180)
                for f in [pool.submit(body, r) for r in range(world)]
            ]
        for rank, held in enumerate(helds):
            assert held == set(range(world)), (rank, held)
    finally:
        chaos.clear_plan()
        for s in stores:
            s.close()
        srv.close()
    return plan.schedule()


# -- scenario: disk integrity + recovery ladder ------------------------------

#: Corrupt rank 0's OWN copy of its iteration-2 shard at write time; the
#: clique mirror in r1's dir (same filename, different holder dir) stays
#: intact, so load() must recover via peer retrieve.
DISK_SPEC_OWN = "{seed}:disk.write.bitflip@peer=r0/iter_0000002_0_local.ckpt"
#: Corrupt BOTH copies (own shard and the r1-held mirror): the only rung left
#: is the group-agreed fallback to iteration 1.
DISK_SPEC_BOTH = (
    DISK_SPEC_OWN + ";disk.write.bitflip@peer=r1/iter_0000002_0_local.ckpt"
)


def scenario_disk(seed: int, fallback: bool = False, spec: str | None = None):
    """Seeded disk corruption of rank 0's newest shard under real saves, then
    a collective ``load()`` exercising the recovery ladder end to end.
    Returns the injection schedule; raises on any divergence from the
    expected recovery (byte-identical peer retrieve, or group-agreed
    fallback when the replica is corrupt too)."""
    import shutil
    import numpy as np

    from tpu_resiliency_torch.checkpoint.local_manager import LocalCheckpointManager
    from tpu_resiliency_torch.checkpoint.state_dict import PyTreeStateDict
    from tpu_resiliency_torch.utils import events as tpu_events
    from tpu_resiliency_torch.utils.metrics import aggregate

    world = 2
    plan = chaos.ChaosPlan.parse(
        spec or (DISK_SPEC_BOTH if fallback else DISK_SPEC_OWN).format(seed=seed)
    )
    chaos.install_plan(plan)
    seen: list = []
    tpu_events.add_sink(seen.append)
    srv = KVServer(host="127.0.0.1", port=0)
    root = tempfile.mkdtemp(prefix="chaos_disk.")
    stores: list = []

    def mk():
        s = CoordStore("127.0.0.1", srv.port, timeout=30.0)
        stores.append(s)
        return s

    def tree(rank: int, it: int):
        return {"w": np.full((2048,), rank * 10.0 + it, np.float32), "step": it}

    def body(rank: int, gen: int, do_save: bool):
        comm = StoreComm(mk(), rank, list(range(world)), timeout=60.0,
                         generation=gen)
        ex = PeerExchange(mk(), rank, timeout=30.0)
        ex.start()
        try:
            strat = CliqueReplicationStrategy(
                comm, ex, replication_jump=1, replication_factor=world
            )
            mgr = LocalCheckpointManager(
                root, rank=rank, comm=comm, replication=strat, keep=2
            )
            if do_save:
                # Materialized saves: deterministic per-file write sequences,
                # which is what makes the injection schedule reproducible.
                mgr.save(1, PyTreeStateDict(tree(rank, 1)), is_async=False)
                mgr.save(2, PyTreeStateDict(tree(rank, 2)), is_async=False)
            it_loaded, tensors = None, None
            if not do_save:
                hollow, tensors, meta = mgr.load()
                it_loaded = meta["iteration"]
                tensors = np.asarray(tensors[0]).copy()
            mgr.close()
            return it_loaded, tensors
        finally:
            ex.close()

    try:
        with cf.ThreadPoolExecutor(max_workers=world) as pool:
            for f in [pool.submit(body, r, 0, True) for r in range(world)]:
                f.result(timeout=120)
        with cf.ThreadPoolExecutor(max_workers=world) as pool:
            loaded = [
                f.result(timeout=120)
                for f in [pool.submit(body, r, 1, False) for r in range(world)]
            ]
        want_iter = 1 if fallback else 2
        for rank, (it, w) in enumerate(loaded):
            assert it == want_iter, (
                f"rank {rank} resumed from iteration {it}, wanted {want_iter} "
                f"(ladder {'fallback' if fallback else 'peer retrieve'} failed)"
            )
            expect = np.full((2048,), rank * 10.0 + want_iter, np.float32)
            assert np.array_equal(w, expect), (
                f"rank {rank}: recovered tree not byte-identical @ iter {it}"
            )
        quarantined = [e for e in seen if e.kind == "ckpt_quarantined"]
        assert quarantined, "corrupt shard was never quarantined"
        rdir = os.path.join(root, "s0", "r0")
        assert any(".corrupt" in n for n in os.listdir(rdir)), (
            "no *.corrupt forensics file in the holder dir"
        )
        if fallback:
            assert any(e.kind == "ckpt_fallback" for e in seen), (
                "group never recorded the fallback decision"
            )
        # The acceptance surface: the same aggregation the metrics-dump CLI
        # runs must show the integrity counters.
        reg = aggregate([{"kind": e.kind, **e.payload} for e in seen])
        prom = reg.to_prometheus()
        assert "tpu_ckpt_integrity_failures_total" in prom, prom[:2000]
        assert 'kind="ckpt_quarantined"' in prom, prom[:2000]
        _assert_byteflow_accounts(seen)
    finally:
        chaos.clear_plan()
        tpu_events.remove_sink(seen.append)
        for s in stores:
            s.close()
        srv.close()
        shutil.rmtree(root, ignore_errors=True)
    return plan.schedule()


# -- scenario: checkpoint byte-economy (erasure + delta) ----------------------

#: Transient network pressure rides along (sender-retried, MUST converge);
#: the coding-specific faults (holder death, parity bitflip, chain break)
#: are seeded below with identities derived from the same seed.
CODING_SPEC = "{seed}:p2p.send.reset@at=2;store.send.reset@at=9"


def scenario_coding(seed: int, spec: str | None = None):
    """The byte-economy plane's fault campaign, three chained phases:

    1. a 4-rank erasure clique (k=2, parity 2) saves two iterations under a
       seeded network plan (sender-retried — the saves must converge);
    2. the seed picks a victim rank (death: disk wiped), one of its block
       HOLDERS loses the victim's newest block (holder died mid-save), and
       another holder's block takes a seeded BITFLIP — the surviving block
       census still reads reconstructible (2 of k=2 listed), so the ladder
       ATTEMPTS the reconstruction and must fail CLOSED on the corrupt
       block (no false-positive container), then the group agrees the
       fallback to the previous iteration, which reconstructs from ITS
       (intact) parity blocks byte-identically;
    3. a 2-rank delta chain (keyframe + chunk-diff rounds) where the seeded
       rank misses the base container — the next delta apply must drop that
       mirror with ``ckpt_delta_applied{broken}`` while the save and a
       subsequent load stay healthy.

    Returns ``(injection_schedule, victim, dead_holder, flip_holder,
    flip_offset, chain_breaker, fallback_iteration)`` — the whole tuple must
    reproduce run-to-run per seed."""
    import shutil

    import numpy as np

    from tpu_resiliency_torch.checkpoint.coding import ErasureReplicationStrategy
    from tpu_resiliency_torch.checkpoint.local_manager import LocalCheckpointManager
    from tpu_resiliency_torch.checkpoint.state_dict import PyTreeStateDict
    from tpu_resiliency_torch.utils import events as tpu_events
    from tpu_resiliency_torch.utils.metrics import aggregate

    world = 4
    plan = chaos.ChaosPlan.parse((spec or CODING_SPEC).format(seed=seed))
    chaos.install_plan(plan)
    rng = np.random.default_rng(seed)
    victim = int(rng.integers(world))
    others = [r for r in range(world) if r != victim]
    dead_holder = others[int(rng.integers(len(others)))]
    flip_holder = [r for r in others if r != dead_holder][
        int(rng.integers(len(others) - 1))
    ]
    seen: list = []
    tpu_events.add_sink(seen.append)
    srv = KVServer(host="127.0.0.1", port=0)
    root = tempfile.mkdtemp(prefix="chaos_coding.")
    droot = tempfile.mkdtemp(prefix="chaos_coding_delta.")
    stores: list = []

    def mk():
        s = CoordStore("127.0.0.1", srv.port, timeout=30.0)
        stores.append(s)
        return s

    def tree(rank: int, it: int):
        return {"w": np.full((65536,), rank * 100.0 + it, np.float32),
                "step": it}

    def ec_body(rank: int, gen: int, do_save: bool, wipe: bool):
        comm = StoreComm(mk(), rank, list(range(world)), timeout=60.0,
                         generation=gen)
        ex = PeerExchange(mk(), rank, timeout=30.0)
        ex.start()
        try:
            strat = ErasureReplicationStrategy(
                comm, ex, replication_jump=1, replication_factor=world,
                parity=2,
            )
            mgr = LocalCheckpointManager(
                root, rank=rank, comm=comm, replication=strat, keep=2
            )
            if wipe:
                mgr.wipe()
            if do_save:
                mgr.save(1, PyTreeStateDict(tree(rank, 1)), is_async=False)
                mgr.save(2, PyTreeStateDict(tree(rank, 2)), is_async=False)
                mgr.close()
                return None
            hollow, tensors, meta = mgr.load()
            it = meta["iteration"]
            w = np.asarray(tensors[0]).copy()
            mgr.close()
            return it, w
        finally:
            ex.close()

    flip_offset = None
    chain_breaker = int(rng.integers(2))
    try:
        # Phase 1: erasure saves under the network plan.
        with cf.ThreadPoolExecutor(max_workers=world) as pool:
            for f in [pool.submit(ec_body, r, 0, True, False)
                      for r in range(world)]:
                f.result(timeout=120)
        # Phase 2: victim dies; one of its iter-2 block holders died
        # mid-save (block file gone), the other's block takes a bitflip.
        def block_path(holder: int, it: int):
            d = os.path.join(root, "s0", f"r{holder}")
            names = [
                n for n in os.listdir(d)
                if n.startswith(f"iter_{it:07d}_{victim}_b")
                and n.endswith(".ecblk")
            ]
            assert len(names) == 1, names
            return os.path.join(d, names[0])

        os.unlink(block_path(dead_holder, 2))
        fpath = block_path(flip_holder, 2)
        blob = bytearray(open(fpath, "rb").read())
        flip_offset = int(rng.integers(len(blob) - 64, len(blob)))
        blob[flip_offset] ^= 0x40
        open(fpath, "wb").write(bytes(blob))
        with cf.ThreadPoolExecutor(max_workers=world) as pool:
            loaded = [
                f.result(timeout=120)
                for f in [pool.submit(ec_body, r, 1, False, r == victim)
                          for r in range(world)]
            ]
        for rank, (it, w) in enumerate(loaded):
            assert it == 1, (
                f"rank {rank} resumed from {it}, wanted the agreed fallback 1"
            )
            expect = np.full((65536,), rank * 100.0 + 1, np.float32)
            assert np.array_equal(w, expect), (
                f"rank {rank}: fallback tree not byte-identical"
            )
        recon = [e for e in seen if e.kind == "ckpt_parity_reconstruct"]
        outcomes = [e.payload["outcome"] for e in recon]
        assert "failed" in outcomes and outcomes[-1] == "ok", (
            f"want a failed iter-2 reconstruction then an ok iter-1 one, "
            f"got {outcomes}"
        )
        assert any(e.kind == "ckpt_fallback" for e in seen), (
            "group never agreed the fallback"
        )
        # Phase 3: delta-chain break on a 2-rank mirror clique.
        def delta_body(rank: int):
            comm = StoreComm(mk(), rank, [0, 1], timeout=60.0, generation=9)
            ex = PeerExchange(mk(), rank, timeout=30.0)
            ex.start()
            try:
                strat = CliqueReplicationStrategy(
                    comm, ex, replication_jump=1, replication_factor=2
                )
                mgr = LocalCheckpointManager(
                    droot, rank=rank, comm=comm, replication=strat,
                    keep=2, delta_interval=4,
                )
                mgr.save(1, PyTreeStateDict(tree(rank, 1)), is_async=False)
                comm.barrier("kf")
                if rank == chain_breaker:
                    # This rank missed the keyframe base of its peer.
                    peer = 1 - rank
                    p = os.path.join(
                        droot, "s0", f"r{rank}",
                        f"iter_{1:07d}_{peer}_local.ckpt",
                    )
                    os.unlink(p)
                comm.barrier("broke")
                mgr.save(2, PyTreeStateDict(tree(rank, 2)), is_async=False)
                hollow, tensors, meta = mgr.load()
                it = meta["iteration"]
                mgr.close()
                return it
            finally:
                ex.close()

        with cf.ThreadPoolExecutor(max_workers=2) as pool:
            its = [
                f.result(timeout=120)
                for f in [pool.submit(delta_body, r) for r in range(2)]
            ]
        assert its == [2, 2], its
        broken = [
            e for e in seen
            if e.kind == "ckpt_delta_applied"
            and e.payload["outcome"] == "broken"
        ]
        assert broken and broken[0].payload["owner"] == 1 - chain_breaker, (
            f"want exactly the chain-breaker's peer mirror dropped, got "
            f"{[e.payload for e in broken]}"
        )
        assert any(
            e.kind == "ckpt_delta_applied" and e.payload["outcome"] == "ok"
            for e in seen
        ), "the intact side of the delta round never applied"
        # Acceptance surface: the same aggregation metrics_dump runs.
        reg = aggregate([{"kind": e.kind, **e.payload} for e in seen])
        prom = reg.to_prometheus()
        assert "tpu_ckpt_parity_reconstructions_total" in prom, prom[:2000]
        assert 'outcome="failed"' in prom, prom[:2000]
        assert "tpu_ckpt_delta_applied_total" in prom, prom[:2000]
        assert "tpu_ckpt_parity_bytes_total" in prom, prom[:2000]
        _assert_byteflow_accounts(seen)
    finally:
        chaos.clear_plan()
        tpu_events.remove_sink(seen.append)
        for s in stores:
            s.close()
        srv.close()
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(droot, ignore_errors=True)
    return (
        plan.schedule(), victim, dead_holder, flip_holder, flip_offset,
        chain_breaker, 1,
    )


# -- scenario: elastic shrink / resharded resume / re-expand ------------------

#: A light network plan rides along (sender-retried, MUST converge) so the
#: elastic chain is exercised under the same fault pressure as the others.
#: The second p2p reset (``at=13``) is aimed inside the shrink's parallel
#: ranged-fetch window (the save-phase replication fan-out plus its one
#: retry consume indices 0..9; the concurrent ``fetch_ranges`` traffic owns
#: 10..25), so every soak run proves the degraded-holder re-route under the
#: overlapped serve/fetch pool, not just under serial resharding. Which
#: *thread's* send draws index 13 is racy, but the convergence contract —
#: schedule, victim, and per-rank byte splits — is thread-independent: the
#: splits come from the plan summary, not from who fetched what when.
ELASTIC_SPEC = "{seed}:p2p.send.reset@at=3+13;store.send.reset@at=7"


def scenario_elastic(seed: int, spec: str | None = None):
    """Seeded preemption of one rank mid-run → shrink → resharded resume →
    save at the shrunken layout → re-expand → resharded resume again.

    The seed picks the victim rank. Convergence = every resumed world's
    reassembled global state is byte-identical to what the full world saved,
    the shrink fetched strictly newly-owned ranges (peer bytes < a full
    shard), and the ``tpu_reshard_*`` metrics aggregate from the events
    stream. Returns ``(injection_schedule, victim, per-phase byte splits)`` —
    the whole tuple must reproduce run-to-run per seed."""
    import shutil
    import numpy as np

    from tpu_resiliency_torch.checkpoint import reshard as ckpt_reshard
    from tpu_resiliency_torch.checkpoint.local_manager import LocalCheckpointManager
    from tpu_resiliency_torch.checkpoint.state_dict import PyTreeStateDict
    from tpu_resiliency_torch.utils import events as tpu_events
    from tpu_resiliency_torch.utils.metrics import aggregate

    world = 4
    victim = seed % world
    survivors = [r for r in range(world) if r != victim]
    plan = chaos.ChaosPlan.parse(spec or ELASTIC_SPEC.format(seed=seed))
    chaos.install_plan(plan)
    seen: list = []
    tpu_events.add_sink(seen.append)
    srv = KVServer(host="127.0.0.1", port=0)
    root = tempfile.mkdtemp(prefix="chaos_elastic.")
    stores: list = []

    def mk():
        s = CoordStore("127.0.0.1", srv.port, timeout=30.0)
        stores.append(s)
        return s

    G = np.arange(32 * 8, dtype=np.float32).reshape(32, 8) * 3.0
    layout4 = ckpt_reshard.TreeLayout(
        [("dp", world)], list(range(world)),
        [ckpt_reshard.LeafSpec(G.shape, "float32", ("dp",))],
    )

    def mgr_for(rank, ranks, gen, ex):
        comm = StoreComm(mk(), rank, ranks, timeout=60.0, generation=gen)
        strat = CliqueReplicationStrategy(
            comm, ex, replication_jump=1, replication_factor=2
        )
        return LocalCheckpointManager(
            root, rank=rank, comm=comm, replication=strat, keep=2
        )

    def full_save(rank):
        ex = PeerExchange(mk(), rank, timeout=30.0)
        ex.start()
        try:
            mgr = mgr_for(rank, list(range(world)), 0, ex)
            tree = {"w": ckpt_reshard.slice_local([G], layout4, rank)[0],
                    "step": 1}
            mgr.save(1, PyTreeStateDict(tree), is_async=False, layout=layout4)
            mgr.close()
        finally:
            ex.close()

    def shrink_resume_and_save(rank):
        ex = PeerExchange(mk(), rank, timeout=30.0)
        ex.start()
        try:
            mgr = mgr_for(rank, survivors, 1, ex)
            hollow, tensors, meta = mgr.load_resharded()
            got = np.asarray(tensors[0]).copy()
            layout_m = ckpt_reshard.TreeLayout.from_meta(meta["layout"])
            mgr.save(
                2, PyTreeStateDict({"w": got, "step": 2}),
                is_async=False, layout=layout_m,
            )
            mgr.close()
            return got
        finally:
            ex.close()

    def expand_resume(rank):
        ex = PeerExchange(mk(), rank, timeout=30.0)
        ex.start()
        try:
            mgr = mgr_for(rank, list(range(world)), 2, ex)
            hollow, tensors, meta = mgr.load_resharded()
            got = np.asarray(tensors[0]).copy()
            mgr.close()
            return got, meta["iteration"]
        finally:
            ex.close()

    try:
        with cf.ThreadPoolExecutor(max_workers=world) as pool:
            for f in [pool.submit(full_save, r) for r in range(world)]:
                f.result(timeout=120)
        # The seeded preemption: the victim's node is gone (its disk with it).
        shutil.rmtree(os.path.join(root, "s0", f"r{victim}"), ignore_errors=True)
        with cf.ThreadPoolExecutor(max_workers=len(survivors)) as pool:
            shrunk = [
                f.result(timeout=120)
                for f in [pool.submit(shrink_resume_and_save, r) for r in survivors]
            ]
        layout_m = layout4.retarget(survivors)
        for rank, got in zip(survivors, shrunk):
            want = ckpt_reshard.slice_local([G], layout_m, rank)[0]
            assert np.array_equal(got, want), (
                f"rank {rank}: shrunken resume not byte-identical"
            )
        # Re-expand: the victim returns with a wiped disk; the newest
        # iteration is the SHRUNKEN world's save, so this leg is a true grow.
        with cf.ThreadPoolExecutor(max_workers=world) as pool:
            grown = [
                f.result(timeout=120)
                for f in [pool.submit(expand_resume, r) for r in range(world)]
            ]
        for rank, (got, it) in zip(range(world), grown):
            want = ckpt_reshard.slice_local([G], layout4, rank)[0]
            assert it == 2, f"rank {rank} resumed iteration {it}, wanted 2"
            assert np.array_equal(got, want), (
                f"rank {rank}: re-expanded resume not byte-identical"
            )
        plans = [e for e in seen if e.kind == "reshard_plan"]
        directions = sorted({e.payload["direction"] for e in plans})
        assert directions == ["grow", "shrink"], directions
        fetches = [e for e in seen if e.kind == "reshard_fetch"]
        shard_bytes = layout4.local_nbytes(0, 0)
        shrink_peer = sum(
            e.payload["bytes"] for e in fetches
            if e.payload.get("via") == "peer"
            and any(p.payload["direction"] == "shrink"
                    and p.payload["rank"] == e.payload["rank"] for p in plans)
        )
        assert 0 < shrink_peer < len(survivors) * shard_bytes, (
            f"shrink moved {shrink_peer} peer bytes (full shard is "
            f"{shard_bytes}) — the ranged path should move strictly less "
            f"than whole mirrors"
        )
        reg = aggregate([{"kind": e.kind, **e.payload} for e in seen])
        prom = reg.to_prometheus()
        for want in ("tpu_reshard_bytes_total", "tpu_reshard_ranks_total",
                     'direction="shrink"', 'direction="grow"'):
            assert want in prom, f"{want} missing:\n{prom[:2000]}"
        splits = sorted(
            (e.payload["rank"], e.payload["direction"],
             e.payload["local_bytes"], e.payload["peer_bytes"])
            for e in plans
        )
        # The mid-fetch reset must have been consumed inside the reshard
        # window AND recovered from: either the sender-side retry absorbed it
        # (a ``p2p_retry`` per reset) or the requester saw the torn reply and
        # re-routed around the degraded holder (``ckpt_integrity_failure``
        # with stage="reshard-fetch"). Both are convergent; neither may be
        # silent.
        p2p_resets = [e for e in seen if e.kind == "chaos_inject"
                      and e.payload["channel"] == "p2p"
                      and e.payload["op"] == "send"]
        assert len(p2p_resets) >= 2, (
            f"expected both seeded p2p resets to fire, saw "
            f"{[(e.payload['op'], e.payload['index']) for e in p2p_resets]}"
        )
        recovered = [e for e in seen if e.kind == "p2p_retry"] + [
            e for e in seen if e.kind == "ckpt_integrity_failure"
            and e.payload.get("stage") == "reshard-fetch"
        ]
        assert len(recovered) >= len(p2p_resets), (
            f"{len(p2p_resets)} p2p resets but only {len(recovered)} "
            f"recovery artifacts — a fault was swallowed without re-route"
        )
        _assert_byteflow_accounts(seen)
    finally:
        chaos.clear_plan()
        tpu_events.remove_sink(seen.append)
        for s in stores:
            s.close()
        srv.close()
        shutil.rmtree(root, ignore_errors=True)
    return (plan.schedule(), victim, splits)


# -- scenario: mixed multi-fault campaign ------------------------------------

#: Straggler + network + disk in ONE campaign: resets on the store and p2p
#: channels while the ranks coordinate, a bitflip landing on rank 0's newest
#: shard DURING the active save, and an injected straggler report stream
#: driving the policy → remediation loop — the scenario-diversity flagship
#: (ROADMAP item 5). Network faults ride connect/send, the retried-and-MUST-
#: converge side (REPL_SPEC's comment explains why recv-side loss is a
#: degrade path, excluded from convergence scenarios).
MIXED_SPEC = (
    "{seed}:store.connect.reset@at=2;p2p.send.reset@at=2;"
    "disk.write.bitflip@peer=r0/iter_0000002_0_local.ckpt"
)


def _synthetic_report(perf: dict):
    from tpu_resiliency_torch.telemetry.reporting import Report

    return Report(
        rank=0, world_size=len(perf), iteration=0, section_names=("step",),
        relative_section_scores={"step": 1.0},
        individual_section_scores={"step": 1.0},
        perf_scores=dict(perf), z_scores={r: 0.0 for r in perf},
        ewma_scores=dict(perf),
    )


def scenario_mixed(seed: int, workdir: str, spec: str | None = None):
    """Multi-fault campaign with the incident plane watching. Asserts the
    full detect→decide→act→recover chain lands in an incident artifact that
    ``incident_report`` accepts, that recovery still converges byte-identical
    under the combined faults, and that the ``tpu_incident_*`` /
    ``tpu_remediation_actions_total`` metrics are visible through the same
    aggregation ``metrics_dump`` runs. Returns the injection schedule."""
    import shutil
    import numpy as np

    from tpu_resiliency_torch.checkpoint.local_manager import LocalCheckpointManager
    from tpu_resiliency_torch.checkpoint.state_dict import PyTreeStateDict
    from tpu_resiliency_torch.launcher.incident import IncidentEngine, read_incident
    from tpu_resiliency_torch.telemetry.policy import HealthVectorPolicy
    from tpu_resiliency_torch.telemetry.remediation import RemediationEngine
    from tpu_resiliency_torch.tools import incident_report
    from tpu_resiliency_torch.utils import events as tpu_events
    from tpu_resiliency_torch.utils import flight_recorder
    from tpu_resiliency_torch.utils.metrics import aggregate

    world = 2
    os.makedirs(workdir, exist_ok=True)
    events_file = os.path.join(workdir, "events.jsonl")
    incidents_dir = os.path.join(workdir, "incidents")
    ckpt_root = os.path.join(workdir, "ckpt")
    for stale in (events_file,):
        if os.path.exists(stale):
            os.unlink(stale)
    shutil.rmtree(incidents_dir, ignore_errors=True)
    shutil.rmtree(ckpt_root, ignore_errors=True)

    plan = chaos.ChaosPlan.parse(spec or MIXED_SPEC.format(seed=seed))
    chaos.install_plan(plan)
    seen: list = []
    jsonl = tpu_events.JsonlSink(events_file)
    tpu_events.add_sink(seen.append)
    tpu_events.add_sink(jsonl)
    flight_recorder.install(incidents_dir, capacity=64, install_handlers=False)
    engine = IncidentEngine(
        incidents_dir, node_id="mixed", auto_open=True, events_file=events_file
    )
    engine.attach()
    srv = KVServer(host="127.0.0.1", port=0)
    stores: list = []

    def mk():
        s = CoordStore("127.0.0.1", srv.port, timeout=30.0)
        stores.append(s)
        return s

    def tree(rank: int, it: int):
        return {"w": np.full((2048,), rank * 10.0 + it, np.float32), "step": it}

    def body(rank: int, gen: int, do_save: bool):
        comm = StoreComm(mk(), rank, list(range(world)), timeout=60.0,
                         generation=gen)
        ex = PeerExchange(mk(), rank, timeout=30.0)
        ex.start()
        try:
            strat = CliqueReplicationStrategy(
                comm, ex, replication_jump=1, replication_factor=world
            )
            mgr = LocalCheckpointManager(
                ckpt_root, rank=rank, comm=comm, replication=strat, keep=2
            )
            if do_save:
                mgr.save(1, PyTreeStateDict(tree(rank, 1)), is_async=False)
                mgr.save(2, PyTreeStateDict(tree(rank, 2)), is_async=False)
            it_loaded, tensors = None, None
            if not do_save:
                hollow, tensors, meta = mgr.load()
                it_loaded = meta["iteration"]
                tensors = np.asarray(tensors[0]).copy()
            mgr.close()
            return it_loaded, tensors
        finally:
            ex.close()

    try:
        # Phase 1: the straggler leg — synthetic slow-rank reports drive the
        # policy into remediation (proactive checkpoint + exclude), then clean
        # reports recover it; the incident engine auto-opens and auto-closes.
        ckpt_calls: list = []
        remediation = RemediationEngine(
            checkpoint_fn=lambda: ckpt_calls.append(1),
            publish_degraded_fn=lambda d: None,
        )
        policy = HealthVectorPolicy(patience=2, recovery=1, sinks=[remediation])
        policy.observe(_synthetic_report({0: 1.0, 1: 0.3}))
        policy.observe(_synthetic_report({0: 1.0, 1: 0.3}))
        assert engine.is_open, "straggler incident never opened"
        policy.observe(_synthetic_report({0: 1.0, 1: 0.99}))
        assert not engine.is_open, "straggler incident never auto-closed"
        assert ckpt_calls, "remediation never ran the proactive checkpoint"
        assert ("exclude", "ok") in remediation.history, remediation.history

        # Phase 2: saves under the store-reset + disk-bitflip plan (the flip
        # lands mid-save on rank 0's newest shard), then a collective load
        # climbing the recovery ladder — this is its own incident.
        with cf.ThreadPoolExecutor(max_workers=world) as pool:
            for f in [pool.submit(body, r, 0, True) for r in range(world)]:
                f.result(timeout=120)
        with cf.ThreadPoolExecutor(max_workers=world) as pool:
            loaded = [
                f.result(timeout=120)
                for f in [pool.submit(body, r, 1, False) for r in range(world)]
            ]
        for rank, (it, w) in enumerate(loaded):
            assert it == 2, f"rank {rank} resumed from {it}, wanted 2"
            expect = np.full((2048,), rank * 10.0 + 2, np.float32)
            assert np.array_equal(w, expect), (
                f"rank {rank}: recovered tree not byte-identical under "
                f"mixed faults"
            )
        assert engine.is_open, "quarantine incident never opened"
        engine.close(outcome="recovered")

        assert len(engine.artifacts) >= 2, engine.artifacts
        import contextlib
        import io

        for path in engine.artifacts:
            doc = read_incident(path)
            with contextlib.redirect_stdout(io.StringIO()):
                assert incident_report.main([path]) == 0, path
        straggler_doc = read_incident(engine.artifacts[0])
        phases = [m["phase"] for m in straggler_doc["chain"]]
        for p in ("detect", "decide", "act", "recover"):
            assert p in phases, (p, phases)
        assert straggler_doc["slo"]["time_to_detect_s"] is not None
        assert straggler_doc["slo"]["time_to_recover_s"] is not None

        # The acceptance surface: the same aggregation metrics_dump runs.
        reg = aggregate(read_events(events_file))
        prom = reg.to_prometheus()
        for want in (
            "tpu_incidents_total", "tpu_incident_time_to_recover_seconds",
            "tpu_remediation_actions_total", 'kind="bitflip"',
        ):
            assert want in prom, f"{want} missing from metrics:\n{prom[:2000]}"

        # Goodput attribution: the campaign's incident windows must be
        # charged to the ``incident`` phase by the same ledger the launcher's
        # /goodput endpoint and metrics_dump --goodput run.
        from tpu_resiliency_torch.utils.goodput import GoodputLedger

        ledger = GoodputLedger()
        ledger.observe_many(read_events(events_file))
        gp = ledger.summary()
        assert gp["phases"]["incident"] > 0, (
            f"mixed campaign charged no incident time: {gp['phases']}"
        )
        assert abs(sum(gp["phases"].values()) - gp["wall_clock_s"]) < 1e-3, gp
    finally:
        chaos.clear_plan()
        engine.detach()
        flight_recorder.uninstall()
        tpu_events.remove_sink(seen.append)
        tpu_events.remove_sink(jsonl)
        jsonl.close()
        for s in stores:
            s.close()
        srv.close()
    return plan.schedule()


# -- scenario: launcher restart chain ---------------------------------------

LAUNCHER_SPEC = (
    "{seed}:store.send.reset@at=3;store.send.truncate@at=9;"
    "ipc.send.reset@at=1;ipc.send.truncate@at=4"
)

_WORKER = textwrap.dedent(
    """
    import os, sys, time
    from tpu_resiliency_torch.watchdog import RankMonitorClient

    rnd = int(os.environ["TPU_FT_RESTART_COUNT"])
    c = RankMonitorClient()
    c.init_workload_monitoring()
    for _ in range(4):
        c.send_heartbeat()
        time.sleep(0.05)
    c.shutdown_workload_monitoring()
    if rnd == 0:
        sys.exit(3)
    print("recovered in round", rnd)
    """
)


def scenario_launcher(seed: int, workdir: str, timeout: float = 180.0):
    """Real restart chain under env-propagated chaos. Returns per-channel
    ``{(channel, fault): count}`` observed in the events stream."""
    os.makedirs(workdir, exist_ok=True)
    script = os.path.join(workdir, "worker.py")
    with open(script, "w") as f:
        f.write(_WORKER)
    events_file = os.path.join(workdir, "events.jsonl")
    env = dict(os.environ)
    repo = REPO_ROOT
    env.update(
        JAX_PLATFORMS="cpu",
        TPU_RESILIENCY_CHAOS=LAUNCHER_SPEC.format(seed=seed),
        TPU_RESILIENCY_EVENTS_FILE=events_file,
        PYTHONPATH=repo + os.pathsep + env.get("PYTHONPATH", ""),
    )
    cmd = [
        sys.executable, "-m", "tpu_resiliency_torch.launcher.launch",
        "--standalone", "--nproc-per-node", "1", "--max-restarts", "3",
        "--rdzv-last-call", "0.2", "--monitor-interval", "0.1",
        "--ft-param-initial_rank_heartbeat_timeout", "30",
        "--ft-param-rank_heartbeat_timeout", "30",
        "--run-dir", os.path.join(workdir, "run"),
        script,
    ]
    r = subprocess.run(
        cmd, capture_output=True, text=True, timeout=timeout, env=env, cwd=workdir
    )
    assert r.returncode == 0, (
        f"launcher chain under chaos failed rc={r.returncode}\n"
        f"stdout: {r.stdout[-2000:]}\nstderr: {r.stderr[-2000:]}"
    )
    assert "recovered in round" in r.stdout, r.stdout[-2000:]
    injected: dict[tuple, int] = {}
    for ev in read_events(events_file):
        if ev.get("kind") == "chaos_inject":
            key = (ev.get("channel"), ev.get("fault"))
            injected[key] = injected.get(key, 0) + 1
    for want in (
        ("store", "reset"), ("store", "truncate"),
        ("ipc", "reset"), ("ipc", "truncate"),
    ):
        assert injected.get(want, 0) >= 1, (
            f"fault {want} never injected — the channel survived nothing; "
            f"observed: {injected}"
        )
    return injected


# -- scenario: hang forensics ------------------------------------------------

_HANG_WORKER = textwrap.dedent(
    """
    import importlib, json, os, sys, threading, time
    from tpu_resiliency_torch.platform.store import CoordStore
    from tpu_resiliency_torch.utils import location
    from tpu_resiliency_torch.utils.events import record
    from tpu_resiliency_torch.watchdog.monitor_client import RankMonitorClient

    inj = importlib.import_module("tpu_resiliency_torch.inprocess.tools.inject_fault")
    inj.GIL_SLEEP_CHUNK_S = 2.0

    victim = int(sys.argv[1])
    rank = int(os.environ["RANK"])
    rnd = int(os.environ["TPU_FT_RESTART_COUNT"])

    client = RankMonitorClient()
    client.init_workload_monitoring()

    def beats():
        while True:
            try:
                client.send_heartbeat()
            except Exception:
                return
            time.sleep(0.2)

    threading.Thread(target=beats, daemon=True).start()
    store = CoordStore(
        os.environ["TPU_RESILIENCY_STORE_HOST"],
        int(os.environ["TPU_RESILIENCY_STORE_PORT"]), prefix="hangsoak/",
    )
    for i in range(2):
        location.note_step(i)
        record("inprocess", "iteration_start", iteration=i)
        store.barrier(f"step-{rnd}-{i}", rank, 2, timeout=60.0)

    if rnd == 0:
        if rank == victim:
            client.start_section("step")
            inj.inject_fault(inj.Fault.GIL_SLEEP, duration=60.0)
            sys.exit(0)
        try:
            store.barrier("stall", rank, 2, timeout=120.0)
        except Exception:
            pass
        time.sleep(120)
        sys.exit(0)
    print("recovered in round", rnd)
    """
)


def scenario_hang(seed: int, workdir: str, timeout: float = 180.0):
    """Seeded stall -> detection -> stack capture -> kill ladder -> restart.

    The seed picks the victim rank; the schedule compared across the two
    per-seed runs is the deterministic forensics chain (victim, detection
    kind, ladder steps, recovery round). The last good ``/hangz`` census is
    saved to ``<workdir>/hangz.json`` so downstream smoke legs can grep the
    live view the operator would have seen.
    """
    import urllib.request

    os.makedirs(workdir, exist_ok=True)
    victim = seed % 2
    script = os.path.join(workdir, "worker.py")
    with open(script, "w") as f:
        f.write(_HANG_WORKER)
    events_file = os.path.join(workdir, "events.jsonl")
    for stale in (events_file, os.path.join(workdir, "hangz.json")):
        if os.path.exists(stale):
            os.unlink(stale)
    env = dict(os.environ)
    repo = REPO_ROOT
    env.update(
        JAX_PLATFORMS="cpu",
        TPU_RESILIENCY_EVENTS_FILE=events_file,
        PYTHONPATH=repo + os.pathsep + env.get("PYTHONPATH", ""),
    )
    run_dir = os.path.join(workdir, "run")
    out_path = os.path.join(workdir, "launcher.out")
    cmd = [
        sys.executable, "-m", "tpu_resiliency_torch.launcher.launch",
        "--standalone", "--nproc-per-node", "2", "--max-restarts", "2",
        "--rdzv-last-call", "0.2", "--monitor-interval", "0.1",
        "--telemetry-port", "0",
        "--ft-param-initial_rank_heartbeat_timeout", "15",
        "--ft-param-rank_heartbeat_timeout", "1.0",
        "--ft-param-workload_check_interval", "0.25",
        "--ft-param-stack_dump_grace", "5.0",
        "--run-dir", run_dir,
        "--incidents-dir", os.path.join(workdir, "incidents"),
        script, str(victim),
    ]
    # File-backed stdio: monitors/workers inherit these fds, so pipes would
    # deadlock once full and never EOF while any child lives.
    with open(out_path, "w") as out:
        proc = subprocess.Popen(
            cmd, stdout=out, stderr=subprocess.STDOUT, env=env, cwd=workdir
        )
    hangz = None
    try:
        port_file = os.path.join(run_dir, "telemetry.port")
        deadline = time.time() + 60
        while not os.path.exists(port_file) and time.time() < deadline:
            assert proc.poll() is None, open(out_path).read()[-2000:]
            time.sleep(0.2)
        port = int(open(port_file).read().strip())
        deadline = time.time() + 90
        while time.time() < deadline and proc.poll() is None:
            try:
                doc = json.loads(urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/hangz", timeout=5).read())
            except OSError:
                time.sleep(0.2)
                continue
            if any(s.get("rank") == victim for s in doc.get("suspects", [])):
                hangz = doc
                break
            time.sleep(0.2)
        assert hangz is not None, "/hangz never named the seeded victim"
        with open(os.path.join(workdir, "hangz.json"), "w") as f:
            json.dump(hangz, f, indent=2)
        rc = proc.wait(timeout=timeout)
        assert rc == 0, f"hang chain rc={rc}\n" + open(out_path).read()[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    # -- the deterministic schedule ---------------------------------------
    evs = read_events(events_file)
    hangs = [e for e in evs if e.get("kind") == "hang_detected"]
    assert len(hangs) == 1 and hangs[0].get("global_rank") == victim, hangs
    assert "last seen in" in hangs[0].get("reason", ""), hangs[0]
    ladder = tuple(
        e.get("step") for e in evs
        if e.get("kind") == "kill_ladder" and e.get("global_rank") == victim
    )
    # Two capture paths race inside the victim (monitor long-poll vs SIGUSR1
    # nudge); under GIL starvation either may be the one that lands before
    # SIGKILL — any victim capture satisfies the contract.
    victim_dumped = any(
        e.get("kind") == "stack_dump" and e.get("rank") == victim
        for e in evs
    )
    assert victim_dumped, "victim never captured a stack dump"
    census_evs = [e for e in evs if e.get("kind") == "hang_census"]
    assert census_evs and any(
        s.get("rank") == victim for s in (census_evs[0].get("suspects") or [])
    ), census_evs
    recovered = max(
        (e.get("round", 0) for e in evs if e.get("kind") == "round_succeeded"),
        default=None,
    )
    assert recovered is not None, "no successful round after the hang"
    return (victim, ladder, recovered)


# -- scenario: goodput-optimal autoscale under fluctuating capacity -----------

#: The disk fault both arms pay identically: a seeded bitflip on the newest
#: proactive-checkpoint container, forcing the quarantine→fallback ladder.
AUTOSCALE_DISK_SPEC = "{seed}:disk.write.bitflip@peer=r0/iter_0000002_0_local.ckpt"


class _AutoscaleSim:
    """A miniature 4-rank job on real wall clock: iteration_start markers at a
    step cadence that the injected conditions (straggler slowdown, restarts,
    resharding stalls) modulate, so the goodput ledger measures the campaign
    exactly as it measures a real run. Record shape = the events JSONL line."""

    STEP_S = 0.02
    WARM_RESTART_S = 0.06
    COLD_RESTART_S = 0.5
    RESHARD_S = 0.12
    PREEMPT_BLOCK_S = 0.4

    def __init__(self, recs: list, ctl=None, world: int = 4):
        self.recs = recs
        self.ctl = ctl
        self.world = world
        self.full_world = world
        self.it = 0

    def emit(self, source, kind, rank=None, pid=0, **payload):
        rec = {"ts": time.time(), "source": source, "kind": kind,
               "pid": pid, "rank": rank, **payload}
        self.recs.append(rec)
        if self.ctl is not None:
            self.ctl.observe(rec)
        return rec

    def steps(self, n: int, slow: float = 1.0):
        """n training steps; a shrunken world steps proportionally slower,
        a straggler inflates every step (synchronous training gates on it)."""
        for _ in range(n):
            time.sleep(self.STEP_S * slow * (self.full_world / self.world))
            self.it += 1
            self.emit("inprocess", "iteration_start", pid=1000,
                      iteration=self.it)

    def downtime(self, seconds: float, kind: str, **payload):
        """Fault evidence, then a dead window; the next step's
        iteration_start closes the ledger's restart interval."""
        self.emit("launcher", kind, **payload)
        time.sleep(seconds)

    # -- controlled-arm actuators (wired into the controller) ---------------

    def swap(self, reason: str):
        self.downtime(self.WARM_RESTART_S, "restart_requested", reason=reason)
        self.emit("launcher", "worker_promoted", outcome="promoted",
                  round=1, park_depth=2)

    def shrink(self, victims, reason: str):
        self.downtime(self.RESHARD_S, "restart_requested", reason=reason)
        self.emit("launcher", "world_resized", direction="shrink",
                  from_world=self.world, to_world=self.world - len(victims))
        self.world -= len(victims)

    def expand(self, reason: str):
        self.downtime(self.RESHARD_S, "restart_requested", reason=reason)
        self.emit("launcher", "world_resized", direction="grow",
                  from_world=self.world, to_world=self.full_world)
        self.world = self.full_world


def _autoscale_campaign(seed: int, workdir: str, controlled: bool,
                        repriced: bool = True):
    """One arm of the campaign: fluctuating capacity (a preemption notice
    that rescinds, then one that doesn't) + an injected straggler + a seeded
    disk fault. ``controlled`` runs the AutoscaleController in act mode;
    the baseline runs the identical fault script with today's hard-coded
    reactions (straggle until death, drain-and-stop on every notice, die at
    the deadline). Returns ``(records, decision_schedule, disk_schedule)``.

    ``repriced`` selects which reshard price the controlled arm's cost model
    reads from its (synthetic) bench artifact — both prices via the SAME
    ``CostModel.from_bench`` path production uses. ``True`` gives it the
    ``phases`` decomposition (plan + fetch = the real per-rank stall once
    serve/fetch/assembly overlap); ``False`` strips the ``phases`` block so
    ``from_bench`` falls back to the serial-era ``ranged_s`` top line, which
    also charges the local assembly that now hides under the fetch. The
    inflated price keeps shrink's predicted gain under the hysteresis bar at
    the ripe preemption, so the old-priced arm declines the resize and pays
    the death it could have dodged — identical fault script, identical
    physics, different constants, measurably worse goodput."""
    import shutil
    import numpy as np

    from tpu_resiliency_torch.checkpoint.local_manager import LocalCheckpointManager
    from tpu_resiliency_torch.checkpoint.state_dict import PyTreeStateDict
    from tpu_resiliency_torch.launcher.autoscale import AutoscaleController, CostModel
    from tpu_resiliency_torch.telemetry.policy import HealthVectorPolicy
    from tpu_resiliency_torch.telemetry.remediation import RemediationEngine
    from tpu_resiliency_torch.utils import events as tpu_events
    from tpu_resiliency_torch.utils.events import RESERVED_KEYS

    world = 4
    v_straggler = seed % world
    v_rescind = (seed // 4) % world
    v_preempt = (seed // 16) % world
    recs: list = []

    def flatten(e):
        recs.append({
            "ts": e.ts, "source": e.source, "kind": e.kind,
            "pid": e.pid, "rank": e.rank,
            **{f"p_{k}" if k in RESERVED_KEYS else k: v
               for k, v in e.payload.items()},
        })
        if ctl is not None:
            ctl.observe(recs[-1])

    arm = ("ctl_phases" if repriced else "ctl_ranged") if controlled else "base"
    ckpt_root = os.path.join(workdir, f"ckpt_{arm}")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    spares = [1]

    ctl = None
    sim = _AutoscaleSim(recs, ctl=None, world=world)
    proactive_mgr = [None]

    def proactive_ckpt():
        # A REAL checkpoint save: its events (and the disk fault below, which
        # corrupts its successor) ride the same stream the ledger reads.
        if proactive_mgr[0] is None:
            proactive_mgr[0] = LocalCheckpointManager(
                ckpt_root, rank=0, keep=2
            )
        proactive_mgr[0].save(
            1, PyTreeStateDict({"w": np.arange(2048, dtype=np.float32), "step": 1}),
            is_async=False,
        )

    if controlled:
        def swap_restart(reason):
            spares[0] -= 1
            sim.swap(reason)

        engine = RemediationEngine(
            checkpoint_fn=proactive_ckpt,
            spare_capacity_fn=lambda: spares[0],
            publish_degraded_fn=lambda d: None,
            request_restart_fn=swap_restart,
            cooldown=0.0,
        )
        # Price the model the way production does — ``from_bench`` over a
        # bench artifact. Both arms share ranged_s (the serial-era top line
        # = the sim's actual reshard stall); only the repriced arm's doc
        # carries the phase decomposition, whose plan+fetch sum is what the
        # overlapped hot path really stalls a rank for.
        bench_dir = os.path.join(workdir, f"bench_{arm}")
        os.makedirs(bench_dir, exist_ok=True)
        bench_doc = {"ranged_s": _AutoscaleSim.RESHARD_S}
        if repriced:
            bench_doc["phases"] = {"plan_s": 0.002, "fetch_s": 0.038}
        with open(os.path.join(bench_dir, "BENCH_reshard.json"), "w") as f:
            json.dump(bench_doc, f)
        cost_model = CostModel.from_bench(
            bench_dir,
            horizon_s=4.0,
            warm_restart_s=_AutoscaleSim.WARM_RESTART_S,
            cold_restart_s=_AutoscaleSim.COLD_RESTART_S,
            ckpt_s=0.02,
            preempt_block_s=_AutoscaleSim.PREEMPT_BLOCK_S,
        )
        assert abs(cost_model.reshard_s - (0.04 if repriced else 0.12)) < 1e-9, (
            f"from_bench priced reshard_s={cost_model.reshard_s} "
            f"(repriced={repriced})"
        )
        ctl = AutoscaleController(
            mode="act",
            cost_model=cost_model,
            remediation=engine,
            spare_capacity_fn=lambda: spares[0],
            shrink_fn=sim.shrink,
            expand_fn=sim.expand,
            target_world=world,
            rescind_grace_s=0.6,
            shrink_lead_s=0.1,
            # Sits between the two priced shrink gains (0.51 with the serial
            # ranged_s, 0.59 with plan+fetch): the repricing alone flips the
            # ripe-preemption decision.
            hysteresis_s=0.55,
            dwell_s=0.3,
            decision_cooldown_s=10.0,
            outcome_window_s=0.5,
        )
        sim.ctl = ctl
    policy = HealthVectorPolicy(
        patience=2, recovery=1,
        sinks=[ctl.note_health] if ctl is not None else [],
    )
    tpu_events.add_sink(flatten)
    try:
        sim.emit("launcher", "rendezvous_round", round=0, world_size=world,
                 active=list(range(world)))
        if controlled:
            sim.emit("launcher", "warm_spare_pool", size=1, parked=1, warm=1)
        # -- phase 0: healthy -------------------------------------------------
        sim.steps(10)
        # -- phase 1: straggler ----------------------------------------------
        scores_bad = {r: (0.3 if r == v_straggler else 1.0)
                      for r in range(world)}
        for _ in range(2):  # patience rounds: the straggler gates the job
            sim.steps(1, slow=3.0)
            policy.observe(_synthetic_report(scores_bad))
        if controlled:
            d = ctl.tick()
            assert d is not None and d.action == "swap", d
            assert d.victims == [v_straggler], (d.victims, v_straggler)
            sim.emit("telemetry", "degraded_set", degraded=[], newly=[],
                     recovered=[v_straggler], scores={})
        else:
            # No controller: the straggler gates the job until it dies, then
            # the round cold-restarts — today's reality.
            sim.steps(18, slow=3.0)
            sim.downtime(
                _AutoscaleSim.COLD_RESTART_S, "worker_failed",
                global_rank=v_straggler, exitcode=1,
                detail="straggler died",
            )
        sim.steps(10)
        # -- phase 2: preemption notice that RESCINDS ------------------------
        sim.emit("preemption", "preemption_sync_point", rank=v_rescind,
                 step=sim.it)
        if controlled:
            d = ctl.tick()  # fresh notice: bank progress, don't panic
            assert d is not None and d.action == "checkpoint", d
            sim.steps(5)
            sim.emit("preemption", "preemption_rescinded", rank=v_rescind,
                     step=sim.it, noticed_step=sim.it - 5)
            assert ctl.tick() is None  # notice gone: nothing to do
            sim.steps(5)
        else:
            # Today's path: the notice forces drain-and-stop; the rescind
            # arrives after the job already paid the restart.
            proactive_ckpt()
            sim.downtime(
                _AutoscaleSim.COLD_RESTART_S, "restart_requested",
                reason=f"preemption notice on rank {v_rescind}: drain and stop",
            )
            sim.emit("preemption", "preemption_rescinded", rank=v_rescind,
                     step=sim.it, noticed_step=sim.it)
            sim.steps(10)
        # -- phase 3: real preemption (deadline hits) ------------------------
        if controlled and repriced:
            ctl.note_preemption(
                f"r{v_preempt}", rank=v_preempt, deadline=time.time()
            )
            sim.emit("preemption", "preemption_sync_point", rank=v_preempt,
                     step=sim.it)
            d = ctl.tick()
            assert d is not None and d.action == "shrink", d
            sim.steps(15)  # training continues at 3/4 capacity
            spares[0] = 1  # the reclaimed capacity returns
            sim.emit("launcher", "warm_spare_pool", size=1, parked=1, warm=1)
            d = ctl.tick()
            assert d is not None and d.action == "expand", d
            sim.steps(10)
        elif controlled:
            # The serial-era price keeps shrink's predicted gain under the
            # hysteresis bar: the controller banks progress at most (or stays
            # silent under the per-victim cooldown) and the rank dies at the
            # deadline — the exact regression the phase repricing closes.
            ctl.note_preemption(
                f"r{v_preempt}", rank=v_preempt, deadline=time.time()
            )
            sim.emit("preemption", "preemption_sync_point", rank=v_preempt,
                     step=sim.it)
            d = ctl.tick()
            assert d is None or d.action == "checkpoint", d
            sim.steps(2)  # the grace window ticks away, nothing resizes
            sim.downtime(
                _AutoscaleSim.COLD_RESTART_S + _AutoscaleSim.PREEMPT_BLOCK_S,
                "worker_failed", global_rank=v_preempt, exitcode=137,
                detail="preempted at deadline; shrink underpriced by the "
                       "serial-era ranged_s constant",
            )
            sim.steps(25)
        else:
            sim.emit("preemption", "preemption_sync_point", rank=v_preempt,
                     step=sim.it)
            sim.steps(2)  # the grace window ticks away, nothing prepares
            sim.downtime(
                _AutoscaleSim.COLD_RESTART_S + _AutoscaleSim.PREEMPT_BLOCK_S,
                "worker_failed", global_rank=v_preempt, exitcode=137,
                detail="preempted at deadline; blocked for capacity",
            )
            sim.steps(25)
        # -- phase 4: the disk fault (identical in both arms) ----------------
        proactive_ckpt()  # ensures iteration 1 exists under this arm's root
        plan = chaos.ChaosPlan.parse(AUTOSCALE_DISK_SPEC.format(seed=seed))
        chaos.install_plan(plan)
        try:
            mgr = proactive_mgr[0]
            import numpy as _np

            mgr.save(
                2,
                PyTreeStateDict({"w": _np.arange(2048, dtype=_np.float32),
                                 "step": 2}),
                is_async=False,
            )
            hollow, tensors, meta = mgr.load()
            assert meta["iteration"] == 1, (
                f"disk-fault ladder resumed iteration {meta['iteration']}, "
                f"wanted the fallback to 1 (bitflipped 2)"
            )
        finally:
            chaos.clear_plan()
        sim.steps(5)
        if ctl is not None:
            ctl.finalize()
        schedule = (
            tuple(
                (d.decision_id, d.action, tuple(d.victims))
                for d in ctl.decisions
            )
            if ctl is not None else ()
        )
        return recs, schedule, tuple(plan.schedule())
    finally:
        tpu_events.remove_sink(flatten)
        if proactive_mgr[0] is not None:
            proactive_mgr[0].close()


def scenario_autoscale(seed: int, workdir: str):
    """The detect→decide→act acceptance: the controlled arm's measured
    goodput ratio must STRICTLY beat the no-controller baseline of the same
    seed, the controlled run's (decision, action, victim) schedule must
    reproduce across two runs, and every decision event must pair with an
    outcome event carrying both predicted and realized goodput deltas.

    A third arm reprices nothing BUT the cost model: same controller, same
    fault script, constants drawn from the same bench artifact minus its
    ``phases`` block (the pre-overlap ``ranged_s`` price). That arm must
    decline the ripe-preemption shrink, never expand, and land a strictly
    WORSE goodput ratio than the phase-priced arm — the decision-schedule
    diff is visible in the two arms' ``autoscale_decision`` audit events.
    Leaves ``controlled.jsonl`` / ``baseline.jsonl`` in ``workdir`` for the
    smoke leg's offline ``tpu-metrics-dump --goodput --baseline`` check."""
    from tpu_resiliency_torch.utils.goodput import GoodputLedger, compare
    from tpu_resiliency_torch.utils.metrics import aggregate

    os.makedirs(workdir, exist_ok=True)
    c1_recs, c1_sched, c1_disk = _autoscale_campaign(seed, workdir, True)
    c2_recs, c2_sched, c2_disk = _autoscale_campaign(seed, workdir, True)
    assert (c1_sched, c1_disk) == (c2_sched, c2_disk), (
        f"autoscale decision schedule not reproducible:\n{c1_sched}\n{c2_sched}"
    )
    assert [a for _, a, _ in c1_sched] == [
        "swap", "checkpoint", "shrink", "expand",
    ], c1_sched
    o_recs, o_sched, o_disk = _autoscale_campaign(
        seed, workdir, True, repriced=False
    )
    b_recs, _, b_disk = _autoscale_campaign(seed, workdir, False)
    assert b_disk == c1_disk, "disk fault schedule diverged between arms"
    assert o_disk == c1_disk, "disk fault schedule diverged (serial-priced)"

    # The repricing IS the decision diff: the serial-priced arm never
    # resizes — and the divergence is auditable from the decision events
    # alone, no internal state needed.
    old_actions = [a for _, a, _ in o_sched]
    assert old_actions[:2] == ["swap", "checkpoint"], o_sched
    assert "shrink" not in old_actions and "expand" not in old_actions, o_sched
    audit_new = [r["action"] for r in c1_recs
                 if r.get("kind") == "autoscale_decision"]
    audit_old = [r["action"] for r in o_recs
                 if r.get("kind") == "autoscale_decision"]
    assert "shrink" in audit_new and "expand" in audit_new, audit_new
    assert "shrink" not in audit_old and "expand" not in audit_old, audit_old

    # Every decision carries predicted AND realized goodput delta (the
    # outcome event pairs them; finalize settled any stragglers).
    decisions = [r for r in c1_recs if r.get("kind") == "autoscale_decision"]
    outcomes = {
        r.get("decision_id"): r
        for r in c1_recs if r.get("kind") == "autoscale_outcome"
    }
    assert len(decisions) == len(c1_sched), decisions
    for d in decisions:
        assert isinstance(d.get("predicted_delta_s"), (int, float)), d
        o = outcomes.get(d.get("decision_id"))
        assert o is not None, f"decision {d.get('decision_id')} never settled"
        assert isinstance(o.get("predicted_delta_s"), (int, float)), o
        assert isinstance(o.get("realized_delta_s"), (int, float)), o

    # The acceptance inequalities, via the same compare() helper the CLI
    # uses: phase-priced > serial-priced > no controller at all.
    controlled, old_priced, baseline = (
        GoodputLedger(), GoodputLedger(), GoodputLedger()
    )
    controlled.observe_many(c1_recs)
    old_priced.observe_many(o_recs)
    baseline.observe_many(b_recs)
    cmp_doc = compare(controlled, baseline)
    assert cmp_doc["ratio_delta"] > 0, (
        f"controller did NOT beat the no-controller baseline: {cmp_doc}"
    )
    cmp_old = compare(old_priced, baseline)
    assert cmp_old["ratio_delta"] > 0, (
        f"serial-priced controller did NOT beat the baseline: {cmp_old}"
    )
    cmp_reprice = compare(controlled, old_priced)
    assert cmp_reprice["ratio_delta"] > 0, (
        f"phase repricing did NOT beat the serial-era constants: {cmp_reprice}"
    )

    # Every arm climbed the identical disk-fault ladder.
    for name, arm in (("controlled", c1_recs), ("serial_priced", o_recs),
                      ("baseline", b_recs)):
        assert any(r.get("kind") == "ckpt_quarantined" for r in arm), (
            f"{name}: bitflipped container never quarantined"
        )
        assert any(r.get("kind") == "ckpt_fallback" for r in arm), (
            f"{name}: ladder never recorded the fallback"
        )

    # The metrics surface: the same aggregation metrics_dump runs.
    prom = aggregate(c1_recs).to_prometheus()
    for want in (
        "tpu_autoscale_decisions_total", 'action="swap"', 'action="shrink"',
        "tpu_autoscale_predicted_vs_realized", "tpu_preemption_rescinded_total",
    ):
        assert want in prom, f"{want} missing:\n{prom[:2000]}"

    for name, arm in (("controlled", c1_recs),
                      ("controlled_serial_priced", o_recs),
                      ("baseline", b_recs)):
        with open(os.path.join(workdir, f"{name}.jsonl"), "w") as f:
            for rec in arm:
                f.write(json.dumps(rec) + "\n")
    return (
        [list(s) for s in c1_sched],
        (seed % 4, (seed // 4) % 4, (seed // 16) % 4),
        [list(i) for i in c1_disk],
        (cmp_doc["goodput_ratio"][0], cmp_old["goodput_ratio"][0],
         cmp_doc["goodput_ratio"][1]),
    )


def _alerts_campaign(seed: int):
    """One synthetic run of the watchtower campaign: a fully seeded stream
    (synthetic timestamps — the watchtower runs on stream time, so the whole
    campaign is wall-clock-free) through a live-wired engine whose emitted
    alert events are appended back into the stream, exactly as a real run's
    telemetry tail sees its own ``alert_fired`` records. Returns
    ``(records, sequence, hang_ts)``."""
    import random

    from tpu_resiliency_torch.telemetry.watchtower import Watchtower, default_rules

    rng = random.Random(seed)
    recs: list = []
    sequence: list = []
    tower = Watchtower(
        rules=default_rules(),
        emit=lambda kind, payload: sequence.append({"kind": kind, **payload}),
    )
    t = [1_000_000.0 + (seed % 997)]

    def emit(source, kind, **payload):
        rec = {"ts": t[0], "source": source, "kind": kind, "pid": 0,
               "rank": None, **payload}
        recs.append(rec)
        n = len(sequence)
        tower.observe(rec)
        # The engine's own transitions ride the stream too (a live run's
        # events tail feeds them back); stamped at their boundary ts they
        # never cross a boundary themselves — inert on replay, by design.
        for tr in sequence[n:]:
            recs.append({
                "ts": tr.get("resolve_ts") or tr.get("fire_ts") or t[0],
                "source": "watchtower", "pid": 0, "rank": None, **tr,
            })

    it = [0]

    def steps(n, step_s):
        for _ in range(n):
            t[0] += step_s * (1.0 + 0.1 * rng.random())
            it[0] += 1
            emit("inprocess", "iteration_start", iteration=it[0], pid=1000)

    # -- phase 0: healthy baseline (jittered so MAD is honest) --------------
    steps(20, 0.1)
    # -- phase 1: seeded straggler — the pre-hang early warning -------------
    steps(8, 3.0)
    fired_rules = [s["rule"] for s in sequence if s["kind"] == "alert_fired"]
    assert "step_anomaly" in fired_rules, (
        f"straggler ramp never fired step_anomaly: {sequence}"
    )
    # ... and only THEN does the monitor's verdict land: the whole point.
    t[0] += 1.0
    hang_ts = t[0]
    emit("monitor", "hang_detected", rank=seed % 4, detail="seeded straggler")
    steps(20, 0.1)  # replacement rank: step time recovers, alert resolves
    # -- phase 2: injected restart burns the goodput SLO fast window --------
    for _ in range(30):
        t[0] += 2.0
        emit("telemetry", "goodput_update", ratio=0.2)
    for _ in range(40):  # recovery refills the fast window, burn resolves
        t[0] += 2.0
        emit("telemetry", "goodput_update", ratio=1.0)
    steps(5, 0.1)  # trailing boundary crossings flush pending resolves
    return recs, sequence, hang_ts


def scenario_alerts(seed: int, workdir: str):
    """The watchtower acceptance: the seeded straggler's ``step_anomaly``
    alert fires STRICTLY BEFORE the monitor's hang verdict (the early-warning
    lead), the injected restart burns the goodput SLO fast window and
    resolves after recovery, two same-seed runs produce identical
    (rule, fire_ts, resolve) sequences, and an offline replay of the saved
    events JSONL reproduces the live sequence byte-identically. Leaves
    ``events.jsonl`` / ``sequence.jsonl`` in ``workdir`` for the smoke leg's
    ``tpu-alerts`` check."""
    from tpu_resiliency_torch.telemetry.watchtower import replay
    from tpu_resiliency_torch.utils.metrics import aggregate

    os.makedirs(workdir, exist_ok=True)
    recs, seq, hang_ts = _alerts_campaign(seed)
    recs2, seq2, hang_ts2 = _alerts_campaign(seed)
    assert (seq, hang_ts) == (seq2, hang_ts2), (
        f"alert sequence not reproducible:\n{seq}\n{seq2}"
    )

    # The early-warning inequality: fired before the verdict, strictly.
    anomaly_fire = next(
        s for s in seq
        if s["kind"] == "alert_fired" and s["rule"] == "step_anomaly"
    )
    assert anomaly_fire["fire_ts"] < hang_ts, (
        f"step_anomaly fired at {anomaly_fire['fire_ts']}, NOT before the "
        f"hang verdict at {hang_ts}"
    )
    anomaly_resolve = next(
        s for s in seq
        if s["kind"] == "alert_resolved" and s["rule"] == "step_anomaly"
    )
    assert anomaly_resolve["resolve_ts"] > hang_ts

    # The SLO burn fires on the injected restart and resolves on recovery.
    burn = [s for s in seq if s["rule"] == "goodput_burn"]
    assert [s["kind"] for s in burn] == ["alert_fired", "alert_resolved"], burn

    # Offline replay of the saved stream reproduces the live sequence
    # byte-identically (the recorded alert events in the file are inert).
    events_path = os.path.join(workdir, "events.jsonl")
    with open(events_path, "w") as f:
        for rec in recs:
            f.write(json.dumps(rec) + "\n")
    with open(events_path) as f:
        loaded = [json.loads(line) for line in f if line.strip()]
    _, replayed = replay(loaded)
    live_bytes = [json.dumps(s, sort_keys=True) for s in seq]
    replay_bytes = [json.dumps(s, sort_keys=True) for s in replayed]
    assert live_bytes == replay_bytes, (
        f"offline replay diverged from the live sequence:\n"
        f"{live_bytes}\n{replay_bytes}"
    )
    with open(os.path.join(workdir, "sequence.jsonl"), "w") as f:
        for line in live_bytes:
            f.write(line + "\n")

    # The metrics surface: alert events aggregate like any other stream.
    prom = aggregate(recs).to_prometheus()
    for want in (
        "tpu_alerts_total", 'rule="step_anomaly"', 'rule="goodput_burn"',
        'severity="page"', "tpu_alerts_active 0",
    ):
        assert want in prom, f"{want} missing:\n{prom[:2000]}"

    ordinals = [
        (s["kind"], s["rule"], i) for i, s in enumerate(seq)
    ]
    return ordinals, round(hang_ts - anomaly_fire["fire_ts"], 3)


# -- scenario: cold-start (checkpoints that outlive the job) -----------------

#: The cold-start campaign's fixed geometry: a 3-rank dp world whose global
#: "w" is reassembled by a 2-rank fresh world — rows divisible by both.
COLD_WORLD = 3
COLD_RESUME_RANKS = [0, 1]


def _cold_global():
    import numpy as np

    return np.arange(24 * 8, dtype=np.float32).reshape(24, 8) * 0.5


def _cold_job_child(base: str) -> int:
    """Hidden ``--_cold-job`` mode: the victim job of
    :func:`scenario_cold_start`. A 3-rank world saves two cold-archived
    keyframe iterations (layout-bearing, clique-replicated), spawns a worker
    subprocess so there is a real process TREE to kill, signals readiness,
    then "trains" forever — the parent SIGKILLs the whole group mid-step, so
    nothing here ever closes cleanly. Durability must come from what already
    landed in the cold tier."""
    from tpu_resiliency_torch.checkpoint import reshard as ckpt_reshard
    from tpu_resiliency_torch.checkpoint.coldtier import ColdTier, FilesystemStore
    from tpu_resiliency_torch.checkpoint.local_manager import LocalCheckpointManager
    from tpu_resiliency_torch.checkpoint.state_dict import PyTreeStateDict

    G = _cold_global()
    world = COLD_WORLD
    layout = ckpt_reshard.TreeLayout(
        [("dp", world)], list(range(world)),
        [ckpt_reshard.LeafSpec(G.shape, "float32", ("dp",))],
    )
    srv = KVServer(host="127.0.0.1", port=0)

    def mk():
        return CoordStore("127.0.0.1", srv.port, timeout=30.0)

    def body(rank):
        comm = StoreComm(mk(), rank, list(range(world)), timeout=60.0)
        ex = PeerExchange(mk(), rank, timeout=30.0)
        ex.start()
        strat = CliqueReplicationStrategy(
            comm, ex, replication_jump=1, replication_factor=2
        )
        cold = ColdTier(
            FilesystemStore(os.path.join(base, "cold")), session=0, rank=rank
        )
        mgr = LocalCheckpointManager(
            os.path.join(base, "root"), rank=rank, comm=comm,
            replication=strat, cold=cold, keep=2,
        )
        for it in (1, 2):
            tree = {
                "w": ckpt_reshard.slice_local([G], layout, rank)[0]
                + float(it),
                "step": it,
            }
            mgr.save(it, PyTreeStateDict(tree), is_async=False, layout=layout)
        assert cold.flush(timeout=60.0), "cold uploads did not drain"
        # Deliberately no mgr.close()/ex.close(): this job dies by SIGKILL.

    with cf.ThreadPoolExecutor(max_workers=world) as pool:
        for f in [pool.submit(body, r) for r in range(world)]:
            f.result(timeout=180)
    worker = subprocess.Popen(
        [sys.executable, "-c", "import time\nwhile True: time.sleep(1)"]
    )
    tmp = os.path.join(base, "ready.tmp")
    with open(tmp, "w") as f:
        f.write(str(worker.pid))
    os.replace(tmp, os.path.join(base, "ready"))
    while True:  # "training" — the parent kills the process group here
        time.sleep(0.05)


def _proc_gone(pid: int) -> bool:
    """Dead-or-zombie (a zombie no longer executes anything; whether it is
    reaped depends on the container's init)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True


def scenario_cold_start(seed: int, workdir: str):
    """Checkpoints that outlive the job: SIGKILL an entire job's process tree
    mid-training, then resume a FRESH world with an EMPTY workdir from the
    cold tier alone, on a DIFFERENT world size (3 -> 2), byte-identical.

    The seeded bitflip variant corrupts one byte of the newest archived
    iteration (victim owner and payload offset both derived from the seed):
    the fresh world must refuse the corrupt bytes fail-closed and agree to
    climb to the next-older covered iteration. Returns the full outcome
    tuple (kill signal, resumed iterations, state digests, fault identity) —
    reproducible run-to-run per seed."""
    import hashlib
    import shutil
    import signal

    import numpy as np

    from tpu_resiliency_torch.checkpoint import reshard as ckpt_reshard
    from tpu_resiliency_torch.checkpoint.coldtier import (
        ColdTier,
        FilesystemStore,
        artifact_key,
    )
    from tpu_resiliency_torch.checkpoint.local_manager import LocalCheckpointManager
    from tpu_resiliency_torch.utils import events as tpu_events

    base = workdir
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    logpath = os.path.join(base, "job.log")
    with open(logpath, "wb") as logf:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--_cold-job", base],
            stdout=logf, stderr=subprocess.STDOUT, start_new_session=True,
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )
    ready = os.path.join(base, "ready")
    deadline = time.monotonic() + 180.0
    try:
        while not os.path.exists(ready):
            if proc.poll() is not None:
                with open(logpath, errors="replace") as f:
                    tail = f.read()[-2000:]
                raise AssertionError(
                    f"cold-start job died before readiness (rc="
                    f"{proc.returncode}):\n{tail}"
                )
            if time.monotonic() > deadline:
                raise AssertionError("cold-start job never became ready")
            time.sleep(0.05)
        with open(ready) as f:
            worker_pid = int(f.read().strip())
        # The whole tree, not just the leader: the job runs in its own
        # session/process group, so one killpg takes worker and leader alike.
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        rc = proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert rc == -signal.SIGKILL, f"job exited {rc}, wanted SIGKILL"
    kill_deadline = time.monotonic() + 10.0
    while not _proc_gone(worker_pid):
        assert time.monotonic() < kill_deadline, (
            f"worker {worker_pid} survived the process-tree kill"
        )
        time.sleep(0.05)

    G = _cold_global()
    ranks = list(COLD_RESUME_RANKS)
    tgt = ckpt_reshard.TreeLayout(
        [("dp", len(ranks))], ranks,
        [ckpt_reshard.LeafSpec(G.shape, "float32", ("dp",))],
    )

    def restore(tag, gen):
        """A fresh launcher's view: empty workdir, only the cold tier and a
        new rendezvous store."""
        srv = KVServer(host="127.0.0.1", port=0)
        stores: list = []
        seen: list = []
        tpu_events.add_sink(seen.append)
        fresh = os.path.join(base, f"fresh_{tag}")

        def mk():
            s = CoordStore("127.0.0.1", srv.port, timeout=30.0)
            stores.append(s)
            return s

        def body(rank):
            comm = StoreComm(mk(), rank, ranks, timeout=60.0, generation=gen)
            ex = PeerExchange(mk(), rank, timeout=30.0)
            ex.start()
            try:
                mgr = LocalCheckpointManager(
                    fresh, rank=rank, comm=comm,
                    cold=ColdTier(
                        FilesystemStore(os.path.join(base, "cold")),
                        session=0, rank=rank,
                    ),
                )
                hollow, tensors, meta = mgr.load_resharded()
                mgr.close()
                return meta["iteration"], [
                    np.asarray(t).copy() for t in tensors
                ]
            finally:
                ex.close()

        try:
            with cf.ThreadPoolExecutor(max_workers=len(ranks)) as pool:
                out = [
                    f.result(timeout=180)
                    for f in [pool.submit(body, r) for r in ranks]
                ]
        finally:
            tpu_events.remove_sink(seen.append)
            for s in stores:
                s.close()
            srv.close()
        return out, seen

    def digest(out):
        h = hashlib.sha256()
        for _, tensors in out:
            for t in tensors:
                h.update(t.tobytes())
        return h.hexdigest()

    # Leg 1: clean restore-anywhere — fresh world 2 resumes the killed
    # world-3 job's newest keyframe, byte-identical, straight from cold.
    out_a, seen_a = restore("clean", gen=1)
    for rank, (it, tensors) in zip(ranks, out_a):
        assert it == 2, f"rank {rank} resumed iteration {it}, wanted 2"
        want = ckpt_reshard.slice_local([G], tgt, rank)[0] + 2.0
        assert np.array_equal(tensors[0], want), (
            f"rank {rank}: cold restore not byte-identical"
        )
    fetches = [e for e in seen_a if e.kind == "coldtier_fetch"]
    assert fetches and all(
        e.payload["outcome"] == "ok" for e in fetches
    ), f"clean leg cold fetches: {[e.payload for e in fetches]}"

    # Leg 2: the seeded cold-tier bitflip — victim owner and offset inside
    # the sharded "w" payload both derive from the seed; the fresh world must
    # climb to the next-older covered iteration, never restoring flipped
    # bytes.
    colddir = os.path.join(base, "cold")
    victim = seed % COLD_WORLD
    probe = ColdTier(FilesystemStore(colddir))
    doc = probe.manifest(2, victim)
    assert doc is not None, f"no cold manifest for iter 2 owner {victim}"
    off = doc["prefix_len"]
    for leaf in doc["leaves"]:
        if leaf["nbytes"] == max(l["nbytes"] for l in doc["leaves"]):
            break
        off += leaf["nbytes"]
    flip_at = off + seed % leaf["nbytes"]
    apath = os.path.join(colddir, artifact_key(0, 2, victim))
    with open(apath, "r+b") as f:
        f.seek(flip_at)
        b = f.read(1)
        f.seek(flip_at)
        f.write(bytes([b[0] ^ 0x01]))

    out_b, seen_b = restore("bitflip", gen=2)
    for rank, (it, tensors) in zip(ranks, out_b):
        assert it == 1, (
            f"rank {rank} resumed iteration {it} — must climb below the "
            f"corrupt iter 2"
        )
        want = ckpt_reshard.slice_local([G], tgt, rank)[0] + 1.0
        assert np.array_equal(tensors[0], want), (
            f"rank {rank}: climbed restore not byte-identical"
        )
    corrupt = [
        e for e in seen_b
        if e.kind == "coldtier_fetch" and e.payload["outcome"] == "corrupt"
    ]
    assert corrupt, "bitflip leg never surfaced a corrupt cold fetch"
    # Persist both restore legs' event streams for downstream smoke legs
    # (metrics_dump must aggregate tpu_coldtier_* from this file).
    with open(os.path.join(base, "events.jsonl"), "w") as f:
        for e in seen_a + seen_b:
            f.write(json.dumps(e.to_record(), default=str) + "\n")
    return (
        rc,
        [it for it, _ in out_a], digest(out_a),
        victim, flip_at,
        [it for it, _ in out_b], digest(out_b),
    )


# -- driver ------------------------------------------------------------------


def run_seed(seed: int, workdir: str, with_launcher: bool = True,
             randomized: bool = False) -> dict:
    """One seeded pass over every scenario. ``randomized`` swaps the fixed
    fault templates for :func:`chaos.random_spec`-generated plans (still fully
    determined by ``seed`` — the soak stays replayable)."""
    out: dict = {"seed": seed, "randomized": randomized}
    t0 = time.perf_counter()
    store_spec = (
        chaos.random_spec(seed, channels=("store",), ops=("send", "recv", "connect"))
        if randomized else None
    )
    # p2p random plans stay off the recv op: recv-side payload truncation is
    # silent loss (degrade path), which this scenario's no-degrade assertion
    # intentionally excludes — see REPL_SPEC's comment.
    repl_spec = (
        chaos.random_spec(seed, channels=("p2p",), ops=("send", "connect"))
        if randomized else None
    )
    s1 = scenario_store(seed, spec=store_spec)
    s2 = scenario_store(seed, spec=store_spec)
    assert s1 == s2, f"store schedule not reproducible:\n{s1}\n{s2}"
    out["store_injections"] = [list(i) for i in s1]
    # Sharded clique + tree collectives under the same store-channel faults,
    # twice per seed: schedule AND gathered bytes must both reproduce.
    scale_spec = (
        chaos.random_spec(seed, channels=("store",), ops=("send", "recv", "connect"))
        if randomized else None
    )
    ss1 = scenario_store_scale(seed, spec=scale_spec)
    ss2 = scenario_store_scale(seed, spec=scale_spec)
    assert ss1[0] == ss2[0], (
        f"store-scale schedule not reproducible:\n{ss1[0]}\n{ss2[0]}"
    )
    assert ss1[1] == ss2[1], "store-scale gathered bytes not reproducible"
    out["store_scale_injections"] = [list(i) for i in ss1[0]]
    out["store_scale_digest"] = ss1[1]
    # Replicated-clique failover campaign (SIGKILL a shard mid-barrier-storm
    # and mid-rendezvous), twice per seed: the victims, the deduped counter,
    # the final keyspace digest and the rendezvous outcome must all reproduce.
    fo1 = scenario_store_failover(seed)
    fo2 = scenario_store_failover(seed)
    assert fo1 == fo2, f"store-failover outcome not reproducible:\n{fo1}\n{fo2}"
    out["store_failover_kill_round"] = fo1[0]
    out["store_failover_victims"] = list(fo1[1])
    out["store_failover_counter"] = fo1[2]
    out["store_failover_digest"] = fo1[3]
    r1 = scenario_replication(seed, spec=repl_spec)
    r2 = scenario_replication(seed, spec=repl_spec)
    assert r1 == r2, f"replication schedule not reproducible:\n{r1}\n{r2}"
    out["replication_injections"] = [list(i) for i in r1]
    # Disk-fault ladder, both rungs, each run twice per seed: the injection
    # schedule (per-file write indices) must reproduce exactly.
    d1 = scenario_disk(seed)
    d2 = scenario_disk(seed)
    assert d1 == d2, f"disk schedule not reproducible:\n{d1}\n{d2}"
    f1 = scenario_disk(seed, fallback=True)
    f2 = scenario_disk(seed, fallback=True)
    assert f1 == f2, f"disk-fallback schedule not reproducible:\n{f1}\n{f2}"
    out["disk_injections"] = [list(i) for i in d1]
    out["disk_fallback_injections"] = [list(i) for i in f1]
    # Byte-economy campaign (erasure holder death + parity bitflip + delta
    # chain break), twice per seed: the whole composite tuple — injection
    # schedule AND every seeded fault identity — must reproduce.
    c1 = scenario_coding(seed)
    c2 = scenario_coding(seed)
    assert c1 == c2, f"coding schedule not reproducible:\n{c1}\n{c2}"
    out["coding_injections"] = [list(i) for i in c1[0]]
    out["coding_victim"] = c1[1]
    out["coding_faults"] = list(c1[2:6])
    # Elastic shrink → resharded resume → re-expand, twice per seed: the
    # (injection schedule, victim, per-rank byte splits) must reproduce.
    e1 = scenario_elastic(seed)
    e2 = scenario_elastic(seed)
    assert e1 == e2, f"elastic schedule not reproducible:\n{e1}\n{e2}"
    out["elastic_victim"] = e1[1]
    out["elastic_splits"] = [list(s) for s in e1[2]]
    out["elastic_injections"] = [list(i) for i in e1[0]]
    # Cold-start: SIGKILL the whole job tree mid-training, fresh empty-workdir
    # world resumes from the cold tier on a different world size — twice per
    # seed, and the (kill, resumed iterations, digests, fault identity) tuple
    # must reproduce exactly, bitflip-climb variant included.
    cold_dir = os.path.join(workdir, f"cold_{seed}")
    cs1 = scenario_cold_start(seed, cold_dir)
    cs2 = scenario_cold_start(seed, cold_dir)
    assert cs1 == cs2, f"cold-start outcome not reproducible:\n{cs1}\n{cs2}"
    out["cold_start_resumed"] = {"clean": cs1[1], "bitflip": cs1[5]}
    out["cold_start_digests"] = {"clean": cs1[2], "bitflip": cs1[6]}
    out["cold_start_fault"] = {"victim_owner": cs1[3], "flip_at": cs1[4]}
    out["cold_start_workdir"] = cold_dir
    # Mixed multi-fault campaign (straggler + network + disk), twice per seed:
    # the combined schedule must reproduce exactly like the single-channel ones.
    mixed_dir = os.path.join(workdir, f"mixed_{seed}")
    m1 = scenario_mixed(seed, mixed_dir)
    m2 = scenario_mixed(seed, mixed_dir)
    assert m1 == m2, f"mixed schedule not reproducible:\n{m1}\n{m2}"
    out["mixed_injections"] = [list(i) for i in m1]
    out["mixed_workdir"] = mixed_dir
    # Hang forensics chain (seeded stall -> detection -> capture -> ladder ->
    # restart), twice per seed: the forensics schedule must reproduce exactly.
    hang_dir = os.path.join(workdir, f"hang_{seed}")
    h1 = scenario_hang(seed, hang_dir)
    h2 = scenario_hang(seed, hang_dir)
    assert h1 == h2, f"hang schedule not reproducible:\n{h1}\n{h2}"
    out["hang_schedule"] = [h1[0], list(h1[1]), h1[2]]
    out["hang_workdir"] = hang_dir
    # Autoscale campaign: scenario_autoscale internally runs the phase-priced
    # controlled arm twice (identical decision schedules) plus the
    # serial-priced arm and the baseline, asserting the strict goodput
    # ordering phase-priced > serial-priced > no controller.
    autoscale_dir = os.path.join(workdir, f"autoscale_{seed}")
    a_sched, a_victims, a_disk, a_ratios = scenario_autoscale(seed, autoscale_dir)
    out["autoscale_schedule"] = a_sched
    out["autoscale_victims"] = list(a_victims)
    out["autoscale_goodput"] = {"controlled": a_ratios[0],
                                "serial_priced": a_ratios[1],
                                "baseline": a_ratios[2]}
    out["autoscale_workdir"] = autoscale_dir
    # Watchtower campaign: scenario_alerts internally runs the synthetic
    # stream twice (identical fire/resolve sequences) and byte-compares the
    # offline replay of its saved events JSONL against the live sequence.
    alerts_dir = os.path.join(workdir, f"alerts_{seed}")
    al_seq, al_lead = scenario_alerts(seed, alerts_dir)
    out["alerts_sequence"] = [list(s) for s in al_seq]
    out["alerts_early_warning_lead_s"] = al_lead
    out["alerts_workdir"] = alerts_dir
    if with_launcher:
        counts = scenario_launcher(seed, os.path.join(workdir, f"launcher_{seed}"))
        out["launcher_injections"] = {f"{c}.{k}": n for (c, k), n in counts.items()}
    out["elapsed_s"] = round(time.perf_counter() - t0, 2)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="fast fixed-seed pass (store + replication + launcher)")
    ap.add_argument("--seed", type=int, default=None, help="single seeded pass")
    ap.add_argument("--soak-runs", type=int, default=0,
                    help="randomized soak: N random seeds, launcher every 4th")
    ap.add_argument("--out", default=None, help="write a JSON report here")
    ap.add_argument(
        "--workdir", default=None,
        help="run under this directory instead of a self-deleting tempdir "
        "(keeps the mixed scenario's events/incident artifacts for "
        "downstream smoke legs)")
    ap.add_argument("--_cold-job", dest="cold_job", metavar="DIR",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.cold_job:
        return _cold_job_child(args.cold_job)

    results = []
    import contextlib

    ctx = (
        contextlib.nullcontext(args.workdir) if args.workdir
        else tempfile.TemporaryDirectory(prefix="chaos_soak.")
    )
    with ctx as workdir:
        os.makedirs(workdir, exist_ok=True)
        if args.smoke or args.seed is not None:
            seed = 1234 if args.seed is None else args.seed
            res = run_seed(seed, workdir, with_launcher=True)
            results.append(res)
            print(f"seed {seed}: store={len(res['store_injections'])} "
                  f"repl={len(res['replication_injections'])} "
                  f"mixed={len(res['mixed_injections'])} "
                  f"autoscale={res.get('autoscale_goodput')} "
                  f"alerts_lead={res.get('alerts_early_warning_lead_s')}s "
                  f"launcher={res.get('launcher_injections')} "
                  f"({res['elapsed_s']}s)")
        base = int.from_bytes(os.urandom(4), "big")
        for i in range(args.soak_runs):
            seed = base + i
            res = run_seed(seed, workdir, with_launcher=(i % 4 == 0),
                           randomized=True)
            results.append(res)
            print(f"soak[{i}] seed {seed}: OK ({res['elapsed_s']}s)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"runs": results}, f, indent=2)
            f.write("\n")
    print(f"chaos_soak: PASS ({len(results)} seeded run(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
