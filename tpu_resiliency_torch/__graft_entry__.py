"""Driver entry points: a one-device forward check and a multi-process sharded dry run.

Port of the repo root's ``__graft_entry__.py``, function by function under the same
names, with the same printed ``dryrun_multichip OK ...`` lines where the facts are the
same:

- :func:`entry` returns the tiny transformer's forward and its example arguments.
- :func:`dryrun_multichip` runs one sharded train step, a telemetry round, a local
  checkpoint round trip of the sharded train state and the MoE family pipelined over
  ``pp`` with experts over ``ep``, in ``n`` ranks. Then it runs the in-process restart
  cycle, the preemption round and the replication re-mirror.

Where the reference runs one process over ``n`` virtual JAX devices, the port starts
``n`` fresh interpreters (a rank that needs the card must be one), in one gloo group.
On the card every rank takes ``cuda:<rank % cards>``, so with one card all ranks share
``cuda:0``; NCCL refuses two ranks on one card, and gloo carries their collectives.
The in-process restart and the preemption round run the port's examples with the
reference's arguments, beside the ranks; a rank drives one device, so the reference's
``--devices-per-rank`` has no counterpart and its world is 2 x 1. The replication
re-mirror is host code in this process, on payloads carved from the step's first
parameter leaf.

``device=None`` means the card and raises without one; ``device="cpu"`` runs every
rank on the host. Run::

    python -m tpu_resiliency_torch.__graft_entry__ --device cpu --n 4
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 300.0
EXAMPLE_TIMEOUT_S = 300.0

#: The collectives gloo does not carry on CUDA tensors (torch 2.11 on an H100, each op
#: alone in two ranks on ``cuda:0``): the functional all-gather that DTensor's
#: ``Shard -> Replicate`` issues ends the process with a segfault, though the plain
#: ``dist.all_gather_into_tensor`` works. (``send`` and ``recv``, the ring's and the
#: pipeline's hops, fail too, with "Bad address", and say so themselves.) The functional
#: all-reduce and reduce-scatter, broadcast, all-to-all and barrier work. A rank on the
#: card refuses these ops before they run (:func:`_collectives`), so there only the
#: data-parallel split runs: its step issues all-reduces alone.
GLOO_CUDA_REFUSED = ("_c10d_functional.all_gather_into_tensor",)


def entry(device=None):
    """(fn, example_args): the forward step of the tiny transformer (seed 0) and its
    arguments, tokens of zeros ``[2, 32]`` on ``device`` (the card by default)."""
    import torch

    from tpu_resiliency_torch.models import transformer as tfm
    from tpu_resiliency_torch.platform.device import resolve_device

    dev = resolve_device(device)
    cfg = tfm.TransformerConfig.tiny()
    model = tfm.Transformer(cfg, seed=0, device=dev)
    tokens = torch.zeros((2, 32), dtype=torch.int64, device=dev)

    def fn(model, tokens):
        return tfm.forward(model, tokens, cfg)

    return fn, (model, tokens)


def dryrun_multichip(n_devices: int, device=None, weights=None, split=None,
                     moe_split=None) -> dict:
    """Run the FULL sharded training step over an ``n_devices``-rank mesh, one step,
    then the framework's dry runs on the same ranks (see the module's docstring).

    ``weights``: a directory holding ``dense.npz`` and ``moe.npz``, each model's
    parameters by flat name (``layers.wq``, ...) as the reference lays them out (carried
    across by ``models/transformer.py`` ``params_from_reference``); by default each model
    is drawn from seed 0. ``split``: the train step's ``{"dp", "tp", "sp", ...}``,
    ``parallel/mesh.py`` ``default_split(n_devices)`` by default; ``moe_split`` the MoE
    pipeline's, ``moe_pipeline_split(n_devices)`` by default. On the card only
    ``{"dp": n_devices}`` runs for either (:data:`GLOO_CUDA_REFUSED`). Returns what the ranks
    measured: the splits, meshes and losses, the collectives the step issued, the
    telemetry mask and its ``loop`` launches, the checkpoint round trip, and each part's
    seconds. Raises if a part fails."""
    from tpu_resiliency_torch.platform.device import resolve_device

    import numpy as np

    dev = resolve_device(device)  # raises here, before any rank starts, without a card
    t0 = time.perf_counter()
    seconds = {}
    # The examples run beside the ranks: they share nothing but the device and the host.
    examples = _start_examples(["--device", "cpu"] if dev.type == "cpu" else [])
    try:
        with tempfile.TemporaryDirectory(prefix="dryrun-") as work:
            ranks = _run_ranks(n_devices, dev.type, work, weights, split, moe_split)
            seconds["ranks"] = time.perf_counter() - t0
            first_leaf = np.load(os.path.join(work, "first_leaf.npy"))
        r0 = ranks[0]
        print(f"dryrun_multichip OK: mesh={r0['mesh']} loss={r0['loss']:.4f}", flush=True)
        _check_telemetry(ranks)
        _check_local_ckpt(ranks)
        _dryrun_inprocess_restart(examples[0])
        _dryrun_preemption_sync(examples[1])
        seconds["examples"] = time.perf_counter() - t0
    finally:
        for proc in examples:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    t = time.perf_counter()
    _dryrun_replication_remirror(first_leaf)
    seconds["replication_remirror"] = time.perf_counter() - t
    if r0["moe_loss"] is not None:
        print(f"dryrun_multichip OK (moe+pipeline): mesh={r0['moe_mesh']} "
              f"loss={r0['moe_loss']:.4f}", flush=True)
    seconds["total"] = time.perf_counter() - t0
    return {
        "n": n_devices, "device": str(dev), "split": r0["split"], "mesh": r0["mesh"],
        "loss": r0["loss"], "collectives": r0["collectives"],
        "moe_split": r0["moe_split"], "moe_mesh": r0["moe_mesh"], "moe_loss": r0["moe_loss"],
        "moe_collectives": r0["moe_collectives"],
        "telemetry": r0["telemetry"],
        "loop_launches": sum(r["telemetry"]["loop_launches"] for r in ranks),
        "local_ckpt": [r["local_ckpt"] for r in ranks], "seconds": seconds,
    }


def _run_ranks(n: int, device_type: str, work: str, weights, split, moe_split) -> list[dict]:
    """Start ``n`` fresh interpreters running :func:`_rank_main` in one gloo group;
    returns each rank's result, in rank order. A rank that fails fails the call."""
    from tpu_resiliency_torch.platform.distributed import reserve_port

    port, held = reserve_port()  # rank 0's group store binds it; held until the ranks end
    env = dict(os.environ, PYTHONPATH=REPO_ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    if device_type == "cpu":  # each rank takes its share of the host's cores
        env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // n)))
    argv = ["--port", str(port), "--world", str(n), "--device", device_type, "--work", work]
    if weights:
        argv += ["--weights", str(weights)]
    if split:
        argv += ["--split", json.dumps(split)]
    if moe_split:
        argv += ["--moe-split", json.dumps(moe_split)]
    procs = [subprocess.Popen([sys.executable, "-m", "tpu_resiliency_torch.__graft_entry__",
                               "--rank", str(r), *argv], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env, cwd=REPO_ROOT)
             for r in range(n)]
    results, failures = [], []
    try:
        for r, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                failures.append(f"rank {r} ran past {RANK_TIMEOUT_S} s:\n{err[-3000:]}")
                continue
            lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            if p.returncode != 0 or not lines:
                failures.append(f"rank {r} exited {p.returncode}:\n{out[-1500:]}\n{err[-3000:]}")
                continue
            results.append(json.loads(lines[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        held.close()
    if failures:
        raise AssertionError("dryrun_multichip: " + "\n".join(failures))
    return results


def _check_telemetry(ranks) -> None:
    tel = ranks[0]["telemetry"]
    n = len(ranks)
    if tel is None:
        # Relative scoring needs a peer to be relative to: a single rank is its
        # own reference and can never be flagged.
        print("dryrun_multichip SKIP (telemetry): needs >= 2 devices", flush=True)
        return
    for r in ranks:
        assert r["telemetry"]["mask"] == r["telemetry"]["truth"], (
            f"straggler mask {r['telemetry']['mask']} != truth {r['telemetry']['truth']}")
    print(f"dryrun_multichip OK (telemetry): {n}-rank group scoring round, "
          f"injected-slow rank {tel['slow']} flagged, F1=1.000", flush=True)


def _check_local_ckpt(ranks) -> None:
    for r in ranks:
        ck = r["local_ckpt"]
        assert ck["latest"] == 3, f"rank {r['rank']}: find_latest()={ck['latest']}, expected 3"
        assert ck["bits_equal"], f"rank {r['rank']}: ckpt roundtrip differs: {ck['differ']}"
        assert ck["placements_equal"], f"rank {r['rank']}: placements not restored"
    print("dryrun_multichip OK (local-ckpt): sharded train-state save -> "
          "find_latest=3 -> restore, max|delta|=0.0, shardings preserved", flush=True)


def _rank_main(args) -> dict:
    """One rank of :func:`dryrun_multichip`: the train step, the telemetry round, the
    local checkpoint and the MoE pipeline step; writes the first parameter leaf after
    the step (rank 0) for the re-mirror."""
    import faulthandler

    import numpy as np
    import torch
    import torch.distributed as dist

    from tpu_resiliency_torch.parallel import mesh as pm
    from tpu_resiliency_torch.platform import distributed

    faulthandler.enable()  # a crash in a collective prints where it happened
    rank, n = args.rank, args.world
    if args.device == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    distributed.initialize(f"tcp://127.0.0.1:{args.port}", n, rank, backend="gloo",
                           timeout=RANK_TIMEOUT_S, device=dev)
    weights = ({name: dict(np.load(os.path.join(args.weights, f"{name}.npz")))
                for name in ("dense", "moe")} if args.weights else None)
    split = _full_split(json.loads(args.split) if args.split else pm.default_split(n))
    out = {"rank": rank, "split": split}
    state = _train_step(out, dev, split, weights and weights["dense"])
    if rank == 0:
        np.save(os.path.join(args.work, "first_leaf.npy"), state["first_leaf"])
    out["telemetry"] = _telemetry_round(rank, n, dev) if n >= 2 else None
    out["local_ckpt"] = _local_ckpt(rank, dev, state, os.path.join(args.work, "ckpt"))
    moe_split = json.loads(args.moe_split) if args.moe_split else pm.moe_pipeline_split(n)
    out.update(_moe_step(_full_split(moe_split), dev, weights and weights["moe"]))
    dist.barrier()
    distributed.shutdown_for_restart()
    return out


def _full_split(split: dict) -> dict:
    return {**{"dp": 1, "tp": 1, "sp": 1, "pp": 1, "ep": 1}, **split}


def _collectives(dev):
    """``CommDebugMode``, which counts the collectives DTensor issues; on the card it
    also refuses, before it runs, one that gloo does not carry on CUDA tensors."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils._pytree import tree_leaves

    class Collectives(CommDebugMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func).rsplit(".", 1)[0]
            if name in GLOO_CUDA_REFUSED and any(
                    isinstance(a, torch.Tensor) and a.is_cuda for a in tree_leaves(args)):
                raise RuntimeError(
                    f"gloo does not carry {name} on CUDA tensors (torch {torch.__version__}; "
                    f"GLOO_CUDA_REFUSED): on the card run the data-parallel split")
            return super().__torch_dispatch__(func, types, args, kwargs)

    return Collectives() if dev.type == "cuda" else CommDebugMode()


def _counts(comm) -> dict:
    return {str(op).rsplit(".", 1)[-1]: int(c) for op, c in comm.get_comm_counts().items()}


def _train_step(out: dict, dev, split: dict, weights) -> dict:
    """The sharded train step of the tiny transformer on ``split``'s mesh, its batch
    zeros ``[dp * 2, 64]``; ring attention over ``sp`` when ``sp > 1``. Records the mesh,
    the loss and the collectives the step issued (DTensor's ``CommDebugMode``)."""
    import torch

    from tpu_resiliency_torch.models import transformer as tfm
    from tpu_resiliency_torch.parallel import mesh as pm

    mesh = pm.build_mesh(device=dev.type, **split)
    cfg = tfm.TransformerConfig.tiny()
    attn_fn = None
    if split["sp"] > 1:
        # Sequence parallelism is real: attention runs as a ring over sp.
        from tpu_resiliency_torch.parallel.ring_attention import make_ring_attn_fn

        attn_fn = make_ring_attn_fn(mesh)
    train_step, init_opt = tfm.make_train_step(cfg, attn_fn=attn_fn)
    params = tfm.params_from_reference(tfm.nest(weights), device=dev) if weights else None
    model = tfm.Transformer(cfg, params, seed=0, device=dev)
    specs = pm.param_specs(cfg)
    pm.distribute_model(model, mesh, specs)
    opt = init_opt(model)
    tokens = pm.distribute_batch(
        torch.zeros((split["dp"] * 2, 64), dtype=torch.int64, device=dev), mesh)
    comm = _collectives(dev)
    try:
        with comm:
            model, opt, loss = train_step(model, opt, tokens)
    except RuntimeError as e:
        raise RuntimeError(f"the train step of split {split} failed on {dev} over gloo after "
                           f"issuing {_counts(comm)}: {e}") from e
    out["mesh"] = pm.axis_sizes(mesh)
    out["loss"] = float(loss)
    out["collectives"] = _counts(comm)
    names = dict(model.named_parameters())
    moments = {n: opt.state[p] for n, p in names.items()}
    tree = {"params": tfm.nest({n: p for n, p in names.items()}),
            "mu": tfm.nest({n: s["exp_avg"] for n, s in moments.items()}),
            "nu": tfm.nest({n: s["exp_avg_sq"] for n, s in moments.items()})}
    return {"mesh": mesh, "tree": tree, "specs": {"params": specs, "mu": specs, "nu": specs},
            "first_leaf": model.embed.full_tensor().detach().float().cpu().numpy()}


def _telemetry_round(rank: int, n: int, dev) -> dict:
    """``MeshTelemetry`` over the ``n`` ranks' group: eight pushes of ``1 + 0.01 N(0, 1)``
    (``default_rng(0)``, every rank draws the whole ``[n, 2]`` row and pushes its own),
    rank ``n - 2`` slowed 1.8x, one scoring round; the gathered mask, the truth and this
    rank's ``loop`` launches."""
    import numpy as np
    import torch.distributed as dist

    from tpu_resiliency_torch.ops import scoring_kernels as sk
    from tpu_resiliency_torch.telemetry import scoring
    from tpu_resiliency_torch.telemetry.sharded import MeshTelemetry

    group = dist.group.WORLD
    sk.reset_launches()
    mt = MeshTelemetry(n, signal_names=("step", "h2d"), window=8, group=group, device=dev)
    state = mt.init_state()
    rng = np.random.default_rng(0)
    slow = n - 2
    for _ in range(8):
        row = 1.0 + 0.01 * rng.standard_normal((n, 2)).astype(np.float32)
        row[slow] *= 1.8
        state = mt.push(state, row[rank:rank + 1])
    state, scores = mt.score(state)
    mask = scoring.scores_to_host(scoring.gather_scores(scores, group)).straggler
    truth = np.zeros(n, dtype=bool)
    truth[slow] = True
    return {"mask": np.asarray(mask).tolist(), "truth": truth.tolist(), "slow": slow,
            "kernel_mode": mt.kernel_mode,
            "loop_launches": int(sk.fused_median_weights.launches_by_mode["loop"])}


def _local_ckpt(rank: int, dev, state: dict, root: str) -> dict:
    """This rank's shards of the sharded train state (parameters and AdamW's moments),
    laid out by ``parallel/mesh.py`` ``checkpoint_layout``: save at iteration 3,
    ``find_latest``, restore with the same placements, compare bit for bit."""
    import torch
    from torch.distributed.tensor import DTensor

    from tpu_resiliency_torch.checkpoint import LocalCheckpointManager, PyTreeStateDict
    from tpu_resiliency_torch.checkpoint.state_dict import tree_flatten
    from tpu_resiliency_torch.parallel import mesh as pm

    mesh, tree, specs = state["mesh"], state["tree"], state["specs"]
    local = _map_tree(lambda t: t.to_local().detach(), tree)
    mgr = LocalCheckpointManager(os.path.join(root, f"node{rank}"), rank=rank)
    mgr.save(3, PyTreeStateDict(local), is_async=False,
             layout=pm.checkpoint_layout(mesh, local, specs))
    latest = mgr.find_latest()
    restored, _ = mgr.load_tree(latest, device=dev)
    mgr.close()
    sub = pm.active_mesh(mesh)
    placed = _map_tree(lambda t, p: DTensor.from_local(t, sub, list(p)), restored,
                       pm.tree_shardings(mesh, specs))
    want, got = tree_flatten(tree)[0], tree_flatten(placed)[0]
    differ = [i for i, (a, b) in enumerate(zip(want, got))
              if not torch.equal(_bits(a.to_local()), _bits(b.to_local()))]
    return {"latest": latest, "leaves": len(got), "bits_equal": not differ, "differ": differ,
            "placements_equal": all(a.placements == b.placements for a, b in zip(want, got))}


def _bits(t):
    import torch

    return t.detach().contiguous().view(torch.uint8)


def _map_tree(fn, tree, *others):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, *(o[k] for o in others)) for k, v in tree.items()}
    return fn(tree, *others)


def _moe_step(msplit: dict, dev, weights) -> dict:
    """Second program: the MoE family pipelined over ``pp`` with experts over ``ep``
    (``msplit``), two microbatches, batch zeros ``[dp * 2 * 2, 64]``."""
    import torch

    from tpu_resiliency_torch.models import moe
    from tpu_resiliency_torch.models import transformer as tfm
    from tpu_resiliency_torch.parallel import mesh as pm
    from tpu_resiliency_torch.parallel import pipeline as pl

    if not any(v > 1 for v in msplit.values()):
        return {"moe_split": msplit, "moe_mesh": None, "moe_loss": None, "moe_collectives": {}}
    mesh = pm.build_mesh(device=dev.type, **msplit)
    mcfg = moe.MoEConfig.tiny()
    params = tfm.params_from_reference(tfm.nest(weights), device=dev) if weights else None
    model = moe.MoE(mcfg, params, seed=0, device=dev)
    specs = pm.moe_param_specs(mcfg)
    specs["layers"] = pm.pipeline_layer_specs(specs["layers"])
    pm.distribute_model(model, mesh, specs)
    n_micro = 2
    tokens = pm.distribute_batch(
        torch.zeros((msplit["dp"] * n_micro * 2, 64), dtype=torch.int64, device=dev), mesh)
    step, init_opt = pl.make_pipelined_train_step(mcfg, mesh, n_micro=n_micro, family="moe")
    opt = init_opt(model)
    comm = _collectives(dev)
    try:
        with comm:
            _, _, loss = step(model, opt, tokens)
    except RuntimeError as e:
        raise RuntimeError(f"the MoE step of split {msplit} failed on {dev} over gloo after "
                           f"issuing {_counts(comm)}: {e}") from e
    return {"moe_split": msplit, "moe_mesh": pm.axis_sizes(mesh), "moe_loss": float(loss),
            "moe_collectives": _counts(comm)}


def _start_example(module: str, argv: list[str]) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=REPO_ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen([sys.executable, "-m", module, *argv], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=REPO_ROOT)


def _example_output(proc: subprocess.Popen, ok_marker: str, what: str) -> str:
    """Wait for an example started as a subprocess certificate step; returns its
    stdout."""
    try:
        out, err = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        proc.kill()
        out, err = proc.communicate()
        # The hung case is where the child's diagnostics matter most.
        print(out[-2000:], err[-2000:], sep="\n", file=sys.stderr)
        raise AssertionError(f"{what} hung past {EXAMPLE_TIMEOUT_S:.0f} s") from e
    if proc.returncode != 0 or ok_marker not in out:
        print(out[-2000:], err[-2000:], sep="\n", file=sys.stderr)
        raise AssertionError(f"{what} failed (rc={proc.returncode})")
    return out


def _start_examples(dev_args) -> list[subprocess.Popen]:
    """The in-process restart and preemption examples, started together."""
    return [
        # The step time of 0.25 s keeps the survivor training until the restart, under
        # load (the reference's reason for it).
        _start_example("tpu_resiliency_torch.examples.inprocess_restart_train",
                       ["--world", "2", "--steps", "8", "--ckpt-every", "2", "--kill-rank",
                        "1", "--kill-step", "4", "--step-time", "0.25", *dev_args]),
        _start_example("tpu_resiliency_torch.examples.preemption_train",
                       ["--world", "2", *dev_args]),
    ]


def _dryrun_inprocess_restart(proc: subprocess.Popen) -> None:
    """One in-process restart cycle: 2 rank processes of one device each; rank 1 dies
    mid-run; the survivor reassigns to world=1 and resumes from its newest local
    checkpoint (``examples/inprocess_restart_train.py``, asserted by its own exit code)."""
    _example_output(proc, "RESTART-RESUME OK", "inprocess restart cycle")
    print("dryrun_multichip OK (inprocess-restart): rank death -> reassignment "
          "-> ckpt resume; surviving world 2x1 -> 1x1 devices completed steps", flush=True)


def _dryrun_preemption_sync(proc: subprocess.Popen) -> None:
    """A preemption-synchronized save round: one rank gets SIGTERM, the agreement over
    the process group reaches every rank, and every rank saves the SAME agreed step
    (``examples/preemption_train.py``)."""
    _example_output(proc, "PREEMPTION-SYNC OK", "preemption-synchronized save round")
    print("dryrun_multichip OK (preemption-sync): SIGTERM on one rank -> all "
          "ranks saved the same agreed step of their state", flush=True)


def _dryrun_replication_remirror(leaf) -> None:
    """Replication remirror after simulated rank loss: world 4 saves sharded
    data in cliques [0,1],[2,3]; rank 3 dies; survivors rebuild over [0,1,2],
    the orphaned shard is re-spread, the dead rank's data stays retrievable,
    and find_latest is coverage-complete before AND after the next save."""
    import concurrent.futures as cf
    import shutil

    import numpy as np

    from tpu_resiliency_torch.checkpoint import LocalCheckpointManager, PyTreeStateDict
    from tpu_resiliency_torch.checkpoint.comm import PeerExchange, StoreComm
    from tpu_resiliency_torch.checkpoint.replication import CliqueReplicationStrategy
    from tpu_resiliency_torch.platform.store import CoordStore, KVServer

    world, survivors = 4, [0, 1, 2]
    # Per-rank payloads carved from the step's first parameter leaf: each rank
    # owns a distinct row-slice of it.
    chunks = np.array_split(np.asarray(leaf).reshape(-1), world)

    server = KVServer(host="127.0.0.1", port=0)
    root = tempfile.mkdtemp(prefix="dryrun-remirror-")
    stores: list = []

    def make_store():
        s = CoordStore("127.0.0.1", server.port, timeout=30.0)
        stores.append(s)
        return s

    def save_phase(rank):
        comm = StoreComm(make_store(), rank, list(range(world)), timeout=30.0)
        ex = PeerExchange(make_store(), rank, timeout=30.0)
        ex.start()
        try:
            strat = CliqueReplicationStrategy(
                comm, ex, replication_jump=1, replication_factor=2
            )
            mgr = LocalCheckpointManager(
                f"{root}/node{rank}", rank=rank, comm=comm, replication=strat
            )
            mgr.save(5, PyTreeStateDict({"w": chunks[rank].copy()}), is_async=False)
            assert mgr.find_latest() == 5
            mgr.close()
        finally:
            ex.close()

    def remirror_phase(rank):
        stale = StoreComm(make_store(), rank, list(range(world)), timeout=30.0)
        ex = PeerExchange(make_store(), rank, timeout=30.0)
        ex.start()
        try:
            strat = CliqueReplicationStrategy(
                stale, ex, replication_jump=1, replication_factor=2
            )
            mgr = LocalCheckpointManager(
                f"{root}/node{rank}", rank=rank, comm=stale, replication=strat
            )
            new_comm = StoreComm(
                make_store(), rank, survivors, timeout=30.0, generation=1
            )
            mgr.rebuild_group(new_comm)
            # The dead rank's shard (sole copy was rank 2's mirror) must be
            # retrievable by EVERY survivor after the remirror spread it.
            _, tensors, _ = mgr.load_shard(3, 5)
            np.testing.assert_array_equal(np.asarray(tensors[0]), chunks[3])
            # Coverage-complete immediately after rebuild...
            assert mgr.find_latest() == 5
            # ...and after the next save over the rebuilt group.
            mgr.save(6, PyTreeStateDict({"w": chunks[rank] + 1.0}), is_async=False)
            assert mgr.find_latest() == 6
            mgr.close()
        finally:
            ex.close()

    try:
        with cf.ThreadPoolExecutor(max_workers=world) as pool:
            for f in [pool.submit(save_phase, r) for r in range(world)]:
                f.result(timeout=120.0)
        # Rank 3 dies and takes its storage with it.
        shutil.rmtree(f"{root}/node3")
        with cf.ThreadPoolExecutor(max_workers=len(survivors)) as pool:
            for f in [pool.submit(remirror_phase, r) for r in survivors]:
                f.result(timeout=120.0)
    finally:
        for s in stores:
            s.close()
        server.close()
        shutil.rmtree(root, ignore_errors=True)
    print(
        "dryrun_multichip OK (replication-remirror): rank loss -> clique "
        "rebuild over survivors -> orphaned shard re-spread (dead rank's data "
        "served by every survivor) -> coverage-complete find_latest at the "
        "next save",
        flush=True,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="",
                    help="'cpu' to run every rank on the host; the card by default")
    ap.add_argument("--n", type=int, default=None,
                    help="ranks of the dry run (default: the cards, at least 2)")
    # Set by dryrun_multichip for each rank process.
    for name in ("--rank", "--world", "--port"):
        ap.add_argument(name, type=int, default=None, help=argparse.SUPPRESS)
    for name in ("--work", "--weights", "--split", "--moe-split"):
        ap.add_argument(name, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        print("RESULT " + json.dumps(_rank_main(args)), flush=True)
        return 0

    import torch

    device = args.device or None
    fn, fargs = entry(device)
    with torch.no_grad():
        print("entry loss-shape:", tuple(fn(*fargs).shape), flush=True)
    n = args.n or max(2, torch.cuda.device_count() if device is None else 2)
    dryrun_multichip(n, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
