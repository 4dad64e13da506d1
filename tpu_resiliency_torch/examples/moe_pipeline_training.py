"""Resilient MoE training over the (dp, pp, ep) mesh with in-process restart.

Port of ``examples/moe_pipeline_training.py``. The restart engine protects the
framework's most complex workload: a top-k routed mixture-of-experts model
(``models/moe.py``) whose layer stack is pipelined over the ``pp`` mesh axis and whose
experts are placed over ``ep`` (``parallel/pipeline.py``). A fault is raised on one
rank mid-training; the Wrapper restarts every rank, each rebuilds its process group
and mesh, and the loop resumes from the newest local checkpoint that every rank holds
(the parameters and AdamW's state). The ranks meet on the job's store at each step
boundary (:func:`meet`), so the fault reaches every rank between steps.

Run (4 gloo ranks on the CPU: ``moe_pipeline_split(4)``, pp = 2 x ep = 2)::

    python -m tpu_resiliency_torch.examples.moe_pipeline_training --world 4 \\
        --device cpu --steps 12 --fault-step 5

Without ``--device`` it runs on the card, one rank by default (pp = ep = 1, a
one-process NCCL group, the model's tensors plain: DTensor in torch 2.11 refuses the
attention's head-flattening view on a mesh of one rank). Rank 0 prints ``RESUMED step=<n>`` after the restart and
``DONE loss=<x>`` on success.

Where the reference runs one process over 8 virtual devices, the port runs
``--world`` processes, each a fresh interpreter; the last rank raises.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RANK_TIMEOUT_S = 600.0  # the Wrapper's own barrier and completion timeouts


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def train_tree(model, opt) -> dict:
    """This rank's train state as a tree of local tensors: the parameters, AdamW's
    ``mu`` and ``nu`` (``exp_avg``, ``exp_avg_sq``) and the step count."""
    from tpu_resiliency_torch.models import transformer as tfm

    def local(t):
        return (t.to_local() if hasattr(t, "to_local") else t).detach()

    names = dict(model.named_parameters())
    state = {n: opt.state[p] for n, p in names.items()}
    return {"params": tfm.nest({n: local(p) for n, p in names.items()}),
            "mu": tfm.nest({n: local(s["exp_avg"]) for n, s in state.items()}),
            "nu": tfm.nest({n: local(s["exp_avg_sq"]) for n, s in state.items()}),
            "count": int(state["embed"]["step"])}


def load_train_tree(model, opt, tree) -> None:
    """Copy a :func:`train_tree` back into ``model`` and ``opt`` (the optimizer state
    made here if it has none yet)."""
    import torch

    from tpu_resiliency_torch.models import transformer as tfm

    def local(t):
        return t.to_local() if hasattr(t, "to_local") else t

    flat = {part: tfm.flat_names(tree[part]) for part in ("params", "mu", "nu")}
    with torch.no_grad():
        for n, p in model.named_parameters():
            st = opt.state[p]
            st.setdefault("exp_avg", torch.zeros_like(p))
            st.setdefault("exp_avg_sq", torch.zeros_like(p))
            st["step"] = torch.tensor(float(tree["count"]), dtype=torch.float32)
            local(p).copy_(flat["params"][n])
            local(st["exp_avg"]).copy_(flat["mu"][n])
            local(st["exp_avg_sq"]).copy_(flat["nu"][n])


def meet(store, key: str, rank: int, world: int) -> None:
    """Wait on the job's store until every rank has reached ``key``: the step
    boundary where a peer's fault reaches this rank. Gloo cannot abort a collective in
    flight (a rank blocked in one wakes only when its peer's sockets close), so the
    ranks enter a step's collectives only together; the wait polls in Python, where the
    Wrapper's restart interrupts it."""
    import time

    store.set_add(key, [rank])
    while len(store.set_get(key)) < world:
        time.sleep(0.002)


def rank_main(args) -> float | None:
    """One rank's training under the Wrapper; returns the final loss."""
    import torch
    import torch.distributed as dist

    from tpu_resiliency_torch.checkpoint import LocalCheckpointManager, PyTreeStateDict
    from tpu_resiliency_torch.inprocess import (
        AbortTorchDistributed,
        CallWrapper,
        RetryController,
        Wrapper,
    )
    from tpu_resiliency_torch.models import moe
    from tpu_resiliency_torch.parallel import mesh as pmesh
    from tpu_resiliency_torch.parallel import pipeline as pl
    from tpu_resiliency_torch.platform import distributed
    from tpu_resiliency_torch.platform.device import resolve_device

    rank, world = args.rank, args.world
    dev = resolve_device(args.device or None)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    group_ports = [int(p) for p in args.group_ports.split(",")]
    cfg = moe.MoEConfig.tiny(dtype=torch.float32)
    fault_armed = {"armed": True}

    @Wrapper(
        initialize=RetryController(max_iterations=4),  # a persistent fault must not loop forever
        abort=AbortTorchDistributed(),
        monitor_interval=0.05,
        last_call_wait=0.1,
        soft_timeout=300.0,
        hard_timeout=600.0,
        heartbeat_interval=0.2,
        heartbeat_timeout=60.0,
        barrier_timeout=600.0,
        completion_timeout=600.0,
    )
    def train(call: CallWrapper):
        fs = call.frozen_state
        distributed.initialize(f"tcp://127.0.0.1:{group_ports[call.iteration]}",
                               fs.active_world_size, fs.active_rank, timeout=60.0, device=dev)
        split = pmesh.moe_pipeline_split(fs.active_world_size)
        mesh = pmesh.build_mesh(device=dev.type, **split)
        specs = pmesh.moe_param_specs(cfg)
        specs["layers"] = pmesh.pipeline_layer_specs(specs["layers"])
        model = moe.MoE(cfg, seed=0, device=dev)
        tokens = torch.arange(16, dtype=torch.int64).repeat(split["dp"] * args.n_micro * 2, 3)
        tokens = tokens[:, :32].to(dev)
        if fs.active_world_size > 1:  # one rank holds the whole model as plain tensors
            pmesh.distribute_model(model, mesh, specs)
            tokens = pmesh.distribute_batch(tokens, mesh)

        step, init_opt = pl.make_pipelined_train_step(cfg, mesh, n_micro=args.n_micro,
                                                      family="moe")
        opt = init_opt(model)
        mgr = LocalCheckpointManager(args.ckpt_root, rank=fs.initial_rank)
        # The newest iteration every rank holds: a fully covered checkpoint.
        latest = torch.tensor([mgr.find_latest()], dtype=torch.int64, device=dev)
        dist.all_reduce(latest, op=dist.ReduceOp.MIN)
        start = 0
        if int(latest) >= 0:
            # Restore the parameters AND AdamW's state: fresh moments would silently
            # change the training trajectory.
            tree, meta = mgr.load_tree(int(latest), device=dev)
            load_train_tree(model, opt, tree)
            start = int(meta["iteration"]) + 1
            if fs.initial_rank == 0:
                print(f"RESUMED step={start}", flush=True)

        loss = None
        for i in range(start, args.steps):
            if (fault_armed["armed"] and i == args.fault_step and call.iteration == 0
                    and fs.initial_rank == world - 1):
                fault_armed["armed"] = False
                raise RuntimeError(f"injected fault at step {i} on rank {fs.initial_rank}")
            meet(call.coord.store, f"moe_pp_step/{call.iteration}/{i}", fs.active_rank,
                 fs.active_world_size)
            model, opt, loss = step(model, opt, tokens)
            call.ping()
            if i % args.ckpt_every == 0:
                mgr.save(i, PyTreeStateDict(train_tree(model, opt)), is_async=False)
        mgr.maybe_finalize(blocking=True)
        mgr.close()
        distributed.shutdown_ordered(call.coord.store, fs.active_rank, fs.active_world_size,
                                     iteration=call.iteration)
        return float(loss)

    return train()


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--fault-step", type=int, default=5)
    p.add_argument("--ckpt-every", type=int, default=2)
    p.add_argument("--ckpt-root", default=None)
    p.add_argument("--n-micro", type=int, default=2)
    p.add_argument("--world", type=int, default=1, help="rank processes")
    p.add_argument("--device", default="",
                   help="'cpu' for gloo ranks on the host; the card (NCCL) by default")
    # Set by the parent for each rank process.
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--group-ports", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    if args.rank is not None:
        final = rank_main(args)
        if args.rank == 0:
            print(f"DONE loss={final:.4f}", flush=True)
        return 0

    ckpt_root = args.ckpt_root or tempfile.mkdtemp(prefix="moe-pp-ckpt-")
    env = dict(os.environ, RANK="", WORLD_SIZE=str(args.world),
               TPU_RESILIENCY_STORE_HOST="127.0.0.1",
               TPU_RESILIENCY_STORE_PORT=str(free_port()),
               PYTHONPATH=REPO_ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    if args.device == "cpu":  # each rank takes its share of the host's cores
        env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // args.world)))
    ports = ",".join(str(free_port()) for _ in range(4))
    procs = []
    for r in range(args.world):
        env["RANK"] = str(r)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tpu_resiliency_torch.examples.moe_pipeline_training",
             *(argv if argv is not None else sys.argv[1:]), "--rank", str(r),
             "--group-ports", ports, "--ckpt-root", ckpt_root], env=dict(env),
            cwd=REPO_ROOT))
    rcs = []
    try:
        for proc in procs:
            rcs.append(proc.wait(timeout=RANK_TIMEOUT_S))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if any(rcs):
        print(f"FAILED: rank exit codes {rcs}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
