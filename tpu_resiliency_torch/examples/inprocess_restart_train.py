"""End-to-end example: fault-tolerant training with in-process restart.

Port of ``examples/inprocess_restart_train.py``: N rank processes each train an MLP;
one rank is killed mid-run; the survivors restart in place (abort, health check,
reassignment to the shrunken world) and resume from their newest local checkpoint.

Run (2 ranks on the CPU)::

    python -m tpu_resiliency_torch.examples.inprocess_restart_train --world 2 \\
        --kill-rank 1 --kill-step 6 --device cpu

Without ``--device`` every rank runs on the card (``cuda:<rank % cards>``). Each rank
process:

- wraps ``train`` with :class:`tpu_resiliency_torch.inprocess.Wrapper`
  (``AbortCompilationCache``, ``CudaHealthCheck``);
- saves an async local checkpoint every ``--ckpt-every`` steps through
  :class:`~tpu_resiliency_torch.checkpoint.LocalCheckpointManager`;
- on restart reloads its newest container and continues.

The ranks are ``spawn``ed, so the parent never initialises CUDA before a child
starts. Edits against the reference: ``--device`` replaces ``--cpu`` (whose
``default=True`` could not be turned off); ``--devices-per-rank`` (JAX's virtual
devices per process) has no counterpart, as a rank drives one device, so
``local_devices`` is 1; the weights are drawn from a seeded torch generator.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import sys
import tempfile
import time


def init_params(device) -> dict:
    """``w1 [16, 32]`` and ``w2 [32, 1]``, standard normal × 0.1, seeded."""
    import torch

    g = torch.Generator().manual_seed(0)
    return {"w1": (torch.randn((16, 32), generator=g) * 0.1).to(device),
            "w2": (torch.randn((32, 1), generator=g) * 0.1).to(device)}


def step_fn(params: dict, x, y, lr: float = 0.1):
    """One SGD step on ``mean((tanh(x @ w1) @ w2 - y) ** 2)``: the new parameters
    and the loss (the reference's jitted ``step_fn``)."""
    import torch

    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    h = torch.tanh(x @ p["w1"])
    loss = torch.mean((h @ p["w2"] - y) ** 2)
    grads = torch.autograd.grad(loss, list(p.values()))
    with torch.no_grad():
        new = {k: v - lr * g for (k, v), g in zip(p.items(), grads)}
    return new, loss.detach()


def rank_main(rank: int, world: int, port: int, args, result_q) -> None:
    os.environ.update(
        RANK=str(rank),
        WORLD_SIZE=str(world),
        TPU_RESILIENCY_STORE_HOST="127.0.0.1",
        TPU_RESILIENCY_STORE_PORT=str(port),
    )
    import numpy as np
    import torch

    from tpu_resiliency_torch.checkpoint import LocalCheckpointManager, PyTreeStateDict
    from tpu_resiliency_torch.inprocess import (
        AbortCompilationCache,
        CallWrapper,
        CudaHealthCheck,
        RetryController,
        Wrapper,
    )
    from tpu_resiliency_torch.platform.device import resolve_device

    dev = resolve_device(args.device or None)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    ckpt_root = args.ckpt_root

    @Wrapper(
        initialize=RetryController(max_iterations=5),
        abort=AbortCompilationCache(),
        health_check=CudaHealthCheck(timeout=60.0, device=dev),
        monitor_interval=0.1,
        last_call_wait=0.1,
        soft_timeout=5.0,
        hard_timeout=10.0,
        heartbeat_interval=0.25,
        heartbeat_timeout=5.0,
        barrier_timeout=60.0,
        completion_timeout=60.0,
    )
    def train(call: CallWrapper):
        fs = call.frozen_state
        my_rank, active_world = fs.active_rank, fs.active_world_size
        # Per-rank local checkpoints, no group between the ranks: each loads its own.
        mgr = LocalCheckpointManager(ckpt_root, rank=fs.initial_rank)

        params = init_params(dev)
        start_step = 0
        latest = mgr.find_latest()
        if latest >= 0:
            tree, meta = mgr.load_tree(latest, device=dev)
            params = tree["params"]
            start_step = int(meta["iteration"]) + 1
            print(f"[rank {fs.initial_rank}] resumed from step {start_step}", flush=True)

        rng = np.random.default_rng(123 + my_rank)
        loss = None
        for step in range(start_step, args.steps):
            if (
                fs.initial_rank == args.kill_rank
                and step == args.kill_step
                and fs.iteration == 0
            ):
                print(f"[rank {fs.initial_rank}] dying at step {step}", flush=True)
                os._exit(9)
            x = torch.tensor(rng.standard_normal((8, 16)), dtype=torch.float32, device=dev)
            y = torch.tensor(rng.standard_normal((8, 1)), dtype=torch.float32, device=dev)
            params, loss = step_fn(params, x, y)
            call.ping()
            time.sleep(args.step_time)  # stand-in for a real training step
            if step % args.ckpt_every == 0:
                mgr.save(step, PyTreeStateDict({"params": params}), is_async=True)
                mgr.maybe_finalize()
        mgr.maybe_finalize(blocking=True)
        mgr.close()
        return {
            "rank": fs.initial_rank,
            "iteration": fs.iteration,
            "active_world": active_world,
            "local_devices": 1,
            "final_loss": float(loss) if loss is not None else None,
            "resumed_from": start_step,
            "device": str(dev),
        }

    try:
        result = train()
        result_q.put((rank, result))
    except BaseException as e:  # noqa: BLE001
        result_q.put((rank, {"error": repr(e)}))
        raise


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt-every", type=int, default=2)
    ap.add_argument("--kill-rank", type=int, default=1)
    ap.add_argument("--kill-step", type=int, default=6)
    ap.add_argument("--step-time", type=float, default=0.25)
    ap.add_argument("--device", default="",
                    help="'cpu' to train on the host; the card by default")
    ap.add_argument("--ckpt-root", default=None)
    args = ap.parse_args(argv)
    if args.ckpt_root is None:
        args.ckpt_root = tempfile.mkdtemp(prefix="inproc-example-")

    from tpu_resiliency_torch.platform.distributed import reserve_port

    port, held = reserve_port()  # rank 0's store binds it; held until the ranks are done
    ctx = mp.get_context("spawn")  # the parent never touches CUDA before a child starts
    q = ctx.Queue()
    procs = [
        ctx.Process(target=rank_main, args=(r, args.world, port, args, q))
        for r in range(args.world)
    ]
    for p in procs:
        p.start()
    results = {}
    import queue as qmod

    deadline = 180.0
    t0 = time.monotonic()
    while len(results) < args.world and time.monotonic() - t0 < deadline:
        try:
            rank, payload = q.get(timeout=1.0)
            results[rank] = payload
        except qmod.Empty:
            if all(not p.is_alive() for p in procs):
                break
    for p in procs:
        p.join(timeout=10)
        if p.is_alive():
            p.terminate()
            p.join(timeout=10)
    held.close()

    survivors = {
        r: v for r, v in results.items() if isinstance(v, dict) and "error" not in v
    }
    print("results:", results, flush=True)
    ok = bool(survivors) and all(
        v["iteration"] >= 1 and v["resumed_from"] > 0 and v["local_devices"] == 1
        for v in survivors.values()
    )
    print(
        f"RESTART-RESUME {'OK' if ok else 'FAILED'} "
        f"ranks {args.world} -> {len(survivors)}",
        flush=True,
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
