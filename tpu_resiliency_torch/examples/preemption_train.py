"""Preemption-synchronized final saves across a multi-process job.

Port of ``examples/preemption_train.py``. N rank processes train in one
``torch.distributed`` process group (``platform/distributed.py``: NCCL on the card,
gloo with ``--device cpu``); mid-run ONE rank receives the preemption notice (SIGTERM,
what a maintenance event or a spot reclaim delivers). The ranks agree on it over a
gloo group at the end of every step (``integrations/preemption.py``), so every rank
observes the SAME step, saves that step through its ``LocalCheckpointManager`` and
stops, with a coordinator-last teardown. Running again with the same
``--ckpt-root`` resumes from the synchronized step.

Run (2 ranks on the CPU; the parent SIGTERMs rank 1 about 2 s into training)::

    python -m tpu_resiliency_torch.examples.preemption_train --world 2 --device cpu

Without ``--device`` every rank runs on the card (``cuda:<rank % cards>``), in a gloo
group where ranks share a card (NCCL refuses two ranks on one).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import textwrap
import threading
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


CHILD = textwrap.dedent(
    """
    import json, sys, time

    rank = int(sys.argv[1]); world = int(sys.argv[2])
    port = sys.argv[3]; ckpt_root = sys.argv[4]; device = sys.argv[5] or None
    steps = int(sys.argv[6])
    import torch

    from tpu_resiliency_torch.platform import distributed as tdist
    from tpu_resiliency_torch.platform.device import resolve_device

    dev = resolve_device(device)
    backend = None  # the device's: NCCL on the card, gloo on the host
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        if world > torch.cuda.device_count():
            backend = "gloo"  # NCCL refuses two ranks on one card
    tdist.initialize(f"tcp://127.0.0.1:{port}", world, rank, backend=backend, device=dev)

    from tpu_resiliency_torch.checkpoint import LocalCheckpointManager, PyTreeStateDict
    from tpu_resiliency_torch.integrations import PreemptionCheckpointCallback
    from tpu_resiliency_torch.integrations.loop import LoopContext, run_training
    from tpu_resiliency_torch.integrations.preemption import install_notice_handler

    install_notice_handler()  # from here on, SIGTERM is a notice, not the end
    print(f"READY {rank}", flush=True)
    mgr = LocalCheckpointManager(ckpt_root, rank=rank)

    def save(state, step):
        mgr.save(step, PyTreeStateDict({"w": state["w"]}), is_async=False)
        print(f"[rank {rank}] preemption save @ step {step}", flush=True)

    cb = PreemptionCheckpointCallback(on_preemption=save)

    def step_fn(state, step):
        time.sleep(0.05)  # stand-in for a real train step
        return {"w": state["w"] + 1.0}

    ctx = LoopContext(rank=rank, world_size=world)
    ctx.state = {"w": torch.zeros((4, 2), device=dev)}
    latest = mgr.find_latest()
    resumed = None
    if latest >= 0:
        tree, _ = mgr.load_tree(latest, device=dev)
        ctx.state = {"w": tree["w"]}
        ctx.start_step = resumed = latest + 1
        print(f"[rank {rank}] resumed from step {ctx.start_step}", flush=True)
    ctx = run_training(step_fn, ctx.state, num_steps=steps, callbacks=[cb], ctx=ctx)
    tdist.shutdown_graceful(rank, grace=3.0)  # coordinator-last teardown
    mgr.close()
    print(
        "PREEMPT " + json.dumps({"rank": rank, "stopped_at": ctx.step,
                                 "saved": cb.preempted_at, "resumed": resumed,
                                 "w": float(ctx.state["w"][0, 0])}),
        flush=True,
    )
    """
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--ckpt-root", default=None)
    ap.add_argument("--device", default="",
                    help="'cpu' for gloo ranks on the host; the card (NCCL) by default")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--notice-after", type=float, default=2.0,
                    help="seconds of training before the notice; negative: send none")
    args = ap.parse_args(argv)
    ckpt_root = args.ckpt_root or tempfile.mkdtemp(prefix="preempt-example-")
    print(f"[parent] checkpoints in {ckpt_root} (pass --ckpt-root here to resume)")
    from tpu_resiliency_torch.platform.distributed import reserve_port

    port, held = reserve_port()  # rank 0's group store binds it; held until the end
    child_env = {
        **os.environ,
        # uninstalled checkouts: children run from a temp dir
        "PYTHONPATH": REPO_ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
    }

    with tempfile.TemporaryDirectory(prefix="preempt-src-") as d, held:
        script = os.path.join(d, "child.py")
        with open(script, "w") as f:
            f.write(CHILD)
        procs = []
        outputs: list[list[str]] = []
        readers: list[threading.Thread] = []
        for r in range(args.world):
            p = subprocess.Popen(
                [sys.executable, script, str(r), str(args.world), str(port), ckpt_root,
                 args.device, str(args.steps)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=child_env,
            )
            buf: list[str] = []
            t = threading.Thread(target=lambda p=p, b=buf: b.extend(p.stdout), daemon=True)
            t.start()
            procs.append(p)
            outputs.append(buf)
            readers.append(t)
        # Deliver the notice only once every rank has its handler: a SIGTERM before
        # that just ends the rank.
        deadline = time.monotonic() + 120.0
        ready = False
        while time.monotonic() < deadline:
            ready = all(any(ln.startswith("READY") for ln in b) for b in outputs)
            if ready or any(p.poll() is not None for p in procs):
                break
            time.sleep(0.2)
        if not ready:
            for r, p in enumerate(procs):
                state = p.returncode if p.poll() is not None else "hung in startup"
                print(f"[parent] rank {r} not READY ({state}):")
                print("".join(outputs[r])[-1500:])
                if p.poll() is None:
                    p.kill()
            return 1
        if args.notice_after >= 0:
            time.sleep(args.notice_after)  # everyone stepping
            target = min(1, args.world - 1)
            print(f"[parent] delivering preemption notice (SIGTERM) to rank {target}")
            procs[target].send_signal(signal.SIGTERM)
        saved_steps = set()
        ok = True
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                ok = False
            readers[r].join(5.0)  # drain the tail before parsing
            out = "".join(outputs[r])
            got = False
            for ln in out.splitlines():
                if ln.startswith("PREEMPT "):
                    payload = json.loads(ln[len("PREEMPT "):])
                    saved_steps.add(payload["saved"])
                    print(f"[parent] rank {r}: {json.dumps(payload)}")
                    got = True
            if not got or p.returncode != 0:
                print(f"[parent] rank {r} FAILED (rc={p.returncode}):")
                print(out[-1500:])
            ok = ok and got and p.returncode == 0
    if args.notice_after >= 0:
        ok = ok and len(saved_steps) == 1 and None not in saved_steps
    print(f"PREEMPTION-SYNC {'OK' if ok else 'FAILED'}: all ranks saved step {saved_steps}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
