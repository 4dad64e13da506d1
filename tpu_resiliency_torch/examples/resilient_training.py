"""End-to-end resilient training on the card: launcher + callbacks + local checkpoints.

The port's counterpart of ``examples/resilient_training.py``, on config 4's
straggler-telemetry workload: each step pushes one seeded ``[R, S]`` row of timings
into ``MeshTelemetry(R, window W, S signals)`` on the device, every ``--report-every``
steps scores a report (the ``loop`` kernel on the card), and ends with a synchronize
(a train step's loss read). An optional extra state (``--shard-shapes``: a tree of f32
leaf shapes, e.g. a model shard's parameters and optimizer moments) rides along,
updated in place every step. The stack:

- launched by ``python -m tpu_resiliency_torch.launcher.launch`` (in-job restart on
  worker death),
- FT heartbeats via :class:`FaultToleranceCallback` (hang detection by the monitor),
- straggler section timing via :class:`StragglerDetectionCallback`,
- local checkpoints every ``--ckpt-every`` steps via
  :class:`HierarchicalCheckpointCallback` (async, ``LocalCheckpointManager``),
- resume-from-latest on every (re)start,
- a fault in round 0 at ``--fault-step``: ``crash`` raises; ``hang`` waits,
  heartbeating, for the first checkpoint's container to finalize, then launches
  ``DEVICE_HANG`` (a kernel that never ends, so the heartbeats stop).

With ``--stop-file PATH`` the run ends after the step in which that file appears (a
job that runs until its operator stops it).

A restarted round with ``--verify`` checks, after its last step, that the state it
restored equals bit for bit (as integer views) a replay of the same seed to the
restored step, and that its straggler masks equal those of an uninterrupted replay.
It prints one ``RESULT`` JSON line at the end (with whether the Detector's host
rings ran the native collector), and records its stages as ``example`` events on
the launcher's event stream (``worker_stage``: entry, imports, device, restored,
first_step; ``iteration_start`` at each step, which goodput and ``tools.critpath``
read; ``report`` with the ``loop`` launches so far; ``fault``), so a run's restart
can be cut into segments from the stream. Each local checkpoint carries its world's
layout (every leaf replicated), so ``tools.ckpt_info --plan`` can plan a resume on
another world.

Run on the card::

    python -m tpu_resiliency_torch.launcher.launch --nproc-per-node 1 --max-restarts 2 \\
        --ft-param-rank_heartbeat_timeout 60 \\
        -m tpu_resiliency_torch.examples.resilient_training --steps 300 \\
        --report-every 100 --ckpt-every 100 --ckpt-dir /tmp/resilient_ckpt

On the CPU, at small widths: add ``--device cpu --ranks 64 --signals 8 --window 8
--report-every 10 --ckpt-every 5``.
"""

import time

_T_ENTRY = time.time()  # this process's first statement: the end of spawn and startup

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpu_resiliency_torch.checkpoint.local_manager import LocalCheckpointManager  # noqa: E402
from tpu_resiliency_torch.checkpoint.reshard import TreeLayout  # noqa: E402
from tpu_resiliency_torch.checkpoint.state_dict import tree_flatten  # noqa: E402
from tpu_resiliency_torch.integrations import (  # noqa: E402
    Callback,
    FaultToleranceCallback,
    HierarchicalCheckpointCallback,
    LoopContext,
    StragglerDetectionCallback,
    run_training,
)
from tpu_resiliency_torch.launcher.errors import record  # noqa: E402
from tpu_resiliency_torch.ops import _build  # noqa: E402
from tpu_resiliency_torch.ops import scoring_kernels as sk  # noqa: E402
from tpu_resiliency_torch.platform.device import resolve_device  # noqa: E402
from tpu_resiliency_torch.telemetry.detector import Detector  # noqa: E402
from tpu_resiliency_torch.telemetry.sharded import MeshTelemetry, TelemetryState  # noqa: E402
from tpu_resiliency_torch.utils.events import record as record_event  # noqa: E402

_T_IMPORTS = time.time()

SLOW_FRACTION, SLOWDOWN = 0.05, 1.6  # bench.py's seeded stragglers
SEED = 0  # the telemetry's; the extra state's is SEED + 1
REPORT_TIME_INTERVAL_S = 2.0  # the straggler callback's report interval
INT_VIEWS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def worker_device(device):
    """``--device``, or this worker's card: ``cuda:$LOCAL_RANK``."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def telemetry_rows(window, ranks, signals, device, seed=SEED):
    """``window`` seeded rows of timings, ``[window, ranks, signals]``, on ``device``
    (``bench.py``'s generator: a per-signal base, 5% noise, 5% of ranks 1.6x slow),
    and the slow ranks' truth mask."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.8, 1.2, size=(1, 1, signals)).astype(np.float32)
    data = base * (1.0 + 0.05 * rng.standard_normal((window, ranks, signals))).astype(
        np.float32)
    slow = rng.choice(ranks, size=max(1, int(ranks * SLOW_FRACTION)), replace=False)
    data[:, slow] *= SLOWDOWN
    truth = np.zeros(ranks, dtype=bool)
    truth[slow] = True
    return torch.from_numpy(data).to(device), truth


def make_shard(shapes, seed, device):
    """A tree of f32 leaves of ``shapes`` (nested dicts of shape lists), from a
    generator seeded with ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(node):
        if isinstance(node, dict):
            return {k: make(v) for k, v in sorted(node.items())}
        return torch.randn(tuple(node), generator=gen, device=device)

    return make(shapes or {})


def leaves(tree):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class LaidOutManager(LocalCheckpointManager):
    """A local manager whose saves carry the world's layout: ``world`` ranks over one
    ``dp`` axis, every leaf replicated (each rank holds the whole tree)."""

    def __init__(self, root, rank, world):
        super().__init__(root, rank=rank)
        self.world = world

    def save(self, iteration, state_dict, is_async=True, meta=None, layout=None):
        if layout is None:  # the popped leaves, in the container's order
            arrays = list(state_dict.tensors())
            layout = TreeLayout.for_local_tree(arrays, [(None,) * a.ndim for a in arrays],
                                               [("dp", self.world)], list(range(self.world)))
        return super().save(iteration, state_dict, is_async=is_async, meta=meta, layout=layout)


class Workload:
    """Config 4's telemetry loop plus the extra state: the step, the checkpoint tree
    and its inverse. ``events``: record each report on the event stream."""

    def __init__(self, args, device, events=True):
        self.args, self.device, self.events = args, device, events
        self.rows, self.truth = telemetry_rows(args.window, args.ranks, args.signals, device)
        self.mt = MeshTelemetry(args.ranks, signal_names=[f"s{i}" for i in range(args.signals)],
                                window=args.window, device=device)
        self.masks = {}  # report step -> flagged ranks

    def init_state(self):
        return {"tel": self.mt.init_state(),
                "shard": make_shard(self.args.shard_shapes, SEED + 1, self.device)}

    def step(self, state, i):
        self.mt.push(state["tel"], self.rows[i % self.args.window])
        for leaf in leaves(state["shard"]):  # an optimizer step's in-place update
            leaf.mul_(0.999).add_(0.001)
        if i % self.args.report_every == 0:
            state["tel"], report = self.mt.generate_report(state["tel"])
            self.masks[i] = sorted(s.rank for s in report.identify_stragglers().by_perf)
            if self.events:
                record_event("example", "report", step=i,
                             loop_launches=sk.fused_median_weights.launches_by_mode["loop"])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # the step's loss read
        return state

    def to_state_dict(self, state):
        tel = state["tel"]
        return {"tel": {f: getattr(tel, f) for f in ("counts", "cursor", "data", "ewma",
                                                     "hist_min")},
                "iteration": torch.tensor(self.mt.iteration, dtype=torch.int64),
                "shard": state["shard"]}

    def from_state_dict(self, state, loaded):
        self.mt.iteration = int(loaded["iteration"])
        return {"tel": TelemetryState(**loaded["tel"]), "shard": loaded["shard"]}

    def replay(self, steps):
        """The state after ``steps`` steps of an uninterrupted run of the same seed,
        its masks by report step."""
        twin = Workload(self.args, self.device, events=False)
        state = twin.init_state()
        for i in range(steps):
            state = twin.step(state, i)
        return twin, state


def bit_equal(a, b) -> bool:
    iv = INT_VIEWS[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(iv), b.contiguous().view(iv))


def verify(work, restored, start_step, steps) -> dict:
    """The restored leaves against a replay of the seed to ``start_step`` (bit for bit,
    as integer views), and this run's masks against an uninterrupted replay's."""
    twin, replayed = work.replay(start_step)
    want = leaves(twin.to_state_dict(replayed))
    out = {"restored_equal": len(want) == len(restored) and all(
               bit_equal(a, b) for a, b in zip(restored, want)),
           "restored_bytes": sum(t.numel() * t.element_size() for t in restored)}
    del twin, replayed, want
    twin, _ = work.replay(steps)
    out["masks_equal_uninterrupted"] = all(twin.masks[k] == v for k, v in work.masks.items())
    out["slow_ranks_flagged"] = all(set(np.flatnonzero(work.truth)) <= set(v)
                                    for v in work.masks.values())
    return out


class StopOnFile(Callback):
    """Ends the loop cooperatively after the step in which ``path`` exists."""

    def __init__(self, path):
        self.path = path

    def on_step_end(self, ctx):
        if os.path.exists(self.path):
            ctx.should_stop = True


@contextlib.contextmanager
def heartbeating(client, interval=0.5):
    """Heartbeats from a thread while the body runs: the monitor times the rank
    until the process ends, also after the FT callback shuts its client down."""
    stop = threading.Event()

    def beat():
        while not stop.wait(interval):
            client.send_heartbeat()

    thread = threading.Thread(target=beat, name="wrap-up-heartbeats", daemon=True)
    thread.start()
    try:
        yield
    finally:
        stop.set()
        thread.join()


@record
def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--ckpt-dir", default="/tmp/resilient_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--fault", choices=("crash", "hang", "none"), default="crash")
    ap.add_argument("--fault-step", type=int, default=12)
    ap.add_argument("--device", default=None, help="default: cuda:$LOCAL_RANK")
    ap.add_argument("--ranks", type=int, default=4096)
    ap.add_argument("--signals", type=int, default=64)
    ap.add_argument("--window", type=int, default=32)
    ap.add_argument("--report-every", type=int, default=100)
    ap.add_argument("--shard-shapes", type=json.loads, default=None,
                    help="JSON tree of f32 leaf shapes carried as extra state")
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--stop-file", default=None,
                    help="end the run after the step in which this file appears")
    ap.add_argument("--step-time", type=float, default=0.0,
                    help="seconds each step waits after its work: a paced job")
    args = ap.parse_args()

    rank = int(os.environ.get("RANK", "0"))
    round_no = int(os.environ.get("TPU_FT_RESTART_COUNT", "0"))
    record_event("example", "worker_stage", stage="entry", t=_T_ENTRY)
    record_event("example", "worker_stage", stage="imports", t=_T_IMPORTS)

    dev = worker_device(args.device)
    if dev.type == "cuda":  # the context, and the loop kernel's library
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize(dev)
        _build.load(sk.KERNEL_NAMES["loop"])
    record_event("example", "worker_stage", stage="device", t=time.time(), device=str(dev))

    work = Workload(args, dev)
    mgr = LaidOutManager(args.ckpt_dir, rank, int(os.environ.get("WORLD_SIZE", "1")))
    ckpt_cb = HierarchicalCheckpointCallback(
        local_manager=mgr, local_every=args.ckpt_every, to_state_dict=work.to_state_dict,
        from_state_dict=work.from_state_dict, device=dev,
    )

    ctx = LoopContext(rank=rank, state=None)
    restored = None
    if not ckpt_cb.restore_latest(ctx):
        ctx.state = work.init_state()
    else:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        record_event("example", "worker_stage", stage="restored", t=time.time(),
                     step=ctx.start_step)
        print(f"[rank {rank}] round {round_no}: resumed from step {ctx.start_step}", flush=True)
        if args.verify:
            restored = [t.clone() for t in leaves(work.to_state_dict(ctx.state))]

    fault = args.fault if round_no == 0 and rank == 0 else "none"
    ft_cb = FaultToleranceCallback(calc_timeouts=False)
    step_seconds = []

    def step_fn(state, i):
        if fault == "crash" and i == args.fault_step:
            raise RuntimeError(f"injected crash at step {i} (round 0)")
        if fault == "hang" and i == args.fault_step:
            # The first checkpoint must be whole before the card hangs: wait for
            # its container to finalize, heartbeating, so the monitor sees a
            # live rank until the hang itself.
            while mgr.find_latest() < 0:
                mgr.maybe_finalize(blocking=False)
                ft_cb.client.send_heartbeat()
                time.sleep(0.05)
            from tpu_resiliency_torch.inprocess.tools.inject_fault import Fault, inject_fault

            record_event("example", "fault", fault="DEVICE_HANG", step=i, t=time.time(),
                         checkpoint=mgr.find_latest())
            inject_fault(Fault.DEVICE_HANG, device=dev)  # never returns
        record_event("example", "iteration_start", iteration=i)
        t0 = time.time()
        state = work.step(state, i)
        step_seconds.append(time.time() - t0)
        if args.step_time:
            time.sleep(args.step_time)
        if i == ctx.start_step:
            record_event("example", "worker_stage", stage="first_step", t=time.time(),
                         step=i, seconds=step_seconds[-1],
                         native_rings=Detector._signal_rings.native)
        return state

    checks = {}

    class WrapUp(Callback):
        """First at the end of training, while the monitor still times the rank: wait
        for the last checkpoint's container, then verify, heartbeating all the while
        (a 3 GB container takes longer to finalize than a short heartbeat timeout)."""

        def on_train_end(self, ctx):
            # The training's launches; the verification's replays launch more.
            checks["launches"] = dict(sk.fused_median_weights.launches_by_mode)
            checks["detector_native_rings"] = Detector._signal_rings.native
            with heartbeating(ft_cb.client):
                mgr.maybe_finalize(blocking=True)
                if args.verify and restored is not None:
                    checks.update(verify(work, restored, ctx.start_step, args.steps))

    callbacks = [
        WrapUp(),
        ft_cb,
        StragglerDetectionCallback(report_time_interval=REPORT_TIME_INTERVAL_S, device=dev),
        ckpt_cb,
        *([StopOnFile(args.stop_file)] if args.stop_file else []),
    ]
    ctx = run_training(step_fn, ctx.state, args.steps, callbacks=callbacks, ctx=ctx)
    ckpt_cb.close()

    result = {"rank": rank, "round": round_no, "start_step": ctx.start_step,
              "final_step": ctx.step, "masks": {str(k): v for k, v in work.masks.items()},
              "nvcc_runs": _build.nvcc_runs, "device": str(dev),
              "first_step_ms": step_seconds[0] * 1e3,
              "step_ms_median": float(np.median(step_seconds)) * 1e3, **checks}
    # The launcher and the job's other processes write to the same file: the record
    # leaves in one write, with nothing of this process's buffered before it.
    sys.stdout.flush()
    print("RESULT " + json.dumps(result), flush=True)
    print(f"[rank {rank}] round {round_no}: done at step {ctx.step}", flush=True)


if __name__ == "__main__":
    main()
