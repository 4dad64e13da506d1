"""Layered in-job + in-process restart: both restarters on one workload on the card.

The port's counterpart of ``examples/layered_restart.py``: config 4's
straggler-telemetry loop (a push per step into ``MeshTelemetry`` on the device, a
report every ``--report-every`` steps through the ``loop`` kernel on the card)
wrapped with :class:`tpu_resiliency_torch.inprocess.Wrapper` runs under the port's
launcher, sharing the launcher-hosted coordination store
(``TPU_RESILIENCY_STORE_EXTERNAL`` is set by the agent, ``launcher/agent.py``). Fault
routing:

- an **exception** inside the wrapped fn is absorbed by the in-process layer — the
  function restarts without the launcher noticing (no respawn, no budget charge);
- a **process death** escalates to the in-job layer — the launcher respawns the
  round, and the respawned wrappers form a fresh in-process restart world scoped by
  the new launcher round (``TPU_FT_RESTART_COUNT``);
- a **sticky device error** (``--fault device-error``: ``DEVICE_ERROR``, the trap
  kernel) cannot be healed in the process that took it: the restart round's
  :class:`CudaHealthCheck` fails, the Wrapper raises ``HealthCheckError``, the
  process exits, and the launcher's respawn gets a new process with a working
  context.

Both layers narrate their state machines via the machine-parseable
``[NestedRestarter] name=[InJob|InProcess] state=...`` log-line contract
(reference ``rank_monitor_state_machine.py:127-145``, ``nested_restarter.py:34-107``).
Each rank prints one ``RESULT`` JSON line when it finishes.

Run on the card (1 rank, a sticky error in round 0)::

    TPU_RESILIENCY_LOG_LEVEL=INFO python -m tpu_resiliency_torch.launcher.launch \\
        --nproc-per-node 1 --max-restarts 2 --no-ft-monitors \\
        -m tpu_resiliency_torch.examples.layered_restart --fault device-error

On the CPU (2 ranks, the reference's two faults): ``--nproc-per-node 2`` and
``--device cpu --ranks 64 --signals 8 --window 8 --report-every 5``.
"""

from __future__ import annotations

import argparse
import json
import os

from tpu_resiliency_torch.inprocess import CallWrapper, CudaHealthCheck, Wrapper
from tpu_resiliency_torch.inprocess.nested_restarter import NestedRestarter
from tpu_resiliency_torch.inprocess.tools.inject_fault import Fault, inject_fault
from tpu_resiliency_torch.launcher.errors import record
from tpu_resiliency_torch.ops import _build
from tpu_resiliency_torch.ops import scoring_kernels as sk
from tpu_resiliency_torch.platform.device import tiny_launch
from tpu_resiliency_torch.telemetry.sharded import MeshTelemetry
from tpu_resiliency_torch.examples.resilient_training import telemetry_rows, worker_device


def build_train(args, rank: int, launcher_round: int, device):
    nr = NestedRestarter()
    rows, _ = telemetry_rows(args.window, args.ranks, args.signals, device)
    iterations = []

    @Wrapper(
        initialize=nr.on_initialize,
        abort=nr.on_abort,
        completion=nr.on_completion,
        terminate=nr.on_terminate,
        health_check=CudaHealthCheck(timeout=30.0, device=device),
        soft_timeout=30.0,
        hard_timeout=60.0,
    )
    def train(call: CallWrapper):
        iterations.append(call.iteration)
        mt = MeshTelemetry(args.ranks, signal_names=[f"s{i}" for i in range(args.signals)],
                           window=args.window, device=device)
        state = mt.init_state()
        flagged = []
        for i in range(args.steps):
            round0 = launcher_round == 0 and rank == args.fault_rank
            if args.fault == "device-error" and round0 and i == args.fail_step:
                # The context takes a sticky error: the next device use raises, and
                # the restart round's health check finds the card dead.
                inject_fault(Fault.DEVICE_ERROR, device=device)
            # Fault (a): in round 0 the wrapper's first pass raises at --fail-step;
            # the in-process layer restarts the fn and iteration 1 runs clean.
            if args.fault == "exit" and round0 and call.iteration == 0 and i == args.fail_step:
                raise RuntimeError(f"transient fault at step {i}")
            # Fault (b): in round 0, the *restarted* fn dies hard at --die-step;
            # only the in-job layer can recover from a lost process.
            if args.fault == "exit" and round0 and call.iteration >= 1 and i == args.die_step:
                os._exit(17)
            mt.push(state, rows[i % args.window])
            if i % args.report_every == 0:
                state, report = mt.generate_report(state)
                flagged = sorted(s.rank for s in report.identify_stragglers().by_perf)
            # The step's loss read: a small launch and a wait for the device (on the
            # CPU it honours the dead-runtime mark an injected DEVICE_ERROR sets).
            tiny_launch(device)
            call.ping()
        return flagged

    return train, iterations


@record
def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--fault", choices=("exit", "device-error", "none"), default="exit")
    ap.add_argument("--fault-rank", type=int, default=1)
    ap.add_argument("--fail-step", type=int, default=5)
    ap.add_argument("--die-step", type=int, default=9)
    ap.add_argument("--device", default=None, help="default: cuda:$LOCAL_RANK")
    ap.add_argument("--ranks", type=int, default=4096)
    ap.add_argument("--signals", type=int, default=64)
    ap.add_argument("--window", type=int, default=32)
    ap.add_argument("--report-every", type=int, default=100)
    args = ap.parse_args()

    rank = int(os.environ.get("RANK", "0"))
    launcher_round = int(os.environ.get("TPU_FT_RESTART_COUNT", "0"))
    device = worker_device(args.device)
    train, iterations = build_train(args, rank, launcher_round, device)
    flagged = train()
    print("RESULT " + json.dumps({
        "rank": rank, "round": launcher_round, "iterations": iterations,
        "flagged": flagged, "launches": dict(sk.fused_median_weights.launches_by_mode),
        "nvcc_runs": _build.nvcc_runs, "device": str(device)}), flush=True)
    print(f"rank {rank}: finished (launcher round {launcher_round}, "
          f"{len(flagged)} ranks flagged)")


if __name__ == "__main__":
    main()
