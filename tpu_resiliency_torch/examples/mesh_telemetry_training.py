"""Group-scored straggler telemetry as the product path: zero-gather report rounds.

Port of ``examples/mesh_telemetry_training.py``. Every worker is its own process in
one ``torch.distributed`` group, and the straggler report rounds ride the group: each
process contributes its per-rank timing summary as its rows of the job's ring
(``MeshTelemetry(group=...)``), the cross-rank reductions run as the group's
collectives, and the coordination store carries only the one-time column-name
agreement. No per-rank summary ever crosses the store (this script asserts that).

Run (2 workers on the CPU)::

    TPU_RESILIENCY_LOG_LEVEL=INFO python -m tpu_resiliency_torch.launcher.launch \\
        --nproc-per-node 2 --no-ft-monitors \\
        tpu_resiliency_torch/examples/mesh_telemetry_training.py --steps 150 --device cpu

Without ``--device`` the rings, the ``loop`` kernel's reports and the step run on the
card (``cuda:<LOCAL_RANK % cards>``) and the group is gloo, which stages the card's
tensors through the host, since NCCL refuses two ranks on one card. The reference's ``--coord-port`` (``jax.distributed``'s
coordinator) is gone: the group's address comes through the launcher's store
(``TPU_RESILIENCY_STORE_HOST``/``PORT``), where rank 0 publishes a free port. Each
rank prints one ``RESULT`` line (rank 0 its flags; every rank its ``loop`` launches).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time

# Run as a file (the launcher's script argument) from a checkout with no install.
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from tpu_resiliency_torch.integrations import LoopContext, run_training  # noqa: E402
from tpu_resiliency_torch.integrations.straggler_callback import (  # noqa: E402
    StragglerDetectionCallback,
)
from tpu_resiliency_torch.launcher.errors import record  # noqa: E402
from tpu_resiliency_torch.ops import scoring_kernels as sk  # noqa: E402
from tpu_resiliency_torch.platform import distributed  # noqa: E402
from tpu_resiliency_torch.platform.device import resolve_device  # noqa: E402
from tpu_resiliency_torch.platform.store import CoordStore, store_addr_from_env  # noqa: E402


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def join_group(store, host: str, rank: int, world: int, device) -> None:
    """The job's gloo group, its address agreed on the launcher's store: rank 0
    publishes a free port for this launcher round, the others wait for it."""
    key = f"mesh_telemetry/group_port/{os.environ.get('TPU_FT_RESTART_COUNT', '0')}"
    if rank == 0:
        store.set(key, free_port())
    port = store.get(key, timeout=60.0)
    distributed.initialize(f"tcp://{host}:{port}", world, rank, backend="gloo",
                           timeout=60.0, device=device)


@record
def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--slow-rank", type=int, default=1)
    ap.add_argument("--slow-ms", type=float, default=20.0)
    ap.add_argument("--device", default="",
                    help="'cpu' to train and score on the host; the card by default")
    args = ap.parse_args()

    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    dev = resolve_device(args.device or None)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())
        torch.cuda.set_device(dev)

    host, port = store_addr_from_env()
    store = CoordStore(host, port)
    join_group(store, host, rank, world, dev)

    callback = StragglerDetectionCallback(
        report_time_interval=0.5,
        threshold=0.75,
        store=store.scoped("straggler/"),
        use_device_mesh=True,
        device=dev,
    )

    w = torch.ones((64, 64), device=dev)

    def forward(w, x):
        return torch.tanh(w @ x).sum()

    def step_fn(state, step):
        x = torch.full((64, 8), 0.1 * (step % 7), device=dev)
        loss = forward(w, x)
        loss.item()  # the step's result read back, as a train step reads its loss
        # The injected straggler: this rank pays extra host time every step.
        if rank == args.slow_rank:
            time.sleep(args.slow_ms / 1e3)
        else:
            time.sleep(args.slow_ms / 4e3)
        return state

    sk.reset_launches()
    run_training(
        step_fn,
        state=None,
        num_steps=args.steps,
        callbacks=[callback],
        ctx=LoopContext(rank=rank, world_size=world),
    )

    # --- the zero-gather proof -------------------------------------------------
    leaked = store.prefix_get("straggler/telemetry/round/")
    assert leaked == {}, f"per-rank summaries leaked through the store: {leaked}"
    report = callback.last_report
    flagged = None
    if rank == 0:
        assert report is not None, "no report round elapsed; raise --steps"
        stragglers = report.identify_stragglers(perf_threshold=0.75)
        flagged = sorted(s.rank for s in stragglers.by_perf)
        assert flagged == [args.slow_rank], (flagged, report.perf_scores)
        print(
            f"ZERO-GATHER OK: report rounds rode the group; flagged ranks {flagged} "
            f"perf={report.perf_scores}",
            flush=True,
        )
    print("RESULT " + json.dumps({
        "rank": rank, "flagged": flagged, "device": str(dev),
        "backend": dist.get_backend(),
        "loop_launches": sk.fused_median_weights.launches_by_mode["loop"]}), flush=True)
    distributed.shutdown_ordered(store, rank, world)


if __name__ == "__main__":
    main()
