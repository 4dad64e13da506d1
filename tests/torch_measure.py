"""Side-by-side measurements of the port and the reference on this CPU, for the records
(ROADMAP Queue 3, PERF.md §7). Run from the repo root::

    JAX_PLATFORMS=cpu python -m tests.torch_measure foreground
    JAX_PLATFORMS=cpu python -m tests.torch_measure hang-race [--runs 6]
    python -m tests.torch_measure moe-copies [--runs 2] [--copies 4]

``foreground``: ``bench_ckpt_save.bench_clique(2, 48 MiB, 3 rounds)`` (the reference's
acceptance size) of both packages, sync and pipelined, and the pipelined ``save()``
broken into its parts (each part's median and max per call, over both ranks).

``hang-race``: ``tests/test_torch_inprocess_faults.py``'s device-hang scenario, the
reference's pair then the port's, each alone ``--runs`` times; prints the survivor's
iteration and world each time (iteration 2 means the dead rank's monitor recorded the
death first).

``moe-copies``: ``--copies`` runs of ``examples/moe_pipeline_training.py`` at once (4
gloo ranks each, the fault at step 3, as ``tests/test_torch_parallel_examples.py`` runs
it), ``--runs`` times; prints each copy's exit code and whether a rank stood down.
"""

from __future__ import annotations

import argparse
import collections
import importlib
import importlib.util
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _instrument(pkg: str) -> dict:
    sd = importlib.import_module(f"{pkg}.checkpoint.state_dict")
    lm = importlib.import_module(f"{pkg}.checkpoint.local_manager")
    fmt = importlib.import_module(f"{pkg}.checkpoint.format")
    times = collections.defaultdict(list)

    def timed(owner, name, label):
        orig = getattr(owner, name)

        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return orig(*a, **kw)
            finally:
                times[label].append(time.perf_counter() - t0)

        setattr(owner, name, call)

    timed(sd.PyTreeStateDict, "pop_tensors", "pop_tensors")
    timed(sd.PyTreeStateDict, "copy_tensors_to_host_async", "snapshot")
    timed(fmt, "header_prefix", "header_prefix")
    timed(lm.LocalCheckpointManager, "_save_pipelined", "save, pipelined")
    timed(lm.LocalCheckpointManager, "_save_materialized", "save, sync")
    return times


def foreground() -> None:
    from tpu_resiliency_torch.scripts import bench_ckpt_save as port

    spec = importlib.util.spec_from_file_location("ref_bench_ckpt_save",
                                                  REPO / "scripts" / "bench_ckpt_save.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    for pkg, bench, kw in (("tpu_resiliency", ref, {}),
                           ("tpu_resiliency_torch", port, {"device": "cpu"})):
        times = _instrument(pkg)
        fg = {}
        for pipelined in (False, True):
            with tempfile.TemporaryDirectory() as root:
                fg[pipelined] = bench.bench_clique(2, 48, 3, pipelined=pipelined, root=root,
                                                   **kw)[0]
        print(f"{pkg}: foreground ms sync {fg[False] * 1e3:.2f}, pipelined "
              f"{fg[True] * 1e3:.2f}, ratio {fg[True] / fg[False]:.4f}")
        for label, ts in times.items():
            ts = sorted(ts)
            print(f"  {label}: {len(ts)} calls, median {ts[len(ts) // 2] * 1e3:.2f} ms, "
                  f"max {ts[-1] * 1e3:.2f} ms")


def hang_race(runs: int) -> None:
    from tests import test_torch_inprocess_faults as faults
    from tests.torch_model_util import held_port

    for pkg in ("reference", "port"):
        for i in range(runs):
            port = held_port()
            if pkg == "reference":
                pairs = faults.reference._run_children(
                    faults.reference.HANG_CHILD, 2, lambda r: [r, port], timeout=120.0)
                (rc0, out0, _), (rc1, _, _) = pairs[0], pairs[1]
            else:
                (rc0, out0, _), (rc1, _, _) = faults.run_children(
                    faults.HANG_CHILD, [[0, port], [1, port]], timeout=120.0)
            got = faults.result(out0, "HANG-RESULT")["result"] if rc0 == 0 else None
            print(f"{pkg} {i}: survivor rc {rc0}, hung rank rc {rc1}, {got}", flush=True)


def moe_copies(runs: int, copies: int) -> None:
    import os
    import subprocess

    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for i in range(runs):
        with tempfile.TemporaryDirectory() as tmp:
            procs = [subprocess.Popen(
                [sys.executable, "-m", "tpu_resiliency_torch.examples.moe_pipeline_training",
                 "--world", "4", "--device", "cpu", "--steps", "8", "--fault-step", "3",
                 "--ckpt-root", f"{tmp}/c{c}"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=env, cwd=REPO) for c in range(copies)]
            outs = [p.communicate(timeout=300) for p in procs]
        print(f"run {i}: exit codes {[p.returncode for p in procs]}, stood down "
              f"{['standing down' in err for _, err in outs]}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("foreground", "hang-race", "moe-copies"))
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--copies", type=int, default=4)
    args = ap.parse_args(argv)
    import tests.conftest  # noqa: F401  JAX on the CPU; the repo root for children

    if args.what == "foreground":
        foreground()
    elif args.what == "hang-race":
        hang_race(args.runs)
    else:
        moe_copies(args.runs, args.copies)
    return 0


if __name__ == "__main__":
    sys.exit(main())
