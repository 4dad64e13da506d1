"""The control of the comparison that decides ``correct``, and a fault planted in the
reference, run on the card at a cell's own size. The benchmark's own runs never run
them.

    python3 -m benchmark.control --workload mistral7b-l2.train --seeds 11,12,13

Each seed prints, as one JSON line, the compared numbers that the reference in float8
(bfloat16 tensors, e4m3 products with the weights) and the reference with half of each
batch left out read against the float32 reference over the compared steps; a state
left unchanged reads 1 on the change by construction.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def train_readings(cell, seed: int, device) -> dict:
    import torch

    from benchmark import generator
    from benchmark.loops.train_loop import training_numbers
    from benchmark.reference import mistral

    cfg, mix = cell.config, cell.traffic
    seq, batch = cfg["assumed"]["seq_len"], cfg["assumed"]["micro_batch"]
    opt = cfg["assumed"]["optimizer"]
    if torch.device(device).type == "cuda":
        mistral.full_precision()
    feed = generator.TokenBatches(cfg, batch, seq, seed, device)
    batches = [feed.next() for _ in range(mix["compared_steps"])]
    weights = lambda: generator.decoder_weights(cfg, seed, device)
    ref = mistral.train(cfg, opt, weights(), batches)
    return {label: training_numbers(mistral.train(cfg, opt, weights(), batches, **kw), ref)
            for label, kw in (("fp8", {"fp8": True}), ("half_batch", {"rows": batch // 2}))}


def main(argv=None) -> int:
    from benchmark import run

    if run._STARTED not in os.environ:
        run.reexec()
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    args = parser.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        readings = train_readings(cell, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.time() - t0, "readings": readings}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
