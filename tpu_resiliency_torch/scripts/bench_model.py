"""Flagship-model throughput on the card: tokens/s and MFU of the Llama-style
transformer's full train step (forward, backward, AdamW), bf16 compute.

Port of ``scripts/bench_model.py``. Not the telemetry's headline metric: it gives the
resiliency overhead a denominator (a telemetry push of ~0.05 ms against a real step).
Prints one JSON line with the reference's keys, where ``mfu_vs_v5e_peak`` becomes
``mfu``: ``6 · n_params · tokens/s`` (the reference's formula) over the H100's
published bf16 dense peak, 989 TFLOP/s. Beside it, ``n_matmul_params`` (every
parameter but the embedding table, which is a lookup) and ``mfu_matmul``, the MFU that
counts only those. The line names the card and its power limit.

    python -m tpu_resiliency_torch.scripts.bench_model [--layers 8] [--d-model 1024] \\
        [--batch 8] [--seq 1024]
    python -m tpu_resiliency_torch.scripts.bench_model --config llama3_8b --layers 2 \\
        --batch 1 --seq 2048

The step is timed on CUDA events, one pair per step, over ``--iters`` steps after an
untimed one. With ``--device cpu`` it runs on the host, timed on the
host's clock, and the line says ``backend: "cpu"`` and ``mfu: null``: no device
metric comes from a CPU run.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

#: The H100 SXM's published dense bf16 peak (NVIDIA H100 Tensor Core GPU datasheet).
H100_BF16_DENSE_FLOPS = 989e12


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=("custom", "llama3_8b"), default="custom",
                    help="llama3_8b: Llama-3-8B's widths, --layers deep (the width "
                         "options are ignored)")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=1024)
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--kv-heads", type=int, default=8)
    ap.add_argument("--d-ff", type=int, default=2816)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="",
                    help="'cpu' to run on the host; the card by default")
    return ap.parse_args(argv)


def config(args):
    from tpu_resiliency_torch.models import transformer as tfm

    if args.config == "llama3_8b":
        return tfm.TransformerConfig.llama3_8b(n_layers=args.layers)
    return tfm.TransformerConfig(
        vocab_size=args.vocab, d_model=args.d_model, n_layers=args.layers,
        n_heads=args.heads, n_kv_heads=args.kv_heads, d_ff=args.d_ff, max_seq_len=args.seq,
    )


def run(args) -> dict:
    """One measurement; returns the JSON line's fields."""
    import numpy as np
    import torch

    from tpu_resiliency_torch.models import transformer as tfm
    from tpu_resiliency_torch.platform.device import resolve_device
    from tpu_resiliency_torch.scripts import device_fields

    dev = resolve_device(args.device or None)
    cuda = dev.type == "cuda"
    cfg = config(args)
    print(f"backend: {dev.type}, device: {dev}", file=sys.stderr)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    train_step, init_opt = tfm.make_train_step(cfg)
    model = tfm.Transformer(cfg, seed=0, device=dev)
    opt = init_opt(model)
    rng = np.random.default_rng(0)
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (args.batch, args.seq)),
                          dtype=torch.int64, device=dev)

    t0 = time.perf_counter()
    _, _, loss = train_step(model, opt, tokens)  # the warm-up: AdamW's state, cuBLAS plans
    float(loss)
    warmup_s = time.perf_counter() - t0

    spans = []
    for _ in range(args.iters):
        if cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            _, _, loss = train_step(model, opt, tokens)
            b.record()
            spans.append((a, b))
        else:
            t = time.perf_counter()
            _, _, loss = train_step(model, opt, tokens)
            float(loss)
            spans.append((time.perf_counter() - t) * 1e3)
    if cuda:
        torch.cuda.synchronize(dev)
        ms = [a.elapsed_time(b) for a, b in spans]
    else:
        ms = spans
    per_step = statistics.median(ms)
    tokens_per_s = args.batch * args.seq / (per_step / 1e3)

    n_params = sum(p.numel() for p in model.parameters())
    n_matmul = n_params - model.embed.numel()

    def mfu(n):
        return 6 * n * tokens_per_s / H100_BF16_DENSE_FLOPS if cuda else None

    return {
        "metric": (
            f"transformer train-step throughput ({n_params / 1e6:.0f}M params, "
            f"{cfg.n_layers}L x {cfg.d_model}d, batch {args.batch} x seq {args.seq}, "
            f"{str(cfg.dtype).removeprefix('torch.')}, warm-up {warmup_s:.1f}s)"
        ),
        "value": tokens_per_s,
        "unit": "tokens/s",
        "ms_per_step": per_step,
        "ms_per_step_min": min(ms),
        "ms_per_step_mean": statistics.fmean(ms),
        "timer": "cuda_events" if cuda else "host_clock",
        "iters": args.iters,
        "final_loss": float(loss),
        **device_fields(dev),
        "config": args.config,
        "layers": cfg.n_layers,
        "d_model": cfg.d_model,
        "batch": [args.batch, args.seq],
        "n_params": n_params,
        "n_matmul_params": n_matmul,
        "mfu": mfu(n_params),
        "mfu_matmul": mfu(n_matmul),
        "peak_flops": H100_BF16_DENSE_FLOPS if cuda else None,
        "peak_memory_allocated": torch.cuda.max_memory_allocated(dev) if cuda else None,
        "memory_total": torch.cuda.get_device_properties(dev).total_memory if cuda else None,
    }


def main(argv=None) -> int:
    print(json.dumps(run(parse_args(argv))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
