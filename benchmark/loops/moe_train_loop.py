"""Train steps of a hybrid mixture of experts under the straggler stack: the program's
``run_training`` over ``models/hybrid.py``'s ``make_train_step`` (LFM2's gated short
convs, GQA attention, dense and routed SwiGLU FFNs; AdamW over float32 weights, the
configuration's compute type) on seeded token batches, with the program's
``StragglerDetectionCallback`` attached as the mix sets it. The loop reads each step's
loss, as a training loop logs it. One rank of a one-rank job.

Everything ``train_loop`` holds the dense decoder to holds here, with the same helpers,
limits' names and callback checks, against ``reference/lfm2_moe.py`` in float32 after
the window. Two more numbers decide ``correct``:

- ``route_mismatch``: the share of the first step's (token, slot) choices, over the
  routed layers, that are not among the reference's choices for that token (the
  program's choices from a spy on its router, ``moe.sigmoid_choices``);
- ``tokens_dropped``: the (token, slot) choices of every step of the run that the
  program's dispatch left out of the experts' groups (a spy on ``moe.expert_groups``:
  the choices it is handed less the rows its groups hold).

Run as a module, it prints the control's and the faults' readings at the cell's own
size, one JSON line a seed:

    python3 -m benchmark.loops.moe_train_loop --workload lfm2-24b-a2b-l6.train --seeds 1,2
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import torch

from benchmark import generator
from benchmark.checks import Checks
from benchmark.loops.train_loop import (DTYPES, Timed, check_callback, compare_training,
                                        first_gradient_norms, leaf_norms,
                                        report_mismatches, spying, training_numbers)
from benchmark.outcome import Outcome
from benchmark.reference import lfm2_moe

#: The expert bias is no trained parameter; it is drawn once from the seed.
BIAS = "expert_bias"


def program_config(cfg: dict, seq: int):
    from tpu_resiliency_torch.models.hybrid import HybridConfig

    if cfg["norm_eps"] != 1e-5 or cfg["conv_bias"] or not cfg["assumed"]["tie_word_embeddings"]:
        raise ValueError("the program's hybrid has RMSNorm eps 1e-5, conv layers without "
                         "bias and a tied head")
    return HybridConfig(
        vocab_size=cfg["vocab_size"], d_model=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
        moe_d_ff=cfg["moe_intermediate_size"], max_seq_len=seq,
        rope_theta=float(cfg["rope_parameters"]["rope_theta"]),
        dtype=DTYPES[cfg["torch_dtype"]], n_experts=cfg["num_experts"],
        top_k=cfg["num_experts_per_tok"], layer_types=tuple(cfg["layer_types"]),
        num_dense_layers=cfg["num_dense_layers"], conv_kernel=cfg["conv_L_cache"],
        norm_topk_prob=cfg["norm_topk_prob"], routed_scale=float(cfg["routed_scaling_factor"]),
        expert_bias=cfg["use_expert_bias"])


def weight_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """The leaves by flat name, stacked over the layers of their kind, each matrix
    ``[in, out]``, each expert stack ``[E, in, out]``."""
    d, v, f = cfg["hidden_size"], cfg["vocab_size"], cfg["intermediate_size"]
    e, fe = cfg["num_experts"], cfg["moe_intermediate_size"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = d // h
    n = cfg["num_hidden_layers"]
    types = cfg["layer_types"][:n]
    conv, attn = types.count("conv"), types.count("full_attention")
    dense = min(cfg["num_dense_layers"], n)
    routed = n - dense
    return {
        "embed": (v, d),
        "layers.op_norm": (n, d), "layers.ffn_norm": (n, d),
        "layers.conv_in": (conv, d, 3 * d), "layers.conv_kernel": (conv, d, cfg["conv_L_cache"]),
        "layers.conv_out": (conv, d, d),
        "layers.wq": (attn, d, h * dh), "layers.wk": (attn, d, kv * dh),
        "layers.wv": (attn, d, kv * dh), "layers.wo": (attn, h * dh, d),
        "layers.q_norm": (attn, dh), "layers.k_norm": (attn, dh),
        "layers.w_gate": (dense, d, f), "layers.w_up": (dense, d, f),
        "layers.w_down": (dense, f, d),
        "layers.w_router": (routed, d, e), "layers.we_gate": (routed, e, d, fe),
        "layers.we_up": (routed, e, d, fe), "layers.we_down": (routed, e, fe, d),
        "final_norm": (d,),
        BIAS: (routed, e),
    }


def weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """f32 leaves by flat name, views of one flat buffer drawn in one call: every matrix
    and conv kernel ``N(0, initializer_range)``, every norm scale 1, the expert bias
    ``N(0, expert_bias_std)``."""
    shapes = weight_shapes(cfg)
    flat = torch.randn(sum(math.prod(s) for s in shapes.values()),
                       generator=generator.torch_generator(seed, generator.WEIGHTS, device),
                       device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        leaf = flat[at:at + math.prod(shape)].view(shape)
        if name.endswith("norm"):
            leaf.fill_(1.0)
        else:
            leaf.mul_(cfg["assumed"]["expert_bias_std"] if name == BIAS
                      else cfg["assumed"]["initializer_range"])
        out[name] = leaf
        at += leaf.numel()
    return out


def route_mismatch(program: list, reference: list) -> float:
    """The share of the program's (token, slot) choices, over the routed layers, not
    among the reference's choices for the same token; NaN with no choices to compare,
    1 where the program routed other tokens than the reference."""
    if not program or len(program) != len(reference):
        return float("nan")
    missed = total = 0
    for p, r in zip(program, reference):
        if p.numel() != r.numel():
            return 1.0
        p, r = p.reshape(-1, p.shape[-1]), r.reshape(-1, r.shape[-1]).to(p.device)
        missed += int((p[:, :, None] != r[:, None, :]).all(-1).sum())
        total += p.numel()
    return missed / total


def expert_loads(tracing, n_experts: int, steps: range) -> tuple[float, float] | None:
    """The largest group's rows over the mean group's, median and largest over the
    routed layers of ``steps``, from the program's ``moe.dispatch`` counts."""
    ratios = sorted(r.counts["max_load"] * n_experts / r.counts["routed"]
                    for r in tracing.spans("moe.dispatch")
                    if "max_load" in r.counts and r.step in steps)
    return (ratios[len(ratios) // 2], ratios[-1]) if ratios else None


def run(cell, seed: int, seconds: float, tracer, device) -> Outcome:
    from tpu_resiliency_torch.integrations import loop, straggler_callback
    from tpu_resiliency_torch.models import hybrid, moe, transformer
    from tpu_resiliency_torch.telemetry import detector
    from tpu_resiliency_torch.telemetry.detector import Detector
    from tpu_resiliency_torch.utils import tracing

    cfg, mix = cell.config, cell.traffic
    seq, batch = cfg["assumed"]["seq_len"], cfg["assumed"]["micro_batch"]
    opt_cfg = cfg["assumed"]["optimizer"]
    cuda = torch.device(device).type == "cuda"
    compared, warmup = mix["compared_steps"], mix["warmup_steps"]
    every = mix["profile_programs_every"]
    traced = range(warmup + mix["trace_skip"], warmup + mix["trace_skip"] + mix["trace_steps"])
    if any(i % every == 0 for i in traced):
        raise ValueError("the traced steps must not hold one of the callback's profiled steps")

    prog_cfg = program_config(cfg, seq)
    model = hybrid.Hybrid(prog_cfg, params=weights(cfg, seed, device))
    train_step, init_opt = hybrid.make_train_step(
        prog_cfg,
        optimizer=transformer.adamw(lr=opt_cfg["lr"], weight_decay=opt_cfg["weight_decay"]))
    opt = init_opt(model)
    batches = generator.TokenBatches(cfg, batch, seq, seed, device)
    callback = Timed(straggler_callback.StragglerDetectionCallback(
        report_time_interval=mix["report_time_interval_s"], use_kernel=mix["use_kernel"],
        profile_programs_every=every, profile_ops=mix["profile_ops"],
        max_signals=mix["max_signals"], device=device), tracer)
    losses, first_grads, first_max, changes, clock = [], {}, {}, {}, {}
    spans, ops, summaries, choices = {}, {}, {}, []  # by step; the first step's choices
    dropped = [torch.zeros((), dtype=torch.long, device=device)]

    def step(state, i):
        clock["step"] = i
        t0 = time.perf_counter()
        with tracer.region("step"):
            _, _, loss = train_step(model, opt, batches.next())
            value = float(loss)  # the loop's loss read
        spans[i] = time.perf_counter() - t0
        if i < compared:
            losses.append(value)
        return state

    def op_samples(args, _):
        seconds, count = ops.get(clock["step"], (0.0, 0))
        for times in args[0].values():
            seconds, count = seconds + sum(times), count + len(times)
        ops[clock["step"]] = (seconds, count)

    def chosen(_, out):
        if clock["step"] == 0:
            choices.append(out[0].detach())

    def grouped(args, out):
        dropped[0] = dropped[0] + (args[0].numel() - out[1].sum())

    class Window(loop.Callback):
        """As ``train_loop``'s: closes the set-up after ``warmup`` steps and the window at
        its deadline; reads the compared state in set-up."""

        def on_step_start(self, ctx):
            if ctx.step == traced.start:
                tracer.start()

        def on_step_end(self, ctx):
            i = ctx.step
            if i >= warmup:
                if "start" not in clock:
                    ctx.should_stop = True
                elif time.perf_counter() - clock["start"] >= seconds:
                    clock["end"], clock["steps"] = time.perf_counter(), i - warmup + 1
                    ctx.should_stop = True
            if i == traced.stop - 1:
                tracer.stop()
            if i == 0:
                norms, largest = first_gradient_norms(model, opt, opt_cfg["betas"][0])
                first_grads.update(norms)
                first_max.update(largest)
            if i == compared - 1:
                start = weights(cfg, seed, device)
                changes.update(leaf_norms((n, p.detach() - start[n])
                                          for n, p in model.named_parameters()))
                del start
            if i == warmup - 1:
                if cuda:
                    torch.cuda.synchronize(device)
                clock["wall"], clock["start"] = time.time(), time.perf_counter()
                callback.counting = True

    with spying(Detector, "record_op_samples", op_samples), \
            spying(Detector, "local_summary",
                   lambda _, out: summaries.__setitem__(clock["step"], out)), \
            spying(moe, "sigmoid_choices", chosen), spying(moe, "expert_groups", grouped):
        ctx = loop.run_training(step, None, 1 << 62, callbacks=[callback, Window()],
                                ctx=loop.LoopContext(rank=0, world_size=1))
    if "end" not in clock:
        raise RuntimeError(f"the loop stopped at step {ctx.step} before the window closed")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    window_s = clock["end"] - clock["start"]
    tokens = batch * seq * clock["steps"]
    window = range(warmup, warmup + clock["steps"])
    loads = expert_loads(tracing, cfg["num_experts"], window)
    if loads:
        print(f"expert loads, largest group over the mean, median and largest over the "
              f"window's routed layers: {loads[0]!r} {loads[1]!r}", file=sys.stderr)
    section = detector.SECTION_PREFIX + callback.inner.section_name
    reports = [(i, r) for i, r in callback.reports if i in window]
    checks = Checks(cell.limits)
    check_callback(checks, callback.errors, [i for i in window if i % every == 0], ops,
                   spans, callback.reports, summaries, section, window,
                   detector.OP_PREFIX, one_stream=cuda)
    checks.add("tokens_dropped", int(dropped[0]))
    callback_s = callback.seconds
    del model, opt, train_step, callback
    if cuda:
        torch.cuda.empty_cache()
        lfm2_moe.full_precision()
    ref_batches = generator.TokenBatches(cfg, batch, seq, seed, device)
    ref = lfm2_moe.train(cfg, opt_cfg, weights(cfg, seed, device),
                         [ref_batches.next() for _ in range(compared)])
    compare_training(checks, {"losses": losses, "grad_norms": first_grads,
                              "grad_max": first_max, "change_norms": changes}, ref)
    checks.add("route_mismatch", route_mismatch(choices, ref["choices"]))
    checks.add("reports_missing", int(not reports))
    checks.add("report_mismatches", sum(report_mismatches(r, cell.config) for _, r in reports))
    return Outcome(
        window_start=clock["wall"],
        end_to_end={"tokens_per_s": tokens / window_s},
        counters={"steps": clock["steps"], "tokens": tokens, "window_s": window_s,
                  "callback_s": callback_s, "reports": len(reports)},
        checks=checks.results(),
        attempted=clock["steps"],
        failed=0,
        memory_peak_bytes=peak,
    )


# -- the control and the faults, at the cell's own size -------------------------------


def readings(cell, seed: int, device) -> dict:
    """The compared numbers that the reference in float8, with half of each batch left
    out, and with the expert bias left out of the choice, read against the float32
    reference over the compared steps."""
    cfg, mix = cell.config, cell.traffic
    seq, batch = cfg["assumed"]["seq_len"], cfg["assumed"]["micro_batch"]
    opt = cfg["assumed"]["optimizer"]
    if torch.device(device).type == "cuda":
        lfm2_moe.full_precision()
    feed = generator.TokenBatches(cfg, batch, seq, seed, device)
    batches = [feed.next() for _ in range(mix["compared_steps"])]
    ref = lfm2_moe.train(cfg, opt, weights(cfg, seed, device), batches)
    out = {}
    for label, kw in (("fp8", {"fp8": True}), ("half_batch", {"rows": batch // 2}),
                      ("bias_ignored", {"bias_in_choice": False})):
        got = lfm2_moe.train(cfg, opt, weights(cfg, seed, device), batches, **kw)
        out[label] = training_numbers(got, ref)
        if label != "half_batch":
            out[label]["route_mismatch"] = route_mismatch(got["choices"], ref["choices"])
    return out


def main(argv=None) -> int:
    from benchmark import harness, run

    if run._STARTED not in os.environ:
        run.reexec()
    parser = argparse.ArgumentParser(description="the control's and the faults' readings")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        got = readings(cell, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.time() - t0, "readings": got}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
